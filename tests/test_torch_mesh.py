"""The port's mesh placement in one process, under ``torch.distributed``'s
``fake`` process group (one process standing for every rank of the mesh;
shapes and dispatch are real, the collectives move no data):

* every leaf's local shard under ``param_shardings`` / ``batch_shardings``
  / ``cache_shardings`` has the shape ``shard_shape`` gives it under the
  same spec (the rules' own shapes, held against the reference's by
  ``tests/test_torch_dryrun.py``), for the ten configs at full width on
  the ``meta`` device on the production mesh (16, 16), and for reduced
  Yi-6B, DeepSeek-V2, RWKV6 and RecurrentGemma-2B on (4, 2);
* a spec's placements follow ``PartitionSpec``'s semantics;
* the mesh builders, ``set_mesh`` and ``place``;
* the dry run's pjit cells report collectives;
* the int8 AdamW moments' layout transfer on a (4, 2) mesh, one leaf of
  each layout case: its collectives by kind and the bytes one rank
  receives, none where every rank's blocks are its own shard;
* on a one-rank ``gloo`` mesh (1, 1), three placed train steps of reduced
  RecurrentGemma-2B in bf16 with int8 moments equal the unplaced steps
  bit for bit (the card's phase ``int8_moments`` (a) at a small size; its
  single KV head, split over a ``model`` axis of one rank, once failed
  the attention output's merge under autograd).
"""

import math

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch.shapes import SHAPES, ShapeCase, cache_specs, \
    input_specs
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as SH

POD = M.production_mesh_shape()


def _assert_local_shapes(tree, shardings, mesh_shape) -> int:
    """Each tensor leaf placed on its sharding has ``shard_shape``'s local
    shape; host ints stay host ints. Returns the leaves checked."""
    placed = SH.place(tree, shardings)
    n = 0

    def check(leaf, node):
        nonlocal n
        got, sh = node
        if not isinstance(leaf, torch.Tensor):
            assert got is leaf
            return
        want = SH.shard_shape(tuple(leaf.shape), sh.spec, mesh_shape)
        assert tuple(got.to_local().shape) == want, (sh.spec, leaf.shape)
        assert tuple(got.shape) == tuple(leaf.shape)
        n += 1

    SH._zip_map(check, tree, SH._zip_map(lambda a, b: (a, b), placed,
                                         shardings))
    return n


def _check_config(cfg, mesh, mesh_shape, case_train, case_decode,
                  device) -> None:
    params = T.init_params(cfg, device=device, dtype=torch.float32
                           if device == "cpu" else None)
    n = _assert_local_shapes(params, SH.param_shardings(cfg, mesh, params),
                             mesh_shape)
    assert n == len(list(T._leaves(params)))
    batch = input_specs(cfg, case_train, device=device)
    _assert_local_shapes(batch, SH.batch_shardings(mesh, batch), mesh_shape)
    cache = cache_specs(cfg, case_decode, device=device)
    _assert_local_shapes(cache, SH.cache_shardings(mesh, cache), mesh_shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_shards_on_the_pod_mesh(arch):
    with M.fake_process_group(256):
        mesh = M.make_production_mesh(device_type="meta")
        _check_config(ARCHS[arch], mesh, POD, SHAPES["train_4k"],
                      SHAPES["decode_32k"], "meta")


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-236b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_reduced_shards_on_a_4x2_mesh(arch):
    with M.fake_process_group(8):
        mesh = M.make_debug_mesh(4, 2, device_type="cpu")
        _check_config(reduced(ARCHS[arch]), mesh, {"data": 4, "model": 2},
                      ShapeCase("t", 16, 8, "train"),
                      ShapeCase("d", 16, 8, "decode"), "cpu")


def test_placements_follow_partition_spec_semantics():
    """A mesh dim named by a tensor dim's entry shards that dim; a tuple
    entry shards it over each of its mesh dims, first one major; the rest
    replicate. A spec out of the mesh's order, naming an unknown axis or
    one axis twice is refused."""
    with M.fake_process_group(512):
        mesh = M.make_production_mesh(multi_pod=True, device_type="meta")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        sh = SH.named_sharding(mesh, (("pod", "data"), None, "model"))
        assert sh.placements == (Shard(0), Shard(0), Shard(2))
        assert SH.named_sharding(mesh, ()).placements == (Replicate(),) * 3
        assert SH.named_sharding(mesh, (None, "data")).placements == (
            Replicate(), Shard(1), Replicate())
        t = SH.place(torch.empty((64, 8, 32), device="meta"), sh)
        assert tuple(t.to_local().shape) == (2, 8, 2)
        for bad in ((("data", "pod"),), ("expert",), ("model", "model")):
            with pytest.raises(ValueError):
                SH.named_sharding(mesh, bad)


def test_mesh_builders_need_a_group_of_the_mesh_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world_size=256"):
        M.make_production_mesh(device_type="meta")
    with M.fake_process_group(8):
        with pytest.raises(RuntimeError, match="world of 4"):
            M.make_debug_mesh(2, 2, device_type="cpu")
        with pytest.raises(ValueError, match="device_type"):
            M.make_debug_mesh(4, 2, device_type="tpu")
        mesh = M.make_debug_mesh(2, 2, n_pod=2, device_type="meta")
        assert M.mesh_shape(mesh) == {"pod": 2, "data": 2, "model": 2}
        with pytest.raises(RuntimeError, match="already"):
            with M.fake_process_group(8):
                pass
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="fake group"):
            M.make_debug_mesh(1, 1, device_type="meta")
    finally:
        dist.destroy_process_group()


def test_set_mesh_is_the_ambient_mesh_within_its_block():
    with M.fake_process_group(8):
        a = M.make_debug_mesh(4, 2, device_type="cpu")
        b = M.make_debug_mesh(2, 4, device_type="cpu")
        assert M.ambient_mesh() is None
        with M.set_mesh(a):
            assert M.ambient_mesh() is a
            with M.set_mesh(b):
                assert M.ambient_mesh() is b
            assert M.ambient_mesh() is a
        assert M.ambient_mesh() is None


def test_place_copies_and_keeps_host_ints():
    """``place`` shares no storage with its input (AdamW writes placed
    params in place), keeps a host int, and redistributes a placed leaf."""
    with M.fake_process_group(1):
        mesh = M.make_debug_mesh(1, 1, device_type="cpu")
        t = torch.arange(12.0).reshape(3, 4)
        tree = {"w": t, "idx": 5}
        sh = {"w": SH.named_sharding(mesh, ("data", "model")),
              "idx": SH.named_sharding(mesh, ())}
        placed = SH.place(tree, sh)
        assert placed["idx"] == 5
        local = placed["w"].to_local()
        assert torch.equal(local, t)
        local.add_(1)
        assert torch.equal(t, torch.arange(12.0).reshape(3, 4))
        again = SH.place(placed, {"w": SH.named_sharding(mesh, ()),
                                  "idx": sh["idx"]})
        assert again["w"].placements == (Replicate(), Replicate())


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_pjit_cell_reports_collectives(mode):
    """A reduced cell traced placed on a (4, 2) mesh: counts and operand
    bytes by kind, as the reference's ``hlo_stats`` keys them; FLOPs and
    bytes per device as before."""
    cfg = reduced(ARCHS["deepseek-v2-236b"])
    res = dryrun.trace_cell(cfg, ShapeCase("c", 16, 8, mode),
                            {"data": 4, "model": 2})
    coll = res["collectives"]
    assert set(coll) == {"count_per_kind", "bytes_per_kind", "total_bytes"}
    assert sum(coll["count_per_kind"].values()) > 0
    assert set(coll["bytes_per_kind"]) <= set(coll["count_per_kind"])
    assert coll["total_bytes"] == sum(coll["bytes_per_kind"].values()) > 0
    # The expert-parallel combine is an all-reduce.
    assert coll["count_per_kind"].get("all-reduce", 0) > 0
    assert "fake process group" in res["collectives_note"]
    # The int8 moments' update transfer is the step's only all-to-all.
    moved = res.get("update_transfer", {"calls": 0})["calls"]
    assert coll["count_per_kind"].get("all-to-all", 0) == moved
    assert (moved > 0) == (mode == "train")
    assert res["cost"]["flops"] > 0 and res["n_devices"] == 8
    assert not dist.is_initialized()
    assert math.prod(res["mesh_shape"].values()) == 8


# (layout case, the leaf's shape and spec on the (4, 2) mesh, the bytes
# rank (0, 0) receives in to_blocks and in from_blocks: float32, the
# parameter and the gradient together on the way in, the parameter back).
# [64, 128] holds 64 blocks, 8 a rank: rank (0, 0) holds rows 0-7.
LAYOUT_CASES = {
    "1: dim 0 over (data, model)": (1, (64, 128), (("data", "model"), None),
                                    0, 0),
    # Its box is columns 0-63: rows 0-7's other half comes in, 56 rows of
    # its half go back.
    "2: dim 1 over model": (2, (64, 128), (None, "model"), 512 * 8,
                            56 * 64 * 4),
    # Replicated: its rows are at hand; the other 56 rows come back.
    "3: codes placed, param replicated": (3, (64, 128), (None, None), 0,
                                          56 * 128 * 4),
    # One block, replicated: the leaf's other 32 elements come in.
    "3: codes replicated, param placed": (3, (64,), ("model",), 32 * 8, 0),
    "0: both replicated": (0, (64,), (None,), 0, 0),
}


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_int8_moment_transfer_by_layout_case(name):
    """One placed leaf with int8 moments through ``adamw_update``: its
    ``layout_case``, and the collectives of the update as the dry run
    counts them (``CommDebugMode``) and as the transfer counts its own:
    one all-to-all for each direction in which some rank needs an
    off-rank piece, the bytes rank (0, 0) receives, none in case 1."""
    from repro_torch import optim
    from repro_torch.optim import adamw as A
    case, shape, spec, bytes_in, bytes_back = LAYOUT_CASES[name]
    with M.fake_process_group(8):
        mesh = M.make_debug_mesh(4, 2, device_type="cpu")
        sh = SH.named_sharding(mesh, spec)
        p = SH.place(torch.zeros(shape), sh)
        g = SH.place(torch.ones(shape), sh)
        opt = optim.adamw_init({"w": p}, "int8")
        assert A.layout_case(p, opt.mu["w"]["q"]) == case
        A.reset_transfer_counts()
        with dryrun._CollectiveBytes() as cm:
            optim.adamw_update({"w": p}, {"w": g}, opt, lr=1e-3,
                               moment_dtype="int8")
        calls = (bytes_in > 0) + (bytes_back > 0)
        counts = {dryrun._kind(str(op)): n
                  for op, n in cm.get_comm_counts().items()}
        assert counts == ({"all-to-all": calls} if calls else {}), counts
        # CommDebugMode reads the exchange's output: what the rank gets.
        assert cm.bytes_by_kind.get("all-to-all", 0) == bytes_in + bytes_back
        assert A.transfer_counts["calls"] == calls


def test_one_rank_placed_int8_steps_are_the_unplaced_steps():
    """Reduced RecurrentGemma-2B (bf16, int8 moments) placed on a (1, 1)
    mesh: three ``make_train_step`` calls give the unplaced calls' losses,
    params, codes and scales bit for bit."""
    from repro_torch import optim
    from repro_torch.launch import steps as STEPS
    from repro_torch.optim.adamw import tree_leaves
    cfg = reduced(ARCHS["recurrentgemma-2b"]).scaled(opt_moment_dtype="int8")
    params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = STEPS.make_train_step(cfg, lr=3e-4, remat=False)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = M.make_debug_mesh(1, 1, device_type="cpu")
        placed = SH.place(params, SH.param_shardings(cfg, mesh, params))
        pbatch = SH.place(batch, SH.batch_shardings(mesh, batch))
        opt, opt_p = optim.adamw_init(params, "int8"), \
            optim.adamw_init(placed, "int8")
        for _ in range(3):
            params, opt, m = step(params, opt, batch)
            with M.set_mesh(mesh):
                placed, opt_p, m_p = step(placed, opt_p, pbatch)
            assert torch.equal(m["loss"], m_p["loss"].to_local())
            want = tree_leaves([params, opt.mu, opt.nu])
            got = tree_leaves([placed, opt_p.mu, opt_p.nu])
            assert len(want) == len(got) > 100
            assert all(torch.equal(w, g.to_local())
                       for w, g in zip(want, got))
    finally:
        dist.destroy_process_group()
