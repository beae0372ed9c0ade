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
* the dry run's pjit cells report collectives.
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
    assert ("int8 moments" in res["collectives_note"]) == (mode == "train")
    assert res["cost"]["flops"] > 0 and res["n_devices"] == 8
    assert not dist.is_initialized()
    assert math.prod(res["mesh_shape"].values()) == 8
