"""The port's flexible layer pipeline (``core/pipeline.py``) across real
ranks: 8 ``gloo`` processes on the CPU, spawned once, run the six cases of
the reference's ``tests/test_pipeline_distributed.py`` (reduced configs cut
to 4 layers, vocabulary 128, capacity factor 8, batch 8 x 16, a
(8 / (S T), S, T) mesh over (data, stage, tp)):

    Yi-6B at S 2 T 2 K 2 and at S 4 T 1 K 4, Qwen2-72B (qkv bias), RWKV6,
    DeepSeek-V2 (MLA + MoE), and Yi-6B at boundaries (0, 3, 4).

Each is held against the port's sequential function of the same weights
(``sequential_loss``, ``sequential_prefill``: the reference test's
``ref_loss``):

* float32: the loss within 1e-5 and each gradient leaf of every rank
  within 1e-4 of the leaf's largest |g| of the sequential gradient's slice
  (the pipeline adds partial sums in another order: a product split over
  tp, sums over the batch shards);
* bfloat16: the loss within the reference test's 5e-3 (2e-2 for
  DeepSeek-V2), the gradient finite and nonzero;
* the prefill's last-token logits (float32) within 1e-5.

The reference's own pipeline is held live on one float32 case: its
``pipeline_loss_fn`` under ``jax.value_and_grad`` on 8 host devices, an
``Auto``-typed mesh (its ``make_pipeline_mesh`` gives ``Explicit`` axes
under this JAX, where ``with_sharding_constraint`` asserts: ROADMAP C3), in
a subprocess that runs beside the ranks; the ranks carry its weights
across (``pipeline_params_from_numpy``) and hold the port's loss and every
gradient leaf to its.

The ranks meet through a ``FileStore`` under ``tmp_path``, every group has
a timeout (the default group 120 s, the mesh's subgroups torch's own), and
the join has a limit (240 s, the reference's subprocess 200 s), so a hang
fails the test instead of spending the run.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
JOIN_LIMIT_S = 240.0
REF_LIMIT_S = 200.0
B, SEQ, VOCAB = 8, 16, 128
CASES = {
    "yi-6b S2 T2 K2": ("yi-6b", 2, 2, 2, None),
    "yi-6b S4 T1 K4": ("yi-6b", 4, 1, 4, None),
    "qwen2-72b S2 T2 K2": ("qwen2-72b", 2, 2, 2, None),
    "rwkv6-7b S2 T2 K2": ("rwkv6-7b", 2, 2, 2, None),
    "deepseek-v2-236b S2 T2 K2": ("deepseek-v2-236b", 2, 2, 2, None),
    "yi-6b S2 T2 K2 boundaries (0, 3, 4)": ("yi-6b", 2, 2, 2, (0, 3, 4)),
}
REF_CASE = "yi-6b S2 T2 K2"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4        # of the leaf's largest |g|
PREFILL_TOL = 1e-5
# The reference test's bf16 tolerances (MoE: expert sums split over tp
# reorder bf16 reductions).
BF16_LOSS_TOL = {"deepseek-v2-236b": 2e-2}
BF16_LOSS_TOL_DEFAULT = 5e-3

_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.compat import set_mesh
    from repro.configs import ARCHS, reduced
    from repro.core import pipeline as PL

    out, arch, S, T, K = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6])
    cfg = reduced(ARCHS[arch]).scaled(n_layers=4, vocab=128,
                                      moe_capacity_factor=8.0,
                                      dtype="float32")
    mesh = jax.make_mesh((8 // (S * T), S, T), ("data", "stage", "tp"),
                         axis_types=(AxisType.Auto,) * 3)
    params, kind = PL.build_pipeline_params(cfg, S=S)
    mask = params.pop("unit_mask")
    units_shape = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params["units"])
    ctx = PL.PipelineContext(cfg=cfg, unit_kind=kind, S=S, T=T, n_micro=K)
    loss_fn = PL.pipeline_loss_fn(ctx, mesh, units_shape, unit_mask=mask)
    tokens = np.random.default_rng(1).integers(0, 128, (8, 16))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(np.roll(tokens, -1, 1), jnp.int32)}
    with set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    flat = {"loss": np.asarray(loss), "mask": np.asarray(mask)}
    for name, tree in (("params", params), ("grads", grads)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            flat[name + "/" + key] = np.asarray(leaf)
    np.savez(out, **flat)
    print("OK", float(loss))
""")


def _cfg(arch: str, dtype: str):
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[arch]).scaled(n_layers=4, vocab=VOCAB,
                                       moe_capacity_factor=8.0, dtype=dtype)


def _batch() -> dict:
    tokens = np.random.default_rng(1).integers(0, VOCAB, (B, SEQ))
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(np.roll(tokens, -1, 1))}


def _local_leaves(local: dict, full: dict, cfg, pm) -> list:
    """(local leaf, full leaf, slice of the full leaf it holds) for every
    distinct leaf of this rank's params: its stage's real slots' unit
    leaves, the embedding's rows, the head's columns, the final norm."""
    from repro_torch.core import pipeline as PL
    lo, hi = PL._vocab_range(cfg.vocab, pm.S * pm.T, pm.vp)
    out = [(local["embed"], full["embed"], (slice(lo, hi),)),
           (local["final_norm"]["scale"], full["final_norm"]["scale"], ())]
    if "lm_head" in local:
        out.append((local["lm_head"]["w"], full["lm_head"]["w"],
                    (slice(None), slice(lo, hi))))
    seen = set()
    for j, unit in enumerate(local["units"]):
        if not bool(local["unit_mask"][j]):
            continue
        whole = full["units"][pm.stage][j]
        dims = PL.unit_tp_dims(cfg, pm.T, whole)
        ref = dict(PL._paths(whole))
        for path, t in PL._paths(unit):
            if id(t) in seen:
                continue
            seen.add(id(t))
            d = dims[path]
            sl = () if d is None else (slice(None),) * d + (slice(
                pm.tp * t.shape[d], (pm.tp + 1) * t.shape[d]),)
            out.append((t, ref[path], sl))
    return [row for row in out if row[0].is_floating_point()]


def _grads(loss_fn, leaves: list) -> tuple:
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn()
        return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _grad_err(got, want_whole, sl) -> float:
    scale = float(want_whole.abs().max())
    return float((got - want_whole[sl]).abs().max()) / max(scale, 1e-30)


def _run_case(rank: int, name: str, dtype: str) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.core import pipeline as PL
    arch, S, T, K, bounds = CASES[name]
    cfg = _cfg(arch, dtype)
    full, kind = PL.build_pipeline_params(cfg, S, bounds, seed=0,
                                          device="cpu")
    mesh = PL.make_pipeline_mesh(WORLD // (S * T), S, T, device_type="cpu")
    pm = PL.PipelineCoords.of(mesh)
    local = PL.shard_pipeline_params(full, cfg, pm)
    ctx = PL.PipelineContext(cfg=cfg, unit_kind=kind, S=S, T=T, n_micro=K)
    batch = _batch()
    rows = _local_leaves(local, full, cfg, pm)
    PL.reset_comm_counts()
    with CommDebugMode() as cm:
        loss, grads = _grads(lambda: PL.pipeline_loss_fn(ctx, mesh)(
            local, batch), [r[0] for r in rows])
    counts = {k: dict(v) for k, v in PL.comm_counts.items()}
    whole = list({id(r[1]): r[1] for r in rows}.values())
    want_loss, want = _grads(
        lambda: PL.sequential_loss(full, cfg, kind, batch), whole)
    by_id = {id(t): g for t, g in zip(whole, want)}
    out = {"loss": float(loss), "want_loss": float(want_loss),
           "grad_err": max(_grad_err(g.float(), by_id[id(r[1])].float(),
                                     r[2]) for r, g in zip(rows, grads)),
           "grad_finite": all(bool(torch.isfinite(g).all()) for g in grads),
           "grad_abs_sum": float(sum(g.float().abs().sum() for g in grads)),
           "counts": counts, "stage": pm.stage, "S": S, "K": K,
           "debug_all_reduces": sum(n for op, n in cm.get_comm_counts()
                                    .items() if "allreduce" in str(op)),
           "handoff_bytes_each": (B // (WORLD // (S * T)) // K) * SEQ
           * cfg.d_model * torch.finfo(getattr(torch, dtype)).bits // 8}
    if dtype == "float32":
        got = PL.pipeline_prefill_fn(ctx, mesh)(local, batch)
        out["prefill_err"] = float(
            (got - PL.sequential_prefill(full, cfg, kind, batch)).abs().max())
    return out


def _run_reference(rank: int, npz: str) -> dict:
    """The port on the reference's weights, against the reference's loss
    and gradient."""
    from repro_torch.core import pipeline as PL
    arch, S, T, K, _ = CASES[REF_CASE]
    cfg = _cfg(arch, "float32")
    data = np.load(npz)

    def tree(prefix):
        root: dict = {}
        for key in data.files:
            if key.startswith(prefix + "/"):
                node = root
                *path, leaf = key[len(prefix) + 1:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = data[key]
        return root

    full = PL.pipeline_params_from_numpy(tree("params"),
                                         unit_mask=data["mask"], device="cpu")
    ref_grads = PL.pipeline_params_from_numpy(tree("grads"), device="cpu")
    mesh = PL.make_pipeline_mesh(WORLD // (S * T), S, T, device_type="cpu")
    pm = PL.PipelineCoords.of(mesh)
    local = PL.shard_pipeline_params(full, cfg, pm)
    ctx = PL.PipelineContext(cfg=cfg, unit_kind="attn", S=S, T=T, n_micro=K)
    batch = {k: v.to(torch.int32) for k, v in _batch().items()}
    rows = _local_leaves(local, full, cfg, pm)
    loss, grads = _grads(lambda: PL.pipeline_loss_fn(ctx, mesh)(
        local, batch), [r[0] for r in rows])
    # The same leaf of the reference's gradient tree, by position.
    rows_g = _local_leaves(local, ref_grads, cfg, pm)
    return {"loss": float(loss), "ref_loss": float(data["loss"]),
            "grad_err": max(_grad_err(g, rg[1], r[2]) for r, rg, g
                            in zip(rows, rows_g, grads)),
            "leaves": len(rows)}


def _worker(rank: int, root: str, npz: str, marker: str) -> None:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=GROUP_TIMEOUT)
    res: dict = {"cases": {}}
    try:
        for name in CASES:
            for dtype in ("float32", "bfloat16"):
                res["cases"][name, dtype] = _run_case(rank, name, dtype)
        deadline = time.monotonic() + REF_LIMIT_S
        while not os.path.exists(marker) and time.monotonic() < deadline:
            time.sleep(0.2)
        ref_ok = os.path.exists(marker) and \
            Path(marker).read_text() == "0" and os.path.exists(npz)
        # Every rank agrees on whether to run the reference case.
        flag = torch.tensor([int(ref_ok)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        res["reference"] = (_run_reference(rank, npz) if int(flag) else
                            {"failed": Path(marker).read_text()
                             if os.path.exists(marker) else "no marker"})
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("pipeline_gloo"))
    npz, marker = os.path.join(root, "ref.npz"), os.path.join(root, "ref.rc")
    arch, S, T, K, _ = CASES[REF_CASE]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, npz, arch, str(S), str(T),
         str(K)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    ctx = mp.start_processes(_worker, args=(root, npz, marker),
                             nprocs=WORLD, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while True:
            if not os.path.exists(marker):
                if ref.poll() is not None:
                    Path(marker).write_text(str(ref.returncode))
                elif time.monotonic() - t0 > REF_LIMIT_S:
                    ref.kill()
                    Path(marker).write_text("timeout")
            if ctx.join(timeout=1):
                break
            if time.monotonic() - t0 > JOIN_LIMIT_S:
                raise TimeoutError(f"the {WORLD} ranks did not finish in "
                                   f"{JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if ref.poll() is None:
            ref.kill()
        ref_out = ref.communicate(timeout=30)[0]
    out = {"ranks": [], "ref_output": ref_out}
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out["ranks"].append(pickle.load(f))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_loss_and_gradient_match_sequential_f32(ranks, name):
    """float32: on every rank the pipelined loss equals the sequential one
    within 1e-5, and each gradient leaf the rank holds (its stage's units,
    tp-sliced; its vocabulary rows) within 1e-4 of the sequential
    gradient's largest |g| on that leaf."""
    for r in ranks["ranks"]:
        row = r["cases"][name, "float32"]
        assert abs(row["loss"] - row["want_loss"]) <= LOSS_TOL, row
        assert row["grad_err"] <= GRAD_TOL, row
        assert row["grad_finite"] and row["grad_abs_sum"] > 0, row


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_loss_bf16_within_reference_tolerance(ranks, name):
    """bfloat16: the loss within the reference test's tolerance of the
    sequential one, the gradient finite and nonzero on every rank."""
    tol = BF16_LOSS_TOL.get(CASES[name][0], BF16_LOSS_TOL_DEFAULT)
    for r in ranks["ranks"]:
        row = r["cases"][name, "bfloat16"]
        assert abs(row["loss"] - row["want_loss"]) <= tol, row
        assert row["grad_finite"] and row["grad_abs_sum"] > 0, row


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_prefill_matches_sequential(ranks, name):
    """The prefill's last-token logits (float32, the whole batch on every
    rank) equal the sequential forward's within 1e-5."""
    for r in ranks["ranks"]:
        assert r["cases"][name, "float32"]["prefill_err"] <= PREFILL_TOL


@pytest.mark.parametrize("name", ["yi-6b S2 T2 K2", "yi-6b S4 T1 K4"])
def test_handoff_counts_its_sends(ranks, name):
    """The hand-off counts each send with its bytes: stage s < S - 1 sends
    its output after every tick but the last (K + S - 2) in the forward,
    stage s > 0 as many gradients in the backward, one microbatch of
    activations each. The module's all-reduce count equals
    ``CommDebugMode``'s, which sees no point-to-point op."""
    for r in ranks["ranks"]:
        row = r["cases"][name, "float32"]
        s, S, K = row["stage"], row["S"], row["K"]
        sends = (K + S - 2) * ((s < S - 1) + (s > 0))
        assert row["counts"]["collective-permute"] == {
            "calls": sends, "bytes": sends * row["handoff_bytes_each"]}
        assert row["counts"]["all-reduce"]["calls"] == \
            row["debug_all_reduces"] > 0


def test_matches_the_reference_pipeline_live(ranks):
    """The reference's own ``pipeline_loss_fn`` (``jax.value_and_grad``,
    8 host devices, an ``Auto`` mesh) on Yi-6B S 2 T 2 K 2 in float32: the
    port, given its weights, gives its loss within 1e-5 and every gradient
    leaf within 1e-4 of the leaf's largest |g|, on every rank."""
    print(ranks["ranks"][0]["reference"])
    for r in ranks["ranks"]:
        row = r["reference"]
        assert "failed" not in row, (row, ranks["ref_output"][-3000:])
        assert abs(row["loss"] - row["ref_loss"]) <= LOSS_TOL, row
        assert row["grad_err"] <= GRAD_TOL, row
        assert row["leaves"] > 10
