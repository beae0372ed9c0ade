"""The port's placed step with int8 AdamW moments against the reference's
own placed step: reduced DeepSeek-V2 (its config's int8 moments, capacity
factor 8), float32, on a (4, 2) ``data`` x ``model`` mesh, two steps of
``make_train_step`` on one batch.

* The port: 8 ``gloo`` processes on the CPU, the params placed by
  ``param_shardings`` (fsdp off), the moments by ``adamw_init`` (the block
  rule), the batch by ``batch_shardings``.
* The reference: its jitted ``make_train_step`` in a subprocess on 8 host
  devices, an ``Auto``-typed mesh (its ``make_mesh`` gives ``Explicit`` axes
  under this JAX: ROADMAP C3), ``in_shardings`` from ``param_shardings``
  and a copy of its dry run's ``_opt_shardings`` (compiled from the source
  file alone: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``), on the
  port's initial params, stacked.

Held after each step, as ``tests/test_torch_mesh_gloo.py`` holds the
placed step against the single-device one: the loss within 1e-5; every
param within 1e-5 but for at most 0.1% of its elements, and those within
2 lr (Adam's first step is sign(g), which flips where |g| is noise); the
codes of the moments equal but for at most 0.1% one apart (after step 2
a code off after step 1 may be two apart), their scales within twice the
gradient tolerance (1e-4 of the largest) of the largest. The placed
update itself is the unplaced one bit for bit
(``tests/test_torch_mesh_gloo.py``), and the unplaced one the reference's
within the int8 bound (``tests/test_torch_optim.py``).

The reference codes each stacked leaf, the port each layer's (a recorded
divergence, ``tests/test_torch_dryrun.py``): the two hold the same blocks
only where a layer's leaf is a whole number of blocks, and only there are
codes compared. Elsewhere (the norm scales, 64 elements a layer) step 2
reads moments quantized over other blocks; those params are held to 2 lr.
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
ARCH = "deepseek-v2-236b"
STEPS = 2
B, S = 8, 16
LR = 1e-3
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
JOIN_LIMIT_S = 240.0
REF_LIMIT_S = 200.0
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
PARAM_FLIP_SHARE = 1e-3
CODE_OFF_SHARE = 1e-3
BLOCK = 128
# The reduced config's 31 param leaves; 22 of them a whole number of
# blocks a layer, so 44 moments whose codes the two packages share.
N_PARAMS, N_CODES = 31, 44

_REF_SCRIPT = textwrap.dedent("""
    import ast, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import optim
    from repro.compat import set_mesh
    from repro.configs import ARCHS, reduced
    from repro.launch import steps
    from repro.runtime import sharding as SH

    src, out, lr, n_steps = sys.argv[1], sys.argv[2], float(sys.argv[3]), \\
        int(sys.argv[4])
    module = ast.parse(open("src/repro/launch/dryrun.py").read())
    ns = {"jax": jax}
    exec(compile(ast.Module(body=[
        n for n in module.body if isinstance(n, ast.FunctionDef)
        and n.name == "_opt_shardings"], type_ignores=[]),
        "src/repro/launch/dryrun.py", "exec"), ns)
    cfg = reduced(ARCHS["deepseek-v2-236b"]).scaled(moe_capacity_factor=8.0)
    data = np.load(src)
    layers = {}
    for key in data.files:
        parts = key.split("/")
        if parts[0] == "batch":
            continue
        at = next((i for i, p in enumerate(parts) if p.isdigit()), None)
        path = tuple(parts if at is None else parts[:at] + parts[at + 1:])
        layers.setdefault(path, {})[
            None if at is None else int(parts[at])] = data[key]
    params = {}
    for path, by_layer in layers.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(
            by_layer[None] if None in by_layer
            else np.stack([by_layer[i] for i in sorted(by_layer)]))
    batch = {k: jnp.asarray(data["batch/" + k], jnp.int32)
             for k in ("tokens", "labels")}
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    psh = SH.param_shardings(cfg, mesh, params, fsdp=False)
    opt = optim.adamw_init(params, "int8")
    osh = ns["_opt_shardings"](opt, psh, mesh)
    step = jax.jit(steps.make_train_step(cfg, lr=lr, remat=False),
                   in_shardings=(psh, osh, SH.batch_shardings(mesh, batch)))
    res = {}
    with set_mesh(mesh):
        for i in range(n_steps):
            params, opt, m = step(jax.device_put(params, psh),
                                  jax.device_put(opt, osh), batch)
            res[f"{i}/loss"] = np.asarray(m["loss"])
            for name, t in (("params", params), ("mu", opt.mu),
                            ("nu", opt.nu)):
                for path, leaf in jax.tree_util.tree_leaves_with_path(t):
                    key = "/".join(str(getattr(k, "key", k)) for k in path)
                    res[f"{i}/{name}/{key}"] = np.asarray(leaf)
    np.savez(out, **res)
    print("OK", [float(res[f"{i}/loss"]) for i in range(n_steps)])
""")


def _cfg():
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[ARCH]).scaled(moe_capacity_factor=8.0)


def _batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


def _flat(tree) -> dict:
    """{"/"-joined path: numpy array} of a tree's leaves (placed ones
    gathered whole), the checkpoint's keys."""
    from repro_torch.checkpointing.checkpoint import _items, _key
    return {_key(k): (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().numpy().copy() for k, v in _items(tree)}


def _worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=GROUP_TIMEOUT)
    try:
        from repro_torch import optim
        from repro_torch.launch import mesh as M
        from repro_torch.launch import steps as STEPS_
        from repro_torch.models import transformer as T
        from repro_torch.runtime import sharding as SH
        cfg = _cfg()
        assert cfg.opt_moment_dtype == "int8"
        mesh = M.make_debug_mesh(4, 2, device_type="cpu")
        params = T.init_params(cfg, seed=0, device="cpu",
                               dtype=torch.float32)
        params = SH.place(params, SH.param_shardings(cfg, mesh, params,
                                                     fsdp=False))
        opt = optim.adamw_init(params, "int8")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        batch = SH.place(batch, SH.batch_shardings(mesh, batch))
        step = STEPS_.make_train_step(cfg, lr=LR, remat=False)
        out = []
        for _ in range(STEPS):
            with M.set_mesh(mesh):
                params, opt, m = step(params, opt, batch)
            row = {"loss": float(m["loss"].full_tensor())}
            flat = {**{"params/" + k: v for k, v in _flat(params).items()},
                    **{"mu/" + k: v for k, v in _flat(opt.mu).items()},
                    **{"nu/" + k: v for k, v in _flat(opt.nu).items()}}
            if rank == 0:
                row["state"] = flat
            out.append(row)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    from repro_torch.checkpointing.checkpoint import _items, _key
    from repro_torch.models import transformer as T
    root = str(tmp_path_factory.mktemp("int8_ref"))
    cfg = _cfg()
    init = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    src = os.path.join(root, "init.npz")
    np.savez(src, **{_key(k): v.numpy() for k, v in _items(init)},
             **{"batch/" + k: v for k, v in _batch(cfg).items()})
    out = os.path.join(root, "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, src, out, str(LR), str(STEPS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    ctx = mp.start_processes(_worker, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish in "
                                   f"{JOIN_LIMIT_S} s")
        ref_out = ref.communicate(timeout=REF_LIMIT_S)[0]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, ref_out
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return {"ranks": ranks, "ref": want}


def _ref_leaf(want: dict, step: int, key: str) -> tuple:
    """The reference's array for the port's ``key`` and the layer of it
    that ``key`` names (None where the reference stacks no layers)."""
    parts = key.split("/")
    at = next((i for i, p in enumerate(parts) if p.isdigit()), None)
    if at is None:
        return want[f"{step}/{key}"], None
    stacked = want[f"{step}/" + "/".join(parts[:at] + parts[at + 1:])]
    return stacked, int(parts[at])


def _param_rows(got: dict, want: dict, step: int) -> dict:
    """For each param leaf: (largest |difference|, share over PARAM_TOL,
    whether the layer's leaf is a whole number of blocks)."""
    rows = {}
    for key, g in got.items():
        if not key.startswith("params/"):
            continue
        w, layer = _ref_leaf(want, step, key)
        d = np.abs(g - (w if layer is None else w[layer])).reshape(-1)
        rows[key] = (float(d.max()), float((d > PARAM_TOL).mean()),
                     g.size % BLOCK == 0)
    return rows


def _code_diff(got: dict, want: dict, step: int, base: str) -> tuple:
    """(|port code - reference code|, largest scale distance over the
    largest scale) of the moment ``base``, whose layer's leaf is a whole
    number of blocks (the two packages' blocks then coincide)."""
    n = int(np.prod(got[base + "/shape"][:-1]))
    out = []
    for part in ("q", "scale"):
        w, layer = _ref_leaf(want, step, f"{base}/{part}")
        if layer is not None:
            w = w.reshape(-1, n // BLOCK, w.shape[-1])[layer]
        out.append((got[f"{base}/{part}"], w))
    (gq, wq), (gs, ws) = out
    return (np.abs(gq.astype(np.int32) - wq.astype(np.int32)),
            float(np.abs(gs - ws).max() / np.abs(ws).max()))


def _code_rows(runs: dict, step: int) -> dict:
    """For each moment whose layer's leaf is a whole number of blocks:
    (share of codes off, largest code difference, largest scale distance
    over the largest scale, and whether every code more than one apart was
    already off after the step before)."""
    want = runs["ref"]
    states = [r["state"] for r in runs["ranks"][0]]
    rows = {}
    for key in states[step]:
        base = key[:-2]
        if not key.endswith("/q") or key.startswith("params/") or \
                int(np.prod(states[step][base + "/shape"][:-1])) % BLOCK:
            continue
        d, scale_rel = _code_diff(states[step], want, step, base)
        far = d > 1
        inherited = not far.any() or (step > 0 and bool(
            _code_diff(states[step - 1], want, step - 1, base)[0][far]
            .all()))
        rows[key] = (float((d > 0).mean()), int(d.max()), scale_rel,
                     inherited)
    return rows


def test_reference_runs_the_placed_int8_step(runs):
    """The reference's jitted step runs on the ``Auto`` mesh with its dry
    run's shardings, and its losses are finite."""
    losses = [float(runs["ref"][f"{i}/loss"]) for i in range(STEPS)]
    assert all(np.isfinite(losses)), losses


@pytest.mark.parametrize("step", range(STEPS))
def test_placed_int8_step_loss_matches_reference(runs, step):
    """Every rank's step loss equals the reference's within 1e-5."""
    want = float(runs["ref"][f"{step}/loss"])
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[step]["loss"], want, rtol=LOSS_TOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_placed_int8_step_params_match_reference(runs, step):
    """Each param after the step: within 1e-5 but for at most 0.1% of its
    elements, and every element within 2 lr."""
    rows = _param_rows(runs["ranks"][0][step]["state"], runs["ref"], step)
    assert len(rows) == N_PARAMS
    for key, (err, share, _) in rows.items():
        assert err <= 2 * LR, (key, err)
        assert share <= PARAM_FLIP_SHARE, (key, share)


@pytest.mark.parametrize("step", range(STEPS))
def test_placed_int8_step_codes_match_reference(runs, step):
    """The codes of every moment whose blocks the two packages share:
    equal but for at most 0.1%, those one apart, but where a code was
    already off after the step before (a first moment one code apart is
    about 9% off and carries 0.9 of that into the next step's code:
    measured, 1 code of 8,192 two apart after step 2); the scales within
    twice the gradient tolerance of the largest."""
    rows = _code_rows(runs, step)
    assert len(rows) == N_CODES, sorted(rows)
    for key, (off, worst, scale_rel, inherited) in rows.items():
        assert off <= CODE_OFF_SHARE and inherited, (key, off, worst)
        assert worst <= 1 + step, (key, worst)
        assert scale_rel <= 2 * GRAD_TOL, (key, scale_rel)
