"""The port's mesh runtime across real ranks: 8 ``gloo`` processes on the
CPU, spawned once, run the cases of the reference's
``tests/test_pipeline_distributed.py::_SHARD_SCRIPT`` (reduced Yi-6B,
DeepSeek-V2 and RWKV6 on a (4, 2) ``data`` x ``model`` mesh, every
parameter placed by ``param_shardings``, the batch by
``batch_shardings``), each held against the port's single-device
function, which the other tests hold against the reference:

* the placed loss against ``loss_fn`` (for the configs that also step,
  the step's own loss; DeepSeek-V2 takes the expert-parallel MoE,
  counted; its aux loss is the mean of the data shards' own, the
  reference's ``pmean``, and is held to that);
* one placed ``make_train_step`` against the single-device step (for
  DeepSeek-V2 against the single-device step of the same function: the
  cross-entropy of the whole batch plus 0.01 x the shards' mean aux);
* the gradient through the expert-parallel combine's all-reduce, as the
  port takes it (a ``Partial`` output of ``local_map``) and as
  ``torch.distributed.nn.functional.all_reduce`` would;
* ``examples/elastic_rescale.py``'s path: the stepped Yi-6B saved under
  (4, 2), ``restore_resharded`` onto (2, 2) in a 4-rank group (bit for
  bit the saved values), and one more step there against the
  single-device step from the saved params;
* AdamW's int8 moments on placed leaves: DeepSeek-V2's step with its
  config's int8 moments (beside the float32 case) against the
  single-device step, within ``tests/test_torch_optim.py``'s int8 code
  bound; three placed ``adamw_update`` calls on reduced Yi-6B and
  DeepSeek-V2, bit for bit the unplaced ones (codes, scales, params),
  with the params placed by ``param_shardings`` and by a fully sharded
  placement (each leaf's dim 0 over (data, model)), which together reach
  every layout case of ``adamw.layout_case``; the stepped int8 state
  saved under (4, 2) and restored onto (2, 2) by ``restore_resharded``,
  bit for bit, then one more step there.

The ranks meet through a ``FileStore`` under ``tmp_path`` (no port to
collide over between test workers), every group has a timeout, and the
join has a limit, so a hang fails the test instead of spending the run.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD, SMALL_WORLD = 8, 4
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
JOIN_LIMIT_S = 240.0
# The reference's _SHARD_SCRIPT cases, and RecurrentGemma-2B, whose
# forward also goes through flash_attention's and linear_scan's rules.
ARCHS = ("yi-6b", "deepseek-v2-236b", "rwkv6-7b", "recurrentgemma-2b")
INT8 = "deepseek-v2-236b-int8"     # the config's own int8 moments
STEP_ARCHS = ARCHS[:3] + (INT8,)
UPDATE_ARCHS = ("yi-6b", INT8)
UPDATES = 3
KERNEL_IMPL_ARCH = "recurrentgemma-2b"
B, S = 8, 16
LR = 1e-3
# float32 on the same CPU: the placed functions add partial sums in
# another order (a product split over model, sums over the data shards).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4        # of the leaf's largest |g|
PARAM_TOL = 1e-5       # per element, after one AdamW step ...
PARAM_FLIP_SHARE = 1e-3  # ... but for at most this share of elements
                         # within 2 lr: Adam's first step is sign(g), and
                         # a gradient at noise level may flip its sign
CODE_OFF_SHARE = 1e-3    # int8 moments: codes equal but for this share,
                         # one apart (tests/test_torch_optim.py's bound)


def _cfg(arch: str):
    from repro_torch.configs import ARCHS as CONFIGS, reduced
    int8 = arch == INT8
    cfg = reduced(CONFIGS[arch.removesuffix("-int8")])
    if not cfg.moe_n_experts:
        return cfg
    # Capacity that drops nothing: each data shard sizes its capacity
    # from its own tokens (the reference's rule), so a drop would differ
    # legitimately from the single-device dispatch. The float32 case keeps
    # the moments of the other configs, the int8 case the config's own.
    cfg = cfg.scaled(moe_capacity_factor=8.0)
    return cfg if int8 else cfg.scaled(opt_moment_dtype="float32")


def _batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _full(tree):
    """Each leaf gathered whole, a copy (a replicated DTensor's
    ``full_tensor`` is its own local tensor, which a step writes into); an
    optimizer state field by field."""
    from repro_torch.optim.adamw import tree_map
    if isinstance(tree, tuple):
        return type(tree)(*(None if t is None else _full(t) for t in tree))
    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                               else t).detach().clone(), tree)


def _value(t) -> float:
    """A 0-d result as a float: a placed one gathered first."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _leaves(tree) -> list:
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def _ref_value_and_grad(params, cfg, batch, n_shards: int):
    """The single-device counterpart of the placed loss's gradient: the
    cross-entropy of the whole batch plus 0.01 x the mean of each data
    shard's aux loss (the function the mesh computes; without a MoE,
    ``loss_fn``)."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as T
    if not cfg.moe_n_experts:
        return STEPS.value_and_grad(params, cfg, batch)
    leaves = _leaves(params)
    T.trainable(params)
    try:
        _, metrics = T.loss_fn(params, cfg, batch)
        rows = B // n_shards
        aux = sum(T.forward(params, cfg,
                            {"tokens": batch["tokens"][i:i + rows]})[2]
                  for i in range(0, B, rows)) / n_shards
        total = metrics["loss"] + 0.01 * aux
        grads = torch.autograd.grad(total, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(grads)
    from repro_torch.optim.adamw import tree_map
    return ((total.detach(), {"loss": metrics["loss"].detach(),
                              "aux": aux.detach()}),
            tree_map(lambda p: next(it), params))


def _ref_step(params, cfg, batch, n_shards: int, value_and_grad=None,
              opt=None):
    """The single-device step in the config's moment dtype, from ``opt``
    (fresh moments by default); returns (params, metrics, opt)."""
    from repro_torch import optim
    from repro_torch.launch import steps as STEPS
    (_, metrics), grads = value_and_grad or _ref_value_and_grad(
        params, cfg, batch, n_shards)
    if opt is None:
        opt = optim.adamw_init(params, cfg.opt_moment_dtype)
    params, opt, gn = STEPS.apply_grads(params, grads, opt, lr=LR,
                                        moment_dtype=cfg.opt_moment_dtype)
    return params, dict(metrics, grad_norm=gn), opt


def _codes(tree) -> list:
    """The int8 codes of a moment tree, in order."""
    from repro_torch.runtime.sharding import is_q8
    if is_q8(tree):
        return [tree]
    nodes = tree.values() if isinstance(tree, dict) else tree
    return [c for v in nodes for c in _codes(v)]


def _code_err(want, got) -> dict:
    """Between two int8 moment states: the share of codes that differ,
    their largest difference, the largest distance of a code's scales over
    its largest scale, and whether the shape codes are equal."""
    off = n = worst = 0
    scale_rel = 0.0
    shapes = True
    for a, b in zip(_codes(want.mu) + _codes(want.nu),
                    _codes(got.mu) + _codes(got.nu)):
        d = (a["q"].int() - b["q"].int()).abs()
        off, n = off + int((d > 0).sum()), n + d.numel()
        worst = max(worst, int(d.max()))
        scale_rel = max(scale_rel, float((a["scale"] - b["scale"]).abs().max()
                                         / a["scale"].abs().max()))
        shapes &= torch.equal(a["shape"], b["shape"])
    return {"code_off_share": off / n, "code_max_diff": worst,
            "scale_rel": scale_rel, "shapes_equal": shapes}


def _param_err(want: list, got: list) -> dict:
    """The largest |difference| of the stepped params, and the share of
    elements further apart than ``PARAM_TOL``."""
    diffs = [(a - b).abs().reshape(-1) for a, b in zip(want, got)]
    d = torch.cat(diffs)
    return {"max_err": float(d.max()),
            "over_tol_share": float((d > PARAM_TOL).float().mean())}


def _allreduce_transposes(mesh) -> dict:
    """d(sum(c * y)) / d(w_r) for y = sum_r x w_r, w_r each ``model``
    rank's own (an expert shard), whose true value is x^T c: through a
    ``Partial`` output of ``local_map`` (the port's combine) and through
    ``torch.distributed.nn.functional.all_reduce``. Ratios to the true
    gradient."""
    from torch.distributed.nn.functional import all_reduce
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    g = torch.Generator().manual_seed(7)
    x, c = torch.randn(4, 3, generator=g), torch.randn(4, 5, generator=g)
    want = x.T @ c
    out = {}
    w = torch.randn(3, 5, generator=g, requires_grad=True)
    y = all_reduce(x @ w, group=mesh.get_group("model"))
    (gw,) = torch.autograd.grad((c * y).sum(), w)
    out["nn_functional_all_reduce"] = float((gw / want).mean())
    w = torch.randn(1, 3, 5, generator=g, requires_grad=True)
    shard = [Replicate(), Shard(0)]
    y = local_map(lambda w_loc: x @ w_loc[0],
                  out_placements=[Replicate(), Partial()],
                  in_placements=(shard,), device_mesh=mesh)(
        DTensor.from_local(w, mesh, shard))
    y = y.redistribute(mesh, (Replicate(), Replicate()))
    (gw,) = torch.autograd.grad((c * y.to_local()).sum(), w)
    out["partial_output"] = float((gw[0] / want).mean())
    return out


def _phase_4x2(rank: int, ckdir: str) -> dict:
    from repro_torch import checkpointing as ckpt
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    mesh = M.make_debug_mesh(4, 2, device_type="cpu")
    out: dict = {"loss": {}, "step": {}}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = T.init_params(cfg, seed=0, device="cpu",
                               dtype=torch.float32)
        batch = _batch(cfg)
        placed = SH.place(params, SH.param_shardings(cfg, mesh, params,
                                                     fsdp=False))
        pbatch = SH.place(batch, SH.batch_shardings(mesh, batch))
        row: dict = {}
        if arch == KERNEL_IMPL_ARCH:
            # Attention through flash_attention's wrapper (its plain
            # version on CPU shards), as the card's forward takes it.
            L.set_attention_impl("kernel")
            try:
                with M.set_mesh(mesh):
                    row["placed_kernel_impl"] = _value(
                        T.loss_fn(placed, cfg, pbatch)[0])
            finally:
                L.set_attention_impl(None)
        if cfg.moe_n_experts:
            # Two rows do not split over 4 data ranks: the batch is
            # replicated there, and the aux loss is the whole batch's.
            small = {k: v[:2] for k, v in batch.items()}
            with M.set_mesh(mesh):
                t2, m2 = T.loss_fn(placed, cfg, SH.place(
                    small, SH.batch_shardings(mesh, small)))
            row["unsplit"] = [_value(t2), _value(m2["aux"])]
            if rank == 0:
                w2, wm2 = T.loss_fn(params, cfg, small)
                row["unsplit_single"] = [float(w2), float(wm2["aux"])]
        if rank == 0:
            ref = _ref_value_and_grad(params, cfg, batch, 4)
            (want, want_m), _ = ref
            row["single"] = [float(want), float(want_m["loss"]),
                             float(want_m["aux"])]
        L.moe_apply.calls_by_path = {"local": 0, "expert_parallel": 0}
        if arch not in STEP_ARCHS:
            with M.set_mesh(mesh):
                total, metrics = T.loss_fn(placed, cfg, pbatch)
            row["placed"] = [_value(total), _value(metrics["loss"]),
                             _value(metrics["aux"])]
            row["paths"] = dict(L.moe_apply.calls_by_path)
            out["loss"][arch] = row
            continue
        # The step's own loss is the placed loss (before its update).
        before = [t.placements for t in _leaves(placed)]
        opt = optim.adamw_init(placed)
        step = STEPS.make_train_step(cfg, lr=LR, remat=False)
        with M.set_mesh(mesh):
            new, _, m = step(placed, opt, pbatch)
        loss, aux = _value(m["loss"]), _value(m["aux"])
        row["placed"] = [loss + 0.01 * aux, loss, aux]
        row["paths"] = dict(L.moe_apply.calls_by_path)
        out["loss"][arch] = row
        got = _full(new)
        srow = {"loss": loss, "grad_norm": _value(m["grad_norm"]),
                "placements_kept": [t.placements for t in _leaves(new)]
                == before and all(
                    a is b for a, b in zip(_leaves(placed), _leaves(new)))}
        if rank == 0:
            ref, ref_m, _ = _ref_step(params, cfg, batch, 4, ref)
            srow.update(ref_loss=float(ref_m["loss"]),
                        ref_grad_norm=float(ref_m["grad_norm"]),
                        **_param_err(_leaves(ref), _leaves(got)))
        out["step"][arch] = srow
        if arch == "yi-6b":
            ckpt.save(ckdir, 1, new)
            out["saved"] = got
    out["step"][INT8] = _int8_step(rank, mesh, ckdir + "8", out)
    out["update"] = {arch: _updates_bit_for_bit(mesh, _cfg(arch))
                     for arch in UPDATE_ARCHS}
    out["transposes"] = _allreduce_transposes(mesh)
    return out


def _int8_step(rank: int, mesh, ckdir: str, out: dict) -> dict:
    """DeepSeek-V2's placed step with its config's int8 moments against
    the single-device step; the stepped state saved (params and moments)
    for ``_phase_2x2``, and kept whole in ``out["saved8"]``."""
    from repro_torch import checkpointing as ckpt
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    cfg = _cfg(INT8)
    params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    placed = SH.place(params, SH.param_shardings(cfg, mesh, params,
                                                 fsdp=False))
    opt = optim.adamw_init(placed, "int8")
    with M.set_mesh(mesh):
        new, opt, m = STEPS.make_train_step(cfg, lr=LR, remat=False)(
            placed, opt, SH.place(batch, SH.batch_shardings(mesh, batch)))
    row = {"loss": _value(m["loss"]), "grad_norm": _value(m["grad_norm"]),
           "placements_kept": all(a is b for a, b in zip(
               _leaves(placed), _leaves(new)))}
    got, got_opt = _full(new), _full(opt)
    if rank == 0:
        ref, ref_m, ref_opt = _ref_step(params, cfg, batch, 4)
        row.update(ref_loss=float(ref_m["loss"]),
                   ref_grad_norm=float(ref_m["grad_norm"]),
                   **_param_err(_leaves(ref), _leaves(got)),
                   **_code_err(ref_opt, got_opt))
        out["saved8"] = (got, got_opt)
    ckpt.save(ckdir, 1, (new, opt))
    return row


def _flat_specs(params) -> dict:
    """Each leaf's dim 0 over (data, model) where it divides them, the
    rest whole: a fully sharded data-parallel placement."""
    from repro_torch.runtime import sharding as SH
    return SH.map_with_path(
        lambda _, t: ((("data", "model"),) + (None,) * (t.ndim - 1)
                      if t.ndim and t.shape[0] % WORLD == 0
                      else (None,) * t.ndim), params)


def _last_dims_specs(params) -> dict:
    """A leaf's second-last dim over data and its last over model where
    they divide, the rest whole: a box of a 3-D leaf then falls on runs at
    two strides (the transfer's index path)."""
    from repro_torch.runtime import sharding as SH

    def one(_, t):
        if t.ndim < 2 or t.shape[-2] % 4 or t.shape[-1] % 2:
            return (None,) * t.ndim
        return (None,) * (t.ndim - 2) + ("data", "model")

    return SH.map_with_path(one, params)


def _updates_bit_for_bit(mesh, cfg) -> dict:
    """UPDATES placed ``adamw_update`` calls with int8 moments against the
    unplaced ones on the same values (seeded gradients, the same on every
    rank, placed with the params), under ``param_shardings``, the fully
    sharded placement and the last two dims split: whether every param,
    code and scale is equal, each leaf's layout case, and the transfer's
    count of one update."""
    from repro_torch import optim
    from repro_torch.optim import adamw as A
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    row = {}
    for name, sh in (
            ("param_shardings", SH.param_shardings(cfg, mesh, params,
                                                   fsdp=False)),
            *((name, SH.map_with_path(
                lambda _, spec: SH.named_sharding(mesh, spec), specs(params)))
              for name, specs in (("fully_sharded", _flat_specs),
                                  ("last_dims", _last_dims_specs)))):
        placed = SH.place(params, sh)
        single = A.tree_map(torch.clone, params)
        opt_p = optim.adamw_init(placed, "int8")
        opt_s = optim.adamw_init(single, "int8")
        cases = [A.layout_case(p, c["q"])
                 for p, c in zip(_leaves(placed), _codes(opt_p.mu))]
        for i in range(UPDATES):
            gen = torch.Generator().manual_seed(100 + i)
            grads = A.tree_map(lambda t: torch.randn(t.shape, generator=gen),
                               params)
            A.reset_transfer_counts()
            placed, opt_p = optim.adamw_update(
                placed, SH.place(grads, sh), opt_p, lr=LR * 10,
                moment_dtype="int8")
            single, opt_s = optim.adamw_update(single, grads, opt_s,
                                               lr=LR * 10,
                                               moment_dtype="int8")
        full_p, full_o = _full(placed), _full(opt_p)
        differ = [i for i, (a, b) in enumerate(zip(
            _leaves(full_p) + _leaves(full_o.mu) + _leaves(full_o.nu),
            _leaves(single) + _leaves(opt_s.mu) + _leaves(opt_s.nu)))
            if not torch.equal(a, b)]
        row[name] = {"differ": differ, "leaves": len(cases),
                     "cases": sorted(set(cases)),
                     "transfer": dict(A.transfer_counts)}
    return row


def _phase_2x2_int8(rank: int, ckdir: str, saved) -> dict:
    """The int8 state saved under (4, 2), restored onto (2, 2) with its
    codes placed by the block rule on the new mesh: bit for bit the saved
    values; one more step there against the single-device step from the
    saved state."""
    from repro_torch import checkpointing as ckpt
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    cfg = _cfg(INT8)
    mesh = M.make_debug_mesh(2, 2, device_type="cpu")
    like = T.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    psh = SH.param_shardings(cfg, mesh, like, fsdp=False)
    like = SH.place(like, psh)
    like_opt = optim.adamw_init(like, "int8")
    params, opt = ckpt.restore_resharded(
        ckdir, 1, (like, like_opt),
        (psh, SH.opt_shardings(mesh, like_opt, psh)))
    out = {"code_placements": sorted({str(c["q"].placements)
                                      for c in _codes(opt.mu)})}
    full, full_opt = _full(params), _full(opt)
    if rank == 0:
        want_p, want_o = saved
        out["bit_for_bit"] = all(torch.equal(a, b) for a, b in zip(
            _leaves(want_p) + _leaves(want_o.mu) + _leaves(want_o.nu)
            + [want_o.step],
            _leaves(full) + _leaves(full_opt.mu) + _leaves(full_opt.nu)
            + [full_opt.step]))
    batch = _batch(cfg)
    with M.set_mesh(mesh):
        _, _, m = STEPS.make_train_step(cfg, lr=LR, remat=False)(
            params, opt, SH.place(batch, SH.batch_shardings(mesh, batch)))
    out["loss"] = _value(m["loss"])
    if rank == 0:
        out["ref_loss"] = float(_ref_step(full, cfg, batch, 2,
                                          opt=full_opt)[1]["loss"])
    return out


def _phase_2x2(rank: int, ckdir: str, saved, saved8) -> dict:
    from repro_torch import checkpointing as ckpt
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    cfg = _cfg("yi-6b")
    mesh = M.make_debug_mesh(2, 2, device_type="cpu")
    like = T.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    restored = ckpt.restore_resharded(
        ckdir, 1, like, SH.param_shardings(cfg, mesh, like, fsdp=False))
    full = _full(restored)
    out = {"placements": sorted({str(t.placements)
                                 for t in _leaves(restored)})}
    if rank == 0:
        out["bit_for_bit"] = all(torch.equal(a, b) for a, b in zip(
            _leaves(saved), _leaves(full)))
    batch = _batch(cfg)
    with M.set_mesh(mesh):
        _, _, m = STEPS.make_train_step(cfg, lr=LR, remat=False)(
            restored, optim.adamw_init(restored),
            SH.place(batch, SH.batch_shardings(mesh, batch)))
    out["loss"] = _value(m["loss"])
    if rank == 0:
        out["ref_loss"] = float(_ref_step(full, cfg, batch, 2)[1]["loss"])
    out["int8"] = _phase_2x2_int8(rank, ckdir + "8", saved8)
    return out


def _worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    ckdir = os.path.join(root, "ckpt")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store8"), WORLD),
        rank=rank, world_size=WORLD, timeout=GROUP_TIMEOUT)
    try:
        res = _phase_4x2(rank, ckdir)
    finally:
        dist.destroy_process_group()
    if rank < SMALL_WORLD:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, "store4"),
                                         SMALL_WORLD),
            rank=rank, world_size=SMALL_WORLD, timeout=GROUP_TIMEOUT)
        try:
            res["rescaled"] = _phase_2x2(rank, ckdir, res.get("saved"),
                                         res.get("saved8"))
        finally:
            dist.destroy_process_group()
    res.pop("saved", None)
    res.pop("saved8", None)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    root = str(tmp_path_factory.mktemp("gloo"))
    ctx = mp.start_processes(_worker, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish in "
                                   f"{JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    out = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_loss_matches_single_device(ranks, arch):
    """The placed loss on (4, 2) equals single-device ``loss_fn`` within
    float32 rounding on every rank, with attention on the plain cores
    (and RecurrentGemma-2B's also through ``flash_attention``'s rule, its
    RG-LRU through ``linear_scan``'s); DeepSeek-V2 took the
    expert-parallel MoE (and no local one), the others no MoE."""
    want = ranks[0]["loss"][arch]["single"]
    for r in ranks:
        got = r["loss"][arch]
        np.testing.assert_allclose(got["placed"], want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        if arch == KERNEL_IMPL_ARCH:
            np.testing.assert_allclose(got["placed_kernel_impl"], want[0],
                                       rtol=LOSS_TOL)
        n_moe = sum(k.endswith("moe") for k in _cfg(arch).layer_kinds())
        assert got["paths"] == {"local": 0, "expert_parallel": n_moe}
        if n_moe:
            np.testing.assert_allclose(
                got["unsplit"], ranks[0]["loss"][arch]["unsplit_single"],
                rtol=LOSS_TOL)
    assert (sum(k.endswith("moe") for k in _cfg(arch).layer_kinds()) > 0) \
        == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_placed_train_step_matches_single_device(ranks, arch):
    """One placed ``make_train_step`` (AdamW in place: the same tensors,
    their placements kept) gives the single-device step's loss, grad norm
    and params; float32 moments, and DeepSeek-V2's own int8 moments, whose
    codes are held to the CPU tests' int8 bound (the clip's global norm is
    a sum over shards, so the step is held to tolerances, not bits) and
    whose scales, each block's largest moment, to twice the gradient's
    tolerance (the second moment squares the gradient)."""
    row = ranks[0]["step"][arch]
    assert all(r["step"][arch]["placements_kept"] for r in ranks)
    np.testing.assert_allclose(row["loss"], row["ref_loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(row["grad_norm"], row["ref_grad_norm"],
                               rtol=GRAD_TOL)
    assert row["max_err"] <= 2 * LR, row
    assert row["over_tol_share"] <= PARAM_FLIP_SHARE, row
    if arch == INT8:
        assert row["code_off_share"] <= CODE_OFF_SHARE, row
        assert row["code_max_diff"] <= 1 and row["shapes_equal"], row
        assert row["scale_rel"] <= 2 * GRAD_TOL, row


@pytest.mark.parametrize("arch", UPDATE_ARCHS)
def test_placed_int8_update_is_bit_for_bit(ranks, arch):
    """Three placed ``adamw_update`` calls with int8 moments equal the
    unplaced ones bit for bit on every rank (params, codes, scales), under
    ``param_shardings``, a fully sharded placement and one splitting each
    leaf's last two dims (runs at two strides: the transfer's index path);
    the leaves of the two configs reach every layout case (1: no data
    moves, 2: elements move, 3: one side replicated)."""
    seen = set()
    for r in ranks:
        for name, row in r["update"][arch].items():
            assert row["differ"] == [], (name, row)
            seen |= set(row["cases"])
    rows = ranks[0]["update"][arch]
    assert rows["param_shardings"]["transfer"]["calls"] > 0
    assert {1, 2, 3} <= {c for a in UPDATE_ARCHS for row in ranks[0][
        "update"][a].values() for c in row["cases"]}


def test_restore_resharded_int8_state_onto_a_smaller_mesh(ranks):
    """DeepSeek-V2's stepped int8 state saved under (4, 2), restored onto
    (2, 2) by ``restore_resharded`` with ``opt_shardings``: every param,
    code, scale and the step bit for bit, the codes placed by the block
    rule on the new mesh; one more step there gives the single-device
    step's loss from the saved state."""
    row = ranks[0]["rescaled"]["int8"]
    assert row["bit_for_bit"]
    assert "(Shard(dim=0), Shard(dim=0))" in row["code_placements"], row
    for r in ranks[:SMALL_WORLD]:
        np.testing.assert_allclose(r["rescaled"]["int8"]["loss"],
                                   row["ref_loss"], rtol=LOSS_TOL)


def test_restore_resharded_onto_a_smaller_mesh(ranks):
    """Saved under (4, 2), restored onto (2, 2) in a 4-rank group: the
    saved values bit for bit, placed on the new mesh; one more step there
    gives the single-device step's loss from the same params."""
    row = ranks[0]["rescaled"]
    assert row["bit_for_bit"]
    assert any("Shard" in p for p in row["placements"]), row
    for r in ranks[:SMALL_WORLD]:
        np.testing.assert_allclose(r["rescaled"]["loss"], row["ref_loss"],
                                   rtol=LOSS_TOL)
    assert all("rescaled" not in r for r in ranks[SMALL_WORLD:])


def test_expert_parallel_combine_transpose(ranks):
    """The combine's gradient: a ``Partial`` output of ``local_map`` hands
    each rank the whole output gradient (ratio 1 to the true one), which
    is what the reference's psum transposes to; ``all_reduce`` of
    ``torch.distributed.nn.functional`` all-reduces it again, T (2) times
    the true one: the port does not combine through it."""
    t = ranks[0]["transposes"]
    print(t)
    assert t["partial_output"] == pytest.approx(1.0, rel=1e-6)
    assert t["nn_functional_all_reduce"] == pytest.approx(2.0, rel=1e-6)
