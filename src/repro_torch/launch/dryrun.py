"""Dry run on the ``meta`` device: every (architecture x input shape) cell
on the production mesh's shape, with nothing allocated, the port of
``repro/launch/dryrun.py``. Each cell builds the params (int8 with
``--quant int8``), the optimizer state, the cache and the batch on meta,
runs the step the reference lowers (train: ``value_and_grad`` then
``apply_grads``; prefill: ``make_prefill_step``; decode:
``make_serve_step``, one token against a cache full but for it) under
``torch.utils.flop_counter.FlopCounterMode``, and reports

  * ``memory``: ``argument_size_in_bytes``, the bytes one device holds of
    the step's arguments under the sharding rules (``runtime/sharding.py``,
    ``shard_bytes``), and ``output_size_in_bytes``, the same for its
    outputs (params, optimizer state and cache under their inputs' specs,
    the rest under the batch rule). XLA's ``temp_size_in_bytes`` (the
    compiled program's scratch) has no counterpart: nothing is compiled;
  * ``cost``: ``flops``, the whole step's FLOPs as ``FlopCounterMode``
    counts them (matrix products, convolutions and attention; no
    elementwise work), and ``flops_over_n_devices``, that total divided
    by the mesh's device count;
  * ``collectives``: ``count_per_kind``, ``bytes_per_kind`` and
    ``total_bytes``, the reference's keys, from a second trace of the same
    step with its arguments placed on the mesh (DTensors under
    ``runtime/sharding.py``'s shardings, the MoE expert-parallel) in a
    ``fake`` process group of the mesh's size, one process standing for
    every rank, under ``CommDebugMode``: each collective the port
    dispatches, counted by kind, and the bytes of its operand on one rank.
    The reference reads them from XLA's partitioned HLO
    (``launch/hlo_stats.py``), which fuses and schedules collectives; the
    port's are its eager dispatch's (a recorded divergence). A config
    with int8 AdamW moments (DeepSeek-V2/V3) updates each leaf where its
    block codes live: the update's layout transfer shows as
    ``all-to-all`` (``optim/adamw.py``; the record also keeps the
    transfer's own count of it, on one rank, as ``update_transfer``).

``--dist pipeline`` runs the reference's ``_run_pipeline_cell``: the
allocator's plan (``plan_pipeline`` over ``lm_layer_workloads``, the
production mesh's model axis as stage x tp), K = max(1, min(the plan's
microbatches, global batch // (16 x pods))), the params at uniform
boundaries (the reference builds them so, whatever the plan's), every slot
computing (the reference's all-True mask), and the pipelined loss with its
gradient (train) or the prefill traced for one rank (stage 0, tp 0) on
``meta`` in a fake group of the pipeline mesh's size. ``cost.flops`` is that
rank's count times the device count (every rank runs the same shapes), and
``collectives`` counts its all-reduces by dispatch and the stage hand-off's
sends (``collective-permute``, counted by ``core/pipeline.py`` itself:
``CommDebugMode`` sees no point-to-point op). ``plan.predicted_util`` is the
allocator's model of a TPU v5e mesh (``hw=V5E``), not a figure for the
card. As in the reference, a decode shape raises (the sweep records
``"error"``), and a config whose dominant unit kind the pipeline does not
take returns ``"unsupported"``, which ``run_cell`` then overwrites with
``"ok"`` (a fault of the reference, reproduced: ROADMAP C9). Unlike the
reference's, this module sets no ``XLA_FLAGS``: it imports no JAX.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
  python -m repro_torch.launch.dryrun --all --mesh pod --jobs 8
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k \\
      --quant int8
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --dist pipeline --stages 4    # the paper's pipeline path
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import optim
from repro_torch.configs import ARCHS, get as get_arch
from repro_torch.core import pipeline as PL
from repro_torch.core.allocator import plan_pipeline
from repro_torch.core.workload import lm_layer_workloads
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import (build_mesh, fake_process_group,
                                     production_mesh_shape, set_mesh)
from repro_torch.launch.shapes import (SHAPES, ShapeCase, cache_specs,
                                       cell_is_runnable, input_specs)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState
from repro_torch.runtime import sharding as SH

COLLECTIVES_NOTE = ("counted from the placed step's dispatch in a fake "
                    "process group of the mesh's size (CommDebugMode), bytes "
                    "the operand's on one rank; the reference reads XLA's "
                    "partitioned HLO (launch/hlo_stats.py)")
# Collective ops by the reference's kind names (hlo_stats.py).
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "broadcast"), ("send", "collective-permute"),
          ("recv", "collective-permute"))
PIPELINE_COLLECTIVES_NOTE = (
    "one rank's (stage 0, tp 0) pipelined step in a fake process group of "
    "the pipeline mesh's size: its all-reduces by dispatch (CommDebugMode), "
    "bytes the operand's; collective-permute the stage hand-off's sends, "
    "counted by core/pipeline.py (stage 0 sends in the forward only)")
PREDICTED_UTIL_OF = ("the allocator's model of a TPU v5e mesh (hw=V5E), "
                     "not a figure for the H100")
NO_TEMP = ("no counterpart: XLA's temp_size_in_bytes is the compiled "
           "program's scratch; nothing is compiled here")


def run_cell(arch: str, shape: str, mesh_name: str, dist: str = "pjit",
             stages: int = 0, quant: str = "none") -> dict:
    """One cell's record: ``status`` ``"skipped"`` (with the reason) or
    ``"ok"`` with ``trace_cell``'s (or ``trace_pipeline_cell``'s) numbers
    and ``compile_s``, the seconds to build and trace it. ``stages`` belongs
    to ``--dist pipeline``."""
    cfg = get_arch(arch)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = production_mesh_shape(multi_pod=(mesh_name == "multipod"))
    t0 = time.time()
    if dist == "pipeline":
        res = trace_pipeline_cell(cfg, SHAPES[shape], mesh, stages)
    else:
        res = trace_cell(cfg, SHAPES[shape], mesh, dp_model=(dist == "dp"),
                         quant=quant)
    # As in the reference, this overwrites a pipeline cell's "unsupported"
    # (ROADMAP C9).
    res.update(arch=arch, shape=shape, mesh=mesh_name, dist=dist,
               quant=quant, compile_s=round(time.time() - t0, 1),
               status="ok")
    return res


def trace_cell(cfg, case: ShapeCase, mesh: dict, dp_model: bool = False,
               quant: str = "none") -> dict:
    """Build the cell's arguments on meta, run its step under
    ``FlopCounterMode`` and count bytes per device under the rules."""
    n_dev = math.prod(mesh.values())
    batch = input_specs(cfg, case)
    if dp_model:
        # Repurpose the model axis as extra data parallelism (small-model
        # optimization): params replicated over it, batch sharded over
        # (pod, data, model).
        batch_sp = dp_batch_specs(mesh, batch)
    else:
        batch_sp = SH.batch_specs(mesh, batch,
                                  seq_shard=(case.mode == "prefill"))

    if case.mode == "train":
        params, opt = STEPS.abstract_state(cfg)
        param_sp = SH.param_specs(cfg, mesh, params,
                                  fsdp=None if not dp_model else False)
        if dp_model:
            param_sp = SH.map_with_path(lambda _, s: strip_model_axis(s),
                                        param_sp)
        opt_sp = opt_specs(opt, param_sp, mesh)
        step = STEPS.make_train_step(cfg)
        with FlopCounterMode(display=False) as fc:
            params, opt, metrics = step(params, opt, batch)
        args = [(params, param_sp), (opt, opt_sp), (batch, batch_sp)]
        outs = [(params, param_sp), (opt, opt_sp),
                (metrics, SH.batch_specs(mesh, metrics))]
    else:
        params = T.init_params(cfg, device="meta")
        if quant == "int8":
            params = L.quantize_params_int8(params)
        param_sp = SH.param_specs(cfg, mesh, params)
        cache = cache_specs(cfg, case)
        if case.mode == "decode":
            cache = _full(cache, case.seq_len - 1)
        cache_sp = SH.cache_specs(mesh, cache)
        step = (STEPS.make_prefill_step(cfg) if case.mode == "prefill"
                else STEPS.make_serve_step(cfg))
        args = [(params, param_sp), (cache, cache_sp), (batch, batch_sp)]
        with FlopCounterMode(display=False) as fc:
            out, new_cache = step(params, cache, batch)
        outs = [(out, SH.batch_specs(mesh, out)),
                (new_cache, SH.cache_specs(mesh, new_cache))]
    flops = fc.get_total_flops()
    collectives, note = _placed_collectives(cfg, case, mesh, args)
    res = {
        "memory": {
            "argument_size_in_bytes": sum(
                SH.tree_shard_bytes(t, sp, mesh) for t, sp in args),
            "output_size_in_bytes": sum(
                SH.tree_shard_bytes(t, sp, mesh) for t, sp in outs),
            "temp_size_in_bytes": None, "temp_note": NO_TEMP},
        "cost": {"flops": float(flops),
                 "flops_over_n_devices": flops / n_dev},
        "collectives": collectives, "collectives_note": note,
        "n_devices": n_dev, "mesh_shape": dict(mesh)}
    if case.mode == "train" and cfg.opt_moment_dtype == "int8":
        res["update_transfer"] = dict(optim.adamw.transfer_counts)
    return res


def _kind(op_name: str) -> str | None:
    return next((kind for key, kind in _KINDS if key in op_name), None)


class _CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that also sums, by kind, the bytes of each
    collective's operand on one rank (its first tensor argument, or the
    first of its tensor list: ``c10d``'s in-place ops take a list), as
    ``hlo_stats.collective_bytes`` sums operand bytes per device."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = None if out is NotImplemented else \
            _kind(str(func._overloadpacket))
        if kind is not None:
            t = next(a for a in pytree.tree_leaves(args)
                     if isinstance(a, torch.Tensor))
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + \
                t.numel() * t.element_size()
        return out


def _placed_collectives(cfg, case: ShapeCase, mesh: dict,
                        args: list) -> tuple[dict, str]:
    """The step of ``trace_cell`` again, its arguments (``args``: (tree,
    specs) pairs, params first) placed on a meta mesh of ``mesh``'s shape
    in a fake process group: the collectives it dispatches, by kind."""
    optim.adamw.reset_transfer_counts()
    with fake_process_group(math.prod(mesh.values())):
        dmesh = build_mesh(mesh, "meta")
        placed = [SH.place(tree, SH.map_with_path(
            lambda _, spec: SH.named_sharding(dmesh, spec), specs))
            for tree, specs in args]
        with _CollectiveBytes() as cm, set_mesh(dmesh):
            if case.mode != "train":
                step = (STEPS.make_prefill_step(cfg)
                        if case.mode == "prefill"
                        else STEPS.make_serve_step(cfg))
                step(*placed)
            else:
                STEPS.make_train_step(cfg)(*placed)
        counts: dict[str, int] = {}
        for op, n in cm.get_comm_counts().items():
            kind = _kind(str(op)) or str(op)
            counts[kind] = counts.get(kind, 0) + n
    return {"count_per_kind": counts, "bytes_per_kind": cm.bytes_by_kind,
            "total_bytes": sum(cm.bytes_by_kind.values())}, COLLECTIVES_NOTE


def pipeline_plan(cfg, case: ShapeCase, mesh: dict, stages: int = 0):
    """The reference's plan for a pipelined cell: ``plan_pipeline`` over
    the config's layer workloads, the mesh's model axis split into stage x
    tp (``stages`` fixes S), and the microbatch count K it traces. Returns
    (plan, K)."""
    n_pod = mesh.get("pod", 1)
    train = case.mode == "train"
    layers = lm_layer_workloads(cfg, seq_len=case.seq_len,
                                batch=case.global_batch, mode=case.mode)
    plan = plan_pipeline(
        layers, model_axis=mesh["model"], data_axis=mesh["data"] * n_pod,
        global_batch=case.global_batch, seq_len=case.seq_len, train=train,
        d_model=cfg.d_model, allow_infeasible=not train,
        stage_choices=[stages] if stages else None)
    K = max(1, min(plan.microbatches,
                   case.global_batch // (mesh["data"] * n_pod)))
    return plan, K


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in tensors}.values())


def trace_pipeline_cell(cfg, case: ShapeCase, mesh: dict,
                        stages: int = 0) -> dict:
    """The reference's ``_run_pipeline_cell`` on ``meta``: the plan, then
    one rank's pipelined step traced in a fake group of the pipeline mesh's
    size (the module docstring says what is counted)."""
    if case.mode not in ("train", "prefill"):
        raise ValueError("pipeline dry-run covers train/prefill shapes")
    if not PL.supports_pipeline(cfg):
        return {"status": "unsupported", "reason": "unit kind"}
    train = case.mode == "train"
    plan, K = pipeline_plan(cfg, case, mesh, stages)
    S, T_ = plan.n_stages, plan.tensor_parallel
    n_pod = mesh.get("pod", 1)
    n_dev = mesh["data"] * n_pod * S * T_
    batch = input_specs(cfg, case)
    with fake_process_group(n_dev):
        pmesh = PL.make_pipeline_mesh(mesh["data"], S, T_, n_pod,
                                      device_type="meta")
        pm = PL.PipelineCoords.of(pmesh)
        params, kind = PL.build_pipeline_params(cfg, S, abstract=True,
                                                coords=pm)
        every_slot = [True] * len(params["units"])
        ctx = PL.PipelineContext(cfg=cfg, unit_kind=kind, S=S, T=T_,
                                 n_micro=K)
        leaves = [t for t in T._leaves({k: v for k, v in params.items()
                                        if k != "unit_mask"})
                  if t.is_floating_point()]
        PL.reset_comm_counts()
        with FlopCounterMode(display=False) as fc, _CollectiveBytes() as cm:
            if train:
                for t in leaves:
                    t.requires_grad_(True)
                loss = PL.pipeline_loss_fn(ctx, pmesh, every_slot)(params,
                                                                   batch)
                torch.autograd.grad(loss, leaves, allow_unused=True)
                out_bytes = _bytes(leaves)
            else:
                logits = PL.pipeline_prefill_fn(ctx, pmesh, every_slot)(
                    params, batch)
                out_bytes = _bytes([logits])
        counts: dict[str, int] = {}
        for op, n in cm.get_comm_counts().items():
            kind_ = _kind(str(op)) or str(op)
            counts[kind_] = counts.get(kind_, 0) + n
    permute = PL.comm_counts["collective-permute"]
    counts["collective-permute"] = permute["calls"]
    by_kind = dict(cm.bytes_by_kind, **{"collective-permute":
                                        permute["bytes"]})
    rows = pm.rows(case.global_batch)
    flops = fc.get_total_flops()
    return {
        "memory": {
            "argument_size_in_bytes": _bytes(leaves) + sum(
                t[rows].numel() * t.element_size() for t in batch.values()),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": None, "temp_note": NO_TEMP},
        "cost": {"flops": float(flops * n_dev),
                 "flops_over_n_devices": float(flops)},
        "collectives": {"count_per_kind": counts, "bytes_per_kind": by_kind,
                        "total_bytes": sum(by_kind.values())},
        "collectives_note": PIPELINE_COLLECTIVES_NOTE,
        "n_devices": n_dev, "mesh_shape": PL.mesh_axes(
            mesh["data"], S, T_, n_pod),
        "plan": {"S": S, "T": T_, "microbatches": K,
                 "boundaries": list(plan.boundaries)[:8],
                 "predicted_util": plan.utilization,
                 "predicted_util_of": PREDICTED_UTIL_OF}}


def _full(cache: dict, pos: int) -> dict:
    """``cache`` with every ``idx`` and ``_pos`` at ``pos`` (host ints): a
    decode step's token then attends over the whole context, as the
    reference's masked buffer does, on every path (MLA's absorbed decode
    reads only the valid entries)."""
    def fill(node):
        if isinstance(node, dict):
            return {k: pos if k in ("idx", "_pos") else fill(v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return node

    return fill(cache)


# ---------------------------------------------------------------------------
# The dry run's own specs (--dist dp, ZeRO-1 moments)
# ---------------------------------------------------------------------------


def strip_model_axis(spec: tuple) -> tuple:
    return tuple(None if ax == "model" else ax for ax in spec)


def dp_batch_specs(mesh: dict, batch):
    """Batch dims over every axis, (pod, data, model), where divisible."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh)
    n = math.prod(mesh[a] for a in axes)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % n == 0 and shape[0] >= n:
            return (axes,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return SH.map_with_path(one, batch)


def opt_specs(opt, param_sp, mesh: dict) -> AdamWState:
    """Moments inherit param specs; ZeRO-1 additionally splits the first
    still-replicated dim over 'data' when divisible. q8-encoded moments
    shard their block dim over the whole mesh (``SH.q8_specs``, the rule
    ``adamw_init`` places them by). ``opt`` may be the port's state or the
    reference's (any named tuple with its fields)."""

    def inherit(node, psp):
        if isinstance(node, list):
            return [inherit(v, s) for v, s in zip(node, psp)]
        if SH.is_q8(node):
            return SH.q8_specs(node, mesh)
        if isinstance(node, dict):
            return {k: inherit(v, psp[k]) for k, v in node.items()}
        shape = tuple(node.shape)
        spec = list(psp) + [None] * (len(shape) - len(psp))
        if "data" in mesh and "data" not in spec:
            nd = mesh["data"]
            for i, s in enumerate(spec):
                if s is None and shape[i] % nd == 0 and shape[i] >= nd:
                    spec[i] = "data"
                    break
        return tuple(spec)

    def replicated(_, leaf):
        return (None,) * len(leaf.shape)

    return AdamWState(replicated("", opt.step),
                      inherit(opt.mu, param_sp), inherit(opt.nu, param_sp),
                      None if opt.err is None else
                      SH.map_with_path(replicated, opt.err))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod",
                                                      "both"))
    ap.add_argument("--dist", default="pjit",
                    choices=("pjit", "pipeline", "dp"))
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--stages", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each (a meta "
                         "trace is single-threaded host work; the largest "
                         "cells take tens of seconds)")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(arch, shape, mesh_name) for mesh_name in meshes
             for arch in archs for shape in shapes]

    os.makedirs(args.out, exist_ok=True)
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            pool = stack.enter_context(ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            # The slowest cells (train, then prefill) go first, so that
            # none of them starts last; the records come out in order.
            rank = {name: i for i, name in enumerate(SHAPES)}
            futures = {i: pool.submit(_cell_or_error, *cells[i], args.dist,
                                      args.stages, args.quant)
                       for i in sorted(range(len(cells)),
                                       key=lambda i: rank[cells[i][1]])}
            results = [futures[i].result for i in range(len(cells))]
        else:
            results = [functools.partial(_cell_or_error, *cell, args.dist,
                                         args.stages, args.quant)
                       for cell in cells]
        failures = 0
        for (arch, shape, mesh_name), result in zip(cells, results):
            res = result()
            failures += res["status"] == "error"
            tag = f"{arch}_{shape}_{mesh_name}_{args.dist}"
            if args.quant != "none":
                tag += f"_{args.quant}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            print(f"[{res['status']:9s}] {tag} "
                  f"({res.get('compile_s', '-')}s)", flush=True)
    return 1 if failures else 0


def _cell_or_error(arch, shape, mesh_name, dist, stages, quant) -> dict:
    """``run_cell``, or a record of its failure: one cell's error does
    not stop the sweep, and the sweep's exit code reports it."""
    try:
        return run_cell(arch, shape, mesh_name, dist, stages, quant)
    except Exception as e:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "dist": dist, "status": "error",
                "error": f"{type(e).__name__}: {e}"}


if __name__ == "__main__":
    sys.exit(main())
