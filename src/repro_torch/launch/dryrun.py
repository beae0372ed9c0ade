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
  * ``collectives``: null. The reference parses XLA's partitioned HLO
    (``launch/hlo_stats.py``); the port has no HLO, and its collectives
    come with the mesh runtime (ROADMAP A3).

``--dist pipeline`` (the reference's shard_map pipeline,
``core/pipeline.py``) waits for ROADMAP A3 and is refused. Unlike the
reference's, this module sets no ``XLA_FLAGS``: it imports no JAX.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
  python -m repro_torch.launch.dryrun --all --mesh pod --jobs 8
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k \\
      --quant int8
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

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get as get_arch
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.shapes import (SHAPES, ShapeCase, cache_specs,
                                       cell_is_runnable, input_specs)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState
from repro_torch.runtime import sharding as SH

PIPELINE_REFUSED = ("--dist pipeline (the reference's shard_map pipeline, "
                    "core/pipeline.py) is not ported: it comes with the "
                    "mesh runtime, ROADMAP A3")
NO_COLLECTIVES = ("no HLO to read: the reference counts collectives in "
                  "XLA's partitioned HLO (launch/hlo_stats.py); the port's "
                  "come with the mesh runtime (ROADMAP A3)")
NO_TEMP = ("no counterpart: XLA's temp_size_in_bytes is the compiled "
           "program's scratch; nothing is compiled here")


def run_cell(arch: str, shape: str, mesh_name: str, dist: str = "pjit",
             stages: int = 0, quant: str = "none") -> dict:
    """One cell's record: ``status`` ``"skipped"`` (with the reason) or
    ``"ok"`` with ``trace_cell``'s numbers and ``compile_s``, the seconds
    to build and trace it. ``stages`` belongs to ``--dist pipeline``."""
    if dist == "pipeline":
        raise NotImplementedError(PIPELINE_REFUSED)
    cfg = get_arch(arch)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = production_mesh_shape(multi_pod=(mesh_name == "multipod"))
    t0 = time.time()
    res = trace_cell(cfg, SHAPES[shape], mesh, dp_model=(dist == "dp"),
                     quant=quant)
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
    return {
        "memory": {
            "argument_size_in_bytes": sum(
                SH.tree_shard_bytes(t, sp, mesh) for t, sp in args),
            "output_size_in_bytes": sum(
                SH.tree_shard_bytes(t, sp, mesh) for t, sp in outs),
            "temp_size_in_bytes": None, "temp_note": NO_TEMP},
        "cost": {"flops": float(flops),
                 "flops_over_n_devices": flops / n_dev},
        "collectives": None, "collectives_note": NO_COLLECTIVES,
        "n_devices": n_dev, "mesh_shape": dict(mesh)}


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


def _is_q8(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale", "shape"}


def opt_specs(opt, param_sp, mesh: dict) -> AdamWState:
    """Moments inherit param specs; ZeRO-1 additionally splits the first
    still-replicated dim over 'data' when divisible. q8-encoded moments
    shard their block dim over the whole mesh. ``opt`` may be the port's
    state or the reference's (any named tuple with its fields)."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh)
    n_all = math.prod(mesh[a] for a in axes)

    def inherit(node, psp):
        if isinstance(node, list):
            return [inherit(v, s) for v, s in zip(node, psp)]
        if _is_q8(node):
            blocks = node["q"].shape[0]
            spec = (axes, None) if blocks % n_all == 0 else (None, None)
            return {"q": spec, "scale": spec,
                    "shape": (None,) * len(node["shape"].shape)}
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
    if args.dist == "pipeline":
        raise NotImplementedError(PIPELINE_REFUSED)

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
