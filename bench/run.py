"""One run of one cell of the port's benchmark.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, its family and traffic mix by name, makes
the weights, the calibration frame and the frame pool on the card from
``--seed``, compiles the int8 engine (``repro_torch``), warms the one batch
shape the cell uses, frees its own inputs on the card, then loads the
cell's entry for ``--seconds`` seconds. After the window it reads the
window's memory peak, frees the program, draws the inputs again from the
seed and holds every answer the window produced against the family's plain
reference. The weights, the program, the reference and the roofline
counts all come from the family (``bench/families/<family>.py``).
The last line of standard output is the result; the numbers compared,
each with its limit, are the last lines of standard error.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled steady sub-window, with the device's
busy and window seconds and a breakdown. Exits non-zero, with no result,
without a CUDA device (or fewer than the cell asks for), without the
program beside it, or when JAX or the JAX package ``repro`` got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The traced sub-window: it opens at this share of the window and lasts
# this long (at most half the window).
TRACE_AT = 0.25
TRACE_S = 2.0


class Refused(Exception):
    """A run that must exit non-zero and print no result."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None, *, device=None, root: Path = ROOT) -> dict:
    """Run the cell and print its result. ``device`` other than None skips
    the look for a card (the harness's tests run tiny cells on the CPU);
    ``root`` is the checkout whose ``BENCHMARK.json`` and ``bench/`` files
    name the cell."""
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise Refused(f"the program (src/repro_torch) is not in {ROOT}")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # Every cache a build may use stays at a fixed path in the checkout
    # (the port's nvcc builds already go to build/kernels).
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))

    import numpy as np
    import torch

    from bench.core import compare, drive, inputs, spec
    from bench.core import trace as T
    from bench.roofline import peaks
    from bench.traffic import replay, schedule

    cell = spec.cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell.chips}")
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix, fam = cell.config, cell.traffic, cell.family
    batch, entry = cfg["batch"], mix["entry"]

    # -- set-up: inputs, compile, warm-up --------------------------------
    params = fam.make_params(cfg, args.seed, dev)
    calib = inputs.make_calib(cfg, args.seed, dev)
    pool_dev = inputs.make_frames(cfg, mix["pool"], args.seed, dev)
    pool = inputs.host_pool(pool_dev)
    prog = fam.compile_program(cfg, params, calib, dev)
    ex = drive.executor(prog, cell)
    fe = None
    drive.warm(ex, pool, batch)
    if entry == "frontend":
        rate = float(mix["rate_per_s"])
        fe = drive.frontend(ex, cfg, rate)
        warm_reqs = [fe.submit(pool[i % len(pool)]) for i in range(4 * batch)]
        for r in warm_reqs:
            r.result(timeout=120)

    tracer = None
    if args.trace:
        def counters():
            return {"t": time.perf_counter(), "batches": ex.stats.batches,
                    "frames": ex.stats.frames,
                    "stage": list(getattr(ex, "stage_busy_s", []))}
        tracer = T.Tracer(cuda, TRACE_AT * args.seconds,
                          min(TRACE_S, 0.5 * args.seconds), counters)
        tracer.warm()
        T.instrument(tracer.spans, ex, fe)
    # The inputs on the card are the harness's, not the program's: free
    # them, so the peak is what serving holds, and draw them again from
    # the seed for the reference once the window has closed.
    del params, calib, pool_dev
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window ------------------------------------------------------
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    tick = tracer.tick if tracer else None
    if mix["driver"] == "closed":
        run = drive.run_closed(ex, pool, batch, args.seconds, tick)
        outputs = list(run.outputs)
        attempted = run.submitted
        failed = attempted - len(outputs)
        outputs += [None] * failed
        pool_index = np.arange(attempted) % len(pool)
    else:
        sched = schedule.open_loop_schedule(mix, args.seconds, args.seed)
        run = drive.run_open(fe, ex, pool, sched, tick)
        outputs = drive.open_outputs(run)
        attempted = len(outputs)
        failed = sum(o is None for o in outputs)
        pool_index = np.array([a.frame_idx for a in sched])
    if tracer:
        tracer.finish()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    if fe is not None:
        fe.close()
    drive.close(ex)
    del prog, ex, fe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the comparison --------------------------------------------------
    t_ref = time.perf_counter()
    params = fam.make_params(cfg, args.seed, dev)
    calib = inputs.make_calib(cfg, args.seed, dev)
    pool_dev = inputs.make_frames(cfg, mix["pool"], args.seed, dev)
    ref = fam.logits(cfg, params, calib, pool_dev, bits=cfg["bits"])
    readings = compare.compare(outputs, pool_index, ref)
    ok = compare.correct(readings)
    ref_s = time.perf_counter() - t_ref

    # -- metrics ---------------------------------------------------------
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not args.trace:
        values = {"setup_s": setup_s}
        if mix["driver"] == "closed":
            good = attempted - readings["wrong_frames"]
            values["frames_per_s"] = good / run.seconds
        else:
            lat = drive.open_latencies_ms(run)
            values["latency_p50_ms"] = float(np.percentile(lat, 50))
            values["latency_p95_ms"] = float(np.percentile(lat, 95))
            log("pacing", json.dumps(replay.pacing(run.due, run.sent)))
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        if not tracer.done:
            raise RuntimeError("the window ended before the traced "
                               "sub-window opened")
        red = T.reduce(tracer.prof, tracer.spans, tracer.t_open)
        c0, c1 = tracer.c0, tracer.c1
        card = peaks.card_peaks(torch.cuda.get_device_name(dev)) \
            if cuda else None
        waits = None
        if mix["driver"] == "open":
            waits = []
            for r, due in zip(run.requests, run.due):
                if c0["t"] <= due <= c1["t"]:
                    ph = r.phase_s()
                    if ph["queueing"] is not None and \
                            ph["assembly"] is not None:
                        waits.append(ph["queueing"] + ph["assembly"])
        stage = [b - a for a, b in zip(c0["stage"], c1["stage"])] or None
        tr = T.Trace(
            entry=entry, window_s=red["window_s"],
            busy_s=red["busy_s"], batches=c1["batches"] - c0["batches"],
            frames=c1["frames"] - c0["frames"],
            least_batch_s=(fam.least_seconds(cfg, batch, card[1], card[2])
                           if card else None),
            ops_per_frame=fam.ops_per_frame(cfg),
            peak_ops=card[1] if card else None, stage_busy_s=stage,
            stage_batches=c1["batches"] - c0["batches"] if stage else None,
            waits_s=waits)
        for m in cell.per_layer:
            v = spec.reader(m["name"], root)(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        log("trace", json.dumps({
            "window_s": red["window_s"], "busy_s": red["busy_s"],
            "batches": tr.batches, "frames": tr.frames, "gaps": red["gaps"],
            "stage_busy_s": stage, "least_batch_s": tr.least_batch_s,
            "spans": tracer.spans.report(),
            "longest_gaps": red["longest_gaps"]}))

    bad = forbidden_modules()
    if bad:
        raise Refused("loaded in this process: " + ", ".join(bad))

    result = {"correct": ok, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else dev.type),
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if args.trace:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in red["device_ops"]],
            "idle_gaps": [[n, s] for n, s in red["idle_gaps"]]}
    result["compared"] = compare.report(readings)

    log("run", json.dumps({"cell": cell.name, "seed": args.seed,
                           "trace": args.trace, "setup_s": setup_s,
                           "window_s": getattr(run, "seconds", None),
                           "per_second": (drive.per_second(run.marks, batch)
                                          if hasattr(run, "marks") else None),
                           "reference_s": ref_s,
                           "card": card_line() if cuda else "cpu"}))
    for k, v in compare.report(readings).items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        main()
    except Refused as e:
        log(f"refused: {e}")
        sys.exit(2)
