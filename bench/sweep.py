"""Find the highest rate an open-loop cell's entry sustains, once, by a
sweep on the card; the benchmark itself never runs this.

    python3 bench/sweep.py --workload alexnet-k2-poisson --seed 1 \
        --seconds 8 --rates 1000,1400,1800

Compiles and warms the cell's program once, then for each rate offers the
cell's mix at that rate to a fresh frontend for ``--seconds`` and prints
one JSON line: the offered rate, the rate answered over the span of the
arrivals, the p50/p95 latency from the due time, and the median latency of
the first and the last quarter of the arrivals. A first line gives the
executor's own closed-loop rate under no frontend. A rate is sustained when
the answered rate keeps up with the offered one and the last quarter's
latency has not grown over the first's (no growing backlog). The cell's
rate is then written by hand into its mix file, at 0.8 of the highest
sustained rate.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, *, device="cuda", root: Path = ROOT) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    from bench.core import drive, inputs, spec
    from bench.traffic import schedule

    cell = spec.cell(args.workload, root)
    cfg, mix = cell.config, cell.traffic
    params = cell.family.make_params(cfg, args.seed, device)
    calib = inputs.make_calib(cfg, args.seed, device)
    pool = inputs.host_pool(inputs.make_frames(cfg, mix["pool"], args.seed,
                                               device))
    prog = cell.family.compile_program(cfg, params, calib, device)
    ex = drive.executor(prog, cell)
    drive.warm(ex, pool, cfg["batch"])
    rows = []
    try:
        closed = drive.run_closed(ex, pool, cfg["batch"], args.seconds)
        print(json.dumps({"closed_loop_frames_per_s":
                          closed.submitted / closed.seconds}), flush=True)
        ex.reset_stats()
        for rate in (float(r) for r in args.rates.split(",")):
            fe = drive.frontend(ex, cfg, rate)
            sched = schedule.open_loop_schedule(mix, args.seconds,
                                                args.seed, rate=rate)
            run = drive.run_open(fe, ex, pool, sched)
            fe.close()
            lat = drive.open_latencies_ms(run)
            done = sorted(run.answered.values())
            span = (done[-1] - run.due[0]) if done else float("inf")
            q = max(1, len(lat) // 4)
            row = {"rate": rate, "answered_per_s": len(done) / span,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p95_ms": float(np.percentile(lat, 95)),
                   "first_quarter_p50_ms": float(np.median(lat[:q])),
                   "last_quarter_p50_ms": float(np.median(lat[-q:])),
                   "lag_ms_max": float((run.sent - run.due).max() * 1e3)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        drive.close(ex)
    return rows


if __name__ == "__main__":
    main()
