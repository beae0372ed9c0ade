"""A tiny checkout for the harness's CPU tests: ``BENCHMARK.json`` and the
``bench/`` files of cells of a small CNN (closed loops on the single
executor and on a two-stage pipeline; open loops behind the frontend on a
two-stage pipeline and, with on-off arrivals, on two routed replicas of
it), with the real metric readers beside them."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

CONFIG = {
    "name": "tiny", "source": "a test network", "reduced": [],
    "bits": 8, "route": "kernel", "batch": 4, "theta": 1794,
    "input_hw": 16, "input_ch": 3,
    "layers": [
        {"name": "conv1", "kind": "conv", "in_ch": 3, "out_ch": 8,
         "kernel": 3},
        {"name": "pool1", "kind": "pool", "in_ch": 8, "out_ch": 8,
         "kernel": 2, "stride": 2},
        {"name": "conv2", "kind": "conv", "in_ch": 8, "out_ch": 16,
         "kernel": 3, "groups": 2},
        {"name": "pool2", "kind": "pool", "in_ch": 16, "out_ch": 16,
         "kernel": 3, "stride": 2, "out_size": 4},
        {"name": "fc3", "kind": "fc", "in_ch": 256, "out_ch": 32,
         "kernel": 1},
        {"name": "fc4", "kind": "fc", "in_ch": 32, "out_ch": 10,
         "kernel": 1}]}

MIXES = {
    "tiny-closed": {"entry": "engine", "driver": "closed", "pool": 12},
    "tiny-pipe-closed": {"entry": "pipeline", "driver": "closed",
                         "pool": 12},
    "tiny-open": {"entry": "frontend", "driver": "open", "pool": 12,
                  "process": "poisson", "rate_per_s": 200.0, "gap_seed": 0,
                  "classes": [{"name": "default", "priority": 0,
                               "deadline_ms": None, "share": 1.0}]},
    "tiny-onoff": {"entry": "frontend", "driver": "open", "pool": 12,
                   "process": "onoff", "rate_per_s": 200.0, "gap_seed": 0,
                   "params": {"burst_factor": 4.0, "duty": 0.25,
                              "n_bursts": 2},
                   "classes": [{"name": "default", "priority": 0,
                                "deadline_ms": None, "share": 1.0}]}}

# cell: (mix, stages, replicas)
CELLS = {"tiny-b4-closed": ("tiny-closed", 1, 1),
         "tiny-k2-closed": ("tiny-pipe-closed", 2, 1),
         "tiny-k2-poisson": ("tiny-open", 2, 1),
         "tiny-r2-onoff": ("tiny-onoff", 2, 2)}


def checkout(tmp: Path) -> Path:
    """Write the tiny checkout under ``tmp`` and return it."""
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    b = tmp / "bench"
    for d in ("configs", "workloads", "traffic/mixes"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "metrics").symlink_to(BENCH / "metrics")
    (b / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    for name, mix in MIXES.items():
        (b / "traffic" / "mixes" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (mix, stages, replicas) in CELLS.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": mix, "stages": stages,
             "replicas": replicas}))
    closed = [c for c, (m, *_) in CELLS.items()
              if MIXES[m]["driver"] == "closed"]
    opened = [c for c, (m, *_) in CELLS.items()
              if MIXES[m]["driver"] == "open"]

    def cells_of(metric):
        moves = metric.get("moves", metric["name"])
        return closed if moves == "frames_per_s" else opened

    bench = dict(real)
    bench["workloads"] = [{"name": c, "config": "tiny", "traffic": m,
                           "chips": 1, "why": "test"}
                          for c, (m, *_) in CELLS.items()]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [dict(m, workloads=cells_of(m)) if m["name"] !=
                      "setup_s" else dict(m) for m in real[key]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
