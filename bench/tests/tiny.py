"""A tiny checkout for the harness's CPU tests: ``BENCHMARK.json`` and the
``bench/`` files of cells of a small CNN (closed loops on the single
executor and on a two-stage pipeline; open loops behind the frontend on a
two-stage pipeline and, with on-off arrivals, on two routed replicas of
it), with the real metric readers and families beside them, and a probe
family that lives in the checkout alone (two closed cells of the same CNN
name it, one with its planted ulp on)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

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

# A family of the checkout's own: the chain family's functions, with a
# reference that adds one ulp to the first frame's first logit where the
# configuration sets ``probe_ulp``.
PROBE = '''"""The chain family, its reference one ulp off where asked."""

import numpy as np

from bench.families.chain import (compile_program, least_seconds,
                                  make_params, ops_per_frame)
from bench.families import chain


def logits(cfg, params, calib, frames, *, bits):
    out = chain.logits(cfg, params, calib, frames, bits=bits)
    if cfg.get("probe_ulp"):
        out = np.array(out)
        out[0, 0] = np.nextafter(out[0, 0], np.inf)
    return out
'''

CONFIGS = {"tiny": CONFIG,
           "tiny-probe": dict(CONFIG, name="tiny-probe", family="probe"),
           "tiny-probe-ulp": dict(CONFIG, name="tiny-probe-ulp",
                                  family="probe", probe_ulp=True)}

# cell: (mix, stages, replicas, config)
CELLS = {"tiny-b4-closed": ("tiny-closed", 1, 1, "tiny"),
         "tiny-k2-closed": ("tiny-pipe-closed", 2, 1, "tiny"),
         "tiny-k2-poisson": ("tiny-open", 2, 1, "tiny"),
         "tiny-r2-onoff": ("tiny-onoff", 2, 2, "tiny"),
         "tiny-probe-b4-closed": ("tiny-closed", 1, 1, "tiny-probe"),
         "tiny-probe-ulp-b4-closed": ("tiny-closed", 1, 1, "tiny-probe-ulp")}


def checkout(tmp: Path) -> Path:
    """Write the tiny checkout under ``tmp`` and return it."""
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    b = tmp / "bench"
    for d in ("configs", "workloads", "traffic/mixes", "families"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "metrics").symlink_to(BENCH / "metrics")
    # The real families, file by file, so the probe can sit beside them.
    for f in (BENCH / "families").glob("*.py"):
        (b / "families" / f.name).symlink_to(f)
    (b / "families" / "probe.py").write_text(PROBE)
    for name, cfg in CONFIGS.items():
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (b / "traffic" / "mixes" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (mix, stages, replicas, cfg) in CELLS.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": cfg, "traffic": mix, "stages": stages,
             "replicas": replicas}))
    closed = [c for c, (m, *_) in CELLS.items()
              if MIXES[m]["driver"] == "closed"]
    opened = [c for c, (m, *_) in CELLS.items()
              if MIXES[m]["driver"] == "open"]

    def cells_of(metric):
        moves = metric.get("moves", metric["name"])
        return closed if moves == "frames_per_s" else opened

    bench = dict(real)
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": m,
                           "chips": 1, "why": "test"}
                          for c, (m, _, _, cfg) in CELLS.items()]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [dict(m, workloads=cells_of(m)) if m["name"] !=
                      "setup_s" else dict(m) for m in real[key]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run(root: Path, cell: str, trace: int = 0, fault: str | None = None,
        ) -> dict:
    """One run of ``cell`` of the tiny checkout at ``root`` on the CPU, in
    a process of its own (``drive_tiny``); its well-formed last line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    args = [sys.executable, "-m", "bench.tests.drive_tiny", str(root),
            cell, str(trace)] + ([fault] if fault else [])
    p = subprocess.run(args, capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert RESULT_KEYS <= set(last)
    assert list(last)[-1] == "compared"
    tail = [l for l in p.stderr.splitlines() if l.startswith("compared ")]
    assert p.stderr.rstrip().splitlines()[-len(tail):] == tail
    return last
