"""A tiny checkout of a residual CNN for the harness's CPU tests: a stem, a
max pool, an identity bottleneck, a projection bottleneck with stride 2,
the global average pool over a 7 x 7 map and an fc, in the ``resnet``
family, served by the single executor and by a two-stage pipeline behind
the frontend; and the faults planted in the program to show that the
comparison catches a residual engine that is wrong:

* ``skip_dropped``: the residual engines add no skip;
* ``align_off_by_one``: each skip is aligned one place further right;
* ``area_64``: the fc after the pool takes its weights over 64, not the
  map's 49.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

LAYERS = [
    {"name": "conv1", "kind": "conv", "in_ch": 3, "out_ch": 8, "kernel": 3,
     "stride": 2, "pad": [1, 1], "relu": True},
    {"name": "maxpool", "kind": "pool", "in_ch": 8, "out_ch": 8,
     "kernel": 3, "stride": 2, "pad": [1, 1]},
    {"name": "b1.conv1", "kind": "conv", "in_ch": 8, "out_ch": 4,
     "kernel": 1, "pad": [0, 0], "relu": True},
    {"name": "b1.conv2", "kind": "conv", "in_ch": 4, "out_ch": 4,
     "kernel": 3, "pad": [1, 1], "relu": True},
    {"name": "b1.conv3", "kind": "conv", "in_ch": 4, "out_ch": 8,
     "kernel": 1, "pad": [0, 0], "relu": True, "residual": "maxpool"},
    {"name": "b2.downsample", "kind": "conv", "in_ch": 8, "out_ch": 16,
     "kernel": 1, "stride": 2, "pad": [0, 0], "relu": False},
    {"name": "b2.conv1", "kind": "conv", "in_ch": 8, "out_ch": 4,
     "kernel": 1, "pad": [0, 0], "relu": True, "src": "b1.conv3"},
    {"name": "b2.conv2", "kind": "conv", "in_ch": 4, "out_ch": 4,
     "kernel": 3, "stride": 2, "pad": [1, 1], "relu": True},
    {"name": "b2.conv3", "kind": "conv", "in_ch": 4, "out_ch": 16,
     "kernel": 1, "pad": [0, 0], "relu": True,
     "residual": "b2.downsample"},
    {"name": "avgpool", "kind": "gap", "in_ch": 16, "out_ch": 16,
     "kernel": 7},
    {"name": "fc", "kind": "fc", "in_ch": 16, "out_ch": 10, "kernel": 1}]

CONFIG = {"name": "tinyres", "family": "resnet", "source": "a test network",
          "reduced": [], "bits": 8, "route": "kernel", "batch": 4,
          "theta": 2 * 900 - len(LAYERS), "input_hw": 56, "input_ch": 3,
          "layers": LAYERS}

CLASSES = [{"name": "default", "priority": 0, "deadline_ms": None,
            "share": 1.0}]
MIXES = {"tinyres-closed": {"entry": "engine", "driver": "closed",
                            "pool": 12},
         "tinyres-open": {"entry": "frontend", "driver": "open", "pool": 12,
                          "process": "poisson", "rate_per_s": 200.0,
                          "gap_seed": 0, "classes": CLASSES}}
# cell: (mix, stages)
CELLS = {"tinyres-b4-closed": ("tinyres-closed", 1),
         "tinyres-k2-poisson": ("tinyres-open", 2)}
FAULTS = ("skip_dropped", "align_off_by_one", "area_64")


def checkout(tmp: Path) -> Path:
    """Write the tiny residual checkout under ``tmp`` and return it; the
    real metric readers and families sit beside its files."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp / "bench"
    for d in ("configs", "workloads", "traffic/mixes"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "metrics").symlink_to(BENCH / "metrics")
    (b / "families").symlink_to(BENCH / "families")
    (b / "configs" / "tinyres.json").write_text(json.dumps(CONFIG))
    for name, mix in MIXES.items():
        (b / "traffic" / "mixes" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (mix, stages) in CELLS.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tinyres", "traffic": mix, "stages": stages,
             "replicas": 1}))
    closed, opened = ["tinyres-b4-closed"], ["tinyres-k2-poisson"]

    def cells_of(metric):
        moves = metric.get("moves", metric["name"])
        return closed if moves == "frames_per_s" else opened

    bench = dict(real)
    bench["workloads"] = [{"name": c, "config": "tinyres", "traffic": m,
                           "chips": 1, "why": "test"}
                          for c, (m, _) in CELLS.items()]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [dict(m, workloads=cells_of(m)) if m["name"] !=
                      "setup_s" else dict(m) for m in real[key]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def install(name: str) -> None:
    """Plant the fault ``name`` in the program, before it is compiled."""
    import dataclasses

    from repro_torch.core import program as P

    if name == "skip_dropped":
        orig = P._step_kernel

        def step(xq, st, skip=None):
            return orig(xq, st)
        P._step_kernel = step
    elif name == "align_off_by_one":
        orig = P._step_kernel

        def step(xq, st, skip=None):
            if skip is not None:
                st = dataclasses.replace(st, skip_shift=st.skip_shift + 1)
            return orig(xq, st, skip)
        P._step_kernel = step
    elif name == "area_64":
        orig = P.folded_weights

        def folded(model, params, i):
            w = orig(model, params, i)
            src = model.sources()[i]
            if src >= 0 and model.layers[src].kind == "gap":
                hw = model.in_sizes()[src]
                w = w * float(hw * hw) / 64.0
            return w
        P.folded_weights = folded
    else:
        raise ValueError(f"unknown fault {name!r}")


def run(root: Path, cell: str, trace: int = 0,
        fault: str | None = None) -> dict:
    """One run of ``cell`` of the checkout at ``root`` on the CPU, in a
    process of its own; its last line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from bench.tests import tiny_resnet\n"
            "if len(sys.argv) > 4:\n"
            "    tiny_resnet.install(sys.argv[4])\n"
            "from bench import run\n"
            "run.main(['--workload', sys.argv[2], '--seed', "
            "str(2 ** 31 + 7), '--seconds', '0.6', '--trace', sys.argv[3]],"
            " device='cpu', root=Path(sys.argv[1]))\n")
    args = [sys.executable, "-c", code, str(root), cell, str(trace)] + \
        ([fault] if fault else [])
    p = subprocess.run(args, capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
