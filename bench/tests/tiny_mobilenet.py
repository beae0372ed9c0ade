"""A tiny checkout of MobileNetV2 for the harness's CPU tests: the network
at width 0.25 on 32 x 32 frames (the stem, 17 inverted residual blocks
with 17 depthwise convs, 4 of stride 2, 11 skips with no activation after
the add, the head, the global average pool and an fc to 10 classes), in
a family of the checkout's own whose weights are the ``mobilenet``
family's doubled, so that ReLU6's ceilings bind on the frames; served by
the single executor and by a two-stage pipeline behind the frontend; and
the faults planted in the program to show that the comparison catches a
wrong inverted residual:

* ``relu6_dropped``: the ReLU6 engines clip at 127, not at their ceiling;
* ``dw_stride_ignored``: a stride-2 depthwise conv computes its windows
  at stride 1 (the map it writes keeps the stride-2 size);
* ``projection_skip_dropped``: the projections add no skip.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

# The mobilenet family with its weights doubled.
DOUBLED = '''"""The mobilenet family, its weights doubled (ReLU6 binds)."""

from bench.families import mobilenet
from bench.families.mobilenet import (compile_program, least_seconds,
                                      logits, ops_per_frame)


def make_params(cfg, seed, device):
    params = mobilenet.make_params(cfg, seed, device)
    for p in params.values():
        p["w"].mul_(2.0)
    return params
'''

CLASSES = [{"name": "default", "priority": 0, "deadline_ms": None,
            "share": 1.0}]
MIXES = {"tinymb-closed": {"entry": "engine", "driver": "closed",
                           "pool": 12},
         "tinymb-open": {"entry": "frontend", "driver": "open", "pool": 12,
                         "process": "poisson", "rate_per_s": 200.0,
                         "gap_seed": 0, "classes": CLASSES}}
# cell: (mix, stages)
CELLS = {"tinymb-b4-closed": ("tinymb-closed", 1),
         "tinymb-k2-poisson": ("tinymb-open", 2)}
FAULTS = ("relu6_dropped", "dw_stride_ignored", "projection_skip_dropped")


def layers() -> list[dict]:
    """The tiny network's layers as a configuration holds them."""
    from repro_torch.core import workload as W
    out = []
    for l in W.mobilenet_v2(0.25, 32, 10).layers:
        d = {"name": l.name, "kind": l.kind, "in_ch": l.in_ch,
             "out_ch": l.out_ch, "kernel": l.kernel}
        if l.stride != 1:
            d["stride"] = l.stride
        if l.groups != 1:
            d["groups"] = l.groups
        if l.kind == "conv":
            d.update(pad=list(l.pad), relu=bool(l.relu))
        if l.relu6:
            d["relu6"] = True
        if l.residual:
            d["residual"] = l.residual
        out.append(d)
    return out


def config() -> dict:
    lyr = layers()
    return {"name": "tinymb", "family": "mobilenet_x2",
            "source": "a test network", "reduced": [], "bits": 8,
            "route": "kernel", "batch": 4, "theta": 2 * 900 - len(lyr),
            "input_hw": 32, "input_ch": 3, "layers": lyr}


def checkout(tmp: Path) -> Path:
    """Write the tiny checkout under ``tmp`` and return it; the real metric
    readers and families sit beside its files."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp / "bench"
    for d in ("configs", "workloads", "traffic/mixes", "families"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "metrics").symlink_to(BENCH / "metrics")
    for f in (BENCH / "families").glob("*.py"):
        (b / "families" / f.name).symlink_to(f)
    (b / "families" / "mobilenet_x2.py").write_text(DOUBLED)
    (b / "configs" / "tinymb.json").write_text(json.dumps(config()))
    for name, mix in MIXES.items():
        (b / "traffic" / "mixes" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (mix, stages) in CELLS.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tinymb", "traffic": mix, "stages": stages,
             "replicas": 1}))
    closed, opened = ["tinymb-b4-closed"], ["tinymb-k2-poisson"]

    def cells_of(metric):
        moves = metric.get("moves", metric["name"])
        return closed if moves == "frames_per_s" else opened

    bench = dict(real)
    bench["workloads"] = [{"name": c, "config": "tinymb", "traffic": m,
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

    orig = P._step_kernel
    if name == "relu6_dropped":
        def step(xq, st, skip=None):
            return orig(xq, dataclasses.replace(st, qmax=None), skip)
    elif name == "dw_stride_ignored":
        def step(xq, st, skip=None):
            lyr = st.layer
            if not (lyr.depthwise and lyr.stride > 1):
                return orig(xq, st, skip)
            one = dataclasses.replace(lyr, stride=1)
            out = orig(xq, dataclasses.replace(st, layer=one), skip)
            ho = (xq.shape[1] - 1) // lyr.stride + 1
            return out[:, :ho, :ho].contiguous()
    elif name == "projection_skip_dropped":
        def step(xq, st, skip=None):
            return orig(xq, st, None if not st.relu else skip)
    else:
        raise ValueError(f"unknown fault {name!r}")
    P._step_kernel = step


def run(root: Path, cell: str, trace: int = 0,
        fault: str | None = None) -> dict:
    """One run of ``cell`` of the checkout at ``root`` on the CPU, in a
    process of its own; its last line."""
    # One thread: the run is tiny, and the test workers run beside it.
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from bench.tests import tiny_mobilenet\n"
            "if len(sys.argv) > 4:\n"
            "    tiny_mobilenet.install(sys.argv[4])\n"
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
