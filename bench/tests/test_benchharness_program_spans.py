"""The metrics that read the program's own spans, on the tiny checkout on
the CPU: a traced run of each tiny cell reports those that apply to it,
from spans each owner numbers on its own; a ``--trace 0`` run leaves the
program's recorder off and empty.

Each run is a process of its own, as in ``test_benchharness_run.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
NEW = ("engine_host_ms", "quantize_in_ms", "stage_launch_offcpu_ms.fps",
       "stage_launch_offcpu_ms.lat")
# What each tiny cell reports of them: the single executor has no stage
# workers, a pipeline no EngineExecutor, and the open cells report only
# the metrics that move latency.
REPORTS = {"tiny-b4-closed": {"engine_host_ms", "quantize_in_ms"},
           "tiny-k2-closed": {"quantize_in_ms",
                              "stage_launch_offcpu_ms.fps"},
           "tiny-k2-poisson": {"stage_launch_offcpu_ms.lat"},
           "tiny-r2-onoff": {"stage_launch_offcpu_ms.lat"}}
# How many pipelines submit in the traced sub-window, each numbering its
# own batches: the on-off cell's may see one replica or both
# (tests/test_torch_spans.py holds a pool's split).
OWNERS = {"tiny-b4-closed": {0}, "tiny-k2-closed": {1},
          "tiny-k2-poisson": {1}, "tiny-r2-onoff": {1, 2}}

# Runs the harness, then prints what the program's recorder holds: the
# spans the readers drained (by owner: the pipeline's submit spans' batch
# numbers) and whether recording is still on.
SCRIPT = """
import json, sys, types
from pathlib import Path
from bench import run
from bench.core import program_spans
from repro_torch.core import spans
run.main(["--workload", sys.argv[2], "--seed", str(2 ** 31 + 5),
          "--seconds", "0.6", "--trace", sys.argv[3]], device="cpu",
         root=Path(sys.argv[1]))
owners = {}
for r in program_spans.rows(types.SimpleNamespace(window_s=1e9)):
    if r.name == "pipeline.quantize":
        owners.setdefault(str(r.owner), []).append(r.batch)
print(json.dumps({"owners": owners, "left": len(spans.drain()),
                  "off": spans.span("x", owner=0, batch=0)
                  is spans.span("y", owner=0, batch=0)}))
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("tiny"))


def _run(checkout, cell, trace):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(checkout), cell,
                        str(trace)], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    *_, result, spans = p.stdout.strip().splitlines()
    return json.loads(result), json.loads(spans)


@pytest.mark.parametrize("cell", sorted(REPORTS))
def test_a_traced_run_reports_the_span_metrics_that_apply(checkout, cell):
    result, spans = _run(checkout, cell, 1)
    assert result["correct"] is True
    got = {m for m in NEW if m in result["metrics"]}
    assert got == REPORTS[cell]
    for m in got:
        v = result["metrics"][m]
        assert v["unit"] == "ms" and v["value"] >= 0.0
    assert spans["off"] and spans["left"] == 0
    assert len(spans["owners"]) in OWNERS[cell]
    for batches in spans["owners"].values():
        assert len(batches) == len(set(batches))


def test_an_untraced_run_leaves_the_recorder_off_and_empty(checkout):
    result, spans = _run(checkout, "tiny-k2-closed", 0)
    assert result["correct"] is True
    assert not set(NEW) & set(result["metrics"])
    assert spans == {"owners": {}, "left": 0, "off": True}
