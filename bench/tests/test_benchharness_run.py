"""The harness end to end on the CPU, on a tiny checkout: a closed and an
open run print a well-formed last line with ``correct`` true; the
control and every planted fault make ``correct`` false.

Each run is a process of its own: the harness refuses to print a result
from a process where JAX is loaded, and test workers load it."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,trace", [
    ("tiny-b4-closed", 0), ("tiny-k2-poisson", 0), ("tiny-k2-closed", 1),
    ("tiny-r2-onoff", 1)])
def test_tiny_runs_print_a_well_formed_correct_line(checkout, cell, trace):
    r = tiny.run(checkout, cell, trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert r["compared"]["wrong_frames"] == {"value": 0, "limit": 0}
    assert r["device"]["count"] == 1
    if trace:
        assert "window_s" in r["device"] and "busy_s" in r["device"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        beat = ("pipeline_stage_beat_ms.fps" if "closed" in cell
                else "frontend_wait_p95_ms")
        assert beat in r["metrics"]
    else:
        assert "setup_s" in r["metrics"]
        key = "frames_per_s" if "closed" in cell else "latency_p95_ms"
        assert r["metrics"][key]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny-b4-closed", "stale_state"), ("tiny-b4-closed", "half_batch"),
    ("tiny-b4-closed", "altered"), ("tiny-k2-closed", "handoff"),
    ("tiny-k2-poisson", "half_batch"), ("tiny-k2-poisson", "handoff")])
def test_each_planted_fault_makes_correct_false(checkout, cell, fault):
    r = tiny.run(checkout, cell, 0, fault)
    assert r["correct"] is False
    assert r["compared"]["wrong_frames"]["value"] > 0


def test_the_control_at_four_bits_is_not_correct(checkout):
    from bench import control
    rows = control.main(["--workload", "tiny-b4-closed", "--seeds",
                         "1,2,3"], device="cpu", root=checkout)
    for row in rows:
        assert row["correct"] is False
        assert row["wrong_frames"] > 0 and row["max_logit_gap"] > 0


def test_without_a_card_the_run_refuses(checkout, tmp_path):
    """No CUDA device: exit non-zero and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(REPO / "bench" / "run.py"),
                        "--workload", "vgg16-b16-closed", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
