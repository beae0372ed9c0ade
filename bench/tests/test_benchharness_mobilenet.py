"""The ``mobilenet`` family on the harness, on the CPU: MobileNetV2's
configuration resolves to it and its counts are the published ones; one
depthwise layer's operations and bytes worked by hand; a tiny MobileNetV2
checkout runs through ``bench/run.py`` and reads correct; three faults
planted in the program's inverted residuals turn ``correct`` false; the
control at four bits is not correct; and ``alexnet-r2-poisson``'s file
asks for two replicas.

Each run is a process of its own (``tiny_mobilenet.run``): the harness
refuses to print a result from a process where JAX is loaded."""

from __future__ import annotations

import pytest
import torch

from bench.core import spec
from bench.reference import mobilenet_int8
from bench.roofline import mobilenet_counts, resnet_counts
from bench.tests import tiny_mobilenet


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_mobilenet.checkout(tmp_path_factory.mktemp("tiny-mobilenet"))


def test_mobilenetv2_resolves_to_the_mobilenet_family():
    cfg = spec.config("mobilenetv2")
    fam = spec.family(cfg)
    assert cfg["family"] == "mobilenet" and cfg["reduced"] == []
    assert fam.__name__ == "bench.families.mobilenet"
    assert fam.logits is mobilenet_int8.logits
    assert fam.least_seconds is mobilenet_counts.least_seconds
    for f in spec.FAMILY_FUNCTIONS:
        assert callable(getattr(fam, f)), f


def test_mobilenetv2_counts_are_the_published_ones():
    cfg = spec.config("mobilenetv2")
    rows = resnet_counts.layer_counts(cfg, 1)
    assert mobilenet_counts.ops_per_frame(cfg) == 2 * 300_774_272
    assert sum(r["weights"] for r in rows) == 3_487_816
    geo = mobilenet_int8.layer_geometry(cfg)
    assert sum(g["res_i"] is not None for g in geo) == 10
    assert sum(g["relu6"] for g in geo) == 35
    dw = [g for g in geo if g.get("groups", 1) > 1]
    assert len(dw) == 17 and all(g["groups"] == g["in_ch"] == g["out_ch"]
                                 for g in dw)
    assert geo[-2]["in_hw"] == 7 and geo[-2]["kind"] == "gap"
    assert cfg["theta"] == 1746 and cfg["batch"] == 16


def test_one_depthwise_layers_counts_worked_by_hand():
    """block2.dw: 112 x 112 x 96 in, stride 2, 56 x 56 x 96 out. A frame
    does 2 x 56 x 56 x 9 x 96 operations; a batch of 16 moves its input
    and output once (int8) and its 9 x 96 weights, 96 biases and 96
    shifts (int32) once; its bound is the bytes'."""
    cfg = spec.config("mobilenetv2")
    rows = {r["name"]: r for r in resnet_counts.layer_counts(cfg, 16)}
    r = rows["block2.dw"]
    assert r["ops"] == 16 * 2 * 56 * 56 * 9 * 96 == 86_704_128
    assert r["bytes"] == 16 * (112 * 112 * 96 + 56 * 56 * 96) \
        + 9 * 96 + 8 * 96 == 24_086_112
    assert r["weights"] == 9 * 96 + 96
    peak_ops, peak_bytes = 1979e12, 3.35e12
    assert r["bytes"] / peak_bytes > 50 * r["ops"] / peak_ops
    dw = sum(max(x["ops"] / peak_ops, x["bytes"] / peak_bytes)
             for n, x in rows.items() if n.endswith(".dw"))
    whole = mobilenet_counts.least_seconds(cfg, 16, peak_ops, peak_bytes)
    assert 28.8e-6 < dw < 29.0e-6 and 66e-6 < whole < 67e-6


@pytest.mark.parametrize("cell,trace", [("tinymb-b4-closed", 0),
                                        ("tinymb-k2-poisson", 1)])
def test_a_tiny_mobilenet_cell_reads_correct(checkout, cell, trace):
    r = tiny_mobilenet.run(checkout, cell, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"]["wrong_frames"] == {"value": 0, "limit": 0}
    if trace:
        assert "frontend_wait_p95_ms" in r["metrics"]
        assert "pipeline_stage_beat_ms.lat" in r["metrics"]


@pytest.mark.parametrize("fault", tiny_mobilenet.FAULTS)
def test_each_planted_inverted_residual_fault_makes_correct_false(
        checkout, fault):
    r = tiny_mobilenet.run(checkout, "tinymb-b4-closed", 0, fault)
    assert r["correct"] is False
    assert r["compared"]["wrong_frames"]["value"] > 0


def test_the_tiny_checkouts_ceilings_bind():
    """The doubled weights put every ReLU6 layer's calibration amax past
    3.97, so each ceiling is below 127."""
    from bench.core import inputs
    cfg = tiny_mobilenet.config()
    fam = spec.family(dict(cfg, family="mobilenet"))
    params = fam.make_params(cfg, 2 ** 31 + 7, "cpu")
    for p in params.values():
        p["w"].mul_(2.0)
    calib = inputs.make_calib(cfg, 2 ** 31 + 7, "cpu")
    q = mobilenet_int8.quantize(cfg, params, mobilenet_int8.calibrate(
        cfg, params, calib))
    ceilings = [L["ceiling"] for L in q["layers"].values() if "ceiling" in L]
    assert len(ceilings) == 35 and max(ceilings) < 127


def test_the_control_at_four_bits_is_not_correct(checkout):
    from bench import control
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # beside the other test workers
    try:
        rows = control.main(["--workload", "tinymb-b4-closed", "--seeds",
                             "1,2"], device="cpu", root=checkout)
    finally:
        torch.set_num_threads(threads)
    for row in rows:
        assert row["correct"] is False
        assert row["wrong_frames"] > 0 and row["max_logit_gap"] > 0


def test_alexnet_r2_poisson_asks_for_two_replicas():
    c = spec.cell("alexnet-r2-poisson")
    k2 = spec.cell("alexnet-k2-poisson")
    assert (c.stages, c.replicas, c.replica_mode) == (2, 2, "pipeline")
    # The same arrivals as alexnet-k2-poisson's, under a mix name of its
    # own (a configuration and a mix make one cell).
    same = ("entry", "driver", "pool", "process", "rate_per_s", "gap_seed",
            "classes")
    assert {k: c.traffic[k] for k in same} == \
        {k: k2.traffic[k] for k in same}
    assert set(c.traffic) == set(k2.traffic) and c.config == k2.config
    assert c.traffic["rate_per_s"] == 320.0
    assert (k2.stages, k2.replicas) == (2, 1)
    assert {m["name"] for m in c.per_layer} == {
        "frontend_wait_p95_ms", "stage_launch_offcpu_ms.lat",
        "graph_replay_share.lat"}


def test_the_mobilenet_cell_reports_the_open_cells_metrics():
    c = spec.cell("mobilenetv2-k2-poisson")
    assert (c.stages, c.replicas) == (2, 1)
    assert c.config["name"] == "mobilenetv2"
    assert {m["name"] for m in c.end_to_end} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "pipeline_stage_beat_ms.lat", "frontend_wait_p95_ms",
        "device_idle_share.lat", "stage_launch_offcpu_ms.lat",
        "graph_replay_share.lat", "chain_roofline.lat"}
