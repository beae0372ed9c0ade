"""The roofline's counts: from the layers' shapes alone."""

from __future__ import annotations

import pytest

from bench.core import spec
from bench.roofline import counts, peaks


def _row(cfg, name, batch=16):
    return next(r for r in counts.layer_counts(cfg, batch)
                if r["name"] == name)


def test_alexnet_conv1_by_hand():
    r = _row(spec.config("alexnet"), "conv1")
    # 55 x 55 outputs x 96 channels x (11 x 11 x 3) MACs, two ops each
    assert r["ops"] == 16 * 2 * 55 * 55 * 96 * 11 * 11 * 3 == 3_373_286_400
    # input 227 x 227 x 3 and output 55 x 55 x 96 int8 a frame; weights
    # 11 x 11 x 3 x 96 int8, int32 bias and shift of 96 channels a batch
    assert r["bytes"] == (16 * (227 * 227 * 3 + 55 * 55 * 96)
                          + 11 * 11 * 3 * 96 + 8 * 96) == 7_155_408


def test_vgg16_fc6_by_hand():
    r = _row(spec.config("vgg16"), "fc6")
    assert r["ops"] == 16 * 2 * 25088 * 4096 == 3_288_334_336
    assert r["bytes"] == (16 * (25088 + 4096) + 25088 * 4096
                          + 8 * 4096) == 103_260_160


def test_counts_never_include_the_im2col_patches():
    """The same work whatever implements it: conv1's bytes are its own
    input and output, not the [3025, 363] patch matrix im2col makes."""
    cfg = spec.config("alexnet")
    r = _row(cfg, "conv1", batch=1)
    patches = 55 * 55 * 11 * 11 * 3
    assert r["bytes"] == 227 * 227 * 3 + 55 * 55 * 96 + 11 * 11 * 3 * 96 \
        + 8 * 96
    assert r["bytes"] < patches
    last = _row(cfg, "fc8", batch=1)
    assert last["bytes"] == 4096 + 4 * 1000 + 4096 * 1000 + 8 * 1000


@pytest.mark.parametrize("name,gop", [("alexnet", 1.4488), ("vgg16", 30.94)])
def test_ops_per_frame_match_the_papers_complexity(name, gop):
    assert counts.ops_per_frame(spec.config(name)) / 1e9 == \
        pytest.approx(gop, rel=1e-3)


def test_least_time_takes_the_larger_bound_per_layer():
    cfg = spec.config("vgg16")
    t = counts.least_seconds(cfg, 16, 1979e12, 3.35e12)
    rows = counts.layer_counts(cfg, 16)
    assert t >= sum(r["ops"] for r in rows) / 1979e12
    assert t >= max(r["bytes"] for r in rows) / 3.35e12
    assert peaks.card_peaks("NVIDIA H100 80GB HBM3")[1:] == (1979e12,
                                                             3.35e12)
    assert peaks.card_peaks("NVIDIA A100-SXM4-80GB") is None
