"""The traced run's spans: where they go, and what happens when the
program no longer has a member they wrap."""

from __future__ import annotations

import pytest

from bench.core import trace as T


class _Runner:
    def quantize(self, x):
        return x

    def dequantize(self, x):
        return x

    def fn(self, x):
        return x


class _Pipeline:
    def __init__(self, stages=2):
        self.runners = [_Runner() for _ in range(stages)]

    def submit_batch(self, frames, n_valid, tag=None):
        return self.runners[0].quantize(frames)

    def _stage_in(self, xq):
        return xq


class _Pool:
    def __init__(self):
        self.replicas = [_Pipeline(), _Pipeline()]


def test_spans_go_around_every_replica_and_report_unused_ones():
    spans = T.Spans()
    pool = _Pool()
    T.instrument(spans, pool)
    pool.replicas[1].submit_batch([1], 1)
    labels = {label for _, _, label in spans.rows}
    assert labels == {"dispatch", "quantize_in"}
    rep = spans.report()
    assert rep["missing"] == []
    assert "stage_in" in rep["never_entered"]
    assert "stage1.enqueue" in rep["never_entered"]


def test_a_private_member_gone_is_noted_and_a_public_one_stops_the_run():
    spans = T.Spans()
    ex = _Pipeline()
    del _Pipeline._stage_in
    try:
        T.instrument(spans, ex)
        assert spans.report()["missing"] == ["_Pipeline._stage_in"]
        ex.runners[0].quantize = None
        with pytest.raises(RuntimeError, match="_Runner.quantize"):
            T.instrument(T.Spans(), ex)
    finally:
        _Pipeline._stage_in = lambda self, xq: xq
