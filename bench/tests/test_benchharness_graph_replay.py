"""The graph replay share's readers (``bench/core/graph_replay.py``) on
synthetic span rows: launch spans without a ``runner.replay`` read 0, launch
spans that each hold one read 100, and a window without launch spans reads
None."""

from __future__ import annotations

import types

import pytest


def _row(name, thread, t0, t1):
    return types.SimpleNamespace(name=name, owner=1, batch=0, thread=thread,
                                 t0=t0, t1=t1, cpu_s=0.0)


LAUNCHES = [_row("engine.enqueue", 1, 0.0, 1.0),
            _row("stage0.launch", 2, 0.0, 1.0),
            _row("stage1.launch", 3, 0.5, 1.5)]
REPLAYS = [_row("runner.replay", 1, 0.1, 0.9),
           _row("runner.replay", 2, 0.2, 0.8),
           _row("runner.replay", 3, 0.6, 1.4)]
# One launch holds its replay; the others' replays ran on another thread
# or after the launch ended.
ASTRAY = [REPLAYS[0], _row("runner.replay", 9, 0.2, 0.8),
          _row("runner.replay", 3, 1.6, 1.7)]


@pytest.mark.parametrize("metric", ["graph_replay_share.fps",
                                    "graph_replay_share.lat"])
@pytest.mark.parametrize("rows,want", [
    (LAUNCHES, 0.0), (LAUNCHES + REPLAYS, 100.0),
    (LAUNCHES + ASTRAY, 100.0 / 3), (REPLAYS, None), ([], None)],
    ids=["eager", "replayed", "one-of-three", "no-launches", "no-spans"])
def test_graph_replay_share_reads_the_launches_holding_a_replay(
        monkeypatch, metric, rows, want):
    from bench.core import program_spans, spec
    monkeypatch.setattr(program_spans, "_drained", list(rows))
    got = spec.reader(metric)(types.SimpleNamespace(window_s=10.0))
    assert got == pytest.approx(want) if want is not None else got is None
