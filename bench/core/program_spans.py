"""The program's own spans (``repro_torch.core.spans``) as the per-layer
readers of a traced run read them.

The program records its spans while the profiler runs: from the profiler's
start, a little before the traced sub-window opens, until its stop, one
tick after the window closes. The stop holds the interpreter for tens to
hundreds of ms and stalls every span open then, so the readers take the
spans that end within the window's length (``window_s``) from the first
one recorded: a window shifted earlier by the lead-in, which the stop
never reaches. They give ms a batch over the batches those spans name
(each span name's seconds over the distinct owner and batch numbers it
carries). A program without the recorder gives no rows, and the readers
None."""

from __future__ import annotations

import collections

_drained = None


def rows(t) -> list:
    """The spans of the traced run ``t`` (see above). The program's
    recorder is drained once and kept for every reader of the run."""
    global _drained
    if _drained is None:
        try:
            from repro_torch.core import spans
        except ImportError:
            return []
        _drained = [r for r in spans.drain() if r.batch is not None]
    if not _drained:
        return []
    end = min(r.t0 for r in _drained) + t.window_s
    return [r for r in _drained if r.t1 <= end]


def wall(r) -> float:
    return r.t1 - r.t0


def named(t, names) -> list:
    return [r for r in rows(t) if r.name in names]


def self_seconds(rs: list) -> dict:
    """Each row's wall seconds less those of the rows of ``rs`` directly
    inside it on its thread, by ``id`` of the row."""
    out = {id(r): wall(r) for r in rs}
    per_thread = collections.defaultdict(list)
    for r in rs:
        per_thread[r.thread].append(r)
    for same in per_thread.values():
        same.sort(key=lambda r: (r.t0, -r.t1))
        open_ = []
        for r in same:
            while open_ and open_[-1].t1 <= r.t0:
                open_.pop()
            if open_:
                out[id(open_[-1])] -= wall(r)
            open_.append(r)
    return out


def ms_a_batch(rs: list, seconds=wall) -> float | None:
    """``seconds(row)`` in ms a batch: for each span name, summed over its
    rows and divided by the batches they carry; then summed over names."""
    by_name = collections.defaultdict(list)
    for r in rs:
        by_name[r.name].append(r)
    if not by_name:
        return None
    return 1e3 * sum(sum(seconds(r) for r in same)
                     / len({(r.owner, r.batch) for r in same})
                     for same in by_name.values())


def busiest_launch_offcpu_ms(t) -> float | None:
    """Of the stage whose ``stage<i>.launch`` spans hold the most wall
    time, the launches' wall time less their thread's CPU seconds, ms a
    batch: time the launching thread was off the CPU (waiting for the
    GIL, descheduled or blocked in a call)."""
    launches = collections.defaultdict(list)
    for r in rows(t):
        if r.name.startswith("stage") and r.name.endswith(".launch"):
            launches[r.name].append(r)
    if not launches:
        return None
    busiest = max(launches.values(), key=lambda rs: sum(map(wall, rs)))
    return ms_a_batch(busiest, lambda r: wall(r) - r.cpu_s)
