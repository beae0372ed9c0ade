"""The traced run: ``torch.profiler`` over one steady sub-window, the
harness's own spans around the calls into each layer, and the reduction
from the trace to what the per-layer readers and ``breakdown`` read.

Device time is the union of the device's activity intervals (kernels,
copies, sets) inside the window, never a sum of aten rows, which repeat
their kernels' time. An idle gap of the device is labelled by what the
host was doing at its midpoint: the most recent of the harness's spans
open then on any thread, else a CUDA synchronisation the host was blocked
in. The spans are kept in memory on the host clock, since the profiler
records Python-side ranges only on the thread that started it; they are
placed on the trace's clock through the window's own range, which both
clocks stamp.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import re
import time

import torch

WINDOW = "bench.window"
WAITS = ("cudaEventSynchronize", "cudaStreamSynchronize",
         "cudaDeviceSynchronize")
# The profiler runs this long before the window opens, so kernels launched
# before it started (which it cannot see) have left the device.
LEAD_S = 0.05


@dataclasses.dataclass
class Trace:
    """What a traced window gives the per-layer readers. Counts are deltas
    over the window; None where the cell has no such layer."""

    entry: str                      # engine | pipeline | frontend
    window_s: float
    busy_s: float
    batches: int
    frames: int
    least_batch_s: float | None     # roofline least time of one batch
    ops_per_frame: int
    peak_ops: float | None
    stage_busy_s: list | None = None
    stage_batches: int | None = None
    waits_s: list | None = None     # queueing + assembly of each request


def idle_share(t: Trace) -> float | None:
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def stage_beat_ms(t: Trace) -> float | None:
    if not t.stage_busy_s or not t.stage_batches:
        return None
    return 1e3 * max(t.stage_busy_s) / t.stage_batches


class Spans:
    """The harness's spans, ``(start, end, label)`` on the host clock,
    from every thread, and what ``instrument`` could not place."""

    def __init__(self):
        self.rows: list = []
        self.placed: list = []      # labels put around a member
        self.missing: list = []     # "Type.member" the program lacks

    def wrap(self, label: str, fn):
        """``fn`` inside a span ``label``."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.rows.append((t0, time.perf_counter(), label))
        return wrapped

    def around(self, obj, member: str, label: str, *,
               required: bool) -> None:
        """Put a span ``label`` around ``obj.member``. A public member the
        program lacks stops the run with its name; a private one (the
        program offers no public call there) is only noted, and the idle
        time it would have labelled falls to the other spans."""
        where = f"{type(obj).__name__}.{member}"
        if not callable(getattr(obj, member, None)):
            if required:
                raise RuntimeError(
                    f"traced run: {where} is gone from the program; "
                    f"bench/core/trace.py puts the span {label!r} "
                    f"around it")
            self.missing.append(where)
            return
        setattr(obj, member, self.wrap(label, getattr(obj, member)))
        self.placed.append(label)

    def report(self) -> dict:
        """The spans placed but never entered (a member the program now
        bypasses) and the members it lacks."""
        seen = {label for _, _, label in self.rows}
        return {"never_entered": sorted(set(self.placed) - seen),
                "missing": self.missing}


def instrument(spans: Spans, executor, frontend=None) -> None:
    """Put the harness's spans around the program's calls: the client's
    submit (an ``EngineExecutor`` stacks a full batch in it) or the
    dispatch of a stacked batch, quantize-in, the host-to-device staging,
    each stage's launches, the collection of results, and the frontend's
    batcher. Only traced runs do this. The spans wrap the program's public
    calls, and private ones only where it has no public call there."""
    for ex in getattr(executor, "replicas", None) or [executor]:
        runners = getattr(ex, "runners", None)
        if runners is None:             # the single EngineExecutor
            runners = [ex.runner]
            spans.around(ex, "submit", "submit", required=True)
            spans.around(ex, "_to_device", "stage_in", required=False)
        else:
            spans.around(ex, "submit_batch", "dispatch", required=True)
            spans.around(ex, "_stage_in", "stage_in", required=False)
        spans.around(runners[0], "quantize", "quantize_in", required=True)
        spans.around(runners[-1], "dequantize", "collect", required=True)
        for i, r in enumerate(runners):
            spans.around(r, "fn", "enqueue" if len(runners) == 1
                         else f"stage{i}.enqueue", required=True)
    if frontend is not None:
        spans.around(frontend, "_assemble", "batcher.assemble",
                     required=False)
        spans.around(frontend, "_dispatch_chunk", "batcher.dispatch",
                     required=False)


class Tracer:
    """Profiles ``[start_s, start_s + length_s]`` of a run's window, driven
    by ``tick(elapsed)`` calls from the driver's loop. ``counters()``
    snapshots the run's counters when the window opens and closes."""

    def __init__(self, cuda: bool, start_s: float, length_s: float,
                 counters):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.activities = acts
        self.cuda = cuda
        self.start_s, self.length_s = start_s, length_s
        self.counters = counters
        self.prof = None
        self.spans = Spans()
        self.t_open = 0.0           # host clock when the window opened
        self.phase = 0
        self.c0 = self.c1 = None
        self._t = 0.0
        self._ann = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so its first start
        (CUPTI's initialisation) does not stall the window."""
        with torch.profiler.profile(activities=self.activities):
            x = torch.ones(8, device="cuda" if self.cuda else "cpu")
            (x + 1).sum().item()

    def tick(self, elapsed: float) -> None:
        if self.phase == 0 and elapsed >= self.start_s:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
            self._t, self.phase = elapsed, 1
        elif self.phase == 1 and elapsed >= self._t + LEAD_S:
            self._ann = torch.profiler.record_function(WINDOW)
            t = time.perf_counter()
            self._ann.__enter__()
            self.t_open = 0.5 * (t + time.perf_counter())
            self.c0 = self.counters()
            self._t, self.phase = elapsed, 2
        elif self.phase == 2 and elapsed >= self._t + self.length_s:
            self.c1 = self.counters()
            self._ann.__exit__(None, None, None)
            self.phase = 3
        elif self.phase == 3:
            self.prof.stop()
            self.phase = 4

    def finish(self) -> None:
        """Close whatever the window left open (a window shorter than the
        traced span)."""
        if self.phase == 2:
            self.c1 = self.counters()
            self._ann.__exit__(None, None, None)
            self.phase = 3
        if self.phase == 3:
            self.prof.stop()
            self.phase = 4

    @property
    def done(self) -> bool:
        return self.phase == 4 and self.c0 is not None


def short_name(kernel: str, width: int = 96) -> str:
    """A kernel's name, short enough for a breakdown: a signature loses
    its return type, namespaces and arguments; an ATen elementwise kernel
    is named by its base and the functors it runs. Names that are not a
    signature (copies, sets) stay as they are."""
    if not kernel.startswith("void "):
        return kernel[:width]
    name = kernel[len("void "):]
    for ns in ("(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(ns, "")
    base = re.match(r"[\w:~]*", name).group()
    tags = list(dict.fromkeys(re.findall(r"\w+(?:_cuda|Functor)\b", name)))
    if tags:
        return f"{base}[{','.join(tags)}]"[:width]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][:width]
    return name[:width]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, spans: Spans, t_open: float, top: int = 10) -> dict:
    """From a stopped profiler and the harness's spans: the window (s),
    device busy (s), the top device ops by time, idle seconds by host
    activity, and the longest single gaps. Times in the trace are
    microseconds; ``t_open`` is the host clock at the window's start."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name == WINDOW and e.device_type == cpu]
    if not win:
        raise RuntimeError("the traced window's span is not in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, by_name = [], collections.Counter()
    host = [(w0 + (a - t_open) * 1e6, w0 + (b - t_open) * 1e6, label, False)
            for a, b, label in spans.rows]
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type != cpu:
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("bench.", "Activity Buffer"))):
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                by_name[e.name] += (b - a) * 1e-6
        elif e.name in WAITS:
            host.append((a, b, "wait." + e.name, True))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [s[0] for s in host]
    idle = collections.Counter()
    labelled = []
    for g0, g1 in gaps:
        m = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, m)
        work = wait = None
        for s in reversed(host[max(0, i - 512):i]):
            if s[1] >= m:
                if not s[3]:
                    work = s[2]
                    break
                wait = wait or s[2]
        label = work or wait or "host.other"
        idle[label] += (g1 - g0) * 1e-6
        labelled.append((g1 - g0, label))
    labelled.sort(reverse=True)
    short = collections.Counter()
    for name, sec in by_name.items():
        short[short_name(name)] += sec
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_ops": short.most_common(top),
            "idle_gaps": idle.most_common(top),
            "longest_gaps": [(lbl, d * 1e-6) for d, lbl in labelled[:top]],
            "gaps": len(gaps)}
