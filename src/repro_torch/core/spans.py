"""The serve path's own spans: each layer of the executors and the frontend
times its work on the host, one row a span, into a bounded buffer.

>>> spans.enable()
>>> ...                                 # serve
>>> rows = spans.drain()                # and clear
>>> spans.disable()

A row (:class:`Span`) holds the span's name, its owner (the ``id`` of the
executor or frontend that made it, so the replicas of a pool stay apart),
the batch it belongs to (the owner's batch sequence number), the thread,
its start and end on ``time.perf_counter()`` and the thread's CPU seconds
inside it (``time.thread_time()``). Its wall time less its CPU seconds is
time the thread was runnable or blocked but off the CPU: waiting for the
GIL, descheduled, or in a blocking call.

Recording is off by default. It is on between :func:`enable` and
:func:`disable`, and while a ``torch.profiler`` session runs, so a profile
of a server carries the program's spans on the host clock beside the
device's activity. Off, :func:`span` returns one shared no-op context: it
allocates nothing, reads no clock and takes no lock. The buffer keeps the
newest :data:`MAXLEN` rows and counts what it drops (:func:`dropped`), so
a long-running server does not grow.
"""

from __future__ import annotations

import collections
import threading
import time

import torch.autograd.profiler as _profiler

MAXLEN = 1 << 16

_on = False
_lock = threading.Lock()
_rows: collections.deque = collections.deque(maxlen=MAXLEN)
_dropped = 0


class Span:
    """One recorded span. ``batch`` may be set once it is known, even after
    the span ended: a submitting thread learns a batch's sequence number
    only when it enqueues the batch, a stage worker only once its queue
    hands the batch over."""

    __slots__ = ("name", "owner", "batch", "thread", "t0", "t1", "cpu_s")

    def __init__(self, name: str, owner: int, batch: int | None):
        self.name, self.owner, self.batch = name, owner, batch

    def __enter__(self) -> "Span":
        self.thread = threading.get_ident()
        # Wall clock outside CPU clock on both ends: cpu_s <= t1 - t0.
        self.t0 = time.perf_counter()
        self.cpu_s = time.thread_time()
        return self

    def __exit__(self, typ, val, tb) -> None:
        global _dropped
        self.cpu_s = time.thread_time() - self.cpu_s
        self.t1 = time.perf_counter()
        with _lock:
            if len(_rows) == _rows.maxlen:
                _dropped += 1
            _rows.append(self)


class _Off:
    """The context :func:`span` returns while recording is off."""

    __slots__ = ()
    batch = property(lambda self: None, lambda self, value: None)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, typ, val, tb) -> None:
        return None


_OFF = _Off()


def span(name: str, *, owner: int, batch: int | None):
    """A context that records the span ``name`` of ``owner``'s ``batch``
    while recording is on, and does nothing otherwise."""
    if _on or _profiler._is_profiler_enabled:
        return Span(name, owner, batch)
    return _OFF


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list[Span]:
    """The rows recorded, oldest first, and clear the buffer."""
    with _lock:
        rows = list(_rows)
        _rows.clear()
    return rows


def dropped() -> int:
    """Rows the full buffer has dropped since the process started."""
    return _dropped
