"""Streaming executor over a compiled :class:`EngineProgram`. PyTorch twin
of ``repro/core/executor.py``.

The paper's engines overlap three things per pipeline stage: reading the
next activation rows into one half of the line buffer, computing on the
other half, and draining finished outputs (activation-buffer double
buffering, Fig. 2). :class:`EngineExecutor` is the software analogue on a
frame stream:

* ``submit(frame)`` micro-batches incoming frames to ``batch_size``;
* a full micro-batch goes straight into a pinned staging slot
  (:func:`staging_slot`): on the card's kernel route as float32 frames,
  copied in one pass, which the runner rounds to int8 on the card as the
  first kernel of its graph; elsewhere quantized to int8 (int16 at
  bits=16) on the *host*, a chunk of frames at a time through the slot's
  float32 scratch. The slot is handed to the runner
  (:meth:`CompiledRunner.launch`), which copies it
  to the card without waiting, launches the step chain on the current
  stream (from the third batch on the kernel route, one replay of a
  CUDA graph), copies the final accumulators back to the host behind it
  and records an event that marks the batch done. The device computes
  batch ``k`` while the host stages batch ``k+1`` and argmax-decodes
  batch ``k-1`` (the two "buffer halves" are the bounded in-flight queue);
* ``drain()`` flushes the partial tail batch (padded to the batch shape)
  and collects all results.

Results are per-frame class ids (``top1``) or float logits; padding
frames are dropped on the way out. On a CPU program the same loop runs
synchronously.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.program import CompiledRunner, EngineProgram
from repro_torch.core.spans import span

# In-flight micro-batches. Two mirrors the paper's double-buffered
# activation memory: one batch computing on-device, one being staged
# host-side; a deeper queue only adds memory, not throughput.
DEFAULT_MAX_INFLIGHT = 2


def normalize_frames(program: EngineProgram,
                     frame: np.ndarray) -> np.ndarray:
    """Accept one ``[H, W, C]`` frame or a pre-batched ``[N, H, W, C]``
    chunk, validate it against ``program``'s input spec, and return the
    ``[N, H, W, C]`` form."""
    frame = np.asarray(frame)
    if frame.ndim == 3:
        frames = frame[None]
    elif frame.ndim == 4:
        frames = frame
    else:
        raise ValueError(f"expected [H,W,C] or [N,H,W,C], got "
                         f"{frame.shape}")
    hw = program.model.input_hw
    if frames.shape[1:] != (hw, hw, program.model.input_ch):
        raise ValueError(
            f"frame shape {frames.shape[1:]} does not match the "
            f"compiled program ({hw}, {hw}, {program.model.input_ch})")
    return frames


def staging_slot(runner: CompiledRunner, batch_size: int, *,
                 pinned: bool) -> tuple[torch.Tensor, np.ndarray | None]:
    """One slot of a serve loop's staging ring for the batches ``runner``
    (the first stage) takes: a host buffer of the batch's shape, pinned
    for an asynchronous copy to the card when ``pinned``, and the
    one-chunk float32 scratch the host's quantize-in passes frames
    through. Where the runner rounds on the card
    (``CompiledRunner.card_intake``) the buffer holds float32 frames and
    there is no scratch (None); else it holds the quantized batch in the
    program's input dtype, int8 or int16 at bits=16. Quantize-in writes
    into the buffer (and refuses any other dtype); a slot is used by one
    thread at a time."""
    m = runner.program.model
    shape = (batch_size, m.input_hw, m.input_hw, m.input_ch)
    if runner.card_intake:
        return torch.empty(shape, dtype=torch.float32,
                           pin_memory=pinned), None
    buf = torch.empty(shape, dtype=quant.int_dtype(runner.program.bits),
                      pin_memory=pinned)
    return buf, quant.quantize_scratch(buf.shape)


@dataclasses.dataclass
class ServeStats:
    """Steady-state accounting for one serve run."""

    frames: int = 0
    batches: int = 0
    padded_frames: int = 0
    wall_s: float = 0.0          # active serving time (idle between
    first_batch_s: float = 0.0   # drains excluded); the first batch is
    # charged to first_batch_s (kernel build + first launch) and excluded
    # from fps.

    @property
    def steady_fps(self) -> float:
        """Frames/s excluding the first batch (kernel build + warmup).
        Returns 0.0 when every frame landed in that first batch: there is
        no steady-state window to measure, not a measured rate of zero."""
        steady_wall = self.wall_s - self.first_batch_s
        steady_frames = self.frames - min(self.frames, self._first_n)
        if steady_wall <= 0 or steady_frames <= 0:
            return 0.0
        return steady_frames / steady_wall

    _first_n: int = 0


class EngineExecutor:
    """Micro-batching serve loop over one engine chain.

    >>> ex = EngineExecutor(program, batch_size=32)
    >>> for frame in frames:
    ...     ex.submit(frame)            # [H, W, C] float
    >>> ids = ex.drain()                # per-frame top-1 class ids
    >>> ex.stats.steady_fps
    """

    def __init__(self, program: EngineProgram, *, batch_size: int = 32,
                 route: str | None = None, output: str = "top1",
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 on_result: Callable[[object, np.ndarray], None]
                 | None = None):
        if output not in ("top1", "logits"):
            raise ValueError(f"unknown output {output!r}")
        self.program = program
        self.batch_size = int(batch_size)
        self.output = output
        self.on_result = on_result
        # Protocol slot only: this executor raises synchronously from
        # submit_batch / flush_inflight, so the callback is never fired.
        self.on_error: Callable[[object, BaseException], None] | None = None
        self.runner: CompiledRunner = program.compile_runner(route=route)
        self.stats = ServeStats()
        self.stats._first_n = self.batch_size
        # One lock serializes the pending micro-batch, the in-flight
        # queue, and stats, so several producer threads (the async
        # frontend's batcher plus direct callers) can feed one executor.
        # Re-entrant because _dispatch collects under the same lock when
        # back-pressured.
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._inflight: collections.deque = collections.deque()
        self._max_inflight = max(1, int(max_inflight))
        self._results: list[np.ndarray] = []
        self._t0: float | None = None
        # The spans' owner and batch numbers (never reset, unlike stats).
        self._owner = id(self)
        self._seq = 0
        # Host staging, one slot (buffer and quantize-in scratch) per
        # in-flight batch, pinned on CUDA: batch k uses slot k %
        # max_inflight, which is free again once batch k - max_inflight
        # has been collected (its event waited on, so its host-to-device
        # copy is done). The CPU runs the same ring, unpinned.
        self._staging: list[tuple[torch.Tensor, np.ndarray]] = []
        self._slot = 0

    # -- intake --------------------------------------------------------------

    def submit(self, frame: np.ndarray) -> None:
        """Queue one float frame ``[H, W, C]`` (or a pre-batched
        ``[N, H, W, C]`` chunk); dispatches whenever ``batch_size``
        frames are buffered."""
        frames = normalize_frames(self.program, frame)
        with self._lock:
            for f in frames:
                self._pending.append(f)
                if len(self._pending) >= self.batch_size:
                    self._dispatch(self._pending[:self.batch_size])
                    self._pending = self._pending[self.batch_size:]

    def submit_batch(self, frames: np.ndarray, n_valid: int,
                     tag: object = None) -> None:
        """Dispatch one pre-assembled micro-batch ``[B, H, W, C]``
        directly (padded with zero frames to the batch size if short),
        bypassing the pending buffer — the entry point the async
        frontend's batcher uses. ``tag`` is handed to ``on_result`` with
        this batch's outputs. Thread-safe; blocks when ``max_inflight``
        batches are already on the device."""
        with self._lock:
            self._dispatch(frames, n_valid=n_valid, tag=tag)

    def flush_inflight(self) -> None:
        """Collect every dispatched micro-batch (delivering their
        ``on_result`` callbacks) without flushing the pending tail."""
        with self._lock:
            while self._inflight:
                self._collect_one()

    def serve(self, frames: Iterable[np.ndarray]) -> list[np.ndarray]:
        """Convenience: submit a finite stream and drain."""
        for f in frames:
            self.submit(f)
        return self.drain()

    def reset_stats(self) -> None:
        """Zero the serve statistics (between drains, not mid-stream:
        with batches still in flight the window split would be
        meaningless)."""
        with self._lock:
            if self._inflight or self._pending:
                raise RuntimeError("reset_stats with work in flight")
            self.stats = ServeStats()
            self.stats._first_n = self.batch_size
            self._t0 = None

    def replica_counts(self) -> list | None:
        """Protocol conformance: a single chain is not a replica fleet."""
        return None

    # -- the overlap core ----------------------------------------------------

    def _dispatch(self, frames, n_valid: int | None = None,
                  tag: object = None):
        """Quantize-in + asynchronous launch of one micro-batch (a list of
        frames from the pending buffer, or an ``[n, H, W, C]`` array, ``n
        <= batch_size``), staged straight into the next staging slot (its
        float frames on the card path, else quantized) and zero-padded
        there. Blocks only when
        ``max_inflight`` batches are already on device (the double-buffer
        back-pressure). Caller holds the lock."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        while len(self._inflight) >= self._max_inflight:
            self._collect_one()
        n = n_valid if n_valid is not None else len(frames)
        owner, seq = self._owner, self._seq
        self._seq += 1
        with span("engine.stack", owner=owner, batch=seq):
            if not self._staging:
                pinned = self.runner.device.type == "cuda"
                self._staging = [staging_slot(self.runner, self.batch_size,
                                              pinned=pinned)
                                 for _ in range(self._max_inflight)]
            buf, scratch = self._staging[self._slot]
        with span("engine.quantize", owner=owner, batch=seq):
            self.runner.quantize(frames, out=buf.numpy(), scratch=scratch)
        # The slot moves on only once it holds this batch: a refused batch
        # leaves the ring where it was.
        self._slot = (self._slot + 1) % self._max_inflight
        t0 = time.perf_counter()
        with span("engine.enqueue", owner=owner, batch=seq):
            acc, done = self.runner.launch(buf, sleep=False)
        if self.stats.batches == 0:
            # The first launch builds the kernels; charge it separately so
            # steady_fps reflects the pipeline, not the build.
            if done is not None:
                done.synchronize()
            self.stats.first_batch_s = time.perf_counter() - t0
        self._inflight.append((acc, done, n, tag, seq))
        self.stats.batches += 1
        self.stats.frames += n
        self.stats.padded_frames += self.batch_size - n

    def _collect_one(self) -> None:
        """Wait for the oldest in-flight batch and argmax/dequant it on the
        host — this runs while newer batches compute on device. Tagged
        batches go to ``on_result``; untagged ones accumulate for
        :meth:`drain`."""
        acc, done, n, tag, seq = self._inflight.popleft()
        with span("engine.wait", owner=self._owner, batch=seq):
            if done is not None:
                done.synchronize()
        with span("engine.collect", owner=self._owner, batch=seq):
            out = self.runner.decode(acc, n, self.output)
            if tag is not None and self.on_result is not None:
                self.on_result(tag, out)
            else:
                self._results.append(out)

    # -- drain ---------------------------------------------------------------

    def drain(self) -> list[np.ndarray]:
        """Flush the partial tail (padded to the batch shape), collect
        everything, and return per-frame outputs in submission order.
        Thread-safe."""
        with self._lock:
            if self._pending:
                tail = self._pending
                self._pending = []
                self._dispatch(tail)
            while self._inflight:
                self._collect_one()
            if self._t0 is not None:
                # Accumulate only the active window; a later submit()
                # opens a fresh one, so host idle between drains never
                # counts.
                self.stats.wall_s += time.perf_counter() - self._t0
                self._t0 = None
            results = self._results
            self._results = []
        if not results:
            return []
        flat = np.concatenate(results, axis=0)
        return list(flat)
