"""Streaming executor over a compiled :class:`EngineProgram`. PyTorch twin
of ``repro/core/executor.py``.

The paper's engines overlap three things per pipeline stage: reading the
next activation rows into one half of the line buffer, computing on the
other half, and draining finished outputs (activation-buffer double
buffering, Fig. 2). :class:`EngineExecutor` is the software analogue on a
frame stream:

* ``submit(frame)`` micro-batches incoming frames to ``batch_size``;
* a full micro-batch is quantized to int8 on the *host* into a pinned
  staging buffer, copied to the card with ``non_blocking=True`` and the
  step chain is launched on the current stream; a ``torch.cuda.Event``
  recorded after the chain marks the batch done. The device computes
  batch ``k`` while the host quantizes batch ``k+1`` and argmax-decodes
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
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.program import CompiledRunner, EngineProgram

# In-flight micro-batches. Two mirrors the paper's double-buffered
# activation memory: one batch computing on-device, one being staged
# host-side; a deeper queue only adds memory, not throughput.
DEFAULT_MAX_INFLIGHT = 2


def normalize_frames(program: EngineProgram,
                     frame: np.ndarray) -> np.ndarray:
    """Accept one ``[H, W, C]`` frame or a pre-batched ``[N, H, W, C]``
    chunk, validate it against ``program``'s input spec, and return the
    ``[N, H, W, C]`` form — the submit()-side twin of
    :func:`pad_micro_batch`."""
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


def pad_micro_batch(program: EngineProgram, frames: np.ndarray,
                    batch_size: int) -> np.ndarray:
    """Validate a ``[B, H, W, C]`` micro-batch against ``program``'s input
    spec and zero-pad it to ``batch_size`` (the fixed batch shape)."""
    frames = np.asarray(frames)
    hw = program.model.input_hw
    if frames.ndim != 4 or frames.shape[1:] != (hw, hw,
                                                program.model.input_ch):
        raise ValueError(
            f"micro-batch shape {frames.shape} does not match the "
            f"compiled program [B, {hw}, {hw}, {program.model.input_ch}]")
    if len(frames) > batch_size:
        raise ValueError(f"micro-batch of {len(frames)} exceeds the "
                         f"compiled batch size {batch_size}")
    if len(frames) < batch_size:
        pad = np.zeros((batch_size - len(frames),) + frames.shape[1:],
                       frames.dtype)
        frames = np.concatenate([frames, pad], axis=0)
    return frames


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
                 max_inflight: int = DEFAULT_MAX_INFLIGHT):
        if output not in ("top1", "logits"):
            raise ValueError(f"unknown output {output!r}")
        self.program = program
        self.batch_size = int(batch_size)
        self.output = output
        self.runner: CompiledRunner = program.compile_runner(route=route)
        self.stats = ServeStats()
        self.stats._first_n = self.batch_size
        self._pending: list[np.ndarray] = []
        self._inflight: collections.deque = collections.deque()
        self._max_inflight = max(1, int(max_inflight))
        self._results: list[np.ndarray] = []
        self._t0: float | None = None
        # Pinned host staging, one buffer per in-flight slot: batch k uses
        # slot k % max_inflight, which is free again once batch
        # k - max_inflight has been collected (its event waited on, so its
        # host-to-device copy is done).
        self._cuda = program.device.type == "cuda"
        self._staging: list[torch.Tensor] = []
        self._slot = 0

    # -- intake --------------------------------------------------------------

    def submit(self, frame: np.ndarray) -> None:
        """Queue one float frame ``[H, W, C]`` (or a pre-batched
        ``[N, H, W, C]`` chunk); dispatches whenever ``batch_size``
        frames are buffered."""
        for f in normalize_frames(self.program, frame):
            self._pending.append(f)
            if len(self._pending) >= self.batch_size:
                self._dispatch(self._pending[:self.batch_size])
                self._pending = self._pending[self.batch_size:]

    def serve(self, frames: Iterable[np.ndarray]) -> list[np.ndarray]:
        """Convenience: submit a finite stream and drain."""
        for f in frames:
            self.submit(f)
        return self.drain()

    # -- the overlap core ----------------------------------------------------

    def _to_device(self, xq: np.ndarray) -> torch.Tensor:
        """Host int8 batch -> device tensor: through a pinned staging
        buffer and an asynchronous copy on the current stream on CUDA."""
        if not self._cuda:
            return torch.from_numpy(xq)
        if not self._staging:
            self._staging = [torch.empty(xq.shape, dtype=torch.int8,
                                         pin_memory=True)
                             for _ in range(self._max_inflight)]
        buf = self._staging[self._slot]
        self._slot = (self._slot + 1) % self._max_inflight
        buf.numpy()[...] = xq
        return buf.to(self.program.device, non_blocking=True)

    def _dispatch(self, frames, n_valid: int | None = None):
        """Host quantize-in + asynchronous launch of one micro-batch (a
        list of frames from the pending buffer, or the padded
        ``[B, H, W, C]`` tail). Blocks only when ``max_inflight`` batches
        are already on device (the double-buffer back-pressure)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        while len(self._inflight) >= self._max_inflight:
            self._collect_one()
        n = n_valid if n_valid is not None else len(frames)
        batch = (frames if isinstance(frames, np.ndarray)
                 else np.stack(frames))
        xq = self.runner.quantize(batch)
        t0 = time.perf_counter()
        acc = self.runner(self._to_device(xq))
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        if self.stats.batches == 0:
            # The first launch builds the kernels; charge it separately so
            # steady_fps reflects the pipeline, not the build.
            if done is not None:
                done.synchronize()
            self.stats.first_batch_s = time.perf_counter() - t0
        self._inflight.append((acc, done, n))
        self.stats.batches += 1
        self.stats.frames += n
        self.stats.padded_frames += len(frames) - n

    def _collect_one(self) -> None:
        """Wait for the oldest in-flight batch and argmax/dequant it on the
        host — this runs while newer batches compute on device."""
        acc, done, n = self._inflight.popleft()
        if done is not None:
            done.synchronize()
        out = self.runner.dequantize(acc)[:n]
        if self.output == "top1":
            out = np.argmax(out.reshape(n, -1), axis=-1)
        self._results.append(out)

    # -- drain ---------------------------------------------------------------

    def drain(self) -> list[np.ndarray]:
        """Flush the partial tail (padded to the batch shape), collect
        everything, and return per-frame outputs in submission order."""
        if self._pending:
            tail = np.stack(self._pending)
            self._pending = []
            self._dispatch(pad_micro_batch(self.program, tail,
                                           self.batch_size),
                           n_valid=len(tail))
        while self._inflight:
            self._collect_one()
        if self._t0 is not None:
            # Accumulate only the active window; a later submit() opens a
            # fresh one, so host idle between drains never counts.
            self.stats.wall_s += time.perf_counter() - self._t0
            self._t0 = None
        results = self._results
        self._results = []
        if not results:
            return []
        flat = np.concatenate(results, axis=0)
        return list(flat)
