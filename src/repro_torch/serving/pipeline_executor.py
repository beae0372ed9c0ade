"""Stage-pipelined executor: one worker thread per stage, bounded queues.
PyTorch twin of ``repro/serving/pipeline_executor.py``.

The paper's engines run concurrently, exchanging row groups through
double-buffered activation memories: engine i computes row group n while
engine i+1 consumes row group n-1 (Fig. 2). :class:`PipelineExecutor` is
the same structure at micro-batch granularity:

* the step chain is split into K contiguous stages with near-equal
  modeled cycles (:func:`repro_torch.serving.partition.partition_program`
  — Algorithm 1's balance objective);
* each stage is one runner over its step range
  (:meth:`EngineProgram.compile_stage_runner`) driven by its own worker
  thread;
* stages are connected by depth-2 :class:`queue.Queue`\\ s — the two
  halves of the activation double buffer. A full queue stalls the
  producer stage exactly like a full activation buffer stalls the
  upstream engine (backpressure), so at most ``queue_depth`` micro-batches
  sit between any two stages.

Activations cross stage boundaries as the same int8 (int16 at bits=16)
tensors the whole chain passes between steps (at a cut inside a residual
block, the tuple of every tensor live there: the block's input beside
the activation, each moved to the next stage's device by its runner, as
the activation is), and the last stage hands
the collector its int32 (int64 at bits=16) accumulators, so the K-stage
pipeline is bit-identical to :meth:`EngineProgram.compile_runner` for
every route (pinned by ``tests/test_torch_serving.py``); K=1 degenerates
to one worker.

How a stage waits for the card. The reference's stage worker calls
``block_until_ready`` on its output: on one TPU, XLA runs programs in
order, so that waits for this stage's output and for everything queued
before it. Here each stage launches its kernels on its device's current
stream (the default stream, shared by every thread of the process, so
the stages' kernels run in submission order as on the TPU), records a
``torch.cuda.Event`` after its own launches and waits on that event only
(never ``torch.cuda.synchronize``, which waits on the whole device). The
event is created with ``blocking=True`` so a waiting worker sleeps
instead of spinning a core the other stages' host work needs. The wait
gives ``stage_busy_s`` and hands a finished tensor to the next queue.
Stage 0 moves the quantized host batch to the card from a pinned staging
ring of ``queue_depth + 1`` buffers in the program's input dtype, each
with the float32 scratch quantize-in passes frames through: the
submitting thread takes a free buffer (blocking while all are in
flight), quantizes the float frames straight into it and queues it;
stage 0 copies it to the card with ``non_blocking=True`` and returns the
buffer to the ring once its event has completed, so no buffer is
rewritten while its copy is in flight. On the CPU the stages run
synchronously in their threads, over the same ring unpinned.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.executor import (ServeStats, normalize_frames,
                                       staging_buffer)
from repro_torch.core.program import CompiledRunner, EngineProgram
from repro_torch.core.spans import span
from repro_torch.serving.partition import (partition_from_boundaries,
                                           partition_program, stage_devices)

# Inter-stage queue depth: two mirrors the paper's double-buffered
# activation memory (one micro-batch in flight, one staged).
DEFAULT_QUEUE_DEPTH = 2

_SENTINEL = ("stop", 0, None, None, 0)


class PipelineExecutor:
    """Serve a frame stream through a K-stage software pipeline.

    >>> px = PipelineExecutor(program, stages=2, batch_size=32)
    >>> for frame in frames:
    ...     px.submit(frame)            # [H, W, C] float
    >>> ids = px.drain()                # per-frame top-1 class ids
    >>> px.close()

    ``on_result`` (for the async frontend) is called from the collector
    thread with ``(tag, outputs)`` for every micro-batch submitted with a
    non-None tag; ``on_error`` with ``(tag, exception)`` when such a
    batch fails in a stage. Untagged batches accumulate for
    :meth:`drain`.
    """

    def __init__(self, program: EngineProgram, *, stages: int = 2,
                 batch_size: int = 32, boundaries: Sequence[int] | None = None,
                 route: str | None = None, output: str = "top1",
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 place_stages: bool = False,
                 devices: Sequence | None = None,
                 on_result: Callable[[object, np.ndarray], None] | None = None,
                 on_error: Callable[[object, BaseException], None] | None = None):
        if output not in ("top1", "logits"):
            raise ValueError(f"unknown output {output!r}")
        self.program = program
        self.batch_size = int(batch_size)
        self.output = output
        self.on_result = on_result
        self.on_error = on_error
        if boundaries is not None:
            if len(tuple(boundaries)) != stages + 1:
                raise ValueError(
                    f"boundaries {tuple(boundaries)} is not a {stages}-"
                    f"stage contiguous cover of [0, {len(program.steps)})")
            self.partition = partition_from_boundaries(program, boundaries)
        else:
            self.partition = partition_program(program, stages)
        # place_stages pins stage i to cuda:(i % n) so K-stage pipelining
        # buys real concurrency on a host with several cards; transparent
        # on one card, where every stage lands on cuda:0 and the
        # arithmetic is unchanged (a program on the CPU keeps its stages
        # there). An explicit ``devices`` list round-robins over that
        # list instead — the replica pool uses it to pin a whole replica
        # to one device (pipeline mode) or its stages across a device
        # slice (stage-shard mode).
        n = self.partition.n_stages
        if devices is not None:
            self.stage_devices = stage_devices(n, list(devices))
        elif place_stages:
            self.stage_devices = stage_devices(
                n, None if program.device.type == "cuda"
                else [program.device])
        else:
            self.stage_devices = [None] * n
        self.runners: list[CompiledRunner] = [
            program.compile_stage_runner(b, e, route=route, device=dev)
            for (b, e), dev in zip(self.partition.stage_ranges(),
                                   self.stage_devices)]
        self.route = self.runners[0].route
        self.stats = ServeStats()
        self.stats._first_n = self.batch_size
        self.stage_busy_s = [0.0] * n
        # The spans' owner, each stage's span names (made once) and the
        # batch each stage is running.
        self._owner = id(self)
        self._stage_spans = [tuple(f"stage{i}.{part}" for part in
                                   ("idle", "launch", "wait", "handoff"))
                             for i in range(n)]
        self._stage_batch: list[int | None] = [None] * n

        depth = max(1, int(queue_depth))
        # queues[i] feeds stage i; queues[K] feeds the collector.
        self._queues = [queue.Queue(maxsize=depth) for _ in range(n + 1)]
        # The staging ring (pinned on CUDA): its free slots, a buffer and
        # its quantize-in scratch each, depth + 1 of them (stage 0's queue
        # full and one batch in stage 0). Whole-batch scratches: the
        # intake runs beside K stage threads that launch under the GIL,
        # so quantize-in takes the torch walk, which gives the GIL up and
        # back a handful of times a batch.
        self._cuda = self.runners[0].device.type == "cuda"
        self._free: queue.Queue = queue.Queue()
        for _ in range(depth + 1):
            buf = staging_buffer(program, self.batch_size, pinned=self._cuda)
            self._free.put((buf, quant.quantize_scratch(buf.shape,
                                                        whole=True)))
        self._threads: list[threading.Thread] = []
        self._lock = threading.RLock()
        # Serializes batch assembly + seq assignment + stage-0 enqueue as
        # one step so concurrent producers cannot interleave out of
        # order, and so close() cannot slip its stop sentinel past a
        # producer blocked on a full queue. Separate from _lock: the
        # holder may block on a full queue, and the collector needs
        # _lock to drain it. Re-entrant: submit() holds it across the
        # pending-buffer flush while submit_batch re-acquires.
        self._order_lock = threading.RLock()
        self._done = threading.Condition(self._lock)
        self._pending: list[np.ndarray] = []
        self._results: list[np.ndarray] = []
        self._submitted = 0
        self._collected = 0
        self._error: BaseException | None = None
        self._closed = False
        self._t0: float | None = None
        self._first_t0: float | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Spawn the K stage workers and the collector (idempotent;
        :meth:`submit` calls this lazily on first use)."""
        if self._threads:
            return
        if self._closed:
            raise RuntimeError("PipelineExecutor is closed")
        for i in range(self.partition.n_stages):
            t = threading.Thread(target=self._stage_worker, args=(i,),
                                 name=f"pipeline-stage-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._collector,
                             name="pipeline-collector", daemon=True)
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        """Stop all workers (waits for in-flight batches to finish).
        Taking the order lock first means no producer is mid-enqueue, so
        the stop sentinel can never overtake a submitted batch into a
        dead queue."""
        if self._closed:
            return
        with self._order_lock:
            self._closed = True
            if self._threads:
                self._queues[0].put(_SENTINEL)
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self) -> "PipelineExecutor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- intake --------------------------------------------------------------

    def submit(self, frame: np.ndarray) -> None:
        """Queue one float frame ``[H, W, C]`` (or a pre-batched
        ``[N, H, W, C]`` chunk); dispatches whenever ``batch_size`` frames
        are buffered. Thread-safe."""
        frames = normalize_frames(self.program, frame)
        # Buffer-flush and dispatch happen under one order-lock hold, or
        # a second producer could assemble and enqueue a later batch
        # between this one's assembly and its enqueue.
        with self._order_lock:
            full: list[list[np.ndarray]] = []
            with self._lock:
                for f in frames:
                    self._pending.append(f)
                    if len(self._pending) >= self.batch_size:
                        full.append(self._pending[:self.batch_size])
                        self._pending = self._pending[self.batch_size:]
            for batch in full:
                self.submit_batch(batch, len(batch))

    def submit_batch(self, frames: np.ndarray, n_valid: int,
                     tag: object = None) -> None:
        """Dispatch one float micro-batch ``[B, H, W, C]`` (padded with
        zero frames to the batch size if short; a list of frames is taken
        too). Takes a free buffer of the staging ring and quantizes into
        it on the calling thread — the host half of the stage-0 double
        buffer — and blocks while the ring is empty or the stage-0 queue
        is full (backpressure)."""
        self._check_error()
        self.start()
        owner = self._owner
        with span("pipeline.stage_in", owner=owner, batch=None) as stage_in:
            slot = self._stage_in()
        try:
            with span("pipeline.quantize", owner=owner,
                      batch=None) as quantize:
                self.runners[0].quantize(frames, out=slot[0].numpy(),
                                         scratch=slot[1])
            # seq assignment and the stage-0 enqueue must be one atomic
            # step, or two producers could enter the FIFO out of
            # submission order (and a close() racing a blocked producer
            # could slot its stop sentinel ahead of this batch).
            with self._order_lock:
                if self._closed:
                    raise RuntimeError("PipelineExecutor is closed")
                with self._lock:
                    if self._t0 is None:
                        self._t0 = time.perf_counter()
                    if self._first_t0 is None:
                        self._first_t0 = time.perf_counter()
                    seq = self._submitted
                    self._submitted += 1
                    self.stats.batches += 1
                    self.stats.frames += n_valid
                    self.stats.padded_frames += self.batch_size - n_valid
                quantize.batch = stage_in.batch = seq
                with span("pipeline.put", owner=owner, batch=seq):
                    self._put(self._queues[0],
                              ("batch", seq, tag, slot, n_valid))
        except BaseException:
            # The batch never reached stage 0: its slot goes back.
            self._free.put(slot)
            raise

    def _stage_in(self) -> tuple[torch.Tensor, np.ndarray]:
        """A free slot of the staging ring (buffer, scratch) for the next
        batch's quantize-in; waits while every buffer is in flight (stage
        0 gives one back once its copy to the card is done)."""
        while True:
            self._check_error()
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue

    def serve(self, frames: Iterable[np.ndarray]) -> list[np.ndarray]:
        """Convenience: submit a finite stream and drain."""
        for f in frames:
            self.submit(f)
        return self.drain()

    def reset_stats(self) -> None:
        """Zero the serve statistics (after a warmup pass, so a measured
        window starts with built kernels and counts every frame: fresh
        stats have ``_first_n = 0`` — no first-batch exclusion needed
        once nothing is cold). Call between drains, not mid-stream."""
        with self._lock:
            if self._collected < self._submitted or self._pending:
                raise RuntimeError("reset_stats with work in flight")
            self.stats = ServeStats()
            self.stage_busy_s = [0.0] * self.partition.n_stages
            self._t0 = None

    def flush_inflight(self) -> None:
        """Protocol no-op: the collector thread delivers results
        continuously, so there is never anything to flush on demand."""

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until every submitted micro-batch has cleared all K
        stages (tagged and untagged alike) — the executor-side half of a
        drain->swap->resume handoff. Unlike :meth:`drain` this neither
        flushes the partial tail nor consumes results; it only waits.
        Returns ``True`` when idle, ``False`` on timeout. Raises if a
        stage worker has failed (a dead stage will never go idle)."""
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        with self._done:
            while self._collected < self._submitted and self._error is None:
                remaining = 0.1
                if deadline is not None:
                    remaining = min(remaining,
                                    deadline - time.perf_counter())
                    if remaining <= 0:
                        return False
                self._done.wait(timeout=remaining)
        self._check_error()
        return True

    def replica_counts(self) -> list | None:
        """Protocol conformance: a single pipeline is not a replica
        fleet."""
        return None

    @property
    def batches_run(self) -> int:
        """Micro-batches submitted over the executor's life (warmup and
        every drain included, unlike :attr:`stats`)."""
        return self._submitted

    # -- drain ---------------------------------------------------------------

    def drain(self) -> list[np.ndarray]:
        """Flush the partial tail, wait for every in-flight micro-batch to
        clear all K stages, and return per-frame outputs of untagged
        batches in submission order. Workers stay alive for reuse."""
        with self._lock:
            tail = self._pending
            self._pending = []
        if tail:
            self.submit_batch(tail, len(tail))
        with self._done:
            while self._collected < self._submitted and self._error is None:
                self._done.wait(timeout=0.1)
        self._check_error()
        with self._lock:
            if self._t0 is not None:
                # Active serving window only (idle between drains excluded).
                self.stats.wall_s += time.perf_counter() - self._t0
                self._t0 = None
            results = self._results
            self._results = []
        if not results:
            return []
        flat = np.concatenate(results, axis=0)
        return list(flat)

    # -- workers -------------------------------------------------------------

    def _put(self, q: queue.Queue, item) -> None:
        while True:
            self._check_error()
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                "pipeline worker failed; no further batches can be "
                "served") from self._error

    def _fail(self, exc: BaseException) -> None:
        with self._done:
            if self._error is None:
                self._error = exc
            self._done.notify_all()

    def _run_stage(self, i: int, payload):
        """Stage i on one batch: launch its steps on the device's current
        stream, record an event after them and wait on it. Stage 0 takes
        a slot of the staging ring, copies its pinned buffer to the card
        (runs on it in place on the CPU) and gives the slot back to the
        ring once the copy is known done. The two spans cover the whole
        call, so they add up to ``stage_busy_s``."""
        _, launch, wait, _ = self._stage_spans[i]
        seq = self._stage_batch[i]
        with span(launch, owner=self._owner, batch=seq):
            runner = self.runners[i]
            cuda = runner.device.type == "cuda"
            x, done = (payload[0] if i == 0 else payload), None
            with (torch.cuda.device(runner.device) if cuda
                  else contextlib.nullcontext()):
                if cuda and i == 0:
                    x = x.to(runner.device, non_blocking=True)
                out = runner(x)
                if cuda:
                    done = torch.cuda.Event(blocking=True)
                    done.record()
        with span(wait, owner=self._owner, batch=seq):
            if done is not None:
                done.synchronize()
            if i == 0:
                self._free.put(payload)
        return out

    def _stage_worker(self, i: int) -> None:
        """Run stage i: pull a micro-batch, run the stage's step range,
        hand the int8 boundary activations (or final accumulators) to the
        next queue. FIFO queues + one thread per stage preserve
        submission order end to end."""
        q_in, q_out = self._queues[i], self._queues[i + 1]
        idle, _, _, handoff = self._stage_spans[i]
        while True:
            with span(idle, owner=self._owner, batch=None) as waiting:
                item = q_in.get()
            if item[0] == "stop":
                q_out.put(item)
                return
            kind, seq, tag, payload, n_valid = item
            waiting.batch = self._stage_batch[i] = seq
            if kind == "batch":
                try:
                    t0 = time.perf_counter()
                    out = self._run_stage(i, payload)
                    self.stage_busy_s[i] += time.perf_counter() - t0
                    item = ("batch", seq, tag, out, n_valid)
                except BaseException as e:  # noqa: BLE001 - forwarded
                    self._fail(e)
                    item = ("err", seq, tag, e, n_valid)
            with span(handoff, owner=self._owner, batch=seq):
                q_out.put(item)

    def _collector(self) -> None:
        """Final stage: dequantize/argmax on the host (overlapping the
        device stages), deliver results, account completion."""
        runner = self.runners[-1]
        q = self._queues[-1]
        while True:
            item = q.get()
            if item[0] == "stop":
                return
            kind, seq, tag, payload, n_valid = item
            out = None
            if kind == "batch":
                try:
                    with span("collect.dequantize", owner=self._owner,
                              batch=seq):
                        out = runner.dequantize(payload)[:n_valid]
                        if self.output == "top1":
                            # reshape(0, -1) is ill-posed for an
                            # all-padding batch; its top-1 is just empty.
                            out = (np.argmax(out.reshape(n_valid, -1),
                                             axis=-1)
                                   if n_valid else
                                   np.zeros((0,), dtype=np.int64))
                except BaseException as e:  # noqa: BLE001 - recorded
                    self._fail(e)
                    kind, payload = "err", e
            with span("collect.deliver", owner=self._owner, batch=seq):
                with self._done:
                    if self._collected == 0 and self._first_t0 is not None:
                        # The first micro-batch traverses K cold stages
                        # serially — pipeline fill + kernel build, charged
                        # apart from steady state exactly like
                        # EngineExecutor's first batch.
                        self.stats.first_batch_s = (time.perf_counter()
                                                    - self._first_t0)
                    self._collected += 1
                    if kind == "batch":
                        if tag is None:
                            self._results.append(out)
                    self._done.notify_all()
                if tag is not None:
                    try:
                        if kind == "batch" and self.on_result:
                            self.on_result(tag, out)
                        elif kind == "err" and self.on_error:
                            # A failed tagged batch must still answer its
                            # requests — deliver the stage error instead of
                            # leaving the futures hanging.
                            self.on_error(tag, payload)
                    except BaseException as e:  # noqa: BLE001 - recorded
                        self._fail(e)
