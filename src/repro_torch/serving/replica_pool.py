"""R replicas of the compiled pipeline behind a least-estimated-wait router.
PyTorch twin of ``repro/serving/replica_pool.py``.

The paper's Algorithm 1 balances engine resources across the stages of
*one* pipeline; Shen et al. (PAPERS.md) show the next efficiency tier
comes from splitting the fabric into multiple specialized processors.
:class:`ReplicaPool` is that move for the serving plane: it instantiates
R independent :class:`~repro_torch.serving.pipeline_executor.PipelineExecutor`
replicas of one compiled :class:`~repro_torch.core.program.EngineProgram` and
routes each ready micro-batch to the replica with the least estimated
wait (:class:`~repro_torch.serving.router.LeastWaitRouter`).

Two replica modes co-partition the devices (default: every CUDA device
for a program on the card, the program's own device otherwise):

* ``pipeline`` — whole-pipeline data parallelism: replica r's K stages
  all pin to ``devices[r % D]``, so each device runs one complete
  pipeline (the Shen "one specialized processor per partition" shape);
* ``stage-shard`` — the D devices split into R contiguous near-equal
  slices (:func:`repro_torch.launch.mesh.device_slices`) and each replica
  stage-pipelines *across its slice*: the Algorithm-1 DP balances the
  step chain into ``len(slice)`` stages and stage i pins to slice[i]
  (replication x flexible pipelining composed).

On one card, R replicas share ``cuda:0`` in both modes (the reference
calls that transparent): their stages launch on the one default stream,
so replication buys host-side concurrency only.

The pool satisfies the executor duck type the
:class:`~repro_torch.serving.frontend.AsyncFrontend` expects (``batch_size``,
``submit_batch(frames, n_valid, tag)``, ``on_result``/``on_error``
slots, ``program``), so the frontend — lanes, deadlines, admission —
is structurally unchanged: admission keeps pricing the *fleet* backlog
because its shared estimator observes the interleaved completion beat
of all R replicas. Every replica dispatch is wrapped in a pool tag, so
per-replica outcomes (dispatched/completed/failed) are counted exactly
and :meth:`replica_counts` reconciles against fleet totals.

Bit-identity: routing only chooses *where* a micro-batch runs; every
replica executes the same compiled step chain with the same int8 stage
boundaries, so pooled output equals the single-replica pipeline frame
for frame in both modes (pinned by ``tests/test_router.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.executor import ServeStats, normalize_frames
from repro_torch.core.program import EngineProgram
from repro_torch.launch.mesh import cuda_devices, device_slices
from repro_torch.serving.pipeline_executor import (DEFAULT_QUEUE_DEPTH,
                                             PipelineExecutor)
from repro_torch.serving.router import (DEFAULT_PROBE_EVERY,
                                  DEFAULT_QUARANTINE_AFTER,
                                  DEFAULT_STRAGGLER_FACTOR, LeastWaitRouter)

REPLICA_MODES = ("pipeline", "stage-shard")


@dataclasses.dataclass(frozen=True)
class _Dispatch:
    """Pool-level tag wrapped around every replica submission: which
    replica got batch ``seq``, when, how many frames were real, and the
    caller's own tag (None for the drain path). ``probe`` marks router
    health probes — synthetic all-padding batches that feed the router
    (re-admission / straggler decay) but never touch live accounting."""

    seq: int
    replica: int
    n_valid: int
    t_disp: float
    tag: object
    probe: bool = False


def _fresh_row() -> dict:
    return {"dispatched_batches": 0, "dispatched_frames": 0,
            "completed_batches": 0, "completed_frames": 0,
            "failed_batches": 0, "failed_frames": 0,
            "probe_batches": 0}


class ReplicaPool:
    """Serve one frame stream through R routed pipeline replicas.

    >>> pool = ReplicaPool(program, replicas=2, stages=2, batch_size=32)
    >>> for frame in frames:
    ...     pool.submit(frame)
    >>> ids = pool.drain()          # per-frame outputs, submission order
    >>> pool.close()

    ``executors`` swaps in pre-built replica executors (tests use fakes
    with a ``submit_batch``/``on_result`` surface); otherwise R
    :class:`PipelineExecutor` replicas are compiled from ``program``
    according to ``mode``.
    """

    def __init__(self, program: EngineProgram | None = None, *,
                 executors: Sequence[object] | None = None,
                 replicas: int = 2, mode: str = "pipeline",
                 stages: int = 2, batch_size: int = 32,
                 route: str | None = None, output: str = "top1",
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 devices: Sequence[object] | None = None,
                 router_seed: int = 0,
                 straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 probe_every: int = DEFAULT_PROBE_EVERY,
                 on_result: Callable[[object, np.ndarray], None] | None = None,
                 on_error: Callable[[object, BaseException], None] | None = None):
        if mode not in REPLICA_MODES:
            raise ValueError(f"unknown replica mode {mode!r} "
                             f"(expected one of {REPLICA_MODES})")
        self.program = program
        self.mode = mode
        self.output = output
        self.on_result = on_result
        self.on_error = on_error

        if executors is not None:
            self.replicas = list(executors)
            if not self.replicas:
                raise ValueError("executors is empty")
            self.batch_size = int(getattr(self.replicas[0], "batch_size",
                                          batch_size))
            self.replica_devices: list[list[str] | None] = \
                [None] * len(self.replicas)
        else:
            if program is None:
                raise ValueError("need a program or pre-built executors")
            if replicas < 1:
                raise ValueError(f"replicas={replicas} < 1")
            self.batch_size = int(batch_size)
            self.replicas, self.replica_devices = self._build_replicas(
                program, replicas, mode, stages=stages, batch_size=batch_size,
                route=route, output=output, queue_depth=queue_depth,
                devices=devices)
        self.n_replicas = len(self.replicas)
        self.partition = getattr(self.replicas[0], "partition", None)
        self.route = getattr(self.replicas[0], "route", route)
        self.router = LeastWaitRouter(self.n_replicas, self.batch_size,
                                      seed=router_seed,
                                      straggler_factor=straggler_factor,
                                      quarantine_after=quarantine_after,
                                      probe_every=probe_every)

        self.stats = ServeStats()
        self.stats._first_n = self.batch_size
        # RLock: completion callbacks from N replica collector threads
        # mutate fleet stats + per-replica rows concurrently with
        # submitters and snapshot readers.
        self._lock = threading.RLock()
        self._done = threading.Condition(self._lock)
        # Serializes batch assembly + routing + replica enqueue for
        # multi-producer submit(), mirroring PipelineExecutor's order
        # lock (the holder may block on a full replica queue while the
        # completion path takes _lock).
        self._order_lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._results: dict[int, np.ndarray] = {}
        self._rows = [_fresh_row() for _ in range(self.n_replicas)]
        self._submitted = 0
        self._collected = 0
        self._error: BaseException | None = None
        self._closed = False
        self._t0: float | None = None
        self._first_t0: float | None = None

        for i, rep in enumerate(self.replicas):
            rep.on_result = self._replica_done
            if hasattr(rep, "on_error"):
                rep.on_error = self._replica_error

    @staticmethod
    def _build_replicas(program, replicas, mode, *, stages, batch_size,
                        route, output, queue_depth, devices):
        if devices is None:
            devices = (cuda_devices() if program.device.type == "cuda"
                       else [program.device])
        devs = list(devices)
        if mode == "pipeline":
            # Whole pipeline per device: replica r's stages all share
            # devices[r % D].
            slices = [[devs[r % len(devs)]] for r in range(replicas)]
        else:
            slices = device_slices(replicas, devs)
        built, built_devs = [], []
        for r in range(replicas):
            sl = slices[r]
            # stage-shard co-partition: as many stages as the replica
            # has devices (the DP balances the step chain over them);
            # pipeline mode keeps the requested stage count.
            n_stages = stages if mode == "pipeline" else max(1, len(sl))
            built.append(PipelineExecutor(
                program, stages=n_stages, batch_size=batch_size,
                route=route, output=output, queue_depth=queue_depth,
                devices=sl))
            built_devs.append([str(d) for d in sl])
        return built, built_devs

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for rep in self.replicas:
            s = getattr(rep, "start", None)
            if s is not None:
                s()

    def close(self) -> None:
        """Close every replica (each waits for its in-flight batches, so
        all pool callbacks have fired when this returns)."""
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            c = getattr(rep, "close", None)
            if c is not None:
                c()

    def __enter__(self) -> "ReplicaPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- intake --------------------------------------------------------------

    def submit(self, frame: np.ndarray) -> None:
        """Queue one float frame (or pre-batched chunk); routes a
        micro-batch whenever ``batch_size`` frames are buffered.
        Thread-safe."""
        if self.program is not None:
            frames = normalize_frames(self.program, frame)
        else:
            frames = [np.asarray(frame)]
        with self._order_lock:
            full: list[np.ndarray] = []
            with self._lock:
                for f in frames:
                    self._pending.append(f)
                    if len(self._pending) >= self.batch_size:
                        full.append(np.stack(self._pending[:self.batch_size]))
                        self._pending = self._pending[self.batch_size:]
            for batch in full:
                self.submit_batch(batch, len(batch))

    def submit_batch(self, frames: np.ndarray, n_valid: int,
                     tag: object = None) -> None:
        """Route one float micro-batch to the least-wait replica and
        dispatch it there. Blocks when that replica's stage-0 queue is
        full (per-replica backpressure). Thread-safe; results may
        complete out of submission order across replicas (drain reorders
        by sequence number)."""
        self._check_error()
        n_valid = int(n_valid)
        with self._order_lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            r = self.router.pick()
            now = time.perf_counter()
            with self._lock:
                if self._t0 is None:
                    self._t0 = now
                if self._first_t0 is None:
                    self._first_t0 = now
                seq = self._submitted
                self._submitted += 1
                self.stats.batches += 1
                self.stats.frames += n_valid
                self.stats.padded_frames += max(0, self.batch_size - n_valid)
                row = self._rows[r]
                row["dispatched_batches"] += 1
                row["dispatched_frames"] += n_valid
            disp = _Dispatch(seq=seq, replica=r, n_valid=n_valid,
                             t_disp=time.perf_counter(), tag=tag)
            try:
                self.replicas[r].submit_batch(frames, n_valid, tag=disp)
            except BaseException:
                # The batch never entered the replica: release the
                # router slot and account the failure so drain/close
                # cannot wait on a batch that will never complete.
                self.router.on_failure(r)
                with self._done:
                    self._collected += 1
                    row = self._rows[r]
                    row["failed_batches"] += 1
                    row["failed_frames"] += n_valid
                    self._done.notify_all()
                raise
            self._maybe_probe(frames)

    def _maybe_probe(self, frames: np.ndarray) -> None:
        """Dispatch one all-padding probe batch when the router asks for
        one (an excluded replica is due its health check). Probes ride
        the live submit beat but live outside it: they never count in
        ``_submitted``/``_collected`` or the outcome rows beyond their
        own ``probe_batches`` counter, so no live request is ever
        sacrificed to discover that a quarantined replica came back (or
        that a flagged straggler's EWMA re-entered band)."""
        p = self.router.probe_target()
        if p is None:
            return
        disp = _Dispatch(seq=-1, replica=p, n_valid=1,
                         t_disp=time.perf_counter(), tag=None, probe=True)
        with self._lock:
            self._rows[p]["probe_batches"] += 1
        try:
            # Fresh copy: the live replica may consume its input buffer,
            # and the probe replica must see intact frames. One
            # valid frame, so the probe observes a real traversal.
            self.replicas[p].submit_batch(np.array(frames, copy=True), 1,
                                          tag=disp)
        except BaseException:
            # A dead replica refuses the probe synchronously: feed the
            # router (quarantine persists) and move on — probes are
            # best-effort by construction.
            self.router.on_failure(p)

    def serve(self, frames: Iterable[np.ndarray]) -> list[np.ndarray]:
        """Convenience: submit a finite stream and drain."""
        for f in frames:
            self.submit(f)
        return self.drain()

    def warmup(self, frames: Iterable[np.ndarray]) -> None:
        """Run one drained pass through *every* replica directly (all
        R x K stages build and launch), bypassing the router so no replica is
        left cold. Follow with :meth:`reset_stats` for a hot measured
        window."""
        frames = list(frames)
        for rep in self.replicas:
            rep.serve(frames)

    def flush_inflight(self) -> None:
        """Protocol no-op: every replica's collector thread delivers
        results continuously."""

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until every dispatched micro-batch has cleared its
        replica — the fleet-side half of a drain->swap->resume handoff.
        Does not flush the partial tail or consume drain results; only
        waits. Returns ``True`` when idle, ``False`` on timeout. Raises
        if a replica failed on the untagged drain path."""
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

    def reset_stats(self) -> None:
        """Zero the fleet serve statistics and each replica's (between
        drains, not mid-stream). Per-replica dispatch rows and router
        counters are pool-lifetime and survive — scoped accounting
        deltas :meth:`replica_counts` (the frontend does)."""
        with self._lock:
            if self._collected < self._submitted or self._pending:
                raise RuntimeError("reset_stats with work in flight")
            self.stats = ServeStats()
            self._t0 = None
        for rep in self.replicas:
            rs = getattr(rep, "reset_stats", None)
            if rs is not None:
                rs()

    # -- drain ---------------------------------------------------------------

    def drain(self) -> list[np.ndarray]:
        """Flush the partial tail, wait for every in-flight micro-batch
        to clear its replica, and return per-frame outputs of untagged
        batches in submission order (results are re-ordered by sequence
        number — replicas finish out of order by design)."""
        with self._lock:
            tail = self._pending
            self._pending = []
        if tail:
            self.submit_batch(np.stack(tail), len(tail))
        with self._done:
            while self._collected < self._submitted and self._error is None:
                self._done.wait(timeout=0.1)
        self._check_error()
        with self._lock:
            if self._t0 is not None:
                self.stats.wall_s += time.perf_counter() - self._t0
                self._t0 = None
            results = self._results
            self._results = {}
        if not results:
            return []
        flat = np.concatenate([results[s] for s in sorted(results)], axis=0)
        return list(flat)

    # -- completion (replica collector threads) ------------------------------

    def _replica_done(self, disp: _Dispatch, outputs) -> None:
        now = time.perf_counter()
        self.router.on_complete(disp.replica, now - disp.t_disp, now=now)
        if disp.probe:
            # Probe success = proof of life; on_complete above already
            # re-admitted the replica / fed its EWMA. Nothing to count.
            return
        with self._done:
            if self._collected == 0 and self._first_t0 is not None:
                self.stats.first_batch_s = now - self._first_t0
            self._collected += 1
            row = self._rows[disp.replica]
            row["completed_batches"] += 1
            row["completed_frames"] += disp.n_valid
            if disp.tag is None:
                self._results[disp.seq] = outputs
            self._done.notify_all()
            cb = self.on_result
        if disp.tag is not None and cb is not None:
            cb(disp.tag, outputs)

    def _replica_error(self, disp: _Dispatch, exc: BaseException) -> None:
        self.router.on_failure(disp.replica)
        if disp.probe:
            # Failed probe: quarantine persists, no live batch was lost.
            return
        with self._done:
            self._collected += 1
            row = self._rows[disp.replica]
            row["failed_batches"] += 1
            row["failed_frames"] += disp.n_valid
            if disp.tag is None and self._error is None:
                self._error = exc
            self._done.notify_all()
            cb = self.on_error
        if disp.tag is not None and cb is not None:
            cb(disp.tag, exc)

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                "replica pipeline failed; no further batches can be "
                "served") from self._error

    # -- reporting -----------------------------------------------------------

    def replica_counts(self) -> list[dict]:
        """Exact per-replica outcome counters (pool lifetime):
        dispatched/completed/failed batches and frames. Snapshot is
        atomic — taken under the fleet lock — so
        ``sum(completed_frames) == fleet completed frames`` holds at any
        quiescent point."""
        with self._lock:
            return [dict(row) for row in self._rows]

    @property
    def batches_run(self) -> int:
        """Micro-batches the replicas ran over the pool's life, probes and
        the direct warmup passes included."""
        return sum(getattr(rep, "batches_run", 0) for rep in self.replicas)

    def replica_rows(self) -> list[dict]:
        """JSON-ready per-replica rows: outcome counters + device
        placement + router view (picks, in-flight, straggler/quarantine
        flags, estimator channels)."""
        counts = self.replica_counts()
        snap = self.router.snapshot()["replicas"]
        rows = []
        for r in range(self.n_replicas):
            rows.append({"replica": r, "devices": self.replica_devices[r],
                         **counts[r],
                         "picks": snap[r]["picks"],
                         "inflight": snap[r]["inflight"],
                         "straggler": snap[r]["straggler"],
                         "quarantined": snap[r]["quarantined"],
                         "estimator": snap[r]["estimator"]})
        return rows
