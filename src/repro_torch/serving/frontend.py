"""Async request frontend: tenant+priority lanes, deadlines, batcher.
PyTorch twin of ``repro/serving/frontend.py`` (pure Python: a copy with the
port's imports).

Non-synthetic traffic arrives one frame at a time, at arbitrary rates,
and not all of it is equal: an interactive frame wants an answer inside
its deadline, a bulk re-index frame only wants an answer eventually —
and in a multi-model deployment the frames belong to different
*tenants* (compiled models) that must not starve each other. The
engines underneath want fixed-shape micro-batches. The frontend bridges
the two (the QoS analogue of the FPGA's stream arbitration in front of
the engine pipeline):

* :meth:`AsyncFrontend.submit` enqueues a request into a *bounded
  per-``(tenant, priority)`` lane* and returns a :class:`ServedRequest`
  handle immediately. Requests carry ``(tenant, priority,
  deadline_ms)``; a full lane blocks the caller (backpressure — the
  same stall a full activation buffer exerts on the paper's producer
  engine) or raises :class:`queue.Full` when ``timeout`` expires.
  Per-lane bounds mean a flood in one class — or one tenant — cannot
  exhaust another's admission capacity.
* a batcher thread assembles micro-batches dynamically. Across tenants
  it sweeps *weighted round-robin* (``tenant_shares``, default equal):
  each time a new batch opens, every tenant with queued work earns
  credit proportional to its share and the highest-credit tenant wins —
  so a flooding tenant gets its share of batch slots, never all of
  them. Within the winning tenant, lanes drain highest-priority first,
  exactly the single-tenant discipline. A batch is *single-tenant*
  (different models take different frame shapes): it is flushed when it
  reaches ``batch_size`` frames, when the oldest member has waited
  ``max_wait_ms``, **or** when holding it any longer would push a
  member past its deadline (the expedited flush). The expedited flush
  fires ``est_service + guard`` before the tightest member deadline,
  where ``est_service`` is an online per-tenant EWMA of measured
  compute phases (:class:`~repro_torch.serving.estimator
  .ServiceTimeEstimator`, fed from each batch's
  ``t_dispatched -> t_done``); with no estimate yet it falls back to
  the static 20%-of-budget guard (``DEADLINE_GUARD_FRAC``), so the
  frontend keeps its static behaviour until it has measurements.
* a request whose deadline passes while it is still queued or assembling
  is *dropped*, resolving with an ``expired`` outcome (``result()``
  raises :class:`DeadlineExpired`) instead of wasting a batch slot —
  the software form of a frame-rate bound: a frame that missed its
  display slot is not worth computing.
* with ``admission_control=True``, a deadline-armed request whose
  deadline budget is already smaller than the estimated wait for the
  queued work ahead of it (frames in *its own tenant's* lanes at its
  priority or higher plus its tenant's in-flight micro-batches, priced
  by that tenant's estimator channels) is refused at submit with the
  ``rejected_wait`` outcome — hopeless requests fail fast instead of
  expiring in queue. Pricing only own-tenant work is the admission half
  of isolation: another tenant's flood never inflates this tenant's
  estimated wait.
* every request records four timestamps — ``t_submit`` (enters its
  lane), ``t_batched`` (popped into an assembling batch),
  ``t_dispatched`` (micro-batch handed to the executor), ``t_done``
  (resolved) — so :class:`FrontendStats` can split latency into
  queueing / assembly / compute percentiles *per traffic class* (and
  roll outcomes up *per tenant*), not just end to end.

The executor must conform to the :class:`repro_torch.serving.Executor`
protocol — :class:`~repro_torch.serving.pipeline_executor.PipelineExecutor`
(K-stage pipeline), :class:`~repro_torch.serving.replica_pool.ReplicaPool`
(R routed replicas), the thread-safe single-chain
:class:`~repro_torch.core.executor.EngineExecutor`, or the per-tenant
:class:`~repro_torch.serving.server.TenantMux`; non-conforming objects are
refused with a TypeError naming the missing members.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import math
import queue
import threading
import time

import numpy as np

from repro_torch.core.spans import span
from repro_torch.serving.estimator import ServiceTimeEstimator, window_key

DEFAULT_CLASS = "default"
DEFAULT_TENANT = "default"

# Outcomes a ServedRequest can resolve with.
PENDING = "pending"
COMPLETED = "completed"
FAILED = "failed"
EXPIRED = "expired"      # deadline passed while queued/assembling; dropped
REJECTED = "rejected"    # refused at admission (full lane, block=False)
REJECTED_WAIT = "rejected_wait"  # refused: estimated wait exceeds deadline


# Fallback expedited-flush rule, used only until the service-time
# estimator has a measurement: fire when this fraction of a request's
# deadline budget is still left — flushing *at* the deadline would
# dispatch a batch whose deadline-armed members are already dead on
# arrival.
DEADLINE_GUARD_FRAC = 0.2


def tenant_key(tenant: str, shape):
    """The estimator key for ``shape`` scoped to ``tenant``. The default
    tenant keeps the bare shape key, so a single-tenant frontend's
    estimator channels (and everything warm-starting them) are bit-for-
    bit the pre-multi-tenant ones."""
    return shape if tenant == DEFAULT_TENANT else (tenant, shape)


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it reached the executor."""


class RequestRejected(RuntimeError):
    """The request was refused at admission — lane full (non-blocking
    submit) or estimated wait already past its deadline budget."""


class ServedRequest:
    """Handle for one in-flight frame.

    ``result()`` blocks until the pipeline answers, re-raising the
    serving error if its batch failed, :class:`DeadlineExpired` if the
    request was dropped on an SLO miss, or :class:`RequestRejected` if
    it was refused at admission. The four timestamps
    ``t_submit -> t_batched -> t_dispatched -> t_done`` chart its path
    through lane, batcher, and executor; ``phase_s()`` returns the
    split."""

    __slots__ = ("priority", "deadline_s", "klass", "tenant",
                 "t_submit", "t_batched", "t_dispatched", "t_done",
                 "_value", "_error", "_outcome", "_event")

    def __init__(self, priority: int = 0, deadline_ms: float | None = None,
                 klass: str | None = None, tenant: str = DEFAULT_TENANT):
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.klass = klass if klass is not None else (
            DEFAULT_CLASS if priority == 0 and deadline_ms is None
            else f"p{priority}")
        self.t_submit = time.perf_counter()
        # Absolute wall deadline; None = best-effort (never expires).
        self.deadline_s = (None if deadline_ms is None
                           else self.t_submit + float(deadline_ms) / 1e3)
        self.t_batched: float | None = None
        self.t_dispatched: float | None = None
        self.t_done: float | None = None
        self._value: np.ndarray | None = None
        self._error: BaseException | None = None
        self._outcome = PENDING
        self._event = threading.Event()

    # -- resolution (frontend-internal) --------------------------------------

    def _resolve(self, value) -> None:
        self._value = value
        self._outcome = COMPLETED
        self.t_done = time.perf_counter()
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._outcome = FAILED
        self.t_done = time.perf_counter()
        self._event.set()

    def _expire(self) -> None:
        self._outcome = EXPIRED
        self.t_done = time.perf_counter()
        self._event.set()

    def _reject(self, outcome: str = REJECTED) -> None:
        self._outcome = outcome
        self.t_done = time.perf_counter()
        self._event.set()

    # -- client side ---------------------------------------------------------

    @property
    def outcome(self) -> str:
        """'pending' | 'completed' | 'failed' | 'expired' | 'rejected'
        | 'rejected_wait'."""
        return self._outcome

    def done(self) -> bool:
        return self._event.is_set()

    def expired(self) -> bool:
        return self._outcome == EXPIRED

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._outcome == EXPIRED:
            raise DeadlineExpired(
                f"request dropped: deadline passed after "
                f"{(self.t_done - self.t_submit) * 1e3:.1f}ms in queue")
        if self._outcome == REJECTED_WAIT:
            raise RequestRejected(
                "request refused at admission: estimated wait for the "
                "queued work ahead already exceeds the deadline budget")
        if self._outcome == REJECTED:
            raise RequestRejected("request refused at admission "
                                  "(lane full)")
        if self._error is not None:
            raise RuntimeError("request failed in the serving "
                               "pipeline") from self._error
        return self._value

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def missed_deadline(self) -> bool:
        """True when the request did not complete inside its deadline —
        dropped (expired), refused for a hopeless wait, or completed
        late."""
        if self.deadline_s is None or self.t_done is None:
            return False
        return (self._outcome in (EXPIRED, REJECTED_WAIT)
                or self.t_done > self.deadline_s)

    def phase_s(self) -> dict[str, float | None]:
        """The latency split the four timestamps define: ``queueing``
        (lane wait), ``assembly`` (in a forming batch), ``compute``
        (executor dispatch -> result). Phases a dropped request never
        reached are None."""
        q = (None if self.t_batched is None
             else self.t_batched - self.t_submit)
        a = (None if self.t_dispatched is None or self.t_batched is None
             else self.t_dispatched - self.t_batched)
        c = (None if self.t_done is None or self.t_dispatched is None
             else self.t_done - self.t_dispatched)
        return {"queueing": q, "assembly": a, "compute": c}


def _percentiles(samples: list) -> dict[str, float]:
    if not samples:
        nan = float("nan")
        return {"p50": nan, "p95": nan, "p99": nan, "mean": nan}
    arr = np.asarray(samples)
    p50, p95, p99 = np.percentile(arr, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(arr.mean())}


@dataclasses.dataclass
class ClassStats:
    """Per-traffic-class accounting: outcome counts and the phase-split
    latency samples of completed requests. Reused per *tenant* for the
    ``FrontendStats.tenants`` rollup (a tenant is just a coarser
    grouping over the same outcomes)."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    expired: int = 0        # dropped on deadline while queued/assembling
    rejected: int = 0       # refused at admission (full lane)
    rejected_wait: int = 0  # refused: estimated wait > deadline budget
    late: int = 0           # completed, but after the deadline
    armed: bool = False     # any submission of this class carried a deadline
    queueing_s: list = dataclasses.field(default_factory=list)
    assembly_s: list = dataclasses.field(default_factory=list)
    compute_s: list = dataclasses.field(default_factory=list)
    total_s: list = dataclasses.field(default_factory=list)

    @property
    def resolved(self) -> int:
        return (self.completed + self.failed + self.expired
                + self.rejected + self.rejected_wait)

    @property
    def drop_rate(self) -> float:
        """Fraction of submissions dropped/refused without compute."""
        if self.submitted == 0:
            return 0.0
        return (self.expired + self.rejected
                + self.rejected_wait) / self.submitted

    @property
    def slo_miss_rate(self) -> float:
        """Fraction of submissions that missed their deadline — dropped,
        refused at admission, or completed late. 0.0 for a class that
        never armed a deadline (best-effort requests have no SLO to
        miss; their admission rejections count only in drop_rate)."""
        if self.submitted == 0 or not self.armed:
            return 0.0
        return (self.expired + self.rejected + self.rejected_wait
                + self.late) / self.submitted

    def phase_percentiles(self) -> dict[str, dict[str, float]]:
        """{'queueing'|'assembly'|'compute'|'total': {p50,p95,p99,mean}}
        in seconds, over *completed* requests (a dropped request never
        reached the later phases, so it would skew them)."""
        return {"queueing": _percentiles(self.queueing_s),
                "assembly": _percentiles(self.assembly_s),
                "compute": _percentiles(self.compute_s),
                "total": _percentiles(self.total_s)}


@dataclasses.dataclass
class FrontendStats:
    """Per-request accounting over one frontend lifetime: totals, a
    per-traffic-class breakdown (``classes``), a per-tenant rollup
    (``tenants`` — same :class:`ClassStats` shape, keyed by tenant, so a
    multi-model server reads each model's outcomes without re-deriving
    them from class names), and — when the executor is a
    :class:`~repro_torch.serving.replica_pool.ReplicaPool` — a per-replica
    outcome breakdown (``replicas``, filled at :meth:`AsyncFrontend
    .close` as the delta of the pool's lifetime counters over this
    frontend's window, so fleet totals reconcile exactly with the sum of
    the per-replica rows)."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0              # requests resolved with an error
    expired: int = 0             # dropped on deadline (SLO miss)
    rejected: int = 0            # refused at admission (full lane)
    rejected_wait: int = 0       # refused: estimated wait > deadline budget
    batches: int = 0
    flushes_full: int = 0        # batches flushed at batch_size
    flushes_timeout: int = 0     # batches flushed by max_wait_ms
    flushes_deadline: int = 0    # batches expedited by a member deadline
    latencies_s: list = dataclasses.field(default_factory=list)
    classes: dict = dataclasses.field(default_factory=dict)
    tenants: dict = dataclasses.field(default_factory=dict)
    replicas: dict = dataclasses.field(default_factory=dict)
    _t_first: float | None = None
    _t_last: float | None = None

    @property
    def resolved(self) -> int:
        """Requests that reached *any* terminal outcome; close() waits
        for this to reconcile exactly with ``submitted``."""
        return (self.completed + self.failed + self.expired
                + self.rejected + self.rejected_wait)

    @property
    def hung(self) -> int:
        """Submitted requests with no terminal outcome yet — the
        liveness headline the chaos artifacts gate at zero (after
        close(), every fault path must have resolved its requests)."""
        return self.submitted - self.resolved

    def klass(self, name: str) -> ClassStats:
        cs = self.classes.get(name)
        if cs is None:
            cs = self.classes[name] = ClassStats()
        return cs

    def tenant_row(self, name: str) -> ClassStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = ClassStats()
        return ts

    def latency_percentiles(self) -> dict[str, float]:
        """{'p50','p95','p99','mean'} end-to-end request latency in
        seconds over all classes (NaN when nothing completed yet)."""
        return _percentiles(self.latencies_s)

    def phase_percentiles(self) -> dict[str, dict[str, dict[str, float]]]:
        """Per-class phase split: {class: {queueing|assembly|compute|
        total: {p50,p95,p99,mean}}} in seconds."""
        return {name: cs.phase_percentiles()
                for name, cs in sorted(self.classes.items())}

    @property
    def fps(self) -> float:
        """Completed requests per second over the first-submit ->
        last-result window (includes compile/fill — the client-observed
        rate, unlike the executor's steady_fps)."""
        if self._t_first is None or self._t_last is None:
            return 0.0
        dt = self._t_last - self._t_first
        return self.completed / dt if dt > 0 else 0.0


def _require_executor(executor) -> None:
    """Protocol gate: refuse any executor that does not offer the whole
    :class:`repro_torch.serving.Executor` surface, naming what is missing.
    (Imported lazily — the package __init__ imports this module.)"""
    from repro_torch.serving import EXECUTOR_MEMBERS, Executor
    if isinstance(executor, Executor):
        return
    missing = sorted(m for m in EXECUTOR_MEMBERS if not hasattr(executor, m))
    raise TypeError(
        f"{type(executor).__name__} does not conform to the "
        f"repro_torch.serving.Executor protocol (missing: {', '.join(missing)})")


class AsyncFrontend:
    """Dynamic-batching QoS frontend over a serving executor.

    >>> with PipelineExecutor(prog, stages=2, batch_size=8) as px:
    ...     fe = AsyncFrontend(px, max_wait_ms=5.0)
    ...     hi = fe.submit(frame, priority=1, deadline_ms=50.0)
    ...     lo = fe.submit(frame)                   # best-effort
    ...     out = hi.result()
    ...     fe.close()

    ``priority`` orders lanes within a tenant (higher drains first);
    ``deadline_ms`` arms drop-on-SLO-miss and the expedited flush;
    ``tenant`` names the model a request belongs to in a multi-model
    deployment. All default to a single best-effort FIFO class of one
    tenant.

    ``estimator`` is the shared :class:`ServiceTimeEstimator` driving
    the expedited flush (and admission), with channels keyed per tenant
    (:func:`tenant_key` — the default tenant keeps the bare keys); one
    is created per frontend if not given, self-warming from observed
    batches. The serve paths warm it from the calibration pass
    (``batch / measured_steady_fps``). ``admission_control=True``
    enables estimated-wait admission: a deadline-armed request is
    refused (``rejected_wait``) when the estimator prices the queued
    work ahead of it — own-tenant work only — past its deadline budget.
    ``flush_guard_ms`` is the safety margin the expedited flush (and
    admission) keeps against the estimate; ``None`` adapts it to 25% of
    the estimate + 2 ms. ``tenant_shares`` weights the round-robin
    batcher sweep across tenants (default: equal shares; tenants absent
    from the mapping get 1.0). Deadline-less requests are untouched by
    the estimator knobs — the plain best-effort path is unchanged.

    :meth:`swap_executor` repoints a live frontend onto a freshly
    calibrated executor between micro-batches — the elastic runtime's
    drain-swap-resume (see :mod:`repro_torch.serving.elastic`): dispatch
    pauses, submits keep landing in lanes, in-flight batches deliver
    on the old executor, then dispatch resumes on the new one. No
    request is rejected, dropped, or reordered by a swap.
    """

    def __init__(self, executor, *, max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 estimator: ServiceTimeEstimator | None = None,
                 admission_control: bool = False,
                 flush_guard_ms: float | None = None,
                 tenant_shares: dict[str, float] | None = None):
        _require_executor(executor)
        if executor.on_result is not None:
            raise ValueError("executor already has an on_result consumer")
        self.executor = executor
        self.batch_size = int(executor.batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = max(1, int(max_queue))
        self.estimator = (estimator if estimator is not None
                          else ServiceTimeEstimator())
        self.admission_control = bool(admission_control)
        self.flush_guard_s = (None if flush_guard_ms is None
                              else float(flush_guard_ms) / 1e3)
        # Weighted round-robin state for the cross-tenant batcher sweep
        # (guarded by _lane_cv, like the lanes it arbitrates).
        self.tenant_shares = dict(tenant_shares or {})
        self._credit: dict[str, float] = {}
        # Micro-batches dispatched but not yet resolved, and frames the
        # batcher has popped into its currently-assembling batch (both
        # guarded by _lock); work in either place is ahead of a new
        # request but visible in neither the lanes nor the executor, so
        # admission must price it explicitly. Tracked per tenant: a
        # request only waits behind its own tenant's work (cross-tenant
        # capacity is governed by the round-robin shares, not priced
        # into admission).
        self._inflight_batches = 0
        self._inflight: dict[str, int] = {}
        self._assembling = 0
        self._assembling_tenant: str | None = None
        # Second estimator channel per tenant: the *completion window*
        # (gap between consecutive batch completions while another of
        # the tenant's batches was still in flight) — the executor's
        # throughput beat, which is what a backlog drains at. Distinct
        # from the latency key because a K-stage pipeline's traversal
        # latency is ~K windows.
        self._window_key = window_key(self.batch_size)
        self._last_done: dict[str, float | None] = {}
        self.stats = FrontendStats()
        self._closing = threading.Event()
        self._lock = threading.Lock()
        # Drain->swap->resume support: the batcher parks assembled
        # batches at this gate while cleared (pause_dispatch), so a live
        # executor swap happens strictly *between* micro-batches.
        # _dispatching marks the window between passing the gate and
        # the in-flight increment (both flipped under _lock), so the
        # swap's quiescence check can never race a batch into the old
        # executor.
        self._dispatch_gate = threading.Event()
        self._dispatch_gate.set()
        self._dispatching = False
        # Lane state: (tenant, priority) -> FIFO deque of (req, frame).
        # _lane_cv guards lanes + per-lane counts; submit() waits on it
        # when its lane is full (backpressure), the batcher waits on it
        # for work. Separate from _lock (stats): a producer blocked on a
        # full lane must not stop the collector thread from recording
        # completions.
        self._lane_cv = threading.Condition()
        self._lanes: dict[tuple[str, int], collections.deque] = {}
        # Replica-pool executors expose exact per-replica outcome
        # counters; baseline them here so close() can report the delta
        # scoped to this frontend's lifetime (the pool's counters span
        # warmup and earlier frontends).
        self._replica_base = executor.replica_counts()
        self._owner = id(self)      # of the batcher's spans
        executor.on_result = self._on_result
        # Pipelined executors report stage failures asynchronously; the
        # single-chain executor raises from submit_batch instead (handled
        # in _dispatch) and simply never calls the slot.
        executor.on_error = self._on_error
        self._batcher = threading.Thread(target=self._run,
                                         name="frontend-batcher", daemon=True)
        self._batcher.start()

    def _lat_key(self, tenant: str):
        return tenant_key(tenant, self.batch_size)

    def _win_key(self, tenant: str):
        return window_key(tenant_key(tenant, self.batch_size))

    # -- client side ---------------------------------------------------------

    def submit(self, frame: np.ndarray, *, priority: int = 0,
               deadline_ms: float | None = None, klass: str | None = None,
               tenant: str = DEFAULT_TENANT,
               timeout: float | None = None,
               block: bool = True) -> ServedRequest:
        """Enqueue one float frame ``[H, W, C]`` into the ``(tenant,
        priority)`` lane. ``deadline_ms`` (from now) arms
        drop-on-SLO-miss; ``klass`` labels the request's traffic class
        for the stats breakdown (default: 'default' for plain requests,
        'p<priority>' otherwise); ``tenant`` routes it to the named
        model behind a multi-tenant executor.

        Blocks while the lane is full (backpressure); raises
        ``queue.Full`` when ``timeout`` (seconds) expires first. With
        ``block=False`` a full lane instead returns a request already
        resolved with the ``rejected`` outcome — load-shedding without
        stalling the caller. Raises ``ValueError`` on a frame the
        compiled program cannot take and ``RuntimeError`` after
        :meth:`close`."""
        if self._closing.is_set():
            raise RuntimeError("frontend is closed")
        req_frame = np.asarray(frame)
        # Reject malformed frames at the client, not inside the batcher
        # thread where one bad frame would poison a whole micro-batch.
        # (program is None behind a multi-tenant mux — the Server
        # validates against the tenant's own program before submitting.)
        prog = self.executor.program
        if prog is not None:
            hw = prog.model.input_hw
            want = (hw, hw, prog.model.input_ch)
            if req_frame.shape != want:
                raise ValueError(f"frame shape {req_frame.shape} does not "
                                 f"match the compiled program {want}")
        req = ServedRequest(priority=priority, deadline_ms=deadline_ms,
                            klass=klass, tenant=tenant)
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lane_cv:
            if self._closing.is_set():
                raise RuntimeError("frontend is closed")
            # Estimated-wait admission: a deadline-armed request whose
            # budget the queued work ahead already exhausts fails fast
            # (rejected_wait) instead of expiring in queue. Checked
            # before the capacity wait — blocking on a full lane only
            # to expire afterwards would be the worst of both.
            if self._hopeless(req):
                self._reject_wait(req)
                return req
            key = (req.tenant, req.priority)
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = collections.deque()
            wait_blocked = False
            while len(lane) >= self.max_queue:
                if not block:
                    self._admit(req)
                    req._reject()
                    with self._lock:
                        self.stats.rejected += 1
                        self.stats.klass(req.klass).rejected += 1
                        self.stats.tenant_row(req.tenant).rejected += 1
                    return req
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise queue.Full
                wait_blocked = True
                if not self._lane_cv.wait(timeout=remaining):
                    raise queue.Full
                if self._closing.is_set():
                    raise RuntimeError("frontend is closed")
            # Re-price after any backpressure wait: the verdict from
            # before the block is stale — the deadline budget shrank
            # and other producers refilled the queues — and enqueueing
            # on it would let an admitted request expire in queue.
            if wait_blocked and self._hopeless(req):
                self._reject_wait(req)
                return req
            self._admit(req)
            lane.append((req, req_frame))
            self._lane_cv.notify_all()
        return req

    def _admit(self, req: ServedRequest) -> None:
        with self._lock:
            self.stats.submitted += 1
            cs = self.stats.klass(req.klass)
            cs.submitted += 1
            ts = self.stats.tenant_row(req.tenant)
            ts.submitted += 1
            if req.deadline_s is not None:
                cs.armed = True
                ts.armed = True
            if self.stats._t_first is None:
                self.stats._t_first = req.t_submit

    # -- adaptive control (estimator-driven) ---------------------------------

    def _guard_s(self, est: float) -> float:
        """Safety margin kept against the service-time estimate: covers
        batcher poll cadence, host stacking/quantize, and estimator
        noise. Fixed when the caller pinned ``flush_guard_ms``, else
        25% of the estimate + 2 ms."""
        if self.flush_guard_s is not None:
            return self.flush_guard_s
        return 0.25 * est + 0.002

    def _urgent_at(self, req: ServedRequest) -> float:
        """The instant the batcher must flush a batch holding ``req``
        (inf for best-effort requests): ``est_service + guard`` before
        the deadline once the estimator has a measurement for the
        request's tenant, else the static fallback of 80% of the
        deadline budget spent."""
        if req.deadline_s is None:
            return float("inf")
        est = self.estimator.estimate(self._lat_key(req.tenant))
        if est is None:
            return req.deadline_s - DEADLINE_GUARD_FRAC * (req.deadline_s
                                                           - req.t_submit)
        return req.deadline_s - (est + self._guard_s(est))

    def estimated_wait_s(self, priority: int,
                         tenant: str = DEFAULT_TENANT) -> float | None:
        """Estimated completion time (seconds from now) of a request
        entering the ``(tenant, priority)`` lane now:
        ``(backlog_batches - 1) * est_window + est_latency`` over the
        tenant's *own* work — frames in its lanes at this priority or
        higher, its assembling batch, its in-flight micro-batches. The
        backlog drains one batch per *completion window* (EWMA of busy
        inter-completion gaps; a pipelined executor overlaps in-flight
        batches, so pricing them serially at full latency would refuse
        servable requests), then the request's own batch traverses the
        pipeline in ``est_latency`` (EWMA of measured dispatch->done
        phases). For a serial executor window == latency and this
        reduces to pricing every batch at full service time; until a
        window gap has been observed the latency estimate stands in for
        the window. Other tenants' backlogs are deliberately not priced:
        the round-robin sweep guarantees this tenant its share of batch
        slots regardless of their floods (any cross-tenant slowdown
        shows up in this tenant's own observed window instead). ``None``
        until the estimator knows nothing for the tenant. Caller holds
        ``_lane_cv`` (or accepts a racy read)."""
        lat = self.estimator.estimate(self._lat_key(tenant))
        if lat is None:
            return None
        win = self.estimator.estimate(self._win_key(tenant))
        if win is None:
            win = lat
        ahead = sum(len(lane) for (t, prio), lane in self._lanes.items()
                    if t == tenant and prio >= priority)
        with self._lock:
            inflight = self._inflight.get(tenant, 0)
            # The tenant's currently-assembling batch dispatches ahead
            # of any of its lane content regardless of priority.
            if self._assembling_tenant == tenant:
                ahead += self._assembling
        batches = inflight + math.ceil((ahead + 1) / self.batch_size)
        return (batches - 1) * win + lat

    def _hopeless(self, req: ServedRequest) -> bool:
        """True when admission control applies to ``req`` and the
        estimated wait for the work ahead of it already exceeds its
        deadline budget (caller holds _lane_cv)."""
        if not self.admission_control or req.deadline_s is None:
            return False
        wait = self.estimated_wait_s(req.priority, req.tenant)
        if wait is None:
            return False
        est = self.estimator.estimate(self._lat_key(req.tenant))
        budget = req.deadline_s - time.perf_counter()
        return wait + self._guard_s(est) > budget

    def _reject_wait(self, req: ServedRequest) -> None:
        """Resolve ``req`` refused-for-hopeless-wait, with stats."""
        self._admit(req)
        req._reject(REJECTED_WAIT)
        with self._lock:
            self.stats.rejected_wait += 1
            self.stats.klass(req.klass).rejected_wait += 1
            self.stats.tenant_row(req.tenant).rejected_wait += 1

    def control_config(self) -> dict:
        """The adaptive-control knobs as a JSON-ready dict — benches
        record it so knee and QoS artifacts are comparable across PRs.
        The headline estimates are the default tenant's channels (the
        single-model case); the full per-tenant channel map is in
        ``estimator``."""
        est = self.estimator.estimate(self.batch_size)
        win = self.estimator.estimate(self._window_key)
        return {
            "admission_control": self.admission_control,
            "flush_guard_ms": (None if self.flush_guard_s is None
                               else round(self.flush_guard_s * 1e3, 3)),
            "deadline_guard_frac_fallback": DEADLINE_GUARD_FRAC,
            "est_service_ms": (None if est is None
                               else round(est * 1e3, 3)),
            "est_window_ms": (None if win is None
                              else round(win * 1e3, 3)),
            "tenant_shares": dict(self.tenant_shares) or None,
            "estimator": self.estimator.snapshot(),
        }

    def stats_snapshot(self) -> FrontendStats:
        """A consistent deep copy of :attr:`stats`, taken atomically
        under the stats lock. With a replica pool underneath, N
        collector threads mutate the live ``stats`` concurrently
        (counters, latency lists, class dicts); reading it field by
        field mid-flight can tear — e.g. ``resolved > submitted`` or a
        latency list longer than ``completed``. Monitoring loops and the
        stress lane read through this instead."""
        with self._lock:
            return copy.deepcopy(self.stats)

    # -- drain -> swap -> resume (elastic rescale) ---------------------------

    def pause_dispatch(self) -> None:
        """Hold every assembled micro-batch at the dispatch boundary.

        Submits keep landing in the lanes (backpressure only when a lane
        fills — nothing is rejected), the batcher keeps assembling, but
        no new micro-batch enters the executor until
        :meth:`resume_dispatch`. A closing frontend overrides the gate
        so :meth:`close` always converges."""
        self._dispatch_gate.clear()

    def resume_dispatch(self) -> None:
        """Reopen the dispatch gate after :meth:`pause_dispatch`."""
        self._dispatch_gate.set()

    def _quiescent(self) -> bool:
        """True when no micro-batch is in flight *and* the batcher is
        not mid-dispatch (between passing the gate and the in-flight
        increment). Only meaningful while dispatch is paused."""
        with self._lock:
            return self._inflight_batches == 0 and not self._dispatching

    def _merge_replica_delta(self) -> None:
        """Fold the current executor's per-replica outcome delta since
        the last baseline into ``stats.replicas`` (no-op for executors
        without replica counters). Rows merge by replica index across
        executor generations, so the sum over rows keeps reconciling
        with fleet totals after a swap. Caller ensures the executor is
        quiescent for this frontend's traffic."""
        if self._replica_base is None:
            return
        rows = self.executor.replica_counts()
        with self._lock:
            for r, base in enumerate(self._replica_base):
                delta = {k: rows[r][k] - base[k] for k in base}
                cur = self.stats.replicas.get(str(r))
                if cur is None:
                    self.stats.replicas[str(r)] = delta
                else:
                    for k, v in delta.items():
                        cur[k] = cur.get(k, 0) + v

    def swap_executor(self, new_executor, *,
                      drain_timeout_s: float = 60.0):
        """Atomically replace the executor underneath this frontend.

        The drain->swap->resume sequence behind a live rescale
        (``Server.rescale`` / the elastic controller): pause dispatch at
        the micro-batch boundary, wait until every dispatched batch has
        resolved on the old executor (int8 stage boundaries carry no
        cross-batch state, so a drained executor holds nothing), move
        the ``on_result``/``on_error`` slots and the replica-counter
        baseline over, then reopen the gate. Submits are never rejected
        — requests arriving during the drain queue in their lanes and
        dispatch to the new executor in submission order, so no request
        is dropped or reordered. Returns the old executor (drained;
        caller closes it). Raises ``TimeoutError`` if the old executor
        does not drain within ``drain_timeout_s`` (the gate reopens and
        the frontend continues on the old executor)."""
        _require_executor(new_executor)
        if new_executor is self.executor:
            raise ValueError("swap_executor with the executor already "
                             "installed")
        if new_executor.on_result is not None:
            raise ValueError("executor already has an on_result consumer")
        if self._closing.is_set():
            raise RuntimeError("frontend is closed")
        self.pause_dispatch()
        try:
            deadline = time.perf_counter() + float(drain_timeout_s)
            while not self._quiescent():
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        "executor did not drain within "
                        f"{drain_timeout_s:.1f}s; swap aborted")
                # Single-chain executors deliver on flush, not from a
                # collector thread — keep flushing while we wait.
                self.executor.flush_inflight()
                time.sleep(0.001)
            old = self.executor
            self._merge_replica_delta()
            old.on_result = None
            old.on_error = None
            new_executor.on_result = self._on_result
            new_executor.on_error = self._on_error
            self._replica_base = new_executor.replica_counts()
            with self._lock:
                self.executor = new_executor
                self.batch_size = int(new_executor.batch_size)
                self._window_key = window_key(self.batch_size)
                # The inter-completion beat spans two topologies at the
                # swap point; never observe a window across it.
                self._last_done.clear()
            return old
        finally:
            self.resume_dispatch()

    def close(self) -> None:
        """Stop accepting requests, flush everything queued, and wait for
        every in-flight request to resolve (completed, failed, expired,
        or rejected — nothing may hang)."""
        with self._lane_cv:
            if self._closing.is_set():
                return
            self._closing.set()
            self._lane_cv.notify_all()   # wake producers blocked on a lane
        self._batcher.join()
        # The batcher exits only after its final drain saw every lane
        # empty under _lane_cv, and submit() refuses new requests once
        # _closing is set — so nothing can be left queued here. Collect
        # trailing micro-batches (PipelineExecutor's collector runs
        # continuously, the single-chain EngineExecutor collects on
        # flush — both sides of the protocol's flush_inflight contract).
        self.executor.flush_inflight()
        deadline = time.perf_counter() + 60.0
        while True:
            with self._lock:
                if self.stats.resolved >= self.stats.submitted:
                    break
            if time.perf_counter() > deadline:
                raise TimeoutError("in-flight requests did not complete")
            time.sleep(0.001)
        # Every request has resolved, so the pool's counters are
        # quiescent for this frontend's traffic: fold in the per-replica
        # outcome delta over our lifetime (exact fleet reconciliation —
        # added to any deltas already merged at executor swaps).
        self._merge_replica_delta()
        # Release the executor for a future frontend (it is documented
        # as reusable across drains) and drop the cross-reference.
        self.executor.on_result = None
        self.executor.on_error = None

    def __enter__(self) -> "AsyncFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- batcher -------------------------------------------------------------

    def _purge_expired(self, now: float) -> None:
        """Drop expired requests from *every* lane (caller holds
        _lane_cv). Expiry cannot wait for a pop: under sustained
        higher-priority traffic a lower lane might never be popped, and
        its deadline-armed requests must still resolve ``expired`` at
        their deadline instead of blocking in result()."""
        for lane in self._lanes.values():
            if not any(r.deadline_s is not None and now > r.deadline_s
                       for r, _ in lane):
                continue
            live = []
            while lane:
                r, f = lane.popleft()
                if r.deadline_s is not None and now > r.deadline_s:
                    self._drop_expired(r)
                else:
                    live.append((r, f))
            lane.extend(live)
            self._lane_cv.notify_all()   # lane freed admission slots

    def _pick_tenant(self) -> str | None:
        """Weighted round-robin choice among tenants with queued work
        (caller holds _lane_cv): every waiting tenant earns credit in
        proportion to its share of the waiting total, the highest
        credit wins one batch slot (ties break by name for
        determinism), and the winner pays one slot back. Over any
        contended interval each tenant's slot count converges to its
        share; a lone tenant nets zero credit, so a returning tenant
        faces no accumulated debt. Credits of idle tenants are dropped —
        fairness is about the present backlog, not hoarded history."""
        waiting: set[str] = {t for (t, _p), lane in self._lanes.items()
                             if lane}
        if not waiting:
            return None
        shares = {t: self.tenant_shares.get(t, 1.0) for t in waiting}
        total = sum(shares.values())
        self._credit = {t: c for t, c in self._credit.items()
                        if t in waiting}
        for t in waiting:
            self._credit[t] = self._credit.get(t, 0.0) + shares[t] / total
        chosen = max(sorted(waiting), key=lambda t: self._credit[t])
        self._credit[chosen] -= 1.0
        return chosen

    def _pop_tenant(self, tenant: str, now: float) -> tuple | None:
        """Pop the oldest live request from ``tenant``'s highest-
        priority non-empty lane (caller holds _lane_cv); None when the
        tenant has nothing live."""
        for key in sorted((k for k in self._lanes if k[0] == tenant),
                          key=lambda k: k[1], reverse=True):
            lane = self._lanes[key]
            while lane:
                req, frame = lane.popleft()
                self._lane_cv.notify_all()  # lane freed a slot
                if (req.deadline_s is not None
                        and now > req.deadline_s):
                    self._drop_expired(req)
                    continue
                return req, frame
        return None

    def _pop_next(self, timeout: float,
                  tenant: str | None = None) -> tuple | None:
        """Pop the next request for the batcher (None on timeout).
        Expired requests anywhere are dropped first — the
        queueing-phase SLO miss — without consuming a batch slot; the
        batcher's poll cadence (<= 50 ms between calls) bounds how
        stale an expiry can go undetected. With ``tenant=None`` (a new
        batch opening) the weighted round-robin sweep picks the tenant;
        a pinned ``tenant`` (filling a single-tenant batch) pops only
        that tenant's lanes, highest priority first."""
        deadline = time.perf_counter() + timeout
        with self._lane_cv:
            while True:
                now = time.perf_counter()
                self._purge_expired(now)
                pick = tenant if tenant is not None else self._pick_tenant()
                if pick is not None:
                    got = self._pop_tenant(pick, now)
                    if got is not None:
                        return got
                    if tenant is None:
                        # The picked tenant held only now-expired work;
                        # re-sweep before consuming any of the timeout.
                        continue
                remaining = deadline - now
                if remaining <= 0 or self._closing.is_set():
                    return None
                self._lane_cv.wait(timeout=remaining)

    def _drop_expired(self, req: ServedRequest) -> None:
        req._expire()
        with self._lock:
            self.stats.expired += 1
            self.stats.klass(req.klass).expired += 1
            self.stats.tenant_row(req.tenant).expired += 1
            self.stats._t_last = req.t_done

    def _run(self) -> None:
        while True:
            nxt = self._pop_next(timeout=0.01)
            if nxt is None:
                if self._closing.is_set():
                    # Final drain: anything a racing submit() slipped in
                    # before _closing was set is still in the lanes.
                    while (nxt := self._pop_next(timeout=0.0)) is not None:
                        self._assemble(nxt)
                    return
                # Idle: collect finished micro-batches the single-chain
                # executor is holding (no-op for the pipeline, whose
                # collector thread is always live).
                self.executor.flush_inflight()
                continue
            self._assemble(nxt)

    def _assemble(self, first: tuple) -> None:
        """Grow a single-tenant micro-batch from ``first`` until
        batch_size, the max_wait timeout, or — the expedited flush —
        the tightest member deadline, then dispatch it. Fill pops are
        pinned to the first request's tenant: models take different
        frame shapes, so a batch can never mix tenants."""
        with span("batcher.fill", owner=self._owner, batch=None) as fill:
            tenant = first[0].tenant
            batch = [first]
            first[0].t_batched = time.perf_counter()
            with self._lock:
                self._assembling = 1
                self._assembling_tenant = tenant
            flush_at = first[0].t_submit + self.max_wait_s
            # Holding the batch into a member's deadline would turn a
            # servable request into a drop; flush with guard margin instead.
            urgent_at = self._urgent_at(first[0])
            reason = "full"

            def take(nxt) -> None:
                nonlocal urgent_at
                nxt[0].t_batched = time.perf_counter()
                batch.append(nxt)
                with self._lock:
                    self._assembling = len(batch)
                urgent_at = min(urgent_at, self._urgent_at(nxt[0]))

            while len(batch) < self.batch_size:
                # Fill from the queued backlog before honoring any flush
                # timer: once lane wait exceeds max_wait the timer is
                # permanently expired, and flushing ahead of a non-empty
                # lane would collapse a backlogged frontend into padded
                # 1-frame batches (service rate / batch_size).
                nxt = self._pop_next(timeout=0.0, tenant=tenant)
                if nxt is not None:
                    take(nxt)
                    continue
                if self._closing.is_set():
                    reason = "timeout"
                    break
                now = time.perf_counter()
                if now >= urgent_at:
                    reason = "deadline"
                    break
                if now >= flush_at:
                    reason = "timeout"
                    break
                nxt = self._pop_next(
                    timeout=min(flush_at - now, urgent_at - now, 0.05),
                    tenant=tenant)
                if nxt is not None:
                    take(nxt)
            # The number this batch's dispatch gives it.
            fill.batch = self.stats.batches
        self._dispatch(batch, reason)

    def _dispatch(self, batch, reason: str) -> None:
        """Hand one assembled micro-batch to the executor. Members whose
        deadline passed during assembly are dropped here (the
        assembly-phase SLO miss). A dispatch failure (e.g. the pipeline
        died) resolves this batch's requests with the error instead of
        killing the batcher thread — later requests still get answers
        (more errors, most likely), and close() still converges."""
        # The swap boundary: while pause_dispatch holds the gate, this
        # assembled batch parks here — still counted as assembling, so
        # admission keeps pricing it — and a concurrent swap_executor
        # can drain the old executor knowing no batch is mid-entry
        # (_dispatching flips under the same lock as the in-flight
        # increment). A closing frontend overrides the gate so every
        # parked request still resolves.
        while True:
            with self._lock:
                if self._dispatch_gate.is_set() or self._closing.is_set():
                    self._dispatching = True
                    break
            self._dispatch_gate.wait(timeout=0.05)
        try:
            now = time.perf_counter()
            live = []
            for r, f in batch:
                if r.deadline_s is not None and now > r.deadline_s:
                    self._drop_expired(r)
                else:
                    live.append((r, f))
            if not live:
                with self._lock:
                    self._assembling = 0
                    self._assembling_tenant = None
                return
            # A swap may have shrunk batch_size while this batch was
            # parked; split so no chunk exceeds the compiled shape.
            bs = self.batch_size
            chunks = [live[i:i + bs] for i in range(0, len(live), bs)]
            for chunk in chunks:
                self._dispatch_chunk(chunk, reason, len(batch))
        finally:
            with self._lock:
                self._dispatching = False

    def _dispatch_chunk(self, live, reason: str, assembled_n: int) -> None:
        reqs = tuple(r for r, _ in live)
        tenant = reqs[0].tenant
        t_disp = time.perf_counter()
        for r in reqs:
            r.t_dispatched = t_disp
        with self._lock:
            # One atomic flip from assembling to in-flight: a concurrent
            # admission check must never see this batch in neither
            # counter (it would under-price the work ahead by a batch).
            self._assembling = 0
            self._assembling_tenant = None
            number = self.stats.batches
            self.stats.batches += 1
            self._inflight_batches += 1
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            if assembled_n >= self.batch_size:
                self.stats.flushes_full += 1
            elif reason == "deadline":
                self.stats.flushes_deadline += 1
            else:
                self.stats.flushes_timeout += 1
        try:
            with span("batcher.dispatch", owner=self._owner, batch=number):
                frames = np.stack([f for _, f in live])
                self.executor.submit_batch(frames, len(frames), tag=reqs)
        except BaseException as e:  # noqa: BLE001 - resolved per request
            for r in reqs:
                r._fail(e)
            with self._lock:
                self._inflight_batches -= 1
                self._inflight[tenant] -= 1
                self._last_done[tenant] = None
                self.stats.failed += len(reqs)
                ts = self.stats.tenant_row(tenant)
                ts.failed += len(reqs)
                for r in reqs:
                    self.stats.klass(r.klass).failed += 1
                    self.stats._t_last = r.t_done

    # -- completion (runs on the executor's collector thread) ----------------

    def _on_result(self, tag, outputs) -> None:
        now = time.perf_counter()
        tenant = tag[0].tenant
        # One observation per micro-batch: the measured compute phase
        # (dispatch -> done) feeds the tenant's EWMA driving the next
        # flush and admission decisions. All of a batch's requests share
        # t_dispatched (and, single-tenant batches, one tenant).
        self.estimator.observe(self._lat_key(tenant),
                               now - tag[0].t_dispatched)
        with self._lock:
            self._inflight_batches -= 1
            n_left = self._inflight.get(tenant, 1) - 1
            self._inflight[tenant] = n_left
            # A completion with another of the tenant's batches still in
            # flight measures its throughput beat (busy inter-completion
            # gap); idle gaps say nothing about drain rate and are
            # skipped — _last_done is cleared whenever the tenant
            # drains, or the first busy completion after an idle spell
            # would observe a "window" spanning the whole idle time.
            last = self._last_done.get(tenant)
            if last is not None and n_left >= 1:
                self.estimator.observe(self._win_key(tenant), now - last)
            self._last_done[tenant] = now if n_left >= 1 else None
            ts = self.stats.tenant_row(tenant)
            for i, req in enumerate(tag):
                req._resolve(outputs[i])
                cs = self.stats.klass(req.klass)
                self.stats.completed += 1
                cs.completed += 1
                ts.completed += 1
                if req.deadline_s is not None and now > req.deadline_s:
                    cs.late += 1
                    ts.late += 1
                self.stats.latencies_s.append(now - req.t_submit)
                ph = req.phase_s()
                cs.queueing_s.append(ph["queueing"])
                cs.assembly_s.append(ph["assembly"])
                cs.compute_s.append(ph["compute"])
                cs.total_s.append(now - req.t_submit)
                ts.total_s.append(now - req.t_submit)
            self.stats._t_last = now

    def _on_error(self, tag, exc: BaseException) -> None:
        for req in tag:
            req._fail(exc)
        tenant = tag[0].tenant
        with self._lock:
            self._inflight_batches -= 1
            self._inflight[tenant] = self._inflight.get(tenant, 1) - 1
            # A failed batch is not a completion: the next success must
            # not measure a "window" spanning this batch's interval.
            self._last_done[tenant] = None
            self.stats.failed += len(tag)
            self.stats.tenant_row(tenant).failed += len(tag)
            for req in tag:
                self.stats.klass(req.klass).failed += 1
            self.stats._t_last = time.perf_counter()
