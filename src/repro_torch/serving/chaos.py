"""FaultPlan-driven fault injection for the serving plane. PyTorch twin of
``repro/serving/chaos.py`` (pure Python: a copy with the port's imports).

The paper's pipeline-balance story (and every artifact this repo
publishes) is only credible if the serving contract — every submitted
request resolves, never hangs — survives the faults a real accelerator
deployment sees: a PE/stage dying mid-batch, a replica degrading into a
straggler, an executor that starts failing at time T. The seed's
``runtime/fault_tolerance.py`` sketched the *detection* side (EWMA
straggler detector, a ``fail_at`` step->fault injection dict for
training loops); this module is the serving-side injection half, so
recovery is measured rather than assumed:

* :class:`FaultPlan` declares one replica's faults (when to die, how —
  mid-batch or refusing dispatch —, when to start dragging, when to
  come back), JSON-recordable so a chaos artifact replays its exact
  fault program;
* :class:`ChaosExecutor` wraps any :class:`~repro_torch.serving.Executor`
  (a real :class:`~repro_torch.serving.pipeline_executor.PipelineExecutor`
  replica or a test fake) and conforms to the same protocol, injecting
  the plan at the dispatch/result boundary — errors flow through the
  pool/frontend ``on_error`` paths that already resolve requests
  ``failed``, which is exactly the property under test;
* :func:`install_stage_fault` reaches *inside* a real PipelineExecutor
  and arms one stage's runner to raise mid-batch — the PE-death case a
  wrapper at the executor boundary cannot express;
* :func:`recovery_report` turns replayed request handles into the
  time-to-recover measurement: windowed armed-miss rates after the
  first injected fault, and the time until the miss rate re-enters the
  target band.

FPGA correspondence: a ``kill`` is a PE/stage hard fault (the paper's
fabric has no ECC story — the batch in the array is lost), a
``straggle`` is a clock-degraded or thermally-throttled region, and
``fail_after_s`` is a board dropping off the host bus mid-run.
"""

from __future__ import annotations

import dataclasses
import threading
import time


class ReplicaKilled(RuntimeError):
    """Injected hard fault: the wrapped replica 'died' on this batch."""


class StageKilled(RuntimeError):
    """Injected stage fault: a pipeline stage runner 'died' mid-batch."""


KILL_MODES = ("mid-batch", "reject")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One replica's fault program, in wrapper-batch counts and seconds.

    ``kill_at_batch``   — from this (1-based) dispatched batch on, the
                          replica is dead: ``mid-batch`` mode accepts
                          the batch and fails it asynchronously through
                          ``on_error`` (the batch was in the array when
                          the PE died); ``reject`` mode raises from
                          ``submit_batch`` (the dispatch itself bounces,
                          like a poisoned pipeline).
    ``fail_after_s``    — the replica starts failing this many seconds
                          after its fault clock starts (first dispatch,
                          or :meth:`ChaosExecutor.reset_fault_clock`).
    ``straggle_at_batch`` / ``slowdown_s`` — from this batch on, every
                          result is delivered ``slowdown_s`` late (on
                          the victim's own delivery thread), degrading
                          it into a straggler without killing it.
    ``recover_at_batch`` — kill/fail faults stop from this batch on:
                          the replica answers probes again, which is
                          how re-admission is exercised.
    """

    kill_at_batch: int | None = None
    kill_mode: str = "mid-batch"
    fail_after_s: float | None = None
    straggle_at_batch: int | None = None
    slowdown_s: float = 0.0
    recover_at_batch: int | None = None

    def __post_init__(self):
        if self.kill_mode not in KILL_MODES:
            raise ValueError(f"kill_mode={self.kill_mode!r} not in "
                             f"{KILL_MODES}")
        for fld in ("kill_at_batch", "straggle_at_batch",
                    "recover_at_batch"):
            v = getattr(self, fld)
            if v is not None and v < 1:
                raise ValueError(f"{fld}={v} must be >= 1 (1-based)")
        if self.fail_after_s is not None and self.fail_after_s < 0:
            raise ValueError(f"fail_after_s={self.fail_after_s} < 0")
        if self.straggle_at_batch is not None and self.slowdown_s <= 0:
            raise ValueError("straggle_at_batch needs slowdown_s > 0")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ChaosExecutor:
    """Protocol-conforming injection wrapper around one executor.

    Sits between a :class:`~repro_torch.serving.replica_pool.ReplicaPool` (or
    an :class:`~repro_torch.serving.frontend.AsyncFrontend` directly) and the
    wrapped executor: claims the inner ``on_result``/``on_error`` slots
    and exposes its own, so injected faults and real results travel the
    same delivery path the healthy stack uses. Attributes the protocol
    does not name (``partition``, ``route``, ``stats``, ``serve`` for
    warmup, ...) pass through to the inner executor untouched.
    """

    def __init__(self, inner, plan: FaultPlan, *, name: str = "victim"):
        self.inner = inner
        self.plan = plan
        self.name = name
        self.batch_size = inner.batch_size
        self.program = inner.program
        self.on_result = None
        self.on_error = None
        self._lock = threading.Lock()
        self._batches = 0          # wrapper dispatches since fault clock
        self._t0: float | None = None
        self.injected_failures = 0
        self.injected_slowdowns = 0
        self.t_first_fault: float | None = None
        inner.on_result = self._forward_result
        if hasattr(inner, "on_error"):
            inner.on_error = self._forward_error

    def __getattr__(self, attr):
        # Only consulted for attributes not set on the wrapper itself.
        return getattr(self.inner, attr)

    def reset_fault_clock(self) -> None:
        """Re-zero the batch counter and the ``fail_after_s`` clock —
        called after warmup/calibration so plan offsets count from the
        measured chaos window, not from the first calibration batch."""
        with self._lock:
            self._batches = 0
            self._t0 = None

    def arm(self, plan: FaultPlan) -> None:
        """Swap in a new fault program and restart the fault clock.

        The chaos bench constructs the wrapper with a benign
        ``FaultPlan()`` so throughput calibration can run through the
        pool (calibration dispatches tick the wrapper's batch counter —
        an armed ``kill_at_batch`` would fire mid-calibration), then
        arms the real plan so its offsets count from the measured
        window."""
        with self._lock:
            self.plan = plan
            self._batches = 0
            self._t0 = None

    # -- fault decisions ------------------------------------------------------

    def _dead(self, n: int, now: float) -> bool:
        p = self.plan
        if p.recover_at_batch is not None and n >= p.recover_at_batch:
            return False
        if p.kill_at_batch is not None and n >= p.kill_at_batch:
            return True
        if (p.fail_after_s is not None and self._t0 is not None
                and now - self._t0 >= p.fail_after_s):
            return True
        return False

    def _straggling(self, n: int) -> bool:
        p = self.plan
        return (p.straggle_at_batch is not None
                and n >= p.straggle_at_batch)

    # -- Executor protocol ----------------------------------------------------

    def submit_batch(self, frames, n_valid: int, tag: object = None) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._batches += 1
            n = self._batches
            dead = self._dead(n, now)
            if dead:
                self.injected_failures += 1
                if self.t_first_fault is None:
                    self.t_first_fault = now
        if dead:
            exc = ReplicaKilled(
                f"injected fault: replica {self.name!r} is down "
                f"(batch {n} of plan {self.plan.to_json()})")
            if self.plan.kill_mode == "mid-batch" and self.on_error is not None:
                # The batch was accepted and died in the array: resolve
                # it through the same async error path a real stage
                # death uses.
                self.on_error(tag, exc)
                return
            raise exc
        self.inner.submit_batch(frames, n_valid, tag=tag)

    def flush_inflight(self) -> None:
        self.inner.flush_inflight()

    def reset_stats(self) -> None:
        self.inner.reset_stats()

    def replica_counts(self):
        return self.inner.replica_counts()

    # -- delivery (inner executor's threads) ----------------------------------

    def _forward_result(self, tag, outputs) -> None:
        with self._lock:
            slow = self._straggling(self._batches)
            if slow and self.t_first_fault is None:
                # A slowdown is a fault too: the straggler row's
                # recovery clock starts at the first dragged delivery.
                self.t_first_fault = time.perf_counter()
        if slow:
            # Dragging the delivery inflates the observed dispatch->done
            # service time (what the router prices) and runs on the
            # victim's own delivery thread, so only the victim stalls.
            self.injected_slowdowns += 1
            time.sleep(self.plan.slowdown_s)
        if self.on_result is not None:
            self.on_result(tag, outputs)

    def _forward_error(self, tag, exc) -> None:
        if self.on_error is not None:
            self.on_error(tag, exc)


def install_stage_fault(px, stage: int, at_call: int):
    """Arm stage ``stage`` of a real PipelineExecutor to raise
    :class:`StageKilled` from its ``at_call``-th batch (1-based) on —
    the PE-dies-mid-batch case: the stage worker catches the raise,
    poisons the executor, and forwards the error downstream so in-flight
    tagged batches resolve through ``on_error`` while later submits
    bounce synchronously. Returns the wrapper (its ``calls`` counter is
    the assertion hook). Must be installed before the stage runs."""
    if at_call < 1:
        raise ValueError(f"at_call={at_call} must be >= 1")

    class _DyingRunner:
        def __init__(self, runner):
            self._runner = runner
            self.calls = 0
            self._lock = threading.Lock()

        def launch(self, payload, *, sleep):
            # The stage's whole trip (CompiledRunner.launch) is its batch.
            with self._lock:
                self.calls += 1
                n = self.calls
            if n >= at_call:
                raise StageKilled(
                    f"injected fault: stage {stage} died on its "
                    f"batch {n}")
            return self._runner.launch(payload, sleep=sleep)

        def __getattr__(self, attr):
            # quantize/decode and anything else the pipeline needs.
            return getattr(self._runner, attr)

    wrapper = _DyingRunner(px.runners[stage])
    px.runners[stage] = wrapper
    return wrapper


def _armed_miss(req) -> bool:
    """Chaos-tier miss for one deadline-armed request: dropped, refused,
    completed late — or *failed*, which the knee's miss definition
    excludes (a healthy sweep treats failures as bench bugs) but a fault
    window must count against the SLO."""
    return (req.missed_deadline()
            or req.outcome in ("failed", "rejected"))


def recovery_report(reqs, *, fault_t0: float | None, window_s: float,
                    miss_target: float) -> dict:
    """Time-to-recover from replayed request handles.

    Buckets the deadline-armed requests submitted after ``fault_t0``
    into ``window_s``-wide windows and reports each window's miss rate
    (chaos definition: expired/refused/late *or failed*). Recovery is
    the end of the first non-empty window whose miss rate is back under
    ``miss_target`` — i.e. the router has steered the stream around the
    injured replica — reported as seconds after ``fault_t0``
    (``recovered_s = None`` when no window recovers, or no fault ever
    fired)."""
    armed = [r for r in reqs if r.deadline_s is not None]
    out: dict = {"window_s": round(window_s, 6),
                 "miss_target": miss_target,
                 "armed_total": len(armed),
                 "pre_fault_armed": None, "windows": [],
                 "recovered_s": None}
    if fault_t0 is None or not armed:
        return out
    pre = [r for r in armed if r.t_submit < fault_t0]
    post = [r for r in armed if r.t_submit >= fault_t0]
    out["pre_fault_armed"] = {
        "submitted": len(pre),
        "missed": sum(1 for r in pre if _armed_miss(r)),
    }
    if not post:
        return out
    end = max(r.t_submit for r in post)
    n_windows = int((end - fault_t0) // window_s) + 1
    windows = []
    for w in range(n_windows):
        lo = fault_t0 + w * window_s
        hi = lo + window_s
        inside = [r for r in post if lo <= r.t_submit < hi]
        missed = sum(1 for r in inside if _armed_miss(r))
        rate = missed / len(inside) if inside else None
        windows.append({"t_s": round(w * window_s, 6),
                        "submitted": len(inside), "missed": missed,
                        "miss_rate": None if rate is None
                        else round(rate, 4)})
        if (out["recovered_s"] is None and inside
                and rate is not None and rate < miss_target):
            out["recovered_s"] = round((w + 1) * window_s, 6)
    out["windows"] = windows
    return out
