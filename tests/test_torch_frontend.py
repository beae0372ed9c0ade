"""The port's QoS frontend, service-time estimator and seeded traffic
generator (``repro_torch.serving.{frontend,estimator,traffic}``, copies of
the reference's jax-free modules): the reference's frontend-QoS and
estimator tests, run on fake executors with the same assertions, and the
traffic generator held to the reference's schedules bit for bit for the
same seed. The acceptance pins: a low-priority flood cannot starve
high-priority requests past their deadline, an expired request resolves
with the ``expired`` outcome instead of hanging, and — with
estimated-wait admission on an exact estimator — no request both passes
admission and later expires in queue."""

import threading
import time

import numpy as np
import pytest

from repro.serving import traffic as traffic_j
from repro_torch.serving import (AsyncFrontend, DeadlineExpired,
                                 RequestRejected, ServiceTimeEstimator,
                                 TrafficClass, armed_class_names,
                                 default_mix, make_schedule,
                                 parse_traffic_mix, replay, window_key)
from repro_torch.serving import traffic as traffic_t


class EchoExecutor:
    """Fake executor: optional fixed service time per batch, echoes each
    frame back as its result, records dispatch order. Deterministic —
    no device, no jit."""

    def __init__(self, batch_size=4, delay_s=0.0):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.program = None         # no compiled program: skip shape checks
        self.on_result = None
        self.on_error = None
        self.dispatched = []        # list of tag tuples, in arrival order

    def submit_batch(self, frames, n_valid, tag=None):
        self.dispatched.append(tag)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.on_result:
            self.on_result(tag, [f.copy() for f in frames[:n_valid]])

    def flush_inflight(self):
        pass                        # delivers synchronously from submit

    def reset_stats(self):
        pass

    def replica_counts(self):
        return None


class GateExecutor(EchoExecutor):
    """EchoExecutor that blocks each submit_batch until released —
    batches complete exactly when the test says so."""

    def __init__(self, batch_size=4):
        super().__init__(batch_size)
        self.gate = threading.Semaphore(0)

    def submit_batch(self, frames, n_valid, tag=None):
        assert self.gate.acquire(timeout=30)
        super().submit_batch(frames, n_valid, tag)


FRAME = np.zeros((2, 2, 1), np.float32)


def _frames(n, base=0):
    return [np.full((2, 2, 1), base + i, np.float32) for i in range(n)]


# ---------------------------------------------------------------------------
# Outcomes
# ---------------------------------------------------------------------------


def test_expired_request_resolves_with_expired_outcome():
    """A request whose deadline passes while queued is dropped: outcome
    'expired', result() raises DeadlineExpired, nothing hangs, and the
    stats reconcile exactly."""
    ex = GateExecutor(batch_size=1)
    fe = AsyncFrontend(ex, max_wait_ms=5.0)
    blocker = fe.submit(FRAME)                  # occupies the executor
    time.sleep(0.05)                            # batcher blocks on gate
    doomed = fe.submit(FRAME, deadline_ms=1.0)  # expires while queued
    time.sleep(0.05)
    ex.gate.release()
    blocker.result(timeout=10)
    with pytest.raises(DeadlineExpired):
        doomed.result(timeout=10)
    assert doomed.outcome == "expired"
    assert doomed.expired() and doomed.missed_deadline()
    assert doomed.t_dispatched is None          # never reached the engine
    fe.close()
    st = fe.stats
    assert st.expired == 1 and st.completed == 1
    assert st.resolved == st.submitted == 2
    assert st.klass("p0").expired == 1


def test_rejected_outcome_on_full_lane_nonblocking():
    """block=False on a full lane load-sheds: the request comes back
    already resolved 'rejected' and result() raises RequestRejected."""
    ex = GateExecutor(batch_size=2)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, max_queue=2)
    reqs = [fe.submit(FRAME) for _ in range(2)]   # claimed by the batcher
    time.sleep(0.05)
    reqs += [fe.submit(FRAME) for _ in range(2)]  # fills the p0 lane
    shed = fe.submit(FRAME, block=False)
    assert shed.outcome == "rejected"
    with pytest.raises(RequestRejected):
        shed.result(timeout=1)
    for _ in range(3):
        ex.gate.release()
    for r in reqs:
        r.result(timeout=10)
    fe.close()
    assert fe.stats.rejected == 1
    assert fe.stats.resolved == fe.stats.submitted == 5


def test_full_lane_still_blocks_by_default():
    """The backpressure contract: a blocking submit on
    a full lane raises queue.Full when its timeout expires."""
    import queue as queue_mod
    ex = GateExecutor(batch_size=2)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, max_queue=2)
    reqs = [fe.submit(FRAME) for _ in range(2)]
    time.sleep(0.05)
    reqs += [fe.submit(FRAME) for _ in range(2)]
    with pytest.raises(queue_mod.Full):
        fe.submit(FRAME, timeout=0.05)
    for _ in range(3):
        ex.gate.release()
    for r in reqs:
        r.result(timeout=10)
    fe.close()


# ---------------------------------------------------------------------------
# Priority lanes + starvation
# ---------------------------------------------------------------------------


def test_priority_lanes_dispatch_high_first():
    """With both lanes populated, the next assembled batch drains the
    high-priority lane before touching the low one."""
    ex = GateExecutor(batch_size=4)
    fe = AsyncFrontend(ex, max_wait_ms=20.0)
    lo_first = [fe.submit(f, priority=0) for f in _frames(4)]
    time.sleep(0.05)        # batcher claims the first lo batch, blocks
    lo_rest = [fe.submit(f, priority=0) for f in _frames(4, base=10)]
    hi = [fe.submit(f, priority=1) for f in _frames(4, base=100)]
    for _ in range(3):
        ex.gate.release()
    for r in lo_first + lo_rest + hi:
        r.result(timeout=10)
    fe.close()
    assert len(ex.dispatched) == 3
    assert [r.priority for r in ex.dispatched[1]] == [1, 1, 1, 1]
    assert [r.priority for r in ex.dispatched[2]] == [0, 0, 0, 0]


def test_low_priority_flood_cannot_starve_high_past_deadline():
    """The pinned QoS guarantee: under a saturating best-effort flood,
    deadline-armed high-priority requests still complete inside their
    deadline (priority lanes + expedited flush), while every flood
    request still resolves eventually."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    fe = AsyncFrontend(ex, max_wait_ms=10.0)
    # 40 best-effort frames = 10 batches = ~500ms of queued work, so
    # FIFO service would answer a later arrival well past the 450ms
    # deadline the high class carries; the priority lane must not.
    flood = [fe.submit(f, priority=0, klass="lo") for f in _frames(40)]
    time.sleep(0.02)        # flood is queued ahead
    hi = [fe.submit(f, priority=2, deadline_ms=450.0, klass="hi")
          for f in _frames(4, base=100)]
    for r in hi:
        out = r.result(timeout=10)   # completes — never expired
        assert r.outcome == "completed"
        assert not r.missed_deadline()
        np.testing.assert_array_equal(out, np.full((2, 2, 1),
                                                   100 + hi.index(r)))
    fe.close()
    st = fe.stats
    assert st.resolved == st.submitted == 44
    assert st.klass("hi").completed == 4
    assert st.klass("hi").late == 0 and st.klass("hi").expired == 0
    assert st.klass("lo").completed == 40    # flood still fully served


def test_backlogged_frontend_dispatches_full_batches():
    """Once lane wait exceeds max_wait_ms the flush timer is permanently
    expired; the batcher must still fill batches from the queued backlog
    instead of timeout-flushing padded singletons (which would collapse
    the service rate by batch_size x)."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    fe = AsyncFrontend(ex, max_wait_ms=10.0, max_queue=1024)
    reqs = [fe.submit(f) for f in _frames(40)]
    for r in reqs:
        r.result(timeout=30)
    fe.close()
    sizes = [len(t) for t in ex.dispatched]
    assert sizes.count(4) >= 9, f"dispatch sizes {sizes}"
    assert fe.stats.flushes_full >= 9


def test_rejected_best_effort_is_drop_not_slo_miss():
    """Admission rejection of a deadline-less class counts in drop_rate
    only — a class with no SLO cannot miss one."""
    ex = GateExecutor(batch_size=2)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, max_queue=2)
    reqs = [fe.submit(FRAME) for _ in range(2)]
    time.sleep(0.05)
    reqs += [fe.submit(FRAME) for _ in range(2)]
    shed = fe.submit(FRAME, block=False)
    assert shed.outcome == "rejected"
    for _ in range(3):
        ex.gate.release()
    for r in reqs:
        r.result(timeout=10)
    fe.close()
    cs = fe.stats.klass("default")
    assert cs.rejected == 1 and not cs.armed
    assert cs.drop_rate > 0.0
    assert cs.slo_miss_rate == 0.0


def test_starved_lane_request_still_expires_at_deadline():
    """A deadline-armed request in a lane the batcher never drains
    (sustained higher-priority traffic) must still resolve ``expired``
    at its deadline — never block in result() until the flood abates."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    fe = AsyncFrontend(ex, max_wait_ms=10.0)
    # ~0.5s of high-priority work keeps lane 1 non-empty throughout.
    flood = [fe.submit(f, priority=1, klass="hi") for f in _frames(40)]
    starved = fe.submit(FRAME, priority=0, deadline_ms=100.0, klass="lo")
    with pytest.raises(DeadlineExpired):
        starved.result(timeout=10)
    # Expired at ~deadline, not after the flood drained (~0.5s).
    assert starved.latency_s < 0.4
    for r in flood:
        r.result(timeout=30)
    fe.close()
    assert fe.stats.klass("lo").expired == 1
    assert fe.stats.resolved == fe.stats.submitted == 41


def test_deadline_expedites_flush():
    """A lone deadline-armed request in a quiet frontend must be flushed
    at its deadline, not parked for the full max_wait window."""
    ex = EchoExecutor(batch_size=8)
    fe = AsyncFrontend(ex, max_wait_ms=10_000.0)
    t0 = time.perf_counter()
    req = fe.submit(FRAME, deadline_ms=100.0)
    req.result(timeout=10)
    elapsed = time.perf_counter() - t0
    fe.close()
    assert req.outcome == "completed"
    assert elapsed < 5.0                     # nowhere near max_wait
    assert fe.stats.flushes_deadline == 1
    assert fe.stats.flushes_timeout == 0


# ---------------------------------------------------------------------------
# Adaptive control: EWMA flush + estimated-wait admission
# ---------------------------------------------------------------------------


def test_admission_rejects_hopeless_request_at_submit():
    """With ~500ms of queued work ahead priced by an exact estimator, a
    100ms-deadline request is refused at submit (rejected_wait) instead
    of expiring in queue; an ample-budget request sails through."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    est = ServiceTimeEstimator()
    est.warm_start(4, 0.05)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, estimator=est,
                       admission_control=True, flush_guard_ms=10.0)
    flood = [fe.submit(f) for f in _frames(40)]   # ~10 batches queued
    doomed = fe.submit(FRAME, deadline_ms=100.0, klass="doomed")
    assert doomed.outcome == "rejected_wait"
    assert doomed.done() and doomed.missed_deadline()
    assert doomed.t_batched is None               # never entered a lane
    with pytest.raises(RequestRejected):
        doomed.result(timeout=1)
    ok = fe.submit(FRAME, deadline_ms=10_000.0, klass="ok")
    for r in flood:
        r.result(timeout=30)
    assert np.asarray(ok.result(timeout=30)).shape == FRAME.shape
    fe.close()
    st = fe.stats
    assert st.resolved == st.submitted == 42
    assert st.rejected_wait == 1 and st.expired == 0
    cs = st.klass("doomed")
    assert cs.rejected_wait == 1 and cs.armed
    assert cs.slo_miss_rate == 1.0 and cs.drop_rate == 1.0
    assert st.klass("ok").completed == 1


def test_admission_prices_only_work_at_or_above_own_priority():
    """A best-effort flood in the low lane must not scare admission off
    a high-priority request — the priority lanes will serve it first, so
    only work at its own priority or higher (plus in-flight batches) is
    ahead of it."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    est = ServiceTimeEstimator()
    est.warm_start(4, 0.05)
    fe = AsyncFrontend(ex, max_wait_ms=10.0, estimator=est,
                       admission_control=True, flush_guard_ms=10.0)
    flood = [fe.submit(f, priority=0, klass="lo") for f in _frames(40)]
    time.sleep(0.02)
    hi = fe.submit(FRAME, priority=2, deadline_ms=450.0, klass="hi")
    assert hi.outcome != "rejected_wait"          # admitted
    out = hi.result(timeout=10)
    assert hi.outcome == "completed" and not hi.missed_deadline()
    np.testing.assert_array_equal(out, FRAME)
    for r in flood:
        r.result(timeout=30)
    fe.close()
    assert fe.stats.rejected_wait == 0
    assert fe.stats.resolved == fe.stats.submitted == 41


def test_admission_disabled_keeps_expiry_behaviour():
    """admission_control=False (the default) is the lane-bound-only contract: the
    same hopeless request is accepted and expires in queue."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    est = ServiceTimeEstimator()
    est.warm_start(4, 0.05)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, estimator=est,
                       flush_guard_ms=10.0)
    flood = [fe.submit(f) for f in _frames(40)]
    doomed = fe.submit(FRAME, deadline_ms=100.0)
    with pytest.raises(DeadlineExpired):
        doomed.result(timeout=10)
    assert doomed.outcome == "expired"
    for r in flood:
        r.result(timeout=30)
    fe.close()
    assert fe.stats.rejected_wait == 0 and fe.stats.expired == 1


def test_ewma_flush_replaces_fixed_guard_when_estimator_is_warm():
    """A lone deadline-armed request in a quiet frontend is parked until
    est_service + guard before its deadline — substantially *later* than
    the fixed 80%-of-budget fallback — and still completes in time."""
    ex = EchoExecutor(batch_size=8)                 # instant service
    est = ServiceTimeEstimator()
    est.warm_start(8, 0.010)
    fe = AsyncFrontend(ex, max_wait_ms=10_000.0, estimator=est,
                       flush_guard_ms=300.0)
    t0 = time.perf_counter()
    req = fe.submit(FRAME, deadline_ms=3_000.0)
    req.result(timeout=10)
    elapsed = time.perf_counter() - t0
    fe.close()
    assert req.outcome == "completed"
    assert not req.missed_deadline()
    # Fixed-guard fallback would have flushed at 2400ms; the estimator
    # holds the batch open until ~2690ms (more assembly opportunity).
    # The ~310ms slack before the deadline absorbs scheduler stalls on
    # a starved shared runner — this runs in the blocking tier-1 lane.
    assert elapsed > 2.5
    assert fe.stats.flushes_deadline == 1


def test_saturating_flood_admitted_requests_never_expire_in_queue():
    """The admission property pinned by the acceptance criteria: under a
    saturating deadline-armed flood with an *exact* estimator (the fake
    executor's service time is deterministic and warm-started verbatim),
    every request either completes or is refused at submit — zero
    requests pass admission and then expire in queue."""
    ex = EchoExecutor(batch_size=4, delay_s=0.05)
    est = ServiceTimeEstimator()
    est.warm_start(4, 0.05)
    fe = AsyncFrontend(ex, max_wait_ms=5.0, max_queue=1024,
                       estimator=est, admission_control=True,
                       flush_guard_ms=25.0)
    # 60 frames = 15 batches = 750ms of work at a 400ms deadline: the
    # early fraction is servable, the tail is hopeless.
    reqs = [fe.submit(f, deadline_ms=400.0, klass="rt")
            for f in _frames(60)]
    for r in reqs:
        assert r._event.wait(timeout=30), "request hung"
    fe.close()
    st = fe.stats
    assert st.resolved == st.submitted == 60
    assert st.expired == 0, \
        f"{st.expired} admitted requests expired in queue"
    assert st.rejected_wait > 0            # the hopeless tail failed fast
    assert st.completed > 0                # the servable head completed
    assert st.completed + st.rejected_wait == 60
    for r in reqs:
        assert r.outcome in ("completed", "rejected_wait")


# ---------------------------------------------------------------------------
# Timestamps + per-class stats
# ---------------------------------------------------------------------------


def test_four_timestamps_monotone_and_phase_split():
    """t_submit <= t_batched <= t_dispatched <= t_done for a completed
    request, and the phase split reassembles to the total latency."""
    ex = EchoExecutor(batch_size=2, delay_s=0.01)
    fe = AsyncFrontend(ex, max_wait_ms=20.0)
    reqs = [fe.submit(f, priority=1, deadline_ms=5_000.0, klass="hi")
            for f in _frames(2)]
    for r in reqs:
        r.result(timeout=10)
    fe.close()
    for r in reqs:
        assert r.t_submit <= r.t_batched <= r.t_dispatched <= r.t_done
        ph = r.phase_s()
        assert all(v is not None and v >= 0 for v in ph.values())
        total = ph["queueing"] + ph["assembly"] + ph["compute"]
        assert total == pytest.approx(r.latency_s, abs=1e-6)


def test_per_class_stats_reconcile_and_percentiles():
    """Class rows partition the totals; phase percentiles come back per
    class with p50 <= p95 <= p99."""
    ex = EchoExecutor(batch_size=4)
    fe = AsyncFrontend(ex, max_wait_ms=10.0)
    for f in _frames(8):
        fe.submit(f, priority=0, klass="bulk")
    for f in _frames(4, base=50):
        fe.submit(f, priority=1, deadline_ms=5_000.0, klass="rt")
    while fe.stats.resolved < 12:
        time.sleep(0.005)
    fe.close()
    st = fe.stats
    assert set(st.classes) == {"bulk", "rt"}
    assert st.klass("bulk").submitted == 8
    assert st.klass("rt").submitted == 4
    assert sum(cs.submitted for cs in st.classes.values()) == st.submitted
    assert sum(cs.completed for cs in st.classes.values()) == st.completed
    pp = st.phase_percentiles()
    for name in ("bulk", "rt"):
        for phase in ("queueing", "assembly", "compute", "total"):
            row = pp[name][phase]
            assert row["p50"] <= row["p95"] <= row["p99"]
    assert st.klass("rt").slo_miss_rate == 0.0
    assert st.klass("bulk").drop_rate == 0.0


def test_legacy_submit_is_single_default_class():
    """Plain submit() (no priority, no deadline) keeps the plain
    behaviour: one best-effort class, nothing dropped, nothing late."""
    ex = EchoExecutor(batch_size=4)
    fe = AsyncFrontend(ex, max_wait_ms=10.0)
    reqs = [fe.submit(f) for f in _frames(6)]
    for r in reqs:
        r.result(timeout=10)
    fe.close()
    assert set(fe.stats.classes) == {"default"}
    assert fe.stats.expired == fe.stats.rejected == 0
    assert not np.isnan(fe.stats.latency_percentiles()["p99"])


# ---------------------------------------------------------------------------
# Traffic generator (the one seeded stream every bench shares)
# ---------------------------------------------------------------------------


def test_make_schedule_deterministic_and_mixed():
    mix = default_mix(slo_ms=100.0)
    a = make_schedule(64, 200.0, mix, seed=7)
    b = make_schedule(64, 200.0, mix, seed=7)
    assert [(x.t, x.frame_idx, x.klass.name) for x in a] == \
        [(x.t, x.frame_idx, x.klass.name) for x in b]
    assert {x.klass.name for x in a} == {"interactive", "batch"}
    # Uniform pacing at 200 fps: 5ms period, monotone offsets.
    assert a[0].t == 0.0
    assert all(y.t - x.t == pytest.approx(0.005)
               for x, y in zip(a, a[1:]))
    c = make_schedule(64, 200.0, mix, seed=8)
    assert [x.klass.name for x in a] != [x.klass.name for x in c]
    # Poisson arrivals: same seed reproduces, gaps vary.
    d = make_schedule(64, 200.0, mix, seed=7, poisson=True)
    e = make_schedule(64, 200.0, mix, seed=7, poisson=True)
    assert [x.t for x in d] == [x.t for x in e]
    gaps = {round(y.t - x.t, 6) for x, y in zip(d, d[1:])}
    assert len(gaps) > 1


def test_parse_traffic_mix():
    mix = parse_traffic_mix("interactive:1:1:50,batch:0:3")
    assert [c.name for c in mix] == ["interactive", "batch"]
    assert mix[0].priority == 1 and mix[0].deadline_ms == 50.0
    assert mix[1].deadline_ms is None
    assert mix[0].share == pytest.approx(0.25)   # normalized 1:3
    assert parse_traffic_mix("a:0:1:slo", slo_ms=77.0)[0].deadline_ms == 77.0
    with pytest.raises(ValueError):
        parse_traffic_mix("bad")
    with pytest.raises(ValueError):
        parse_traffic_mix("a:0:0,b:0:0")
    with pytest.raises(ValueError):
        parse_traffic_mix("a:0:1:slo")       # 'slo' needs an slo_ms
    with pytest.raises(ValueError):
        parse_traffic_mix("a:0:1:slo", slo_ms=0.0)


def test_armed_class_names():
    mix = default_mix(slo_ms=100.0)
    assert armed_class_names(mix) == ("interactive",)
    assert armed_class_names(parse_traffic_mix("a:0:1,b:1:1")) == ()


def test_replay_resolves_every_request():
    """replay() waits out expired/failed requests instead of raising —
    handles come back with their outcomes readable."""
    ex = EchoExecutor(batch_size=4, delay_s=0.01)
    fe = AsyncFrontend(ex, max_wait_ms=10.0)
    mix = (TrafficClass("rt", priority=1, deadline_ms=2_000.0, share=0.5),
           TrafficClass("bulk", priority=0, deadline_ms=None, share=0.5))
    frames = np.stack(_frames(16))
    schedule = make_schedule(16, 500.0, mix, seed=3)
    reqs = replay(fe, frames, schedule)
    fe.close()
    assert len(reqs) == 16
    assert all(r.done() for r in reqs)
    assert fe.stats.resolved == fe.stats.submitted == 16
    for a, r in zip(schedule, reqs):
        assert r.klass == a.klass.name
        if r.outcome == "completed":
            np.testing.assert_array_equal(r.result(), frames[a.frame_idx])


# ---------------------------------------------------------------------------
# Service-time estimator
# ---------------------------------------------------------------------------


def test_warm_start_channels_seeds_both_admission_channels():
    """One K>1 calibration throughput measurement seeds both channels:
    the busy-completion-window at the fleet batch window and the latency
    at stages x replicas x window — and real measurements still outrank
    the seed, channel by channel."""
    est = ServiceTimeEstimator()
    est.warm_start_channels(32, 0.040, stages=3, replicas=2)
    assert est.estimate(window_key(32)) == pytest.approx(0.040)
    assert est.estimate(32) == pytest.approx(3 * 2 * 0.040)
    # A measured latency outranks a later warm start on that channel
    # only; the never-observed window channel still accepts the seed.
    est.observe(32, 0.100)
    lat_after_obs = est.estimate(32)
    est.warm_start_channels(32, 0.010, stages=3, replicas=2)
    assert est.estimate(window_key(32)) == pytest.approx(0.010)
    assert est.estimate(32) == pytest.approx(lat_after_obs)
    # Degenerate K=1, R=1: both channels seed at the same window.
    est2 = ServiceTimeEstimator()
    est2.warm_start_channels(8, 0.020)
    assert est2.estimate(8) == pytest.approx(0.020)
    assert est2.estimate(window_key(8)) == pytest.approx(0.020)
    with pytest.raises(ValueError):
        est.warm_start_channels(32, 0.010, stages=0)
    with pytest.raises(ValueError):
        est.warm_start_channels(32, 0.010, replicas=0)
    with pytest.raises(ValueError):
        est.warm_start_channels(32, -1.0)


def test_empty_estimator_knows_nothing():
    est = ServiceTimeEstimator()
    assert est.estimate(32) is None
    assert est.n_observed(32) == 0
    assert est.snapshot() == {}


def test_warm_start_seeds_and_measurements_outrank_it():
    est = ServiceTimeEstimator()
    est.warm_start(32, 0.050)
    assert est.estimate(32) == pytest.approx(0.050)
    assert est.n_observed(32) == 0           # calibration != observation
    # A second warm start before any observation re-seeds (recalibration)
    est.warm_start(32, 0.040)
    assert est.estimate(32) == pytest.approx(0.040)
    # ...but once a real batch has been observed, warm_start is a no-op:
    # measurements outrank calibration.
    est.observe(32, 0.060)
    before = est.estimate(32)
    est.warm_start(32, 0.001)
    assert est.estimate(32) == pytest.approx(before)
    assert est.n_observed(32) == 1


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        ServiceTimeEstimator(alpha=0.0)
    with pytest.raises(ValueError):
        ServiceTimeEstimator(alpha=1.5)
    est = ServiceTimeEstimator()
    with pytest.raises(ValueError):
        est.warm_start(32, 0.0)
    # Non-positive observations (clock skew) are dropped, not folded in.
    est.observe(32, -1.0)
    assert est.estimate(32) is None


def test_ewma_converges_and_tracks_a_shift():
    est = ServiceTimeEstimator(alpha=0.3)
    for _ in range(30):
        est.observe(8, 0.020)
    assert est.estimate(8) == pytest.approx(0.020, rel=1e-6)
    # The backend slows down 2x; the EWMA tracks it within ~10 batches.
    for _ in range(10):
        est.observe(8, 0.040)
    assert est.estimate(8) == pytest.approx(0.040, rel=0.05)
    # First observation initializes directly (no bias toward zero).
    fresh = ServiceTimeEstimator()
    fresh.observe(4, 0.123)
    assert fresh.estimate(4) == pytest.approx(0.123)


def test_shapes_are_isolated():
    est = ServiceTimeEstimator()
    est.warm_start(8, 0.010)
    for _ in range(5):
        est.observe(32, 0.050)
    assert est.estimate(8) == pytest.approx(0.010)
    assert est.estimate(32) == pytest.approx(0.050)
    assert est.estimate(16) is None
    assert est.n_observed(8) == 0 and est.n_observed(32) == 5
    snap = est.snapshot()
    assert snap["8"]["warm_started"] and not snap["32"]["warm_started"]
    assert snap["32"]["n_observed"] == 5


def test_thread_safety_under_concurrent_observe_and_estimate():
    """8 writer threads x 500 observations per shape, concurrent readers:
    no exception, every observation counted, and the final estimate sits
    inside the observed range (a torn read/write would escape it)."""
    est = ServiceTimeEstimator(alpha=0.5)
    n_threads, n_obs = 8, 500
    lo, hi = 0.010, 0.030
    errors = []

    def writer(shape):
        try:
            for i in range(n_obs):
                est.observe(shape, lo + (hi - lo) * (i % 10) / 9)
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors.append(e)

    def reader():
        try:
            for _ in range(n_obs):
                for shape in (0, 1, 2, 3):
                    v = est.estimate(shape)
                    assert v is None or lo <= v <= hi
                est.snapshot()
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(p % 4,))
               for p in range(n_threads)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "estimator thread hung"
    assert not errors, f"concurrent access raised: {errors}"
    assert sum(est.n_observed(s) for s in (0, 1, 2, 3)) == \
        n_threads * n_obs
    for shape in (0, 1, 2, 3):
        assert lo <= est.estimate(shape) <= hi


# ---------------------------------------------------------------------------
# The traffic generator against the reference's, seed for seed
# ---------------------------------------------------------------------------


def _rows(schedule):
    return [(a.t, a.frame_idx, a.tenant, a.klass.name, a.klass.priority,
             a.klass.deadline_ms, a.klass.share) for a in schedule]


def _mix(mod, slo_ms=80.0):
    return mod.parse_traffic_mix("interactive:2:1:slo,bulk:0:3,mid:1:1:250",
                                 slo_ms=slo_ms)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("poisson", [False, True])
def test_make_schedule_equals_the_reference(seed, poisson):
    """Same seed, rate and mix: every arrival offset, frame index, tenant
    and class equal the reference's (float offsets compared exactly)."""
    want = traffic_j.make_schedule(97, 333.0, _mix(traffic_j), seed=seed,
                                   poisson=poisson)
    got = traffic_t.make_schedule(97, 333.0, _mix(traffic_t), seed=seed,
                                  poisson=poisson)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("scenario", sorted(traffic_j.SCENARIOS))
def test_scenario_schedules_equal_the_reference(scenario):
    """Every arrival process of ``SCENARIOS`` (bursts, heavy tails, rate
    ramps) draws the reference's schedule and records the same resolved
    parameters."""
    assert sorted(traffic_t.SCENARIOS) == sorted(traffic_j.SCENARIOS)
    sj, pj = traffic_j.make_scenario_schedule(scenario, 80, 250.0,
                                              _mix(traffic_j), seed=5)
    st, pt = traffic_t.make_scenario_schedule(scenario, 80, 250.0,
                                              _mix(traffic_t), seed=5)
    assert _rows(st) == _rows(sj)
    assert pt == pj


def test_parse_and_default_mix_equal_the_reference():
    assert [c.to_json() for c in _mix(traffic_t)] == \
        [c.to_json() for c in _mix(traffic_j)]
    assert [c.to_json() for c in traffic_t.default_mix(120.0)] == \
        [c.to_json() for c in traffic_j.default_mix(120.0)]
