"""The port's chaos serving (``repro_torch.serving.chaos``): the
reference's ``tests/test_chaos.py`` case for case with the same
assertions, on the port's fakes, plus the same faults injected into the
port's real ``PipelineExecutor`` on a tiny CPU program (a stage that dies
mid-batch; one of two real replicas killed mid-stream, the survivor's
outputs equal to the whole chain's).

Chaos serving: fault injection, adversarial traffic, and the liveness
contract under both.

The load-bearing test is the pinned acceptance scenario at the bottom:
kill one replica mid-stream at ~0.6x the fleet's sustainable load and
require that *zero* requests hang, every affected request resolves
``failed``, the survivor absorbs the stream, and the armed miss rate
recovers below the target within a measured window. Everything above it
is the unit layer that makes that scenario diagnosable when it breaks:
FaultPlan semantics, ChaosExecutor protocol conformance, the scenario
schedule suite, trace round-trips, and the pacing/recovery reports."""

import json
import time

import numpy as np
import pytest

from repro_torch.serving import (Arrival, AsyncFrontend, ChaosExecutor,
                                 Executor, FaultPlan, PipelineExecutor,
                                 ReplicaKilled, ReplicaPool, SCENARIOS,
                                 StageKilled, TrafficClass,
                                 install_stage_fault, make_schedule,
                                 make_scenario_schedule, pacing_report,
                                 record_trace, recovery_report, replay,
                                 trace_schedule)


class EchoExec:
    """Minimal Executor-conforming fake: optional fixed service time,
    echoes valid frames back synchronously from the submit thread."""

    def __init__(self, batch_size=4, delay_s=0.0):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.program = None
        self.on_result = None
        self.on_error = None
        self.batches = 0

    def submit_batch(self, frames, n_valid, tag=None):
        self.batches += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.on_result is not None:
            self.on_result(tag, np.asarray(frames)[:n_valid].copy())

    def flush_inflight(self):
        pass

    def reset_stats(self):
        pass

    def replica_counts(self):
        return None


def _collectors(chaos):
    """Claim the wrapper's callback slots into (results, errors) lists."""
    results, errors = [], []
    chaos.on_result = lambda tag, out: results.append((tag, out))
    chaos.on_error = lambda tag, exc: errors.append((tag, exc))
    return results, errors


_FRAMES = np.zeros((4, 2, 2, 1), np.float32)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------


def test_fault_plan_validates():
    with pytest.raises(ValueError):
        FaultPlan(kill_mode="nope")
    with pytest.raises(ValueError):
        FaultPlan(kill_at_batch=0)
    with pytest.raises(ValueError):
        FaultPlan(recover_at_batch=0)
    with pytest.raises(ValueError):
        FaultPlan(fail_after_s=-1.0)
    with pytest.raises(ValueError):
        FaultPlan(straggle_at_batch=3)          # needs slowdown_s > 0
    plan = FaultPlan(kill_at_batch=5, recover_at_batch=9)
    rec = plan.to_json()
    assert rec["kill_at_batch"] == 5 and rec["recover_at_batch"] == 9
    json.dumps(rec)                             # artifact-serializable


def test_install_stage_fault_validates():
    with pytest.raises(ValueError):
        install_stage_fault(object(), stage=0, at_call=0)


# ---------------------------------------------------------------------------
# ChaosExecutor
# ---------------------------------------------------------------------------


def test_chaos_executor_conforms_and_passes_through():
    inner = EchoExec()
    chaos = ChaosExecutor(inner, FaultPlan())
    assert isinstance(chaos, Executor)
    assert chaos.batch_size == inner.batch_size
    assert chaos.batches == 0                   # __getattr__ passthrough
    # The wrapper claimed the inner slots and exposes fresh ones.
    assert inner.on_result is not None and chaos.on_result is None
    results, errors = _collectors(chaos)
    chaos.submit_batch(_FRAMES, 4, tag="a")
    assert inner.batches == 1
    assert [t for t, _ in results] == ["a"] and not errors


def test_chaos_kill_mid_batch_flows_through_on_error():
    """mid-batch mode: the dispatch is *accepted* and dies in the array —
    the error arrives asynchronously-shaped through on_error with the
    submit tag, which is exactly the path that resolves frontend
    requests ``failed`` instead of hanging them."""
    chaos = ChaosExecutor(EchoExec(), FaultPlan(kill_at_batch=2))
    results, errors = _collectors(chaos)
    chaos.submit_batch(_FRAMES, 4, tag="a")     # batch 1: alive
    chaos.submit_batch(_FRAMES, 4, tag="b")     # batch 2+: dead
    chaos.submit_batch(_FRAMES, 4, tag="c")
    assert [t for t, _ in results] == ["a"]
    assert [t for t, _ in errors] == ["b", "c"]
    assert all(isinstance(e, ReplicaKilled) for _, e in errors)
    assert chaos.inner.batches == 1             # never reached the inner
    assert chaos.injected_failures == 2
    assert chaos.t_first_fault is not None


def test_chaos_kill_reject_mode_raises_from_submit():
    chaos = ChaosExecutor(EchoExec(),
                          FaultPlan(kill_at_batch=1, kill_mode="reject"))
    _collectors(chaos)
    with pytest.raises(ReplicaKilled):
        chaos.submit_batch(_FRAMES, 4, tag="a")


def test_chaos_recovers_at_batch():
    chaos = ChaosExecutor(EchoExec(),
                          FaultPlan(kill_at_batch=2, recover_at_batch=4))
    results, errors = _collectors(chaos)
    for tag in "abcd":
        chaos.submit_batch(_FRAMES, 4, tag=tag)
    assert [t for t, _ in results] == ["a", "d"]
    assert [t for t, _ in errors] == ["b", "c"]


def test_chaos_fail_after_s_and_clock_reset():
    """fail_after_s counts from the fault clock (first dispatch, or the
    explicit reset a bench performs after calibration) — so calibration
    batches must not burn the fault window."""
    chaos = ChaosExecutor(EchoExec(), FaultPlan(fail_after_s=0.0))
    results, errors = _collectors(chaos)
    chaos.submit_batch(_FRAMES, 4, tag="a")     # t0 set, 0s elapsed: dead
    assert not results and [t for t, _ in errors] == ["a"]

    chaos = ChaosExecutor(EchoExec(), FaultPlan(kill_at_batch=3))
    results, errors = _collectors(chaos)
    chaos.submit_batch(_FRAMES, 4, tag="warm1")
    chaos.submit_batch(_FRAMES, 4, tag="warm2")
    chaos.reset_fault_clock()                   # calibration over
    chaos.submit_batch(_FRAMES, 4, tag="a")     # batches 1, 2 post-reset
    chaos.submit_batch(_FRAMES, 4, tag="b")
    chaos.submit_batch(_FRAMES, 4, tag="c")     # batch 3: dead
    assert [t for t, _ in results] == ["warm1", "warm2", "a", "b"]
    assert [t for t, _ in errors] == ["c"]


def test_chaos_straggle_delays_delivery_without_killing():
    chaos = ChaosExecutor(
        EchoExec(), FaultPlan(straggle_at_batch=2, slowdown_s=0.05))
    results, errors = _collectors(chaos)
    chaos.submit_batch(_FRAMES, 4, tag="a")
    t0 = time.perf_counter()
    chaos.submit_batch(_FRAMES, 4, tag="b")
    slow_s = time.perf_counter() - t0
    assert [t for t, _ in results] == ["a", "b"] and not errors
    assert slow_s >= 0.05
    assert chaos.injected_slowdowns == 1
    assert chaos.injected_failures == 0
    # A slowdown is a fault too: the straggler replay's recovery clock
    # starts at the first dragged delivery.
    assert chaos.t_first_fault is not None


def test_chaos_arm_swaps_plan_and_restarts_clock():
    """The bench calibrates through a benign wrapper, then arms the real
    plan — the armed offsets must count from zero, not from the
    calibration batches."""
    chaos = ChaosExecutor(EchoExec(), FaultPlan())
    results, errors = _collectors(chaos)
    for tag in ("c1", "c2", "c3"):              # calibration: no faults
        chaos.submit_batch(_FRAMES, 4, tag=tag)
    chaos.arm(FaultPlan(kill_at_batch=2))
    chaos.submit_batch(_FRAMES, 4, tag="a")     # batch 1 post-arm: fine
    chaos.submit_batch(_FRAMES, 4, tag="b")     # batch 2: dead
    assert [t for t, _ in results] == ["c1", "c2", "c3", "a"]
    assert [t for t, _ in errors] == ["b"]
    assert chaos.plan.kill_at_batch == 2
    assert chaos.injected_failures == 1


# ---------------------------------------------------------------------------
# Scenario schedules
# ---------------------------------------------------------------------------


def test_scenarios_deterministic_monotone_and_recorded():
    for scenario in SCENARIOS:
        sched, rec = make_scenario_schedule(scenario, 400, 200.0, seed=7)
        again, rec2 = make_scenario_schedule(scenario, 400, 200.0, seed=7)
        assert sched == again and rec == rec2
        assert len(sched) == 400
        times = [a.t for a in sched]
        assert times[0] == 0.0
        assert all(b >= a for a, b in zip(times, times[1:]))
        assert rec["scenario"] == scenario
        assert rec["seed"] == 7 and rec["n"] == 400
        assert rec["rate_fps"] == 200.0
        json.dumps(rec)


def test_scenarios_hold_the_long_run_rate():
    """Every envelope bends the arrival *process*, not the long-run mean
    rate the artifact claims (pareto's infinite variance earns it the
    loosest band)."""
    for scenario, lo, hi in [("uniform", 0.99, 1.01),
                             ("poisson", 0.8, 1.25),
                             ("onoff", 0.8, 1.25),
                             ("lognormal", 0.7, 1.4),
                             ("pareto", 0.5, 2.0),
                             ("diurnal", 0.8, 1.25)]:
        sched, _ = make_scenario_schedule(scenario, 2000, 500.0, seed=11)
        span = sched[-1].t - sched[0].t
        achieved = (len(sched) - 1) / span
        assert lo <= achieved / 500.0 <= hi, \
            f"{scenario}: achieved {achieved:.1f} fps vs target 500"


def test_uniform_and_poisson_reproduce_make_schedule():
    """The legacy paths ride the same front door bit-for-bit: existing
    knee artifacts stay comparable across the scenario refactor."""
    mix = (TrafficClass("rt", priority=1, deadline_ms=50.0, share=0.5),
           TrafficClass("bulk", share=0.5))
    for scenario, poisson in [("uniform", False), ("poisson", True)]:
        legacy = make_schedule(300, 150.0, mix, seed=3, poisson=poisson)
        sched, _ = make_scenario_schedule(scenario, 300, 150.0, mix, seed=3)
        assert sched == legacy


def test_onoff_has_two_gap_regimes():
    sched, rec = make_scenario_schedule("onoff", 800, 400.0, seed=1,
                                        burst_factor=4.0, duty=0.25)
    gaps = np.diff([a.t for a in sched])
    # burst gap = 1/(4 x base rate), idle gap = 1/base: 4x apart.
    assert gaps.max() > 2.5 * gaps.min()
    assert rec["burst_factor"] == 4.0 and rec["n_bursts"] == 4


def test_diurnal_ramps_from_trough_to_peak():
    sched, _ = make_scenario_schedule("diurnal", 1000, 500.0, seed=1,
                                      amp=0.8, cycles=1)
    gaps = np.diff([a.t for a in sched])
    # Starts at the trough (sparse) and peaks mid-stream (dense).
    assert gaps[:20].mean() > 2.0 * gaps[len(gaps) // 2 - 10:
                                        len(gaps) // 2 + 10].mean()


def test_scenario_rejects_unknown_and_bad_knobs():
    with pytest.raises(ValueError):
        make_scenario_schedule("flashmob", 10, 100.0)
    with pytest.raises(ValueError):
        make_scenario_schedule("onoff", 10, 100.0, bogus=1)
    with pytest.raises(ValueError):
        make_scenario_schedule("onoff", 10, 100.0, burst_factor=1.0)
    with pytest.raises(ValueError):
        make_scenario_schedule("onoff", 10, 100.0, duty=0.0)
    with pytest.raises(ValueError):
        make_scenario_schedule("lognormal", 10, 100.0, sigma=0.0)
    with pytest.raises(ValueError):
        make_scenario_schedule("pareto", 10, 100.0, alpha=1.0)
    with pytest.raises(ValueError):
        make_scenario_schedule("diurnal", 10, 100.0, amp=1.0)


def test_trace_round_trip_is_exact():
    sched, _ = make_scenario_schedule("pareto", 60, 120.0, seed=2)
    trace = record_trace(sched)
    json.dumps(trace)                           # artifact-serializable
    assert trace_schedule(trace) == sched
    # Two different class defs under one name cannot be recorded.
    clash = [Arrival(t=0.0, frame_idx=0, klass=TrafficClass("rt")),
             Arrival(t=1.0, frame_idx=1,
                     klass=TrafficClass("rt", deadline_ms=5.0))]
    with pytest.raises(ValueError):
        record_trace(clash)


# ---------------------------------------------------------------------------
# Pacing / recovery reports
# ---------------------------------------------------------------------------


class _Handle:
    def __init__(self, t_submit):
        self.t_submit = t_submit


def test_pacing_report_measures_rate_and_lag():
    mix = (TrafficClass("rt"),)
    sched, _ = make_scenario_schedule("uniform", 11, 100.0, mix, seed=0)
    on_time = [_Handle(5.0 + a.t) for a in sched]       # offset cancels
    pr = pacing_report(sched, on_time)
    assert pr["rate_ratio"] == pytest.approx(1.0)
    assert pr["lag_ms_max"] == pytest.approx(0.0)
    slow = [_Handle(5.0 + 1.25 * a.t) for a in sched]   # 25% too slow
    pr = pacing_report(sched, slow)
    assert pr["rate_ratio"] == pytest.approx(0.8)
    assert pr["target_fps"] == pytest.approx(100.0)
    assert pr["achieved_fps"] == pytest.approx(80.0)
    assert pr["lag_ms_max"] == pytest.approx(25.0)
    with pytest.raises(ValueError):
        pacing_report(sched, on_time[:-1])
    short = pacing_report(sched[:1], on_time[:1])
    assert short["rate_ratio"] is None


class _Req:
    def __init__(self, t_submit, outcome, *, armed=True, late=False):
        self.t_submit = t_submit
        self.outcome = outcome
        self.deadline_s = (t_submit + 1.0) if armed else None
        self._late = late

    def missed_deadline(self):
        return (self.outcome in ("expired", "rejected_wait")
                or self._late)


def test_recovery_report_windows_and_recovery_point():
    reqs = [
        _Req(9.5, "completed"),
        _Req(9.7, "completed", armed=False),     # unarmed: ignored
        _Req(10.2, "failed"), _Req(10.4, "failed"),  # fault window
        _Req(10.6, "completed"),
        _Req(11.1, "completed"), _Req(11.5, "completed"),
        _Req(11.9, "expired"),
    ]
    rec = recovery_report(reqs, fault_t0=10.0, window_s=1.0,
                          miss_target=0.5)
    assert rec["armed_total"] == 7
    assert rec["pre_fault_armed"] == {"submitted": 1, "missed": 0}
    w0, w1 = rec["windows"]
    assert (w0["submitted"], w0["missed"]) == (3, 2)    # failed counts
    assert (w1["submitted"], w1["missed"]) == (3, 1)    # expired counts
    assert w0["miss_rate"] > 0.5 > w1["miss_rate"]
    assert rec["recovered_s"] == 2.0
    json.dumps(rec)
    # No fault ever fired: nothing to window.
    empty = recovery_report(reqs, fault_t0=None, window_s=1.0,
                            miss_target=0.5)
    assert empty["recovered_s"] is None and empty["windows"] == []


# ---------------------------------------------------------------------------
# The pinned acceptance scenario: kill one replica mid-stream
# ---------------------------------------------------------------------------


def test_kill_one_replica_mid_stream_recovers_without_hangs():
    """Kill replica 0 mid-stream at ~0.6x the sustainable per-replica
    load: zero requests hang, every affected request resolves
    ``failed``, the survivor absorbs the rest of the stream, the victim
    is quarantined after exactly ``quarantine_after`` sacrificed batches
    and later re-admitted by a probe, and the armed miss rate is back
    under the target within a measured recovery window."""
    delay_s, batch = 0.004, 8
    plan = FaultPlan(kill_at_batch=4, recover_at_batch=10)
    victim = ChaosExecutor(EchoExec(batch_size=batch, delay_s=delay_s),
                           plan)
    survivor = EchoExec(batch_size=batch, delay_s=delay_s)
    pool = ReplicaPool(executors=[victim, survivor], router_seed=0,
                       quarantine_after=3, probe_every=4)
    # Warm symmetric estimators: ties break to replica 0, so the victim
    # carries the stream until its plan kills it.
    pool.router.warm_start(delay_s, 2.0 * delay_s)
    fe = AsyncFrontend(pool, max_wait_ms=8.0, max_queue=1024)

    # One armed class, paced at 1200 fps against a ~2000 fps single-
    # replica service rate (batch/delay): ~0.6x the knee.
    mix = (TrafficClass("rt", priority=1, deadline_ms=1000.0),)
    n = 320
    sched, _ = make_scenario_schedule("uniform", n, 1200.0, mix, seed=5)
    frames = [np.full((2, 2, 1), i, np.float32) for i in range(n)]
    reqs = replay(fe, frames, sched, raise_failed=False)
    pacing = pacing_report(sched, reqs)
    fe.close()
    pool.close()

    st = fe.stats
    # Liveness headline: nothing hangs, everything resolves terminally.
    assert st.submitted == n
    assert st.hung == 0
    assert st.resolved == n
    assert st.completed + st.failed == n and st.expired == 0
    assert {r.outcome for r in reqs} == {"completed", "failed"}

    # Exactly quarantine_after live batches were sacrificed discovering
    # the death; the survivor never failed and absorbed the stream.
    counts = pool.replica_counts()
    assert counts[0]["failed_batches"] == 3
    assert counts[1]["failed_batches"] == 0
    assert st.failed == counts[0]["failed_frames"] > 0
    assert counts[1]["completed_batches"] >= 10
    router = pool.router
    assert router.quarantine_events == 1
    # The victim came back at wrapper batch 10: probes (not live
    # requests) discovered it and re-admitted it.
    assert router.readmissions == 1
    assert not router.is_quarantined(0)
    assert counts[0]["probe_batches"] >= 1
    assert victim.injected_failures >= 3        # 3 live + failed probes

    # Time-to-recover: the armed miss rate re-enters the target band
    # within the windowed report, and its miss counts reconcile exactly
    # with the frontend's failure count.
    rec = recovery_report(reqs, fault_t0=victim.t_first_fault,
                          window_s=0.05, miss_target=0.1)
    assert rec["recovered_s"] is not None
    assert rec["recovered_s"] <= 0.25
    missed = rec["pre_fault_armed"]["missed"] + \
        sum(w["missed"] for w in rec["windows"])
    assert missed == st.failed

    # The open loop actually drove the claimed rate.
    assert pacing["rate_ratio"] is not None
    assert 0.5 <= pacing["rate_ratio"] <= 1.5


# ---------------------------------------------------------------------------
# The same faults in the port's real PipelineExecutor (tiny CPU program)
# ---------------------------------------------------------------------------


def _tiny_program():
    from repro_torch.core import workload as W
    from repro_torch.core.program import compile_model
    from repro_torch.models import cnn
    m = W.CNNModel("tiny", 8, 3, (
        W.ConvLayer("c1", 3, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 8, 8, 3, groups=2),
        W.ConvLayer("fc", 8 * 4 * 4, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    return compile_model(
        m, cnn.params_from_numpy(cnn.init_params_np(m, 0), "cpu"), bits=8,
        calib_batch=calib, device="cpu")


def _frames(n, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 8, 8, 3)).astype(np.float32)


def test_install_stage_fault_kills_a_real_stage_mid_stream():
    """Stage 1 of a real two-stage pipeline dies on its third batch: the
    first two answer with the whole chain's logits, the third and every
    batch already behind it resolve through ``on_error`` with
    :class:`StageKilled`, and a later submit bounces."""
    prog = _tiny_program()
    frames = _frames(16)
    want = prog.compile_runner().logits(frames)
    px = PipelineExecutor(prog, stages=2, batch_size=4, output="logits")
    results, errors = {}, {}
    px.on_result = lambda tag, out: results.__setitem__(tag, out)
    px.on_error = lambda tag, exc: errors.__setitem__(tag, exc)
    wrapper = install_stage_fault(px, stage=1, at_call=3)
    try:
        for i in range(4):
            px.submit_batch(frames[4 * i:4 * i + 4], 4, tag=i)
        deadline = time.perf_counter() + 30
        while len(results) + len(errors) < 4 and \
                time.perf_counter() < deadline:
            time.sleep(0.01)
        assert sorted(results) == [0, 1]
        for i in (0, 1):
            np.testing.assert_array_equal(results[i],
                                          want[4 * i:4 * i + 4])
        assert sorted(errors) == [2, 3]
        assert isinstance(errors[2], StageKilled)
        assert wrapper.calls >= 3
        with pytest.raises(RuntimeError):
            px.submit_batch(frames[:4], 4, tag=9)
    finally:
        px.close()


def test_kill_one_of_two_real_replicas_mid_stream():
    """One of two real pipeline replicas is killed at its third batch
    behind the frontend: no request hangs, each resolves completed or
    failed, the survivor carries the rest, and every completed request
    holds the whole chain's logits for its own frame."""
    prog = _tiny_program()
    n = 96
    frames = _frames(n, seed=5)
    want = prog.compile_runner().logits(frames)
    reps = [PipelineExecutor(prog, stages=2, batch_size=4, output="logits")
            for _ in range(2)]
    victim = ChaosExecutor(reps[0], FaultPlan(kill_at_batch=3))
    pool = ReplicaPool(executors=[victim, reps[1]], router_seed=0,
                       quarantine_after=2, probe_every=4)
    pool.router.warm_start(0.004, 0.008)
    fe = AsyncFrontend(pool, max_wait_ms=5.0, max_queue=1024)
    mix = (TrafficClass("rt", priority=1, deadline_ms=5000.0),)
    sched, _ = make_scenario_schedule("uniform", n, 400.0, mix, seed=2)
    reqs = replay(fe, list(frames), sched, raise_failed=False)
    fe.close()
    pool.close()
    st = fe.stats
    assert st.submitted == n and st.hung == 0 and st.resolved == n
    assert st.completed + st.failed == n and st.failed > 0
    assert {r.outcome for r in reqs} <= {"completed", "failed"}
    for a, r in zip(sched, reqs):
        if r.outcome == "completed":
            np.testing.assert_array_equal(r.result(timeout=0),
                                          want[a.frame_idx])
    assert pool.replica_counts()[1]["failed_batches"] == 0
    rec = recovery_report(reqs, fault_t0=victim.t_first_fault,
                          window_s=0.05, miss_target=0.5)
    missed = rec["pre_fault_armed"]["missed"] + \
        sum(w["missed"] for w in rec["windows"])
    assert missed == st.failed
