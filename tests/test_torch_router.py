"""The port's replicated serving: the least-estimated-wait router (warm
pricing, seeded cold power-of-two-choices, straggler avoidance) and the
:class:`ReplicaPool` behind it — the reference's router tests with the
same assertions, on fake replicas and on a tiny program compiled on the
CPU from numpy weights. Routed replicated output must stay bit-identical
to the single-replica pipeline in both replica modes, per-replica outcome
counts must reconcile exactly with fleet totals, and for one seed the
router picks as the reference's does."""

import time

import numpy as np
import pytest
import torch

from repro.serving import LeastWaitRouter as RouterJ
from repro_torch.core import workload as W
from repro_torch.core.program import compile_model
from repro_torch.launch.mesh import device_slices
from repro_torch.models import cnn
from repro_torch.serving import LeastWaitRouter, ReplicaPool


def _tiny():
    """Small graph exercising every step kind (the shape of
    tests/test_serving.py's), compiled on the CPU from numpy weights."""
    m = W.CNNModel("tiny", 16, 4, (
        W.ConvLayer("c1", 4, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 8, 8, 3, groups=2),
        W.ConvLayer("fc", 8 * 8 * 8, 10, 1, kind="fc"),
    ))
    rng = np.random.default_rng(2)
    prog = compile_model(
        m, cnn.params_from_numpy(cnn.init_params_np(m, 0), "cpu"), bits=8,
        calib_batch=rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
        device="cpu")
    frames = rng.standard_normal((11, 16, 16, 4)).astype(np.float32)
    return prog, frames


class EchoExecutor:
    """Synchronous fake replica: optional fixed service delay, echoes
    the valid frames back as the batch output."""

    def __init__(self, batch_size=4, delay_s=0.0):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.on_result = None
        self.on_error = None
        self.batches = 0

    def submit_batch(self, frames, n_valid, tag=None):
        self.batches += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.on_result is not None:
            self.on_result(tag, np.asarray(frames)[:n_valid].copy())


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def test_router_rejects_bad_inputs():
    with pytest.raises(ValueError):
        LeastWaitRouter(0, 4)
    with pytest.raises(ValueError):
        LeastWaitRouter(2, 4, straggler_factor=1.0)
    with pytest.raises(ValueError):
        LeastWaitRouter(2, 4, quarantine_after=0)
    with pytest.raises(ValueError):
        LeastWaitRouter(2, 4, probe_every=0)


def test_warm_least_wait_picks_the_idle_replica():
    """Warm pricing: wait(r) = inflight*window + latency. A busy replica
    prices one queued batch higher than an idle one, so the idle replica
    wins; symmetric ties break to the lowest index."""
    router = LeastWaitRouter(2, 4, seed=0)
    router.warm_start(0.010, 0.020)
    assert router.estimated_wait_s(0) == pytest.approx(0.020)
    assert router.pick() == 0          # symmetric tie -> index 0
    # Replica 0 now holds one in-flight batch: 1*0.010 + 0.020 prices
    # above idle replica 1's bare latency.
    assert router.estimated_wait_s(0) == pytest.approx(0.030)
    assert router.pick() == 1
    assert router.inflight(0) == router.inflight(1) == 1
    # Drain replica 1, keep 0 busy: the idle replica wins again.
    router.on_complete(1, 0.020)
    assert router.pick() == 1
    assert router.cold_picks == 0


def test_warm_router_prices_out_a_drifting_replica():
    """A replica whose latency EWMA drifts up loses the argmin without
    any dedicated straggler machinery."""
    router = LeastWaitRouter(2, 4, seed=0)
    router.warm_start(0.010, 0.020)
    r = router.pick()
    assert r == 0
    router.on_complete(0, 0.500)       # 25x the calibrated latency
    for _ in range(5):
        r = router.pick()
        assert r == 1
        router.on_complete(1, 0.020)


def test_reset_pricing_relevels_a_starved_replica():
    """The starvation-hysteresis bug the chaos fault replays flushed
    out: a replica left with a stale high latency EWMA after a
    saturated calibration pass loses every warm argmin, gets no new
    observations, and — being neither quarantined nor (at R=2, where
    its own EWMA drags the fleet median) straggler-flagged — is starved
    forever. warm_start alone cannot fix it (measurements outrank
    seeds); reset_pricing + warm_start must re-level the fleet."""
    router = LeastWaitRouter(2, 4, seed=0)
    router.warm_start(0.010, 0.020)
    router.on_complete(0, 0.500)       # calibration left 0 mispriced
    router.on_complete(1, 0.020)
    assert not router.is_straggler(0)  # median includes the victim
    # warm_start defers to the stale measurement: still starved.
    router.warm_start(0.010, 0.020)
    picks = [router.pick() for _ in range(4)]
    assert 0 not in picks
    for r in picks:
        router.on_complete(r, 0.020)
    # The replay-boundary re-level restores the symmetric tie.
    router.reset_pricing()
    router.warm_start(0.010, 0.020)
    assert router.estimated_wait_s(0) == pytest.approx(0.020)
    assert router.pick() == 0
    assert router.pick() == 1


def test_reset_pricing_clears_quarantine_and_streaks():
    """reset_pricing is a replay boundary: health verdicts reset with
    the pricing (a fresh replay earns fresh verdicts), while in-flight
    accounting and cumulative telemetry survive."""
    router = LeastWaitRouter(2, 4, seed=0, quarantine_after=2)
    for _ in range(2):
        router.pick()
    router.on_failure(0)
    router.on_failure(0)
    # One batch still in flight on replica 1 across the boundary.
    assert router.is_quarantined(0)
    router.reset_pricing()
    assert not router.is_quarantined(0)
    assert router.snapshot()["replicas"][0]["consecutive_failures"] == 0
    assert router.inflight(1) == 1
    assert router.quarantine_events == 1


def test_cold_power_of_two_choices_is_seeded_deterministic():
    """No warm start -> every pick is a cold p2c draw from the seeded
    RNG: two routers with the same seed reproduce the exact sequence."""
    a = LeastWaitRouter(4, 4, seed=7)
    b = LeastWaitRouter(4, 4, seed=7)
    seq_a = [a.pick() for _ in range(10)]
    seq_b = [b.pick() for _ in range(10)]
    assert seq_a == seq_b
    assert a.cold_picks == 10
    assert sum(a.picks) == 10
    # p2c keeps depths near-balanced: no replica hoards the draw.
    assert max(a.picks) <= 2 * (10 // 4 + 1)


def test_straggler_flagged_and_excluded_from_cold_draws():
    """A replica whose latency EWMA exceeds straggler_factor x the fleet
    median is flagged and sits out cold draws while healthy replicas
    exist."""
    router = LeastWaitRouter(4, 4, seed=3)
    for r, lat in enumerate([0.010, 0.011, 0.012, 1.0]):
        router.estimators[r].observe(4, lat)
    assert not router.is_straggler(0)
    assert router.is_straggler(3)
    # Window channels were never seeded -> every pick is cold.
    picks = [router.pick() for _ in range(30)]
    assert 3 not in picks
    assert router.straggler_skips > 0
    snap = router.snapshot()
    assert snap["replicas"][3]["straggler"] is True
    assert snap["replicas"][3]["picks"] == 0


def test_single_replica_fast_path():
    router = LeastWaitRouter(1, 4, seed=0)
    assert [router.pick() for _ in range(5)] == [0] * 5
    assert router.inflight(0) == 5
    assert router.cold_picks == 0


# ---------------------------------------------------------------------------
# ReplicaPool over fake executors
# ---------------------------------------------------------------------------


def test_pool_rejects_bad_config():
    with pytest.raises(ValueError):
        ReplicaPool(executors=[])
    with pytest.raises(ValueError):
        ReplicaPool(None, replicas=2, mode="nope")
    with pytest.raises(ValueError):
        ReplicaPool(None, replicas=2)    # no program, no executors


def test_pool_routes_and_reconciles_over_fakes():
    """Submission order survives routing (drain reorders by sequence
    number) and the per-replica outcome rows reconcile exactly with the
    fleet totals."""
    exs = [EchoExecutor(batch_size=4), EchoExecutor(batch_size=4)]
    pool = ReplicaPool(executors=exs)
    frames = [np.full((2, 2, 1), i, np.float32) for i in range(10)]
    out = pool.serve(frames)
    pool.close()
    assert len(out) == 10
    for i, f in enumerate(out):
        np.testing.assert_array_equal(f, frames[i])
    counts = pool.replica_counts()
    assert sum(r["dispatched_batches"] for r in counts) == 3   # 4+4+2
    assert sum(r["completed_batches"] for r in counts) == 3
    assert sum(r["completed_frames"] for r in counts) == 10
    assert sum(r["failed_batches"] for r in counts) == 0
    assert sum(ex.batches for ex in exs) == 3
    assert pool.stats.frames == 10
    assert pool.stats.padded_frames == 2                       # tail 2/4
    rows = pool.replica_rows()
    assert [r["replica"] for r in rows] == [0, 1]
    for r in rows:
        assert r["picks"] == r["dispatched_batches"]
        assert r["inflight"] == 0


def test_slowed_straggler_replica_gets_measurably_fewer_batches():
    """A warm-started pool over one fast and one deliberately slow fake:
    the slow replica's latency EWMA rises on its first picks and the
    router routes the rest of the stream away from it."""
    slow = EchoExecutor(batch_size=4, delay_s=0.005)
    fast = EchoExecutor(batch_size=4, delay_s=0.0)
    pool = ReplicaPool(executors=[slow, fast], router_seed=0)
    pool.router.warm_start(0.001, 0.002)
    batch = np.zeros((4, 2, 2, 1), np.float32)
    n = 24
    for _ in range(n):
        pool.submit_batch(batch, 4)
    pool.drain()
    pool.close()
    counts = pool.replica_counts()
    assert counts[0]["completed_batches"] + \
        counts[1]["completed_batches"] == n
    # Measurably fewer: the slow replica serves at most a quarter of the
    # stream (deterministically it gets only the first tie-break pick).
    assert counts[0]["completed_batches"] < counts[1]["completed_batches"]
    assert counts[0]["completed_batches"] <= n // 4


def test_pool_failure_releases_router_slot_and_is_accounted():
    class FailingExecutor(EchoExecutor):
        def submit_batch(self, frames, n_valid, tag=None):
            raise RuntimeError("replica died")

    pool = ReplicaPool(executors=[FailingExecutor(batch_size=4)])
    with pytest.raises(RuntimeError):
        pool.submit_batch(np.zeros((4, 2, 2, 1), np.float32), 4)
    assert pool.router.inflight(0) == 0
    counts = pool.replica_counts()
    assert counts[0]["failed_batches"] == 1
    assert counts[0]["failed_frames"] == 4
    assert pool.drain() == []          # the failed batch cannot hang drain
    pool.close()


# ---------------------------------------------------------------------------
# Quarantine + probe re-admission (dead-replica bugfix)
# ---------------------------------------------------------------------------


def test_router_quarantines_after_repeated_hard_failures():
    """Repeated hard failures quarantine a replica out of *all* live
    picks (warm and cold) — the straggler flag covers slow, not dead —
    and a completed batch (probe success) re-admits it."""
    router = LeastWaitRouter(2, 4, seed=0, quarantine_after=3)
    router.warm_start(0.010, 0.020)
    assert not router.is_quarantined(0)
    for _ in range(3):
        router.on_failure(0)
    assert router.is_quarantined(0)
    assert router.quarantine_events == 1
    # Every live pick now lands on the survivor, warm pricing included
    # (the corpse's frozen estimator would otherwise keep it attractive).
    for _ in range(10):
        r = router.pick()
        assert r == 1
        router.on_complete(1, 0.020)
    snap = router.snapshot()
    assert snap["replicas"][0]["quarantined"] is True
    assert snap["replicas"][0]["consecutive_failures"] == 3
    # Probe success = proof of life: re-admitted, streak cleared.
    router.on_complete(0, 0.020)
    assert not router.is_quarantined(0)
    assert router.readmissions == 1
    assert router.snapshot()["replicas"][0]["consecutive_failures"] == 0


def test_router_all_quarantined_still_serves():
    """With every replica quarantined the router must keep picking
    (failing fast beats deadlocking the pool)."""
    router = LeastWaitRouter(2, 4, seed=0, quarantine_after=1)
    router.on_failure(0)
    router.on_failure(1)
    assert router.is_quarantined(0) and router.is_quarantined(1)
    assert router.pick() in (0, 1)


def test_probe_target_beats_and_feedback():
    """probe_target nominates a quarantined replica every probe_every-th
    call, only while idle; a failed probe keeps the quarantine, a
    successful one re-admits."""
    router = LeastWaitRouter(2, 4, seed=0, quarantine_after=2,
                             probe_every=3)
    assert router.probe_target() is None        # nothing injured: no tick
    router.on_failure(0)
    router.on_failure(0)
    assert router.is_quarantined(0)
    assert router.probe_target() is None        # tick 1
    assert router.probe_target() is None        # tick 2
    p = router.probe_target()                   # tick 3 -> probe due
    assert p == 0
    assert router.probe_picks == 1
    assert router.inflight(0) == 1              # probe holds a slot
    router.on_failure(0)                        # probe failed
    assert router.is_quarantined(0)
    for _ in range(2):
        assert router.probe_target() is None
    assert router.probe_target() == 0
    router.on_complete(0, 0.010)                # probe succeeded
    assert not router.is_quarantined(0)
    assert router.readmissions == 1


class FlakyExecutor(EchoExecutor):
    """Fake replica that hard-fails every dispatch in a batch-count
    window (its own 1-based counter), then recovers."""

    def __init__(self, dead_from=3, dead_to=8, **kw):
        super().__init__(**kw)
        self.dead_from, self.dead_to = dead_from, dead_to

    def submit_batch(self, frames, n_valid, tag=None):
        self.batches += 1
        if self.dead_from <= self.batches <= self.dead_to:
            raise RuntimeError("replica down")
        if self.on_result is not None:
            self.on_result(tag, np.asarray(frames)[:n_valid].copy())


def test_pool_kill_mid_stream_quarantines_steers_and_readmits():
    """The kill-mid-stream regression: a replica that dies mid-stream is
    quarantined after quarantine_after consecutive hard failures (before
    this fix the router kept picking the corpse forever), the survivor
    absorbs the stream, probe batches — not live requests — keep
    checking the victim, and the first probe success re-admits it."""
    victim = FlakyExecutor(batch_size=4, dead_from=3, dead_to=8)
    survivor = EchoExecutor(batch_size=4, delay_s=0.005)
    pool = ReplicaPool(executors=[victim, survivor], router_seed=0,
                       quarantine_after=3, probe_every=2)
    pool.router.warm_start(0.001, 0.002)
    batch = np.zeros((4, 2, 2, 1), np.float32)
    n, raised = 24, 0
    for _ in range(n):
        try:
            pool.submit_batch(batch, 4)
        except RuntimeError:
            raised += 1
    out = pool.drain()
    pool.close()
    router = pool.router
    counts = pool.replica_counts()
    # Exactly quarantine_after live batches were sacrificed to discover
    # the death; every later failure is a probe (invisible to callers).
    assert raised == 3
    assert counts[0]["failed_batches"] == 3
    assert counts[1]["failed_batches"] == 0
    assert router.quarantine_events == 1
    # The victim recovered (its fake comes back at batch 9): a probe
    # re-admitted it and live traffic returned to it.
    assert router.readmissions == 1
    assert not router.is_quarantined(0)
    assert counts[0]["probe_batches"] >= 2
    assert router.probe_picks == counts[0]["probe_batches"]
    assert counts[0]["completed_batches"] > 2   # pre-death + post-readmit
    # Liveness: every live batch resolved — completed or raised — and
    # probe outputs never leak into the drained results.
    assert sum(c["completed_batches"] for c in counts) + raised == n
    assert len(out) == (n - raised) * 4


# ---------------------------------------------------------------------------
# Straggler decay (degrade -> recover bugfix)
# ---------------------------------------------------------------------------


def test_straggler_flag_decays_when_ewma_reenters_band():
    """Degrade -> recover: a flagged straggler is excluded from cold
    draws, but probe completions keep feeding its EWMA, and once it
    re-enters band the (dynamic) flag clears and the replica rejoins the
    draw — before this fix an excluded replica got no observations and
    stayed excluded forever."""
    router = LeastWaitRouter(4, 4, seed=3, probe_every=4)
    for r, lat in enumerate([0.010, 0.011, 0.012, 1.0]):
        router.estimators[r].observe(4, lat)
    assert router.is_straggler(3)
    # Excluded from live cold draws...
    picks = [router.pick() for _ in range(12)]
    assert 3 not in picks
    # ...but probe_target still nominates it (the decay path): inflight
    # from the live picks above sits on 0..2, never 3.
    probed = [router.probe_target() for _ in range(4)]
    assert probed[:3] == [None, None, None] and probed[3] == 3
    router.on_complete(3, 0.011)
    # Recovery: fast probe completions walk the EWMA back into band.
    for _ in range(40):
        if not router.is_straggler(3):
            break
        p = None
        while p is None:
            p = router.probe_target()
        assert p == 3
        router.on_complete(3, 0.011)
    assert not router.is_straggler(3)
    # Back in the cold draw: the seeded p2c reaches it again.
    picks = [router.pick() for _ in range(40)]
    assert 3 in picks


def test_device_slices_contiguous_cover_and_wrap():
    devs = list("abcdefgh")
    sl = device_slices(3, devs)
    assert [len(s) for s in sl] == [3, 3, 2]
    assert [d for s in sl for d in s] == devs       # contiguous cover
    assert device_slices(4, ["x"]) == [["x"]] * 4   # wrap when R >= D
    with pytest.raises(ValueError):
        device_slices(0, devs)
    with pytest.raises(ValueError):
        device_slices(2, [])


# ---------------------------------------------------------------------------
# Bit-identity (the acceptance bar): routed replicas == single-jit chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pipeline", "stage-shard"])
def test_replicated_pool_bit_identical_both_modes(mode):
    """Routing only chooses *where* a micro-batch runs: the routed
    2-replica pool's output equals the single-jit chain bit for bit in
    both replica modes, tail padding included."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    with ReplicaPool(prog, replicas=2, mode=mode, stages=2, batch_size=4,
                     output="logits") as pool:
        got = np.stack(pool.serve(list(frames)))
    np.testing.assert_array_equal(got, want)
    assert pool.n_replicas == 2
    assert len(pool.replica_devices) == 2
    counts = pool.replica_counts()
    assert sum(r["completed_batches"] for r in counts) == 3    # 11/4
    assert sum(r["completed_frames"] for r in counts) == len(frames)
    assert pool.stats.padded_frames == 1


def test_device_slices_default_to_the_cuda_devices(monkeypatch):
    """Without a device list the slices cover the CUDA devices; with no
    GPU that raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_slices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert device_slices(2) == [[torch.device("cuda:0"),
                                 torch.device("cuda:1")],
                                [torch.device("cuda:2")]]


def test_router_picks_as_the_reference_does():
    """One seeded sequence of cold picks, completions (a slow replica, a
    failure streak into quarantine) and probes gives the reference's
    picks, flags and snapshot."""
    rj, rt = (cls(4, 4, seed=11, quarantine_after=2)
              for cls in (RouterJ, LeastWaitRouter))
    log_j, log_t = [], []
    for step in range(60):
        for r, log in ((rj, log_j), (rt, log_t)):
            p = r.pick()
            if step % 9 == 4:
                r.on_failure(p)
            else:
                r.on_complete(p, 0.004 * (3 if p == 2 else 1),
                              now=1.0 + 0.01 * step)
            log.append((p, r.probe_target(), r.is_straggler(2)))
    assert log_t == log_j
    assert rt.snapshot() == rj.snapshot()
