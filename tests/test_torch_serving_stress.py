"""Multi-producer stress lane for the port's QoS frontend and pipelined
executors (``stress`` marker, as the reference's
``tests/test_serving_stress.py``, whose tests these are, with the same
assertions).

8 submitter threads x 64 frames each against a deliberately slow fake
executor: no request may ever hang, each producer's results must come
back in its own submission order (per-producer FIFO), every request must
resolve to its *own* frame, and the FrontendStats outcome counts must
reconcile exactly with the submissions — completed + failed + expired
(+ rejected) == submitted, totals and per-class alike. The real-executor
cases run a tiny program compiled on the CPU from numpy weights."""

import threading
import time

import numpy as np
import pytest

from repro_torch.core import workload as W
from repro_torch.core.program import compile_model
from repro_torch.models import cnn
from repro_torch.serving import (AsyncFrontend, PipelineExecutor,
                                 ProgramRegistry, ReplicaPool,
                                 ServerConfig, ServiceTimeEstimator,
                                 TenantMux, build_server,
                                 install_stage_fault)

N_PRODUCERS = 8
N_FRAMES = 64

pytestmark = pytest.mark.stress


def _tiny_program():
    m = W.CNNModel("tiny", 16, 4, (
        W.ConvLayer("c1", 4, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 8, 8, 3, groups=2),
        W.ConvLayer("fc", 8 * 8 * 8, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(1).standard_normal(
        (2, 16, 16, 4)).astype(np.float32)
    return compile_model(
        m, cnn.params_from_numpy(cnn.init_params_np(m, 0), "cpu"), bits=8,
        calib_batch=calib, device="cpu")


class SlowEchoExecutor:
    """Deterministic fake: fixed service time per micro-batch, echoes
    each frame back as its result (so a request's payload identifies the
    frame it was answered with)."""

    def __init__(self, batch_size=16, delay_s=0.002):
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.program = None
        self.on_result = None
        self.on_error = None
        self.batches = 0

    def submit_batch(self, frames, n_valid, tag=None):
        self.batches += 1
        time.sleep(self.delay_s)
        if self.on_result:
            self.on_result(tag, [f.copy() for f in frames[:n_valid]])

    def flush_inflight(self):
        pass

    def reset_stats(self):
        pass

    def replica_counts(self):
        return None


def _frame(producer: int, i: int) -> np.ndarray:
    """A frame whose payload encodes (producer, sequence)."""
    return np.full((2, 2, 1), producer * 1000 + i, np.float32)


def _run_producers(fe, submit_one):
    """Spawn N_PRODUCERS threads, each submitting N_FRAMES requests via
    ``submit_one(producer, i)``; returns per-producer request lists."""
    reqs = [[None] * N_FRAMES for _ in range(N_PRODUCERS)]
    errors = []

    def producer(p):
        try:
            for i in range(N_FRAMES):
                reqs[p][i] = submit_one(p, i)
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors.append((p, e))

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(N_PRODUCERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "producer thread hung"
    assert not errors, f"producer raised: {errors}"
    return reqs


def test_multi_producer_no_hang_fifo_and_reconciled_stats():
    ex = SlowEchoExecutor(batch_size=16, delay_s=0.002)
    fe = AsyncFrontend(ex, max_wait_ms=20.0, max_queue=1024)
    reqs = _run_producers(
        fe, lambda p, i: fe.submit(_frame(p, i), timeout=30))

    # No request hangs: every one resolves inside a bounded wait.
    for p in range(N_PRODUCERS):
        for r in reqs[p]:
            assert r._event.wait(timeout=60), "request hung"
    fe.close()

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    # Exact reconciliation: all outcomes, no deadline traffic here.
    assert st.submitted == total
    assert st.completed == total
    assert st.failed == st.expired == st.rejected == 0
    assert st.resolved == total
    assert sum(cs.submitted for cs in st.classes.values()) == total
    assert sum(cs.completed for cs in st.classes.values()) == total

    for p in range(N_PRODUCERS):
        for i, r in enumerate(reqs[p]):
            # Every request got its own frame's answer...
            np.testing.assert_array_equal(
                np.asarray(r.result(timeout=1)),
                _frame(p, i))
            # ...with monotone timestamps through the frontend.
            assert r.t_submit <= r.t_batched <= r.t_dispatched <= r.t_done
        # Per-producer FIFO: a producer's requests are batched and
        # resolved in its own submission order (lanes are FIFO, batches
        # dispatch in pop order, the executor is FIFO).
        for a, b in zip(reqs[p], reqs[p][1:]):
            assert a.t_batched <= b.t_batched
            assert a.t_done <= b.t_done


def test_multi_producer_admission_control_reconciles():
    """8 producers flooding tight deadlines through estimated-wait
    admission: every request resolves to exactly one of
    completed | expired | rejected_wait (no hangs), the outcome counts
    reconcile exactly, and the hopeless tail is refused at submit (the
    flood queues far more work than a 150ms budget can absorb, so
    admission must fire)."""
    ex = SlowEchoExecutor(batch_size=16, delay_s=0.01)
    est = ServiceTimeEstimator()
    est.warm_start(16, ex.delay_s)
    fe = AsyncFrontend(ex, max_wait_ms=20.0, max_queue=1024,
                       estimator=est, admission_control=True,
                       flush_guard_ms=5.0)

    reqs = _run_producers(
        fe, lambda p, i: fe.submit(_frame(p, i), deadline_ms=150.0,
                                   timeout=30, klass=f"rt{p}"))
    for p in range(N_PRODUCERS):
        for r in reqs[p]:
            assert r._event.wait(timeout=60), "request hung"
    fe.close()

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    assert st.submitted == total
    assert st.failed == st.rejected == 0
    assert st.completed + st.expired + st.rejected_wait == total
    assert st.resolved == total
    # 512 frames = 32 batches x 10ms ~= 320ms of queued work against
    # 150ms budgets: the estimator must refuse part of the flood.
    assert st.rejected_wait > 0, \
        "admission never fired under a saturating flood"
    assert st.completed > 0
    # Per-class reconciliation and per-request terminal outcomes.
    assert sum(cs.submitted for cs in st.classes.values()) == total
    assert sum(cs.resolved for cs in st.classes.values()) == total
    for p in range(N_PRODUCERS):
        for i, r in enumerate(reqs[p]):
            assert r.outcome in ("completed", "expired", "rejected_wait")
            if r.outcome == "completed":
                np.testing.assert_array_equal(
                    np.asarray(r.result(timeout=1)), _frame(p, i))
            else:
                assert r.missed_deadline()


def test_multi_producer_mixed_deadlines_reconcile():
    """Same flood, but half the producers arm tight deadlines: expired
    requests must resolve (never hang) and the outcome counts still
    reconcile exactly — completed + expired == submitted."""
    ex = SlowEchoExecutor(batch_size=16, delay_s=0.005)
    fe = AsyncFrontend(ex, max_wait_ms=20.0, max_queue=1024)

    def submit_one(p, i):
        if p % 2 == 0:
            return fe.submit(_frame(p, i), timeout=30, klass="bulk")
        return fe.submit(_frame(p, i), priority=1, deadline_ms=150.0,
                         timeout=30, klass="rt")

    reqs = _run_producers(fe, submit_one)
    for p in range(N_PRODUCERS):
        for r in reqs[p]:
            assert r._event.wait(timeout=60), "request hung"
    fe.close()

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    assert st.submitted == total
    assert st.failed == st.rejected == 0
    assert st.completed + st.expired == total
    assert st.resolved == total
    bulk, rt = st.klass("bulk"), st.klass("rt")
    assert bulk.submitted == rt.submitted == total // 2
    assert bulk.expired == 0 and bulk.completed == bulk.submitted
    assert rt.completed + rt.expired == rt.submitted
    # Every rt request resolved one way or the other, with a value only
    # when completed.
    for p in range(1, N_PRODUCERS, 2):
        for i, r in enumerate(reqs[p]):
            assert r.outcome in ("completed", "expired")
            if r.outcome == "completed":
                np.testing.assert_array_equal(
                    np.asarray(r.result(timeout=1)), _frame(p, i))


def test_multi_producer_replica_pool_reconciles_exactly():
    """8 producers through the frontend over a routed 3-replica pool,
    with a concurrent ``stats_snapshot()`` reader hammering the stats
    lock the whole time: no request hangs, every request resolves to its
    own frame, no snapshot is ever torn (resolved > submitted), and the
    fleet totals reconcile *exactly* with the per-replica outcome rows —
    both the pool's lifetime counters and the frontend's close() delta."""
    exs = [SlowEchoExecutor(batch_size=16, delay_s=0.002)
           for _ in range(3)]
    pool = ReplicaPool(executors=exs, router_seed=11)
    fe = AsyncFrontend(pool, max_wait_ms=20.0, max_queue=1024)

    stop = threading.Event()
    torn: list[str] = []

    def snapshot_reader():
        while not stop.is_set():
            st = fe.stats_snapshot()
            resolved = (st.completed + st.failed + st.expired
                        + st.rejected + st.rejected_wait)
            if resolved > st.submitted:
                torn.append(f"resolved {resolved} > "
                            f"submitted {st.submitted}")
            time.sleep(0.0005)

    reader = threading.Thread(target=snapshot_reader)
    reader.start()
    try:
        reqs = _run_producers(
            fe, lambda p, i: fe.submit(_frame(p, i), timeout=30))
        for p in range(N_PRODUCERS):
            for r in reqs[p]:
                assert r._event.wait(timeout=60), "request hung"
        fe.close()
    finally:
        stop.set()
        reader.join(timeout=10)
    assert not reader.is_alive()
    assert torn == [], f"torn snapshots: {torn[:3]}"

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    assert st.submitted == total
    assert st.completed == total
    assert st.failed == st.expired == st.rejected == 0
    assert st.resolved == total
    for p in range(N_PRODUCERS):
        for i, r in enumerate(reqs[p]):
            np.testing.assert_array_equal(
                np.asarray(r.result(timeout=1)), _frame(p, i))

    # Exact fleet-vs-replica reconciliation, three ways: the pool's
    # lifetime rows, the frontend's close() delta, and the fakes' own
    # batch counters all agree.
    counts = pool.replica_counts()
    assert sum(r["completed_frames"] for r in counts) == total
    assert sum(r["dispatched_frames"] for r in counts) == total
    assert sum(r["failed_batches"] for r in counts) == 0
    assert sum(r["completed_batches"] for r in counts) == \
        sum(ex.batches for ex in exs)
    assert st.replicas, "frontend recorded no per-replica outcomes"
    assert sorted(st.replicas) == ["0", "1", "2"]
    for r, row in enumerate(st.replicas.values()):
        assert row == counts[r]
    # Routing spread the load: every replica served something.
    assert all(r["completed_batches"] > 0 for r in counts)
    pool.close()


def test_multi_producer_mixed_tenants_reconcile_per_tenant():
    """The 8-producer lane, multi-tenant: producers split across two
    tenants behind a :class:`TenantMux` of per-tenant fakes. No request
    hangs, every request resolves to its own frame through its own
    tenant's executor (batches are single-tenant by construction), and
    the per-tenant rollups reconcile exactly with the per-producer
    submissions — no cross-tenant leakage in either direction."""
    exs = {"a": SlowEchoExecutor(batch_size=16, delay_s=0.002),
           "b": SlowEchoExecutor(batch_size=16, delay_s=0.004)}
    mux = TenantMux(exs, batch_size=16)
    fe = AsyncFrontend(mux, max_wait_ms=20.0, max_queue=1024)

    def submit_one(p, i):
        return fe.submit(_frame(p, i), tenant="a" if p % 2 == 0 else "b",
                         timeout=30)

    reqs = _run_producers(fe, submit_one)
    for p in range(N_PRODUCERS):
        for r in reqs[p]:
            assert r._event.wait(timeout=60), "request hung"
    fe.close()
    mux.close()

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    assert st.submitted == total
    assert st.completed == total
    assert st.failed == st.expired == st.rejected == 0
    # Per-tenant reconciliation: each tenant's rollup counts exactly its
    # producers' submissions, and together they cover everything.
    ta, tb = st.tenant_row("a"), st.tenant_row("b")
    assert ta.submitted == tb.submitted == total // 2
    assert ta.completed == tb.completed == total // 2
    assert ta.failed == tb.failed == 0
    # Batches never mixed tenants: each fake served exactly its own
    # tenant's frames (payloads encode the producer, producers encode
    # the tenant).
    for p in range(N_PRODUCERS):
        for i, r in enumerate(reqs[p]):
            np.testing.assert_array_equal(
                np.asarray(r.result(timeout=1)), _frame(p, i))
    assert exs["a"].batches > 0 and exs["b"].batches > 0


def test_stage_death_mid_batch_resolves_every_request():
    """Chaos x stress: a *real* two-stage PipelineExecutor whose stage-1
    worker dies mid-batch (injected by :func:`install_stage_fault`) under the
    full 8-producer flood. The liveness contract must hold through the
    death: every request resolves to completed | failed (no deadlines
    armed, so nothing may expire), the outcome counts reconcile exactly,
    the batches that cleared stage 1 before the fault completed with
    real answers, everything after resolves failed — and no producer or
    request ever hangs."""
    prog = _tiny_program()

    px = PipelineExecutor(prog, stages=2, batch_size=4)
    # Stage 1 dies from its 6th micro-batch on: exactly 5 batches make
    # it through the whole pipeline, everything else must fail cleanly
    # (in-flight batches through on_error, later submits synchronously).
    wrapper = install_stage_fault(px, stage=1, at_call=6)
    px.start()
    fe = AsyncFrontend(px, max_wait_ms=10.0, max_queue=4096)

    def frame16(producer, i):
        return np.full((16, 16, 4), (producer * 64 + i) % 7, np.float32)

    reqs = _run_producers(
        fe, lambda p_, i: fe.submit(frame16(p_, i), timeout=60))
    for prod in range(N_PRODUCERS):
        for r in reqs[prod]:
            assert r._event.wait(timeout=60), "request hung"
    fe.close()
    px.close()

    total = N_PRODUCERS * N_FRAMES
    st = fe.stats
    assert st.submitted == total
    assert st.hung == 0
    assert st.resolved == total
    # Exact reconciliation under the fault: completed + failed covers
    # everything (no deadlines => no expiry, queue ample => no rejects).
    assert st.completed + st.failed == total
    assert st.expired == st.rejected == st.rejected_wait == 0
    # The fault actually fired, after exactly 5 clean stage-1 batches.
    assert wrapper.calls >= 6
    assert 0 < st.completed <= 5 * px.batch_size
    assert st.failed == total - st.completed
    for prod in range(N_PRODUCERS):
        for r in reqs[prod]:
            assert r.outcome in ("completed", "failed")
            if r.outcome == "completed":
                # A real traversal: top-1 class id out of the tiny CNN.
                assert int(np.asarray(r.result(timeout=1))) in range(10)


def test_mid_stream_rescale_resolves_every_request():
    """Elastic x stress: a *real* one-model server (tiny CNN, 2-stage
    pipeline) under the full 8-producer flood while ``Server.rescale``
    performs a live drain -> swap -> resume to 2 replicas mid-stream.
    The zero-loss contract must hold across the swap: no producer or
    request hangs, nothing is rejected because of the rescale, every
    request resolves, outcome counts reconcile exactly, each producer's
    requests are batched in its own submission order — and a
    deadline-armed probe phase after the swap completes cleanly (armed
    miss recovered on the rescaled fleet)."""
    prog = _tiny_program()

    reg = ProgramRegistry()
    reg.register("tiny", prog)
    srv = build_server(reg, ServerConfig(batch=4, stages=2, replicas=1))
    fe = srv.open_frontend(400.0)
    event = {}
    rescale_errs: list[BaseException] = []

    def rescaler():
        # Let the flood establish itself, then swap under it. The
        # compile + calibration happens while the old executor serves;
        # only the drain/swap window pauses dispatch.
        time.sleep(0.2)
        try:
            event.update(srv.rescale("tiny", replicas=2))
        except BaseException as e:  # surfaced after join
            rescale_errs.append(e)

    def frame16(producer, i):
        return np.full((16, 16, 4), (producer * 64 + i) % 7, np.float32)

    t = threading.Thread(target=rescaler, name="rescaler")
    t.start()
    try:
        reqs = _run_producers(
            fe, lambda p_, i: fe.submit(frame16(p_, i), timeout=120))
        for prod in range(N_PRODUCERS):
            for r in reqs[prod]:
                assert r._event.wait(timeout=120), "request hung"
    finally:
        t.join(timeout=120)
    assert not t.is_alive(), "rescale hung"
    assert not rescale_errs, f"rescale raised: {rescale_errs}"

    # The swap happened mid-stream and is fully recorded.
    assert event["before"]["replicas"] == 1
    assert event["after"]["replicas"] == 2
    assert event["swapped_frontends"] >= 1
    assert getattr(srv.runtime("tiny").executor, "n_replicas", 1) == 2

    # Armed probe on the rescaled fleet: a full batch of requests with
    # an ample deadline must all complete — the estimator was rewarmed
    # from the *new* plan's calibration, so admission must not refuse
    # them and nothing may expire or arrive late.
    probes = [fe.submit(frame16(0, i), deadline_ms=10_000.0,
                        klass="post-swap", timeout=120)
              for i in range(8)]
    for r in probes:
        assert r._event.wait(timeout=120), "post-swap probe hung"
    fe.close()

    total = N_PRODUCERS * N_FRAMES + len(probes)
    st = fe.stats
    assert st.submitted == total
    assert st.hung == 0
    assert st.resolved == total
    # A rescale never rejects or fails a request: everything completed.
    assert st.completed == total
    assert st.failed == st.expired == st.rejected == st.rejected_wait == 0
    post = st.klass("post-swap")
    assert post.submitted == len(probes)
    assert post.completed == len(probes)
    assert post.late == 0, "armed miss did not recover post-swap"
    for prod in range(N_PRODUCERS):
        for r in reqs[prod]:
            # Real traversals on both executors: top-1 out of the CNN.
            assert int(np.asarray(r.result(timeout=1))) in range(10)
        # Per-producer FIFO held across the swap: lanes stay FIFO and
        # the parked batch re-dispatches before anything newer. (Done
        # order is not asserted — post-swap batches route across 2
        # replicas and may legally interleave.)
        for a, b in zip(reqs[prod], reqs[prod][1:]):
            assert a.t_batched <= b.t_batched
    srv.close()
