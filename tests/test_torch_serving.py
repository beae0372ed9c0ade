"""The port's stage-pipelined serving subsystem
(``repro_torch.serving.{partition,pipeline_executor}``,
``core/executor.py``'s frontend slots), held against the reference's on
the same numpy weights and frames:

* the reference's ``tests/test_serving.py`` with the same assertions —
  partition invariants, K-stage bit-identity with the whole-chain
  ``compile_runner`` (a stage boundary mid-conv-block, the K=1 case, a
  padded tail), placement, thread-safe multi-producer execution, and the
  async frontend's edge cases;
* the K-stage pipeline against the reference's K-stage pipeline, bit for
  bit, on the tiny and two-block graphs and on reduced AlexNet and VGG16,
  for every route;
* the executor protocol slots (``submit_batch``, ``flush_inflight``,
  ``on_result``, ``reset_stats``, ``replica_counts``) and the device pin's
  weight copies.

Tensors stay on the CPU, where each kernel wrapper runs its plain
version; the card runs the same paths in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""

import dataclasses
import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as prog_j
from repro.core import workload as Wj
from repro.serving import PipelineExecutor as PipelineJ
from repro.serving import partition_program as partition_program_j
from repro_torch.core import program as prog_t
from repro_torch.core import workload as Wt
from repro_torch.core.executor import EngineExecutor
from repro_torch.models import cnn as cnn_t
from repro_torch.serving import (AsyncFrontend, Executor, PipelineExecutor,
                                 ReplicaPool, partition_program,
                                 stage_devices, step_cycles)
from test_torch_program import REDUCED

ROUTES = ("f32", "oracle", "kernel")


def _tiny_layers(L):
    """Small graph exercising every step kind: conv stem, pool, grouped
    conv, fc head (the reference's ``tests/test_serving.py`` graph)."""
    return L.CNNModel("tiny", 16, 4, (
        L.ConvLayer("c1", 4, 8, 3),
        L.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        L.ConvLayer("c2", 8, 8, 3, groups=2),
        L.ConvLayer("fc", 8 * 8 * 8, 10, 1, kind="fc"),
    ))


def _two_block_layers(L):
    """Two conv *blocks* (conv-conv-pool twice) so a cut can land
    mid-block, between two convs that share a block."""
    return L.CNNModel("twoblock", 16, 3, (
        L.ConvLayer("c1_1", 3, 8, 3),
        L.ConvLayer("c1_2", 8, 8, 3),
        L.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        L.ConvLayer("c2_1", 8, 16, 3),
        L.ConvLayer("c2_2", 16, 16, 3),
        L.ConvLayer("p2", 16, 16, 2, stride=2, kind="pool"),
        L.ConvLayer("fc", 16 * 4 * 4, 10, 1, kind="fc"),
    ))


GRAPHS = {"tiny": (_tiny_layers, 0, 11),
          "two_block": (_two_block_layers, 3, 7),
          "alexnet": (REDUCED["alexnet"], 5, 5),
          "vgg16": (REDUCED["vgg16"], 6, 5)}


@functools.lru_cache(maxsize=None)
def _both(name):
    """The reference's and the port's program of one graph, compiled from
    the same numpy weights (nonzero biases) and calibration batch, and
    frames made from the same seed."""
    layers, seed, n = GRAPHS[name]
    mj, mt = layers(Wj), layers(Wt)
    params = cnn_t.init_params_np(mt, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for p in params.values():
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32)
    shape = (mt.input_hw, mt.input_hw, mt.input_ch)
    calib = rng.standard_normal((2, *shape)).astype(np.float32)
    frames = rng.standard_normal((n, *shape)).astype(np.float32)
    pj = prog_j.compile_model(
        mj, {k: {kk: jnp.asarray(v) for kk, v in p.items()}
             for k, p in params.items()},
        bits=8, calib_batch=jnp.asarray(calib))
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              bits=8, calib_batch=calib, device="cpu")
    return pj, pt, frames


def _tiny():
    _, pt, frames = _both("tiny")
    return pt, frames


def _two_block():
    _, pt, frames = _both("two_block")
    return pt, frames


@functools.lru_cache(maxsize=None)
def _reference_pipeline(name, stages, route):
    """The reference's K-stage pipeline output (logits) on the graph's
    frames, batch 4."""
    pj, _, frames = _both(name)
    with PipelineJ(pj, stages=stages, batch_size=4, route=route,
                   interpret=True, output="logits") as px:
        return np.stack(px.serve(list(frames)))


# ---------------------------------------------------------------------------
# Against the reference's pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["tiny", "two_block", "alexnet", "vgg16"])
def test_pipeline_matches_the_reference_pipeline(name, route):
    """The port's K-stage pipeline equals the port's whole chain and the
    reference's K-stage pipeline (same route, the Pallas kernel in
    interpret mode on the kernel route) bit for bit, with the same
    partition, for every K the graph takes up to 4; the padded tail
    batch included."""
    pj, pt, frames = _both(name)
    n_compute = sum(s.kind != "pool" for s in pt.steps)
    want = _reference_pipeline(name, 2, route)
    np.testing.assert_array_equal(
        pt.compile_runner(route=route).logits(frames), want)
    for k in range(1, min(4, n_compute) + 1):
        with PipelineExecutor(pt, stages=k, batch_size=4, route=route,
                              output="logits") as px:
            got = np.stack(px.serve(list(frames)))
        np.testing.assert_array_equal(got, want, err_msg=f"K={k}")
        assert px.partition.boundaries == \
            partition_program_j(pj, k).boundaries
        assert px.stats.padded_frames == -len(frames) % 4


def test_top1_matches_the_reference_pipeline():
    pj, pt, frames = _both("alexnet")
    with PipelineJ(pj, stages=2, batch_size=4, route="f32") as px:
        want = np.asarray(px.serve(list(frames)))
    with PipelineExecutor(pt, stages=2, batch_size=4) as px:
        got = np.asarray(px.serve(list(frames)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Placement and the device pin
# ---------------------------------------------------------------------------


def test_stage_devices_round_robin(monkeypatch):
    """Placement policy: stage i -> devices[i % n], default the CUDA
    devices (raising without one), bad inputs refused."""
    cpu = torch.device("cpu")
    assert stage_devices(3, [cpu]) == [cpu] * 3
    fake = ["d0", "d1"]
    assert stage_devices(5, fake) == ["d0", "d1", "d0", "d1", "d0"]
    with pytest.raises(ValueError):
        stage_devices(0, fake)
    with pytest.raises(ValueError):
        stage_devices(2, [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_devices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert stage_devices(3) == [torch.device("cuda:0")] * 3


def test_placed_runner_device_pin_single_runner():
    """compile_stage_runner(device=...) runs on the pinned device and
    stays bit-identical to the unpinned runner; the program's own device
    copies no weights."""
    prog, frames = _tiny()
    cpu = torch.device("cpu")
    pinned = prog.compile_stage_runner(0, len(prog.steps), device=cpu)
    plain = prog.compile_runner()
    np.testing.assert_array_equal(pinned.logits(frames), plain.logits(frames))
    out = pinned(pinned.quantize(frames[:4]))
    assert out.device == cpu and pinned.device == cpu
    assert prog.steps_on(cpu) is prog.steps
    assert not prog._placed


def test_steps_on_another_device_copy_once_and_stay_k_major():
    """A stage on another device gets its steps' tensors copied there once
    (cached per device), ``wk`` remade K-major from the copied ``wq``."""
    _, pt, _ = _both("two_block")
    prog = dataclasses.replace(pt)          # a fresh placement cache
    meta = prog.steps_on("meta")
    assert prog.steps_on(torch.device("meta")) is meta
    for src, st in zip(prog.steps, meta):
        assert (st.name, st.kind) == (src.name, src.kind)
        if st.kind == "pool":
            continue
        for t in (st.wq, st.wk, st.bias_q, st.shift):
            assert t.device.type == "meta"
        assert st.wk.shape == src.wk.shape
        assert st.wk.stride() == src.wk.stride()
    runner = prog.compile_stage_runner(1, 3, device="meta")
    assert runner.device == torch.device("meta")


def test_same_device():
    same = prog_t.same_device
    assert same("cpu", torch.device("cpu"))
    assert not same("cpu", "meta")
    assert same("cuda:1", "cuda:1") and not same("cuda:0", "cuda:1")


# ---------------------------------------------------------------------------
# The executor protocol slots
# ---------------------------------------------------------------------------


def test_engine_executor_protocol_slots():
    """``submit_batch`` with a tag delivers through ``on_result`` when
    the batch is collected (``flush_inflight``), untagged batches go to
    ``drain``; ``reset_stats`` refuses work in flight; the single chain
    is no replica fleet."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    got = {}
    ex = EngineExecutor(prog, batch_size=4, output="logits",
                        on_result=lambda tag, out: got.setdefault(tag, out))
    assert isinstance(ex, Executor) and ex.on_error is None
    assert ex.replica_counts() is None
    ex.submit_batch(frames[:4], 4, tag="a")
    ex.submit_batch(frames[4:6], 2, tag="b")     # padded to the batch
    ex.flush_inflight()
    np.testing.assert_array_equal(got["a"], want[:4])
    np.testing.assert_array_equal(got["b"], want[4:6])
    assert (ex.stats.batches, ex.stats.frames, ex.stats.padded_frames) == \
        (2, 6, 2)
    ex.submit(frames[6])
    with pytest.raises(RuntimeError):
        ex.reset_stats()                         # a pending frame
    np.testing.assert_array_equal(np.stack(ex.drain()), want[6:7])
    ex.reset_stats()
    assert ex.stats.batches == 0 and ex.stats._first_n == 4


def test_every_executor_conforms_to_the_protocol():
    prog, _ = _tiny()
    with PipelineExecutor(prog, stages=2, batch_size=4) as px, \
            ReplicaPool(prog, replicas=2, stages=1, batch_size=4) as pool:
        for ex in (EngineExecutor(prog, batch_size=4), px, pool):
            assert isinstance(ex, Executor), type(ex).__name__
        assert px.replica_counts() is None
        assert len(pool.replica_counts()) == 2


def test_pipeline_counts_every_batch_it_runs():
    """``batches_run`` counts every micro-batch over the executor's life,
    across drains and ``reset_stats``."""
    prog, frames = _tiny()
    with PipelineExecutor(prog, stages=2, batch_size=4) as px:
        px.serve(list(frames))                   # 3 batches
        px.reset_stats()
        px.serve(list(frames[:4]))               # 1 more
        assert px.batches_run == 4 and px.stats.batches == 1
    with ReplicaPool(prog, replicas=2, stages=2, batch_size=4) as pool:
        pool.warmup(list(frames[:4]))            # one batch a replica
        pool.serve(list(frames))
        assert pool.batches_run == 2 + 3


def test_pipelined_serving_is_exact_under_many_producers():
    """Four producer threads submitting into one K=3 pipeline through the
    frontend: every request resolves to its own frame's exact logits."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    with PipelineExecutor(prog, stages=3, batch_size=4,
                          output="logits") as px:
        fe = AsyncFrontend(px, max_wait_ms=5.0)
        results = [None] * len(frames)

        def client(idx):
            for i in idx:
                results[i] = fe.submit(frames[i]).result(timeout=120)

        threads = [threading.Thread(target=client,
                                    args=(range(j, len(frames), 4),))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        fe.close()
    np.testing.assert_array_equal(np.stack(results), want)


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------


def test_partition_invariants():
    """Contiguous cover, modeled cycles conserved, balance in (0, 1],
    bottleneck monotone non-increasing in K (more stages never model
    slower), pools never lead a stage."""
    prog, _ = _two_block()
    total = sum(step_cycles(prog.allocs).values())
    prev_bottleneck = float("inf")
    for k in range(1, 6):
        part = partition_program(prog, k)
        assert part.boundaries[0] == 0
        assert part.boundaries[-1] == len(prog.steps)
        assert list(part.boundaries) == sorted(set(part.boundaries))
        assert part.n_stages == k
        assert sum(part.stage_cycles) == pytest.approx(total)
        assert 0 < part.balance <= 1 + 1e-12
        assert part.bottleneck <= prev_bottleneck + 1e-9
        prev_bottleneck = part.bottleneck
        for b, e in part.stage_ranges()[1:]:
            assert prog.steps[b].kind != "pool"


def test_partition_rejects_bad_stage_counts():
    prog, _ = _tiny()
    with pytest.raises(ValueError):
        partition_program(prog, 0)
    with pytest.raises(ValueError):
        partition_program(prog, 4)  # only 3 compute steps
    plan_only = prog_t.compile_model(Wt.CNN_MODELS["alexnet"](), theta=900,
                                     bits=8, device="cpu")
    with pytest.raises(ValueError):
        partition_program(plan_only, 2)


# ---------------------------------------------------------------------------
# Stage runners + pipelined bit-identity
# ---------------------------------------------------------------------------


def test_stage_runner_chain_bit_identical_all_routes():
    """Chaining compile_stage_runner ranges reproduces compile_runner
    exactly for every MAC lowering — int8 activations are the stage
    boundary contract."""
    prog, frames = _tiny()
    for route in ("f32", "oracle", "kernel"):
        full = prog.compile_runner(route=route)
        want = full.logits(frames[:4])
        first = prog.compile_stage_runner(0, 2, route=route)
        second = prog.compile_stage_runner(2, 4, route=route)
        mid = first(first.quantize(frames[:4]))
        assert mid.dtype == torch.int8            # int8 across the cut
        got = second.dequantize(second(mid))
        np.testing.assert_array_equal(got, want)


def test_stage_runner_end_guards():
    """Host-side quantize/dequantize exist only at the matching chain
    ends; out-of-range stages are refused."""
    prog, frames = _tiny()
    inner = prog.compile_stage_runner(1, 3)
    with pytest.raises(ValueError):
        inner.quantize(frames[:1])
    with pytest.raises(ValueError):
        inner.dequantize(np.zeros((1, 10)))
    with pytest.raises(ValueError):
        prog.compile_stage_runner(2, 2)
    with pytest.raises(ValueError):
        prog.compile_stage_runner(0, 99)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_pipelined_bit_identical(stages):
    """K-stage pipelined serving == the whole chain, bit for bit,
    including the K=1 degenerate case and a padded tail batch."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    with PipelineExecutor(prog, stages=stages, batch_size=4,
                          output="logits") as px:
        got = np.stack(px.serve(list(frames)))
    np.testing.assert_array_equal(got, want)
    assert px.stats.frames == len(frames)
    assert px.stats.padded_frames == 1
    # top1 path too
    with PipelineExecutor(prog, stages=stages, batch_size=4) as px:
        ids = px.serve(list(frames))
    np.testing.assert_array_equal(
        np.asarray(ids), np.argmax(want.reshape(len(frames), -1), -1))


def test_pipelined_mid_block_boundary_bit_identical():
    """A stage cut landing *inside* a conv block (between two convs that
    share a block, and one where a pool leads the next stage) stays
    bit-identical — the boundary contract is any step edge."""
    prog, frames = _two_block()
    want = prog.compile_runner().logits(frames)
    n = len(prog.steps)
    for bounds in [(0, 2, n),      # cut after c1_2 (mid-structure)
                   (0, 1, n),      # cut between c1_1 and c1_2: mid-block
                   (0, 4, n),      # cut between c2_1 and c2_2: mid-block
                   (0, 1, 4, n)]:  # both mid-block cuts at once
        with PipelineExecutor(prog, stages=len(bounds) - 1, batch_size=4,
                              boundaries=bounds, output="logits") as px:
            got = np.stack(px.serve(list(frames)))
        np.testing.assert_array_equal(got, want, err_msg=str(bounds))


@pytest.mark.parametrize("route", ["f32", "oracle", "kernel"])
def test_placed_stage_runners_bit_identical_all_routes(route):
    """--place-stages determinism: with every stage pinned to a device
    (all the same one on the CPU), K in {1, 2, 4} placed
    pipelines stay bit-identical to the whole-chain compile_runner on
    every MAC route — placement moves buffers, never arithmetic."""
    prog, frames = _two_block()
    want = prog.compile_runner(route=route).logits(frames)
    for k in (1, 2, 4):
        with PipelineExecutor(prog, stages=k, batch_size=4, route=route,
                              place_stages=True, output="logits") as px:
            got = np.stack(px.serve(list(frames)))
        np.testing.assert_array_equal(got, want, err_msg=f"K={k}")
        assert len(px.stage_devices) == k
        assert all(d is not None for d in px.stage_devices)


def test_pipeline_reuse_across_drains():
    """Workers survive drain(); a second stream through the same
    pipeline stays correct (the port compiles nothing per shape:
    ``cache_size`` is -1)."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    with PipelineExecutor(prog, stages=2, batch_size=4,
                          output="logits") as px:
        got1 = np.stack(px.serve(list(frames)))
        got2 = np.stack(px.serve(list(frames[:5])))
        assert all(r.cache_size() in (1, -1) for r in px.runners)
    np.testing.assert_array_equal(got1, want)
    np.testing.assert_array_equal(got2, want[:5])


def test_pipeline_rejects_bad_boundaries():
    prog, _ = _tiny()
    with pytest.raises(ValueError):
        PipelineExecutor(prog, stages=2, boundaries=(0, 4))       # wrong len
    with pytest.raises(ValueError):
        PipelineExecutor(prog, stages=2, boundaries=(1, 2, 4))    # no 0
    with pytest.raises(ValueError):
        PipelineExecutor(prog, stages=2, boundaries=(0, 2, 3))    # short


# ---------------------------------------------------------------------------
# Thread safety (the frontend's contract with EngineExecutor)
# ---------------------------------------------------------------------------


def _match_rows(got: np.ndarray, want: np.ndarray) -> None:
    """Every produced row must be exactly one expected row, each expected
    row consumed once (submission order across threads is arbitrary)."""
    assert got.shape == want.shape
    used = np.zeros(len(want), bool)
    for row in got:
        hit = np.nonzero((want == row).all(axis=1) & ~used)[0]
        assert hit.size > 0, "result row matches no unconsumed expectation"
        used[hit[0]] = True
    assert used.all()


def test_engine_executor_multi_producer_submit():
    """Concurrent submit() from several threads: no frame lost or
    corrupted through the shared pending buffer and tail padding."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    ex = EngineExecutor(prog, batch_size=4, output="logits")
    chunks = [frames[0:3], frames[3:7], frames[7:11]]
    threads = [threading.Thread(target=ex.submit, args=(c,))
               for c in chunks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = np.stack(ex.drain())
    _match_rows(got, want)
    assert ex.stats.frames == len(frames)


def test_frontend_over_engine_executor_multi_producer():
    """Many client threads -> AsyncFrontend -> thread-safe EngineExecutor:
    every request resolves to its own frame's exact logits."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames)
    ex = EngineExecutor(prog, batch_size=4, output="logits")
    fe = AsyncFrontend(ex, max_wait_ms=30.0)
    results = [None] * len(frames)

    def client(i):
        results[i] = fe.submit(frames[i]).result(timeout=120)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fe.close()
    for i, r in enumerate(results):
        np.testing.assert_array_equal(np.asarray(r), want[i])
    assert fe.stats.completed == len(frames)
    assert not np.isnan(fe.stats.latency_percentiles()["p99"])


# ---------------------------------------------------------------------------
# Frontend edge cases
# ---------------------------------------------------------------------------


def test_frontend_empty_stream():
    """Close with zero submissions: no hang, clean stats, submit-after-
    close refused."""
    prog, _ = _tiny()
    with PipelineExecutor(prog, stages=2, batch_size=4) as px:
        fe = AsyncFrontend(px)
        fe.close()
        assert fe.stats.submitted == 0
        assert fe.stats.completed == 0
        assert fe.stats.fps == 0.0
        assert np.isnan(fe.stats.latency_percentiles()["p50"])
        with pytest.raises(RuntimeError):
            fe.submit(np.zeros((16, 16, 4), np.float32))


def test_frontend_single_frame_flush_by_timeout():
    """One lone frame must be answered after ~max_wait_ms, not parked
    waiting for a full batch."""
    prog, frames = _tiny()
    want = prog.compile_runner().logits(frames[:1])
    with PipelineExecutor(prog, stages=2, batch_size=4,
                          output="logits") as px:
        px.serve(list(frames[:4]))          # warm the stage jits
        fe = AsyncFrontend(px, max_wait_ms=10.0)
        req = fe.submit(frames[0])
        out = req.result(timeout=60)
        fe.close()
    np.testing.assert_array_equal(out, want[0])
    assert fe.stats.flushes_timeout == 1
    assert fe.stats.flushes_full == 0
    assert req.latency_s is not None and req.latency_s >= 0.010 * 0.5


def test_frontend_backpressure_bounded_queue():
    """A full submission queue blocks, and queue.Full surfaces when the
    caller's timeout expires (stub executor that never completes until
    released, so the test is deterministic)."""
    import queue as queue_mod

    release = threading.Event()

    class StallExecutor:
        batch_size = 2
        program = None
        on_result = None
        on_error = None

        def submit_batch(self, frames, n_valid, tag=None):
            release.wait(timeout=30)
            if self.on_result:
                self.on_result(tag, np.zeros((n_valid, 1)))

        def flush_inflight(self):
            pass

        def reset_stats(self):
            pass

        def replica_counts(self):
            return None

    ex = StallExecutor()
    fe = AsyncFrontend(ex, max_wait_ms=5.0, max_queue=2)
    f = np.zeros((4, 4, 1), np.float32)
    reqs = [fe.submit(f) for f in [f] * 2]      # first batch stalls
    time.sleep(0.05)                             # batcher picks them up
    reqs += [fe.submit(f) for f in [f] * 2]      # fills the queue
    with pytest.raises(queue_mod.Full):
        fe.submit(f, timeout=0.05)
    release.set()
    for r in reqs:
        r.result(timeout=30)
    fe.close()
    assert fe.stats.completed == fe.stats.submitted == 4


def test_frontend_resolves_requests_on_executor_failure():
    """A dispatch failure must resolve that batch's requests with the
    error (not kill the batcher silently): result() raises, close()
    converges, later submits still get answers."""
    class BrokenExecutor:
        batch_size = 2
        program = None
        on_result = None
        on_error = None

        def submit_batch(self, frames, n_valid, tag=None):
            raise RuntimeError("stage worker died")

        def flush_inflight(self):
            pass

        def reset_stats(self):
            pass

        def replica_counts(self):
            return None

    fe = AsyncFrontend(BrokenExecutor(), max_wait_ms=5.0)
    f = np.zeros((4, 4, 1), np.float32)
    reqs = [fe.submit(f) for _ in range(3)]
    for r in reqs:
        with pytest.raises(RuntimeError):
            r.result(timeout=30)
    fe.close()
    assert fe.stats.failed == 3
    assert fe.stats.completed == 0


def test_frontend_rejects_malformed_frame_at_submit():
    """A wrong-shape frame is refused at the client, before it can
    poison a micro-batch inside the batcher thread."""
    prog, frames = _tiny()
    with PipelineExecutor(prog, stages=1, batch_size=4) as px:
        fe = AsyncFrontend(px, max_wait_ms=10.0)
        with pytest.raises(ValueError):
            fe.submit(np.zeros((8, 8, 4), np.float32))
        req = fe.submit(frames[0])
        req.result(timeout=60)
        fe.close()
    assert fe.stats.completed == 1


def test_frontend_stage_failure_resolves_requests():
    """A stage worker dying mid-batch must deliver the error to that
    batch's requests through on_error — futures never hang."""
    prog, frames = _tiny()
    px = PipelineExecutor(prog, stages=2, batch_size=4)

    def boom(xq):
        raise RuntimeError("stage exploded")

    px.runners[0] = dataclasses.replace(px.runners[0], fn=boom)
    with px:
        fe = AsyncFrontend(px, max_wait_ms=5.0)
        req = fe.submit(frames[0])
        with pytest.raises(RuntimeError):
            req.result(timeout=60)
        fe.close()                      # converges: the request resolved
    assert fe.stats.failed == 1
    assert fe.stats.completed == 0


def test_frontend_rejects_busy_executor_until_closed():
    """A second frontend on a busy executor is refused; after close()
    the executor is released and reusable."""
    prog, frames = _tiny()
    with PipelineExecutor(prog, stages=1, batch_size=4,
                          output="logits") as px:
        fe = AsyncFrontend(px)
        with pytest.raises(ValueError):
            AsyncFrontend(px)           # on_result already consumed
        fe.close()
        fe2 = AsyncFrontend(px)         # released on close
        want = prog.compile_runner().logits(frames[:1])
        got = fe2.submit(frames[0]).result(timeout=120)
        fe2.close()
    np.testing.assert_array_equal(got, want[0])
