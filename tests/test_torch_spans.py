"""The serve path's own spans (``repro_torch.core.spans``): off, a serve
records nothing; on, every batch of ``EngineExecutor``, a K = 2
``PipelineExecutor`` and an ``AsyncFrontend`` over it records exactly its
layer's spans, with the owner's batch numbers; nested spans lie inside
their parents; a stage's launch and wait add up to its ``stage_busy_s``;
outputs are the same bits either way; a full buffer counts what it drops.
On the CPU, where the serve path runs synchronously."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core import spans
from repro_torch.core import workload as W
from repro_torch.core.executor import EngineExecutor
from repro_torch.models import cnn
from repro_torch.serving import (AsyncFrontend, PipelineExecutor,
                                 ReplicaPool)

BATCH = 4
N_FRAMES = 14               # three whole batches and a padded tail

ENGINE = {"engine.stack", "engine.quantize", "engine.enqueue",
          "engine.wait", "engine.collect"}
SUBMIT = {"pipeline.quantize", "pipeline.stage_in", "pipeline.put"}
COLLECT = {"collect.dequantize", "collect.deliver"}
BATCHER = {"batcher.fill", "batcher.dispatch"}


def _stages(k):
    return {f"stage{i}.{p}" for i in range(k)
            for p in ("idle", "launch", "wait", "handoff")}


@pytest.fixture(scope="module")
def tiny():
    model = W.CNNModel("tiny", 16, 3, (
        W.ConvLayer("c1", 3, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 8, 8, 3, groups=2),
        W.ConvLayer("fc", 8 * 8 * 8, 10, 1, kind="fc")))
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((N_FRAMES, 16, 16, 3)).astype(np.float32)
    prog = P.compile_model(model, cnn.init_params(model, 0, device="cpu"),
                           bits=8, calib_batch=torch.from_numpy(frames[:4]),
                           device="cpu")
    return prog, frames


@pytest.fixture
def recording():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _engine(prog, frames):
    ex = EngineExecutor(prog, batch_size=BATCH, output="logits")
    return np.stack(ex.serve(list(frames))), ex


def _pipeline(prog, frames):
    with PipelineExecutor(prog, stages=2, batch_size=BATCH,
                          output="logits") as px:
        out = np.stack(px.serve(list(frames)))
    return out, px


def _frontend(prog, frames):
    with PipelineExecutor(prog, stages=2, batch_size=BATCH,
                          output="logits") as px:
        fe = AsyncFrontend(px, max_wait_ms=5.0)
        reqs = [fe.submit(f) for f in frames]
        out = np.stack([r.result(timeout=60) for r in reqs])
        fe.close()
    return out, (px, fe)


SERVES = {"engine": _engine, "pipeline": _pipeline, "frontend": _frontend}


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_off_records_nothing_and_on_gives_the_same_bits(tiny, recording,
                                                       serve):
    prog, frames = tiny
    off, _ = SERVES[serve](prog, frames)
    assert spans.drain() == []
    spans.enable()
    on, _ = SERVES[serve](prog, frames)
    spans.disable()
    assert spans.drain()
    np.testing.assert_array_equal(on, off)
    assert on.dtype == off.dtype and on.shape == (N_FRAMES, 10)


def _by_batch(rows, owner):
    """Span names by batch number; a stage worker's last wait, ended by
    the executor's close rather than a batch, has none."""
    got = collections.defaultdict(set)
    for r in rows:
        if r.owner == owner and r.batch is None:
            assert r.name.endswith(".idle"), r.name
        elif r.owner == owner:
            assert r.name not in got[r.batch], (r.name, r.batch)
            got[r.batch].add(r.name)
    return got


def test_engine_spans_each_batch_with_its_number(tiny, recording):
    prog, frames = tiny
    spans.enable()
    _, ex = _engine(prog, frames)
    rows = spans.drain()
    assert {r.owner for r in rows} == {id(ex)}
    got = _by_batch(rows, id(ex))
    assert sorted(got) == list(range(ex.stats.batches)) == [0, 1, 2, 3]
    for names in got.values():
        assert names == ENGINE


def test_pipeline_spans_each_batch_on_every_thread(tiny, recording):
    prog, frames = tiny
    spans.enable()
    _, px = _pipeline(prog, frames)
    rows = spans.drain()
    got = _by_batch(rows, id(px))
    assert sorted(got) == list(range(px.batches_run)) == [0, 1, 2, 3]
    for names in got.values():
        assert names == SUBMIT | COLLECT | _stages(2)
    threads = collections.defaultdict(set)
    for r in rows:
        threads[r.name.split(".")[0]].add(r.thread)
    assert threads["pipeline"] == {threading.get_ident()}
    assert all(len(t) == 1 for t in threads.values())
    # The client, two stage workers and the collector.
    assert len(set.union(*threads.values())) == 4


def test_frontend_spans_nest_the_pipelines_on_the_batcher(tiny, recording):
    prog, frames = tiny
    spans.enable()
    _, (px, fe) = _frontend(prog, frames)
    rows = spans.drain()
    mine = _by_batch(rows, id(fe))
    assert sorted(mine) == list(range(fe.stats.batches))
    for names in mine.values():
        assert names == BATCHER
    theirs = _by_batch(rows, id(px))
    assert sorted(theirs) == list(range(px.batches_run))
    for names in theirs.values():
        assert names == SUBMIT | COLLECT | _stages(2)
    # The pipeline's submit spans run inside the dispatch of the
    # frontend's batch of the same number, on the batcher's thread.
    dispatch = {r.batch: r for r in rows if r.name == "batcher.dispatch"}
    for r in rows:
        if r.name in SUBMIT:
            d = dispatch[r.batch]
            assert r.thread == d.thread
            assert d.t0 <= r.t0 <= r.t1 <= d.t1


def test_a_pools_replicas_stay_apart_by_owner(tiny, recording):
    prog, _ = tiny
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((BATCH * 12, 16, 16, 3)).astype(np.float32)
    pool = ReplicaPool(prog, replicas=2, stages=2, batch_size=BATCH,
                       output="logits")
    spans.enable()
    fe = AsyncFrontend(pool, max_wait_ms=5.0)
    for r in [fe.submit(f) for f in frames]:
        r.result(timeout=60)
    fe.close()
    pool.close()
    rows = spans.drain()
    counts = pool.replica_counts()
    assert {r.owner for r in rows} == ({id(fe)}
                                       | {id(x) for x in pool.replicas})
    for px, c in zip(pool.replicas, counts):
        got = _by_batch(rows, id(px))
        assert sorted(got) == list(range(c["dispatched_batches"]))
        assert c["dispatched_batches"] > 0
        for names in got.values():
            assert names == SUBMIT | COLLECT | _stages(2)


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_times_are_ordered_and_cpu_within_wall(tiny, recording, serve):
    prog, frames = tiny
    spans.enable()
    SERVES[serve](prog, frames)
    rows = spans.drain()
    for r in rows:
        assert r.t0 <= r.t1
        assert 0.0 <= r.cpu_s <= r.t1 - r.t0, r.name
    # On one thread, two spans are disjoint or one holds the other.
    per_thread = collections.defaultdict(list)
    for r in rows:
        per_thread[r.thread].append(r)
    for rs in per_thread.values():
        rs.sort(key=lambda r: (r.t0, -r.t1))
        open_ = []
        for r in rs:
            while open_ and open_[-1].t1 <= r.t0:
                open_.pop()
            if open_:
                assert r.t1 <= open_[-1].t1, (r.name, open_[-1].name)
            open_.append(r)


def test_stage_launch_and_wait_add_up_to_its_busy_time(tiny, recording):
    prog, _ = tiny
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((BATCH * 12, 16, 16, 3)).astype(np.float32)
    spans.enable()
    _, px = _pipeline(prog, frames)
    rows = spans.drain()
    for i, busy in enumerate(px.stage_busy_s):
        inside = sum(r.t1 - r.t0 for r in rows
                     if r.name in (f"stage{i}.launch", f"stage{i}.wait"))
        assert inside == pytest.approx(busy, rel=0.05)


def test_the_buffer_counts_what_it_drops(recording):
    before = spans.dropped()
    spans.enable()
    for i in range(spans.MAXLEN + 7):
        with spans.span("t", owner=0, batch=i):
            pass
    spans.disable()
    assert spans.dropped() - before == 7
    rows = spans.drain()
    assert len(rows) == spans.MAXLEN
    assert rows[0].batch == 7 and rows[-1].batch == spans.MAXLEN + 6
    assert spans.drain() == []


def test_off_is_one_shared_context_that_reads_no_clock(recording,
                                                       monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    monkeypatch.setattr(time, "thread_time", no_clock)
    a = spans.span("x", owner=1, batch=0)
    with spans.span("y", owner=2, batch=None) as b:
        b.batch = 3
    assert a is b and b.batch is None
    monkeypatch.undo()
    assert spans.drain() == []


def test_a_profiler_session_records_spans(recording):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("in", owner=0, batch=0):
            pass
    with spans.span("out", owner=0, batch=1):
        pass
    assert [r.name for r in spans.drain()] == ["in"]
