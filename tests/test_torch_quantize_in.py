"""Quantize-in of the serve loops on the CPU: ``EngineExecutor`` and
``PipelineExecutor`` quantize the float frames straight into their
staging rings (``quant.quantize_to_exponent_np``'s ``out=`` form), so a
dispatch allocates no array the size of the batch, and a reused slot
carries each batch exactly: its quantized frames, then zero rows."""

import tracemalloc

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import executor as ex_mod
from repro_torch.core import program as prog_t
from repro_torch.core import workload as Wt
from repro_torch.core.executor import EngineExecutor, staging_slot
from repro_torch.models import cnn as cnn_t
from repro_torch.serving import PipelineExecutor
from repro_torch.serving import pipeline_executor as pe_mod


def _program(hw: int, ch: int, bits: int = 8):
    """A stride-4 11 x 11 stem, a pool and an fc head at ``hw`` x ``hw``
    x ``ch``: AlexNet's input size compiles in well under a second."""
    m = Wt.CNNModel(f"intake{hw}", hw, ch, (
        Wt.ConvLayer("c1", ch, 4, 11, stride=4),
        Wt.ConvLayer("p1", 4, 4, 3, stride=2, kind="pool"),
        Wt.ConvLayer("fc", 4 * (hw // 8) ** 2, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(1).standard_normal(
        (2, hw, hw, ch)).astype(np.float32)
    return prog_t.compile_model(
        m, cnn_t.params_from_numpy(cnn_t.init_params_np(m, 0), "cpu"),
        bits=bits, calib_batch=calib, device="cpu")


def _executor(kind: str, prog, batch: int):
    if kind == "engine":
        return EngineExecutor(prog, batch_size=batch, output="logits")
    return PipelineExecutor(prog, stages=2, batch_size=batch,
                            output="logits")


def _close(ex) -> None:
    if isinstance(ex, PipelineExecutor):
        ex.close()


@pytest.mark.parametrize("entry", ["submit", "submit_batch"])
@pytest.mark.parametrize("kind", ["engine", "pipeline"])
def test_serve_intake_allocates_no_batch_sized_array(kind, entry):
    """A second batch's intake and collection, at AlexNet's 227 x 227 x 3,
    allocate less than one float32 batch: numpy's peak under
    ``tracemalloc``, torch's CPU allocations under the profiler. No stack,
    no float temporaries, no int8 copy beside the staging buffer. The
    chain replays its first outputs, so only the intake's tensors count."""
    batch = 16
    frames = np.random.default_rng(2).standard_normal(
        (batch, 227, 227, 3)).astype(np.float32)
    ex = _executor(kind, _program(227, 3), batch)
    runners = [ex.runner] if kind == "engine" else ex.runners

    def replay(r):
        fn = r.fn

        def first(x):
            r.fn = (lambda x, y=fn(x): y)
            return r.fn(x)
        r.fn = first

    def dispatch():
        if entry == "submit_batch":
            ex.submit_batch(frames, batch)
        else:
            for f in frames:
                ex.submit(f)
        return len(ex.drain())

    try:
        for r in runners:
            replay(r)
        assert dispatch() == batch
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            assert dispatch() == batch
            peak = tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            assert dispatch() == batch
    finally:
        _close(ex)
    allocated = sum(max(e.self_cpu_memory_usage, 0)
                    for e in prof.key_averages())
    assert peak < frames.nbytes, (peak, frames.nbytes)
    assert allocated < frames.nbytes, (allocated, frames.nbytes)


@pytest.mark.parametrize("hw, bits", [(16, 8), (16, 16), (227, 8)])
@pytest.mark.parametrize("kind", ["engine", "pipeline"])
def test_reused_staging_slots_carry_each_batch_exactly(kind, hw, bits):
    """Seven batches through a ring of two (engine) or three (pipeline)
    slots, each of distinct frames: full ones, a short ``submit_batch``
    and a short tail. Every batch reaches the chain as its own quantized
    frames and zero rows (int8, or int16 at bits=16), and every frame's
    logits equal ``CompiledRunner.logits``. At 16 x 16 x 3 a batch is one
    chunk; at 227 x 227 x 3 the engine walks it a frame at a time and the
    pipeline takes it whole in torch ops."""
    batch = 5
    prog = _program(hw, 3, bits)
    frames = (np.random.default_rng(bits).standard_normal(
        (6 * batch + 2, hw, hw, 3)) * 3).astype(np.float32)
    whole = prog.compile_runner()
    ex = _executor(kind, prog, batch)
    first = ex.runner if kind == "engine" else ex.runners[0]
    seen = []
    fn = first.fn

    def record(x):
        seen.append(x.clone().numpy())
        return fn(x)

    first.fn = record
    try:
        for f in frames[:4 * batch]:
            ex.submit(f)
        ex.submit_batch(frames[4 * batch:4 * batch + 3], 3)
        ex.submit_batch(frames[4 * batch + 3:5 * batch + 3], batch)
        for f in frames[5 * batch + 3:]:
            ex.submit(f)
        got = ex.drain()
    finally:
        _close(ex)
    np.testing.assert_array_equal(np.stack(got), whole.logits(frames))
    cuts = [0, 5, 10, 15, 20, 23, 28, 32]
    assert len(seen) == len(cuts) - 1
    for x, lo, hi in zip(seen, cuts, cuts[1:]):
        want = np.zeros_like(x)
        want[:hi - lo] = whole.quantize(frames[lo:hi])
        np.testing.assert_array_equal(x, want)


def test_both_rings_take_one_chunk_slots_and_hand_over_the_buffer(
        monkeypatch):
    """Both executors build their staging slots with the one
    ``staging_slot``; each slot's scratch is one chunk (a frame at 227 x
    227 x 3, not the batch), and the runner's launch takes the slot's
    buffer itself: the runner, not the executor, copies it onward."""
    made = []

    def slot(*args, **kwargs):
        made.append(staging_slot(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(ex_mod, "staging_slot", slot)
    monkeypatch.setattr(pe_mod, "staging_slot", slot)
    batch = 3
    prog = _program(227, 3)
    frames = np.random.default_rng(3).standard_normal(
        (2 * batch, 227, 227, 3)).astype(np.float32)
    want = prog.compile_runner().logits(frames)
    for kind, n_slots in (("engine", 2), ("pipeline", 3)):
        made.clear()
        ex = _executor(kind, prog, batch)
        first = ex.runner if kind == "engine" else ex.runners[0]
        handed = []
        launch = first.launch

        def record(x, *, sleep, launch=launch, handed=handed):
            handed.append(x)
            return launch(x, sleep=sleep)

        first.launch = record
        try:
            got = ex.serve(list(frames))
        finally:
            _close(ex)
        np.testing.assert_array_equal(np.stack(got), want)
        assert len(made) == n_slots
        for buf, scratch in made:
            assert scratch.shape == (1, 227, 227, 3), kind
        bufs = [buf for buf, _ in made]
        assert len(handed) == 2
        assert all(any(x is b for b in bufs) for x in handed), kind
