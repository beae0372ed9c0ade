"""Quantize-in on the card: where a runner replays (a CUDA device, the
kernel route, bits 8) the serve loops copy float32 frames into their
staging slots and stage 0's graph rounds them with ``quantize_in_int8``;
everywhere else the host rounds them into an int8 (int16) slot.

On the CPU: the path rule for each device, route and bits, the slot each
path gets and that the runner keeps the path it was compiled with, the
card path's host copy (exact, zero rows, other dtypes cast, no batch-sized
temporary, wrong buffers refused), the ``"quantize_in"`` launch count, the
kernel's plain version against the reference's rounding
(``repro.core.quant``, its numpy and its JAX form) on the awkward values,
the reference against the port's host rounding on every input the card
tests feed the kernel, and the whole card path run on the CPU (the rule
patched) through both executors against the host path. On the card
(marked ``cuda``, skipped without one, run with ``python -m pytest -m cuda
tests/test_torch_quantize_in_card.py``): the kernel bit for bit against
``quant.quantize_to_exponent_np`` on those inputs (frames at each
configuration's input format, ties, values just off them, values past the
rails, infinities, -0.0 and subnormals, at batches 16, 1, 3 and 17 with
zero rows, 227² and 224²), so against the reference through the CPU test
of the same inputs; and the int32 accumulators of AlexNet, VGG16,
ResNet-50 and MobileNetV2 through both executors, eager and replayed,
identical between the card's intake and the host's.

The machine with the card has no JAX: only the CPU tests import the
reference, inside the test (:func:`_reference`)."""

from __future__ import annotations

import gc
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.core import executor as ex_mod
from repro_torch.core import program as prog_t
from repro_torch.core import quant
from repro_torch.core import workload as Wt
from repro_torch.core.executor import EngineExecutor, staging_slot
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.kernels.quantize_in.kernel import (quantize_in_int8,
                                                    quantize_in_int8_ref)
from repro_torch.models import cnn as cnn_t
from repro_torch.serving import PipelineExecutor


def _program(hw: int = 16, ch: int = 3, bits: int = 8):
    m = Wt.CNNModel(f"card_intake{hw}", hw, ch, (
        Wt.ConvLayer("c1", ch, 4, 3, stride=2),
        Wt.ConvLayer("p1", 4, 4, 2, stride=2, kind="pool"),
        Wt.ConvLayer("fc", 4 * (hw // 4) ** 2, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(1).standard_normal(
        (2, hw, hw, ch)).astype(np.float32)
    return prog_t.compile_model(
        m, cnn_t.params_from_numpy(cnn_t.init_params_np(m, 0), "cpu"),
        bits=bits, calib_batch=calib, device="cpu")


def _reference(x: np.ndarray, e: int) -> np.ndarray:
    """The reference's int8 rounding of ``x`` on the format 2^e:
    ``repro.core.quant.quantize_to_exponent_np``, asserted equal to its
    JAX form ``quantize_to_exponent`` on the same values."""
    import jax.numpy as jnp
    from repro.core import quant as qj
    want = qj.quantize_to_exponent_np(x, e)
    assert want.dtype == np.int8
    np.testing.assert_array_equal(
        np.asarray(qj.quantize_to_exponent(jnp.asarray(x), e)), want)
    return want


def _awkward(e: int, n: int, rng) -> np.ndarray:
    """``n`` float32 values on the format 2^e: ties at +-(k + 0.5) 2^e,
    values past +-128 2^e, +-inf, -0.0, subnormals, and normal draws."""
    step = np.float32(2.0 ** e)
    k = np.arange(-130, 130, dtype=np.float32)
    special = np.concatenate([
        (k + np.float32(0.5)) * step, k * step,
        np.array([128.5, -128.5, 129, -129, 1e4, -1e4, 1e30, -1e30,
                  0.5 - 2 ** -24, 0.5 + 2 ** -23], np.float32) * step,
        np.array([np.inf, -np.inf, -0.0, 0.0, 1e-45, -1e-45, 1e-40,
                  -1.17e-38, np.finfo(np.float32).tiny], np.float32)])
    x = (rng.standard_normal(n) * 40 * step).astype(np.float32)
    at = rng.choice(n, size=min(n, 4 * len(special)), replace=False)
    x[at] = np.resize(special, len(at))
    return x


# The formats the card tests round onto: every configuration's ``e_input``
# (the card test asserts each is here) and a sweep beyond them.
EXPS = tuple(range(-8, 3))
HWS = (227, 224)
BATCHES = (16, 1, 3, 17)
COUNTS = (1, 5, 15, 16, 17, 31, 33, 154587, 154587 * 3 + 7)


def _batches(hw: int, batch: int):
    """``(e, x)`` for each format of :data:`EXPS`: a ``[batch, hw, hw, 3]``
    slot of awkward values whose last rows are zero, as the card path's
    intake leaves a short batch."""
    rng = np.random.default_rng(hw + batch)
    for e in EXPS:
        x = _awkward(e, batch * hw * hw * 3, rng).reshape(batch, hw, hw, 3)
        x[batch - batch // 3:] = 0
        yield e, x


def _counts():
    """``(e, x)``: flat batches of every length in :data:`COUNTS` at
    2^-4 (lengths that are no multiple of 16 and shorter than 16), then
    4096 values at 2^-5 that the card test views at an offset."""
    rng = np.random.default_rng(7)
    for n in COUNTS:
        yield -4, _awkward(-4, n, rng)
    yield -5, _awkward(-5, 4096, rng)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0"])
@pytest.mark.parametrize("route", prog_t.ROUTES)
@pytest.mark.parametrize("bits", [8, 16])
def test_the_card_path_is_cuda_kernel_route_bits_8(device, route, bits):
    want = device.startswith("cuda") and route == "kernel" and bits == 8
    assert prog_t.rounds_on_card(device, route, bits) is want
    assert prog_t.rounds_on_card(torch.device(device), route, bits) is want


def _runner(prog, device: str, route: str, monkeypatch, start: int = 0):
    """The runner ``compile_stage_runner`` makes for ``device``, its steps
    left where they are (none is needed to ask its path)."""
    monkeypatch.setattr(prog, "steps_on", lambda device: prog.steps)
    return prog.compile_stage_runner(start, len(prog.steps), route=route,
                                     device=device)


@pytest.mark.parametrize("device, route, bits, start, dtype", [
    ("cuda", "kernel", 8, 0, torch.float32),
    ("cuda", "f32", 8, 0, torch.int8),
    ("cuda", "oracle", 8, 0, torch.int8),
    ("cuda", "oracle", 16, 0, torch.int16),
    ("cuda", "kernel", 8, 1, torch.int8),
    ("cpu", "kernel", 8, 0, torch.int8),
    ("cpu", "f32", 8, 0, torch.int8),
    ("cpu", "oracle", 16, 0, torch.int16),
])
def test_each_path_gets_its_slot(device, route, bits, start, dtype,
                                 monkeypatch):
    """The card path's slot holds float32 frames and has no scratch; every
    other path's holds the quantized batch and a one-chunk scratch."""
    prog = _program(bits=bits)
    runner = _runner(prog, device, route, monkeypatch, start)
    assert runner.card_intake is (dtype == torch.float32)
    buf, scratch = staging_slot(runner, 5, pinned=False)
    assert buf.dtype == dtype and tuple(buf.shape) == (5, 16, 16, 3)
    if dtype == torch.float32:
        assert scratch is None
    else:
        assert buf.dtype == quant.int_dtype(bits)
        assert scratch.dtype == np.float32 and scratch.shape[1:] == (16, 16,
                                                                     3)


@pytest.mark.parametrize("card", [True, False])
def test_the_runner_keeps_the_path_it_was_compiled_with(card, monkeypatch):
    """The rule is asked once, when the runner is compiled: its slot, its
    intake and its ``fn`` keep that answer after the rule changes."""
    prog = _program()
    with monkeypatch.context() as mp:
        mp.setattr(prog_t, "rounds_on_card", lambda *a: card)
        runner = prog.compile_runner(route="kernel")
    assert runner.card_intake is card
    buf, scratch = staging_slot(runner, 4, pinned=False)
    assert buf.dtype == (torch.float32 if card else torch.int8)
    assert (scratch is None) is card
    frames = (np.random.default_rng(8).standard_normal((3, 16, 16, 3))
              * 3).astype(np.float32)
    got = runner.quantize(frames, out=buf.numpy(), scratch=scratch)
    want = quant.quantize_to_exponent_np(frames, prog.e_input)
    np.testing.assert_array_equal(got[:3], frames if card else want)
    assert not got[3:].any()
    # The card path's fn rounds the float slot; both give the host's logits.
    np.testing.assert_array_equal(
        runner.dequantize(runner.fn(torch.from_numpy(got)))[:3],
        runner.logits(frames))


@pytest.mark.parametrize("as_list", [False, True])
@pytest.mark.parametrize("src", [np.float32, np.float64, np.uint8])
def test_the_card_intake_copies_frames_and_zeroes_the_rest(src, as_list,
                                                           monkeypatch):
    """The card path's ``quantize(out=)`` copies the n frames into the
    float32 slot, cast as the host's walk casts them, zeroes the rows after
    them and returns the slot; a slot of another dtype or frame shape is
    refused and left as it was."""
    prog = _program()
    runner = _runner(prog, "cuda", "kernel", monkeypatch)
    frames = (np.random.default_rng(4).standard_normal((3, 16, 16, 3))
              * 50).astype(src)
    buf = np.full((5, 16, 16, 3), 7, np.float32)
    got = runner.quantize(list(frames) if as_list else frames, out=buf)
    assert got is buf
    np.testing.assert_array_equal(buf[:3], frames.astype(np.float32))
    assert not buf[3:].any()
    # The card rounds what the host copied to the reference's integers.
    np.testing.assert_array_equal(
        quantize_in_int8(torch.from_numpy(buf), prog.e_input).numpy()[:3],
        _reference(frames.astype(np.float32), prog.e_input))
    for bad in (np.full((5, 16, 16, 3), 5, np.int8),
                np.full((5, 16, 15, 3), 5, np.float32),
                np.full((2, 16, 16, 3), 5, np.float32)):
        with pytest.raises(ValueError):
            runner.quantize(frames, out=bad)
        assert (bad == 5).all()


def test_the_card_intake_makes_no_batch_sized_temporary():
    """A VGG16 batch's copy, from float32 and from float64 frames, as an
    array and as a list, allocates under a tenth of a float32 batch."""
    frames = np.random.default_rng(5).standard_normal((16, 224, 224, 3))
    buf = np.empty((16, 224, 224, 3), np.float32)
    for x in (frames.astype(np.float32), frames, list(frames)):
        quant.copy_frames_np(x, buf)
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            quant.copy_frames_np(x, buf)
            peak = tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
        assert peak < buf.nbytes // 10, peak
        np.testing.assert_array_equal(buf, np.asarray(x, np.float32))


def test_launch_counts_carry_the_quantize_in_key():
    counts = gemm_kernel.launch_counts()
    assert "quantize_in" in counts
    delta = dict.fromkeys(counts, 0)
    delta["quantize_in"] = 3
    gemm_kernel.add_launches(delta)
    assert gemm_kernel.launch_counts()["quantize_in"] == \
        counts["quantize_in"] + 3
    assert quantize_in_int8.launches == counts["quantize_in"] + 3
    gemm_kernel.add_launches(delta, -1)
    assert gemm_kernel.launch_counts() == counts


@pytest.mark.parametrize("e", [-7, -5, -4, -2, 0, 3])
def test_the_plain_version_rounds_as_the_host(e):
    """On a CPU tensor ``quantize_in_int8`` runs its plain version, which
    counts no launch and gives the reference's integers (and the host
    walk's) on the awkward values; it refuses what the kernel does not
    take."""
    x = _awkward(e, 4096, np.random.default_rng(e + 10)).reshape(
        4, 16, 16, 4)
    before = quantize_in_int8.launches
    got = quantize_in_int8(torch.from_numpy(x), e)
    assert quantize_in_int8.launches == before
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _reference(x, e))
    np.testing.assert_array_equal(got.numpy(),
                                  quant.quantize_to_exponent_np(x, e))
    assert torch.equal(quantize_in_int8_ref(torch.from_numpy(x), e), got)
    with pytest.raises(ValueError):
        quantize_in_int8(torch.from_numpy(x.astype(np.float64)), e)
    with pytest.raises(ValueError):
        quantize_in_int8(torch.from_numpy(x).permute(0, 2, 1, 3), e)


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("batch", BATCHES)
def test_the_card_tests_inputs_hold_the_reference(hw, batch):
    """Every slot the card test feeds the kernel: the port's host rounding,
    which that test holds the kernel to, gives the reference's integers
    (its numpy and its JAX form), ±inf, subnormals and values just off the
    ties included; so does the kernel's plain version."""
    for e, x in _batches(hw, batch):
        want = _reference(x, e)
        np.testing.assert_array_equal(quant.quantize_to_exponent_np(x, e),
                                      want)
        np.testing.assert_array_equal(
            quantize_in_int8_ref(torch.from_numpy(x), e).numpy(), want)


def test_the_card_tests_counts_hold_the_reference():
    """The same for the card test of odd element counts and views."""
    for e, x in _counts():
        np.testing.assert_array_equal(quant.quantize_to_exponent_np(x, e),
                                      _reference(x, e))


@pytest.mark.parametrize("kind", ["engine", "pipeline"])
def test_the_card_path_run_on_the_cpu_equals_the_host_path(monkeypatch,
                                                           kind):
    """The card path's whole loop on the CPU (the rule patched to take it
    there, the kernel's plain version rounding): float32 slots, the first
    runner's ``fn`` handed float32 frames with zero rows, and every frame's
    logits those of the host path."""
    batch = 4
    prog = _program()
    frames = (np.random.default_rng(6).standard_normal((2 * batch + 3, 16,
                                                        16, 3)) * 3
              ).astype(np.float32)
    want = prog.compile_runner().logits(frames)
    monkeypatch.setattr(prog_t, "rounds_on_card",
                        lambda device, route, bits: bits == 8)
    made = []

    def slot(*args, **kwargs):
        made.append(staging_slot(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(ex_mod, "staging_slot", slot)
    import repro_torch.serving.pipeline_executor as pe_mod
    monkeypatch.setattr(pe_mod, "staging_slot", slot)
    if kind == "engine":
        ex = EngineExecutor(prog, batch_size=batch, output="logits")
        first = ex.runner
    else:
        ex = PipelineExecutor(prog, stages=2, batch_size=batch,
                              output="logits")
        first = ex.runners[0]
    assert first.card_intake
    seen, fn = [], first.fn

    def record(x):
        seen.append(x.clone())
        return fn(x)

    first.fn = record
    try:
        got = ex.serve(list(frames))
    finally:
        if kind == "pipeline":
            ex.close()
    np.testing.assert_array_equal(np.stack(got), want)
    assert made and all(b.dtype == torch.float32 and s is None
                        for b, s in made)
    assert [x.dtype for x in seen] == [torch.float32] * 3
    np.testing.assert_array_equal(seen[2][:3].numpy(), frames[-3:])
    assert not seen[2][3:].any()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

MODELS = ("alexnet", "vgg16", "resnet50", "mobilenetv2")
BATCH = 16


@pytest.fixture(scope="module")
def progs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.serving.server import compile_for_serving
    return {m: compile_for_serving(m, device="cuda") for m in MODELS}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("batch", BATCHES)
def test_the_kernel_equals_the_host_bit_for_bit(progs, hw, batch):
    """Every configuration's input format and a sweep of others, on a slot
    of ``batch`` frames whose last rows are zero (as the card path's intake
    leaves a short batch): the kernel's int8 equal the host walk's, which
    the CPU test of the same inputs holds to the reference, and one launch
    counted each."""
    assert {p.e_input for p in progs.values()} <= set(EXPS)
    for e, x in _batches(hw, batch):
        before = quantize_in_int8.launches
        got = quantize_in_int8(torch.as_tensor(x, device="cuda"), e)
        torch.cuda.synchronize()
        assert quantize_in_int8.launches == before + 1
        want = quant.quantize_to_exponent_np(x, e)
        assert np.array_equal(got.cpu().numpy(), want), (e, hw, batch)


@pytest.mark.cuda
def test_the_kernel_takes_any_element_count(progs):
    """Counts that are no multiple of 16 (the scalar tail) and shorter than
    16, and a view on a 16-byte base inside a larger tensor."""
    *flat, (_, last) = _counts()
    for e, x in flat:
        got = quantize_in_int8(torch.as_tensor(x, device="cuda"), e)
        assert np.array_equal(got.cpu().numpy(),
                              quant.quantize_to_exponent_np(x, e)), len(x)
    whole = torch.as_tensor(last, device="cuda")
    view = whole[64:64 + 1000]
    assert torch.equal(quantize_in_int8(view, -5).cpu(),
                       torch.as_tensor(quant.quantize_to_exponent_np(
                           view.cpu().numpy(), -5)))
    with pytest.raises(ValueError, match="16-byte"):
        quantize_in_int8(whole[1:1001], -5)


def _accs(prog, kind: str, frames, card: bool, monkeypatch):
    """Every batch's int32 accumulators as ``kind``'s last runner decodes
    them, with the card's intake or the host's (the rule patched off),
    and the quantize_in launches the serve counted."""
    # A runner left in a reference cycle would be collected inside the
    # next capture, and freeing its graph there invalidates that capture.
    gc.collect()
    with monkeypatch.context() as mp:
        if not card:
            mp.setattr(prog_t, "rounds_on_card", lambda *a: False)
        if kind == "engine":
            ex = EngineExecutor(prog, batch_size=BATCH, output="logits")
            runners = [ex.runner]
        else:
            ex = PipelineExecutor(prog, stages=2, batch_size=BATCH,
                                  output="logits")
            runners = ex.runners
        last, accs = runners[-1], []
        decode = last.decode

        def record(acc, n, output):
            accs.append(acc.clone())
            return decode(acc, n, output)

        last.decode = record
        before = gemm_kernel.launch_counts()["quantize_in"]
        try:
            logits = np.stack(ex.serve(list(frames)))
        finally:
            del last.decode         # the wrapper refers to the runner
            if kind == "pipeline":
                ex.close()
        counted = gemm_kernel.launch_counts()["quantize_in"] - before
        assert runners[0].card_intake is card
        for r in runners:
            assert (r.eager_calls, r.replays) == (1, len(accs) - 1)
    return accs, logits, counted


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["engine", "pipeline"])
@pytest.mark.parametrize("model", MODELS)
def test_the_card_intake_gives_the_host_intakes_accumulators(
        progs, model, kind, monkeypatch):
    """Four batches (the last short), the first eager, the rest replayed:
    the accumulators with the card's intake equal the host's and those of
    the eager chain on the host's int8, bit for bit; the card path counts
    one ``quantize_in`` launch a batch, replays included, the host path
    none."""
    from repro_torch.serving.server import synthetic_stream
    prog = progs[model]
    frames = synthetic_stream(model, 4 * BATCH - 5, seed=9)
    card, card_logits, card_n = _accs(prog, kind, frames, True,
                                      monkeypatch)
    host, host_logits, host_n = _accs(prog, kind, frames, False,
                                      monkeypatch)
    assert (card_n, host_n) == (4, 0)
    assert len(card) == len(host) == 4
    assert all(torch.equal(c, h) for c, h in zip(card, host))
    np.testing.assert_array_equal(card_logits, host_logits)
    runner = prog.compile_runner(route="kernel")
    for i, acc in enumerate(card):
        xq = np.zeros((BATCH,) + frames.shape[1:], np.int8)
        chunk = frames[i * BATCH:(i + 1) * BATCH]
        xq[:len(chunk)] = runner.quantize(chunk)
        want = runner.fn(torch.as_tensor(xq, device="cuda")).cpu()
        assert torch.equal(acc.cpu(), want), i
