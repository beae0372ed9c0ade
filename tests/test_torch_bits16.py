"""The port's bits=16 engine against the reference's and against an
independent int64 numpy oracle, on the same numpy weights and frames.

The reference models the DSP48's 48-bit accumulation in float32
(``repro/core/program.py::_step_oracle`` at bits=16); the port computes
the same engine in exact integer arithmetic (int64 accumulators, an
arithmetic shift). So against the reference, per engine on the same int16
input:

* hidden layers differ by at most 1 LSB, on at most 0.5% of the elements
  (the reference's float32 ``exp2`` shift and rounded sums move a value
  across a floor now and then);
* the last engine's accumulators differ by at most 2^-16 of the layer's
  largest |accumulator| (float32 rounds them past 2^24);

and end to end the top-1 ids are identical and the logits' relative L2
distance is within ``E2E_REL_L2``. Against the numpy oracle every engine
is bit for bit. Then the refusals (no kernel or f32 route at bits=16),
the serve paths on int16 frames, and the staging rings' dtype check."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as prog_j
from repro.core import workload as Wj
from repro.models import cnn as cnn_j
from repro_torch.core import executor as ex_t
from repro_torch.core import program as prog_t
from repro_torch.core import quant as qt
from repro_torch.core import workload as Wt
from repro_torch.models import cnn as cnn_t
from repro_torch.serving import PipelineExecutor, ProgramRegistry

# Twice the largest relative L2 distance measured between the port's and
# the reference's bits=16 logits on these models (:func:`measure`):
# 1.33e-4 on full-width ZF (1.58e-5 on the reduced AlexNet, 8.3e-8 on the
# pool-last model). The reference's own bound against the float forward
# is 1e-3.
E2E_REL_L2 = 2.7e-4
HIDDEN_SHARE = 5e-3      # share of a hidden layer's elements off by 1 LSB
LAST_REL = 2.0 ** -16    # of the last engine's largest |accumulator|


def _alexnet_reduced(L):
    """AlexNet's first two engines at full width (the stride-4 11 x 11
    stem, the grouped conv2, both pools), then one fc head."""
    full = L.CNN_MODELS["alexnet"]()
    head = [l for l in full.layers[:4]]
    assert [l.name for l in head] == ["conv1", "pool1", "conv2", "pool2"]
    return L.CNNModel("alexnet-reduced", full.input_hw, 3, tuple(head) + (
        L.ConvLayer("fc", 13 * 13 * 256, 10, 1, kind="fc"),))


def _pool_last(L):
    """The reference's model whose final layer is a pool: the last
    engine's accumulators reach the pool."""
    return L.CNNModel("tiny", 8, 3, (
        L.ConvLayer("c1", 3, 4, 3),
        L.ConvLayer("p1", 4, 4, 2, stride=2, kind="pool"),
    ))


MODELS = {"zf": lambda L: L.CNN_MODELS["zf"](),
          "alexnet-reduced": _alexnet_reduced, "pool-last": _pool_last}


def _both(name, frames=1, seed=0):
    mj, mt = MODELS[name](Wj), MODELS[name](Wt)
    params = cnn_t.init_params_np(mt, seed)
    rng = np.random.default_rng(seed + 1)
    for p in params.values():   # nonzero biases exercise bias_q
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32)
    shape = (frames, mt.input_hw, mt.input_hw, mt.input_ch)
    calib = rng.standard_normal(shape).astype(np.float32)
    pj = prog_j.compile_model(
        mj, {n: {k: jnp.asarray(v) for k, v in p.items()}
             for n, p in params.items()},
        bits=16, calib_batch=jnp.asarray(calib))
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              bits=16, calib_batch=calib, device="cpu")
    return pj, pt, params, calib


_CACHE: dict = {}


def _cached(name):
    if name not in _CACHE:
        _CACHE[name] = _both(name)
    return _CACHE[name]


def _np_engine(x: np.ndarray, step) -> np.ndarray:
    """One engine in int64 numpy, independent of torch: a loop-built
    im2col over (r, s, c), one int64 GEMM per channel group, + bias, ReLU,
    floor(acc / 2^shift) (a multiply for a negative shift), clip to
    int16; the last engine returns the int64 accumulators."""
    lyr = step.layer
    w = step.wq.numpy().astype(np.int64)
    x = x.astype(np.int64)
    if step.kind == "fc":
        acc = x.reshape(len(x), -1) @ w
    else:
        R, S, Cg, M = w.shape
        lo, hi = step.pad
        xp = np.pad(x, ((0, 0), (lo, hi), (lo, hi), (0, 0)))
        B, Hp, Wp, _ = xp.shape
        Ho = (Hp - R) // lyr.stride + 1
        Wo = (Wp - S) // lyr.stride + 1
        Mg = M // lyr.groups
        outs = []
        for g in range(lyr.groups):
            xg = xp[..., g * Cg:(g + 1) * Cg]
            cols = [xg[:, r:r + (Ho - 1) * lyr.stride + 1:lyr.stride,
                       s:s + (Wo - 1) * lyr.stride + 1:lyr.stride, :]
                    for r in range(R) for s in range(S)]
            patches = np.concatenate(cols, -1).reshape(B * Ho * Wo, -1)
            wg = w[..., g * Mg:(g + 1) * Mg].reshape(-1, Mg)
            outs.append((patches @ wg).reshape(B, Ho, Wo, Mg))
        acc = np.concatenate(outs, -1)
    acc = acc + step.bias_q.numpy().astype(np.int64)
    if step.relu:
        acc = np.maximum(acc, 0)
    if not step.requantize:
        return acc
    sh = step.shift.numpy().astype(np.int64)
    y = np.where(sh >= 0, acc >> np.maximum(sh, 0),
                 acc * (2 ** np.maximum(-sh, 0)))
    return np.clip(y, -2 ** 15, 2 ** 15 - 1).astype(np.int16)


def _np_pool(x: np.ndarray, step) -> np.ndarray:
    lyr = step.layer
    lo, hi = step.pad
    fill = np.iinfo(x.dtype).min
    xp = np.pad(x, ((0, 0), (lo, hi), (lo, hi), (0, 0)),
                constant_values=fill)
    k, st = lyr.kernel, lyr.stride
    Ho = (xp.shape[1] - k) // st + 1
    Wo = (xp.shape[2] - k) // st + 1
    return np.max([xp[:, r:r + (Ho - 1) * st + 1:st,
                      s:s + (Wo - 1) * st + 1:st, :]
                   for r in range(k) for s in range(k)], axis=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_lowering_matches_reference(name):
    pj, pt, _, _ = _cached(name)
    assert pt.bits == 16 and pt.e_input == pj.e_input
    for sj, st in zip(pj.steps, pt.steps):
        assert (st.name, st.kind, st.pad, st.relu, st.requantize) == \
            (sj.name, sj.kind, sj.pad, sj.relu, sj.requantize)
        if st.kind == "pool":
            continue
        assert st.wq.dtype == torch.int16 and st.wk is None
        np.testing.assert_array_equal(st.wq.numpy(), np.asarray(sj.wq))
        np.testing.assert_array_equal(st.bias_q.numpy(),
                                      np.asarray(sj.bias_q))
        np.testing.assert_array_equal(st.shift.numpy(), np.asarray(sj.shift))
        np.testing.assert_array_equal(st.e_w, sj.e_w)
        assert (st.e_in, st.e_out) == (sj.e_in, sj.e_out)


@pytest.mark.parametrize("name", list(MODELS))
def test_each_engine_against_reference_and_int64_numpy(name):
    """Each step on the same int16 input: the reference's float32 model
    within its bounds, the numpy int64 oracle bit for bit."""
    pj, pt, _, calib = _cached(name)
    x = qt.quantize_to_exponent_np(calib, pt.e_input, 16)
    assert x.dtype == np.int16
    for sj, st in zip(pj.steps, pt.steps):
        if st.kind == "pool":
            want = np.asarray(prog_j._pool_int(jnp.asarray(x), sj))
            got = prog_t._pool_int(torch.from_numpy(x), st).numpy()
            np.testing.assert_array_equal(got, _np_pool(x, st))
            np.testing.assert_array_equal(got.astype(np.float64),
                                          want.astype(np.float64))
            x = got
            continue
        want = np.asarray(prog_j._step_oracle(jnp.asarray(x), sj, 16))
        got = prog_t._step_oracle16(torch.from_numpy(x), st).numpy()
        np.testing.assert_array_equal(got, _np_engine(x, st),
                                      err_msg=st.name)
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        if st.requantize:
            assert got.dtype == np.int16 and want.dtype == np.int16
            assert diff.max() <= 1, (st.name, diff.max())
            assert (diff > 0).mean() <= HIDDEN_SHARE, (
                st.name, (diff > 0).mean())
        else:
            assert got.dtype == np.int64
            assert diff.max() <= LAST_REL * np.abs(got).max(), (
                st.name, diff.max(), np.abs(got).max())
        x = got


@pytest.mark.parametrize("name", list(MODELS))
def test_end_to_end_against_reference(name):
    pj, pt, params, calib = _cached(name)
    want = np.asarray(pj.run(jnp.asarray(calib)))
    got = pt.run(calib).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.reshape(len(got), -1).argmax(-1),
                                  want.reshape(len(want), -1).argmax(-1))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= E2E_REL_L2, rel
    # Every route-free path the reference has at bits=16 gives the same.
    runner = pt.compile_runner()
    assert runner.route == "oracle"
    np.testing.assert_array_equal(runner.logits(calib), got)
    fwd = cnn_t.forward(cnn_t.params_from_numpy(params, "cpu"), pt.model,
                        calib, quantized=True, bits=16)
    np.testing.assert_array_equal(fwd.numpy(), got)


def test_cnn_forward_matches_the_reference_forward():
    """``forward(quantized=True, bits=16)`` in both packages (each
    recalibrates on its input) against the float forward: both within the
    reference's own 1e-3 bound, and within ``E2E_REL_L2`` of each
    other."""
    mj, mt = Wj.CNN_MODELS["zf"](), Wt.CNN_MODELS["zf"]()
    params = cnn_t.init_params_np(mt, 3)
    x = np.random.default_rng(4).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    pjax = {n: {k: jnp.asarray(v) for k, v in p.items()}
            for n, p in params.items()}
    want = np.asarray(cnn_j.forward(pjax, mj, jnp.asarray(x),
                                    quantized=True, bits=16))
    got = cnn_t.forward(cnn_t.params_from_numpy(params, "cpu"), mt, x,
                        quantized=True, bits=16).numpy()
    flt = np.asarray(cnn_j.forward(pjax, mj, jnp.asarray(x)))
    for y in (want, got):
        assert np.linalg.norm(y - flt) / np.linalg.norm(flt) < 1e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= E2E_REL_L2


def _tiny16(hw=8, ch=3, seed=0, bits=16):
    m = Wt.CNNModel(f"tiny{bits}", hw, ch, (
        Wt.ConvLayer("c1", ch, 8, 3),
        Wt.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        Wt.ConvLayer("c2", 8, 8, 3, groups=2),
        Wt.ConvLayer("fc", 8 * (hw // 2) ** 2, 10, 1, kind="fc"),
    ))
    calib = np.random.default_rng(seed + 1).standard_normal(
        (2, hw, hw, ch)).astype(np.float32)
    return prog_t.compile_model(
        m, cnn_t.params_from_numpy(cnn_t.init_params_np(m, seed), "cpu"),
        bits=bits, calib_batch=calib, device="cpu")


def test_kernel_and_f32_routes_refused_up_front():
    """As in the reference's ``test_kernel_route_checked_up_front``: no
    silent fallback to the oracle."""
    prog = _tiny16()
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(NotImplementedError, match="int8"):
        prog.compile_runner(route="kernel")
    with pytest.raises(NotImplementedError):
        prog.compile_stage_runner(0, 2, route="kernel")
    with pytest.raises(NotImplementedError):
        prog.run(x, use_kernel=True)
    with pytest.raises(NotImplementedError):
        cnn_t.forward(cnn_t.params_from_numpy(
            cnn_t.init_params_np(prog.model, 0), "cpu"), prog.model, x,
            quantized=True, bits=16, use_kernel=True)
    with pytest.raises(NotImplementedError, match="int8 products"):
        prog.compile_runner(route="f32")
    with pytest.raises(NotImplementedError):
        PipelineExecutor(prog, stages=2, batch_size=2, route="kernel")
    prog.device = torch.device("cuda")      # what the card resolves
    assert prog._resolve_route(None) == "oracle"
    assert prog_t.kernel_available(16)[0] is False
    assert prog_t.kernel_available(8) == (True, "")
    with pytest.raises(ValueError):
        prog_t.compile_model(prog.model, bits=4, device="cpu")


def test_oracle16_refuses_chains_past_the_float64_bound(monkeypatch):
    monkeypatch.setattr(prog_t, "_F64_MAX_MACS", 16)
    prog = _tiny16()
    with pytest.raises(NotImplementedError, match="float64"):
        prog.run(np.zeros((1, 8, 8, 3), np.float32))


def test_saturation_and_left_shifts_match_the_numpy_oracle():
    """Accumulators driven to the int16 rails and past them, with shifts
    of both signs, through the exact epilogue."""
    prog = _tiny16()
    step = prog.steps[0]
    rng = np.random.default_rng(0)
    x = rng.integers(-2 ** 15, 2 ** 15, (2, 8, 8, 3)).astype(np.int16)
    for shifts in ([-31, -3, -1, 0, 1, 5, 20, 31], [0] * 8, [-16] * 8):
        s = step.__class__(**{**step.__dict__,
                              "shift": torch.tensor(shifts,
                                                    dtype=torch.int32)})
        got = prog_t._step_oracle16(torch.from_numpy(x), s).numpy()
        np.testing.assert_array_equal(got, _np_engine(x, s))
        assert got.min() >= -2 ** 15 and got.max() <= 2 ** 15 - 1


def test_serve_paths_take_int16_frames():
    """The single executor and the K-stage pipeline serve a bits=16
    program: int16 crosses the stage boundaries, int64 reaches the
    collector, and both equal the whole chain."""
    prog = _tiny16()
    frames = np.random.default_rng(9).standard_normal(
        (7, 8, 8, 3)).astype(np.float32)
    runner = prog.compile_runner()
    xq = runner.quantize(frames)
    assert xq.dtype == np.int16
    acc = runner(xq)
    assert acc.dtype == torch.int64
    want = runner.logits(frames)
    ex = ex_t.EngineExecutor(prog, batch_size=4, output="logits")
    np.testing.assert_array_equal(np.stack(ex.serve(list(frames))), want)
    for k in (1, 2, 3):
        with PipelineExecutor(prog, stages=k, batch_size=4,
                              output="logits") as px:
            assert px.route == "oracle"
            mid = px.runners[0](xq[:4])
            if k > 1:
                assert mid.dtype == torch.int16
            got = np.stack(px.serve(list(frames)))
        np.testing.assert_array_equal(got, want)


def test_serve_and_launcher_at_bits16(capsys):
    import json

    from repro_torch.launch import serve_cnn
    from repro_torch.serving import server
    res = server.serve("zf", frames=4, batch=2, bits=16, output="logits",
                       device="cpu", verbose=False, return_outputs=True)
    prog = server.compile_for_serving("zf", bits=16, device="cpu")
    assert prog.bits == 16 and res["route"] == "oracle"
    np.testing.assert_array_equal(res["outputs"], prog.compile_runner(
    ).logits(server.synthetic_stream("zf", 4)))
    assert serve_cnn.main(["--model", "zf", "--bits", "16", "--device",
                           "cpu", "--frames", "4", "--batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bits"] == 16 and out["route"] == "oracle"


def test_registry_refuses_same_shape_different_bits():
    """The reference's ``test_register_refuses_same_shape_different_bits``
    with a real bits=16 program."""
    reg = ProgramRegistry()
    reg.register("m8", _tiny16(seed=0, bits=8))
    with pytest.raises(ValueError) as ei:
        reg.register("m16", _tiny16(seed=1))
    assert "dtype" in str(ei.value) and "m8" in str(ei.value)
    reg.register("m8b", _tiny16(seed=2, bits=8))
    reg.register("m16w", _tiny16(hw=12, seed=3))
    reg.register("fake", object())


def test_staging_rings_refuse_a_batch_of_another_dtype():
    """The host-to-card rings are made in the program's input dtype, and
    quantize-in refuses, rather than casts into, a buffer of any other
    dtype or frame shape, writing nothing. The card's buffers are pinned;
    here the same rings run unpinned."""
    prog = _tiny16()
    runner = prog.compile_runner()
    frames = (np.random.default_rng(7).standard_normal((3, 8, 8, 3))
              * 4).astype(np.float32)
    buf, scratch = ex_t.staging_slot(runner, 4, pinned=False)
    assert buf.dtype == torch.int16 and tuple(buf.shape) == (4, 8, 8, 3)
    view = buf.numpy()
    view[...] = 97
    assert runner.quantize(frames, out=view, scratch=scratch) is view
    np.testing.assert_array_equal(view[:3], runner.quantize(frames))
    assert not view[3:].any()
    for bad in (np.full((4, 8, 8, 3), 5, np.int8),
                np.full((4, 8, 9, 3), 5, np.int16)):
        with pytest.raises(ValueError):
            runner.quantize(frames, out=bad)
        assert (bad == 5).all()
    want = runner.logits(frames)
    # The executor's own ring: a refused batch leaves it where it was.
    ex = ex_t.EngineExecutor(prog, batch_size=4, output="logits")
    with pytest.raises(ValueError):
        ex.submit_batch(frames[:, :, :6], 3)
    np.testing.assert_array_equal(np.stack(ex.serve(list(frames))), want)
    assert ex._staging[0][0].dtype == torch.int16
    # The pipeline's ring: a refused batch gives its slot back.
    px = PipelineExecutor(prog, stages=2, batch_size=4, output="logits")
    free = px._free.qsize()
    with pytest.raises(ValueError):
        px.submit_batch(frames[:, :, :6], 3)
    assert px._free.qsize() == free
    np.testing.assert_array_equal(np.stack(px.serve(list(frames))), want)
    px.close()


def measure() -> dict:
    """The distances the bounds above hold, per model: each hidden
    engine's largest difference (LSB) and share of differing elements,
    the last engine's largest difference over its largest |accumulator|,
    and the logits' relative L2 distance end to end."""
    out = {}
    for name in MODELS:
        pj, pt, _, calib = _cached(name)
        x = qt.quantize_to_exponent_np(calib, pt.e_input, 16)
        hidden, last = {}, None
        for sj, st in zip(pj.steps, pt.steps):
            if st.kind == "pool":
                x = prog_t._pool_int(torch.from_numpy(x), st).numpy()
                continue
            want = np.asarray(prog_j._step_oracle(jnp.asarray(x), sj, 16))
            got = prog_t._step_oracle16(torch.from_numpy(x), st).numpy()
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            if st.requantize:
                hidden[st.name] = (float(diff.max()),
                                   float((diff > 0).mean()))
            else:
                last = float(diff.max() / np.abs(got).max())
            x = got
        want = np.asarray(pj.run(jnp.asarray(calib)))
        got = pt.run(calib).numpy()
        out[name] = {"hidden_max_lsb_and_share": hidden,
                     "last_rel": last,
                     "e2e_rel_l2": float(np.linalg.norm(got - want)
                                         / np.linalg.norm(want))}
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_bits16.py
    import json
    print(json.dumps(measure(), indent=1))
