"""The port's ``compile_model`` / ``EngineProgram`` against the
reference's, fed the same numpy weights and frames.

* The lowered fields (``wq``, ``bias_q``, ``shift``, ``e_in``, ``e_w``,
  ``e_out``, ``e_input``) are equal, on a tiny model and on full-width
  AlexNet and ZF (calibration is one float forward, so this is cheap).
* The int32 accumulators of each port route equal the reference's
  ``oracle`` route's, and the top-1 ids match.
* ``float_forward`` agrees at rtol 1e-4 / atol 1e-5: the two frameworks
  sum the float32 products in other orders, and that is the only cause.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as prog_j
from repro.core import workload as W
from repro_torch.core import program as prog_t
from repro_torch.core import workload as Wt
from repro_torch.models import cnn as cnn_t


def _tiny_layers(L):
    """A stride-2 stem with pad (0, 1), an asymmetric pool (0, 1), a grouped
    conv and two fc layers, widths <= 16."""
    return (
        L.ConvLayer("c1", 3, 8, 3, stride=2),
        L.ConvLayer("p1", 8, 8, 3, stride=2, kind="pool"),
        L.ConvLayer("c2", 8, 16, 3, groups=2),
        L.ConvLayer("fc1", 4 * 4 * 16, 16, 1, kind="fc"),
        L.ConvLayer("fc2", 16, 10, 1, kind="fc"),
    )


def _tiny():
    mj = W.CNNModel("tiny", 16, 3, _tiny_layers(W))
    mt = Wt.CNNModel("tiny", 16, 3, _tiny_layers(Wt))
    params = cnn_t.init_params_np(mt, seed=3)
    rng = np.random.default_rng(11)
    for p in params.values():   # nonzero biases exercise bias_q
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32)
    calib = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    frames = rng.standard_normal((5, 16, 16, 3)).astype(np.float32)
    return mj, mt, params, calib, frames


def _compile_both(mj, mt, params, calib):
    pj = prog_j.compile_model(
        mj, {n: {k: jnp.asarray(v) for k, v in p.items()}
             for n, p in params.items()},
        bits=8, calib_batch=jnp.asarray(calib))
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              bits=8, calib_batch=calib, device="cpu")
    return pj, pt


def _assert_lowered_equal(pj, pt):
    assert pt.e_input == pj.e_input
    assert [s.name for s in pt.steps] == [s.name for s in pj.steps]
    for sj, st in zip(pj.steps, pt.steps):
        assert (st.kind, st.pad, st.relu, st.requantize) == \
            (sj.kind, sj.pad, sj.relu, sj.requantize), st.name
        if st.kind == "pool":
            continue
        assert st.wq.dtype == torch.int8
        np.testing.assert_array_equal(st.wq.numpy(), np.asarray(sj.wq),
                                      err_msg=st.name)
        np.testing.assert_array_equal(st.bias_q.numpy(),
                                      np.asarray(sj.bias_q), err_msg=st.name)
        np.testing.assert_array_equal(st.shift.numpy(), np.asarray(sj.shift),
                                      err_msg=st.name)
        np.testing.assert_array_equal(st.e_w, sj.e_w, err_msg=st.name)
        assert (st.e_in, st.e_out) == (sj.e_in, sj.e_out), st.name


def test_tiny_lowering_matches_reference():
    mj, mt, params, calib, _ = _tiny()
    pj, pt = _compile_both(mj, mt, params, calib)
    _assert_lowered_equal(pj, pt)
    assert pt.fps() == pj.fps()
    assert pt.frame_cycles() == pj.frame_cycles()


def test_tiny_routes_accumulators_and_top1_match_reference_oracle():
    mj, mt, params, calib, frames = _tiny()
    pj, pt = _compile_both(mj, mt, params, calib)
    rj = pj.compile_runner(route="oracle")
    xq = rj.quantize(frames)
    want = np.asarray(rj(xq))
    assert want.dtype == np.int32 and want.shape == (5, 10)
    for route in prog_t.ROUTES:
        rt = pt.compile_runner(route=route)
        np.testing.assert_array_equal(rt.quantize(frames), xq)
        got = rt(xq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)
        np.testing.assert_array_equal(rt.classify(frames),
                                      rj.classify(frames))
    np.testing.assert_array_equal(pt.run(frames).numpy(),
                                  np.asarray(pj.run(jnp.asarray(frames))))
    np.testing.assert_array_equal(
        pt.run(frames, use_kernel=True).numpy(),
        np.asarray(pj.run(jnp.asarray(frames))))


def test_stage_runners_chain_to_the_whole_chain():
    _, mt, params, calib, frames = _tiny()
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              calib_batch=calib, device="cpu")
    whole = pt.compile_runner(route="kernel")
    xq = whole.quantize(frames)
    a, b = pt.compile_stage_runner(0, 2), pt.compile_stage_runner(2, 5)
    assert torch.equal(b(a(xq)), whole(xq))
    with pytest.raises(ValueError):
        b.quantize(frames)
    with pytest.raises(ValueError):
        a.dequantize(a(xq))
    with pytest.raises(ValueError):
        pt.compile_stage_runner(3, 3)
    with pytest.raises(ValueError):
        pt.compile_runner(route="pallas")


def test_route_defaults():
    _, mt, params, calib, _ = _tiny()
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              calib_batch=calib, device="cpu")
    assert pt.compile_runner().route == "f32"      # the reference's, on CPU
    pt.device = torch.device("cuda")               # what the card resolves
    assert pt._resolve_route(None) == "kernel"
    assert pt.compile_runner().cache_size() == -1


def test_float_forward_matches_reference():
    mj, mt, params, calib, _ = _tiny()
    rec_j, rec_t = {}, {}
    want = np.asarray(prog_j.float_forward(
        {n: {k: jnp.asarray(v) for k, v in p.items()}
         for n, p in params.items()}, mj, jnp.asarray(calib), record=rec_j))
    got = prog_t.float_forward(cnn_t.params_from_numpy(params, "cpu"), mt,
                               torch.from_numpy(calib), record=rec_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert rec_t.keys() == rec_j.keys()
    for k in rec_j:
        np.testing.assert_allclose(rec_t[k], rec_j[k], rtol=1e-4, atol=1e-5)


def test_plan_only_and_unported_options():
    mt = Wt.CNN_MODELS["zf"]()
    plan = prog_t.compile_model(mt, device="cpu")
    ref = prog_j.compile_model(W.CNN_MODELS["zf"]())
    assert plan.fps() == ref.fps()
    with pytest.raises(ValueError):
        plan.compile_runner()
    with pytest.raises(NotImplementedError):
        prog_t.compile_model(mt, bits=16, device="cpu")


@pytest.mark.parametrize("name", ["alexnet", "zf"])
def test_full_width_lowering_matches_reference(name):
    """Full width at batch 1. AlexNet: the 11x11 stride-4 stem (K = 363),
    the grouped two-tower convs and the fc head. ZF: the 7x7 stride-2 stem
    and pool with pad (0, 1). Both lower identically."""
    mj, mt = W.CNN_MODELS[name](), Wt.CNN_MODELS[name]()
    params = cnn_t.init_params_np(mt, seed=0)
    calib = np.random.default_rng(1).standard_normal(
        (1, mt.input_hw, mt.input_hw, 3)).astype(np.float32)
    pj, pt = _compile_both(mj, mt, params, calib)
    _assert_lowered_equal(pj, pt)


def test_reference_exp2_exact_only_near_zero():
    """Why ``_lower`` may scale by an exact power of two and still match
    the reference: XLA's ``jnp.exp2`` (``exp(ln2 * x)`` in float32) is
    exact for integer |x| <= 12, and AlexNet's weight exponents stay inside
    that range; at |x| = 13 it is not, and there the two would differ."""
    e = np.arange(-12, 13, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.exp2(jnp.asarray(e))),
                                  np.exp2(e))
    far = np.float32([13.0, -13.0])
    assert not np.array_equal(np.asarray(jnp.exp2(jnp.asarray(far))),
                              np.exp2(far))


def test_cnn_forward_float_and_quantized_match_reference():
    from repro.models import cnn as cnn_j
    mj, mt, params, calib, _ = _tiny()
    pj = {n: {k: jnp.asarray(v) for k, v in p.items()}
          for n, p in params.items()}
    pt = cnn_t.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(   # float: summation order only, as above
        cnn_t.forward(pt, mt, calib).numpy(),
        np.asarray(cnn_j.forward(pj, mj, jnp.asarray(calib))),
        rtol=1e-4, atol=1e-5)
    want = np.asarray(cnn_j.forward(pj, mj, jnp.asarray(calib),
                                    quantized=True))
    for use_kernel in (False, True):
        got = cnn_t.forward(pt, mt, calib, quantized=True,
                            use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
