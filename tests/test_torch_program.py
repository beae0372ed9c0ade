"""The port's ``compile_model`` / ``EngineProgram`` against the
reference's, fed the same numpy weights and frames.

* The lowered fields (``wq``, ``bias_q``, ``shift``, ``e_in``, ``e_w``,
  ``e_out``, ``e_input``) are equal, on a tiny model and on full-width
  AlexNet and ZF (calibration is one float forward, so this is cheap).
* The int32 accumulators of each port route equal the reference's
  ``oracle`` route's, and the top-1 ids match.
* ``float_forward`` agrees at rtol 1e-4 / atol 1e-5: the two frameworks
  sum the float32 products in other orders, and that is the only cause.
* The K-major weights the kernel route reads (``EngineStep.wk``) hold
  ``wq``'s values, and the kernel route of a reduced AlexNet and a reduced
  VGG16 equals the reference's (Pallas, interpret mode) bit for bit.
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
    # bits=16 plans as the reference does; other widths are refused.
    plan16 = prog_t.compile_model(mt, theta=900, bits=16, device="cpu")
    ref16 = prog_j.compile_model(W.CNN_MODELS["zf"](), theta=900, bits=16)
    assert plan16.fps() == ref16.fps()
    with pytest.raises(ValueError):
        prog_t.compile_model(mt, bits=4, device="cpu")


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
    """XLA's ``jnp.exp2`` (``exp(ln2 * x)`` in float32) is the exact power
    of two for integer |x| <= 12 and not beyond (x = 13 is one ulp high).
    The port's scale, ``ref_exp2``, equals XLA's value on -40..40 except
    at x = 32 (a weight exponent of -32, a column whose largest |w| is
    below 2^-25), where the two float32 ``exp`` implementations differ."""
    e = np.arange(-12, 13, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.exp2(jnp.asarray(e))),
                                  np.exp2(e))
    far = np.float32([13.0, -13.0])
    assert not np.array_equal(np.asarray(jnp.exp2(jnp.asarray(far))),
                              np.exp2(far))
    x = np.arange(-40, 41, dtype=np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(x)))
    got = prog_t.ref_exp2(x).numpy()
    assert got.dtype == np.float32
    differ = x[got != want]
    np.testing.assert_array_equal(differ, [32.0])
    ok = x != 32
    np.testing.assert_array_equal(got[ok], want[ok])


def test_lowering_matches_reference_at_weight_exponents_13_and_14():
    """fc2's first two columns hold weights of (n + 1/2) / 2^13 and
    (n + 1/2) / 2^14, which put e_w at -13 and -14 and sit exactly on
    rounding ties under the exact power of two. The reference's float32
    exp2(13) is one ulp above 8192, so its ties round away from even;
    the port's lowering gives the same wq, where the exact power of two
    would not."""
    mj, mt, params, calib, _ = _tiny()
    n = np.arange(4, 127, 8, dtype=np.float32)[:16] + 0.5   # 4.5 .. 124.5
    n[-1] = 126.5
    w = params["fc2"]["w"].copy()
    w[:, 0] = n / 2 ** 13
    w[:, 1] = n / 2 ** 14
    params["fc2"]["w"] = w
    pj, pt = _compile_both(mj, mt, params, calib)
    _assert_lowered_equal(pj, pt)
    fc2 = pt.steps[-1]
    assert fc2.e_w[0] == -13 and fc2.e_w[1] == -14
    exact = np.clip(np.round(w[:, 0] * np.float32(2 ** 13)), -128, 127)
    assert not np.array_equal(fc2.wq[:, 0].numpy(), exact)


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


def _reduced_alexnet(L):
    """AlexNet's graph at 227 x 227 with every width cut: the 11 x 11
    stride-4 stem (K = 363, rows padded to 368 on the kernel route), the
    grouped two-tower convs, the pools' explicit sizes, three fc layers."""
    C = L.ConvLayer
    return L.CNNModel("alexnet-reduced", 227, 3, (
        C("conv1", 3, 8, 11, stride=4, out_size=55),
        C("pool1", 8, 8, 3, stride=2, kind="pool", out_size=27),
        C("conv2", 8, 16, 5, groups=2, out_size=27),
        C("pool2", 16, 16, 3, stride=2, kind="pool", out_size=13),
        C("conv3", 16, 24, 3, out_size=13),
        C("conv4", 24, 24, 3, groups=2, out_size=13),
        C("conv5", 24, 16, 3, groups=2, out_size=13),
        C("pool5", 16, 16, 3, stride=2, kind="pool", out_size=6),
        C("fc6", 16 * 6 * 6, 32, 1, kind="fc"),
        C("fc7", 32, 32, 1, kind="fc"),
        C("fc8", 32, 10, 1, kind="fc"),
    ))


def _reduced_vgg16(L):
    """VGG16's graph (blocks of 2, 2, 3, 3, 3 convs, each closed by a
    2 x 2 pool, then three fc layers) at 32 x 32 with widths cut; conv1_1
    keeps K = 27 (rows padded to 32 on the kernel route)."""
    layers = []
    for i, (n, cin, cout) in enumerate(
            [(2, 3, 8), (2, 8, 16), (3, 16, 16), (3, 16, 24), (3, 24, 24)], 1):
        layers += [L.ConvLayer(f"conv{i}_{j + 1}", cin if j == 0 else cout,
                               cout, 3) for j in range(n)]
        layers.append(L.ConvLayer(f"pool{i}", cout, cout, 2, stride=2,
                                  kind="pool"))
    layers += [L.ConvLayer("fc6", 24, 32, 1, kind="fc"),
               L.ConvLayer("fc7", 32, 32, 1, kind="fc"),
               L.ConvLayer("fc8", 32, 10, 1, kind="fc")]
    return L.CNNModel("vgg16-reduced", 32, 3, tuple(layers))


REDUCED = {"alexnet": _reduced_alexnet, "vgg16": _reduced_vgg16}


def _reduced(name, frames):
    mj, mt = REDUCED[name](W), REDUCED[name](Wt)
    params = cnn_t.init_params_np(mt, seed=5)
    rng = np.random.default_rng(7)
    for p in params.values():
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32)
    shape = (frames, mt.input_hw, mt.input_hw, 3)
    calib = rng.standard_normal((1, *shape[1:])).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return mj, mt, params, calib, x


@pytest.mark.parametrize("name", ["tiny", "alexnet", "vgg16"])
def test_k_major_weights_hold_wq_per_group(name):
    """``wk`` is a view of wq's shape and values whose stride along K is 1,
    over [M, K16] rows (K16 the next multiple of 16); each group's rows
    are that group's weights transposed, and the padding is zero."""
    if name == "tiny":
        _, mt, params, calib, _ = _tiny()
    else:
        _, mt, params, calib, _ = _reduced(name, 1)
    pt = prog_t.compile_model(mt, cnn_t.params_from_numpy(params, "cpu"),
                              calib_batch=calib, device="cpu")
    for st in pt.steps:
        if st.kind == "pool":
            continue
        M = st.wq.shape[-1]
        K = st.wq.numel() // M
        k16 = -(-K // 16) * 16
        assert torch.equal(st.wk, st.wq)
        assert st.wk.stride()[-1] == k16 and st.wk.stride()[-2] == 1
        rows = torch.as_strided(st.wk, (M, k16), (k16, 1))
        groups = st.layer.groups
        mg = M // groups
        for g in range(groups):
            wg = st.wq[..., g * mg:(g + 1) * mg].reshape(K, mg)
            assert torch.equal(rows[g * mg:(g + 1) * mg, :K], wg.t())
            view = st.wk[..., g * mg:(g + 1) * mg].reshape(K, mg)
            assert view.stride() == (1, k16)
            assert view.data_ptr() == rows.data_ptr() + g * mg * k16
        assert not rows[:, K:].any(), st.name


@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_reduced_kernel_route_matches_reference_kernel_route(name):
    """The kernel route (K-major weights, 16-byte patch rows; the plain
    version on CPU tensors) against the reference's kernel route (the
    Pallas kernel in interpret mode) on the same numpy weights and frames:
    the lowered fields and the int32 accumulators equal bit for bit."""
    mj, mt, params, calib, frames = _reduced(name, 2)
    pj, pt = _compile_both(mj, mt, params, calib)
    _assert_lowered_equal(pj, pt)
    rj = pj.compile_runner(route="kernel", interpret=True)
    xq = rj.quantize(frames)
    want = np.asarray(rj(xq))
    assert want.shape == (2, 10) and want.dtype == np.int32
    rt = pt.compile_runner(route="kernel")
    np.testing.assert_array_equal(rt.quantize(frames), xq)
    got = rt(xq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = pt.compile_runner(route="oracle")(xq)
    assert torch.equal(oracle, got)
