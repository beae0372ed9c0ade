"""ResNet-50 v1.5 on the port's int8 engine, on the CPU: a tiny residual net
(an identity bottleneck, a projection bottleneck with stride 2, the global
average pool and an fc) against the benchmark's plain reference
(``bench/reference/resnet_int8.py``) bit for bit on every route and at
every stage cut; the residual epilogue of ``gemm_int8``'s plain version
against a hand computation; the published padding; the chains' lowered
steps unchanged; the 56-layer plan without weights. The card runs the
same epilogue in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import program, spans
from repro_torch.core import workload as W
from repro_torch.core.program import EngineStep, compile_model
from repro_torch.kernels.conv2d_int8 import ref
from repro_torch.models.cnn import init_params
from repro_torch.serving.partition import (partition_from_boundaries,
                                           partition_program)
from repro_torch.serving.pipeline_executor import PipelineExecutor

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    path = ROOT / "bench" / "reference" / "resnet_int8.py"
    spec = importlib.util.spec_from_file_location("resnet_int8_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RESNET_REF = _reference()

# The tiny net: a 3x3/2 stem and 3x3/2 max pool, an identity bottleneck,
# a projection bottleneck with stride 2 on its 3x3 (v1.5), the global
# average pool over the 2 x 2 map and an fc.
TINY = [
    {"name": "conv1", "kind": "conv", "in_ch": 3, "out_ch": 8, "kernel": 3,
     "stride": 2, "pad": [1, 1], "relu": True},
    {"name": "maxpool", "kind": "pool", "in_ch": 8, "out_ch": 8,
     "kernel": 3, "stride": 2, "pad": [1, 1]},
    {"name": "b1.conv1", "kind": "conv", "in_ch": 8, "out_ch": 4,
     "kernel": 1, "pad": [0, 0], "relu": True},
    {"name": "b1.conv2", "kind": "conv", "in_ch": 4, "out_ch": 4,
     "kernel": 3, "pad": [1, 1], "relu": True},
    {"name": "b1.conv3", "kind": "conv", "in_ch": 4, "out_ch": 8,
     "kernel": 1, "pad": [0, 0], "relu": True, "residual": "maxpool"},
    {"name": "b2.downsample", "kind": "conv", "in_ch": 8, "out_ch": 16,
     "kernel": 1, "stride": 2, "pad": [0, 0], "relu": False},
    {"name": "b2.conv1", "kind": "conv", "in_ch": 8, "out_ch": 4,
     "kernel": 1, "pad": [0, 0], "relu": True, "src": "b1.conv3"},
    {"name": "b2.conv2", "kind": "conv", "in_ch": 4, "out_ch": 4,
     "kernel": 3, "stride": 2, "pad": [1, 1], "relu": True},
    {"name": "b2.conv3", "kind": "conv", "in_ch": 4, "out_ch": 16,
     "kernel": 1, "pad": [0, 0], "relu": True,
     "residual": "b2.downsample"},
    {"name": "avgpool", "kind": "gap", "in_ch": 16, "out_ch": 16,
     "kernel": 2},
    {"name": "fc", "kind": "fc", "in_ch": 16, "out_ch": 10, "kernel": 1},
]
CFG = {"name": "tinyres", "input_hw": 16, "input_ch": 3, "layers": TINY}
SEEDS = (0, 1, 2 ** 31 + 11)


def _model() -> W.CNNModel:
    return W.CNNModel("tinyres", 16, 3,
                      tuple(W.ConvLayer(**l) for l in TINY))


def _inputs(seed: int):
    m = _model()
    params = init_params(m, seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for p in params.values():
        p["b"] = 0.01 * torch.randn(p["b"].shape, generator=g)
    calib = torch.randn((1, 16, 16, 3), generator=g)
    frames = torch.randn((6, 16, 16, 3), generator=g)
    return m, params, calib, frames


@pytest.fixture(scope="module", params=SEEDS)
def tiny(request):
    m, params, calib, frames = _inputs(request.param)
    prog = compile_model(m, params, calib_batch=calib, theta=1789,
                         bram_total=None, device="cpu")
    want = RESNET_REF.logits(CFG, params, calib, frames, bits=8)
    return prog, frames.numpy(), want


@pytest.mark.parametrize("route", ["kernel", "f32", "oracle"])
def test_tiny_residual_net_equals_the_plain_reference(tiny, route):
    prog, frames, want = tiny
    got = prog.compile_runner(route=route).logits(frames)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_eager_run_equals_the_reference(tiny):
    prog, frames, want = tiny
    for use_kernel in (False, True):
        assert np.array_equal(prog.run(frames, use_kernel=use_kernel).numpy(),
                              want)


def test_the_lowering_carries_the_graph(tiny):
    prog, _, _ = tiny
    by = {s.name: (i, s) for i, s in enumerate(prog.steps)}
    assert by["b1.conv3"][1].skip == by["maxpool"][0]
    assert by["b2.conv3"][1].skip == by["b2.downsample"][0]
    assert by["b2.conv1"][1].src == by["b1.conv3"][0]
    assert not by["b2.downsample"][1].relu and by["b2.conv3"][1].relu
    # A max pool passes its input's format on: b1's skip is conv1's.
    for name, fmt in (("b1.conv3", "conv1"), ("b2.conv3", "b2.downsample")):
        s = by[name][1]
        e_s = by[fmt][1].e_out
        want = np.clip(s.e_in + s.e_w - e_s, -24, 31)
        assert s.skip_shift.tolist() == want.tolist()
        assert s.skip_shift.shape == (s.layer.out_ch,)
    assert by["avgpool"][1].kind == "gap" and by["fc"][1].requantize is False


@pytest.mark.parametrize("route", ["kernel", "oracle"])
def test_stage_runners_equal_the_whole_chain_at_every_cut(tiny, route):
    """Every cut, those inside a bottleneck included (where the block's
    input crosses beside the activation), and every three-way split."""
    prog, frames, want = tiny
    n = len(prog.steps)
    whole = prog.compile_runner(route=route)
    xq = whole.quantize(frames)
    for cut in range(1, n):
        a = prog.compile_stage_runner(0, cut, route=route)
        b = prog.compile_stage_runner(cut, n, route=route)
        mid = a(xq)
        live = prog.live_at(cut)
        assert isinstance(mid, tuple) == (len(live) > 1), cut
        assert np.array_equal(b.dequantize(b(mid)), want), cut
    for c1 in range(1, n - 1):
        for c2 in range(c1 + 1, n):
            rs = [prog.compile_stage_runner(s, e, route=route)
                  for s, e in ((0, c1), (c1, c2), (c2, n))]
            y = xq
            for r in rs:
                y = r(y)
            assert np.array_equal(rs[-1].dequantize(y), want), (c1, c2)


def test_live_tensors_at_a_cut_inside_a_block(tiny):
    prog, _, _ = tiny
    idx = {s.name: i for i, s in enumerate(prog.steps)}
    # Inside the identity block: its input (the pool) and conv1's output.
    assert prog.live_at(idx["b1.conv2"]) == [idx["maxpool"], idx["b1.conv1"]]
    # Between the projection and conv1: the block input and the shortcut.
    assert prog.live_at(idx["b2.conv1"]) == [idx["b1.conv3"],
                                              idx["b2.downsample"]]
    assert prog.live_at(idx["avgpool"]) == [idx["b2.conv3"]]
    assert prog.live_at(len(prog.steps)) == [len(prog.steps) - 1]


@pytest.mark.parametrize("cut", ["b1.conv2", "b2.conv1", "b2.conv3"])
def test_pipeline_executor_hands_on_the_skip_at_a_cut_inside_a_block(
        tiny, cut):
    prog, frames, want = tiny
    b = next(i for i, s in enumerate(prog.steps) if s.name == cut)
    with PipelineExecutor(prog, stages=2, batch_size=4, route="kernel",
                          output="logits",
                          boundaries=(0, b, len(prog.steps))) as px:
        got = px.serve(list(frames))
    assert np.array_equal(np.stack(got), want)


def test_residual_spans_carry_the_stage_launch_owner_and_batch(tiny):
    prog, frames, _ = tiny
    b = next(i for i, s in enumerate(prog.steps) if s.name == "b1.conv2")
    spans.drain()
    spans.enable()
    try:
        with PipelineExecutor(prog, stages=2, batch_size=3, route="kernel",
                              output="logits",
                              boundaries=(0, b, len(prog.steps))) as px:
            px.serve(list(frames))
    finally:
        spans.disable()
    rows = spans.drain()
    res = [r for r in rows if r.name == "residual.launch"]
    # Two batches; block 1 split over both stages, block 2 in stage 1.
    assert len(res) == 2 * 3
    launches = {(r.thread, r.batch): r for r in rows
                if r.name.endswith(".launch") and r.name.startswith("stage")}
    for r in res:
        outer = launches[(r.thread, r.batch)]
        assert r.owner == outer.owner and r.batch is not None
        assert outer.t0 <= r.t0 <= r.t1 <= outer.t1


def test_residual_spans_cover_each_bottleneck_with_its_projection(tiny):
    """A bottleneck's span holds its three convs and its projection
    shortcut, not the stem, the pools or the fc; the lowered steps and
    the layers give the same blocks. ResNet-50's 16 spans hold 52 of its
    53 convs."""
    prog, _, _ = tiny
    block = program._bottlenecks(program._step_reads(prog.steps))
    assert block == program._bottlenecks(_model().reads())
    names = [s.name for s in prog.steps]
    spans_of = {names[b]: [n for n, c in zip(names, block) if c == b]
                for b in set(block) - {None}}
    assert spans_of == {
        "b1.conv3": ["b1.conv1", "b1.conv2", "b1.conv3"],
        "b2.conv3": ["b2.downsample", "b2.conv1", "b2.conv2", "b2.conv3"]}
    m = W.resnet50()
    block = program._bottlenecks(m.reads())
    assert len(set(block) - {None}) == 16
    inside = [l for l, b in zip(m.layers, block) if b is not None]
    assert len(inside) == 52 and all(l.kind == "conv" for l in inside)
    assert {l.name for l, b in zip(m.layers, block) if b is None} == {
        "conv1", "maxpool", "avgpool", "fc"}
    for lyr, b in zip(m.layers, block):
        if b is not None:
            assert lyr.name.rsplit(".", 1)[0] == \
                m.layers[b].name.rsplit(".", 1)[0]


def test_residual_spans_cost_nothing_when_off():
    assert spans.nested("residual.launch") is spans.span("x", owner=0,
                                                          batch=None)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("relu,emit_int32", [(True, False), (False, False),
                                             (True, True)])
def test_residual_epilogue_matches_a_hand_computation(sign, relu,
                                                      emit_int32):
    """``gemm_int8_ref``'s residual: a left shift (exact) for a negative
    alignment shift, an arithmetic right shift (rounding toward -inf, as
    requantize does) for a positive one, added before ReLU and shift."""
    g = torch.Generator().manual_seed(3)
    N, K, M = 7, 20, 6
    x = torch.randint(-128, 128, (N, K), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (K, M), generator=g, dtype=torch.int8)
    shift = torch.randint(0, 12, (M,), generator=g, dtype=torch.int32)
    bias = torch.randint(-5000, 5000, (M,), generator=g, dtype=torch.int32)
    # A residual view with a row stride wider than M.
    res = torch.randint(-128, 128, (N, M + 5), generator=g,
                        dtype=torch.int8)[:, 2:M + 2]
    rs = sign * torch.arange(1, M + 1, dtype=torch.int32)
    got = ref.gemm_int8_ref(x, w, shift, bias, relu=relu,
                            emit_int32=emit_int32, residual=res,
                            res_shift=rs)
    xi, wi, ri = x.long().tolist(), w.long().tolist(), res.long().tolist()
    for n in range(N):
        for m in range(M):
            acc = sum(xi[n][k] * wi[k][m] for k in range(K))
            s = int(rs[m])
            skip = ri[n][m] << -s if s < 0 else ri[n][m] >> s
            v = acc + int(bias[m]) + skip
            if relu:
                v = max(v, 0)
            if not emit_int32:
                v = max(-128, min(127, v >> int(shift[m])))
            assert int(got[n, m]) == v, (n, m)


def test_residual_right_shift_rounds_toward_minus_infinity():
    acc = torch.zeros((1, 4), dtype=torch.int32)
    res = torch.tensor([[-1, -3, 3, 127]], dtype=torch.int8)
    rs = torch.tensor([1, 1, 1, 40], dtype=torch.int32)
    got = ref.bias_relu_ref(acc, None, False, residual=res, res_shift=rs)
    assert got.tolist() == [[-1, -2, 1, 0]]
    left = ref.align_residual(torch.tensor([[-128, 127]], dtype=torch.int8),
                              torch.tensor([-24, -30], dtype=torch.int32))
    assert left.tolist() == [[-2 ** 31, 127 << 24]]


def test_explicit_padding_gives_resnets_windows():
    """(k - 1) // 2 in front: the stem's 7x7/2 pads 3 (a derived pad would
    be (2, 3)), the 3x3/2 max pool and each 3x3/2 pad 1 (derived: (0, 1)),
    so every window sits where the published net puts it."""
    m = W.resnet50()
    by = {l.name: (l, hw) for l, hw in zip(m.layers, m.in_sizes())}
    for name, pad, hw_in, hw_out in [("conv1", (3, 3), 224, 112),
                                     ("maxpool", (1, 1), 112, 56),
                                     ("layer2.0.conv2", (1, 1), 56, 28),
                                     ("layer2.0.downsample", (0, 0), 56, 28),
                                     ("layer4.0.conv2", (1, 1), 14, 7)]:
        lyr, hw = by[name]
        assert (lyr.padding(hw), hw, lyr.out_hw(hw)) == (pad, hw_in, hw_out)
        derived = dataclasses.replace(lyr, pad=None, out_size=hw_out)
        if lyr.kernel > 1 and lyr.stride == 2:
            assert derived.padding(hw) != pad
    # The window of output (0, 0) of a 3x3/2 pad-1 conv covers rows -1..1.
    x = torch.arange(16, dtype=torch.float64).reshape(1, 4, 4, 1)
    w = torch.ones((3, 3, 1, 1), dtype=torch.float64)
    lyr = W.ConvLayer("c", 1, 1, 3, stride=2, pad=(1, 1))
    from repro_torch.core.program import _conv_nhwc
    y = _conv_nhwc(x, w, 2, lyr.padding(4), 1)
    assert y.shape[1:3] == (2, 2)
    assert float(y[0, 0, 0, 0]) == 0 + 1 + 4 + 5


def test_resnet50_counts_and_layers():
    m = W.resnet50()
    assert len(m.layers) == 56
    assert sum(l.computes for l in m.layers) == 54
    assert sum(l.residual is not None for l in m.layers) == 16
    assert sum(l.name.endswith("downsample") for l in m.layers) == 4
    assert sum(l.macs for l in m.layer_workloads(8)) == 4_089_184_256
    weights = sum(l.weight_bytes for l in m.layer_workloads(8))
    biases = sum(l.out_ch for l in m.layers if l.computes)
    assert weights + biases == 25_530_472
    assert W.CNN_MODELS["resnet50"]().layers == m.layers


def test_algorithm1_and_the_partition_plan_resnet50_without_weights():
    m = W.resnet50()
    prog = compile_model(m, theta=2 * 900 - len(m.layers), bram_total=None,
                         device="cpu")
    assert len(prog.allocs) == 56
    assert sum(a.layer.macs > 0 for a in prog.allocs) == 54
    assert prog.fps() > 0
    # The partition needs lowered steps; plan them without weights.
    prog.steps = [EngineStep(name=l.name, kind=l.kind, layer=l,
                             pad=l.padding(hw))
                  for l, hw in zip(m.layers, m.in_sizes())]
    for k in (1, 2, 4, 8):
        part = partition_program(prog, k)
        assert part.n_stages == k and part.boundaries[-1] == 56
        assert 0 < part.balance <= 1.0
    inside = next(i for i, l in enumerate(m.layers)
                  if l.name == "layer1.1.conv2")
    part = partition_from_boundaries(prog, (0, inside, 56))
    assert part.n_stages == 2


def _chain_lowering_as_it_stood(model, params, amax, e_input, bits=8):
    """The chain lowering before residual graphs, frozen: each engine reads
    the previous format, ReLU on all but the last, no skip."""
    from repro_torch.core import quant
    from repro_torch.kernels.conv2d_int8.kernel import k_major_view
    steps = []
    last = [l for l in model.layers if l.kind != "pool"][-1]
    hw, e_act = model.input_hw, e_input
    for lyr in model.layers:
        pad = lyr.padding(hw)
        if lyr.kind == "pool":
            steps.append(EngineStep(name=lyr.name, kind="pool", layer=lyr,
                                    pad=pad))
            hw = lyr.out_hw(hw)
            continue
        w, b = params[lyr.name]["w"], params[lyr.name]["b"]
        e_w = quant.po2_scale(w, axis=-1, bits=bits).numpy().astype(np.int64)
        e_out = quant.po2_exponent(amax[lyr.name], bits)
        b_np = b.numpy().astype(np.float64)
        nz = np.abs(b_np) > 0
        b_mag = np.full(b_np.shape, -(10 ** 9), np.int64)
        b_mag[nz] = np.ceil(np.log2(np.abs(b_np[nz])))
        e_w = np.maximum(e_w, np.maximum(b_mag - 30, e_out - 31) - e_act)
        qmax = 2 ** (bits - 1) - 1
        scale = quant.ref_exp2(-e_w).reshape((1,) * (w.ndim - 1) + (-1,))
        wq = torch.clamp(torch.round(w * scale), -qmax - 1, qmax).to(
            torch.int8).contiguous()
        acc_e = e_act + e_w
        bias_q = np.clip(np.round(b_np / np.exp2(acc_e)), -2 ** 31,
                         2 ** 31 - 1).astype(np.int32)
        shift = np.clip(e_out - acc_e, -31, 31).astype(np.int32)
        steps.append(EngineStep(
            name=lyr.name, kind=lyr.kind, layer=lyr, pad=pad, wq=wq,
            wk=k_major_view(wq), bias_q=torch.as_tensor(bias_q),
            shift=torch.as_tensor(shift), e_in=e_act, e_w=e_w, e_out=e_out,
            relu=lyr is not last, requantize=lyr is not last))
        e_act = e_out
        hw = lyr.out_hw(hw)
    return steps


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.stride() == b.stride()
                and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name,n_layers", [("alexnet", 5), ("vgg16", 4)])
def test_chain_models_lower_field_for_field_as_before(name, n_layers):
    """AlexNet's and VGG16's leading layers (the CPU does not compile the
    full-size nets) lower to the very steps the chain lowering made: every
    field equal, the new ones (``src``, ``skip``, ``skip_shift``) None."""
    from repro_torch.core.program import _lower, float_forward
    from repro_torch.core import quant
    m = W.CNN_MODELS[name]()
    assert m.linear and not any(l.kind == "gap" for l in m.layers)
    head = W.CNNModel(m.name, m.input_hw, m.input_ch, m.layers[:n_layers])
    params = init_params(head, 0, device="cpu")
    calib = torch.randn((1, m.input_hw, m.input_hw, m.input_ch),
                        generator=torch.Generator().manual_seed(0))
    amax = {}
    float_forward(params, head, calib, record=amax)
    e_input = quant.po2_exponent(amax["__input__"], 8)
    got = _lower(head, params, amax, e_input, 8)
    want = _chain_lowering_as_it_stood(head, params, amax, e_input)
    assert len(got) == len(want) == n_layers
    for g, w in zip(got, want):
        for f in dataclasses.fields(EngineStep):
            assert _same(getattr(g, f.name), getattr(w, f.name)), \
                (g.name, f.name)
        assert (g.src, g.skip, g.skip_shift) == (None, None, None)


def test_bits16_refuses_a_residual_model_with_the_reason():
    m, params, calib, _ = _inputs(0)
    with pytest.raises(NotImplementedError, match="linear chains only"):
        compile_model(m, params, bits=16, calib_batch=calib, theta=900,
                      bram_total=None, device="cpu")


def test_a_layer_reading_a_later_layer_is_refused():
    with pytest.raises(ValueError, match="not an earlier layer"):
        W.CNNModel("bad", 8, 3, (
            W.ConvLayer("a", 3, 4, 3, src="b"),
            W.ConvLayer("b", 4, 4, 3)))
