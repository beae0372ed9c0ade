"""MobileNetV2 on the port's int8 engine, on the CPU: a cut MobileNetV2
(width 0.25 at 64 x 64: the stem, blocks with and without an expansion,
stride-1 and stride-2 depthwise convs, blocks with and without a skip, the
head, the global average pool and the fc) against the benchmark's plain
reference (``bench/reference/mobilenet_int8.py``) bit for bit on every
route, at K = 1 and through a two-stage pipeline cut inside a block; ReLU6's
ceiling binding; the lowering; the depthwise spans; the published counts
and the plan of the full-width net. On the card (marked ``cuda``):
full-width MobileNetV2 on the kernel route, replayed, against the integer
oracle, with its launches counted. Run those with

    python -m pytest -m cuda tests/test_torch_mobilenet.py
"""

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
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.serving.partition import partition_program
from repro_torch.serving.pipeline_executor import PipelineExecutor

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    path = ROOT / "bench" / "reference" / "mobilenet_int8.py"
    spec = importlib.util.spec_from_file_location("bench.reference."
                                                  "mobilenet_int8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
SEEDS = (0, 2 ** 31 + 11)
HW = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and beside the other
    test workers on the same cores OpenMP's spinning threads slowed these
    cases a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(m: W.CNNModel) -> dict:
    """The benchmark's configuration form of ``m``'s layers."""
    layers = []
    for l in m.layers:
        d = {"name": l.name, "kind": l.kind, "in_ch": l.in_ch,
             "out_ch": l.out_ch, "kernel": l.kernel, "stride": l.stride,
             "groups": l.groups, "residual": l.residual}
        if l.kind == "conv":
            d.update(pad=list(l.pad), relu=bool(l.relu), relu6=l.relu6)
        layers.append(d)
    return {"name": m.name, "input_hw": m.input_hw,
            "input_ch": m.input_ch, "layers": layers}


def _inputs(seed: int, gain: float):
    """Weights drawn normal over sqrt(fan in) times ``gain`` (2 drives the
    activations past 6, so ReLU6's ceilings bind), biases N(0, 0.01^2)."""
    m = W.mobilenet_v2(0.25, HW, 10)
    g = torch.Generator().manual_seed(seed)
    params = {}
    for l in m.layers:
        if not l.computes:
            continue
        shape = (l.in_ch, l.out_ch) if l.kind == "fc" else \
            (l.kernel, l.kernel, l.in_ch // l.groups, l.out_ch)
        fan_in = int(np.prod(shape[:-1]))
        params[l.name] = {
            "w": torch.randn(shape, generator=g) * gain / fan_in ** 0.5,
            "b": 0.01 * torch.randn((l.out_ch,), generator=g)}
    calib = torch.randn((1, HW, HW, 3), generator=g)
    frames = torch.randn((5, HW, HW, 3), generator=g)
    return m, params, calib, frames


@pytest.fixture(scope="module", params=[(s, gain) for s in SEEDS
                                        for gain in (1.0, 2.0)],
                ids=lambda p: f"seed{p[0]}-gain{p[1]:g}")
def tiny(request):
    m, params, calib, frames = _inputs(*request.param)
    prog = compile_model(m, params, calib_batch=calib,
                         theta=2 * 900 - len(m.layers), bram_total=None,
                         device="cpu")
    want = REF.logits(config(m), params, calib, frames, bits=8)
    return prog, frames.numpy(), want, request.param[1]


@pytest.mark.parametrize("route", ["kernel", "f32", "oracle"])
def test_tiny_mobilenet_equals_the_plain_reference(tiny, route):
    prog, frames, want, _ = tiny
    got = prog.compile_runner(route=route).logits(frames)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_relu6_ceilings_bind_and_matter(tiny, monkeypatch):
    """At gain 2 every ReLU6 engine's ceiling is below 127, and the same
    program without its ceilings answers otherwise."""
    prog, frames, want, gain = tiny
    six = [s for s in prog.steps if s.layer.relu6]
    assert len(six) == 35
    assert all(s.qmax == program.relu6_ceiling(s.e_out) for s in six)
    if gain < 2:
        return
    assert all(s.qmax < 127 for s in six)
    steps = [dataclasses.replace(s, qmax=None) for s in prog.steps]
    monkeypatch.setattr(prog, "steps", steps)
    assert not np.array_equal(
        prog.compile_runner(route="kernel").logits(frames), want)


def test_the_lowering_carries_the_inverted_residuals(tiny):
    prog, _, _, _ = tiny
    by = {s.name: (i, s) for i, s in enumerate(prog.steps)}
    dw = [s for s in prog.steps if s.layer.depthwise]
    assert len(dw) == 17 and all(s.wk is None and s.wq.is_contiguous()
                                 for s in dw)
    assert sum(s.layer.stride == 2 for s in dw) == 4
    for s in prog.steps:
        if s.name.endswith("project"):
            assert not s.relu and s.qmax is None
    # Width 0.25 keeps block 1's width (8 channels), so it adds its input.
    assert by["block1.project"][1].skip == by["stem"][0]
    assert by["block3.project"][1].skip == by["block2.project"][0]
    assert by["block2.project"][1].skip is None
    assert by["avgpool"][1].kind == "gap" and not by["fc"][1].requantize


@pytest.mark.parametrize("cut", ["block3.dw", "block3.project",
                                 "block11.expand"])
def test_a_two_stage_pipeline_cut_inside_a_block(tiny, cut):
    """K = 2 with the cut inside a block whose projection adds its input:
    the block's input crosses beside the activation."""
    prog, frames, want, _ = tiny
    b = next(i for i, s in enumerate(prog.steps) if s.name == cut)
    assert len(prog.live_at(b)) == (1 if cut == "block11.expand" else 2)
    with PipelineExecutor(prog, stages=2, batch_size=4, route="kernel",
                          output="logits",
                          boundaries=(0, b, len(prog.steps))) as px:
        got = px.serve(list(frames))
    assert np.array_equal(np.stack(got), want)


def test_depthwise_spans_nest_in_their_block_and_stage(tiny):
    prog, frames, _, _ = tiny
    b = next(i for i, s in enumerate(prog.steps) if s.name == "block3.dw")
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
    dws = [r for r in rows if r.name == "depthwise.launch"]
    assert len(dws) == 2 * 17                     # two batches
    stage = {(r.thread, r.batch): r for r in rows
             if r.name.startswith("stage") and r.name.endswith(".launch")}
    blocks = [r for r in rows if r.name == "residual.launch"]
    for r in dws:
        outer = stage[(r.thread, r.batch)]
        assert r.owner == outer.owner and r.batch is not None
        assert outer.t0 <= r.t0 <= r.t1 <= outer.t1
    # Blocks with a skip hold their depthwise conv's span.
    inside = [r for r in dws if any(b.thread == r.thread and b.t0 <= r.t0
                                    and r.t1 <= b.t1 for b in blocks)]
    assert len(inside) == 2 * 11
    assert spans.nested("depthwise.launch") is spans.span("x", owner=0,
                                                           batch=None)


def test_mobilenet_v2_counts_and_layers():
    m = W.mobilenet_v2()
    assert W.CNN_MODELS["mobilenetv2"]().layers == m.layers
    assert len(m.layers) == 54 and m.input_hw == 224
    convs = [l for l in m.layers if l.kind == "conv"]
    assert len(convs) == 52
    assert sum(l.depthwise for l in m.layers) == 17
    assert sum(l.name.endswith("expand") for l in m.layers) == 16
    assert sum(l.name.endswith("project") for l in m.layers) == 17
    assert sum(l.residual is not None for l in m.layers) == 10
    assert sum(l.relu6 for l in m.layers) == 35
    assert sum(l.macs for l in m.layer_workloads(8)) == 300_774_272
    weights = sum(l.weight_bytes for l in m.layer_workloads(8))
    biases = sum(l.out_ch for l in m.layers if l.computes)
    assert weights + biases == 3_487_816
    # With BatchNorm kept apart (its scale and shift beside each conv, no
    # conv bias): torchvision's published count.
    bn = sum(2 * l.out_ch for l in convs)
    fc = m.layers[-1]
    assert weights + bn + fc.out_ch == 3_504_872
    assert m.in_sizes()[-2] == 7 and m.layers[-2].kernel == 7
    assert [l.out_ch for l in m.layers if l.name.endswith("project")][-1] \
        == 320
    with pytest.raises(ValueError, match="ReLU6"):
        W.ConvLayer("x", 4, 4, 1, relu=False, relu6=True)


def test_algorithm1_and_the_partition_plan_mobilenet_v2_without_weights():
    """Algorithm 1 sees a depthwise conv as C = 1; the K = 2 cut falls
    where its cycles balance (``PERF.md`` gives where)."""
    m = W.mobilenet_v2()
    prog = compile_model(m, theta=2 * 900 - len(m.layers), bram_total=None,
                         device="cpu")
    assert len(prog.allocs) == 54 and prog.fps() > 0
    dw = [a.layer for a in prog.allocs if a.layer.name.endswith(".dw")]
    assert len(dw) == 17 and all(l.C == 1 and l.R == 3 for l in dw)
    prog.steps = [EngineStep(name=l.name, kind=l.kind, layer=l,
                             pad=l.padding(hw))
                  for l, hw in zip(m.layers, m.in_sizes())]
    for k in (1, 2, 4):
        part = partition_program(prog, k)
        assert part.n_stages == k and part.boundaries[-1] == 54
        assert 0 < part.balance <= 1.0


def test_bits16_refuses_relu6():
    m, params, calib, _ = _inputs(0, 1.0)
    with pytest.raises(NotImplementedError, match="ReLU6"):
        compile_model(m, params, bits=16, calib_batch=calib, theta=900,
                      bram_total=None, device="cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_full_width_mobilenet_v2_on_the_kernel_route():
    """One batch of 16 of full-width MobileNetV2: the kernel route (eager,
    captured, replayed) equals the integer oracle on the card; a batch
    launches 17 ``dwconv_int8`` and 36 ``gemm_int8``, no per-channel
    GEMM."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from bench.core import inputs
    m = W.mobilenet_v2()
    cfg = config(m)
    params = inputs.make_params(
        dict(cfg, layers=[l for l in cfg["layers"] if l["kind"] != "gap"]),
        3, "cuda")
    calib = inputs.make_calib(cfg, 3, "cuda")
    frames = inputs.make_frames(cfg, 16, 3, "cuda").cpu().numpy()
    prog = compile_model(m, params, calib_batch=calib, theta=1746,
                         bram_total=None, device="cuda")
    oracle = prog.compile_runner(route="oracle")
    want = oracle.dequantize(oracle(oracle.quantize(frames)))
    r = prog.compile_runner()
    xq = r.quantize(frames)
    for i in range(3):
        before = gemm_kernel.launch_counts()
        got = r.dequantize(r(xq))
        torch.cuda.synchronize()
        after = gemm_kernel.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        assert delta["depthwise"] == 17 and delta["launches"] == 36, delta
        assert np.array_equal(got, want), i
    assert r.replays == 2           # the capture's call replays too
    ref = REF.logits(cfg, params, calib, torch.as_tensor(frames,
                                                         device="cuda"))
    assert np.array_equal(want, ref)
