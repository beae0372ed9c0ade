"""``CompiledRunner``'s CUDA graph replay: on a CUDA device on the kernel
route the runner captures its step range at the second call of a shape
and replays it after; everything else runs launch by launch.

On the CPU: a runner never captures on any route or width, the launch
gate keeps a capture alone against many launching threads, and the
``gemm_int8`` count helpers a replay uses. On the card (marked ``cuda``,
skipped without one, run with ``python -m pytest -m cuda
tests/test_torch_graph_replay.py``): the replay equals the eager chain
bit for bit on full-width AlexNet, VGG16 and ResNet-50, as a whole
runner, through ``EngineExecutor`` and at K = 2 and 4 (ResNet-50 also
cut inside a bottleneck, a tuple in and out); two batches in flight keep
their own answers; another shape runs eagerly; the launch counts a batch
are the eager ones.

This file imports no JAX: the machine with the card has none."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import program
from repro_torch.core import workload as W
from repro_torch.core.program import compile_model
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.models.cnn import init_params


def _tiny(bits: int = 8):
    m = W.CNNModel("tiny", 12, 3, (
        W.ConvLayer("c1", 3, 8, 3),
        W.ConvLayer("p1", 8, 8, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 8, 8, 3, groups=2),
        W.ConvLayer("fc", 6 * 6 * 8, 10, 1, kind="fc")))
    params = init_params(m, seed=0, device="cpu")
    frames = np.random.default_rng(0).standard_normal(
        (4, 12, 12, 3)).astype(np.float32)
    return compile_model(m, params, bits=bits, calib_batch=frames,
                         device="cpu"), frames


@pytest.mark.parametrize("bits,route", [(8, "kernel"), (8, "f32"),
                                        (8, "oracle"), (16, "oracle")])
def test_a_cpu_runner_never_captures(bits, route):
    prog, frames = _tiny(bits)
    runner = prog.compile_runner(route=route)
    xq = torch.as_tensor(runner.quantize(frames))
    want = runner.fn(xq)
    for n in range(1, 4):
        assert torch.equal(runner(xq), want)
        assert (runner.replays, runner.eager_calls) == (0, n)
    assert runner.cache_size() == -1


def test_the_launch_gate_keeps_a_capture_alone():
    """Eight threads take the gate shared and two take it alone, over
    and over with a short switch interval: no launch is inside while a
    capture is, and no two captures are inside at once."""
    gate = program._LaunchGate()
    state = {"launching": 0, "alone": 0}
    bad, lock = [], threading.Lock()
    stop = time.perf_counter() + 1.0

    def launcher():
        while time.perf_counter() < stop:
            with gate.shared():
                with lock:
                    state["launching"] += 1
                    if state["alone"]:
                        bad.append(dict(state))
                with lock:
                    state["launching"] -= 1

    def capturer():
        while time.perf_counter() < stop:
            with gate.alone():
                with lock:
                    state["alone"] += 1
                    if state["launching"] or state["alone"] > 1:
                        bad.append(dict(state))
                time.sleep(1e-4)
                with lock:
                    state["alone"] -= 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launcher) for _ in range(8)] + \
            [threading.Thread(target=capturer) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def test_launch_counts_add_and_take_back():
    before = gemm_kernel.launch_counts()
    assert set(before) == {"launches", "residual", "depthwise",
                           "quantize_in", *gemm_kernel.PATHS}
    delta = {"launches": 9, "large_n": 3, "small_n": 2, "dp4a": 0,
             "implicit": 4, "residual": 1, "depthwise": 2, "quantize_in": 1}
    gemm_kernel.add_launches(delta)
    after = gemm_kernel.launch_counts()
    assert {k: after[k] - before[k] for k in after} == delta
    gemm_kernel.add_launches(delta, -1)
    assert gemm_kernel.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

MODELS = ("alexnet", "vgg16", "resnet50")
BATCH = 16


@pytest.fixture(scope="module")
def progs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.serving.server import compile_for_serving
    return {}, compile_for_serving


def _prog(progs, model):
    cache, compile_for_serving = progs
    if model not in cache:
        cache[model] = compile_for_serving(model, device="cuda")
    return cache[model]


def _frames(model, batches, seed=0):
    from repro_torch.serving.server import synthetic_stream
    return synthetic_stream(model, BATCH * batches, seed)


def _eager_logits(prog, frames):
    """Each batch through a kernel-route runner's ``fn``, launch by
    launch."""
    runner = prog.compile_runner(route="kernel")
    out = []
    for i in range(0, len(frames), BATCH):
        xq = torch.as_tensor(runner.quantize(frames[i:i + BATCH]),
                             device="cuda")
        out.append(runner.dequantize(runner.fn(xq)))
    return np.concatenate(out)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_the_replayed_runner_equals_the_eager_chain(progs, model):
    """A whole-chain runner: its first call eager, its second captured and
    replayed, the rest replayed; each call's accumulators equal ``fn``'s
    on the same batch, and the launch counts a batch are ``fn``'s."""
    prog = _prog(progs, model)
    runner = prog.compile_runner(route="kernel")
    frames = _frames(model, 4)
    xqs = [torch.as_tensor(runner.quantize(frames[i:i + BATCH]),
                           device="cuda")
           for i in range(0, len(frames), BATCH)]
    before = gemm_kernel.launch_counts()
    wants = [runner.fn(x) for x in xqs]
    torch.cuda.synchronize()
    mid = gemm_kernel.launch_counts()
    gots = [runner(x) for x in xqs]
    torch.cuda.synchronize()
    after = gemm_kernel.launch_counts()
    assert (runner.eager_calls, runner.replays) == (1, 3)
    assert runner.cache_size() == 1
    assert all(torch.equal(g, w) for g, w in zip(gots, wants))
    # A host batch replays too: the replay copies it into the graph.
    assert torch.equal(runner(xqs[0].cpu()), wants[0])
    assert (runner.eager_calls, runner.replays) == (1, 4)
    assert {k: after[k] - mid[k] for k in after} == \
        {k: mid[k] - before[k] for k in mid}


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_two_batches_in_flight_keep_their_own_answers(progs, model):
    """After the capture, two batches of different frames launched back
    to back before any wait: each gets its own accumulators (the replay
    hands back a fresh copy of the graph's output)."""
    prog = _prog(progs, model)
    runner = prog.compile_runner(route="kernel")
    frames = _frames(model, 2, seed=1)
    xa, xb = (torch.as_tensor(runner.quantize(frames[i:i + BATCH]),
                              device="cuda") for i in (0, BATCH))
    runner(xa), runner(xa)
    a, b = runner(xa), runner(xb)
    torch.cuda.synchronize()
    assert torch.equal(a, runner.fn(xa)) and torch.equal(b, runner.fn(xb))
    assert not torch.equal(a, b)


@pytest.mark.cuda
def test_another_shape_runs_eagerly(progs):
    prog = _prog(progs, "alexnet")
    runner = prog.compile_runner(route="kernel")
    frames = _frames("alexnet", 1)
    x16 = torch.as_tensor(runner.quantize(frames), device="cuda")
    x8 = x16[:8].clone()
    runner(x16), runner(x16)
    assert (runner.eager_calls, runner.replays) == (1, 1)
    got = runner(x8)
    assert (runner.eager_calls, runner.replays) == (2, 1)
    assert torch.equal(got, runner.fn(x8))
    assert torch.equal(runner(x8.cpu()), got)
    assert (runner.eager_calls, runner.replays) == (3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_the_engine_executor_replays_and_equals_the_eager_chain(progs,
                                                                model):
    from repro_torch.core.executor import EngineExecutor
    prog = _prog(progs, model)
    frames = _frames(model, 5, seed=2)
    ex = EngineExecutor(prog, batch_size=BATCH, output="logits")
    got = np.stack(ex.serve(list(frames)))
    assert (ex.runner.eager_calls, ex.runner.replays) == (1, 4)
    np.testing.assert_array_equal(got, _eager_logits(prog, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_pipeline_stages_replay_and_equal_the_eager_chain(progs, model,
                                                          stages):
    """Every stage captures at its second batch, alone on the card while
    the other stage threads run, and replays after; the logits equal the
    eager chain's and the launch counts a batch are the eager ones."""
    from repro_torch.serving.pipeline_executor import PipelineExecutor
    prog = _prog(progs, model)
    frames = _frames(model, 6, seed=3)
    want = _eager_logits(prog, frames)
    one = prog.compile_runner(route="kernel")
    # The float frames, as the pipeline's ring holds them: stage 0 rounds
    # them on the card, one quantize_in launch a batch.
    xf = torch.as_tensor(frames[:BATCH], device="cuda")
    before = gemm_kernel.launch_counts()
    one.fn(xf)
    torch.cuda.synchronize()
    mid = gemm_kernel.launch_counts()
    per_batch = {k: mid[k] - before[k] for k in mid}
    with PipelineExecutor(prog, stages=stages, batch_size=BATCH,
                          output="logits") as px:
        got = np.stack(px.serve(list(frames)))
    after = gemm_kernel.launch_counts()
    np.testing.assert_array_equal(got, want)
    for r in px.runners:
        assert (r.eager_calls, r.replays) == (1, 5) and r.cache_size() == 1
    assert {k: after[k] - mid[k] for k in after} == \
        {k: 6 * n for k, n in per_batch.items()}


@pytest.mark.cuda
def test_a_resnet_cut_inside_a_bottleneck_replays_tuples(progs):
    """Two stage runners cut inside a bottleneck: the first hands on the
    block's input beside the activation, the second takes both; each
    replayed tuple equals the eager one."""
    prog = _prog(progs, "resnet50")
    cut = next(i for i, s in enumerate(prog.steps)
               if s.name == "layer3.0.conv1")
    first = prog.compile_stage_runner(0, cut, route="kernel")
    second = prog.compile_stage_runner(cut, len(prog.steps), route="kernel")
    frames = _frames("resnet50", 1, seed=4)
    xq = torch.as_tensor(first.quantize(frames), device="cuda")
    mid = first.fn(xq)
    assert isinstance(mid, tuple) and len(mid) == 2
    want = second.fn(mid)
    for _ in range(3):
        got_mid = first(xq)
        got = second(got_mid)
    torch.cuda.synchronize()
    assert first.replays == second.replays == 2
    assert all(torch.equal(g, w) for g, w in zip(got_mid, mid))
    assert torch.equal(got, want)
