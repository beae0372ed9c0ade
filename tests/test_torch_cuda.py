"""The Hopper kernels on the card, against their plain versions on the
same CUDA tensors: ``gemm_int8`` bit for bit, ``flash_attention`` and
``linear_scan`` within the reference's tolerances (2e-5 in float32, 3e-2
in bfloat16, as ``tests/test_kernels.py`` states them; each attention
output row also within a fraction of its own RMS); the bits=16 engine on
the card bit for bit against the CPU, the residual epilogue on every
tiling and full-width ResNet-50 v1.5, an imported LeNet's golden on
every route, ``linear_scan``'s gradient against autograd through its
plain version, and a reduced RecurrentGemma train step against the CPU.
The CUDA kernels
have no CPU mode, so these tests are marked ``cuda`` and skip without a
GPU; on a machine with one (and ``nvcc``) run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.kernels.conv2d_int8 import ops, ref
from repro_torch.kernels.conv2d_int8.kernel import (Plan, gemm_int8,
                                                    k_major_view)
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_rows_close(got, want, rel):
    """Each output row's largest error under ``rel`` of the row's RMS. On
    randn inputs a row averaging n keys has an RMS of about 1/sqrt(n),
    near the absolute 3e-2 on the long cases; dropping or repeating one
    128-key tile there moves a row by a quarter to a third of its RMS."""
    diff = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt().clamp_min(1e-30)
    assert float((diff / rms).max()) <= rel


def _int(gen, shape, lo, hi, dtype=torch.int8):
    return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                         device="cuda")


@pytest.mark.parametrize("n,k,m", [(17, 40, 33), (128, 128, 128),
                                   (300, 100, 260), (1, 9, 1), (65, 363, 96),
                                   (16, 4096, 1000), (70, 65, 130)])
@pytest.mark.parametrize("relu,emit_int32", [(False, False), (True, False),
                                             (True, True)])
def test_kernel_matches_plain_version(gen, n, k, m, relu, emit_int32):
    x, w = _int(gen, (n, k), -128, 128), _int(gen, (k, m), -128, 128)
    shift = _int(gen, (m,), -31, 32, torch.int32)
    bias = _int(gen, (m,), -2 ** 30, 2 ** 30, torch.int32)
    before = gemm_int8.launches
    got = gemm_int8(x, w, shift, bias, relu=relu, emit_int32=emit_int32)
    want = ref.gemm_int8_ref(x, w, shift, bias, relu=relu,
                             emit_int32=emit_int32)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 1
    assert torch.equal(got, want)


def test_kernel_takes_unaligned_row_views(gen):
    """Operands that start off a 4-byte boundary or have an odd leading
    dimension take the kernel's byte-load path; a group's column slice of
    the weights takes the 4-byte path with ld > M."""
    xf, wf = _int(gen, (50, 301), -128, 128), _int(gen, (300, 90), -128, 128)
    shift = _int(gen, (90,), 0, 16, torch.int32)
    for x, w, s in [(xf[:, 1:], wf, shift),                 # unaligned x
                    (xf[:, :300], wf[:, 3:50], shift[3:50]),  # odd offset
                    (xf[:, :300], wf[:, 40:80], shift[40:80])]:
        got = gemm_int8(x, w, s, relu=True)
        want = ref.gemm_int8_ref(x, w, s, relu=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _path_of(fn):
    """Run ``fn`` and return (its result, the one gemm_int8 path it
    launched)."""
    before = dict(gemm_int8.launches_by_path)
    out = fn()
    torch.cuda.synchronize()
    ran = [p for p, n in gemm_int8.launches_by_path.items()
           if n != before[p]]
    assert len(ran) == 1 and sum(gemm_int8.launches_by_path.values()) == \
        sum(before.values()) + 1
    return out, ran[0]


def _patch_rows(gen, n, k):
    """x [n, k] as a view into rows of a multiple of 16 bytes whose padding
    holds 127 (the kernel route's patches)."""
    rows = torch.full((n, -(-k // 16) * 16), 127, dtype=torch.int8,
                      device="cuda")
    rows[:, :k] = _int(gen, (n, k), -128, 128)
    return rows[:, :k]


@pytest.mark.parametrize("n,k,m", [(17, 40, 33), (128, 128, 128),
                                   (300, 100, 260), (1, 9, 1), (65, 363, 96),
                                   (16, 4096, 1000), (70, 65, 130)])
@pytest.mark.parametrize("relu,emit_int32", [(False, False), (True, False),
                                             (True, True)])
def test_k_major_w_matches_plain_version(gen, n, k, m, relu, emit_int32):
    """The same cases with w K-major and x in 16-byte rows: the wgmma
    paths (N <= 64 small, else large), bit for bit."""
    x = _patch_rows(gen, n, k)
    w = k_major_view(_int(gen, (k, m), -128, 128))
    shift = _int(gen, (m,), -31, 32, torch.int32)
    bias = _int(gen, (m,), -2 ** 30, 2 ** 30, torch.int32)
    got, path = _path_of(lambda: gemm_int8(x, w, shift, bias, relu=relu,
                                           emit_int32=emit_int32))
    assert path == ("small_n" if n <= 64 else "large_n")
    assert torch.equal(got, ref.gemm_int8_ref(x, w, shift, bias, relu=relu,
                                              emit_int32=emit_int32))


# Forced tilings at the edges: (N, K, M, plan). Small N at 1, 16, 17 and
# 64, wider than one tile; a K that ends inside a stage; M ragged against
# every width; 64- and 128-row tiles, one or several column tiles; every
# tiling the kernels are built for (``kernel.plans``).
PLAN_CASES = [
    (1, 1000, 1000, Plan("small_n", 16, 1)),
    (16, 4000, 1000, Plan("small_n", 16, 1)),
    (17, 4100, 97, Plan("small_n", 32, 1)),
    (64, 1000, 1000, Plan("small_n", 64, 1)),
    (65, 1000, 96, Plan("small_n", 64, 1)),         # two B tiles
    (65, 1000, 1000, Plan("large_n", 64, 1)),
    (300, 1700, 184, Plan("large_n", 64, 1)),
    (300, 1700, 184, Plan("large_n", 64, 2)),
    (300, 700, 520, Plan("large_n", 128, 2)),
    (1000, 27, 64, Plan("large_n", 64, 2)),
    (700, 3000, 130, Plan("large_n", 64, 1)),
    (700, 3000, 130, Plan("large_n", 96, 2)),
    (700, 3000, 130, Plan("large_n", 128, 2)),
]


@pytest.mark.parametrize("N,K,M,plan", PLAN_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3].path}-{c[3].width}"
                              f"-{c[3].warpgroups}" for c in PLAN_CASES])
@pytest.mark.parametrize("relu,emit_int32", [(True, False), (False, True)])
def test_wgmma_plans_at_their_edges(gen, monkeypatch, N, K, M, plan, relu,
                                    emit_int32):
    """Each tiling forced in place of ``plan_for``'s, bit for bit."""
    monkeypatch.setattr(gemm_kernel, "plan_for", lambda *shape: plan)
    x = _patch_rows(gen, N, K)
    w = k_major_view(_int(gen, (K, M), -128, 128))
    shift = _int(gen, (M,), -20, 32, torch.int32)
    bias = _int(gen, (M,), -2 ** 30, 2 ** 30, torch.int32)
    got, path = _path_of(lambda: gemm_int8(x, w, shift, bias, relu=relu,
                                           emit_int32=emit_int32))
    assert path == plan.path
    assert torch.equal(got, ref.gemm_int8_ref(x, w, shift, bias, relu=relu,
                                              emit_int32=emit_int32))


@pytest.mark.parametrize("N,K,M,plan", PLAN_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3].path}-{c[3].width}"
                              f"-{c[3].warpgroups}" for c in PLAN_CASES])
@pytest.mark.parametrize("relu,emit_int32", [(True, False), (False, True)])
def test_residual_epilogue_on_every_plan(gen, monkeypatch, N, K, M, plan,
                                         relu, emit_int32):
    """Each tiling with a residual (a bottleneck's skip): an int8 [N, M]
    view with a row stride wider than M, aligned by shifts of both signs
    (left up to 24, right up to 31), added before ReLU and shift; staged
    and unstaged int8 stores and the int32 one, bit for bit. A launch with
    a residual counts once more in ``residual_launches``."""
    monkeypatch.setattr(gemm_kernel, "plan_for", lambda *shape: plan)
    x = _patch_rows(gen, N, K)
    w = k_major_view(_int(gen, (K, M), -128, 128))
    shift = _int(gen, (M,), -20, 32, torch.int32)
    bias = _int(gen, (M,), -2 ** 28, 2 ** 28, torch.int32)
    res = _int(gen, (N, M + 24), -128, 128)[:, 8:M + 8]
    rs = _int(gen, (M,), -24, 32, torch.int32)
    before = gemm_int8.residual_launches
    got, path = _path_of(lambda: gemm_int8(
        x, w, shift, bias, relu=relu, emit_int32=emit_int32, residual=res,
        res_shift=rs))
    assert path == plan.path
    assert gemm_int8.residual_launches == before + 1
    assert torch.equal(got, ref.gemm_int8_ref(
        x, w, shift, bias, relu=relu, emit_int32=emit_int32, residual=res,
        res_shift=rs))


def test_residual_epilogue_on_the_dp4a_kernel(gen):
    xf = _int(gen, (50, 301), -128, 128)
    w = k_major_view(_int(gen, (300, 90), -128, 128))
    shift = _int(gen, (90,), 0, 16, torch.int32)
    res = _int(gen, (50, 91), -128, 128)[:, 1:]
    rs = _int(gen, (90,), -24, 32, torch.int32)
    for relu, emit in ((True, False), (False, True)):
        got, path = _path_of(lambda: gemm_int8(
            xf[:, 1:], w, shift, relu=relu, emit_int32=emit, residual=res,
            res_shift=rs))
        assert path == "dp4a"
        assert torch.equal(got, ref.gemm_int8_ref(
            xf[:, 1:], w, shift, relu=relu, emit_int32=emit, residual=res,
            res_shift=rs))


def test_resnet50_chain_runs_on_the_wgmma_paths():
    """One batch of 16 frames of full-width ResNet-50 v1.5 on the kernel
    route: 54 launches, the 53 convs on the large-N kernels (16 of them
    adding their block's skip), the fc on the small-N one, none on dp4a;
    the accumulators equal the oracle route's. Two stages cut inside a
    bottleneck, its input handed on beside the activation, equal the
    whole chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.serving.pipeline_executor import PipelineExecutor
    from repro_torch.serving.server import (compile_for_serving,
                                            synthetic_stream)
    prog = compile_for_serving("resnet50", device="cuda")
    runner = prog.compile_runner(route="kernel")
    frames = synthetic_stream("resnet50", 16)
    xq = torch.as_tensor(runner.quantize(frames), device="cuda")
    before = dict(gemm_int8.launches_by_path)
    res_before = gemm_int8.residual_launches
    acc = runner(xq)
    torch.cuda.synchronize()
    ran = {p: n - before[p] for p, n in gemm_int8.launches_by_path.items()}
    assert ran == {"large_n": 53, "small_n": 1, "dp4a": 0}
    assert gemm_int8.residual_launches - res_before == 16
    assert torch.equal(acc, prog.compile_runner(route="oracle")(xq))
    cut = next(i for i, s in enumerate(prog.steps)
               if s.name == "layer3.0.conv1")
    assert len(prog.live_at(cut)) == 2
    with PipelineExecutor(prog, stages=2, batch_size=16, route="kernel",
                          output="logits",
                          boundaries=(0, cut, len(prog.steps))) as px:
        got = px.serve(list(frames))
    assert np.array_equal(np.stack(got), runner.dequantize(acc))


def test_wgmma_reaches_the_int32_rails():
    """K = 65536 with all-equal rows and columns puts the accumulators at
    2^30 and -2^30 + 2^23; the biases carry them exactly onto INT32_MAX
    and INT32_MIN, through the small-N kernel (256 K stages a block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    K = 65536
    rows = torch.tensor([-128, 127, 0, 1, -1], dtype=torch.int8)
    x = rows[:, None].expand(5, K).contiguous().cuda()
    w = k_major_view(torch.cat([torch.full((K, 63), -128, dtype=torch.int8),
                                torch.full((K, 63), 127, dtype=torch.int8)],
                               dim=1).cuda())
    shift = torch.cat([torch.arange(-31, 32)] * 2).to(torch.int32).cuda()
    i32 = torch.iinfo(torch.int32)
    bias = torch.cat([torch.full((63,), i32.max - 2 ** 30),
                      torch.full((63,), i32.min + 2 ** 30 - 2 ** 23)]).to(
        torch.int32).cuda()
    for relu in (False, True):
        for emit_int32 in (False, True):
            got, path = _path_of(lambda: gemm_int8(
                x, w, shift, bias, relu=relu, emit_int32=emit_int32))
            assert path == "small_n"
            assert torch.equal(got, ref.gemm_int8_ref(
                x, w, shift, bias, relu=relu, emit_int32=emit_int32))
    acc = gemm_int8(x, w, shift, bias, emit_int32=True)
    assert int(acc[0, 0]) == i32.max and int(acc[0, 63]) == i32.min


def test_unaligned_views_take_the_dp4a_kernel(gen):
    """What TMA cannot take goes to the first design, still exact: an x
    off a 16-byte boundary, K-major w rows of a stride off 16 bytes, a
    row-major w."""
    xf = _int(gen, (50, 301), -128, 128)
    wf = _int(gen, (90, 310), -128, 128)            # [M, K + 10] rows
    shift = _int(gen, (90,), 0, 16, torch.int32)
    w_k = wf[:, :300].t()                           # stride 310 along M
    for x, w in [(xf[:, 1:], k_major_view(wf[:, :300].t().contiguous())),
                 (xf[:, :300], w_k),
                 (xf[:, :300], w_k.contiguous())]:
        got, path = _path_of(lambda: gemm_int8(x, w, shift, relu=True))
        assert path == "dp4a"
        assert torch.equal(got, ref.gemm_int8_ref(x, w, shift, relu=True))


def test_alexnet_chain_runs_on_the_wgmma_paths():
    """One batch of full-width AlexNet on the kernel route: 11 launches,
    the 8 conv launches on the large-N kernels, fc6-fc8 on the small-N
    one, none on dp4a; the accumulators equal the oracle route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.serving.server import (compile_for_serving,
                                            synthetic_stream)
    prog = compile_for_serving("alexnet", device="cuda")
    runner = prog.compile_runner(route="kernel")
    xq = torch.as_tensor(runner.quantize(synthetic_stream("alexnet", 4)),
                         device="cuda")
    before = dict(gemm_int8.launches_by_path)
    acc = runner(xq)
    torch.cuda.synchronize()
    ran = {p: n - before[p] for p, n in gemm_int8.launches_by_path.items()}
    assert ran == {"large_n": 8, "small_n": 3, "dp4a": 0}
    assert torch.equal(acc, prog.compile_runner(route="oracle")(xq))


def test_four_stage_workers_launch_gemm_int8_concurrently():
    """Full-width AlexNet through a K=4 ``PipelineExecutor`` on the kernel
    route for 200 batches: four stage threads launch ``gemm_int8`` at once
    (its library bound at first use, its counts updated from every
    thread). Every batch's logits equal the whole chain's bit for bit, and
    the counts are exact: 8 ``large_n`` + 3 ``small_n`` a batch, no
    ``dp4a``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import numpy as np

    from repro_torch.serving import PipelineExecutor
    from repro_torch.serving.server import (compile_for_serving,
                                            synthetic_stream)
    batch, n_batches, distinct = 4, 200, 8
    prog = compile_for_serving("alexnet", device="cuda")
    stream = synthetic_stream("alexnet", batch * distinct, 3)
    whole = prog.compile_runner(route="kernel")
    want = np.concatenate([whole.logits(stream[i:i + batch])
                           for i in range(0, len(stream), batch)])
    torch.cuda.synchronize()
    frames = [stream[i % len(stream)] for i in range(batch * n_batches)]
    before = dict(gemm_int8.launches_by_path)
    with PipelineExecutor(prog, stages=4, batch_size=batch, route="kernel",
                          output="logits") as px:
        got = np.stack(px.serve(frames))
    ran = {p: n - before[p] for p, n in gemm_int8.launches_by_path.items()}
    assert px.partition.n_stages == 4 and px.route == "kernel"
    assert ran == {"large_n": 8 * n_batches, "small_n": 3 * n_batches,
                   "dp4a": 0}
    np.testing.assert_array_equal(got, np.tile(want, (n_batches
                                                      // distinct, 1)))


def _on_cpu(prog):
    """The same compiled program with its tensors on the CPU."""
    import dataclasses
    return dataclasses.replace(prog, steps=prog.steps_on("cpu"),
                               device=torch.device("cpu"))


def test_bits16_on_the_card_equals_the_cpu():
    """Full-width AlexNet at bits=16 on the card (the exact integer oracle:
    int16 activations, int64 accumulators) through the whole-chain runner,
    the single executor (its pinned int16 staging ring) and a K=2
    ``PipelineExecutor``: bit for bit the same program run on the CPU, and
    no ``gemm_int8`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import numpy as np

    from repro_torch.core.executor import EngineExecutor
    from repro_torch.serving import PipelineExecutor
    from repro_torch.serving.server import (compile_for_serving,
                                            synthetic_stream)
    prog = compile_for_serving("alexnet", bits=16, device="cuda")
    cpu = _on_cpu(prog)
    frames = synthetic_stream("alexnet", 8, 1)
    runner, runner_cpu = prog.compile_runner(), cpu.compile_runner()
    assert runner.route == "oracle"
    before = gemm_int8.launches
    xq = runner.quantize(frames[:4])
    assert xq.dtype == np.int16
    acc = runner(xq)
    assert acc.dtype == torch.int64 and acc.is_cuda
    assert torch.equal(acc.cpu(), runner_cpu(xq))
    want = runner_cpu.logits(frames)
    ex = EngineExecutor(prog, batch_size=4, output="logits")
    np.testing.assert_array_equal(np.stack(ex.serve(list(frames))), want)
    buf, scratch = ex._staging[0]
    assert buf.dtype == torch.int16 and buf.is_pinned()
    assert scratch.dtype == np.float32
    with PipelineExecutor(prog, stages=2, batch_size=4,
                          output="logits") as px:
        got = np.stack(px.serve(list(frames)))
    np.testing.assert_array_equal(got, want)
    assert gemm_int8.launches == before
    for route in ("kernel", "f32"):
        with pytest.raises(NotImplementedError):
            prog.compile_runner(route=route)


def test_lenet_golden_holds_on_every_route_on_the_card():
    """``examples/lenet.json`` imported on the card: its f32 golden
    reproduces on the oracle and kernel routes there and on the CPU, and
    the kernel route launches conv1 and conv2 on ``large_n``, fc1 (K 400)
    on ``small_n`` and fc2, fc3 (rows of 120 and 84 bytes, not on 16-byte
    strides) on ``dp4a``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import os

    from repro_torch import compiler
    from repro_torch.serving import ProgramRegistry
    spec = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "lenet.json")
    reg = ProgramRegistry()
    name, golden = reg.register_imported(spec, seed=0, device="cuda")
    prog = reg.get(name)
    before = dict(gemm_int8.launches_by_path)
    compiler.check_golden(prog, golden, seed=0, route="kernel")
    ran = {p: n - before[p] for p, n in gemm_int8.launches_by_path.items()}
    assert ran == {"large_n": 2, "small_n": 1, "dp4a": 2}
    for route in ("f32", "oracle"):
        compiler.check_golden(prog, golden, seed=0, route=route)
        compiler.check_golden(_on_cpu(prog), golden, seed=0, route=route)


def test_grouped_conv_launches_once_per_group(gen):
    x = _int(gen, (2, 13, 13, 32), -128, 128)
    w = _int(gen, (3, 3, 16, 24), -40, 40)
    shift = _int(gen, (24,), 2, 12, torch.int32)
    bias = _int(gen, (24,), -5000, 5000, torch.int32)
    before = gemm_int8.launches
    got = ops.conv2d_int8(x, w, shift, bias, padding=((1, 1), (1, 1)),
                          groups=2, relu=True)
    want = ref.conv2d_int8_ref(x, w, shift, bias, padding=((1, 1), (1, 1)),
                               groups=2, relu=True)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 2
    assert torch.equal(got, want)


# (B, Sq, Skv, H, KV, d, causal, window): the reference's test shapes, a
# query block shorter than the keys and one longer, GQA and MQA, ragged
# lengths that fill no tile, every head dim the kernel takes.
ATTN_CASES = [
    (1, 64, 64, 1, 1, 32, False, 0),
    (2, 128, 128, 2, 2, 64, True, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (2, 64, 192, 4, 2, 64, True, 0),
    (1, 96, 40, 2, 1, 32, True, 0),
    (2, 100, 100, 8, 2, 128, True, 0),
    (1, 77, 77, 4, 4, 16, False, 16),
    (1, 300, 300, 8, 1, 128, True, 100),
    (2, 130, 130, 4, 2, 128, False, 0),
    (2, 200, 200, 10, 1, 256, True, 64),
    (1, 300, 300, 10, 1, 256, True, 128),
    (1, 96, 160, 2, 1, 256, False, 0),
    # The wgmma kernel's 128-row query tiles (bf16 at d 64, 128, 256):
    # lengths that fill no tile, Sq < Skv, causal Sq > Skv (rows with no
    # valid key), windows whose edge crosses a 128-row tile, GQA 8:1 and
    # MQA 10:1.
    (1, 300, 300, 8, 1, 64, True, 0),
    (2, 1000, 1000, 8, 1, 128, True, 0),
    (1, 2049, 2049, 10, 1, 256, True, 300),
    (1, 300, 1000, 4, 2, 128, True, 0),
    (1, 1000, 300, 4, 4, 64, True, 0),
    (1, 1000, 300, 10, 1, 256, True, 0),
    (1, 2049, 2049, 8, 1, 64, False, 200),
    (1, 1000, 1000, 10, 1, 256, True, 130),
    (2, 1000, 2049, 8, 1, 128, True, 1000),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal,window", ATTN_CASES)
def test_flash_attention_matches_plain_version(gen, dtype, B, Sq, Skv, H,
                                               KV, d, causal, window):
    q = torch.randn((B, Sq, H, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, d), generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, Sq, H, d)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    _assert_rows_close(got, want, 1e-3 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("S,d", [(128, 64), (300, 128), (1000, 256)])
def test_flash_attention_reads_strided_views(gen, S, d):
    """q/k/v as views into one fused [B,S,3,H,d] projection: the kernel
    reads them through their strides, with no copy (the wgmma kernel's
    tensor maps take the same strides)."""
    qkv = torch.randn((2, S, 3, 4, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.unbind(2)
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    _assert_rows_close(got, want, 5e-2)


# The other LM families' shapes: Qwen2-VL-2B (GQA 12:2, d 128, causal),
# SeamlessM4T-medium (d 64: its encoder and its cross-attention with
# Sq = Skv, non-causal; its decoder, causal).
FAMILY_ATTN_CASES = [(2, 1024, 12, 2, 128, True), (2, 1024, 16, 16, 64, False),
                     (2, 1024, 16, 16, 64, True)]


@pytest.mark.parametrize("B,S,H,KV,d,causal", FAMILY_ATTN_CASES)
def test_flash_attention_at_the_family_shapes(gen, B, S, H, KV, d, causal):
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, KV, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    _assert_rows_close(got, want, 5e-2)


def test_flash_attention_takes_cross_attention_projections(gen):
    """Seamless's cross-attention: keys and values projected from the
    encoder's output and reshaped (the layout the model passes), queries
    from the decoder, one length, no mask."""
    B, S, D, H, d = 2, 512, 1024, 16, 64
    enc = torch.randn((B, S, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    wk, wv = (torch.randn((D, H * d), generator=gen, device="cuda").to(
        torch.bfloat16) / 32 for _ in range(2))
    k, v = (enc @ wk).reshape(B, S, H, d), (enc @ wv).reshape(B, S, H, d)
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    got = flash_attention(q, k, v, causal=False)
    want = attention_ref(q.float(), k.float(), v.float(), causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    _assert_rows_close(got, want, 5e-2)


def _family_inputs(cfg, B, S):
    gen = torch.Generator().manual_seed(1)
    if cfg.frontend_stub and cfg.family != "enc_dec":
        i = torch.arange(S)
        pos = torch.stack([i, i // 8, i % 8], -1)[None].expand(B, S, 3)
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=gen),
                "positions": pos}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = torch.randn((B, S, cfg.d_model), generator=gen)
    return batch


def _tree_to(node, device):
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, device) for v in node]
    return node.to(device)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium",
                                  "deepseek-v2-236b", "rwkv6-7b"])
def test_family_forward_on_the_card_matches_the_cpu(gen, arch):
    """One reduced forward of each new family in float32 on the card (the
    attention layers through ``flash_attention``: one launch per layer,
    and Seamless's per encoder layer and cross-attention too; none for
    MLA, whose q and v dims differ, and RWKV) against the same forward on
    the CPU (the plain attention). rtol/atol 1e-4: the float32 kernel's
    2e-5 carried through the reduced layers."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import transformer as T
    cfg = reduced(ARCHS[arch])
    params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = _family_inputs(cfg, 2, 128)
    want = T.forward(params, cfg, batch)[0]
    before = flash_attention.launches
    got = T.forward(_tree_to(params, "cuda"), cfg, _tree_to(batch, "cuda"))[0]
    torch.cuda.synchronize()
    expect = {"qwen2-vl-2b": cfg.n_layers,
              "seamless-m4t-medium": cfg.n_enc_layers + 2 * cfg.n_layers
              }.get(arch, 0)
    assert flash_attention.launches - before == expect
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_flash_attention_refuses_what_it_cannot_take(gen):
    q = torch.randn((1, 64, 2, 48), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.randn((1, 64, 2, 66), generator=gen, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q)
    q = torch.randn((1, 64, 2, 64), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q.half(), q.half(), q.half())


# linear_scan: the reference test's shapes, a ragged S, S + 1 (the RG-LRU's
# h0 fold), and a long sequence with a in (0.99, 0.9999), where h grows to
# about 50 over 4096 steps (a fused multiply-add drifted beyond 2e-5 from
# the plain version's two roundings a step there; the kernel rounds as
# the plain version does).
SCAN_CASES = [(1, 64, 8, 0.7, 0.999), (2, 128, 32, 0.7, 0.999),
              (3, 96, 16, 0.7, 0.999), (1, 256, 128, 0.7, 0.999),
              (2, 77, 100, 0.7, 0.999), (2, 4097, 256, 0.7, 0.999),
              (1, 4096, 512, 0.99, 0.9999),
              # The chunked kernel's edges (chunks of 256 steps, tiles of
              # 32 channels): one step, less than a chunk, one chunk and
              # one step, a long chain of 64 chunks, a ragged D edge.
              (2, 1, 64, 0.7, 0.999), (2, 100, 96, 0.7, 0.999),
              (1, 257, 64, 0.7, 0.999), (1, 16384, 128, 0.99, 0.9999),
              (4, 300, 100, 0.7, 0.999)]


@pytest.mark.parametrize("B,S,D,lo,hi", SCAN_CASES)
def test_linear_scan_matches_plain_version(gen, B, S, D, lo, hi):
    a = torch.rand((B, S, D), generator=gen, device="cuda") * (hi - lo) + lo
    b = torch.randn((B, S, D), generator=gen, device="cuda")
    before = linear_scan.launches
    got = linear_scan(a, b)
    want = linear_scan_ref(a, b)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, want)     # the same roundings, step by step


def test_linear_scan_back_to_back(gen):
    """Two launches in a row on one stream: each zeroes its own ticket and
    hand-off words, so the second equals the first bit for bit."""
    a = torch.rand((2, 1000, 256), generator=gen, device="cuda") * 0.3 + 0.7
    b = torch.randn((2, 1000, 256), generator=gen, device="cuda")
    first, second = linear_scan(a, b), linear_scan(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, linear_scan_ref(a, b))


def test_linear_scan_bf16_operands(gen):
    """bf16 a and b are widened to fp32; the output takes b's dtype."""
    a = (torch.rand((2, 100, 64), generator=gen, device="cuda") * 0.3
         + 0.7).to(torch.bfloat16)
    b = torch.randn((2, 100, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    got = linear_scan(a, b)
    want = linear_scan_ref(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)
    got = linear_scan(a, b.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, linear_scan_ref(a, b.float()))
    # D not a multiple of 8 takes the kernel's element-wise tile loads.
    got = linear_scan(a[..., :60].contiguous(), b[..., :60].float())
    torch.testing.assert_close(got, want[..., :60], rtol=2e-5, atol=2e-5)


def test_linear_scan_refuses_what_it_cannot_take(gen):
    a = torch.rand((2, 8, 16), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        linear_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        linear_scan(a.half(), a.half())
    with pytest.raises(ValueError, match="several devices"):
        linear_scan(a, a.cpu())


# ---------------------------------------------------------------------------
# Training: linear_scan's gradient and a reduced train step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,D", [(2, 77, 100), (2, 1, 2560),
                                   (2, 257, 2560), (2, 1024, 2560)])
def test_linear_scan_backward_matches_plain_version(gen, B, S, D):
    """The kernel's gradient (one forward and one backward launch, the
    backward over reversed time) against autograd through
    ``linear_scan_ref`` on the card: within 2e-5, and bit for bit since
    both round each step's product, then its sum."""
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.299 + 0.7
    b = torch.randn((B, S, D), generator=gen, device="cuda")
    dh = torch.randn((B, S, D), generator=gen, device="cuda")

    def grads(scan):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        h = scan(x, y)
        return (h.detach(), *torch.autograd.grad(h, (x, y), dh))

    before = dict(linear_scan.launches_by_path)
    got = grads(linear_scan)
    torch.cuda.synchronize()
    assert {k: linear_scan.launches_by_path[k] - before[k]
            for k in before} == {"forward": 1, "backward": 1}
    for g, w in zip(got, grads(linear_scan_ref)):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        assert torch.equal(g, w)


def test_reduced_recurrentgemma_train_step_on_the_card_matches_the_cpu(gen):
    """One ``make_train_step`` of the reduced RecurrentGemma-2B in float32
    on the card (the RG-LRU's scan forward and backward through the
    kernel: 3 + 3 launches; attention on the plain path under autograd: 0
    ``flash_attention``) against the same step on the CPU: loss and grad
    norm at rtol 1e-5 / 1e-4, params within 1e-5 except at most 0.1% of
    the elements within 2 lr."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = reduced(ARCHS["recurrentgemma-2b"])
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    n_rec = cfg.layer_kinds().count("rglru")
    out = {}
    for device in ("cpu", "cuda"):
        params = _tree_to(T.init_params(cfg, seed=0, device="cpu",
                                        dtype=torch.float32), device)
        opt = optim.adamw_init(params)
        step = steps.make_train_step(cfg, lr=1e-3, remat=False)
        before = (dict(linear_scan.launches_by_path),
                  flash_attention.launches)
        params, _, m = step(params, opt, _tree_to(batch, device))
        if device == "cuda":
            torch.cuda.synchronize()
            assert {k: linear_scan.launches_by_path[k] - before[0][k]
                    for k in before[0]} == {"forward": n_rec,
                                            "backward": n_rec}
            assert flash_attention.launches == before[1]
        out[device] = (params, m)
    (pc, mc), (pk, mk) = out["cpu"], out["cuda"]
    torch.testing.assert_close(mk["loss"].cpu(), mc["loss"], rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(mk["grad_norm"].cpu(), mc["grad_norm"],
                               rtol=1e-4, atol=0)
    off = n = 0
    for a, b in zip(optim.adamw.tree_leaves(pk), optim.adamw.tree_leaves(pc)):
        d = (a.detach().cpu() - b.detach()).abs()
        assert float(d.max()) <= 2e-3 + 1e-5
        off += int((d > 1e-5).sum())
        n += d.numel()
    assert off <= 1e-3 * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_and_dequantize_on_the_card_equal_the_cpu(gen, dtype):
    """``quantize_params_int8`` of a reduced DeepSeek-V2 tree (dense
    layers, MLA's ``wkv_b``, the float32 router, the expert stacks) on the
    card equals the same on the CPU, every code and scale bit for bit, and
    so does each dense layer's dequantized weight; ``apply_dense`` on int8
    weights (the dequantize, then cuBLAS) within 1e-4 in float32 and the
    reference's bf16 3e-2 of the CPU's."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = reduced(ARCHS["deepseek-v2-236b"])
    params = T.init_params(cfg, seed=0, device="cpu", dtype=dtype)
    want = L.quantize_params_int8(params)
    got = L.quantize_params_int8(_tree_to(params, "cuda"))
    bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
            else t)
    leaves_w, leaves_g = list(T._leaves(want)), list(T._leaves(got))
    assert len(leaves_w) == len(leaves_g)
    for w, g in zip(leaves_w, leaves_g):
        assert g.dtype == w.dtype and torch.equal(bits(g.cpu()), bits(w))
    x = torch.randn((2, 8, cfg.d_model), generator=gen, device="cuda").to(
        dtype)
    layer_w, layer_g = want["seg1"][0], got["seg1"][0]
    for name in ("wq_a", "wkv_a", "wkv_b", "wo"):
        pw, pg = layer_w["attn"][name], layer_g["attn"][name]
        assert pg["w"].dtype == torch.int8
        assert torch.equal(bits(L.apply_dense_weight(pg, dtype).cpu()),
                           bits(L.apply_dense_weight(pw, dtype)))
    for pw, pg in ((layer_w["mlp"]["router"], layer_g["mlp"]["router"]),
                   (layer_w["attn"]["wq_a"], layer_g["attn"]["wq_a"])):
        xin = x.float() if pw is layer_w["mlp"]["router"] else x
        tol = 1e-4 if xin.dtype == torch.float32 else 3e-2
        torch.testing.assert_close(L.apply_dense(pg, xin).cpu(),
                                   L.apply_dense(pw, xin.cpu()),
                                   rtol=tol, atol=tol)


def test_int8_forward_on_the_card_matches_the_cpu(gen):
    """A reduced Yi-6B in float32 with int8 weights: the card's forward
    (one ``flash_attention`` launch a layer) against the CPU's (the plain
    attention), rtol/atol 1e-4 as the family forwards above."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = reduced(ARCHS["yi-6b"])
    params = L.quantize_params_int8(T.init_params(
        cfg, seed=0, device="cpu", dtype=torch.float32))
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                           device="cuda")
    want = T.forward(params, cfg, {"tokens": tokens.cpu()})[0]
    before = flash_attention.launches
    got = T.forward(_tree_to(params, "cuda"), cfg, {"tokens": tokens})[0]
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_linear_scan_launches_on_the_card_and_not_on_meta(gen):
    """The dry run's meta branch is reached by meta operands only: a CUDA
    operand launches the kernel (one count), a meta operand of the same
    shape gets an empty result and counts nothing."""
    a = torch.rand((2, 300, 64), generator=gen, device="cuda")
    b = torch.randn((2, 300, 64), generator=gen, device="cuda")
    before = linear_scan.launches
    h = linear_scan(a, b)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    torch.testing.assert_close(h, linear_scan_ref(a, b), rtol=2e-5,
                               atol=2e-5)
    m = linear_scan(a.to("meta"), b.to("meta"))
    assert m.device.type == "meta" and m.shape == h.shape
    assert linear_scan.launches == before + 1


# ---------------------------------------------------------------------------
# The kernel wrappers under DTensor on a one-rank mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh(gen, tmp_path):
    """A (1, 1) mesh on cuda:0 over a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield M.make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _placed(mesh, *tensors):
    from repro_torch.runtime import sharding as SH
    return [SH.place(t, SH.named_sharding(mesh, ())) for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,d,window", [(2, 256, 8, 2, 128, 0),
                                               (1, 300, 4, 1, 256, 128)])
def test_flash_attention_on_dtensors_equals_plain_launch(
        gen, one_rank_mesh, dtype, B, S, H, KV, d, window):
    """The wrapper's DTensor rule on a one-rank mesh: one launch on the
    local shard, the same output as the plain-tensor launch bit for bit,
    a DTensor on the operands' placements."""
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, d), generator=gen, device="cuda").to(dtype)
    want = flash_attention(q, k, v, causal=True, window=window)
    before = flash_attention.launches
    got = flash_attention(*_placed(one_rank_mesh, q, k, v), causal=True,
                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.device_mesh is one_rank_mesh
    assert torch.equal(got.to_local(), want)


def test_linear_scan_on_dtensors_equals_plain_launch(gen, one_rank_mesh):
    """The same for ``linear_scan``, forward and gradient: one launch each
    way, bit for bit the plain-tensor calls'."""
    a = torch.rand((2, 300, 256), generator=gen, device="cuda")
    b = torch.randn((2, 300, 256), generator=gen, device="cuda")
    dh = torch.randn((2, 300, 256), generator=gen, device="cuda")
    a0, b0 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = linear_scan(a0, b0)
    want_da, want_db = torch.autograd.grad(want, (a0, b0), dh)
    pa, pb, pdh = _placed(one_rank_mesh, a, b, dh)
    pa.requires_grad_()
    pb.requires_grad_()
    before = dict(linear_scan.launches_by_path)
    got = linear_scan(pa, pb)
    da, db = torch.autograd.grad(got, (pa, pb), pdh)
    torch.cuda.synchronize()
    assert linear_scan.launches_by_path == {
        k: v + 1 for k, v in before.items()}
    assert torch.equal(got.to_local(), want)
    assert torch.equal(da.to_local(), want_da)
    assert torch.equal(db.to_local(), want_db)
