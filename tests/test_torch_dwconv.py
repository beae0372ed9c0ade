"""The depthwise kernel ``dwconv_int8`` and ReLU6's ceiling in the shared
epilogue.

On the CPU: the plain version against ``F.conv2d(groups=C)`` on integers;
``conv2d_int8``'s dispatch of a depthwise conv to it; the ceiling in the
plain epilogue (``gemm_int8_ref``) against a hand computation, with a skip
and no activation after the add (a MobileNetV2 projection); the ceiling's
values; and that a program without a depthwise step never builds or
loads the new library.

On the card (marked ``cuda``, skipped elsewhere): the kernel against its
plain version on every depthwise shape of MobileNetV2 at batches 16, 1, 3
and 17, both strides, the ceiling binding, narrow channel counts; the
ceiling and the activation-free skip on every ``gemm_int8`` path; and the
library left unloaded by a chain program on the card. Run them with

    python -m pytest -m cuda tests/test_torch_dwconv.py
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import workload as W
from repro_torch.core.program import compile_model, relu6_ceiling
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.kernels.conv2d_int8 import ops, ref
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8, k_major_view
from repro_torch.kernels.dwconv_int8 import kernel as dw
from repro_torch.models.cnn import init_params

ROOT = Path(__file__).resolve().parents[1]
# Every depthwise conv of MobileNetV2 1.0/224: (side in, channels, stride).
MOBILENET_DW = sorted({(hw, l.in_ch, l.stride) for l, hw in zip(
    W.mobilenet_v2().layers, W.mobilenet_v2().in_sizes()) if l.depthwise})


def _int(g, shape, lo=-128, hi=128, dtype=torch.int8, device="cpu"):
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype,
                         device=device)


def _operands(g, B, H, C, device="cpu"):
    x = _int(g, (B, H, H, C), device=device)
    w = _int(g, (3, 3, 1, C), device=device)
    shift = _int(g, (C,), 4, 12, torch.int32, device)
    bias = _int(g, (C,), -3000, 3000, torch.int32, device)
    return x, w, shift, bias


def test_mobilenet_v2_depthwise_shapes():
    assert MOBILENET_DW == [(7, 960, 1), (14, 384, 1), (14, 576, 1),
                            (14, 576, 2), (28, 192, 1), (28, 192, 2),
                            (56, 144, 1), (56, 144, 2), (112, 32, 1),
                            (112, 96, 2)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("B,H,C", [(2, 7, 16), (1, 8, 12), (3, 5, 32)])
def test_depthwise_acc_equals_grouped_conv2d_on_integers(stride, B, H, C):
    g = torch.Generator().manual_seed(H * C + stride)
    x, w, _, _ = _operands(g, B, H, C)
    xn = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (1, 1, 1, 1))
    want = F.conv2d(xn, w.permute(3, 2, 0, 1).to(torch.float64),
                    stride=stride, groups=C).permute(0, 2, 3, 1)
    got = dw.depthwise_acc(x, w, stride)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.round(want).to(torch.int32))


@pytest.mark.parametrize("relu,qmax", [(True, 96), (True, 127),
                                       (False, 127)])
def test_plain_version_is_the_shared_epilogue_on_the_accumulators(relu,
                                                                  qmax):
    g = torch.Generator().manual_seed(qmax)
    x, w, shift, bias = _operands(g, 2, 6, 8)
    got = dw.dwconv_int8(x, w, shift, bias, stride=2, relu=relu, qmax=qmax)
    acc = dw.depthwise_acc(x, w, 2)
    want = ref.requantize_ref(acc.reshape(-1, 8), shift, bias, relu,
                              qmax=qmax).reshape(acc.shape)
    assert got.shape == (2, 3, 3, 8) and torch.equal(got, want)
    if qmax < 127:
        assert int(got.max()) == qmax


def test_conv2d_int8_sends_a_depthwise_conv_to_dwconv(monkeypatch):
    calls = []
    orig = ops.dwconv_int8

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(ops, "dwconv_int8", spy)
    g = torch.Generator().manual_seed(1)
    x, w, shift, bias = _operands(g, 2, 8, 16)
    got = ops.conv2d_int8(x, w, shift, bias, stride=2,
                          padding=((1, 1), (1, 1)), groups=16, relu=True,
                          qmax=100)
    want = ref.conv2d_int8_ref(x, w, shift, bias, stride=2,
                               padding=((1, 1), (1, 1)), groups=16,
                               relu=True, qmax=100)
    assert calls == [{"stride": 2, "relu": True, "qmax": 100}]
    assert torch.equal(got, want)
    # Not depthwise: a grouped conv of two channels a group, a 1x1.
    ops.conv2d_int8(x, _int(g, (3, 3, 2, 16)), shift, bias,
                    padding=((1, 1), (1, 1)), groups=8)
    ops.conv2d_int8(x, _int(g, (1, 1, 16, 16)), shift, bias,
                    padding=((0, 0), (0, 0)))
    assert len(calls) == 1


@pytest.mark.parametrize("relu", [False, True])
def test_ceiling_and_a_skip_with_no_activation_match_a_hand_computation(
        relu):
    """The plain GEMM's epilogue: the aligned skip added, ReLU where asked,
    the floor shift, the clip onto [-128, qmax]; a projection's case is
    the skip with no ReLU after it."""
    g = torch.Generator().manual_seed(7)
    N, K, M, qmax = 9, 24, 5, 96
    x, w = _int(g, (N, K)), _int(g, (K, M))
    shift = _int(g, (M,), 2, 9, torch.int32)
    bias = _int(g, (M,), -4000, 4000, torch.int32)
    res = _int(g, (N, M))
    rs = torch.tensor([-3, -1, 0, 2, 5], dtype=torch.int32)
    got = ref.gemm_int8_ref(x, w, shift, bias, relu=relu, residual=res,
                            res_shift=rs, qmax=qmax)
    xi, wi, ri = x.long().tolist(), w.long().tolist(), res.long().tolist()
    clipped = 0
    for n in range(N):
        for m in range(M):
            s = int(rs[m])
            v = sum(xi[n][k] * wi[k][m] for k in range(K)) + int(bias[m]) \
                + (ri[n][m] << -s if s < 0 else ri[n][m] >> s)
            if relu:
                v = max(v, 0)
            y = v >> int(shift[m])
            clipped += y > qmax
            assert int(got[n, m]) == max(-128, min(qmax, y)), (n, m)
    assert clipped > 0


def test_relu6_ceiling_is_six_on_the_output_format():
    from bench.reference import mobilenet_int8
    for e_out, want in ((-4, 96), (-5, 127), (-3, 48), (0, 6), (1, 3),
                        (2, 1), (-20, 127)):
        assert relu6_ceiling(e_out) == want
        assert mobilenet_int8.ceiling(e_out, 127) == want
    assert relu6_ceiling(-1, bits=4) == 7 and relu6_ceiling(0, bits=4) == 6


def _chain_program(device):
    m = W.CNNModel("dense", 16, 3, (
        W.ConvLayer("c1", 3, 16, 3),
        W.ConvLayer("p1", 16, 16, 2, stride=2, kind="pool"),
        W.ConvLayer("c2", 16, 16, 3, groups=2),
        W.ConvLayer("fc", 16 * 8 * 8, 10, 1, kind="fc")))
    params = init_params(m, 0, device=device)
    calib = torch.randn((1, 16, 16, 3), device=device)
    return compile_model(m, params, calib_batch=calib, theta=900,
                         bram_total=None, device=device)


def test_a_program_without_a_depthwise_step_never_loads_the_library(
        monkeypatch):
    loaded = []
    monkeypatch.setattr(_build, "load", lambda src: loaded.append(src))
    prog = _chain_program("cpu")
    prog.compile_runner(route="kernel").logits(np.zeros((2, 16, 16, 3),
                                                        np.float32))
    assert dw.SOURCE not in loaded
    assert not any(s.layer.depthwise for s in prog.steps)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 1, 3, 17])
@pytest.mark.parametrize("hw,C,stride", MOBILENET_DW)
def test_dwconv_kernel_equals_its_plain_version(gen, batch, hw, C, stride):
    x, w, shift, bias = _operands(gen, batch, hw, C, "cuda")
    before = dw.dwconv_int8.launches
    for relu, qmax in ((True, 96), (False, 127)):
        got = dw.dwconv_int8(x, w, shift, bias, stride=stride, relu=relu,
                             qmax=qmax)
        want = dw.dwconv_int8_ref(x, w, shift, bias, stride=stride,
                                  relu=relu, qmax=qmax)
        assert torch.equal(got, want), (relu, qmax)
        if qmax < 127:
            assert int(got.max()) == qmax     # the ceiling binds
    assert dw.dwconv_int8.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,stride", [(2, 9, 8, 1), (3, 10, 48, 2),
                                          (2, 5, 12, 2), (1, 1, 4, 1),
                                          (2, 33, 240, 2), (1, 3, 1040, 1)])
def test_dwconv_kernel_on_narrow_and_ragged_shapes(gen, B, H, C, stride):
    """Loads of 8 and 4 bytes (C 8, 12), a map of one pixel, a last block
    of channels cut short (240, 1040), no bias."""
    x, w, shift, bias = _operands(gen, B, H, C, "cuda")
    for b in (bias, None):
        got = dw.dwconv_int8(x, w, shift, b, stride=stride, relu=True,
                             qmax=110)
        want = dw.dwconv_int8_ref(x, w, shift, b, stride=stride, relu=True,
                                  qmax=110)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_dwconv_refuses_what_it_cannot_take_on_the_card(gen):
    x, w, shift, bias = _operands(gen, 1, 6, 6, "cuda")
    with pytest.raises(ValueError, match="multiple of 4"):
        dw.dwconv_int8(x, w, shift, bias)
    x, w, shift, bias = _operands(gen, 1, 6, 16, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        dw.dwconv_int8(x, w.transpose(0, 1), shift, bias)
    with pytest.raises(ValueError, match="stride"):
        dw.dwconv_int8(x, w, shift, bias, stride=3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(300, 96, 96), (16, 1280, 1000),
                                   (70, 65, 130)])
@pytest.mark.parametrize("relu,skip", [(True, False), (False, True),
                                       (True, True)])
def test_gemm_int8_ceiling_and_skip_on_every_path(gen, n, k, m, relu,
                                                  skip):
    x, w = _int(gen, (n, k), device="cuda"), _int(gen, (k, m),
                                                 device="cuda")
    shift = _int(gen, (m,), 4, 10, torch.int32, "cuda")
    bias = _int(gen, (m,), -3000, 3000, torch.int32, "cuda")
    kw = {}
    if skip:
        kw = dict(residual=_int(gen, (n, m), device="cuda"),
                  res_shift=_int(gen, (m,), -4, 4, torch.int32, "cuda"))
    want = ref.gemm_int8_ref(x, w, shift, bias, relu=relu, qmax=96, **kw)
    paths = []
    for wt in (k_major_view(w), w):
        before = gemm_kernel.launch_counts()
        got = gemm_int8(x, wt, shift, bias, relu=relu, qmax=96, **kw)
        after = gemm_kernel.launch_counts()
        paths += [p for p in gemm_kernel.PATHS if after[p] > before[p]]
        assert torch.equal(got, want)
    assert paths[-1] == "dp4a"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_implicit_conv_ceiling_and_skip(gen, relu):
    """The implicit route (a 1x1 at 64 channels, MobileNetV2's widths)
    with the ceiling and a projection's skip."""
    x = _int(gen, (3, 14, 14, 64), device="cuda")
    wq = _int(gen, (1, 1, 64, 160), device="cuda")
    w = k_major_view(wq)
    shift = _int(gen, (160,), 4, 10, torch.int32, "cuda")
    bias = _int(gen, (160,), -3000, 3000, torch.int32, "cuda")
    res = _int(gen, (3, 14, 14, 160), device="cuda")
    rs = _int(gen, (160,), -4, 4, torch.int32, "cuda")
    pad = ((0, 0), (0, 0))
    before = gemm_kernel.launch_counts()["implicit"]
    got = ops.conv2d_int8(x, w, shift, bias, padding=pad, relu=relu,
                          residual=res, res_shift=rs, qmax=80)
    assert gemm_kernel.launch_counts()["implicit"] == before + 1
    want = ref.conv2d_int8_via(ref.gemm_int8_ref, x.cpu(), wq.cpu(),
                               shift.cpu(), bias.cpu(), padding=pad,
                               relu=relu, residual=res.cpu(),
                               res_shift=rs.cpu(), qmax=80)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_a_chain_program_on_the_card_leaves_the_library_unloaded(gen):
    """In a process of its own: a chain program served on the card (eager,
    then captured and replayed, then replayed) loads ``gemm_int8``'s library and not
    ``dwconv_int8``'s."""
    code = ("import numpy as np, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_dwconv import _chain_program\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.kernels.conv2d_int8 import kernel as g\n"
            "from repro_torch.kernels.dwconv_int8 import kernel as dw\n"
            "r = _chain_program('cuda').compile_runner()\n"
            "for _ in range(3):\n"
            "    r.logits(np.zeros((4, 16, 16, 3), np.float32))\n"
            "print(r.replays, _build.library_path(g.SOURCE) in "
            "_build._LOADED, _build.library_path(dw.SOURCE) in "
            "_build._LOADED)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["2", "True", "False"]
