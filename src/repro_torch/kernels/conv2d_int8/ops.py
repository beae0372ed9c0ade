"""conv2d / fc on the Hopper int8 GEMM kernel with the fused
bias/ReLU/requantize epilogue. Twin of ``repro/kernels/conv2d_int8/ops.py``.

A conv is an implicit GEMM over its int8 patches (the paper's line-buffer
address generator). Where :func:`kernel.implicit_ok` admits it (a group
width of a multiple of 64 channels: every conv of the paper's models but
the 3-channel stems and AlexNet's conv2) the kernel reads the patches
straight from the NHWC activation by TMA's im2col mode
(``kernel.conv_int8_implicit``, path ``"implicit"``), and no patch matrix
is written. A 3 x 3 depthwise conv (MobileNetV2's) goes to its own
kernel, ``dwconv_int8``, and not to one GEMM per channel. The rest take
the reference's route: int8 im2col as tensor
slicing outside the kernel, into rows of a multiple of 16 bytes (AlexNet's
stem has K = 363, VGG16's 27), which TMA needs, then the GEMM. Grouped
convolutions (AlexNet's two-tower layers) run one weight-stationary GEMM
per group on either route, like the paper's per-engine channel split. The
weights reach the fast paths as a K-major view (``core/program.py``). On
CPU tensors the kernel's plain version runs instead (the same integers).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d_int8.kernel import (ALIGN, QMAX,
                                                    conv_int8_implicit,
                                                    gemm_int8, implicit_ok)
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_via, resolve_pad
from repro_torch.kernels.dwconv_int8.kernel import STRIDES, dwconv_int8


def depthwise_ok(x: torch.Tensor, w: torch.Tensor, *, stride: int, pad,
                 groups: int) -> bool:
    """Whether ``dwconv_int8`` takes this conv: a 3 x 3 depthwise conv
    (one input channel per output channel), padding 1, stride 1 or 2."""
    R, S, Cg, M = w.shape
    return (R, S, Cg) == (3, 3, 1) and groups == x.shape[3] == M > 1 and \
        stride in STRIDES and tuple(map(tuple, pad)) == ((1, 1), (1, 1))


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                padding="same", groups: int = 1, relu: bool = False,
                emit_int32: bool = False,
                residual: torch.Tensor | None = None,
                res_shift: torch.Tensor | None = None,
                qmax: int = QMAX) -> torch.Tensor:
    """x [B,H,W,C] int8, w [R,S,C/groups,M] int8, shift/bias [M] int32 ->
    int8 [B,Ho,Wo,M] on [-128, qmax] (int32 with ``emit_int32``). An int8
    ``residual`` [B,Ho,Wo,M] (a bottleneck's skip) is added in the
    kernel's epilogue, aligned by the int32 [M] ``res_shift``, before
    ReLU; ``qmax`` is 127, or a ReLU6 engine's ceiling.

    ``padding`` is "same" or an explicit ((top, bottom), (left, right));
    ``stride`` and ``groups`` are arbitrary, so every conv shape in the
    paper's four models (stride-4/stride-2 stems, grouped towers) takes
    this route. ``w`` may be HWIO row-major or a K-major view of that
    shape; only the K-major one reaches the ``wgmma`` kernels, and only
    it the implicit route.
    """
    pad = resolve_pad(padding, x.shape[1], x.shape[2], w.shape[0],
                      w.shape[1], stride)
    if residual is None and not emit_int32 and \
            depthwise_ok(x, w, stride=stride, pad=pad, groups=groups):
        return dwconv_int8(x, w, shift, bias, stride=stride, relu=relu,
                           qmax=qmax)
    if implicit_ok(x, w, stride=stride, pad=pad, groups=groups):
        return conv_int8_implicit(x, w, shift, bias, stride=stride, pad=pad,
                                  groups=groups, relu=relu,
                                  emit_int32=emit_int32, residual=residual,
                                  res_shift=res_shift, qmax=qmax)
    return conv2d_int8_via(gemm_int8, x, w, shift, bias, stride=stride,
                           padding=padding, groups=groups, relu=relu,
                           row_align=ALIGN, emit_int32=emit_int32,
                           residual=residual, res_shift=res_shift,
                           qmax=qmax)


def fc_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
            bias: torch.Tensor | None = None, *, relu: bool = False,
            emit_int32: bool = False, qmax: int = QMAX) -> torch.Tensor:
    """Fully-connected layer on the same GEMM engine: x [B,F] int8,
    w [F,M] int8 -> int8 [B,M] on [-128, qmax] (int32 with
    ``emit_int32``)."""
    return gemm_int8(x, w, shift, bias, relu=relu, emit_int32=emit_int32,
                     qmax=qmax)
