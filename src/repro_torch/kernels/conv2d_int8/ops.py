"""conv2d / fc as int8 im2col + the Hopper int8 GEMM kernel with the fused
bias/ReLU/requantize epilogue. Twin of ``repro/kernels/conv2d_int8/ops.py``.

The im2col (the line-buffer address generator) stays plain int8 tensor
slicing outside the kernel, as the reference runs it in XLA outside the
Pallas kernel; the MAC array + output pipeline is the kernel. Grouped
convolutions (AlexNet's two-tower layers) run one weight-stationary GEMM
per group, like the paper's per-engine channel split. The patches land in
rows of a multiple of 16 bytes (AlexNet's stem has K = 363, VGG16's 27),
which TMA needs; the weights reach the fast path as a K-major view
(``core/program.py``). On CPU tensors the kernel's plain version runs
instead (``kernel.gemm_int8``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d_int8.kernel import ALIGN, gemm_int8
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_via


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                padding="same", groups: int = 1, relu: bool = False,
                emit_int32: bool = False) -> torch.Tensor:
    """x [B,H,W,C] int8, w [R,S,C/groups,M] int8, shift/bias [M] int32 ->
    int8 [B,Ho,Wo,M] (int32 with ``emit_int32``).

    ``padding`` is "same" or an explicit ((top, bottom), (left, right));
    ``stride`` and ``groups`` are arbitrary, so every conv shape in the
    paper's four models (stride-4/stride-2 stems, grouped towers) takes
    this route. ``w`` may be HWIO row-major or a K-major view of that
    shape; only the K-major one reaches the ``wgmma`` kernels.
    """
    return conv2d_int8_via(gemm_int8, x, w, shift, bias, stride=stride,
                           padding=padding, groups=groups, relu=relu,
                           row_align=ALIGN, emit_int32=emit_int32)


def fc_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
            bias: torch.Tensor | None = None, *, relu: bool = False,
            emit_int32: bool = False) -> torch.Tensor:
    """Fully-connected layer on the same GEMM engine: x [B,F] int8,
    w [F,M] int8 -> int8 [B,M] (int32 with ``emit_int32``)."""
    return gemm_int8(x, w, shift, bias, relu=relu, emit_int32=emit_int32)
