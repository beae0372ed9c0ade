"""Plain PyTorch versions of the int8 conv/GEMM engine (paper Fig. 3).

The hardware pipeline: int8 activations x int8 weights -> int32 partial
sums -> (+bias, ReLU) -> per-output-channel shift + truncate to int8. The
conv is an implicit GEMM over int8 im2col patches (the activation line
buffer's address generation), which is what the Hopper kernel computes
tile by tile. Patch features are ordered ``(r, s, c)`` so
``w[R,S,C,M].reshape(R*S*C, M)`` matches directly. Twin of
``repro/kernels/conv2d_int8/ref.py``.

**Accumulation in float64.** CUDA torch has no int32 ``matmul`` or
``conv2d``, so the plain GEMM multiplies the int8 operands as float64 on
every device. This is exact: each product has magnitude <= 2^14 and
|acc| <= K * 2^14; the largest K on the main path is 9216 (AlexNet fc6),
so every partial sum, in any summation order, is an integer far below
2^53. The float64 result is cast to int32 *before* the bias add, as the
reference's int32 matmul-then-add does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant

Pad2 = tuple[tuple[int, int], tuple[int, int]]


def requantize_ref(acc: torch.Tensor, shift: torch.Tensor,
                   bias: torch.Tensor | None = None,
                   relu: bool = False) -> torch.Tensor:
    """The fused epilogue on raw int32 accumulators ``[N, M]``: bias add,
    optional ReLU, then the shared saturating signed shift + clip to int8
    (``quant.requantize_output`` — the CUDA epilogue inlines the identical
    math, pinned by the bit-identity checks)."""
    acc = _bias_relu(acc, bias, relu)
    return quant.requantize_output(acc, 0, shift[None, :].to(torch.int32),
                                   bits=8)


def _bias_relu(acc: torch.Tensor, bias: torch.Tensor | None,
               relu: bool) -> torch.Tensor:
    if bias is not None:
        acc = acc + bias.to(torch.int32)[None, :]
    if relu:
        acc = torch.clamp(acc, min=0)
    return acc


def matmul_int8_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``[N, K] @ [K, M]`` -> exact int32 accumulators via float64
    (see the module docstring for why float64 is exact here)."""
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64)).to(torch.int32)


def gemm_int8_ref(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  emit_int32: bool = False) -> torch.Tensor:
    """x [N, K] int8, w [K, M] int8, shift [M] int32 (signed shift bits).
    Returns int8 [N, M]: clip((relu?)(x @ w + bias) >> shift); with
    ``emit_int32`` the int32 ``(relu?)(x @ w + bias)`` instead."""
    acc = matmul_int8_exact(x, w)
    if emit_int32:
        return _bias_relu(acc, bias, relu)
    return requantize_ref(acc, shift, bias, relu)


def same_padding(in_hw: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/XLA "SAME" pad pair for one spatial dim."""
    out = -(-in_hw // stride)
    total = max((out - 1) * stride + kernel - in_hw, 0)
    return total // 2, total - total // 2


def im2col_int8(x: torch.Tensor, R: int, S: int, stride: int,
                pad: Pad2, row_align: int = 1) -> torch.Tensor:
    """int8 im2col with no float materialization: x [B,H,W,C] ->
    [B,Ho,Wo,R*S*C], features ordered (r, s, c). ``pad`` is
    ((top, bottom), (left, right)); zero-padding is exact for the
    symmetric (zero-point-0) po2 formats. With ``row_align`` > 1 the
    features are written into rows of a multiple of ``row_align`` bytes
    (one block of zeros closes each row) and the result is a view of their
    first R*S*C columns: the layout TMA reads on the kernel route."""
    (top, bot), (left, right) = pad
    xp = F.pad(x, (0, 0, left, right, top, bot))
    Hp, Wp = xp.shape[1], xp.shape[2]
    Ho = (Hp - R) // stride + 1
    Wo = (Wp - S) // stride + 1
    cols = [xp[:, r:r + (Ho - 1) * stride + 1:stride,
               s:s + (Wo - 1) * stride + 1:stride, :]
            for r in range(R) for s in range(S)]
    K = R * S * x.shape[-1]
    extra = -K % row_align
    if extra:
        cols.append(xp.new_zeros((xp.shape[0], Ho, Wo, extra)))
    patches = torch.cat(cols, dim=-1)
    return patches[..., :K] if extra else patches


def _resolve_pad(padding, in_h: int, in_w: int, R: int, S: int,
                 stride: int) -> Pad2:
    if padding == "same":
        return same_padding(in_h, R, stride), same_padding(in_w, S, stride)
    return tuple(tuple(p) for p in padding)  # type: ignore[return-value]


def conv2d_int8_via(gemm_fn, x: torch.Tensor, w: torch.Tensor,
                    shift: torch.Tensor, bias: torch.Tensor | None = None, *,
                    stride: int = 1, padding="same", groups: int = 1,
                    relu: bool = False, row_align: int = 1,
                    **gemm_kwargs) -> torch.Tensor:
    """Conv as implicit GEMM over any engine: one weight-stationary
    ``gemm_fn(patches, w2d, shift, bias, relu=..., **gemm_kwargs)`` per
    channel group. Shared by the plain version and the kernel route so the
    spatial plumbing (stride, asymmetric padding, groups) cannot drift.
    A group's weights are a [K, M/groups] view of ``w`` (no copy), in
    whatever layout ``w`` has: HWIO row-major, or a K-major view (unit
    stride along R, S, C); the GEMM takes such views as they are. The
    patches are an [N, K] view into rows of a multiple of ``row_align``
    bytes (:func:`im2col_int8`)."""
    R, S, Cg, M = w.shape
    B, H, W, C = x.shape
    if C != Cg * groups or M % groups:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         f"not split into {groups} groups")
    pad = _resolve_pad(padding, H, W, R, S, stride)
    outs = []
    Mg = M // groups
    for g in range(groups):
        xg = x[..., g * Cg:(g + 1) * Cg]
        patches = im2col_int8(xg, R, S, stride, pad, row_align)
        Bp, Ho, Wo, K = patches.shape
        wg = w[..., g * Mg:(g + 1) * Mg].reshape(R * S * Cg, Mg)
        bg = None if bias is None else bias[g * Mg:(g + 1) * Mg]
        out = gemm_fn(patches.reshape(-1, K), wg,
                      shift[g * Mg:(g + 1) * Mg], bg, relu=relu,
                      **gemm_kwargs)
        outs.append(out.reshape(B, Ho, Wo, Mg))
    return outs[0] if groups == 1 else torch.cat(outs, dim=-1)


def conv2d_int8_ref(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                    bias: torch.Tensor | None = None, *, stride: int = 1,
                    padding="same", groups: int = 1, relu: bool = False,
                    emit_int32: bool = False) -> torch.Tensor:
    """x [B,H,W,C] int8, w [R,S,C/groups,M] int8, shift/bias [M].
    Arbitrary stride, asymmetric padding ((top,bot),(left,right)) or
    "same", and grouped channels. Returns int8 [B,Ho,Wo,M] (int32 with
    ``emit_int32``)."""
    return conv2d_int8_via(gemm_int8_ref, x, w, shift, bias, stride=stride,
                           padding=padding, groups=groups, relu=relu,
                           emit_int32=emit_int32)
