"""Channel-wise fixed-point quantization (paper Section 3.3, Fig. 3(c)).

The paper computes int8 MACs into 32-bit partial sums; different channels
may use different fixed-point formats (power-of-2 scales = "shift bits"),
aligned by left-shifters before accumulation, then right-shifted and
truncated when writing output activations. This is the PyTorch twin of
``repro/core/quant.py``: the same arithmetic on tensors, bit-identical
(``tests/test_torch_quant.py``), so the Hopper GEMM kernel, its plain
version and the integer oracle agree bit for bit.

``torch.round``, ``jnp.round`` and ``np.rint`` all round half to even; the
tests assert it rather than assume it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


def po2_scale(x: torch.Tensor, axis: int, bits: int = 8) -> torch.Tensor:
    """Per-channel power-of-2 exponent e such that x / 2^e fits int<bits>.

    Returns int32 exponents (can be negative), one per index of ``axis``;
    the reduction runs over every other axis, in float32 as the reference
    does.
    """
    qmax = 2 ** (bits - 1) - 1
    red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    amax = torch.abs(x.float())
    if red:     # torch.amax(dim=()) would reduce every axis
        amax = torch.amax(amax, dim=red)
    amax = torch.clamp(amax, min=1e-12)
    # smallest e with amax / 2^e <= qmax
    return torch.ceil(torch.log2(amax / qmax)).to(torch.int32)


def po2_exponent(amax: float, bits: int = 8) -> int:
    """Smallest integer e with ``amax / 2^e <= qmax`` — the frozen
    per-tensor activation format a calibration pass records."""
    qmax = 2 ** (bits - 1) - 1
    return math.ceil(math.log2(max(float(amax), 1e-12) / qmax))


def _int_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def quantize_to_exponent(x: torch.Tensor, e: int,
                         bits: int = 8) -> torch.Tensor:
    """Quantize onto a *given* po2 format (compile-time frozen scale):
    ``q = clip(round(x / 2^e))`` as int8/int16, with the same float32
    multiply as the reference."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x.float() * (2.0 ** (-e))), -qmax - 1, qmax)
    return q.to(_int_dtype(bits))


def quantize_to_exponent_np(x, e: int, bits: int = 8) -> np.ndarray:
    """Numpy twin of :func:`quantize_to_exponent` for host-side
    quantize-in (the serving executor overlaps it with device compute).
    Bit-identical: same float32 multiply, same round-half-to-even, same
    clip."""
    qmax = 2 ** (bits - 1) - 1
    q = np.clip(np.rint(np.asarray(x, np.float32) * np.float32(2.0 ** (-e))),
                -qmax - 1, qmax)
    return q.astype(np.int8 if bits <= 8 else np.int16)


def saturating_signed_shift(acc32: torch.Tensor,
                            shift: torch.Tensor) -> torch.Tensor:
    """``acc >> shift`` with truncation for ``shift >= 0`` and a
    *saturating* left shift for ``shift < 0`` — no int32 wraparound, so a
    downstream clip onto int8/int16 rails sees the true sign.

    The left shift is capped at 16 and the value is clamped to
    ``[INT32_MIN >> sl, INT32_MAX >> sl]`` before it shifts; the right
    shift is arithmetic and capped at 31. Both shift amounts are kept in
    ``[0, 31]`` on the branch that ``where`` discards too, so neither side
    ever shifts by a negative amount."""
    sh = torch.as_tensor(shift, dtype=torch.int32, device=acc32.device)
    sl = torch.clamp(-sh, 0, 16)
    lo32 = torch.bitwise_right_shift(
        torch.full_like(sl, INT32_MIN), sl)
    hi32 = torch.bitwise_right_shift(
        torch.full_like(sl, INT32_MAX), sl)
    right = torch.bitwise_right_shift(acc32, torch.clamp(sh, 0, 31))
    left = torch.bitwise_left_shift(
        torch.minimum(torch.maximum(acc32, lo32), hi32), sl)
    return torch.where(sh >= 0, right, left)


def requantize_output(acc32: torch.Tensor, e_acc, e_out,
                      bits: int = 8) -> torch.Tensor:
    """Right-shift + truncate 32-bit accumulators to the output activation
    format (paper: "partial sums should be right shifted and truncated")."""
    shift = torch.as_tensor(e_out - e_acc, dtype=torch.int32,
                            device=acc32.device)
    y = saturating_signed_shift(acc32, shift)
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(y, -qmax - 1, qmax).to(_int_dtype(bits))
