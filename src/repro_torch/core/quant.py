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
# ln 2 as XLA's float32 exp2 lowering multiplies by it.
LN2_F32 = 0.6931472


def ref_exp2(x) -> torch.Tensor:
    """The reference's ``jnp.exp2(x)`` for integer ``x`` as float32:
    ``exp(0.6931472 * x)`` evaluated in float32 by torch on the CPU. It
    equals XLA's value for every integer in -60..60 except 32, and differs
    from the exact power of two for |x| >= 13 (every port of a
    ``jnp.exp2`` site takes its scale from here)."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    return torch.exp(torch.tensor(LN2_F32) * x)


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


def int_dtype(bits: int) -> torch.dtype:
    """The activation and weight dtype of a ``bits``-wide program."""
    return torch.int8 if bits <= 8 else torch.int16


def quantize_to_exponent(x: torch.Tensor, e: int,
                         bits: int = 8) -> torch.Tensor:
    """Quantize onto a *given* po2 format (compile-time frozen scale):
    ``q = clip(round(x / 2^e))`` as int8/int16, with the same float32
    multiply as the reference."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x.float() * (2.0 ** (-e))), -qmax - 1, qmax)
    return q.to(int_dtype(bits))


def quantize_to_exponent_np(x, e: int, bits: int = 8, out=None,
                            scratch=None) -> np.ndarray:
    """Numpy twin of :func:`quantize_to_exponent` for host-side
    quantize-in (the serving executor overlaps it with device compute).
    Bit-identical: same float32 multiply, same round-half-to-even, same
    clip.

    With ``out`` (an int8 / int16 ``[B, H, W, C]`` array, the dtype of
    ``bits``), ``x`` is an ``[n, H, W, C]`` array or a sequence of ``n <=
    B`` frames ``[H, W, C]``: the n quantized frames go to ``out[:n]``,
    ``out[n:]`` is zeroed (what a zero frame quantizes to) and ``out`` is
    returned. The frames are walked a chunk at a time on the calling
    thread, in cache: each chunk (:data:`SCRATCH_BYTES` of whole frames)
    passes through the float32 ``scratch`` (from :func:`quantize_scratch`;
    one chunk is allocated without it, and only one chunk of a longer one
    is used), cast, multiplied, rounded, clipped and cast into ``out`` in
    that order, so a scratch its owner reuses leaves no array the size of
    the batch made. An ``out`` or ``scratch`` of another dtype or frame
    shape is refused, never cast."""
    qmax = 2 ** (bits - 1) - 1
    scale = np.float32(2.0 ** (-e))
    if out is None:
        q = np.clip(np.rint(np.asarray(x, np.float32) * scale),
                    -qmax - 1, qmax)
        return q.astype(np.int8 if bits <= 8 else np.int16)
    frame = out.shape[1:]
    x, n = _frames_into(x, out, np.dtype(np.int8 if bits <= 8 else np.int16),
                        f"quantize-in at bits={bits}")
    if scratch is None:
        scratch = quantize_scratch((max(n, 1),) + frame)
    elif scratch.dtype != np.float32 or scratch.shape[1:] != frame:
        raise ValueError(f"scratch {scratch.dtype}{list(scratch.shape)} is "
                         f"not float32 frames {list(frame)}")
    _quantize_chunks(x, n, scale, qmax, out,
                     scratch[:scratch_frames(frame)])
    out[n:] = 0
    return out


def copy_frames_np(x, out: np.ndarray) -> np.ndarray:
    """Quantize-in's host half on the card path: the ``n`` float frames of
    ``x`` (an ``[n, H, W, C]`` array or a sequence of ``[H, W, C]``
    frames, as :func:`quantize_to_exponent_np` takes them) copied into the
    float32 batch ``out[:n]``, cast in the same pass where they are of
    another dtype, and ``out[n:]`` zeroed; returns ``out``. One pass over
    the frames and no temporary; ``np.copyto`` releases the GIL. The card
    rounds ``out`` (``kernels/quantize_in``). An ``out`` of another dtype
    or frame shape is refused."""
    x, n = _frames_into(x, out, np.dtype(np.float32), "the card's intake")
    if isinstance(x, np.ndarray):
        np.copyto(out[:n], x, casting="unsafe")
    else:
        for i, f in enumerate(x):
            np.copyto(out[i], f, casting="unsafe")
    out[n:] = 0
    return out


def _frames_into(x, out: np.ndarray, want: np.dtype, what: str):
    """``(x, n)``: the frames checked against the batch ``out`` of dtype
    ``want`` (a sequence made a list of arrays), or a ``ValueError``."""
    frame = out.shape[1:]
    if out.dtype != want:
        raise ValueError(f"{what} writes {want}, not into {out.dtype}")
    if isinstance(x, np.ndarray):
        if x.ndim != out.ndim or x.shape[1:] != frame:
            raise ValueError(f"frames {list(x.shape)} do not fit a batch "
                             f"{list(out.shape)}")
    else:
        x = [np.asarray(f) for f in x]
        if any(f.shape != frame for f in x):
            raise ValueError(f"a frame's shape is not {list(frame)}")
    if len(x) > len(out):
        raise ValueError(f"{len(x)} frames exceed a batch of {len(out)}")
    return x, len(x)


# The float32 scratch of the chunk walk: at most 1 MiB of whole frames
# (never fewer than one), small enough to stay in a core's cache and be
# reused, where a batch-sized temporary is faulted in afresh.
SCRATCH_BYTES = 1 << 20


def scratch_frames(frame_shape) -> int:
    """Whole float32 frames of ``frame_shape`` in one chunk."""
    return max(1, SCRATCH_BYTES // (4 * math.prod(frame_shape)))


def quantize_scratch(batch_shape) -> np.ndarray:
    """A float32 scratch for :func:`quantize_to_exponent_np`'s ``out=``
    form into ``[B, H, W, C]`` batches, for its owner to reuse: one chunk
    (the whole batch where it is smaller)."""
    b, *frame = batch_shape
    return np.empty((min(b, scratch_frames(frame)), *frame), np.float32)


def _quantize_chunks(x, n, scale, qmax, out, scratch) -> None:
    for i in range(0, n, len(scratch)):
        s = scratch[:min(len(scratch), n - i)]
        if isinstance(x, np.ndarray):
            _scale_into(s, x[i:i + len(s)], scale)
        else:
            for j in range(len(s)):
                _scale_into(s[j], x[i + j], scale)
        np.rint(s, out=s)
        np.clip(s, -qmax - 1, qmax, out=s)
        np.copyto(out[i:i + len(s)], s, casting="unsafe")


def _scale_into(s: np.ndarray, x: np.ndarray, scale: np.float32) -> None:
    """``s = float32(x) * scale``: float32 frames are multiplied where they
    lie, any other dtype is cast into ``s`` first (a float64 frame is never
    multiplied before its cast)."""
    if x.dtype != np.float32:
        s[...] = x
        x = s
    np.multiply(x, scale, out=s)


def _channel_shape(ndim: int, axis: int) -> list[int]:
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return shape


def quantize_po2(x: torch.Tensor, axis: int, bits: int = 8):
    """-> (q int8/int16, e int32 per-channel): x ~= q * 2^e. The scale is
    the reference's float32 ``jnp.exp2`` (:func:`ref_exp2`)."""
    e = po2_scale(x, axis, bits)
    scale = ref_exp2(-e.cpu().numpy()).to(x.device).reshape(
        _channel_shape(x.ndim, axis))
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x.float() * scale), -qmax - 1, qmax)
    return q.to(int_dtype(bits)), e


def dequantize_po2(q: torch.Tensor, e: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """``q * 2^e`` per channel of ``axis`` in float32, with the reference's
    float32 ``jnp.exp2`` (:func:`ref_exp2`)."""
    scale = ref_exp2(torch.as_tensor(e).cpu().numpy()).to(q.device)
    return q.to(torch.float32) * scale.reshape(_channel_shape(q.ndim, axis))


def align_partial_sums(psum: torch.Tensor, e_in: torch.Tensor,
                       e_common: torch.Tensor, axis: int) -> torch.Tensor:
    """Left-shift partial sums of per-channel formats onto a common scale
    (the adder-tree alignment in Fig. 3(c)): ``(psum << max(sh, 0)) >>
    max(-sh, 0)`` with ``sh = e_in - e_common``, int32 in, int32 out."""
    sh = (torch.as_tensor(e_in) - torch.as_tensor(e_common)).to(
        torch.int32).to(psum.device).reshape(_channel_shape(psum.ndim, axis))
    return torch.bitwise_right_shift(
        torch.bitwise_left_shift(psum, torch.clamp(sh, min=0)),
        torch.clamp(-sh, min=0))


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
    return torch.clamp(y, -qmax - 1, qmax).to(int_dtype(bits))
