"""The Hopper depthwise int8 conv: ``dwconv_int8``, a 3 x 3 depthwise conv
(channel multiplier 1, padding 1, stride 1 or 2) with ``gemm_int8``'s
fused epilogue: int32 accumulation, bias, ReLU or none, the per-channel
saturating shift, the clip onto ``[-128, qmax]`` (127, or a ReLU6
engine's ceiling).

It ports no TPU kernel: the JAX package has no depthwise model, and runs
a grouped conv as one GEMM per group, which for a depthwise conv is one
launch per channel with K = 9. ``conv2d_int8`` sends a depthwise conv
here instead (MobileNetV2's 17 a frame).

The kernel is CUDA C++ (``csrc/dwconv_int8.cu``), built with ``nvcc`` at
its first launch and called through ctypes (``kernels/_build.py``), so a
process whose programs hold no depthwise step never builds or loads it.
A tensor on the CPU goes to the plain version, :func:`dwconv_int8_ref`,
in this module; a CUDA tensor always launches the kernel, or raises.
``dwconv_int8.launches`` counts the kernel's launches and nothing else;
``conv2d_int8.kernel.launch_counts`` reports it as ``"depthwise"``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import requantize_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "dwconv_int8.cu"
QMAX = 127
STRIDES = (1, 2)
MAX_CHANNELS = 128          # channels a block takes
MAX_THREADS = 256           # threads a block, before its rows are cut
MAX_SMEM = 48 * 1024        # a block's staged input and weights, bytes


def depthwise_acc(x: torch.Tensor, w: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """The exact int32 accumulators of the 3 x 3 depthwise conv of x [B, H,
    W, C] with w [3, 3, (1,) C] at ``stride``, padding 1: nine strided
    slices of the zero-padded input times their tap's weights, summed in
    int32 (|acc| <= 9 * 2^14). Any device."""
    wc = w.reshape(3, 3, -1).to(torch.int32)
    xp = F.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1))
    Ho = (x.shape[1] - 1) // stride + 1
    Wo = (x.shape[2] - 1) // stride + 1
    acc = None
    for r in range(3):
        for s in range(3):
            tap = xp[:, r:r + (Ho - 1) * stride + 1:stride,
                     s:s + (Wo - 1) * stride + 1:stride, :] * wc[r, s]
            acc = tap if acc is None else acc + tap
    return acc


def dwconv_int8_ref(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                    bias: torch.Tensor | None = None, *, stride: int = 1,
                    relu: bool = False, qmax: int = QMAX) -> torch.Tensor:
    """The plain version: :func:`depthwise_acc`, then ``requantize_ref``,
    the epilogue every route of the engine shares."""
    acc = depthwise_acc(x, w, stride)
    C = acc.shape[-1]
    return requantize_ref(acc.reshape(-1, C), shift, bias, relu,
                          qmax=qmax).reshape(acc.shape)


@_build.once
def _lib():
    """The library, built and bound once per process at the first launch,
    concurrent first callers included."""
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dwconv_int8_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, i, i, p]
    lib.dwconv_int8_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def plan_for(B: int, C: int, Ho: int, Wo: int, stride: int,
             sms: int) -> tuple[int, int, int]:
    """``(cb, tw, th)``: a block's channels (at most 128), output columns
    and output rows. Channels run across the threads four a thread, the
    columns down them up to 256 threads a block; the rows start at 8 and
    halve while the grid would not give each SM two blocks, or the
    block's staged input would pass 48 KiB."""
    cb = min(C, MAX_CHANNELS)
    tw = max(1, min(Wo, MAX_THREADS // (cb // 4)))
    th = min(Ho, 8)

    def blocks(h):
        return -(-C // cb) * -(-Wo // tw) * -(-Ho // h) * B

    def smem(h, w_):
        return ((h - 1) * stride + 3) * ((w_ - 1) * stride + 3) * cb + 9 * cb

    while th > 1 and (blocks(th) < 2 * sms or smem(th, tw) > MAX_SMEM):
        th = -(-th // 2)
    while smem(th, tw) > MAX_SMEM:
        tw = -(-tw // 2)
    return cb, tw, th


def _check(x, w, shift, bias, stride, qmax) -> torch.device:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x: expected an int8 [B, H, W, C] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C = x.shape[3]
    if w.dtype != torch.int8 or w.numel() != 9 * C or \
            tuple(w.shape[:2]) != (3, 3) or w.shape[-1] != C:
        raise ValueError(f"w: expected int8 [3, 3, 1, {C}] weights, got "
                         f"{w.dtype} {tuple(w.shape)}")
    for name, t in (("shift", shift), ("bias", bias)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (C,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous int32 [{C}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride {stride}: the kernel takes 1 or 2")
    if not isinstance(qmax, int) or not 0 <= qmax <= QMAX:
        raise ValueError(f"qmax: expected an int in [0, {QMAX}], got "
                         f"{qmax!r}")
    devices = {t.device for t in (x, w, shift, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    return devices.pop()


def dwconv_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                relu: bool = False, qmax: int = QMAX) -> torch.Tensor:
    """x [B, H, W, C] int8 NHWC, w [3, 3, 1, C] (or [3, 3, C]) int8, shift
    and bias [C] int32 -> int8 [B, Ho, Wo, C], Ho = (H - 1) // stride + 1:
    ``clip(shift((relu?)(dwconv(x, w) + bias)), -128, qmax)``, padding 1.
    On CUDA the kernel wants x and w contiguous and C a multiple of 4
    (every depthwise width of MobileNetV2 is a multiple of 16, which takes
    16-byte loads); anything else raises. On CPU tensors the plain version
    runs (the same integers)."""
    device = _check(x, w, shift, bias, stride, qmax)
    if device.type == "cpu":
        return dwconv_int8_ref(x, w, shift, bias, stride=stride, relu=relu,
                               qmax=qmax)
    if device.type != "cuda":
        raise ValueError(f"dwconv_int8 runs on cuda or cpu, not {device}")
    B, H, W, C = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty((B, Ho, Wo, C), dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    if not (x.is_contiguous() and w.is_contiguous()) or C % 4 or \
            x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError(f"dwconv_int8 takes contiguous x and w on 4-byte "
                         f"bases with C a multiple of 4 (x {tuple(x.shape)} "
                         f"strides {x.stride()}, w strides {w.stride()})")
    vl = next(v for v in (16, 8, 4)
              if C % v == 0 and x.data_ptr() % v == 0
              and w.data_ptr() % v == 0)
    cb, tw, th = plan_for(B, C, Ho, Wo, stride, _sms(device.index or 0))
    err = _lib().dwconv_int8_launch(
        x.data_ptr(), w.data_ptr(), shift.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, H, W,
        C, stride, int(relu), qmax, vl, cb, tw, th,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"dwconv_int8 launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, stride {stride}, plan "
                           f"{(vl, cb, tw, th)})")
    _build.count(dwconv_int8)
    return out


_build.reset_count(dwconv_int8)
