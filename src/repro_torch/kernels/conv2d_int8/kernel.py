"""The Hopper int8 GEMM engine: ``gemm_int8`` with the fused requantize
epilogue, the port of the Pallas kernel
``repro/kernels/conv2d_int8/kernel.py::gemm_int8``.

The kernel is CUDA C++ (``csrc/gemm_int8.cu``), built with ``nvcc`` at
first use and called through ctypes (``kernels/_build.py``). A tensor on
the CPU goes to the plain version, ``ref.gemm_int8_ref``; a CUDA tensor
always launches the kernel, or raises. ``gemm_int8.launches`` counts the
kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import gemm_int8_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm_int8.cu"


@functools.cache
def _entry():
    """The C entry point, built and bound once per process (a per-launch
    library lookup touches the filesystem and costs more host time than
    the kernel takes on the card)."""
    fn = _build.load(SOURCE).gemm_int8_launch
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """A 2-D operand: ``dtype``, unit stride along rows, rows that do not
    overlap (a leading dimension >= the row length)."""
    if t.dtype != dtype or t.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1 or \
            t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: rows must be contiguous (strides "
                         f"{t.stride()} for shape {tuple(t.shape)})")


def _check_vec(name: str, t: torch.Tensor, m: int) -> None:
    if t.dtype != torch.int32 or t.shape != (m,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 [{m}] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def gemm_int8(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
              bias: torch.Tensor | None = None, *, relu: bool = False,
              emit_int32: bool = False) -> torch.Tensor:
    """int8 GEMM with fused requantize epilogue: [N,K]x[K,M] -> int8 [N,M].

    ``out = clip((relu?)(x @ w + bias) >> shift)`` with per-column (output
    channel) ``shift``/``bias``; negative shifts left-shift. With
    ``emit_int32`` the epilogue stops after bias/ReLU and returns the raw
    int32 accumulators. ``x`` and ``w`` may be row-major views with any
    leading dimension; ``shift`` and ``bias`` are contiguous int32 [M].
    """
    _check_rows("x", x, torch.int8)
    _check_rows("w", w, torch.int8)
    N, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    M = w.shape[1]
    _check_vec("shift", shift, M)
    if bias is not None:
        _check_vec("bias", bias, M)
    devices = {t.device for t in (x, w, shift, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return gemm_int8_ref(x, w, shift, bias, relu=relu,
                             emit_int32=emit_int32)
    if device.type != "cuda":
        raise ValueError(f"gemm_int8 runs on cuda or cpu, not {device}")
    out = torch.empty((N, M), dtype=torch.int32 if emit_int32 else torch.int8,
                      device=device)
    if N == 0 or M == 0:
        return out
    fn = _entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                 shift.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), N, K, M, int(relu), int(emit_int32), stream)
    if err:
        raise RuntimeError(f"gemm_int8 launch failed: cudaError_t {err} "
                           f"(N={N}, K={K}, M={M})")
    gemm_int8.launches += 1
    return out


gemm_int8.launches = 0
