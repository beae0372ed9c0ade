"""Quantize-in on the card: ``quantize_in_int8`` rounds a float32 frame
batch onto the program's frozen int8 input format, ``q = clamp(rint(x *
2^-e), -128, 127)``, the same integers as the host's
``quant.quantize_to_exponent_np``.

It ports no TPU kernel: the JAX package rounds frames on the host, as the
port did until the host's numpy walk set a closed serve loop's pace. On
the card path (:func:`repro_torch.core.program.rounds_on_card`) the host
copies the float frames into a pinned slot and stage 0's runner launches
this kernel first, inside its captured CUDA graph.

The kernel is CUDA C++ (``csrc/quantize_in.cu``), built with ``nvcc`` at
its first launch and called through ctypes (``kernels/_build.py``), in a
directory of its own, so it builds in seconds. A tensor on the CPU goes to
the plain version, :func:`quantize_in_int8_ref`; a CUDA tensor always
launches the kernel, or raises. ``quantize_in_int8.launches`` counts the
kernel's launches; ``conv2d_int8.kernel.launch_counts`` reports it as
``"quantize_in"``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize_in.cu"


def quantize_in_int8_ref(x: torch.Tensor, e: int) -> torch.Tensor:
    """The plain version: ``quant.quantize_to_exponent`` at 8 bits."""
    return quant.quantize_to_exponent(x, e, 8)


@_build.once
def _lib():
    """The library, built and bound once per process at the first launch,
    concurrent first callers included."""
    lib = _build.load(SOURCE)
    p = ctypes.c_void_p
    lib.quantize_in_int8_launch.argtypes = [p, p, ctypes.c_longlong,
                                            ctypes.c_float, p]
    lib.quantize_in_int8_launch.restype = ctypes.c_int
    return lib


def quantize_in_int8(x: torch.Tensor, e: int) -> torch.Tensor:
    """x float32, contiguous (a ``[B, H, W, C]`` frame batch) -> int8 of
    the same shape, ``clamp(rint(x * 2^-e), -128, 127)``. On CUDA the
    kernel wants x on a 16-byte base (every allocation is); anything else
    raises. On CPU tensors the plain version runs (the same integers)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous float32 tensor, got "
                         f"{x.dtype} strides {x.stride()}")
    if x.device.type == "cpu":
        return quantize_in_int8_ref(x, e)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_in_int8 runs on cuda or cpu, not "
                         f"{x.device}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if not x.numel():
        return out
    if x.data_ptr() % 16:
        raise ValueError("quantize_in_int8 takes x on a 16-byte base")
    err = _lib().quantize_in_int8_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), 2.0 ** -e,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_in_int8 launch failed: cudaError_t "
                           f"{err} (x {tuple(x.shape)})")
    _build.count(quantize_in_int8)
    return out


_build.reset_count(quantize_in_int8)
