"""The Hopper diagonal linear recurrence: ``linear_scan``, the port of the
Pallas kernel ``repro/kernels/rglru_scan/kernel.py::linear_scan``.

The kernel is CUDA C++ (``csrc/linear_scan.cu``), built with ``nvcc`` at
first use and called through ctypes (``kernels/_build.py``). A tensor on
the CPU goes to the plain version, ``ref.linear_scan_ref``; a CUDA tensor
always launches the kernel, or raises. ``linear_scan.launches`` counts
the kernel's launches and nothing else. Each launch gets a zeroed int64
scratch tensor (the blocks' ticket and the chunk-to-chunk hand-off words
of the chunked kernel), allocated here; the kernel allocates nothing.

The Pallas kernel's ``chunk``, ``bt`` and ``interpret`` arguments are TPU
tiling and its interpreter switch; they have no meaning here and are left
out. Its ``S % chunk == 0`` assertion is a Pallas tiling limit, not part
of the function: this kernel takes any S.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
DTYPES = (torch.float32, torch.bfloat16)


@_build.once
def _entry():
    """The C entry points (launch, scratch size), built and bound once per
    process."""
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.linear_scan_launch
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    words = lib.linear_scan_scratch_words
    words.argtypes = [i, i, i]
    words.restype = ctypes.c_longlong
    return fn, words


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B,S,D] -> h [B,S,D] with h_t = a_t * h_{t-1} + b_t and
    h_{-1} = 0, computed in float32 and returned in b's dtype.

    a and b are each float32 or bfloat16, of one shape, on one device.
    """
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b [B,S,D] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype not in DTYPES:
        raise ValueError(f"a and b must be float32 or bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on several devices: {a.device}, "
                         f"{b.device}")
    device = a.device
    if device.type == "cpu":
        return linear_scan_ref(a, b).to(b.dtype)
    if device.type != "cuda":
        raise ValueError(f"linear_scan runs on cuda or cpu, not {device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan: the kernel reads [B,S,D] row-major; "
                         "pass .contiguous()")
    B, S, D = a.shape
    out = torch.empty((B, S, D), dtype=b.dtype, device=device)
    if out.numel() == 0:
        return out
    fn, words = _entry()
    # The chunk-to-chunk hand-off words and the block ticket, zeroed on
    # the launch's stream before every launch.
    scratch = torch.zeros(words(B, S, D), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B, S, D,
                 int(a.dtype == torch.bfloat16),
                 int(b.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"linear_scan launch failed: cudaError_t {err} "
                           f"(a {tuple(a.shape)}, {a.dtype}, {b.dtype})")
    _build.count(linear_scan)
    return out


linear_scan.launches = 0
