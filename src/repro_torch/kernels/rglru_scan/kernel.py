"""The Hopper diagonal linear recurrence: ``linear_scan``, the port of the
Pallas kernel ``repro/kernels/rglru_scan/kernel.py::linear_scan``.

The kernel is CUDA C++ (``csrc/linear_scan.cu``), built with ``nvcc`` at
first use and called through ctypes (``kernels/_build.py``). A tensor on
the CPU goes to the plain version, ``ref.linear_scan_ref``; a CUDA tensor
always launches the kernel, or raises. ``linear_scan.launches`` counts
the kernel's launches and nothing else, and ``linear_scan.launches_by_path``
splits them into ``"forward"`` and ``"backward"``. Each launch gets a
zeroed int64 scratch tensor (the blocks' ticket and the chunk-to-chunk
hand-off words of the chunked kernel), allocated here; the kernel
allocates nothing.

Under autograd (grad enabled and a or b requiring grad) the call goes
through ``_LinearScan``, whose backward is the same recurrence run
backwards in time: with g_t = dL/dh_t + a_{t+1} g_{t+1} (g_S = 0),

    db_t = g_t,    da_t = g_t * h_{t-1}    (h_{-1} = 0),

and g is ``linear_scan`` itself on the time-reversed a_{t+1} and dL/dh.
So the backward launches the same kernel (the plain version on CPU
tensors) and the gradient is never cut: the kernel's output is an empty
tensor it fills, which autograd cannot see through by itself. Each step
rounds as autograd through ``linear_scan_ref`` does (the product, then
the sum), so on the CPU the two gradients are equal. The reference's
Pallas kernel has no VJP (``jax.grad`` refuses it); this gradient is the
port's own, for the RG-LRU that runs through this kernel.

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
    Differentiable in a and b (the backward runs the kernel too).
    """
    _check(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LinearScan.apply(a, b)
    return _scan(a, b, "forward")


class _LinearScan(torch.autograd.Function):
    """``linear_scan`` with its gradient: the forward keeps h in float32
    (the kernel's own h before it rounds to b's dtype), the backward is
    one more scan over reversed time."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b.float(), "forward")
        ctx.save_for_backward(a, h)
        ctx.b_dtype = b.dtype
        return h.to(b.dtype)

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        B, S, D = a.shape
        if S == 0:
            return torch.zeros_like(a), torch.zeros_like(h, dtype=ctx.b_dtype)
        zero = a.new_zeros((B, 1, D))
        # Reversed time: step s of the backward scan is step S-1-s, whose
        # decay is a_{t+1} (0 past the end).
        a_rev = torch.cat([zero, a.flip(1)[:, :S - 1]], dim=1)
        g = _scan(a_rev, dh.float().flip(1).contiguous(),
                  "backward").flip(1)
        h_prev = torch.cat([zero.float(), h[:, :S - 1]], dim=1)
        da = (g * h_prev).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = g.to(ctx.b_dtype) if ctx.needs_input_grad[1] else None
        return da, db


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b [B,S,D] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype not in DTYPES:
        raise ValueError(f"a and b must be float32 or bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on several devices: {a.device}, "
                         f"{b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_scan runs on cuda or cpu, not {a.device}")
    if a.device.type == "cuda" and not (a.is_contiguous()
                                        and b.is_contiguous()):
        raise ValueError("linear_scan: the kernel reads [B,S,D] row-major; "
                         "pass .contiguous()")


def _scan(a: torch.Tensor, b: torch.Tensor, path: str) -> torch.Tensor:
    """One checked scan: the plain version on the CPU, else one launch,
    counted under ``path``."""
    device = a.device
    if device.type == "cpu":
        return linear_scan_ref(a, b).to(b.dtype)
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
    _build.count(linear_scan, path)
    return out


linear_scan.launches = 0
linear_scan.launches_by_path = {"forward": 0, "backward": 0}
