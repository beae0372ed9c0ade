"""The Hopper blockwise attention kernel: ``flash_attention``, the port of
the Pallas kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``.

The kernel is CUDA C++ (``csrc/flash_attention.cu``), built with ``nvcc``
at first use and called through ctypes (``kernels/_build.py``). A tensor on
the CPU goes to the plain version, ``ref.attention_ref``; a CUDA tensor
always launches the kernel, or raises. ``flash_attention.launches`` counts
the kernel's launches and nothing else. bf16 at d 64, 128 and 256 runs
the TMA/wgmma kernel, whose tensor maps the C entry point encodes from the
strides passed here at every launch.

The kernel has no backward, as the reference's Pallas kernel has no VJP
(``jax.grad`` refuses it): a call that autograd would record (grad
enabled and q, k or v requiring grad) raises on every device, the CPU
included, rather than return an output whose gradient is silently cut.
Training attends on the plain path (``models/layers.py``'s dispatch).

DTensor operands (a placed forward) run through ``kernels/_local.py``'s
rule: each rank calls this wrapper on its local shard, with the batch over
the batch axes and the heads over ``model`` (where both H and KV divide
it: query head h then finds its key/value head h // (H // KV) on its own
rank), sequence and head dim whole.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, _local
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


@_build.once
def _entry():
    """The C entry point, built and bound once per process."""
    fn = _build.load(SOURCE).flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_layout(name: str, t: torch.Tensor) -> None:
    """What the kernel's 16-byte loads and stores need: d contiguous, every
    other stride and the base address a multiple of 16 bytes."""
    unit = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % unit for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs d contiguous and 16-byte "
                         f"aligned rows (strides {t.stride()}, address "
                         f"{t.data_ptr():#x}); pass .contiguous()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,d], k/v [B,Skv,KV,d] -> [B,Sq,H,d] in q's dtype.

    KV must divide H: query head h attends with key/value head
    h // (H // KV). Query i sits at position i + Skv - Sq for the causal
    (key <= query) and window (key > query - window) masks.
    Not differentiable: raises when autograd would record the call.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no gradient (the reference's Pallas "
            "kernel has no VJP either): attend on the plain path "
            "(set_attention_impl('torch') or None) or call it under "
            "torch.no_grad()")
    if _local.is_placed(q, k, v):
        mesh = _local.mesh_of(q, k, v)
        pl = _local.local_placements(
            mesh, batch=_local.batch_split(mesh, q.shape[0]),
            model_dim=2 if _local.model_split(mesh, q.shape[2], k.shape[2])
            else None)
        return _local.run_local(flash_attention, (q, k, v), (pl, pl, pl), pl,
                                mesh, causal=causal, window=window)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,d] and k, v [B,Skv,KV,d] of "
                         f"one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != d or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head dim, and KV "
                         f"dividing H must agree)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, B, Sq, Skv, H, KV, d, int(causal), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    _build.count(flash_attention)
    return out


flash_attention.launches = 0
