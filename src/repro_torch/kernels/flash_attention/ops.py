"""Blockwise attention, the port of ``repro/kernels/flash_attention/ops.py``.

The reference jits its wrapper; PyTorch runs it eagerly, so this is a
plain call of the kernel's wrapper (the kernel on CUDA tensors, its plain
version on CPU tensors)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,d], k/v [B,Skv,KV,d] (KV divides H) -> [B,Sq,H,d]."""
    return flash_attention(q, k, v, causal=causal, window=window)
