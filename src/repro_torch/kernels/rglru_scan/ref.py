"""The plain version of ``linear_scan``: the diagonal linear recurrence
h_t = a_t * h_{t-1} + b_t as a loop over time in float32, the port of
``repro/kernels/rglru_scan/ref.py`` (the RG-LRU core; RWKV6's per-channel
decay uses the same primitive on its diagonal part).

Each step rounds the product before the sum (two float32 operations, as
the reference's ``lax.scan`` body); the kernel rounds the same way.
"""

from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b [B,S,D] -> h [B,S,D] in float32; h_{-1} = h0 or 0."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(a32[:, 0]) if h0 is None else h0.float()
    out = torch.empty_like(a32)
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out
