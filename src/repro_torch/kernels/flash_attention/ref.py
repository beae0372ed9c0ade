"""The plain version of ``flash_attention``: causal/windowed softmax
attention with an fp32 softmax, the port of
``repro/kernels/flash_attention/ref.py``.

It keeps the reference's numerics: the QK product in the inputs' dtype,
then float32, divided by sqrt(d); masked logits set to -1e30 (not -inf,
so a row with no valid key averages every value); the probabilities cast
to v's dtype before the PV product. Query rows are aligned to the end of
the keys when Sq != Skv (query i sits at position i + Skv - Sq).

k and v may carry fewer heads than q (grouped-query attention): query
head h reads key/value head h // (H // KV), which is the reference's
``jnp.repeat(k, G, axis=2)`` head order.
"""

from __future__ import annotations

import math

import torch


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,KV,d] -> [B,S,H,d] with head h = kv * G + g reading kv."""
    kv = k.shape[2]
    if n_heads % kv:
        raise ValueError(f"{n_heads} query heads do not split into {kv} "
                         f"key/value heads")
    return k if kv == n_heads else k.repeat_interleave(n_heads // kv, dim=2)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,d], k/v [B,Skv,KV,d] (KV divides H) -> [B,Sq,H,d]."""
    B, Sq, H, d = q.shape
    Skv = k.shape[1]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / math.sqrt(d)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
