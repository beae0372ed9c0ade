"""Transformer building blocks for the dense and hybrid decoder families:
norms, RoPE, the attention cores and their dispatch, GQA attention with a
linear KV cache or, for windowed layers, a ring cache, and the MLPs. The
port of the part of ``repro/models/layers.py`` that the dense decoders
(GQA/MQA, optional QKV bias and qk_norm) and RecurrentGemma's local
attention run.

Plain functions over parameter dicts, as in the reference, so the two
parameter trees compare leaf for leaf. Mixed dtypes promote as in JAX:
bf16 x f32 tensors compute in f32, Python scalars take the tensor's dtype.

Left for later slices: M-RoPE (VLM slice), MLA and MoE, and the int8
weight-only branch of ``apply_dense`` (reached only through
``quantize_params_int8``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import flash_attention

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator | None, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """Normal(0, scale^2) drawn in float32 on ``device`` and cast, like the
    reference's ``_dense_init``; on the ``meta`` device only the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense(gen, d_in: int, d_out: int, dtype, device,
          bias: bool = False) -> Params:
    p = {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype,
                      device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    if p["w"].dtype == torch.int8:
        raise NotImplementedError(
            "int8 weight-only dense layers are not ported yet (they come "
            "with quantize_params_int8, ROADMAP A)")
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"]


def layer_norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, half: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, half] (float32)."""
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B,S,H,hd]; positions [B,S]. Rotates the two halves of hd."""
    if positions.ndim != 2:
        raise NotImplementedError("M-RoPE positions [B,S,3] come with the "
                                  "VLM slice (ROADMAP A)")
    half = x.shape[-1] // 2
    cos, sin = _rope_angles(positions, half, theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled-dot-product attention cores
# ---------------------------------------------------------------------------


def _sdpa_direct(q, k, v, *, causal: bool, window: int, q_offset: int,
                 kv_len: int | None, kpos: torch.Tensor | None = None):
    """q [B,Sq,KV,G,hd], k/v [B,Skv,KV,hd]. fp32 softmax.

    q_offset: absolute position of q[0] (for causal masking with a cache).
    kv_len: number of valid cache entries (decode), else None.
    kpos: per-slot absolute key positions (ring caches), else arange.
    """
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = (torch.arange(Skv, device=q.device) if kpos is None
            else kpos)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, q_offset: int,
                  chunk: int = 1024):
    """Online softmax over KV chunks: O(Sq * chunk) memory, for prefill
    shapes whose Sq x Skv logits would not fit."""
    B, Sq, KV, G, hd = q.shape
    dv = v.shape[-1]
    Skv = k.shape[1]
    n_chunks = max(1, Skv // chunk)
    if Skv % n_chunks:
        raise ValueError(f"{Skv} keys do not split into {n_chunks} chunks")
    chunk = Skv // n_chunks
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    m = torch.full((B, KV, G, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, KV, G, Sq), device=q.device)
    acc = torch.zeros((B, KV, G, Sq, dv), device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        logits = torch.einsum("bqkgh,bskh->bkgqs", q, kj).float() * scale
        kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                   vj.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)     # -> b q k g h


# Attention implementation switch for the cache-less full-attention path:
# "torch" (the reference's "jax": the plain cores above) or "kernel" (the
# reference's "pallas": the Hopper flash_attention). None picks "kernel"
# for CUDA tensors and "torch" for CPU tensors, so the card runs the
# port's kernel by default (a recorded divergence: the reference defaults
# to "jax").
ATTN_IMPLS = ("torch", "kernel")
_ATTN_IMPL: str | None = None


def set_attention_impl(impl: str | None) -> None:
    global _ATTN_IMPL
    if impl is not None and impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS} or "
                         f"None, not {impl!r}")
    _ATTN_IMPL = impl


def attention_impl(device: torch.device) -> str:
    """The impl in force for tensors on ``device``."""
    if _ATTN_IMPL is not None:
        return _ATTN_IMPL
    return "kernel" if device.type == "cuda" else "torch"


def _sdpa_kernel(q, k, v, *, causal, window):
    """[B,S,KV,G,hd] GQA tensors through the flash kernel. Query heads
    flatten to h = kv * G + g; the kernel reads K/V head h // G in place
    of the reference's repeat of K/V G times."""
    B, Sq, KV, G, hd = q.shape
    out = flash_attention(q.reshape(B, Sq, KV * G, hd), k, v, causal=causal,
                          window=window)
    return out.reshape(B, Sq, KV, G, hd)


def sdpa(q, k, v, *, causal: bool = True, window: int = 0, q_offset=0,
         kv_len=None, kpos=None, chunked_threshold: int = 8192):
    """Dispatch between the direct, chunked and kernel attention cores, on
    the reference's conditions."""
    Sq, Skv = q.shape[1], k.shape[1]
    if (attention_impl(q.device) == "kernel" and kv_len is None
            and kpos is None and Sq == Skv and Sq % min(128, Sq) == 0
            and q.shape[-1] == v.shape[-1]):
        return _sdpa_kernel(q, k, v, causal=causal, window=window)
    if (Sq > 1 and Sq * Skv > chunked_threshold ** 2 and kv_len is None
            and kpos is None):
        return _sdpa_chunked(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    return _sdpa_direct(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len, kpos=kpos)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg, dtype, device) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense(gen, d, H * hd, dtype, device, cfg.qkv_bias),
        "wk": dense(gen, d, KV * hd, dtype, device, cfg.qkv_bias),
        "wv": dense(gen, d, KV * hd, dtype, device, cfg.qkv_bias),
        "wo": dense(gen, H * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, dtype, device)
        p["k_norm"] = rms_norm_init(hd, dtype, device)
    return p


def _ring_write(buf: torch.Tensor, x: torch.Tensor, start: int,
                dim: int) -> None:
    """Write x into buf along ``dim`` at slots start, start + 1, ...
    modulo buf's length there, in place: at most two slice copies, with
    host-int bounds (no index tensor, nothing read back from the card)."""
    size, n = buf.shape[dim], x.shape[dim]
    s0 = start % size
    n1 = min(n, size - s0)
    buf.narrow(dim, s0, n1).copy_(x.narrow(dim, 0, n1))
    if n > n1:
        buf.narrow(dim, 0, n - n1).copy_(x.narrow(dim, n1, n - n1))


def gqa_apply(p: Params, cfg, x, positions, *, cache: Params | None = None,
              window: int = 0, causal: bool = True):
    """Returns (out [B,S,D], new_cache).

    cache = {"k", "v", "idx"}, a linear cache: this call's keys and values
    are written into its tensors in place at [idx, idx + S), and the
    returned cache holds the same tensors with idx + S (a host int, so a
    decode step never waits on the card to learn it).

    With a window and a cache no longer than it, the cache is a ring,
    {"k", "v", "slot_pos", "idx"}: it holds the last ``size`` keys, each in
    slot position % size, and ``slot_pos`` (an int32 tensor on the cache's
    device) the absolute position of each slot's key, -1e9 while empty;
    the causal and window masks read it. Keys, values and slot_pos are
    written in place. A prefill longer than the ring (S > size) keeps only
    its last ``size`` keys, as the reference does: its earlier queries then
    find no valid key and average all values (a fault of the reference,
    ROADMAP C, which the port reproduces)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    q = apply_dense(p["wq"], x).reshape(B, S, KV, G, hd)
    k = apply_dense(p["wk"], x).reshape(B, S, KV, hd)
    v = apply_dense(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    q = apply_rope(q.reshape(B, S, KV * G, hd), positions,
                   cfg.rope_theta).reshape(B, S, KV, G, hd)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    kv_len = None
    q_offset = 0
    if cache is not None:
        idx = int(cache["idx"])
        size = cache["k"].shape[1]
        if window > 0 and size <= window:
            # RoPE is applied before caching, so slot order is irrelevant.
            if S > size:
                k, v = k[:, -size:], v[:, -size:]
            s_eff = min(S, size)
            start = idx + (S - s_eff)
            _ring_write(cache["k"], k.to(cache["k"].dtype), start, 1)
            _ring_write(cache["v"], v.to(cache["v"].dtype), start, 1)
            _ring_write(cache["slot_pos"], torch.arange(
                start, start + s_eff, dtype=cache["slot_pos"].dtype,
                device=cache["slot_pos"].device), start, 0)
            new_cache = {"k": cache["k"], "v": cache["v"], "idx": idx + S,
                         "slot_pos": cache["slot_pos"]}
            out = sdpa(q, cache["k"], cache["v"], causal=causal,
                       window=window, q_offset=idx, kpos=cache["slot_pos"])
            out = out.reshape(B, S, H * hd)
            return apply_dense(p["wo"], out), new_cache
        if idx + S > size:
            raise ValueError(f"cache of {size} positions cannot take {S} "
                             f"more at {idx}")
        cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
        cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "idx": idx + S}
        kv_len = idx + S
        q_offset = idx
    out = sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
               kv_len=kv_len)
    out = out.reshape(B, S, H * hd)
    return apply_dense(p["wo"], out), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, f: int, kind: str, dtype, device) -> Params:
    if kind in ("swiglu", "geglu"):
        return {"wi": dense(gen, d, f, dtype, device),
                "wg": dense(gen, d, f, dtype, device),
                "wo": dense(gen, f, d, dtype, device)}
    return {"wi": dense(gen, d, f, dtype, device),
            "wo": dense(gen, f, d, dtype, device)}


def mlp_apply(p: Params, x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation.
    if kind == "swiglu":
        return apply_dense(p["wo"], F.silu(apply_dense(p["wg"], x))
                           * apply_dense(p["wi"], x))
    if kind == "geglu":
        return apply_dense(p["wo"], F.gelu(apply_dense(p["wg"], x),
                                           approximate="tanh")
                           * apply_dense(p["wi"], x))
    return apply_dense(p["wo"], F.gelu(apply_dense(p["wi"], x),
                                       approximate="tanh"))
