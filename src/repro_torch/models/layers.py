"""Transformer building blocks, the port of ``repro/models/layers.py``:
norms, RoPE and M-RoPE, the attention cores and their dispatch, GQA
attention with a linear KV cache, a ring cache for windowed layers, or
projected encoder keys and values (cross-attention), DeepSeek's MLA over
a latent cache, the MLPs, and the shared + routed top-k MoE.

Plain functions over parameter dicts, as in the reference, so the two
parameter trees compare leaf for leaf. Mixed dtypes promote as in JAX:
bf16 x f32 tensors compute in f32, Python scalars take the tensor's dtype.

The int8 weight-only form (``quantize_params_int8``): every dense weight
and MoE expert stack as int8 codes with a float32 scale per output
channel, dequantized in the activations' dtype just before its product,
as in the reference: a plain torch product, not a kernel (the reference's
dequantize and matmul are XLA's, outside any Pallas kernel).

Not ported: the MoE's sharded dispatch (``_moe_sharded``,
``_moe_expert_parallel``), which needs a device mesh with a ``model``
axis (ROADMAP A3).
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


def apply_dense_weight(p: Params, dtype: torch.dtype) -> torch.Tensor:
    """The weight a dense layer multiplies in compute dtype ``dtype``: an
    int8 weight dequantized in that dtype, ``w.to(dtype) *
    w_scale.to(dtype)`` (the scale rounded to ``dtype`` first, as the
    reference rounds it), else ``w`` as it is."""
    w = p["w"]
    if w.dtype == torch.int8:
        return w.to(dtype) * p["w_scale"].to(dtype)
    return w


def apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ apply_dense_weight(p, x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def quantize_params_int8(params: Params) -> Params:
    """Per-output-channel symmetric int8 for every dense weight and MoE
    expert stack, the reference's rule: s = max(|w|, axis -2) (at least
    1e-8) / 127 and q = clip(round(w / s), -127, 127), computed in
    float32 (``torch.round`` rounds half to even, as ``jnp.round``).

    A dict whose ``"w"`` has 2 or 3 dims gets ``{"w": q, "w_scale": s}``;
    a MoE stack ``wi``/``wg``/``wo`` of 3 or 4 dims gets ``<name>_scale``
    beside it. The embedding keeps its dtype; the float32 router is
    quantized too, as in the reference. Lists (a segment's layers) are
    walked, so a per-layer tree gives the leaves of the reference's
    stacked one: the max runs over axis -2 either way. Returns a new tree
    sharing the leaves it does not quantize."""
    def q2d(w):
        w = w.float()
        # 127 as a tensor on w's device, not a Python number: CUDA divides
        # by a CPU scalar as a product with its reciprocal, which moves
        # some scales by an ulp from the reference's division.
        s = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8) \
            / w.new_full((), 127.0)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return q, s.squeeze(-2)

    def is_weight(v, ndims):
        return isinstance(v, torch.Tensor) and v.ndim in ndims \
            and v.dtype != torch.int8

    def visit(node):
        if isinstance(node, list):
            return [visit(v) for v in node]
        if not isinstance(node, dict):
            return node
        if is_weight(node.get("w"), (2, 3)):
            q, s = q2d(node["w"])
            return {**node, "w": q, "w_scale": s}
        out = {}
        for k, v in node.items():
            if k in ("wi", "wg", "wo") and is_weight(v, (3, 4)):
                out[k], out[k + "_scale"] = q2d(v)
            else:
                out[k] = visit(v)
        return out

    with torch.no_grad():
        return visit(params)


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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """x [B,S,H,hd]; positions [B,S], or [B,S,3] for M-RoPE. Rotates the
    two halves of hd.

    M-RoPE (Qwen2-VL): the half's frequencies are split into sections,
    each rotated by its own position component (temporal, height,
    width)."""
    half = x.shape[-1] // 2
    if mrope_sections is None or positions.ndim == 2:
        cos, sin = _rope_angles(positions, half, theta)
    else:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to half the head dim, {half}")
        coss, sins = [], []
        start = 0
        for j, sec in enumerate(mrope_sections):
            freqs = theta ** (-torch.arange(start, start + sec,
                                            dtype=torch.float32,
                                            device=x.device) / half)
            ang = positions[..., j].float()[..., None] * freqs
            coss.append(torch.cos(ang))
            sins.append(torch.sin(ang))
            start += sec
        cos, sin = torch.cat(coss, -1), torch.cat(sins, -1)
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
# to "jax"), and "torch" for any call autograd records: the kernel has no
# gradient, as the reference's has none, and the reference trains on
# "jax". An explicit "kernel" stays "kernel" under autograd, and the
# kernel then raises, as the reference's "pallas" does under jax.grad.
# This is a dispatch rule, not a fallback: nothing is caught or retried.
ATTN_IMPLS = ("torch", "kernel")
_ATTN_IMPL: str | None = None


def set_attention_impl(impl: str | None) -> None:
    global _ATTN_IMPL
    if impl is not None and impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS} or "
                         f"None, not {impl!r}")
    _ATTN_IMPL = impl


def attention_impl(device: torch.device, *operands: torch.Tensor) -> str:
    """The impl in force for a call on ``operands``, tensors on
    ``device``."""
    if _ATTN_IMPL is not None:
        return _ATTN_IMPL
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return "torch"
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
    if (attention_impl(q.device, q, k, v) == "kernel" and kv_len is None
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
              window: int = 0, cross_kv: tuple | None = None,
              causal: bool = True):
    """Returns (out [B,S,D], new_cache).

    cross_kv: (k, v) [B,Skv,KV,hd], already projected: encoder-decoder
    cross-attention, non-causal, with nothing rotated (the Seamless
    backbone's).

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
    if cross_kv is None:
        k = apply_dense(p["wk"], x).reshape(B, S, KV, hd)
        v = apply_dense(p["wv"], x).reshape(B, S, KV, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    causal = causal and cross_kv is None
    if cross_kv is None:
        sections = cfg.mrope_sections if cfg.mrope else None
        q = apply_rope(q.reshape(B, S, KV * G, hd), positions,
                       cfg.rope_theta, sections).reshape(B, S, KV, G, hd)
        k = apply_rope(k, positions, cfg.rope_theta, sections)

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
# MLA attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, dtype, device) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vh = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    p: Params = {}
    if qr:
        p["wq_a"] = dense(gen, d, qr, dtype, device)
        p["q_a_norm"] = rms_norm_init(qr, dtype, device)
        p["wq_b"] = dense(gen, qr, H * (nope + rope), dtype, device)
    else:
        p["wq"] = dense(gen, d, H * (nope + rope), dtype, device)
    p["wkv_a"] = dense(gen, d, kvr + rope, dtype, device)
    p["kv_a_norm"] = rms_norm_init(kvr, dtype, device)
    p["wkv_b"] = dense(gen, kvr, H * (nope + vh), dtype, device)
    p["wo"] = dense(gen, H * vh, d, dtype, device)
    return p


def mla_apply(p: Params, cfg, x, positions, *, cache: Params | None = None):
    """MLA with a low-rank latent KV. Returns (out [B,S,D], new_cache).

    Forward and prefill take the decompressed path: keys and values
    expanded from this call's latent, attended through ``sdpa`` (q and v
    head dims differ, so never the kernel). A single-token call with a
    cache takes the matrix-absorbed path: q_nope is contracted with W_uk
    into the latent space and attends over the cached latent directly,
    the reference's order of contractions and bf16 casts.

    cache = {"ckv" [B,Smax,kvr], "krope" [B,Smax,rope], "idx"}: this
    call's latent and rotated key are written into its tensors in place
    at [idx, idx + S), idx a host int as in ``gqa_apply``. As in the
    reference, a multi-token call with a non-empty cache attends only
    within the call (causal from its own first token): it writes the
    cache but reads none of it (ROADMAP C7).
    """
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope, vh = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q = apply_dense(p["wq_b"],
                        rms_norm(p["q_a_norm"], apply_dense(p["wq_a"], x)))
    else:
        q = apply_dense(p["wq"], x)
    q = q.reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = apply_dense(p["wkv_a"], x)
    ckv, k_rope = kv_a[..., :kvr], kv_a[..., kvr:]
    ckv = rms_norm(p["kv_a_norm"], ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    wkv_b = apply_dense_weight(p["wkv_b"], x.dtype)
    wkv_b = wkv_b.reshape(kvr, H, nope + vh)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    scale = 1.0 / math.sqrt(nope + rope)

    new_cache = None
    if cache is not None:
        idx = int(cache["idx"])
        if idx + S > cache["ckv"].shape[1]:
            raise ValueError(f"cache of {cache['ckv'].shape[1]} positions "
                             f"cannot take {S} more at {idx}")
        cache["ckv"][:, idx:idx + S] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, idx:idx + S] = k_rope.to(cache["krope"].dtype)
        new_cache = {"ckv": cache["ckv"], "krope": cache["krope"],
                     "idx": idx + S}

    if cache is not None and S == 1:
        # Absorbed decode over the valid entries [0, idx + 1): the
        # reference's mask over the rest of the buffer (kpos < idx + S)
        # gives those entries probability 0, so they add nothing.
        ckv_all = cache["ckv"][:, :idx + S]
        kr_all = cache["krope"][:, :idx + S]
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv_all)
                  + torch.einsum("bshn,btn->bhst", q_rope, kr_all)
                  ).float() * scale
        probs = torch.softmax(logits, -1).to(x.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", probs, ckv_all)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
        return apply_dense(p["wo"], out.reshape(B, S, H * vh)), new_cache

    # Decompressed path (forward / prefill), over this call's latent only.
    kv = torch.einsum("btr,rhn->bthn", ckv, wkv_b)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                       -1)
    # H query heads as H KV groups of one for the shared sdpa core.
    out = sdpa(q_full[:, :, :, None, :], k_full, v, causal=True, q_offset=0)
    out = out[:, :, :, 0, :]
    return apply_dense(p["wo"], out.reshape(B, S, H * vh)), new_cache


# ---------------------------------------------------------------------------
# MLPs and MoE
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


def moe_init(gen, cfg, dtype, device) -> Params:
    """The router (float32 whatever ``dtype`` is), the routed experts'
    stacked [E, d, f] / [E, f, d] weights and the shared experts' SwiGLU.
    The reference scales the stacked weights by 1/sqrt of their first
    axis, E (``_dense_init``'s fan-in rule), and so does the port."""
    d, E, f = cfg.d_model, cfg.moe_n_experts, cfg.moe_d_ff
    scale = 1.0 / math.sqrt(E)
    p = {
        "router": dense(gen, d, E, torch.float32, device),
        "wi": _normal(gen, (E, d, f), scale, dtype, device),
        "wg": _normal(gen, (E, d, f), scale, dtype, device),
        "wo": _normal(gen, (E, f, d), scale, dtype, device),
    }
    if cfg.moe_n_shared:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff * cfg.moe_n_shared,
                               "swiglu", dtype, device)
    return p


def moe_apply(p: Params, cfg, x):
    """Top-k MoE: the sort-based dispatch on one device. Returns
    (y [B,S,D], aux loss). The reference's expert-parallel dispatch over a
    mesh's ``model`` axis has no counterpart on one card (ROADMAP A3)."""
    return _moe_local(p, cfg, x)


def _expert_w(p: Params, name: str, dtype):
    w = p[name]
    if w.dtype == torch.int8:
        return w.to(dtype) * p[name + "_scale"][:, None, :].to(dtype)
    return w


def _expert_counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """How many of ``ids`` name each of the E experts: the reference's
    ``segment_sum(ones, ids, num_segments=E)``. An integer scatter-add
    into E slots, exact in any order; unlike ``torch.bincount`` its output
    shape does not depend on the values, so it also runs on the ``meta``
    device and reads nothing back from the card."""
    return torch.zeros(E, dtype=ids.dtype, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def moe_route(p: Params, cfg, xt: torch.Tensor) -> dict:
    """The routing of ``_moe_local`` for tokens xt [T,D].

    Returns the gates [T,E] (float32), the top-k ids and weights [T,k]
    (ids in descending gate order, ties to the lower id as
    ``jax.lax.top_k`` breaks them; weights renormalised), the dispatch
    table of the reference (``tok_idx`` [E,C]: the token in each expert's
    slot, ``valid`` [E,C]: whether the slot holds one; choices grouped by
    expert with a stable sort, the overflow past C = ceil(k T / E *
    capacity_factor) dropped), and for each choice its slot (``rank``
    [T,k]) and whether it was kept (``kept``)."""
    T = xt.shape[0]
    E, k = cfg.moe_n_experts, cfg.moe_top_k
    C = max(1, int(math.ceil(k * T / E * cfg.moe_capacity_factor)))
    gates = torch.softmax(apply_dense(p["router"], xt.float()), -1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = _expert_counts(flat_e, E)
    offsets = torch.cumsum(counts, 0) - counts
    c = torch.arange(C, device=xt.device)
    slot = offsets[:, None] + c[None, :]
    valid = (c[None, :] < counts[:, None]) & (slot < T * k)
    tok_idx = (order // k)[torch.clamp(slot, 0, T * k - 1)]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=xt.device)
    rank = (pos - offsets[flat_e]).reshape(T, k)
    return {"gates": gates, "topi": topi, "topv": topv, "C": C,
            "tok_idx": tok_idx, "valid": valid, "rank": rank,
            "kept": rank < C}


def _moe_local(p: Params, cfg, x):
    """The sort-based top-k dispatch with capacity C on one device:
    gather each expert's tokens, run the experts as batched matrix
    products, combine, add the shared experts; and the Switch-style
    load-balance aux loss.

    The reference combines with a scatter-add in x's dtype, each token's
    contributions added in the order of their slots, i.e. by ascending
    expert id. The port gathers each token's k contributions instead and
    adds them in that same order, one rounding per add: the same sums on
    every run (a scatter on CUDA adds with atomics in no fixed order)."""
    B, S, D = x.shape
    E = cfg.moe_n_experts
    T = B * S
    xt = x.reshape(T, D)
    r = moe_route(p, cfg, xt)
    C = r["C"]
    xe = xt[r["tok_idx"].reshape(-1)].reshape(E, C, D)
    xe = xe * r["valid"][..., None].to(xt.dtype)
    h = torch.bmm(xe, _expert_w(p, "wi", xe.dtype))
    g = torch.bmm(xe, _expert_w(p, "wg", xe.dtype))
    ye = torch.bmm(F.silu(g) * h, _expert_w(p, "wo", xe.dtype))

    # Each choice's weighted output, its slot's row of ye (0 if dropped),
    # taken in ascending expert order per token.
    by_expert = torch.argsort(r["topi"], dim=-1)
    e_sorted = r["topi"].gather(1, by_expert)
    rank = r["rank"].gather(1, by_expert)
    kept = r["kept"].gather(1, by_expert)
    w = r["topv"].gather(1, by_expert).to(xt.dtype) * kept.to(xt.dtype)
    rows = ye.reshape(E * C, D)[(e_sorted * C + torch.clamp(rank, max=C - 1))
                                .reshape(-1)].reshape(T, -1, D)
    contrib = rows * w[..., None]
    yt = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        yt = yt + contrib[:, j]
    y = yt.reshape(B, S, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    density = _expert_counts(r["topi"].reshape(-1), E).float() / T
    router_prob = r["gates"].mean(0)
    aux = E * torch.sum(density * router_prob)
    return y, aux.float()
