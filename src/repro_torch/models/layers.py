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

The MoE is expert-parallel under a mesh with a ``model`` axis of more
than one rank (``_moe_sharded``, ``_moe_expert_parallel``, on
``torch.distributed``'s DTensor), as the reference's is under its mesh;
the pipeline splits its experts over ``tp`` itself
(``core/pipeline.py::_moe_apply_tp``, through ``moe_route_shard`` and
``_moe_routed``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.kernels import _local
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch.mesh import ambient_mesh

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


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A placed table (vocab-parallel: its rows split
    over ``model``) is looked up on each rank's local shard: every rank
    takes the rows its shard holds and zeros elsewhere, and the sum over
    ``model`` (an all-reduce) adds exact zeros to the one rank's row. A
    dispatch rule: DTensor's own lookup has no gradient rule in some torch
    releases (torch 2.11 fails the backward's ``index_put``)."""
    if not _local.is_placed(table, tokens):
        return table[tokens]
    mesh = _local.mesh_of(table, tokens)
    vocab = _local.model_split(mesh, table.shape[0])
    batch = _local.batch_split(mesh, tokens.shape[0])
    rep, partial = Replicate(), Partial()

    def on(batch_pl, model_pl):
        return _local.per_axis(mesh, batch, batch_pl, model_pl)

    tab_pl = on(rep, Shard(0) if vocab else rep)
    out_pl = on(Shard(0), partial if vocab else rep)
    lo = compute_local_shape_and_global_offset(
        table.shape, mesh, tab_pl)[1][0]

    def lookup(tab, tok):
        rows = tok - lo
        inside = (rows >= 0) & (rows < tab.shape[0])
        got = tab[torch.where(inside, rows, 0)]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    out = _local.run_local(
        lookup, (table, tokens), (tab_pl, on(Shard(0), rep)), out_pl, mesh,
        in_grad_placements=(on(partial, Shard(0) if vocab else rep),
                            on(Shard(0), rep)))
    return out.redistribute(mesh, on(Shard(0), rep))


def apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = _local.reduced(x) @ apply_dense_weight(p, x.dtype)
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
    the reference's conditions. Placed operands (DTensors) reach the
    kernel through its wrapper's rule, and the plain cores through the
    same rule here (``kernels/_local.py``): each core is local to a
    (batch, KV head) shard, so it runs as one ``local_map`` rather than
    as a DTensor op per step of its chunk loop."""
    Sq, Skv = q.shape[1], k.shape[1]
    if (attention_impl(q.device, q, k, v) == "kernel" and kv_len is None
            and kpos is None and Sq == Skv and Sq % min(128, Sq) == 0
            and q.shape[-1] == v.shape[-1]):
        return _sdpa_kernel(q, k, v, causal=causal, window=window)
    if _local.is_placed(q, k, v):
        mesh = _local.mesh_of(q, k, v)
        pl = _local.local_placements(
            mesh, batch=_local.batch_split(mesh, q.shape[0]),
            model_dim=2 if _local.model_split(mesh, q.shape[2], k.shape[2])
            else None)
        rep = (Replicate(),) * mesh.ndim
        return _local.run_local(
            _sdpa_plain, (q, k, v, kpos), (pl, pl, pl,
                                           None if kpos is None else rep),
            pl, mesh, causal=causal, window=window, q_offset=q_offset,
            kv_len=kv_len, chunked_threshold=chunked_threshold)
    return _sdpa_plain(q, k, v, kpos, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len,
                       chunked_threshold=chunked_threshold)


def _sdpa_plain(q, k, v, kpos, *, causal, window, q_offset, kv_len,
                chunked_threshold):
    """The chunked core for long prefills without a cache, else the
    direct one."""
    Sq, Skv = q.shape[1], k.shape[1]
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
    _cache_write(buf, x.narrow(dim, 0, n1), s0, dim)
    if n > n1:
        _cache_write(buf, x.narrow(dim, n1, n - n1), 0, dim)


def _cache_write(buf: torch.Tensor, x: torch.Tensor, start: int,
                 dim: int) -> None:
    """``buf.narrow(dim, start, len) .copy_(x)`` in place. A placed cache
    (DTensors; its sequence dim may be split over ``model``) is written
    on each rank's local shard: x gathered along ``dim``'s mesh axes to the
    buffer's other placements, and each rank copies the part of the slots
    its shard holds. DTensor has no in-place rule for a slice of a split
    dim."""
    if not _local.is_placed(buf, x):
        buf.narrow(dim, start, x.shape[dim]).copy_(x)
        return
    mesh = buf.device_mesh
    x_pl = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim
                 else pl for pl in buf.placements)
    x_loc = _local.as_placed(x, mesh, x_pl).to_local()
    local = buf.to_local()
    _, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo, n_loc = offset[dim], local.shape[dim]
    a, b = max(start, lo), min(start + x.shape[dim], lo + n_loc)
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(
            x_loc.narrow(dim, a - start, b - a))


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
    q = _local.reshape(apply_dense(p["wq"], x), (B, S, KV, G, hd))
    if cross_kv is None:
        k = _local.reshape(apply_dense(p["wk"], x), (B, S, KV, hd))
        v = _local.reshape(apply_dense(p["wv"], x), (B, S, KV, hd))
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    causal = causal and cross_kv is None
    if cross_kv is None:
        sections = cfg.mrope_sections if cfg.mrope else None
        q = _local.reshape(apply_rope(
            _local.reshape(q, (B, S, KV * G, hd)), positions,
            cfg.rope_theta, sections), (B, S, KV, G, hd))
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
            out = _local.reshape(out, (B, S, H * hd))
            return apply_dense(p["wo"], out), new_cache
        if idx + S > size:
            raise ValueError(f"cache of {size} positions cannot take {S} "
                             f"more at {idx}")
        _cache_write(cache["k"], k.to(cache["k"].dtype), idx, 1)
        _cache_write(cache["v"], v.to(cache["v"].dtype), idx, 1)
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "idx": idx + S}
        kv_len = idx + S
        q_offset = idx
    out = sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
               kv_len=kv_len)
    out = _local.reshape(out, (B, S, H * hd))
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
    q = _local.reshape(q, (B, S, H, nope + rope))
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
        _cache_write(cache["ckv"], ckv.to(cache["ckv"].dtype), idx, 1)
        _cache_write(cache["krope"], k_rope.to(cache["krope"].dtype), idx, 1)
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
        return apply_dense(p["wo"], _local.reshape(out, (B, S, H * vh))), \
            new_cache

    # Decompressed path (forward / prefill), over this call's latent only.
    kv = torch.einsum("btr,rhn->bthn", ckv, wkv_b)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                       -1)
    # H query heads as H KV groups of one for the shared sdpa core.
    out = sdpa(q_full[:, :, :, None, :], k_full, v, causal=True, q_offset=0)
    out = out[:, :, :, 0, :]
    return apply_dense(p["wo"], _local.reshape(out, (B, S, H * vh))), \
        new_cache


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
    """Top-k MoE dispatcher. Returns (y [B,S,D], aux loss). Under an
    ambient mesh (``launch/mesh.py::set_mesh``) with a ``model`` axis and
    more than one rank, the reference's condition, ``_moe_sharded``: tokens
    stay on their data shard, experts are expert-parallel over ``model``,
    and the combine is an all-reduce. Otherwise ``_moe_local``; a placed x
    (DTensors) then runs it on every rank over the whole batch
    (``_moe_replicated``): its sorts and scatter-adds have no DTensor
    sharding rule. ``moe_apply.calls_by_path`` counts the calls by path."""
    mesh = ambient_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names \
            and mesh.size() > 1:
        moe_apply.calls_by_path["expert_parallel"] += 1
        return _moe_sharded(p, cfg, x, mesh)
    moe_apply.calls_by_path["local"] += 1
    if _local.is_placed(x):
        return _moe_replicated(p, cfg, x, _local.mesh_of(x))
    return _moe_local(p, cfg, x)


moe_apply.calls_by_path = {"local": 0, "expert_parallel": 0}


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
    return moe_route_shard(p, cfg, xt, 0, 1)


def moe_route_shard(p: Params, cfg, xt: torch.Tensor, shard: int,
                    n_shards: int) -> dict:
    """``moe_route`` for shard ``shard`` of ``n_shards`` of the experts,
    the reference's ``_moe_expert_parallel`` routing: the same gates and
    top-k over all E experts, and the dispatch table of the shard's E_loc =
    E / n_shards experts (ids ``shard * E_loc`` on, row e of ``tok_idx``
    for expert ``shard * E_loc + e``), its capacity C sized from the
    tokens given, as the reference sizes it from a shard's tokens. A
    choice of another shard's expert is not kept here. With one shard it
    is ``moe_route``."""
    T = xt.shape[0]
    E, k = cfg.moe_n_experts, cfg.moe_top_k
    E_loc = E // n_shards
    off = shard * E_loc
    C = max(1, int(math.ceil(k * T / E * cfg.moe_capacity_factor)))
    gates = torch.softmax(apply_dense(p["router"], xt.float()), -1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(-1) - off
    in_range = (flat_e >= 0) & (flat_e < E_loc)
    # Another shard's choices sort last, into an (E_loc + 1)-th bin.
    flat_e = torch.where(in_range, flat_e, E_loc)
    order = torch.argsort(flat_e, stable=True)
    counts = _expert_counts(flat_e, E_loc + 1)[:E_loc]
    offsets = torch.cumsum(counts, 0) - counts
    c = torch.arange(C, device=xt.device)
    slot = offsets[:, None] + c[None, :]
    valid = (c[None, :] < counts[:, None]) & (slot < T * k)
    tok_idx = (order // k)[torch.clamp(slot, 0, T * k - 1)]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=xt.device)
    local = torch.where(in_range, flat_e, 0)
    rank = (pos - offsets[local]).reshape(T, k)
    return {"gates": gates, "topi": topi, "topv": topv, "C": C,
            "tok_idx": tok_idx, "valid": valid, "rank": rank,
            "kept": in_range.reshape(T, k) & (rank < C)}


def _moe_routed(p: Params, x, r: dict, off: int):
    """The routed experts' output [B,S,D] for tokens x under routing ``r``
    (``moe_route_shard``'s, whose experts are ``p``'s stacks, ids ``off``
    on): gather each expert's tokens, run the experts as batched matrix
    products, and combine.

    The reference combines with a scatter-add in x's dtype, each token's
    contributions added in the order of their slots, i.e. by ascending
    expert id. The port gathers each token's k contributions instead and
    adds them in that same order, one rounding per add: the same sums on
    every run (a scatter on CUDA adds with atomics in no fixed order). A
    choice that was not kept here adds an exact zero."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E_loc, C = r["tok_idx"].shape[0], r["C"]
    xe = xt[r["tok_idx"].reshape(-1)].reshape(E_loc, C, D)
    xe = xe * r["valid"][..., None].to(xt.dtype)
    h = torch.bmm(xe, _expert_w(p, "wi", xe.dtype))
    g = torch.bmm(xe, _expert_w(p, "wg", xe.dtype))
    ye = torch.bmm(F.silu(g) * h, _expert_w(p, "wo", xe.dtype))

    # Each choice's weighted output, its slot's row of ye (0 if not kept
    # here), taken in ascending expert order per token.
    by_expert = torch.argsort(r["topi"], dim=-1)
    e_sorted = r["topi"].gather(1, by_expert) - off
    rank = r["rank"].gather(1, by_expert)
    kept = r["kept"].gather(1, by_expert)
    w = r["topv"].gather(1, by_expert).to(xt.dtype) * kept.to(xt.dtype)
    local = torch.where((e_sorted >= 0) & (e_sorted < E_loc), e_sorted, 0)
    rows = ye.reshape(E_loc * C, D)[(local * C + torch.clamp(rank, 0, C - 1))
                                    .reshape(-1)].reshape(T, -1, D)
    contrib = rows * w[..., None]
    yt = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        yt = yt + contrib[:, j]
    return yt.reshape(B, S, D)


def _moe_aux(r: dict, E: int):
    """The Switch-style load-balance loss of routing ``r``: E times the
    dot of each expert's share of the k choices and its mean gate."""
    T = r["gates"].shape[0]
    density = _expert_counts(r["topi"].reshape(-1), E).float() / T
    router_prob = r["gates"].mean(0)
    return (E * torch.sum(density * router_prob)).float()


def _moe_local(p: Params, cfg, x):
    """The sort-based top-k dispatch with capacity C on one device
    (``_moe_routed`` over all E experts), the shared experts added, and
    the load-balance aux loss."""
    B, S, D = x.shape
    r = moe_route(p, cfg, x.reshape(B * S, D))
    y = _moe_routed(p, x, r, 0)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    return y, _moe_aux(r, cfg.moe_n_experts)


def _moe_expert_parallel(p: Params, cfg, x, *, shard: int, n_shards: int):
    """One expert shard's work, the port of the reference's
    ``_moe_expert_parallel`` run on shard ``shard`` of ``n_shards``: the
    sort-based dispatch over the local tokens x [B,S,D] to the local
    experts only (``p``'s stacks hold experts ``shard * E / n_shards`` on),
    capacity from the local tokens. Returns (y, aux): y this shard's
    experts' part of the routed output, which the caller sums over the
    shards (the reference's psum, ``_moe_sharded``'s all-reduce) and then
    adds the shared experts to, as the reference does after its psum; aux
    the local tokens' load-balance loss."""
    B, S, D = x.shape
    E = cfg.moe_n_experts
    r = moe_route_shard(p, cfg, x.reshape(B * S, D), shard, n_shards)
    return _moe_routed(p, x, r, shard * (E // n_shards)), _moe_aux(r, E)


_EXPERT_KEYS = ("wi", "wg", "wo", "wi_scale", "wg_scale", "wo_scale")


def _moe_sharded(p: Params, cfg, x, mesh):
    """The expert-parallel MoE on ``mesh``: x [B,S,D] with its batch over
    the batch axes (``pod``, ``data``) where it divides them, each
    ``model`` rank holding E / T of the expert stacks, ``_moe_expert_parallel``
    on every rank's local shard (``local_map``); the partial outputs summed
    over ``model`` by an all-reduce (the reference's psum), then the
    shared experts, replicated as the reference's ``shard_map`` takes them,
    added on each rank's tokens; the aux loss the mean over the batch
    shards. A plain x (and plain params) is placed first, and the result
    returned plain.

    Placements carry the gradient: every output is a sum over ranks
    (``Partial`` over ``model``; the aux also over the batch axes when
    they split the batch, each rank's value a piece of the mean), so the
    local gradients of the replicated router and x are pieces of theirs
    too (``Partial``), and the all-reduce's transpose hands each rank the
    whole output gradient. Where the batch is not split, every output and
    gradient is the same on each of those ranks (``Replicate``)."""
    names = mesh.mesh_dim_names
    E = cfg.moe_n_experts
    T = mesh.size(names.index("model"))
    if E % T:
        raise ValueError(f"{E} experts do not split over a model axis of "
                         f"{T}")
    plain = not _local.is_placed(x)
    batch = _local.batch_split(mesh, x.shape[0])
    n_b = math.prod(mesh.size(names.index(a)) for a in _local.BATCH_AXES
                    if a in names) if batch else 1
    partial, rep = Partial(), Replicate()

    def on(batch_pl, model_pl):
        return _local.per_axis(mesh, batch, batch_pl, model_pl)

    x_pl = on(Shard(0), rep)
    expert_pl = on(rep, Shard(0))
    keys = [("router", k) for k in p["router"]] + \
        [(k,) for k in _EXPERT_KEYS if k in p]
    leaves = [p[k[0]][k[1]] if len(k) == 2 else p[k[0]] for k in keys]
    pls = [on(rep, rep) if k[0] == "router" else expert_pl
           for k in keys]
    grad_pls = [on(partial, partial) if k[0] == "router"
                else on(partial, Shard(0)) for k in keys]
    # The aux loss's mean over the batch shards and its copies on the
    # model ranks, as one sum over ranks.
    aux_share = n_b * T

    def shard_fn(x_loc, *local):
        p_loc: Params = {"router": {}}
        for k, t in zip(keys, local):
            if len(k) == 2:
                p_loc["router"][k[1]] = t
            else:
                p_loc[k[0]] = t
        y, aux = _moe_expert_parallel(p_loc, cfg, x_loc,
                                      shard=mesh.get_local_rank("model"),
                                      n_shards=T)
        return y, aux / aux_share

    y, aux = _local.run_local(
        shard_fn, [x, *leaves], [x_pl, *pls],
        (on(Shard(0), partial), on(partial, partial)),
        mesh, in_grad_placements=[on(Shard(0), partial), *grad_pls])
    y = y.redistribute(mesh, x_pl)             # the psum over model
    aux = aux.redistribute(mesh, (rep,) * len(names))
    if "shared" in p:
        shared = {name: {k: _local.as_placed(t, mesh, (rep,) * len(names))
                         for k, t in lp.items()}
                  for name, lp in p["shared"].items()}
        y = y + mlp_apply(shared, _local.as_placed(x, mesh, x_pl), "swiglu")
    if plain:
        return y.full_tensor(), aux.full_tensor()
    return y, aux


def _moe_replicated(p: Params, cfg, x, mesh):
    """``_moe_local`` on every rank of ``mesh`` over the whole batch and
    every expert (inputs gathered to ``Replicate``): a placed x outside an
    expert-parallel mesh (one rank, or no ``model`` axis), where the
    reference's compiler would partition the same global function."""
    keys, leaves = [], []

    def flat(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                flat(v, path + (k,))
        else:
            keys.append(path)
            leaves.append(node)

    flat(p, ())
    rep = (Replicate(),) * mesh.ndim

    def local_fn(x_loc, *local):
        p_loc: Params = {}
        for path, t in zip(keys, local):
            node = p_loc
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return _moe_local(p_loc, cfg, x_loc)

    return _local.run_local(local_fn, [x, *leaves], [rep] * (1 + len(keys)),
                            (rep, rep), mesh)
