"""Model assembly for the dense and hybrid decoder families, the port of
the part of ``repro/models/transformer.py`` that they run: layer kinds,
segments, parameter and cache init, the forward and the parameter count.

The reference stacks each segment's layers on a leading axis and scans
them; the port keeps one parameter dict per layer in a list per segment
(``params["seg0"][i]``) and loops. ``params_from_numpy`` carries the
reference's stacked tree across.

Layer kinds: ``attn`` (GQA with a linear cache), ``attn_local`` (windowed
GQA with a ring cache) and ``rglru`` (the RG-LRU recurrent block, whose
cache is its state). Families other than ``dense`` and ``hybrid`` (MoE,
MLA, encoder-decoder, RWKV, the VLM's M-RoPE frontend) load as configs but
are refused here with ``NotImplementedError``: they come with later
slices (ROADMAP A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

Params = dict[str, Any]

PORTED_KINDS = ("attn", "attn_local", "rglru")
PORTED_FAMILIES = ("dense", "hybrid")


def _device(device) -> torch.device:
    """``None`` means the card; without one, raise rather than run on the
    CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_ported(cfg: ModelConfig) -> None:
    """Refuse a configuration this slice does not run, naming the slice
    that brings it."""
    unported = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if cfg.family not in PORTED_FAMILIES or unported or cfg.mrope \
            or cfg.frontend_stub or cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (layer kinds "
            f"{sorted(set(cfg.layer_kinds()))}) is not ported yet; the "
            f"dense and hybrid decoder families run. MoE/MLA, enc-dec, VLM "
            f"and RWKV come with later slices (ROADMAP A)")


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    start: int
    count: int


def segments(cfg: ModelConfig) -> list[Segment]:
    kinds = cfg.layer_kinds()
    segs: list[Segment] = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append(Segment(kinds[i], i, j - i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Per-layer init / cache / apply
# ---------------------------------------------------------------------------


def _layer_init(kind: str, cfg: ModelConfig, gen, dtype, device) -> Params:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    d = cfg.d_model
    p: Params = {"ln1": L.rms_norm_init(d, dtype, device),
                 "ln2": L.rms_norm_init(d, dtype, device)}
    if kind == "rglru":
        p["rec"] = R.rglru_block_init(gen, cfg, dtype, device)
    else:
        p["attn"] = L.gqa_init(gen, cfg, dtype, device)
    p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device)
    return p


def _layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 dtype, device) -> Params:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    if kind == "attn":
        size = max_len
    elif kind == "attn_local":
        size = min(cfg.window or max_len, max_len)
    elif kind == "rglru":
        return R.rglru_state_init(cfg, batch, dtype, device)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    c = {"k": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
         "v": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
         "idx": 0}
    if kind == "attn_local":
        c["slot_pos"] = torch.full((size,), -(10 ** 9), dtype=torch.int32,
                                   device=device)
    return c


def _layer_apply(kind: str, p: Params, cfg: ModelConfig, x, positions,
                 cache: Params | None):
    """Pre-norm residual block. Returns (x, new_cache)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    if kind == "rglru":
        h, st = R.rglru_block_apply(p["rec"], cfg, L.rms_norm(p["ln1"], x),
                                    state=cache)
        new_cache = st if cache is not None else None
    else:
        h, new_cache = L.gqa_apply(
            p["attn"], cfg, L.rms_norm(p["ln1"], x), positions, cache=cache,
            window=cfg.window if kind == "attn_local" else 0)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.rms_norm(p["ln2"], x), cfg.mlp_kind)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# Model init / cache init / forward
# ---------------------------------------------------------------------------


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: torch.dtype | None = None) -> Params:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference draws with ``jax.random``, which torch
    cannot reproduce: a recorded divergence; parity tests carry the
    reference's weights across with ``params_from_numpy``). On the
    ``meta`` device only the shapes are built."""
    check_ported(cfg)
    device = _device(device)
    dtype = _dtype(cfg, dtype)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    p: Params = {
        "embed": L._normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype,
                           device),
        "final_norm": L.rms_norm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense(gen, cfg.d_model, cfg.vocab, dtype, device)
    for si, seg in enumerate(segments(cfg)):
        p[f"seg{si}"] = [_layer_init(seg.kind, cfg, gen, dtype, device)
                         for _ in range(seg.count)]
    return p


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Params, device=None) -> Params:
    """The reference's parameter tree (numpy leaves, each segment's layers
    stacked on a leading axis) as the port's: the same leaves as tensors
    on ``device``, each segment a list of per-layer dicts."""
    device = _device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor_from_numpy(node, device)

    def unstack(node, i):
        if isinstance(node, dict):
            return {k: unstack(v, i) for k, v in node.items()}
        return node[i]

    out: Params = {}
    for key, node in tree.items():
        if key.startswith("seg"):
            count = len(next(iter(_leaves(node))))
            out[key] = [convert(unstack(node, i)) for i in range(count)]
        else:
            out[key] = convert(node)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Params:
    check_ported(cfg)
    device = _device(device)
    dtype = _dtype(cfg, dtype)
    c: Params = {"_pos": 0}
    for si, seg in enumerate(segments(cfg)):
        c[f"seg{si}"] = [_layer_cache(seg.kind, cfg, batch, max_len, dtype,
                                      device) for _ in range(seg.count)]
    return c


def _positions(B: int, S: int, offset: int, device) -> torch.Tensor:
    pos = offset + torch.arange(S, device=device)[None, :]
    return pos.expand(B, S)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, batch: dict,
            cache: Params | None = None):
    """Returns (logits [B,S,V], new_cache, aux_loss).

    batch: {"tokens" [B,S]}. With a cache, the attention layers' keys and
    values (and a ring's slot positions) are written into the cache's
    tensors in place, and the returned cache shares them with the one
    passed in; an RG-LRU layer's state comes back as new tensors.
    """
    check_ported(cfg)
    if "tokens" not in batch:
        raise NotImplementedError("embedding inputs come with the VLM and "
                                  "enc-dec slices (ROADMAP A)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens]
    offset = 0 if cache is None else int(cache["_pos"])
    positions = _positions(B, S, offset, x.device)

    new_cache: Params = {}
    for si, seg in enumerate(segments(cfg)):
        layer_caches = cache[f"seg{si}"] if cache is not None else None
        ncs = []
        for i, lp in enumerate(params[f"seg{si}"]):
            lc = layer_caches[i] if layer_caches is not None else None
            x, nc = _layer_apply(seg.kind, lp, cfg, x, positions, lc)
            ncs.append(nc)
        if cache is not None:
            new_cache[f"seg{si}"] = ncs
    if cache is not None:
        new_cache["_pos"] = offset + S
    x = L.rms_norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = L.apply_dense(params["lm_head"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, (new_cache if cache is not None else None), aux


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg`` at full size, counted from shapes built on the
    ``meta`` device (nothing is allocated)."""
    params = init_params(cfg, device="meta")
    return sum(math.prod(t.shape) for t in _leaves(params))


def _leaves(node):
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node
