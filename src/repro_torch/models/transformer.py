"""Model assembly, the port of ``repro/models/transformer.py``: layer kinds,
segments, parameter and cache init, the encoder, the forward and the
parameter count, for every family of the configs (dense, hybrid, MoE with
MLA, encoder-decoder, the VLM backbone, RWKV).

The reference stacks each segment's layers (and the encoder's) on a
leading axis and scans them; the port keeps one parameter dict per layer
in a list per segment (``params["seg0"][i]``, ``params["encoder"][i]``)
and loops. ``params_from_numpy`` carries the reference's stacked tree
across.

Layer kinds: ``attn`` (GQA with a linear cache), ``attn_local`` (windowed
GQA with a ring cache), ``rglru`` (the RG-LRU block, whose cache is its
state), ``mla`` (DeepSeek's MLA over a latent cache), ``moe`` and
``mla_moe`` (GQA or MLA with the routed MoE in place of the MLP) and
``rwkv`` (RWKV6 time-mix and channel-mix, whose cache is the two token
shifts and the WKV state). An encoder-decoder model's attention layers
also cross-attend to the encoder's output.

``loss_fn`` is the training loss (float32 log-softmax, the masked mean
over ``labels >= 0``, plus 0.01 times the MoE aux loss); ``forward`` is
differentiable, and with ``remat=True`` each layer of a segment of 3 or
more layers is recomputed in the backward
(``torch.utils.checkpoint``), where the reference's ``jax.checkpoint``
wraps its scanned segments' body.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

Params = dict[str, Any]

ATTN_KINDS = ("attn", "attn_local", "mla", "moe", "mla_moe")


def _device(device) -> torch.device:
    """``None`` means the card; without one, raise rather than run on the
    CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    start: int
    count: int

    @property
    def scanned(self) -> bool:
        """Whether the reference scans this segment's layers (and so
        rematerialises them under ``remat``)."""
        return self.count >= 3


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
    d = cfg.d_model
    p: Params = {"ln1": L.rms_norm_init(d, dtype, device),
                 "ln2": L.rms_norm_init(d, dtype, device)}
    if kind in ("attn", "attn_local", "moe"):
        p["attn"] = L.gqa_init(gen, cfg, dtype, device)
    elif kind in ("mla", "mla_moe"):
        p["attn"] = L.mla_init(gen, cfg, dtype, device)
    elif kind == "rglru":
        p["rec"] = R.rglru_block_init(gen, cfg, dtype, device)
    elif kind == "rwkv":
        p["rwkv"] = R.rwkv6_block_init(gen, cfg, dtype, device)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind.endswith("moe"):
        p["mlp"] = L.moe_init(gen, cfg, dtype, device)
    elif kind != "rwkv":
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device)
    return p


def _layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 dtype, device) -> Params:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    if kind == "rglru":
        return R.rglru_state_init(cfg, batch, dtype, device)
    if kind == "rwkv":
        return R.rwkv6_state_init(cfg, batch, dtype, device)
    if kind in ("mla", "mla_moe"):
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                     dtype=dtype, device=device),
                "idx": 0}
    if kind in ("attn", "moe"):
        size = max_len
    elif kind == "attn_local":
        size = min(cfg.window or max_len, max_len)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    c = {"k": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
         "v": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
         "idx": 0}
    if kind == "attn_local":
        c["slot_pos"] = torch.full((size,), -(10 ** 9), dtype=torch.int32,
                                   device=device)
    return c


def _layer_apply(kind: str, p: Params, cfg: ModelConfig, x, positions,
                 cache: Params | None):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        h, tm_state = R.rwkv6_block_apply(
            p["rwkv"], cfg, L.rms_norm(p["ln1"], x),
            state=None if cache is None else
            {"shift_tm": cache["shift_tm"], "wkv": cache["wkv"]})
        x = x + h
        cm_prev = (cache["shift_cm"] if cache is not None
                   else torch.zeros_like(x[:, 0]))
        h2, cm_new = R.rwkv6_channel_mix(p["rwkv"], L.rms_norm(p["ln2"], x),
                                         cm_prev)
        new_cache = None if cache is None else {
            "shift_tm": tm_state["shift_tm"], "shift_cm": cm_new,
            "wkv": tm_state["wkv"]}
        return x + h2, new_cache, aux
    if kind == "rglru":
        h, st = R.rglru_block_apply(p["rec"], cfg, L.rms_norm(p["ln1"], x),
                                    state=cache)
        new_cache = st if cache is not None else None
    elif kind in ("mla", "mla_moe"):
        h, new_cache = L.mla_apply(p["attn"], cfg, L.rms_norm(p["ln1"], x),
                                   positions, cache=cache)
    else:
        h, new_cache = L.gqa_apply(
            p["attn"], cfg, L.rms_norm(p["ln1"], x), positions, cache=cache,
            window=cfg.window if kind == "attn_local" else 0)
    x = x + h
    if kind.endswith("moe"):
        h, aux = L.moe_apply(p["mlp"], cfg, L.rms_norm(p["ln2"], x))
    else:
        h = L.mlp_apply(p["mlp"], L.rms_norm(p["ln2"], x), cfg.mlp_kind)
    return x + h, new_cache, aux


# ---------------------------------------------------------------------------
# Encoder layers (the Seamless backbone): bidirectional attention, and
# cross-attention in the decoder's attention layers
# ---------------------------------------------------------------------------


def _enc_layer_init(cfg: ModelConfig, gen, dtype, device) -> Params:
    return {"ln1": L.rms_norm_init(cfg.d_model, dtype, device),
            "ln2": L.rms_norm_init(cfg.d_model, dtype, device),
            "attn": L.gqa_init(gen, cfg, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                              dtype, device)}


def _dec_xattn_init(cfg: ModelConfig, gen, dtype, device) -> Params:
    return {"ln3": L.rms_norm_init(cfg.d_model, dtype, device),
            "xattn": L.gqa_init(gen, cfg, dtype, device)}


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
        layers = []
        for _ in range(seg.count):
            lp = _layer_init(seg.kind, cfg, gen, dtype, device)
            if cfg.n_enc_layers and seg.kind in ATTN_KINDS:
                lp.update(_dec_xattn_init(cfg, gen, dtype, device))
            layers.append(lp)
        p[f"seg{si}"] = layers
    if cfg.n_enc_layers:
        p["encoder"] = [_enc_layer_init(cfg, gen, dtype, device)
                        for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = L.rms_norm_init(cfg.d_model, dtype, device)
    return p


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Params, device=None) -> Params:
    """The reference's parameter tree (numpy leaves, each segment's layers
    and the encoder's stacked on a leading axis) as the port's: the same
    leaves as tensors on ``device``, each segment and the encoder a list
    of per-layer dicts."""
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
        if key.startswith("seg") or key == "encoder":
            count = len(next(iter(_leaves(node))))
            out[key] = [convert(unstack(node, i)) for i in range(count)]
        else:
            out[key] = convert(node)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Params:
    device = _device(device)
    dtype = _dtype(cfg, dtype)
    c: Params = {"_pos": 0}
    for si, seg in enumerate(segments(cfg)):
        c[f"seg{si}"] = [_layer_cache(seg.kind, cfg, batch, max_len, dtype,
                                      device) for _ in range(seg.count)]
    return c


def _positions(cfg: ModelConfig, B: int, S: int, offset: int,
               device) -> torch.Tensor:
    pos = (offset + torch.arange(S, device=device))[None, :].expand(B, S)
    if cfg.mrope:
        # Text tokens: all three M-RoPE components equal the text position.
        return pos[..., None].expand(B, S, 3)
    return pos


def encode(params: Params, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings [B,S,D]; its
    attention rotates q and k from position 0."""
    B, S, _ = enc_embeds.shape
    x = enc_embeds
    positions = _positions(cfg, B, S, 0, x.device)
    for lp in params["encoder"]:
        h, _ = L.gqa_apply(lp["attn"], cfg, L.rms_norm(lp["ln1"], x),
                           positions, causal=False)
        x = x + h
        x = x + L.mlp_apply(lp["mlp"], L.rms_norm(lp["ln2"], x),
                            cfg.mlp_kind)
    return L.rms_norm(params["enc_norm"], x)


def _cross_attend(lp: Params, cfg: ModelConfig, x, positions, enc_out):
    """A decoder layer's cross-attention to the encoder output: its keys
    and values projected from ``enc_out``, nothing rotated, no mask."""
    Bx, Sx, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = L.apply_dense(lp["xattn"]["wk"], enc_out).reshape(Bx, Sx, KV, hd)
    v = L.apply_dense(lp["xattn"]["wv"], enc_out).reshape(Bx, Sx, KV, hd)
    h, _ = L.gqa_apply(lp["xattn"], cfg, L.rms_norm(lp["ln3"], x), positions,
                       cross_kv=(k, v))
    return x + h


def forward(params: Params, cfg: ModelConfig, batch: dict,
            cache: Params | None = None, remat: bool = False):
    """Returns (logits [B,S,V], new_cache, aux_loss).

    batch: {"tokens" [B,S]} or {"embeds" [B,S,D]} (the VLM's patch
    embeddings), optionally with "positions" ([B,S], or [B,S,3] for
    M-RoPE) and, for an encoder-decoder model, "enc_embeds" [B,Se,D]:
    without them its decoder cross-attends to nothing, as in the
    reference. aux_loss is the MoE layers' load-balance loss, summed.

    With a cache, the attention layers' keys and values (a ring's slot
    positions, MLA's latent) are written into the cache's tensors in
    place, and the returned cache shares them with the one passed in; a
    recurrent layer's state comes back as new tensors.

    Differentiable: autograd records it when a parameter requires grad
    (the serve steps call it under ``torch.inference_mode``). With
    ``remat`` and no cache, each layer of a segment the reference scans
    (``Segment.scanned``) keeps only its input for the backward and is
    recomputed there.
    """
    if "tokens" in batch:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = params["embed"][tokens]
    else:
        x = batch["embeds"]
        B, S, _ = x.shape
    offset = 0 if cache is None else int(cache["_pos"])
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(cfg, B, S, offset, x.device)

    enc_out = None
    if cfg.n_enc_layers and "enc_embeds" in batch:
        enc_out = encode(params, cfg, batch["enc_embeds"])

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Params = {}
    for si, seg in enumerate(segments(cfg)):
        layer_caches = cache[f"seg{si}"] if cache is not None else None

        def one_layer(x, lp, lc, kind=seg.kind):
            x, nc, aux = _layer_apply(kind, lp, cfg, x, positions, lc)
            if enc_out is not None and kind in ATTN_KINDS:
                x = _cross_attend(lp, cfg, x, positions, enc_out)
            return x, nc, aux

        rematted = remat and cache is None and seg.scanned
        ncs = []
        for i, lp in enumerate(params[f"seg{si}"]):
            lc = layer_caches[i] if layer_caches is not None else None
            if rematted:
                x, nc, aux = checkpoint(one_layer, x, lp, lc,
                                        use_reentrant=False)
            else:
                x, nc, aux = one_layer(x, lp, lc)
            aux_total = aux_total + aux
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
    return logits, (new_cache if cache is not None else None), aux_total


def loss_fn(params: Params, cfg: ModelConfig, batch: dict,
            remat: bool = False):
    """(loss + 0.01 * aux, {"loss", "aux"}): the next-token cross-entropy
    in float32, averaged over the positions whose label is >= 0, and the
    MoE load-balance loss."""
    logits, _, aux = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def trainable(params: Params) -> Params:
    """Mark every floating leaf of ``params`` ``requires_grad_()``, in
    place; returns ``params``."""
    for t in _leaves(params):
        if t.is_floating_point():
            t.requires_grad_()
    return params


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
