"""AdamW with a configurable moment dtype (float32 / bfloat16 / int8
blockwise), global-norm clipping, a warmup-stable-decay schedule, and int8
gradient compression with error feedback: the port of
``repro/optim/adamw.py``.

Trees are the port's parameter trees: dicts and lists of tensors. The
int8 moments are blockwise (128) absmax-scaled codes, each a dict
``{"q", "scale", "shape"}`` in place of the tensor, with the reference's
"dynamic" (mu-law) code; the gradient compression uses its "linear" code.

``adamw_update`` writes the new parameters and moments into the tensors it
was given (the counterpart of donated buffers under ``jax.jit``) and
returns them: a full-width model's state then needs no second copy. The
step counter, the learning rate and the bias corrections are float32
tensors, as in the reference; every leaf is updated in float32 and cast
back to its parameter's dtype.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

_BLOCK = 128
_DYN_K = 65535.0      # companding constant: ~4.8 decades of dynamic range


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any          # first moment (an int8 code dict per leaf at int8)
    nu: Any          # second moment
    err: Any | None  # error-feedback residual for grad compression (or None)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists of tensors) and
    the nodes at the same places in ``rest``, which may hold whole
    subtrees (an int8 code) where ``tree`` holds a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# Blockwise int8 moment quantization
# ---------------------------------------------------------------------------


def _q8_encode(x: torch.Tensor, code: str = "linear") -> dict:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    amax = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    if code == "dynamic":
        # mu-law companding (bnb-style dynamic quantization): linear int8
        # zeroes small second moments and Adam explodes; log-spaced codes
        # keep ~9% relative error across the whole block range.
        u = torch.log1p(blocks.abs() / amax * _DYN_K) / math.log1p(_DYN_K)
        q = torch.clamp(torch.round(u * 127.0), 0, 127) * torch.sign(blocks)
        scale = amax
    else:
        q = torch.clamp(torch.round(blocks / (amax / 127.0)), -127, 127)
        scale = amax / 127.0
    marker = 1 if code == "linear" else 2
    return {"q": q.to(torch.int8), "scale": scale.float(),
            "shape": torch.tensor(tuple(x.shape) + (marker,),
                                  dtype=torch.int32, device=x.device)}


def _q8_decode(enc: dict, shape, code: str = "linear") -> torch.Tensor:
    q = enc["q"].float()
    if code == "dynamic":
        mag = torch.expm1(q.abs() / 127.0 * math.log1p(_DYN_K)) / _DYN_K \
            * enc["scale"]
        flat = (mag * torch.sign(q)).reshape(-1)
    else:
        flat = (q * enc["scale"]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _moment_like(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8_encode(torch.zeros_like(p, dtype=torch.float32),
                          code="dynamic")
    return torch.zeros_like(p, dtype=getattr(torch, dtype))


def adamw_init(params, moment_dtype: str = "float32",
               error_feedback: bool = False) -> AdamWState:
    """Zero moments beside every leaf, on the leaf's device."""
    with torch.no_grad():
        mu = tree_map(lambda p: _moment_like(p, moment_dtype), params)
        nu = tree_map(lambda p: _moment_like(p, moment_dtype), params)
        err = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params) if error_feedback else None)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          mu, nu, err)


def _read_moment(m, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(m, shape, code="dynamic")
    return m.float()


def _write_moment(dst, x: torch.Tensor, dtype: str) -> None:
    if dtype == "int8":
        enc = _q8_encode(x, code="dynamic")
        dst["q"].copy_(enc["q"])
        dst["scale"].copy_(enc["scale"])
    else:
        dst.copy_(x)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, moment_dtype: str = "float32"):
    """One AdamW step, leaf by leaf in float32, written in place into
    ``params`` and ``state``'s moments. Returns (params, new state)."""
    step = state.step + 1
    f32 = dict(dtype=torch.float32, device=step.device)
    lr_t = lr(step) if callable(lr) else torch.tensor(lr, **f32)
    stepf = step.float()
    bc1 = 1 - torch.tensor(b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(b2, **f32) ** stepf

    def upd(p, g, mu, nu):
        g32 = g.float()
        p32 = p.float()
        m = _read_moment(mu, p.shape, moment_dtype)
        v = _read_moment(nu, p.shape, moment_dtype)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        upd_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_(p32 - lr_t * (upd_ + weight_decay * p32))
        _write_moment(mu, m, moment_dtype)
        _write_moment(nu, v, moment_dtype)

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step, state.mu, state.nu, state.err)


# ---------------------------------------------------------------------------
# Gradient clipping / schedule / compression
# ---------------------------------------------------------------------------


@torch.no_grad()
def _norm_and_scale(leaves, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """(grads scaled to a global L2 norm of at most ``max_norm``, in their
    own dtypes; the norm before scaling, a float32 tensor)."""
    gn, scale = _norm_and_scale(tree_leaves(grads), max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """``clip_by_global_norm`` written into ``grads`` in place (the same
    values), so that no second gradient tree is allocated; returns the
    norm before scaling."""
    leaves = tree_leaves(grads)
    gn, scale = _norm_and_scale(leaves, max_norm)
    for g in leaves:
        g.copy_((g.float() * scale).to(g.dtype))
    return gn


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1):
    """Warmup-stable-decay (linear warmup, constant, cosine tail), in
    float32 on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        decay_start = total * (1 - decay_frac)
        t = torch.clamp((s - decay_start) / max(total - decay_start, 1),
                        0, 1)
        return peak_lr * w * (0.5 * (1 + torch.cos(math.pi * t))
                              if decay_frac > 0 else 1.0)
    return lr


@torch.no_grad()
def compress_grads(grads, err):
    """int8 blockwise compression with error feedback: returns
    (compressed tree, new_err). Decompress with ``decompress_grads`` after
    the all-reduce."""
    def one(g, e):
        g32 = g.float() + e
        enc = _q8_encode(g32)
        return enc, g32 - _q8_decode(enc, g.shape)
    pairs = tree_map(one, grads, err)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i):
    """The ``i``-th element of every (code, residual) pair of ``tree``."""
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]


@torch.no_grad()
def decompress_grads(comp, shapes):
    """The float32 gradients of ``comp``, shaped as the leaves of
    ``shapes``."""
    return tree_map(lambda ref, enc: _q8_decode(enc, ref.shape), shapes,
                    comp)
