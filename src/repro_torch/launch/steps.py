"""Step functions: ``train_step`` (loss, gradients, clipping, AdamW),
``prefill_step`` and ``serve_step`` (greedy decode over the KV cache), the
port of ``repro/launch/steps.py``, and ``value_and_grad``, the
counterpart of the reference's ``jax.value_and_grad`` of ``loss_fn``. The
reference jits these; here they are eager calls. The serve steps run
under ``torch.inference_mode`` (no graph, whatever the params' flags); the
train step is ``value_and_grad`` then ``apply_grads``. ``value_and_grad``
marks the params' floating leaves ``requires_grad`` for its own call and
puts their flags back before it returns, so a forward after a step builds
no graph and dispatches attention as a served forward does.

The reference's ``abstract_state`` (shapes without allocation, for its
XLA dry run) comes with the dry run (ROADMAP A2).
"""

from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def value_and_grad(params, cfg: ModelConfig, batch, *, remat=False):
    """``((loss + 0.01 aux, {"loss", "aux"}), grads)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them: the grads
    tree mirrors ``params`` and a leaf off the loss's path gets zeros. The
    params' floating leaves require grad during the call only; each
    leaf's flag is as it was when the call returns or raises."""
    leaves = optim.adamw.tree_leaves(params)
    was = [t.requires_grad for t in leaves]
    try:
        T.trainable(params)
        total, metrics = T.loss_fn(params, cfg, batch, remat=remat)
        flat = iter(torch.autograd.grad(total, leaves, allow_unused=True))
    finally:
        for t, flag in zip(leaves, was):
            t.requires_grad_(flag)

    def grad_of(p):
        g = next(flat)
        return torch.zeros_like(p) if g is None else g

    grads = optim.adamw.tree_map(grad_of, params)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def apply_grads(params, grads, opt_state, *, lr, clip_norm: float = 1.0,
                moment_dtype: str = "float32"):
    """``(params, opt_state, grad_norm)``: ``grads`` clipped in place to a
    global norm of ``clip_norm``, then one AdamW update written into
    ``params`` and ``opt_state``'s moments in place; ``grad_norm`` is the
    norm before clipping. Clipping in place keeps the caller's gradient
    tree the only one: at full width a second would stand beside AdamW's
    float32 temporaries at the step's peak."""
    gn = optim.clip_by_global_norm_(grads, clip_norm)
    params, opt_state = optim.adamw_update(
        params, grads, opt_state, lr=lr, moment_dtype=moment_dtype)
    return params, opt_state, gn


def make_train_step(cfg: ModelConfig, *, lr=3e-4, remat: bool = True,
                    clip_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics {"loss", "aux", "grad_norm"} (float32 0-d
    tensors): ``value_and_grad`` then ``apply_grads``."""
    moment_dtype = cfg.opt_moment_dtype

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(params, cfg, batch, remat=remat)
        params, opt_state, gn = apply_grads(
            params, grads, opt_state, lr=lr, clip_norm=clip_norm,
            moment_dtype=moment_dtype)
        return params, opt_state, dict(metrics, grad_norm=gn)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, cache, batch):
        logits, cache, _ = T.forward(params, cfg, batch, cache=cache)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: new token against the running cache (greedy)."""
    @torch.inference_mode()
    def serve_step(params, cache, batch):
        logits, cache, _ = T.forward(params, cfg, batch, cache=cache)
        next_tok = logits[:, -1].float().argmax(dim=-1)
        return next_tok, cache

    return serve_step
