"""Step functions for serving: prefill and greedy decode over the KV
cache, the port of ``make_prefill_step``/``make_serve_step`` in
``repro/launch/steps.py``. ``make_train_step`` comes with the training
slice (ROADMAP A). The reference jits these; here they are eager calls.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, cache, batch):
        logits, cache, _ = T.forward(params, cfg, batch, cache=cache)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: new token against the running cache (greedy)."""
    def serve_step(params, cache, batch):
        logits, cache, _ = T.forward(params, cfg, batch, cache=cache)
        next_tok = logits[:, -1].float().argmax(dim=-1)
        return next_tok, cache

    return serve_step
