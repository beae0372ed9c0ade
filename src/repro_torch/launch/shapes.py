"""The assigned input-shape set, as empty tensors on the ``meta`` device:
the port of ``repro/launch/shapes.py``.

Four shapes per LM architecture (40 cells):
  train_4k     seq 4096  x global_batch 256   (training, train_step)
  prefill_32k  seq 32768 x global_batch 32    (inference prefill)
  decode_32k   one token against a 32768 KV cache, global_batch 128
  long_500k    one token against a 524288-token context, global_batch 1
               (sub-quadratic archs only: recurrentgemma-2b, rwkv6-7b)

``input_specs`` and ``cache_specs`` return tensors with shapes and dtypes
and no storage (``device="meta"``), the counterpart of the reference's
``ShapeDtypeStruct`` stand-ins, which ``launch/dryrun.py`` traces against.
Embeddings are bf16 and ids int32 whatever the config's dtype, as in the
reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k runs only for sub-quadratic archs (see DESIGN.md)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524288-ctx decode skipped"
    return True, ""


def input_specs(cfg: ModelConfig, case: ShapeCase, device="meta") -> dict:
    """Model inputs for the given shape case, as empty tensors on
    ``device``."""
    B, S = case.global_batch, case.seq_len

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    bf16, i32 = torch.bfloat16, torch.int32
    if case.mode == "train":
        if cfg.family == "enc_dec":
            return {"enc_embeds": t((B, S, cfg.d_model), bf16),
                    "tokens": t((B, S), i32), "labels": t((B, S), i32)}
        if cfg.frontend_stub:  # vlm: precomputed patch embeddings + M-RoPE
            return {"embeds": t((B, S, cfg.d_model), bf16),
                    "positions": t((B, S, 3), i32),
                    "labels": t((B, S), i32)}
        return {"tokens": t((B, S), i32), "labels": t((B, S), i32)}
    if case.mode == "prefill":
        if cfg.family == "enc_dec":
            return {"enc_embeds": t((B, S, cfg.d_model), bf16),
                    "tokens": t((B, S), i32)}
        if cfg.frontend_stub:
            return {"embeds": t((B, S, cfg.d_model), bf16),
                    "positions": t((B, S, 3), i32)}
        return {"tokens": t((B, S), i32)}
    # decode: one new token against a cache of case.seq_len
    if cfg.frontend_stub and cfg.family != "enc_dec":
        return {"embeds": t((B, 1, cfg.d_model), bf16),
                "positions": t((B, 1, 3), i32)}
    return {"tokens": t((B, 1), i32)}


def cache_specs(cfg: ModelConfig, case: ShapeCase, device="meta") -> dict:
    """The KV / state cache for the case's batch and length, on
    ``device``: ``init_cache`` (per-layer lists, ``idx`` and ``_pos``
    host ints, as the port's cache keeps them)."""
    return T.init_cache(cfg, case.global_batch, case.seq_len, device=device)
