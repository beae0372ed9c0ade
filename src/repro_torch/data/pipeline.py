"""Synthetic sharded data pipeline, the port of ``repro/data/pipeline.py``.

Deterministic, seekable token/image streams: every (step, host) pair
regenerates its shard independently, which is what checkpoint/restart and
elastic rescaling need (resume = seek(step); rescale = re-partition host
ids). The numpy draws are the reference's (``SeedSequence([seed, step,
host_id])``), so both packages make the same tokens for the same config,
bit for bit; the batches are tensors on the stream's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _device


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    # 0 -> uniform token ids; >0 -> Zipf(alpha)-distributed ids (realistic
    # frequency skew; gives training curves a learnable unigram signal).
    zipf_alpha: float = 0.0


class TokenStream:
    """Infinite synthetic LM batches, sharded by host, on ``device``
    (``None``: the card, raising without one)."""

    def __init__(self, dc: DataConfig, device=None):
        assert dc.global_batch % dc.n_hosts == 0
        self.dc = dc
        self.device = _device(device)
        self.local_batch = dc.global_batch // dc.n_hosts
        self._step = 0

    def seek(self, step: int) -> None:
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype)

    def _batch_for(self, step: int) -> dict:
        dc = self.dc
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, step, dc.host_id]))
        shape = (self.local_batch, dc.seq_len + 1)
        if dc.zipf_alpha > 0:
            ranks = np.arange(1, dc.vocab + 1, dtype=np.float64)
            p = ranks ** -dc.zipf_alpha
            p /= p.sum()
            toks = rng.choice(dc.vocab, size=shape, p=p).astype(np.int32)
        else:
            toks = rng.integers(0, dc.vocab, size=shape, dtype=np.int32)
        return {"tokens": self._tensor(toks[:, :-1]),
                "labels": self._tensor(toks[:, 1:])}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._batch_for(self._step)
        self._step += 1
        return b


class EmbedStream(TokenStream):
    """Precomputed-embedding batches for frontend-stub archs (vlm/enc-dec),
    bfloat16 rounded from the same float32 draws as the reference's."""

    def __init__(self, dc: DataConfig, cfg: ModelConfig,
                 enc_len: int | None = None, device=None):
        super().__init__(dc, device)
        self.cfg = cfg
        self.enc_len = enc_len

    def _batch_for(self, step: int) -> dict:
        base = super()._batch_for(step)
        dc, cfg = self.dc, self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, step, dc.host_id, 7]))
        if cfg.family == "enc_dec":
            enc = rng.standard_normal(
                (self.local_batch, self.enc_len or dc.seq_len, cfg.d_model),
                dtype=np.float32)
            base["enc_embeds"] = self._tensor(enc, torch.bfloat16)
        else:  # vlm: patch embeddings + 3D M-RoPE positions
            emb = rng.standard_normal(
                (self.local_batch, dc.seq_len, cfg.d_model), dtype=np.float32)
            base["embeds"] = self._tensor(emb, torch.bfloat16)
            pos = np.broadcast_to(
                np.arange(dc.seq_len, dtype=np.int32)[None, :, None],
                (self.local_batch, dc.seq_len, 3))
            base["positions"] = self._tensor(pos)
            del base["tokens"]
        return base


def make_stream(cfg: ModelConfig, dc: DataConfig, device=None):
    """The stream for ``cfg``'s inputs on ``device`` (``None``: the card,
    raising without one)."""
    if cfg.frontend_stub:
        return EmbedStream(dc, cfg, device=device)
    return TokenStream(dc, device)
