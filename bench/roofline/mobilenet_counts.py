"""Operations and bytes of each layer of a MobileNetV2 configuration, from
its shapes alone: ``bench/roofline/resnet_counts.py``'s rules, over the
inverted residual graph. A 3x3 depthwise conv (one input channel per
output channel) does ``2 x Ho x Wo x 9 x C`` operations a frame and moves,
once a batch, its int8 input and output and its 9 C int8 weights with its
int32 bias and shift; a projection that adds a skip moves the skip too.
A layer's least time is the larger of operations over the peak rate and
bytes over the peak bandwidth: every depthwise layer is bound by its
bytes."""

from __future__ import annotations

from bench.roofline.resnet_counts import layer_counts


def ops_per_frame(cfg: dict) -> int:
    return sum(r["ops"] for r in layer_counts(cfg, 1))


def least_seconds(cfg: dict, batch: int, peak_ops: float,
                  peak_bytes: float) -> float:
    """The least time one batch of the whole graph could take: the sum
    over layers of each layer's bound."""
    return sum(max(r["ops"] / peak_ops, r["bytes"] / peak_bytes)
               for r in layer_counts(cfg, batch))
