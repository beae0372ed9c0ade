"""Analytic throughput model — paper Eqs. (2), (3), (4) and DSP efficiency.

The pipeline advances in row-groups: engine i needs ``T_row_i`` cycles
(Eq. 2) per K_i of its output rows. One output row of layer i corresponds to
``prod(G_j, j <= i)`` input rows, so normalizing every engine's time to
*input rows* gives Eq. (3)'s ``T_rowmax``, and a frame of H_0 input rows
takes ``H_0 * T_rowmax`` cycles (Eq. 4).
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.allocator import LayerAlloc


def cumulative_strides(allocs: Sequence[LayerAlloc]) -> list[int]:
    """prod(G_j, j <= i): how many input-image rows map to one output row of
    layer i. Pooling layers contribute their stride too (paper Eq. 3)."""
    out: list[int] = []
    g = 1
    for a in allocs:
        g *= max(1, a.layer.stride)
        out.append(g)
    return out


def t_rowmax(allocs: Sequence[LayerAlloc]) -> float:
    """Eq. (3): slowest engine's cycles per *input row* of the frame."""
    gs = cumulative_strides(allocs)
    worst = 0.0
    for a, g in zip(allocs, gs):
        if a.layer.macs == 0:
            continue
        if a.layer.kind == "fc":
            # FC layers run once per frame; amortize over all input rows.
            continue
        worst = max(worst, a.t_per_output_row / g)
    return worst


def frame_cycles(allocs: Sequence[LayerAlloc], h0: int | None = None) -> float:
    """Steady-state cycles per frame.

    Eq. (4) writes H_0 * T_rowmax with T_rowmax stride-normalized (Eq. 3);
    when valid-padding makes H_i < H_0/prod(G), the engine is only busy for
    its actual H_i output rows, so the exact steady-state bound is the
    slowest engine's *busy* cycles per frame, H_i * t_row/K. The two agree
    exactly for same-padded stride pyramids (e.g. VGG16).
    """
    del h0
    conv_cycles = max((a.layer.H * a.t_per_output_row for a in allocs
                       if a.layer.kind == "conv"), default=0.0)
    # Each FC engine is its own pipeline stage overlapping other frames; the
    # frame rate is bounded by the slowest single engine, not their sum.
    fc_cycles = max((a.t_row for a in allocs if a.layer.kind == "fc"),
                    default=0.0)
    return max(conv_cycles, fc_cycles)


def pipeline_fps(allocs: Sequence[LayerAlloc], *, freq_hz: float,
                 h0: int | None = None) -> float:
    """Eq. (4): throughput in frames/sec."""
    return freq_hz / frame_cycles(allocs, h0)


def gops(allocs: Sequence[LayerAlloc], *, freq_hz: float,
         h0: int | None = None) -> float:
    total_macs = sum(a.layer.macs for a in allocs)
    return 2 * total_macs * pipeline_fps(allocs, freq_hz=freq_hz, h0=h0) / 1e9


def dsp_efficiency(allocs: Sequence[LayerAlloc], *, macs_per_dsp: int = 1,
                   h0: int | None = None) -> float:
    """Busy-MAC fraction: useful MACs / (DSPs * frame cycles * macs_per_dsp).

    This is the paper's "DSP Efficiency" row in Table I; ``macs_per_dsp=2``
    models the 8-bit double-pumped DSP48E1.
    """
    dsps = dsps_used(allocs, macs_per_dsp=macs_per_dsp)
    if dsps == 0:
        return 0.0
    total_macs = sum(a.layer.macs for a in allocs)
    return total_macs / (dsps * macs_per_dsp * frame_cycles(allocs, h0))


def dsps_used(allocs: Sequence[LayerAlloc], *, macs_per_dsp: int = 1) -> int:
    return sum(math.ceil(a.theta / macs_per_dsp) for a in allocs)
