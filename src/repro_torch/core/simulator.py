"""Cycle-accurate pipeline simulator. PyTorch twin of
``repro/core/simulator.py`` (pure Python: a copy with the port's imports).

Validates the closed-form throughput model (Eqs. 2-4) by simulating the
layer-wise pipeline at row-group granularity: engine i may compute its r-th
output-row group only when (a) the producer has delivered the input rows its
receptive field needs and (b) its own previous group is done. The steady
state must match ``H_0 * T_rowmax``; the simulator additionally exposes the
fill/drain latency and per-engine idle cycles (the quantity the paper's
DSP-efficiency metric penalizes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.allocator import LayerAlloc


@dataclasses.dataclass(frozen=True)
class SimResult:
    frame_cycles: float           # makespan for one frame (incl. fill)
    steady_cycles: float          # asymptotic per-frame cycles (pipelined)
    engine_busy: tuple[float, ...]
    engine_idle_frac: tuple[float, ...]
    dsp_efficiency: float         # busy MACs / (theta_total * makespan)


def simulate(allocs: Sequence[LayerAlloc], n_frames: int = 2) -> SimResult:
    """Event-driven simulation over ``n_frames`` consecutive frames.

    Accepts either a sequence of :class:`LayerAlloc` or any object exposing
    an ``allocs`` attribute (e.g.
    :class:`repro_torch.core.program.EngineProgram`), so the simulator
    consumes the same compiled plan as the executor.

    Returns per-frame steady-state cycles measured between the completion of
    consecutive frames, which is what Eq. (4) predicts.
    """
    allocs = getattr(allocs, "allocs", allocs)
    engines = [a for a in allocs if a.layer.macs > 0]
    n = len(engines)

    # ready[i][g] = cycle when group g of engine i's output exists.
    finish: list[list[float]] = []
    frame_done: list[float] = []

    for i, a in enumerate(engines):
        l = a.layer
        groups = max(1, math.ceil(l.H / max(1, a.K))) if l.kind == "conv" else 1
        finish.append([0.0] * (groups * n_frames))
    busy_acc = [0.0] * n

    for f in range(n_frames):
        for i, a in enumerate(engines):
            l = a.layer
            if l.kind == "conv":
                groups = max(1, math.ceil(l.H / max(1, a.K)))
            else:
                groups = 1
            base = f * groups
            for g in range(groups):
                # Input dependency: which producer group covers the rows this
                # group's receptive field needs?
                if i == 0:
                    t_dep = 0.0  # frame f input fully available at cycle ~0
                else:
                    p = engines[i - 1]
                    pl = p.layer
                    pgroups = (max(1, math.ceil(pl.H / max(1, p.K)))
                               if pl.kind == "conv" else 1)
                    if l.kind == "fc":
                        need = pgroups - 1          # whole feature map
                    else:
                        # Output rows [g*K, (g+1)*K) need input rows up to
                        # (g+1)*K*G + R - 1 from the producer.
                        last_in_row = min(
                            pl.H - 1,
                            ((g + 1) * max(1, a.K)) * max(1, l.stride) + l.R - 2)
                        need = min(pgroups - 1,
                                   last_in_row // max(1, p.K))
                    t_dep = finish[i - 1][f * pgroups + need]
                t_self = finish[i][base + g - 1] if (g > 0 or f > 0) else 0.0
                if g == 0 and f > 0:
                    t_self = finish[i][base - 1]
                if l.kind == "conv":
                    # The last row-group of a frame may cover fewer than K
                    # output rows (H % K != 0); charge only its actual rows.
                    rows = min(max(1, a.K), l.H - g * max(1, a.K))
                    dur = rows * a.t_per_output_row
                else:
                    dur = a.t_row
                busy_acc[i] += dur
                finish[i][base + g] = max(t_dep, t_self) + dur
        frame_done.append(finish[-1][(f + 1) * len(finish[-1]) // n_frames - 1])

    makespan = frame_done[0]
    steady = (frame_done[-1] - frame_done[0]) / (n_frames - 1) \
        if n_frames > 1 else makespan

    total_span = frame_done[-1]
    busy = tuple(busy_acc)
    idle = tuple(1.0 - min(1.0, b / total_span) for b in busy)
    theta_total = sum(a.theta for a in engines)
    # steady-state efficiency (per-frame rate once the pipe is full);
    # the fill/drain latency is reported separately via frame_cycles.
    per_frame = steady if n_frames > 1 else makespan
    total_macs = sum(a.layer.macs for a in engines)
    eff = total_macs / (theta_total * per_frame) if theta_total else 0.0
    return SimResult(
        frame_cycles=makespan,
        steady_cycles=steady,
        engine_busy=busy,
        engine_idle_frac=idle,
        dsp_efficiency=min(1.0, eff),
    )
