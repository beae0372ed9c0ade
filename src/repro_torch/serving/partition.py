"""Balanced stage partitioning for the software layer-wise pipeline.
PyTorch twin of ``repro/serving/partition.py``.

The paper's Algorithm 1 balances hardware across layers so every engine
finishes a row group at the same rate; the serving pipeline needs the dual
decision — given the *fixed* per-engine allocation the program was
compiled with, split the step chain into K contiguous stages whose modeled
busy cycles are as equal as possible, so K worker threads each finish a
micro-batch at the same rate. The partition objective (minimize the
slowest stage) is exactly Algorithm 1's T_rowmax balance, solved with the
same contiguous min-max DP the mesh allocator uses
(:func:`repro_torch.core.allocator._partition_min_max`).

Stage weights come from :class:`~repro_torch.core.allocator.LayerAlloc` — the
single source of truth for modeled cycles — matched to steps by layer
name: conv engines cost ``H * t_row / K`` busy cycles per frame, FC
engines ``t_row``, pools zero (they ride with whichever compute stage the
cut assigns them to, as on the FPGA where pooling hides inside the
line-buffer read-out).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.allocator import LayerAlloc, _partition_min_max
from repro_torch.core.program import EngineProgram
from repro_torch.launch.mesh import cuda_devices


def stage_devices(n_stages: int,
                  devices: Sequence | None = None) -> list:
    """Round-robin device assignment for K stages: stage i runs on
    ``devices[i % len(devices)]`` (default: every CUDA device; raises
    without one) — each balanced stage gets its own card when the host has
    several, the software form of resource-partitioned multi-accelerator
    serving. On one card every stage maps to ``cuda:0``, so placement is
    transparent (same arithmetic, same weights)."""
    if n_stages < 1:
        raise ValueError(f"n_stages={n_stages} < 1")
    devs = list(cuda_devices() if devices is None else devices)
    if not devs:
        raise ValueError("no devices to place stages on")
    return [devs[i % len(devs)] for i in range(n_stages)]


def step_cycles(allocs: Sequence[LayerAlloc]) -> dict[str, float]:
    """Modeled per-frame busy cycles for each engine, keyed by layer name
    (pool layers map to 0.0 — they are plumbing, not compute)."""
    out: dict[str, float] = {}
    for a in allocs:
        if a.layer.macs == 0:
            out[a.layer.name] = 0.0
        elif a.layer.kind == "fc":
            out[a.layer.name] = a.t_row
        else:
            out[a.layer.name] = a.layer.H * a.t_per_output_row
    return out


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """A K-way contiguous split of an ``EngineProgram``'s step chain.

    ``boundaries`` has K+1 step indices: stage i runs steps
    ``[boundaries[i], boundaries[i+1])``. ``stage_cycles`` are the modeled
    busy cycles per frame per stage; ``bottleneck`` is their max — the
    modeled steady-state cost of one pipeline beat (the T_rowmax analogue
    at micro-batch granularity)."""

    n_stages: int
    boundaries: tuple[int, ...]
    stage_cycles: tuple[float, ...]

    @property
    def bottleneck(self) -> float:
        return max(self.stage_cycles)

    @property
    def balance(self) -> float:
        """mean/max stage cycles in (0, 1]; 1.0 == perfectly balanced.
        The pipeline's modeled speedup over one monolithic stage is
        ``n_stages * balance``."""
        if self.bottleneck <= 0:
            return 1.0
        return (sum(self.stage_cycles) / self.n_stages) / self.bottleneck

    def stage_ranges(self) -> list[tuple[int, int]]:
        return [(self.boundaries[i], self.boundaries[i + 1])
                for i in range(self.n_stages)]


def partition_from_boundaries(program: EngineProgram,
                              boundaries: Sequence[int]) -> StagePartition:
    """Build a :class:`StagePartition` for caller-chosen ``boundaries``
    (K+1 step indices covering ``[0, len(steps))``), with the same cycle
    weighting :func:`partition_program` uses — one source of truth for
    stage_cycles/balance however the cuts were picked."""
    if program.steps is None:
        raise ValueError("plan-only program (no lowered steps) cannot be "
                         "partitioned for serving")
    bounds = tuple(boundaries)
    n_stages = len(bounds) - 1
    if (n_stages < 1 or bounds[0] != 0 or bounds[-1] != len(program.steps)
            or any(b >= e for b, e in zip(bounds, bounds[1:]))):
        raise ValueError(
            f"boundaries {bounds} is not a contiguous cover of "
            f"[0, {len(program.steps)})")
    cycles = step_cycles(program.allocs)
    weights = [cycles.get(s.name, 0.0) for s in program.steps]
    return StagePartition(
        n_stages=n_stages, boundaries=bounds,
        stage_cycles=tuple(sum(weights[b:e])
                           for b, e in zip(bounds, bounds[1:])))


def partition_program(program: EngineProgram,
                      n_stages: int) -> StagePartition:
    """Split ``program``'s step chain into ``n_stages`` contiguous stages
    with near-equal modeled cycles (Algorithm 1's balance objective via
    the exact contiguous min-max DP).

    Raises when the program is plan-only (no lowered steps) or when more
    stages than compute steps are requested — a stage of only pool steps
    would spin on zero modeled work.
    """
    if program.steps is None:
        raise ValueError("plan-only program (no lowered steps) cannot be "
                         "partitioned for serving")
    n_compute = sum(1 for s in program.steps if s.kind != "pool")
    if not 1 <= n_stages <= n_compute:
        raise ValueError(
            f"n_stages={n_stages} outside [1, {n_compute}] "
            f"(compute steps in the chain)")
    cycles = step_cycles(program.allocs)
    weights = [cycles.get(s.name, 0.0) for s in program.steps]
    bounds, _ = _partition_min_max(weights, n_stages)
    # The DP may cut between a compute step and a trailing zero-weight
    # pool; both cuts cost the same, but keeping a pool with its producer
    # mirrors the FPGA (pooling reads out of the producing engine's line
    # buffer). Pull each boundary forward past any leading pools.
    bounds = list(bounds)
    for i in range(1, n_stages):
        while (bounds[i] < len(weights) and bounds[i] < bounds[i + 1] - 1
               and program.steps[bounds[i]].kind == "pool"):
            bounds[i] += 1
    return partition_from_boundaries(program, bounds)
