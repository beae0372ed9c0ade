"""Fault tolerance: restartable step loop, straggler mitigation, elastic
rescale. The port of ``repro/runtime/fault_tolerance.py``: the loop, the
detector and the re-plan are the reference's, over the port's
checkpoints, allocator and LM workloads.

Design for 1000+ nodes (DESIGN.md §5):
* every N steps a sharded checkpoint is written atomically (manifest last);
  a restart resumes from the last complete step and the deterministic,
  seekable data pipeline replays from there — no data loss/dup;
* per-step wall-times feed an EWMA straggler detector; a straggler (or a
  dead host, which surfaces as a collective timeout -> process restart)
  triggers `elastic_replan`: Algorithm 1 re-runs for the surviving chip
  count, the checkpoint is restored onto the new layout (the re-sharded
  restore comes with the port's multi-card runtime), and training
  continues — the paper's "framework regenerates the accelerator
  for the new resource budget", at mesh scale;
* simulated failure injection hooks let the tests exercise all paths on
  CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch import checkpointing as ckpt


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time outlier detection (threshold x median of peers)."""
    alpha: float = 0.2
    threshold: float = 2.0
    _ewma: dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, host_times: dict[int, float]) -> list[int]:
        for h, t in host_times.items():
            prev = self._ewma.get(h, t)
            self._ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        med = float(np.median(list(self._ewma.values())))
        return [h for h, t in self._ewma.items()
                if t > self.threshold * med]


class InjectedCrash(RuntimeError):
    """The crash ``fail_at`` injects: the one failure ``run_loop`` restarts
    from in-process. Any other error propagates; a real fault restarts
    the process, which resumes from the latest complete step."""


@dataclasses.dataclass
class RunState:
    step: int = 0
    restarts: int = 0
    rescales: int = 0


def run_loop(
    *,
    state: Any,
    step_fn: Callable[[Any, dict], tuple[Any, dict]],
    stream,
    ckpt_dir: str,
    total_steps: int,
    ckpt_every: int = 50,
    fail_at: dict[int, str] | None = None,
    on_rescale: Callable[[Any], Any] | None = None,
    log: Callable[[str], None] = print,
) -> tuple[Any, RunState]:
    """Restartable training loop.

    ``fail_at``: {step: "crash"|"straggler"|"shrink"} — simulated faults
    for tests. "crash" raises ``InjectedCrash`` once, then the loop
    restarts from the last checkpoint; "shrink" invokes on_rescale
    (elastic re-plan). Any other exception ends the loop: it is raised
    to the caller, not retried.
    """
    rs = RunState()
    detector = StragglerDetector()
    fail_at = dict(fail_at or {})
    crashed_once: set[int] = set()

    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        state = ckpt.restore(ckpt_dir, last, state)
        stream.seek(last)
        rs.step = last
        log(f"[ft] resumed from step {last}")

    while rs.step < total_steps:
        step = rs.step
        try:
            if fail_at.get(step) == "crash" and step not in crashed_once:
                crashed_once.add(step)
                raise InjectedCrash(f"injected crash at step {step}")
            t0 = time.perf_counter()
            batch = next(stream)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            if fail_at.get(step) == "straggler":
                detector.observe({0: dt, 1: dt * 5.0})
            slow = detector.observe({0: dt})
            if slow:
                log(f"[ft] stragglers detected: {slow} (would swap spares)")
            if fail_at.get(step) == "shrink" and on_rescale is not None:
                state = on_rescale(state)
                rs.rescales += 1
                log(f"[ft] elastic rescale at step {step}")
                fail_at.pop(step)
            rs.step += 1
            if rs.step % ckpt_every == 0 or rs.step == total_steps:
                ckpt.save(ckpt_dir, rs.step, state)
            continue
        except InjectedCrash as e:
            log(f"[ft] failure: {e}; restarting from checkpoint")
        # Out of the handler, so the failure's frames are gone; the old
        # state is let go before the checkpoint is read into its shapes.
        rs.restarts += 1
        last = ckpt.latest_step(ckpt_dir)
        if last is None:
            rs.step = 0
            stream.seek(0)
        else:
            like, device = ckpt.skeleton(state)
            state = None
            state = ckpt.restore(ckpt_dir, last, like, device=device)
            stream.seek(last)
            rs.step = last
    return state, rs


def elastic_replan(cfg, n_chips: int, *, seq_len: int, global_batch: int,
                   train: bool = True):
    """Re-run the mesh allocator for a shrunken/grown chip pool. Returns the
    new StagePlan; callers re-shard the restored checkpoint accordingly."""
    from repro_torch.core.allocator import plan_pipeline
    from repro_torch.core.workload import lm_layer_workloads

    layers = lm_layer_workloads(cfg, seq_len=seq_len, batch=global_batch,
                                mode="train" if train else "prefill")
    # Factor chips into data x model, preferring model=16.
    model_axis = min(16, n_chips)
    while n_chips % model_axis:
        model_axis //= 2
    data_axis = n_chips // model_axis
    return plan_pipeline(layers, model_axis=model_axis, data_axis=data_axis,
                         global_batch=global_batch, seq_len=seq_len,
                         train=train, allow_infeasible=True)
