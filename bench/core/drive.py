"""The system under test and the two drivers that load it.

The program is ``repro_torch``: a configuration is compiled with
``core.program.compile_model`` from the harness's own weights and
calibration frame (what ``serving.server.compile_for_serving`` does with
weights it draws itself), and served through the entry the cell's mix
names: the single ``EngineExecutor``, the ``PipelineExecutor`` that
``serving.server.make_executor`` builds, or an ``AsyncFrontend`` over it.

* closed loop: one client submits frames from the pool as fast as the
  entry takes them, whole batches at a time, until the window's seconds
  have passed, then drains; the rate is every frame over all that time;
* open loop: requests are submitted at their scheduled times, late or
  not; each one's latency runs from its due time to its result on the
  host, and one that fails or never comes sits at the top of the tail.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench.traffic import replay as R
from bench.traffic import schedule as S

# How long past the last arrival an open-loop run waits for its answers.
ANSWER_WAIT_S = 60.0


def model(cfg: dict):
    from repro_torch.core.workload import CNNModel, ConvLayer
    return CNNModel(cfg["name"], cfg["input_hw"], cfg["input_ch"],
                    tuple(ConvLayer(**lyr) for lyr in cfg["layers"]))


def compile_program(cfg: dict, params: dict, calib: torch.Tensor, device):
    from repro_torch.core.program import compile_model
    return compile_model(model(cfg), params, bits=cfg["bits"],
                         calib_batch=calib, theta=cfg["theta"],
                         bram_total=None, device=device)


def executor(prog, cell):
    """The cell's executor: the single ``EngineExecutor``, or what
    ``make_executor`` builds from the cell's stages and replicas (a
    ``PipelineExecutor``, or a ``ReplicaPool`` of them); the frontend goes
    on top of the latter."""
    cfg = cell.config
    if cell.traffic["entry"] == "engine":
        from repro_torch.core.executor import EngineExecutor
        return EngineExecutor(prog, batch_size=cfg["batch"],
                              route=cfg["route"], output="logits")
    from repro_torch.serving.server import make_executor
    return make_executor(prog, stages=cell.stages, batch=cfg["batch"],
                         route=cfg["route"], output="logits",
                         replicas=cell.replicas,
                         replica_mode=cell.replica_mode)


def frontend(px, cfg: dict, rate: float):
    """An ``AsyncFrontend`` with the frontend's default flush timeout, one
    full batch's assembly window at the offered rate."""
    from repro_torch.serving.calibrate import default_max_wait_ms
    from repro_torch.serving.frontend import AsyncFrontend
    return AsyncFrontend(px, max_wait_ms=default_max_wait_ms(cfg["batch"],
                                                             rate))


def close(ex) -> None:
    if hasattr(ex, "close"):
        ex.close()


def warm(ex, pool: np.ndarray, batch: int, batches: int = 4) -> None:
    """Serve a few whole batches: every kernel and buffer of the one batch
    shape the cell uses is built before the window."""
    n = batch * batches
    ex.serve([pool[i % len(pool)] for i in range(n)])
    ex.reset_stats()


@dataclasses.dataclass
class Closed:
    outputs: list
    submitted: int
    seconds: float
    marks: list                # elapsed seconds after each batch's submit


def run_closed(ex, pool: np.ndarray, batch: int, seconds: float,
               tick=None) -> Closed:
    """Submit whole batches of pool frames, cycled, until ``seconds`` have
    passed, then drain. ``tick(elapsed)`` runs between batches."""
    n_pool = len(pool)
    i = 0
    marks = []
    t0 = time.perf_counter()
    while True:
        for _ in range(batch):
            ex.submit(pool[i % n_pool])
            i += 1
        elapsed = time.perf_counter() - t0
        marks.append(elapsed)
        if tick is not None:
            tick(elapsed)
        if elapsed >= seconds:
            break
    outputs = ex.drain()
    return Closed(outputs, i, time.perf_counter() - t0, marks)


def per_second(marks: list, batch: int) -> list:
    """Frames submitted in each whole second of a closed-loop window."""
    counts = np.bincount(np.asarray(marks, dtype=np.int64)) * batch
    return counts[:int(marks[-1])].tolist() if marks else []


@dataclasses.dataclass
class Open:
    requests: list
    due: np.ndarray
    sent: np.ndarray
    answered: dict             # id(request) -> host time its result came
    closed_at: float           # when the harness stopped waiting


def run_open(fe, ex, pool: np.ndarray, schedule, tick=None) -> Open:
    """Replay ``schedule`` into the frontend, then wait for every answer,
    up to ``ANSWER_WAIT_S`` past the last arrival."""
    answered = R.stamp_results(ex)

    def submit(frame, klass: S.TrafficClass):
        return fe.submit(frame, priority=klass.priority,
                         deadline_ms=klass.deadline_ms, klass=klass.name)

    reqs, due, sent = R.replay(submit, pool, schedule, tick)
    limit = due[-1] + ANSWER_WAIT_S
    for r in reqs:
        try:
            r.result(timeout=max(0.0, limit - time.perf_counter()))
        except (TimeoutError, RuntimeError):
            pass                # counted as missing below
    return Open(reqs, due, sent, answered, time.perf_counter())


def open_outputs(run: Open) -> list:
    """Each request's output, or None for one that failed or never came."""
    outs = []
    for r in run.requests:
        if id(r) in run.answered and r.outcome == "completed":
            outs.append(r.result(timeout=0))
        else:
            outs.append(None)
    return outs


def open_latencies_ms(run: Open) -> np.ndarray:
    """Due-to-answer latency of every request; a request without an answer
    counts from its due time to the end of the wait, plus the wait again,
    so it lands above every answered one."""
    lat = np.empty(len(run.requests))
    for i, r in enumerate(run.requests):
        t = run.answered.get(id(r))
        if t is None or r.outcome != "completed":
            t = run.closed_at + ANSWER_WAIT_S
        lat[i] = t - run.due[i]
    return lat * 1e3
