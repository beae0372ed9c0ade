"""Open-loop replay, after ``repro_torch.serving.traffic.replay``: each
request is submitted at its scheduled offset against absolute deadlines
(sleep overshoot never accumulates), late or not. The harness keeps its
own clock: each request's due time, when it was submitted, and (through
``stamp_results``) when its result reached the host."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

from bench.traffic.schedule import Arrival


def stamp_results(executor) -> dict:
    """Wrap the callback the frontend installed on ``executor`` so that
    each request of a batch gets a host-clock stamp when the batch's
    outputs reach the host, just before the frontend resolves them:
    ``{id(request): seconds}``."""
    done: dict = {}
    deliver = executor.on_result

    def on_result(tag, outputs):
        now = time.perf_counter()
        for req in tag:
            done[id(req)] = now
        deliver(tag, outputs)

    executor.on_result = on_result
    return done


def replay(submit: Callable, pool: np.ndarray,
           schedule: Sequence[Arrival],
           on_tick: Callable[[float], None] | None = None):
    """Submit ``pool[a.frame_idx]`` for every arrival at ``t0 + a.t``.
    Returns ``(requests, due, submitted)``: the handles and the absolute
    due and submit times. ``on_tick(elapsed)`` runs before each submit."""
    n = len(schedule)
    due = np.empty(n)
    sent = np.empty(n)
    reqs = []
    t0 = time.perf_counter()
    for i, a in enumerate(schedule):
        due[i] = t0 + a.t
        delay = due[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if on_tick is not None:
            on_tick(time.perf_counter() - t0)
        sent[i] = time.perf_counter()
        reqs.append(submit(pool[a.frame_idx], a.klass))
    return reqs, due, sent


def pacing(due: np.ndarray, sent: np.ndarray) -> dict:
    """How late the generator ran: submit time minus due time, in ms."""
    lag = (sent - due) * 1e3
    return {"lag_ms_mean": float(lag.mean()), "lag_ms_p95":
            float(np.percentile(lag, 95)), "lag_ms_max": float(lag.max())}
