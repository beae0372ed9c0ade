"""One implementation of warmup / throughput calibration for every
serve path. PyTorch twin of ``repro/serving/calibrate.py`` (pure Python: a
copy with the port's imports).

Three routines shared by the single-model serve paths, the
multi-tenant server's per-tenant warm-start, and live rescale
recalibration:

- :func:`pipeline_throughput` — compile-warm a pipeline (or replica
  pool), measure the unloaded single-batch traversal, then measure
  closed-loop steady-state throughput over a clean stats window;
- :func:`default_max_wait_ms` — the one-full-batch-window flush-timeout
  convention;
- :func:`warmed_frontend` — a fresh :class:`AsyncFrontend` whose
  estimator (and router, for a pool) is warm-started from that
  calibration, the shared convention behind every QoS rate and knee
  probe.

:func:`repro_torch.serving.server.build_server` runs the same
:func:`pipeline_throughput` per tenant, and :meth:`Server.rescale
<repro_torch.serving.server.Server.rescale>` runs it on every candidate
executor before swapping it live, so warm-start numbers everywhere are
measured by exactly the code the single-model benches use.
"""

from __future__ import annotations

import dataclasses
import time


def pipeline_throughput(px, stream, batch: int):
    """Warmup + closed-loop steady-state throughput of one pipeline:
    one micro-batch through all K stages builds every stage's kernels (stats
    reset afterwards so the measured window is pure steady state —
    without this, batches queued during the cold builds flood out the
    moment the pipeline opens and a short stream reads an absurd fps),
    then a saturating closed-loop pass. Returns ``(warmup_s, lat1_s,
    phase-1 stats snapshot)`` — snapshotting keeps the counts describing
    exactly the window steady_fps was measured over (later frontend
    phases keep accumulating into ``px.stats``). A replica pool warms
    every replica (all R x K stages), so no probe ever pays a cold
    first launch mid-measurement."""
    t0 = time.perf_counter()
    warm = getattr(px, "warmup", None)
    if warm is not None:
        warm(list(stream[:batch]))
    else:
        px.serve(list(stream[:batch]))
    warmup_s = time.perf_counter() - t0
    # One more single-batch pass through the now-compiled, *empty*
    # pipeline: the unloaded K-stage traversal. This is the honest seed
    # for the admission latency channel — the closed-loop pass below
    # runs saturated, so its per-batch dispatch->done times include
    # stage-queue waits that an admitted open-loop request never sees.
    t0 = time.perf_counter()
    px.serve(list(stream[:batch]))
    lat1_s = time.perf_counter() - t0
    px.reset_stats()
    px.serve(list(stream))
    return warmup_s, lat1_s, dataclasses.replace(px.stats)


def default_max_wait_ms(batch: int, rate: float) -> float:
    """One full batch assembles in batch/rate seconds; waiting any less
    flushes padded partial batches faster than the pipeline drains them
    (service rate collapses), any more only parks the first frame of a
    quiet period."""
    return 1e3 * batch / rate if rate > 0 else 50.0


def warmed_frontend(px, steady: float, rate: float, batch: int, *,
                    max_wait_ms: float | None,
                    admission_control: bool,
                    flush_guard_ms: float | None,
                    lat1_s: float | None = None,
                    max_queue: int = 256):
    """One convention for the per-replay control plane — shared by the
    QoS rates and the knee probes so their artifacts stay comparable: a
    fresh estimator per replay (an overload replay's noisy tail must
    not skew the next replay's admission), warm-started from the
    measured calibration throughput (:meth:`ServiceTimeEstimator
    .warm_start_channels`) — the window channel at the fleet batch
    window (``batch / steady``), the latency channel at
    ``stages x replicas x window`` (a K-stage traversal is ~K windows,
    and R-way routing multiplies each replica's per-batch beat by R) —
    behind a frontend whose ``max_wait`` defaults to one full-batch
    window at the arrival rate. When the calibration pass measured the
    *unloaded* single-batch traversal (``lat1_s``), that measurement
    replaces the formula on the latency channel: the ``K x R x window``
    bound assumes fleet throughput scales linearly with R, which
    overprices admission whenever replicas share silicon (the backlog
    ahead of a request is priced separately, via the window channel, so
    the latency channel must NOT bake queueing in). With a replica pool
    underneath, the router's per-replica estimators get the matching
    per-replica formula seed — router pricing is relative across
    replicas, so a shared bias cancels — and admission itself stays on
    the fleet numbers: the frontend's shared estimator observes the
    interleaved completion beat of all R replicas. The router's
    fresh-start is *forced* (:meth:`LeastWaitRouter.reset_pricing`
    before the warm seed): ``warm_start`` alone defers to existing
    measurements, so a replica starved during the saturated calibration
    pass would keep its stale high EWMA and be priced out of every
    subsequent pick — the starvation-hysteresis liveness bug the chaos
    fault replays flushed out."""
    from repro_torch.serving.estimator import ServiceTimeEstimator
    from repro_torch.serving.frontend import AsyncFrontend
    n_replicas = getattr(px, "n_replicas", 1)
    warm = batch / max(steady, 1e-9)
    est = ServiceTimeEstimator()
    est.warm_start_channels(batch, warm, stages=px.partition.n_stages,
                            replicas=n_replicas)
    if lat1_s is not None and lat1_s > 0:
        est.warm_start(batch, lat1_s)
    router = getattr(px, "router", None)
    if router is not None:
        router.reset_pricing()
        router.warm_start(n_replicas * warm,
                          px.partition.n_stages * n_replicas * warm)
    wait_ms = (max_wait_ms if max_wait_ms is not None
               else default_max_wait_ms(batch, min(rate, steady)))
    return AsyncFrontend(px, max_wait_ms=wait_ms, estimator=est,
                         admission_control=admission_control,
                         flush_guard_ms=flush_guard_ms,
                         max_queue=max_queue)
