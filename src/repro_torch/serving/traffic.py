"""Seeded synthetic traffic: mixed-class arrival schedules + replay.
PyTorch twin of ``repro/serving/traffic.py`` (pure Python: a copy with the
port's imports).

Every serving benchmark needs the same thing — an open-loop request
stream at a target rate, with each request assigned a traffic class —
and before this module each bench rolled its own pacing loop. Here it is
once, seeded and recorded, so ``BENCH_serve_async.json`` and
``BENCH_serve_qos.json`` are reproducible from the artifact alone:

* :class:`TrafficClass` names one class of requests: a priority lane, an
  optional per-request deadline, and its share of the arrival mix;
* :func:`make_schedule` draws a deterministic arrival schedule — paced
  inter-arrival times (optionally exponential, i.e. Poisson arrivals)
  and a class per request — from one ``numpy`` RNG seed;
* :func:`make_scenario_schedule` is the adversarial superset — one
  front door over :data:`SCENARIOS`: ``uniform`` / ``poisson`` (the
  serve paths' own, bit-identical under the same seed), ``onoff``
  flash-crowd bursts, heavy-tailed ``lognormal`` / ``pareto``
  inter-arrival, and ``diurnal`` rate ramps — returning the schedule
  plus a JSON-ready record of every resolved parameter, so a chaos
  artifact replays from its own metadata;
* :func:`record_trace` / :func:`trace_schedule` round-trip a schedule
  through a JSON-serializable trace (the recorded-trace replay path:
  measured or captured arrivals re-driven exactly);
* :func:`replay` submits a frame stream through an
  :class:`~repro_torch.serving.frontend.AsyncFrontend` following a schedule
  against *absolute* deadlines (sleep until ``t0 + schedule[i].t``, so
  sleep overshoot never accumulates drift), and waits for every request
  to resolve (completed, failed, or expired — expired requests raise
  out of ``result()`` and are counted, never re-raised here);
* :func:`pacing_report` measures achieved-vs-target submit rate and
  per-arrival lag from the replayed handles, so pacing drift is visible
  in every artifact instead of silently biasing the knee optimistic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.serving.frontend import (DEFAULT_TENANT, AsyncFrontend,
                                    ServedRequest)

# The canonical two-class mix the QoS bench and launcher default to:
# a latency-sensitive interactive slice over a best-effort bulk floor.
DEFAULT_SLO_MS = 250.0


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One traffic class: lane priority, per-request deadline (None =
    best-effort, never dropped), and share of the arrival mix."""

    name: str
    priority: int = 0
    deadline_ms: float | None = None
    share: float = 1.0

    def to_json(self) -> dict:
        return {"name": self.name, "priority": self.priority,
                "deadline_ms": self.deadline_ms, "share": self.share}


def default_mix(slo_ms: float = DEFAULT_SLO_MS) -> tuple[TrafficClass, ...]:
    """interactive (priority 1, deadline ``slo_ms``, 25% of arrivals)
    over batch (priority 0, best-effort, 75%)."""
    return (TrafficClass("interactive", priority=1, deadline_ms=slo_ms,
                         share=0.25),
            TrafficClass("batch", priority=0, deadline_ms=None, share=0.75))


def armed_class_names(mix: Sequence[TrafficClass]) -> tuple[str, ...]:
    """Names of the deadline-armed classes in a mix — the latency-
    sensitive slice whose SLO miss rate defines ``sustained`` for the
    QPS-knee sweep (best-effort classes have no SLO to miss)."""
    return tuple(c.name for c in mix if c.deadline_ms is not None)


def parse_traffic_mix(spec: str,
                      slo_ms: float | None = None) -> tuple[TrafficClass, ...]:
    """Parse ``name:priority:share[:deadline_ms]`` comma-separated, e.g.
    ``interactive:1:0.25:50,batch:0:0.75`` (omitted/'-' deadline =
    best-effort; 'slo' = use ``slo_ms``, which must then be given — a
    silent 0 ms fallback would expire the whole class at submit).
    Shares are normalized."""
    classes = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not 3 <= len(fields) <= 4:
            raise ValueError(
                f"traffic-mix entry {part!r} is not "
                f"name:priority:share[:deadline_ms]")
        name, prio, share = fields[0], int(fields[1]), float(fields[2])
        deadline: float | None = None
        if len(fields) == 4 and fields[3] not in ("", "-", "none"):
            if fields[3] == "slo":
                if slo_ms is None or slo_ms <= 0:
                    raise ValueError(
                        f"traffic-mix entry {part!r} uses the 'slo' "
                        f"deadline token but no --slo-ms was given")
                deadline = slo_ms
            else:
                deadline = float(fields[3])
        classes.append(TrafficClass(name, priority=prio,
                                    deadline_ms=deadline, share=share))
    total = sum(c.share for c in classes)
    if total <= 0:
        raise ValueError(f"traffic mix {spec!r} has no positive share")
    return tuple(dataclasses.replace(c, share=c.share / total)
                 for c in classes)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit at ``t`` seconds after stream
    start, frame ``frame_idx`` of the (tenant's) stream, as class
    ``klass``, addressed to ``tenant`` (the default tenant for the
    single-model schedules :func:`make_schedule` draws; a multi-tenant
    bench tags per-tenant schedules with :func:`tag_tenant` and merges
    them by time)."""

    t: float
    frame_idx: int
    klass: TrafficClass
    tenant: str = DEFAULT_TENANT


def tag_tenant(schedule: Sequence[Arrival], tenant: str) -> list[Arrival]:
    """The same schedule addressed to ``tenant`` — the building block
    for multi-tenant replays: draw one seeded schedule per tenant (its
    own rate, mix, and frame indices), tag each, then merge-sort by
    ``t`` into the single interleaved arrival stream one frontend
    replays."""
    return [dataclasses.replace(a, tenant=tenant) for a in schedule]


def merge_schedules(*schedules: Sequence[Arrival]) -> list[Arrival]:
    """Interleave per-tenant schedules into one stream ordered by
    arrival time (stable: equal offsets keep argument order, so the
    merge is deterministic)."""
    merged = [a for s in schedules for a in s]
    merged.sort(key=lambda a: a.t)
    return merged


def make_schedule(n: int, rate_fps: float,
                  classes: Sequence[TrafficClass] | None = None, *,
                  seed: int = 0, poisson: bool = False) -> list[Arrival]:
    """Deterministic arrival schedule for ``n`` requests at ``rate_fps``.

    Class assignment is drawn per request from the mix shares; arrivals
    are uniformly paced at ``1/rate`` (or exponential inter-arrival gaps
    of the same mean with ``poisson=True`` — the bursty open-loop case).
    Everything comes from one ``np.random.default_rng(seed)``, so a
    recorded ``(n, rate, mix, seed, poisson)`` tuple replays the exact
    same stream.
    """
    if n < 0:
        raise ValueError(f"n={n} < 0")
    if classes is None:
        classes = default_mix()
    rng = np.random.default_rng(seed)
    shares = np.asarray([c.share for c in classes], dtype=np.float64)
    shares = shares / shares.sum()
    which = rng.choice(len(classes), size=n, p=shares)
    period = 1.0 / rate_fps if rate_fps > 0 else 0.0
    if poisson and period > 0:
        gaps = rng.exponential(scale=period, size=n)
        times = np.cumsum(gaps) - gaps[0] if n else np.zeros(0)
    else:
        times = np.arange(n) * period
    return [Arrival(t=float(times[i]), frame_idx=i,
                    klass=classes[int(which[i])]) for i in range(n)]


# The adversarial scenario suite (ROADMAP item 5). ``uniform`` and
# ``poisson`` reproduce make_schedule exactly (same RNG draw order), so
# existing artifacts stay comparable; the rest bend the arrival process
# while keeping the same long-run mean rate:
#
#   onoff     - flash crowd: square-wave between a burst rate and a base
#               rate (duty-cycle fraction of each period at burst_factor
#               x base), the input-buffer-overrun case;
#   lognormal - heavy-tailed gaps, lognormal(sigma) with mean 1/rate;
#   pareto    - heavier still: Pareto(alpha) gaps with mean 1/rate
#               (alpha must be > 1 for the mean to exist);
#   diurnal   - slow sinusoidal rate ramp, ``cycles`` periods across the
#               stream, swinging +-amp around the mean rate.
SCENARIOS = ("uniform", "poisson", "onoff", "lognormal", "pareto",
             "diurnal")


def resolve_scenario_params(scenario: str, rate_fps: float,
                            **params) -> dict:
    """Validate + default the knobs of one scenario into the JSON-ready
    record :func:`make_scenario_schedule` stores in artifacts. Unknown
    knobs are an error — a typo must not silently run the default."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(expected one of {SCENARIOS})")
    out: dict = {"scenario": scenario, "rate_fps": float(rate_fps)}
    if scenario == "onoff":
        bf = float(params.pop("burst_factor", 4.0))
        duty = float(params.pop("duty", 0.25))
        nb = int(params.pop("n_bursts", 4))
        if bf <= 1.0:
            raise ValueError(f"burst_factor={bf} must be > 1")
        if not 0.0 < duty < 1.0:
            raise ValueError(f"duty={duty} must be in (0, 1)")
        if nb < 1:
            raise ValueError(f"n_bursts={nb} must be >= 1")
        out.update(burst_factor=bf, duty=duty, n_bursts=nb)
    elif scenario == "lognormal":
        sigma = float(params.pop("sigma", 1.0))
        if sigma <= 0:
            raise ValueError(f"sigma={sigma} must be > 0")
        out["sigma"] = sigma
    elif scenario == "pareto":
        alpha = float(params.pop("alpha", 1.5))
        if alpha <= 1.0:
            raise ValueError(f"alpha={alpha} must be > 1 for a finite "
                             f"mean inter-arrival gap")
        out["alpha"] = alpha
    elif scenario == "diurnal":
        amp = float(params.pop("amp", 0.8))
        cycles = int(params.pop("cycles", 1))
        if not 0.0 <= amp < 1.0:
            raise ValueError(f"amp={amp} must be in [0, 1)")
        if cycles < 1:
            raise ValueError(f"cycles={cycles} must be >= 1")
        out.update(amp=amp, cycles=cycles)
    if params:
        raise ValueError(f"unknown {scenario!r} scenario params: "
                         f"{sorted(params)}")
    return out


def _scenario_times(n: int, rate_fps: float, rng: np.random.Generator,
                    p: dict) -> np.ndarray:
    period = 1.0 / rate_fps if rate_fps > 0 else 0.0
    scenario = p["scenario"]
    if n == 0 or period == 0.0:
        return np.zeros(n)
    if scenario == "uniform":
        return np.arange(n) * period
    if scenario == "poisson":
        gaps = rng.exponential(scale=period, size=n)
        return np.cumsum(gaps) - gaps[0]
    if scenario == "lognormal":
        # mean of lognormal(mu, sigma) is exp(mu + sigma^2/2): pin the
        # mean gap at 1/rate so the long-run rate matches the target.
        sigma = p["sigma"]
        mu = np.log(period) - sigma * sigma / 2.0
        gaps = rng.lognormal(mean=mu, sigma=sigma, size=n)
        return np.cumsum(gaps) - gaps[0]
    if scenario == "pareto":
        # numpy's pareto is the Lomax form; (x+1)*m is Pareto(alpha)
        # with minimum m and mean m*alpha/(alpha-1): scale for mean gap.
        alpha = p["alpha"]
        m = period * (alpha - 1.0) / alpha
        gaps = (rng.pareto(alpha, size=n) + 1.0) * m
        return np.cumsum(gaps) - gaps[0]
    if scenario == "onoff":
        # Square-wave envelope: duty-cycle fraction of each period runs
        # at burst_factor x the base rate; the base is chosen so the
        # duty-weighted mean equals rate_fps.
        bf, duty, nb = p["burst_factor"], p["duty"], p["n_bursts"]
        duration = n * period
        cycle = duration / nb
        rate_base = rate_fps / (duty * bf + (1.0 - duty))
        rate_on = bf * rate_base
        times = np.empty(n)
        t = 0.0
        for i in range(n):
            times[i] = t
            in_burst = (t % cycle) < duty * cycle
            t += 1.0 / (rate_on if in_burst else rate_base)
        return times
    if scenario == "diurnal":
        # rate(t) swings +-amp around the mean, starting at the trough
        # (1-amp) so the ramp-up through the mean is part of the window.
        amp, cycles = p["amp"], p["cycles"]
        duration = n * period
        times = np.empty(n)
        t = 0.0
        for i in range(n):
            times[i] = t
            r = rate_fps * (1.0 - amp * np.cos(2.0 * np.pi * cycles
                                               * t / duration))
            t += 1.0 / max(r, 1e-9)
        return times
    raise AssertionError(f"unhandled scenario {scenario!r}")


def make_scenario_schedule(scenario: str, n: int, rate_fps: float,
                           classes: Sequence[TrafficClass] | None = None,
                           *, seed: int = 0,
                           **params) -> tuple[list[Arrival], dict]:
    """Deterministic arrival schedule under one adversarial scenario.

    Same contract as :func:`make_schedule` (one RNG, class draw first —
    ``uniform``/``poisson`` reproduce it bit-for-bit under the same
    seed), plus the scenario envelope on the inter-arrival process.
    Returns ``(schedule, record)`` where ``record`` is the JSON-ready
    resolved-parameter dict (scenario, rate, seed, n, every knob) that
    makes the stream reproducible from the artifact alone."""
    if n < 0:
        raise ValueError(f"n={n} < 0")
    if classes is None:
        classes = default_mix()
    p = resolve_scenario_params(scenario, rate_fps, **params)
    rng = np.random.default_rng(seed)
    shares = np.asarray([c.share for c in classes], dtype=np.float64)
    shares = shares / shares.sum()
    which = rng.choice(len(classes), size=n, p=shares)
    times = _scenario_times(n, rate_fps, rng, p)
    schedule = [Arrival(t=float(times[i]), frame_idx=i,
                        klass=classes[int(which[i])]) for i in range(n)]
    record = dict(p, seed=int(seed), n=int(n))
    return schedule, record


def record_trace(schedule: Sequence[Arrival]) -> dict:
    """A JSON-serializable trace of a schedule — class table + per-
    arrival ``[t, frame_idx, class, tenant]`` rows. With
    :func:`trace_schedule` this is the recorded-trace replay path: any
    arrival stream (synthetic or captured) can be stored in an artifact
    and re-driven exactly, independent of the RNG that produced it."""
    classes: dict[str, TrafficClass] = {}
    for a in schedule:
        prev = classes.setdefault(a.klass.name, a.klass)
        if prev != a.klass:
            raise ValueError(
                f"schedule has two different classes named {a.klass.name!r}")
    return {"version": 1,
            "classes": [c.to_json() for c in classes.values()],
            "arrivals": [[float(a.t), int(a.frame_idx), a.klass.name,
                          a.tenant] for a in schedule]}


def trace_schedule(trace: dict) -> list[Arrival]:
    """Rebuild the exact schedule a :func:`record_trace` dict captured."""
    classes = {c["name"]: TrafficClass(
        c["name"], priority=int(c["priority"]),
        deadline_ms=(None if c["deadline_ms"] is None
                     else float(c["deadline_ms"])),
        share=float(c["share"])) for c in trace["classes"]}
    return [Arrival(t=float(t), frame_idx=int(idx), klass=classes[name],
                    tenant=tenant)
            for t, idx, name, tenant in trace["arrivals"]]


def pacing_report(schedule: Sequence[Arrival],
                  reqs: Sequence[ServedRequest]) -> dict:
    """Achieved-vs-target pacing of one replay, from the request
    handles' ``t_submit`` stamps: the achieved submit rate over the
    stream span, the ratio against the scheduled rate, and the
    per-arrival lag behind the absolute schedule (mean / max). A ratio
    near 1 certifies the open loop actually drove the rate the artifact
    claims; a large max lag flags a submit path that fell behind."""
    if len(schedule) != len(reqs):
        raise ValueError(f"schedule has {len(schedule)} arrivals but "
                         f"{len(reqs)} request handles were returned")
    n = len(reqs)
    if n < 2:
        return {"arrivals": n, "target_fps": None, "achieved_fps": None,
                "rate_ratio": None, "lag_ms_mean": None, "lag_ms_max": None}
    t0_sched, t0_real = schedule[0].t, reqs[0].t_submit
    lags = [(reqs[i].t_submit - t0_real) - (schedule[i].t - t0_sched)
            for i in range(n)]
    span_sched = schedule[-1].t - t0_sched
    span_real = reqs[-1].t_submit - t0_real
    target = (n - 1) / span_sched if span_sched > 0 else None
    achieved = (n - 1) / span_real if span_real > 0 else None
    ratio = (achieved / target if achieved is not None
             and target is not None and target > 0 else None)
    return {"arrivals": n,
            "target_fps": None if target is None else round(target, 3),
            "achieved_fps": None if achieved is None else round(achieved, 3),
            "rate_ratio": None if ratio is None else round(ratio, 4),
            "lag_ms_mean": round(1e3 * float(np.mean(lags)), 3),
            "lag_ms_max": round(1e3 * float(np.max(lags)), 3)}


def replay(frontend: AsyncFrontend, frames,
           schedule: Sequence[Arrival], *,
           result_timeout: float = 600.0,
           raise_failed: bool = True) -> list[ServedRequest]:
    """Submit ``frames`` through ``frontend`` following ``schedule``
    (open loop: each request goes in at its scheduled offset, late or
    not), then wait for every request to resolve. ``frames`` is one
    stream array for a single-tenant schedule, or a ``{tenant: stream}``
    mapping for a merged multi-tenant one (each arrival's ``frame_idx``
    indexes its own tenant's stream). Returns the request handles in
    schedule order. Pacing is against *absolute* deadlines — each sleep
    targets ``t0 + a.t``, never a relative gap, so per-sleep overshoot
    cannot accumulate into rate drift at high QPS (pass the handles to
    :func:`pacing_report` to verify). An ``expired`` request is a
    resolved handle (drop-on-SLO-miss is expected QoS behaviour — read
    ``req.outcome``), but a ``failed`` one re-raises its serving error:
    a broken pipeline must fail the bench, not quietly thin out the
    percentile samples. Chaos scenarios that *inject* failures pass
    ``raise_failed=False`` and assert on the outcomes instead."""
    t0 = time.perf_counter()
    reqs: list[ServedRequest] = []
    for a in schedule:
        delay = (t0 + a.t) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        stream = frames[a.tenant] if isinstance(frames, dict) else frames
        reqs.append(frontend.submit(
            stream[a.frame_idx], priority=a.klass.priority,
            deadline_ms=a.klass.deadline_ms, klass=a.klass.name,
            tenant=a.tenant))
    deadline = time.perf_counter() + result_timeout
    for r in reqs:
        if not r._event.wait(timeout=max(0.0, deadline - time.perf_counter())):
            raise TimeoutError("replayed request did not resolve")
    if raise_failed:
        for r in reqs:
            if r.outcome == "failed":
                r.result(timeout=0)     # re-raises the serving error
    return reqs
