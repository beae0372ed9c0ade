"""Arrival schedules. ``make_schedule`` and ``make_scenario_schedule``
(with ``SCENARIOS`` and their parameters) are frozen copies of
``repro_torch.serving.traffic``'s (tests hold them equal), so the program
can change and this yardstick cannot. ``open_loop_schedule`` is the one
generator every open-loop mix file feeds: the mix's ``process`` names a
scenario and its ``params`` that scenario's knobs; anything else raises."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One traffic class: lane priority, per-request deadline (None =
    best-effort, never dropped), and share of the arrival mix."""

    name: str
    priority: int = 0
    deadline_ms: float | None = None
    share: float = 1.0


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit at ``t`` seconds after stream start,
    frame ``frame_idx``, as class ``klass``."""

    t: float
    frame_idx: int
    klass: TrafficClass


def make_schedule(n: int, rate_fps: float,
                  classes: Sequence[TrafficClass], *,
                  seed: int = 0, poisson: bool = False) -> list[Arrival]:
    """``n`` arrivals at ``rate_fps``: a class per request drawn from the
    mix shares, then uniform gaps of ``1/rate`` or, with ``poisson``,
    exponential gaps of that mean, all from one
    ``np.random.default_rng(seed)``."""
    if n < 0:
        raise ValueError(f"n={n} < 0")
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


# The scenarios: ``uniform`` and ``poisson`` reproduce make_schedule
# exactly (same RNG draw order); the others bend the arrival process at
# the same long-run mean rate:
#
#   onoff     - flash crowd: a square wave, ``duty`` of each of
#               ``n_bursts`` periods at ``burst_factor`` x the base rate;
#   lognormal - heavy-tailed gaps, lognormal(sigma) with mean 1/rate;
#   pareto    - heavier still: Pareto(alpha) gaps with mean 1/rate;
#   diurnal   - a sinusoidal rate ramp, ``cycles`` periods across the
#               stream, swinging +-amp around the mean rate.
SCENARIOS = ("uniform", "poisson", "onoff", "lognormal", "pareto",
             "diurnal")
# Scenarios whose gaps are drawn independently: a run's seed may shuffle
# them. The others have a shape in time, which a run's seed only rotates.
IID = ("poisson", "lognormal", "pareto")


def resolve_scenario_params(scenario: str, rate_fps: float,
                            **params) -> dict:
    """The scenario's knobs, validated and defaulted. An unknown scenario
    or knob raises: a typo must not silently run another process."""
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
        sigma = p["sigma"]
        mu = np.log(period) - sigma * sigma / 2.0
        gaps = rng.lognormal(mean=mu, sigma=sigma, size=n)
        return np.cumsum(gaps) - gaps[0]
    if scenario == "pareto":
        # numpy's pareto is the Lomax form; (x+1)*m is Pareto(alpha) with
        # minimum m and mean m*alpha/(alpha-1).
        alpha = p["alpha"]
        m = period * (alpha - 1.0) / alpha
        gaps = (rng.pareto(alpha, size=n) + 1.0) * m
        return np.cumsum(gaps) - gaps[0]
    if scenario == "onoff":
        bf, duty, nb = p["burst_factor"], p["duty"], p["n_bursts"]
        cycle = n * period / nb
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
                           classes: Sequence[TrafficClass], *,
                           seed: int = 0, **params) -> list[Arrival]:
    """``n`` arrivals at a mean of ``rate_fps`` under ``scenario``: a class
    per request drawn from the mix shares, then the scenario's times, all
    from one ``np.random.default_rng(seed)``."""
    if n < 0:
        raise ValueError(f"n={n} < 0")
    p = resolve_scenario_params(scenario, rate_fps, **params)
    rng = np.random.default_rng(seed)
    shares = np.asarray([c.share for c in classes], dtype=np.float64)
    shares = shares / shares.sum()
    which = rng.choice(len(classes), size=n, p=shares)
    times = _scenario_times(n, rate_fps, rng, p)
    return [Arrival(t=float(times[i]), frame_idx=i,
                    klass=classes[int(which[i])]) for i in range(n)]


def classes_of(mix: dict) -> list[TrafficClass]:
    return [TrafficClass(c["name"], int(c.get("priority", 0)),
                         c.get("deadline_ms"), float(c.get("share", 1.0)))
            for c in mix["classes"]]


def open_loop_schedule(mix: dict, seconds: float, seed: int,
                       rate: float | None = None) -> list[Arrival]:
    """A run's arrivals: ``rate * seconds`` requests (``rate`` defaults to
    the mix's ``rate_per_s``) under the mix's ``process`` and ``params``.
    The gaps and classes are drawn once from the mix's own ``gap_seed``;
    the run's ``seed`` shuffles them (a process of independent gaps) or
    rotates them (one with a shape in time), so every seed offers the same
    work in another order. Frame ``i`` of the schedule is frame
    ``i % pool`` of the pool."""
    rate = float(mix["rate_per_s"] if rate is None else rate)
    n = max(2, int(round(rate * seconds)))
    process = mix["process"]
    base = make_scenario_schedule(process, n, rate, classes_of(mix),
                                  seed=mix["gap_seed"],
                                  **mix.get("params", {}))
    gaps = np.diff([a.t for a in base])
    rng = np.random.default_rng(abs(int(seed)))
    if process in IID:
        order = rng.permutation(n)
    else:
        order = np.roll(np.arange(n), -int(rng.integers(n)))
    gaps = gaps[order[order < n - 1]]
    times = np.concatenate([[0.0], np.cumsum(gaps)])
    return [Arrival(t=float(times[i]), frame_idx=i % mix["pool"],
                    klass=base[order[i]].klass) for i in range(n)]
