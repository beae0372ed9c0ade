"""The harness's copy of the schedule generator, and its open-loop
arrivals."""

from __future__ import annotations

import numpy as np
import pytest

from bench.core import spec
from bench.traffic import schedule as S


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
@pytest.mark.parametrize("poisson", [False, True])
def test_schedule_copy_equals_the_programs(seed, poisson):
    from repro_torch.serving import traffic as T
    classes = [S.TrafficClass("a", 1, 50.0, 0.25), S.TrafficClass("b")]
    ours = S.make_schedule(300, 1200.0, classes, seed=seed, poisson=poisson)
    theirs = T.make_schedule(300, 1200.0,
                             [T.TrafficClass("a", 1, 50.0, 0.25),
                              T.TrafficClass("b")], seed=seed,
                             poisson=poisson)
    assert [(a.t, a.frame_idx, a.klass.name) for a in ours] == \
        [(a.t, a.frame_idx, a.klass.name) for a in theirs]


@pytest.mark.parametrize("scenario,params", [
    ("uniform", {}), ("poisson", {}),
    ("onoff", {"burst_factor": 3.0, "duty": 0.3, "n_bursts": 2}),
    ("lognormal", {"sigma": 0.7}), ("pareto", {"alpha": 2.5}),
    ("diurnal", {"amp": 0.5, "cycles": 2})])
def test_scenario_copy_equals_the_programs(scenario, params):
    from repro_torch.serving import traffic as T
    assert S.SCENARIOS == T.SCENARIOS
    for seed in (0, 7, 2 ** 31 + 5):
        ours = S.make_scenario_schedule(
            scenario, 200, 900.0, [S.TrafficClass("a", 1, 50.0, 0.25),
                                   S.TrafficClass("b")], seed=seed, **params)
        theirs, _ = T.make_scenario_schedule(
            scenario, 200, 900.0, [T.TrafficClass("a", 1, 50.0, 0.25),
                                   T.TrafficClass("b")], seed=seed, **params)
        assert [(a.t, a.frame_idx, a.klass.name) for a in ours] == \
            [(a.t, a.frame_idx, a.klass.name) for a in theirs]


@pytest.mark.parametrize("mix", [
    {"process": "bogus"}, {"process": "onoff", "params": {"burst": 2.0}}])
def test_an_unknown_process_or_knob_raises(mix):
    base = spec.traffic("frontend-poisson-320")
    with pytest.raises(ValueError):
        S.open_loop_schedule(dict(base, **mix), 1.0, 1)


@pytest.mark.parametrize("process,params", [
    ("poisson", {}), ("onoff", {"burst_factor": 4.0, "duty": 0.25,
                                "n_bursts": 4})])
def test_open_loop_seeds_reorder_the_same_arrivals(process, params):
    mix = dict(spec.traffic("frontend-poisson-320"), process=process,
               params=params)
    a = S.open_loop_schedule(mix, 2.0, 1)
    b = S.open_loop_schedule(mix, 2.0, 2 ** 31 + 3)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 2.0)
    ga, gb = np.diff([x.t for x in a]), np.diff([x.t for x in b])
    assert not np.array_equal(ga, gb)
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=0,
                               atol=1e-12)
    assert a[-1].t == pytest.approx(b[-1].t, rel=1e-12)
    assert [x.frame_idx for x in a] == [i % mix["pool"]
                                        for i in range(len(a))]


def test_a_shaped_process_is_rotated_not_shuffled():
    """An on-off schedule keeps its bursts under every seed: the gaps are
    the base schedule's, rotated."""
    mix = dict(spec.traffic("frontend-poisson-320"), process="onoff",
               params={"burst_factor": 4.0, "duty": 0.25, "n_bursts": 4})
    base = np.diff([x.t for x in S.open_loop_schedule(mix, 2.0, 0)])
    gaps = np.diff([x.t for x in S.open_loop_schedule(mix, 2.0, 99)])
    k = next(k for k in range(len(base))
             if np.allclose(np.roll(base, -k), gaps, rtol=0, atol=1e-9))
    assert k > 0
