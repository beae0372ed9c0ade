"""The port's cycle simulator (``repro_torch/core/simulator.py``) and stage
partition (``repro_torch/serving/partition.py``) against the reference's
on the four paper models (AlexNet, VGG16, ZF, YOLO). Both are arithmetic
over the Algorithm 1/2 plan, which the two packages compute identically
(``tests/test_torch_program.py``), so every field must be equal: the
simulated cycles, idle fractions and DSP efficiency, the K-stage
boundaries and per-stage modeled cycles for K in 1..4, and the modeled
GOP. Plan-only programs with the lowering's step list stand in for
compiled ones: the partition reads each step's name and kind only."""

import dataclasses

import pytest

from repro.core import program as prog_j
from repro.core import simulator as sim_j
from repro.core import workload as W
from repro.serving import partition as part_j
from repro_torch.core import program as prog_t
from repro_torch.core import simulator as sim_t
from repro_torch.core import workload as Wt
from repro_torch.serving import partition as part_t

MODELS = ("alexnet", "vgg16", "zf", "yolo")


def _steps(prog, mod):
    """The lowering's step list without its tensors (one step a layer)."""
    steps, hw = [], prog.model.input_hw
    for lyr in prog.model.layers:
        steps.append(mod.EngineStep(name=lyr.name, kind=lyr.kind,
                                    layer=lyr, pad=lyr.padding(hw)))
        hw = lyr.out_hw(hw)
    return steps


def _plans(name, serving):
    """Both packages' plans: the serving convention (8-bit double-pumped
    DSPs, no buffer pass) or Table I's defaults (Algorithm 2 included,
    so row-group sizes K vary)."""
    mj, mt = W.CNN_MODELS[name](), Wt.CNN_MODELS[name]()
    kw = ({"theta": 2 * 900 - len(mj.layers), "bram_total": None}
          if serving else {})
    pj = prog_j.compile_model(mj, **kw)
    pt = prog_t.compile_model(mt, device="cpu", **kw)
    pj = dataclasses.replace(pj, steps=_steps(pj, prog_j))
    pt.steps = _steps(pt, prog_t)
    return pj, pt


@pytest.mark.parametrize("serving", [True, False], ids=["serving", "table1"])
@pytest.mark.parametrize("name", MODELS)
def test_simulate_equals_the_reference(name, serving):
    pj, pt = _plans(name, serving)
    for n_frames in (1, 2, 3):
        want = sim_j.simulate(pj.allocs, n_frames=n_frames)
        got = sim_t.simulate(pt.allocs, n_frames=n_frames)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # The program itself is accepted in place of its allocs.
    assert sim_t.simulate(pt) == sim_t.simulate(pt.allocs)
    assert pt.gop == pj.gop
    assert pt.fps() == pj.fps()


@pytest.mark.parametrize("name", MODELS)
def test_partition_equals_the_reference(name):
    pj, pt = _plans(name, serving=True)
    assert part_t.step_cycles(pt.allocs) == part_j.step_cycles(pj.allocs)
    for k in (1, 2, 3, 4):
        want = part_j.partition_program(pj, k)
        got = part_t.partition_program(pt, k)
        assert got.boundaries == want.boundaries, (name, k)
        assert got.stage_cycles == want.stage_cycles, (name, k)
        assert got.balance == want.balance
        assert got.bottleneck == want.bottleneck
    b = want.boundaries
    assert dataclasses.asdict(part_t.partition_from_boundaries(pt, b)) == \
        dataclasses.asdict(part_j.partition_from_boundaries(pj, b))


def test_steady_state_matches_the_closed_form():
    """The simulator's reason to exist: its steady state is Eq. (4)'s
    ``H_0 * T_rowmax`` cycles, the throughput model's frame cycles."""
    for name in MODELS:
        _, pt = _plans(name, serving=False)
        res = sim_t.simulate(pt.allocs, n_frames=3)
        assert res.steady_cycles == pytest.approx(pt.frame_cycles(),
                                                  rel=0.05), name
        assert res.frame_cycles >= res.steady_cycles
        assert 0.0 < res.dsp_efficiency <= 1.0
