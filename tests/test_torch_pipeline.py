"""The pure parts of the port's pipeline (``core/pipeline.py``) against the
reference's ``repro/core/pipeline.py``: stage stacking at Algorithm-1
boundaries, uniform boundaries, each unit leaf's tp-split dim for the ten
full-width configs, which configs pipeline, the reference's params carried
across, and the port's own parameter build (its seeding, its one-rank
parts). The pipeline across ranks is ``test_torch_pipeline_gloo.py``'s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, reduced as ref_reduced
from repro.core import pipeline as RPL
from repro.models import transformer as RTF
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import pipeline as PL
from repro_torch.models import transformer as T

# The dominant segment's kind of each config, from the port's segments.
DOMINANT = {"yi-6b": "attn", "qwen3-1.7b": "attn", "granite-34b": "attn",
            "qwen2-72b": "attn", "qwen2-vl-2b": "attn",
            "seamless-m4t-medium": "attn", "deepseek-v2-236b": "mla_moe",
            "deepseek-v3-671b": "mla_moe", "rwkv6-7b": "rwkv",
            "recurrentgemma-2b": "rglru"}


def test_stage_stack_nonuniform_boundaries():
    """``tests/test_allocator.py::test_stage_stack_nonuniform_boundaries``'s
    case: 7 units at boundaries (0, 3, 4, 7) give 3 stages of 3 slots, the
    middle stage one unit and two masked slots holding it; the slots equal
    the reference's stacked rows."""
    units = [{"w": torch.full((3,), float(i))} for i in range(7)]
    staged, mask = PL.stage_stack(units, (0, 3, 4, 7))
    assert [len(row) for row in staged] == [3, 3, 3]
    assert mask.tolist() == [[True, True, True], [True, False, False],
                             [True, True, True]]
    assert torch.equal(staged[1][0]["w"], torch.full((3,), 3.0))
    assert staged[1][1] is staged[1][0] and staged[1][2] is staged[1][0]
    ref, ref_mask = RPL.stage_stack(
        {"w": jnp.arange(7.0)[:, None] * jnp.ones((7, 3))}, (0, 3, 4, 7))
    np.testing.assert_array_equal(np.asarray(ref_mask), mask.numpy())
    got = np.stack([np.stack([u["w"].numpy() for u in row])
                    for row in staged])
    np.testing.assert_array_equal(np.asarray(ref["w"]), got)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16])
def test_uniform_boundaries_match_reference(S):
    for n in range(S, 80):
        assert PL.uniform_boundaries(n, S) == RPL.uniform_boundaries(n, S)


def _ref_unit_shapes(cfg, kind):
    """The reference's one unit of ``kind`` as shapes: {path: shape}."""
    tree = jax.eval_shape(lambda k: RTF._layer_init(
        kind, cfg, k, jnp.dtype(cfg.dtype)), jax.random.PRNGKey(0))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_dims_match_reference(arch):
    """Each leaf of each unit kind of the full-width config: the port's
    tp-split dim of the unit leaf is the reference's dim of its [S, Lmax,
    ...] leaf less two, at T 1, 2, 4, 8 and 16, before and after the
    divisibility rule (``_unit_specs``); the unit trees' paths agree."""
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    for kind in sorted({seg.kind for seg in T.segments(cfg)}):
        unit = T._layer_init(kind, cfg, None, torch.float32, "meta")
        shapes = dict(PL._paths(unit))
        ref_shapes = _ref_unit_shapes(ref_cfg, kind)
        assert sorted(shapes) == sorted(ref_shapes), kind
        for tp in (1, 2, 4, 8, 16):
            dims = PL.unit_tp_dims(cfg, tp, unit)
            for path, leaf in shapes.items():
                shape = tuple(leaf.shape)
                assert shape == tuple(ref_shapes[path]), (kind, path)
                ref_d = RPL._tp_dim_for(path, len(shape) + 2, ref_cfg, tp,
                                        (2, 2) + shape)
                got = PL._tp_dim_for(path, len(shape), cfg, tp)
                assert (got is None and ref_d is None) or got + 2 == ref_d, \
                    (kind, path, tp, got, ref_d)
                split = ref_d is not None and shape[ref_d - 2] % tp == 0
                assert dims[path] == (ref_d - 2 if split else None), \
                    (kind, path, tp)


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                         if DOMINANT[a] != "rglru"))
def test_unit_specs_match_reference(arch):
    """For the configs that pipeline, the reference's ``_unit_specs`` over
    its stacked abstract units names ``tp`` on exactly the dim the port
    splits (at the reference dry run's T 2, 4 and 16)."""
    ref_cfg = REF_ARCHS[arch]
    params, kind = RPL.build_pipeline_params(ref_cfg, 2, abstract=True)
    unit = T._layer_init(kind, ARCHS[arch], None, torch.float32, "meta")
    for tp in (2, 4, 16):
        specs = RPL._unit_specs(ref_cfg, tp, params["units"])
        ref = {"/".join(str(getattr(k, "key", k)) for k in path): spec
               for path, spec in jax.tree_util.tree_leaves_with_path(
                   specs, is_leaf=lambda x: isinstance(
                       x, jax.sharding.PartitionSpec))}
        dims = PL.unit_tp_dims(ARCHS[arch], tp, unit)
        assert sorted(ref) == sorted(dims)
        for path, spec in ref.items():
            want = (list(spec).index("tp") - 2) if "tp" in spec else None
            assert dims[path] == want, (arch, path, tp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_supports_pipeline_matches_reference(arch):
    """The dominant segment (kind, start, count) and whether the config
    pipelines are the reference's for all ten configs; RecurrentGemma-2B's
    dominant segment is two ``rglru`` layers, which the pipeline does not
    take."""
    seg, ref_seg = (PL.dominant_segment(ARCHS[arch]),
                    RPL.dominant_segment(REF_ARCHS[arch]))
    assert (seg.kind, seg.start, seg.count) == \
        (ref_seg.kind, ref_seg.start, ref_seg.count)
    assert seg.kind == DOMINANT[arch]
    assert PL.supports_pipeline(ARCHS[arch]) == \
        RPL.supports_pipeline(REF_ARCHS[arch]) == (arch != "recurrentgemma-2b")
    if arch == "recurrentgemma-2b":
        assert seg.count == 2
        with pytest.raises(ValueError, match="rglru"):
            PL.build_pipeline_params(ARCHS[arch], 2, abstract=True)


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-236b", "rwkv6-7b"])
def test_params_from_numpy_carry_the_references(arch):
    """The reference's ``build_pipeline_params`` (its bf16 reduced config at
    boundaries (0, 2, 3) for DeepSeek-V2's three units, (0, 3, 4) else)
    carried across: every real slot's leaves equal the reference's [s, j]
    rows bit for bit, a padded slot is its stage's last unit's dict, the
    mask and the other leaves equal."""
    cfg = ref_reduced(REF_ARCHS[arch]).scaled(n_layers=4, vocab=128)
    n = RPL.dominant_segment(cfg).count
    bounds = (0, n - 1, n)
    ref, _ = RPL.build_pipeline_params(cfg, 2, bounds)
    tree = jax.tree.map(np.asarray, ref)
    got = PL.pipeline_params_from_numpy(tree, device="cpu")
    mask = np.asarray(tree["unit_mask"])
    assert got["unit_mask"].tolist() == mask.tolist()
    for s, row in enumerate(got["units"]):
        for j, unit in enumerate(row):
            if not mask[s, j]:
                assert unit is row[j - 1]
                continue
            for path, leaf in PL._paths(unit):
                want = tree["units"]
                for k in path.split("/"):
                    want = want[k]
                want = want[s, j]
                assert str(leaf.dtype).split(".")[1] == str(want.dtype)
                np.testing.assert_array_equal(
                    leaf.float().numpy(), np.asarray(want, np.float32))
    for key, sub in (("embed", None), ("final_norm", "scale"),
                     ("lm_head", "w")):
        a, b = (got[key], tree[key]) if sub is None else \
            (got[key][sub], tree[key][sub])
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert set(got) == set(tree)


def test_build_pipeline_params_layout_and_seeding():
    """The port's build: the dominant segment's units only (DeepSeek-V2's
    leading MLA layer left out), S lists of Lmax dicts with the padded slot
    its stage's last unit, the reference's keys; the same seed draws the
    same weights, another seed others; ``abstract`` builds on ``meta``; a
    rank's own build (``coords``) equals its part of the whole build."""
    cfg = reduced(ARCHS["deepseek-v2-236b"]).scaled(n_layers=4, vocab=128,
                                                    dtype="float32")
    full, kind = PL.build_pipeline_params(cfg, 2, seed=3, device="cpu")
    assert kind == "mla_moe" and set(full) == {
        "embed", "units", "unit_mask", "final_norm", "lm_head"}
    assert full["unit_mask"].tolist() == [[True, True], [True, False]]
    assert full["units"][1][1] is full["units"][1][0]
    again, _ = PL.build_pipeline_params(cfg, 2, seed=3, device="cpu")
    other, _ = PL.build_pipeline_params(cfg, 2, seed=4, device="cpu")
    a, b, c = (full["units"][0][1]["attn"]["wkv_b"]["w"],
               again["units"][0][1]["attn"]["wkv_b"]["w"],
               other["units"][0][1]["attn"]["wkv_b"]["w"])
    assert torch.equal(a, b) and not torch.equal(a, c)
    meta, _ = PL.build_pipeline_params(cfg, 2, abstract=True)
    assert meta["embed"].device.type == "meta"
    for stage in (0, 1):
        for tp in (0, 1):
            pm = PL.PipelineCoords(stage=stage, S=2, tp=tp, T=2)
            mine, _ = PL.build_pipeline_params(cfg, 2, seed=3, device="cpu",
                                               coords=pm)
            want = PL.shard_pipeline_params(full, cfg, pm)
            assert set(mine) == set(want)
            assert mine["units"][-1] is mine["units"][0] or stage == 0
            for u, w in zip(mine["units"], want["units"]):
                for (p1, t1), (p2, t2) in zip(PL._paths(u), PL._paths(w)):
                    assert p1 == p2 and torch.equal(t1, t2), p1
            assert torch.equal(mine["embed"], want["embed"])
            assert mine["embed"].shape == (32, cfg.d_model)
            assert mine["units"][0]["mlp"]["wi"].shape[0] == \
                cfg.moe_n_experts // 2


def test_entry_points_need_a_card_unless_asked():
    """``device=None`` means the card, as every entry point of the port:
    without one the build and the carry-across raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(ARCHS["yi-6b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.build_pipeline_params(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.pipeline_params_from_numpy({"embed": np.zeros((2, 2)),
                                       "units": {"w": np.zeros((1, 1, 2))}})
