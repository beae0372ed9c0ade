"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the same numpy params and gradients: ``adamw_update``
over three steps with the warmup-stable-decay schedule at float32,
bfloat16 and int8 moments, ``clip_by_global_norm``, ``wsd_schedule`` and
``compress_grads``/``decompress_grads`` with error feedback; and the
reference's own optimizer cases (``tests/test_substrate.py``) on the port.

Tolerances:
* float32 / bfloat16 moments: params and moments within 1e-6 relative
  (both compute each leaf in float32 in the same order; XLA's and torch's
  ``pow``, ``sqrt`` and division may differ in the last bit);
* int8 moments: the codes equal except at most 0.1% that are one apart
  (``log1p``/``expm1`` of the two libraries may differ in the last bit,
  which moves a code sitting on a rounding edge), the block scales within
  1e-6 relative;
* the schedule, the clip and the linear int8 gradient code: 1e-6
  relative; codes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as OJ
from repro_torch import optim as OT

REL = 1e-6
CODE_OFF_SHARE = 1e-3


def _np_params(seed=0):
    """Leaves of several sizes: a matrix, a vector that fills no whole
    128-block, a scalar-ish bias."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "c": {"w": rng.standard_normal((3, 5)).astype(np.float32)}}


def _np_grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return {"a": (rng.standard_normal((64, 32)) * scale).astype(np.float32),
            "b": (rng.standard_normal((300,)) * 1e-3).astype(np.float32),
            "c": {"w": rng.standard_normal((3, 5)).astype(np.float32)}}


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return OT.adamw.tree_map(lambda x: torch.from_numpy(x.copy()), tree)


def _close(got, want, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


PATHS = [("a",), ("b",), ("c", "w")]


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    pj, pt = _jt(_np_params()), _tt(_np_params())
    sj = OJ.adamw_init(pj, moments)
    st = OT.adamw_init(pt, moments)
    lr_j = OJ.wsd_schedule(1e-2, warmup=2, total=3)
    lr_t = OT.wsd_schedule(1e-2, warmup=2, total=3)
    for step in range(3):
        g = _np_grads(step)
        pj, sj = OJ.adamw_update(pj, _jt(g), sj, lr=lr_j,
                                 moment_dtype=moments)
        pt, st = OT.adamw_update(pt, _tt(g), st, lr=lr_t,
                                 moment_dtype=moments)
    assert int(st.step) == int(sj.step) == 3
    for path in PATHS:
        for got, want in ((_leaf(pt, path), _leaf(pj, path)),
                          (_leaf(st.mu, path), _leaf(sj.mu, path)),
                          (_leaf(st.nu, path), _leaf(sj.nu, path))):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            _close(got, want)


def test_adamw_bf16_params_round_as_the_reference():
    """bf16 params: each leaf updated in float32 and cast back."""
    pj = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _np_params())
    pt = OT.adamw.tree_map(lambda x: torch.from_numpy(x).bfloat16(),
                           _np_params())
    sj, st = OJ.adamw_init(pj), OT.adamw_init(pt)
    g = _np_grads(0)
    pj, _ = OJ.adamw_update(pj, _jt(g), sj, lr=1e-2)
    pt, _ = OT.adamw_update(pt, _tt(g), st, lr=1e-2)
    for path in PATHS:
        got = _leaf(pt, path)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(_leaf(pj, path), np.float32))


def int8_code_distances(steps=3) -> dict:
    """Three int8-moment steps: the share of moment codes that differ from
    the reference's, their largest difference, and the params' and scales'
    relative distances."""
    pj, pt = _jt(_np_params()), _tt(_np_params())
    sj, st = OJ.adamw_init(pj, "int8"), OT.adamw_init(pt, "int8")
    for step in range(steps):
        g = _np_grads(step)
        pj, sj = OJ.adamw_update(pj, _jt(g), sj, lr=1e-2,
                                 moment_dtype="int8")
        pt, st = OT.adamw_update(pt, _tt(g), st, lr=1e-2,
                                 moment_dtype="int8")
    off = n = worst = 0
    scale_rel = param_rel = 0.0
    for path in PATHS:
        for mt, mj in ((_leaf(st.mu, path), _leaf(sj.mu, path)),
                       (_leaf(st.nu, path), _leaf(sj.nu, path))):
            d = np.abs(mt["q"].numpy().astype(np.int32)
                       - np.asarray(mj["q"]).astype(np.int32))
            off += int((d > 0).sum())
            n += d.size
            worst = max(worst, int(d.max()))
            np.testing.assert_array_equal(mt["shape"].numpy(),
                                          np.asarray(mj["shape"]))
            sj_ = np.asarray(mj["scale"])
            scale_rel = max(scale_rel, float(np.abs(mt["scale"].numpy() - sj_)
                                             .max() / np.abs(sj_).max()))
        want = np.asarray(_leaf(pj, path))
        param_rel = max(param_rel, float(np.abs(_leaf(pt, path).numpy()
                                                - want).max()
                                         / np.abs(want).max()))
    return {"code_off_share": off / n, "code_max_diff": worst,
            "scale_rel": scale_rel, "param_rel": param_rel}


def test_adamw_int8_moments_match_reference_codes():
    d = int8_code_distances()
    assert d["code_off_share"] <= CODE_OFF_SHARE, d
    assert d["code_max_diff"] <= 1, d
    assert d["scale_rel"] <= REL, d
    assert d["param_rel"] <= REL, d


def test_clip_by_global_norm_matches_reference():
    for scale in (1.0, 100.0):
        g = _np_grads(3, scale)
        cj, gnj = OJ.clip_by_global_norm(_jt(g), 1.0)
        ct, gnt = OT.clip_by_global_norm(_tt(g), 1.0)
        _close(gnt, gnj)
        for path in PATHS:
            _close(_leaf(ct, path), _leaf(cj, path))


def test_wsd_schedule_matches_reference():
    for warmup, total, frac in ((10, 100, 0.1), (1, 7, 0.5), (5, 20, 0.0)):
        lj = OJ.wsd_schedule(3e-4, warmup, total, frac)
        lt = OT.wsd_schedule(3e-4, warmup, total, frac)
        for s in range(total + 2):
            got = lt(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, lj(jnp.asarray(s, jnp.int32)))


def test_compress_grads_with_error_feedback_matches_reference():
    """Two rounds of the linear int8 code with the residual carried: the
    codes equal the reference's, the scales, the decoded gradients and the
    residuals within 1e-6 relative."""
    ej = jax.tree.map(lambda x: jnp.zeros_like(x), _jt(_np_params()))
    et = OT.adamw.tree_map(torch.zeros_like, _tt(_np_params()))
    for step in range(2):
        g = _np_grads(step)
        comp_j, ej = OJ.compress_grads(_jt(g), ej)
        comp_t, et = OT.compress_grads(_tt(g), et)
        dj = OJ.decompress_grads(comp_j, _jt(g))
        dt = OT.decompress_grads(comp_t, _tt(g))
        for path in PATHS:
            cj, ct = _leaf(comp_j, path), _leaf(comp_t, path)
            np.testing.assert_array_equal(ct["q"].numpy(), np.asarray(cj["q"]))
            _close(ct["scale"], cj["scale"])
            _close(_leaf(dt, path), _leaf(dj, path))
            _close(_leaf(et, path), _leaf(ej, path))


# -- the reference's optimizer cases (tests/test_substrate.py) --------------


def _toy_params(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((64, 32), generator=gen), "b": torch.zeros(32)}


def _quad_loss(p, target=None):
    return sum(torch.sum((x - (1.0 if target else 0.0)) ** 2)
               for x in OT.adamw.tree_leaves(p))


def _descend(params, steps, lr, moments, target):
    state = OT.adamw_init(params, moments)
    l0 = float(_quad_loss(params, target))
    for _ in range(steps):
        leaves = [t.requires_grad_() for t in OT.adamw.tree_leaves(params)]
        g = torch.autograd.grad(_quad_loss(params, target), leaves)
        it = iter(g)
        grads = OT.adamw.tree_map(lambda _: next(it), params)
        params, state = OT.adamw_update(params, grads, state, lr=lr,
                                        weight_decay=0.0,
                                        moment_dtype=moments)
    with torch.no_grad():
        return l0, float(_quad_loss(params, target))


def test_adamw_descends_quadratic():
    l0, l1 = _descend(_toy_params(0), 50, 0.05, "float32", target=True)
    assert l1 < l0 * 0.1


def test_adamw_int8_moments_still_descend():
    """int8 blockwise moments are an approximation (bnb-style); the
    contract is that optimization still descends, not bitwise parity."""
    l0, l1 = _descend(_toy_params(1), 30, 0.02, "int8", target=False)
    assert l1 < 0.5 * l0


def test_grad_compression_error_feedback():
    g = {"w": torch.randn(1000, generator=torch.Generator().manual_seed(2))}
    err = {"w": torch.zeros(1000)}
    comp, err = OT.compress_grads(g, err)
    deq = OT.decompress_grads(comp, g)
    rel = float(torch.linalg.norm(deq["w"] - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02  # blockwise int8
    # error feedback: residual carries the lost mass
    assert float(torch.linalg.norm(err["w"])) > 0


def test_clip_by_global_norm():
    g = {"w": torch.full((10,), 100.0)}
    clipped, gn = OT.clip_by_global_norm(g, 1.0)
    assert float(gn) > 1.0
    assert float(torch.linalg.norm(clipped["w"])) <= 1.0 + 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1e-3, 100.0])
def test_clip_in_place_equals_clip(dtype, scale):
    """``clip_by_global_norm_`` writes ``clip_by_global_norm``'s values
    into the tree it was given, bit for bit, and returns the same norm."""
    g = OT.adamw.tree_map(lambda t: t.to(dtype), _tt(_np_grads(7, scale)))
    want, gn_want = OT.clip_by_global_norm(g, 1.0)
    leaves = OT.adamw.tree_leaves(g)
    ptrs = [t.data_ptr() for t in leaves]
    gn = OT.clip_by_global_norm_(g, 1.0)
    assert torch.equal(gn, gn_want)
    for t, p, w in zip(leaves, ptrs, OT.adamw.tree_leaves(want)):
        assert t.data_ptr() == p and t.dtype == dtype
        assert torch.equal(t, w)
    assert float(gn) > 1.0          # the clip did scale


if __name__ == "__main__":
    print(int8_code_distances())
