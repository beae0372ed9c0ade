"""One whole ``make_train_step`` per LM family against the reference's
jitted ``make_train_step`` (float32, lr 1e-3 constant, the configs'
moment dtypes: int8 for DeepSeek), from the same weights and batch
(``tests/test_torch_train.py``'s helpers).

Tolerances:
* loss: rtol 1e-5; grad_norm: rtol 1e-4;
* params within 1e-5, except a share of at most 0.1% of all elements,
  each within 2 lr: at step 1 Adam moves an element by
  g / (|g| + eps) * lr, and where |g| is near eps or rounding noise the
  two packages' moves may differ by up to 2 lr.
``PYTHONPATH=src:tests python tests/test_torch_train_step.py`` prints the
measured distances.
"""

import jax
import numpy as np
import pytest

from repro import optim as optim_j
from repro.launch import steps as steps_j
from repro_torch import optim as optim_t
from repro_torch.launch import steps as steps_t
from repro_torch.models import transformer as TT
from test_torch_train import (FAMILY_REPS, GRAD_TOL, LOSS_RTOL, _batch,
                              _both, _j, _pairs, _t)

PARAM_TOL = 1e-5
FLIP_SHARE = 1e-3
LR = 1e-3


def step_distances(arch) -> dict:
    """One ``make_train_step`` in both packages from the same float32
    weights and batch: the metrics, and per leaf the share of elements
    more than 1e-5 apart and the largest difference."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    batch = _batch(cfg_t)
    step_j = jax.jit(steps_j.make_train_step(cfg_j, lr=LR, remat=False))
    oj = optim_j.adamw_init(pj, cfg_j.opt_moment_dtype)
    pj2, _, mj = step_j(pj, oj, _j(batch))
    step_t = steps_t.make_train_step(cfg_t, lr=LR, remat=False)
    ot = optim_t.adamw_init(pt, cfg_t.opt_moment_dtype)
    pt2, ot2, mt = step_t(pt, ot, _t(batch))
    want = TT.params_from_numpy(jax.tree.map(np.asarray, pj2), "cpu")
    off, worst, n = 0, 0.0, 0
    for p, w in _pairs(pt2, want):
        diff = (p.detach() - w).abs()
        off += int((diff > PARAM_TOL).sum())
        n += diff.numel()
        worst = max(worst, float(diff.max()))
    return {"loss": float(mt["loss"]), "loss_ref": float(mj["loss"]),
            "grad_norm": float(mt["grad_norm"]),
            "grad_norm_ref": float(mj["grad_norm"]),
            "step": int(ot2.step), "off_share": off / n,
            "max_param_diff": worst}


@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_train_step_matches_reference(arch):
    d = step_distances(arch)
    np.testing.assert_allclose(d["loss"], d["loss_ref"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(d["grad_norm"], d["grad_norm_ref"],
                               rtol=GRAD_TOL)
    assert d["step"] == 1
    assert d["off_share"] <= FLIP_SHARE, d
    assert d["max_param_diff"] <= 2 * LR + PARAM_TOL, d


def measure() -> dict:
    return {arch: step_distances(arch) for arch in FAMILY_REPS}


if __name__ == "__main__":
    for arch, d in measure().items():
        print(arch, {k: f"{v:.3g}" for k, v in d.items()})
