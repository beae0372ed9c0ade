"""The port's ``linear_scan`` (its plain version on CPU tensors) against
the reference's Pallas kernel in interpret mode and its
``linear_scan_ref``, on the same numpy inputs, at the tolerance
``tests/test_kernels.py`` states: rtol 2e-5 / atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ref as ref_j
from repro.kernels.rglru_scan.ops import rglru_scan as rglru_scan_j
from repro_torch.kernels.rglru_scan import ref as ref_t
from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.kernels.rglru_scan.ops import rglru_scan as rglru_scan_t

TOL = dict(rtol=2e-5, atol=2e-5)


def _ab(seed, B, S, D, lo=0.7, hi=0.999):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,D,chunk", [(1, 64, 8, 16), (2, 128, 32, 64),
                                         (3, 96, 16, 32), (1, 256, 128, 256)])
def test_matches_reference_kernel_and_ref(B, S, D, chunk):
    """The reference test's four shapes; the Pallas chunk is TPU tiling
    the port does not take."""
    a, b = _ab(B * S * D, B, S, D)
    got = rglru_scan_t(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    for want in (rglru_scan_j(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                              interpret=True),
                 ref_j.linear_scan_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_length():
    """S = 77 is a multiple of no chunk: the reference's kernel cannot
    take it (S % chunk), its ``linear_scan_ref`` and the port can."""
    a, b = _ab(5, 2, 77, 24)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = ref_j.linear_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_h0_fold_equals_initial_state():
    """A carry folded in as a virtual step 0 (a = 1, b = h0), as the
    RG-LRU's ``rglru_scan`` does, gives ``linear_scan_ref(a, b, h0)``."""
    a, b = _ab(6, 2, 40, 16)
    h0 = np.random.default_rng(7).standard_normal((2, 16)).astype(np.float32)
    af = np.concatenate([np.ones_like(a[:, :1]), a], axis=1)
    bf = np.concatenate([h0[:, None], b], axis=1)
    got = linear_scan(torch.from_numpy(af), torch.from_numpy(bf))[:, 1:]
    for want in (ref_j.linear_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0)),
                 ref_t.linear_scan_ref(*map(torch.from_numpy, (a, b, h0)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_long_sequence_near_one_decay():
    """S = 4096 with a in (0.99, 0.9999): h grows to about 70 and the
    rounding of 4096 steps accumulates; the plain version still matches
    the reference's float32 loop at the reference's tolerance."""
    a, b = _ab(8, 1, 4096, 8, 0.99, 0.9999)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = ref_j.linear_scan_ref(jnp.asarray(a), jnp.asarray(b))
    assert np.abs(np.asarray(want)).max() > 20
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_output_takes_b_dtype():
    """fp32 inside, b's dtype out, as the reference kernel's out_shape."""
    a, b = _ab(9, 1, 32, 8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b).to(torch.bfloat16)
    got = linear_scan(at, bt)
    assert got.dtype == torch.bfloat16
    want = ref_t.linear_scan_ref(at, bt.float()).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_validates_before_dispatch():
    a, b = (torch.from_numpy(x) for x in _ab(10, 2, 16, 8))
    before = linear_scan.launches
    with pytest.raises(ValueError, match="one shape"):
        linear_scan(a, b[:, :8])
    with pytest.raises(ValueError, match="one shape"):
        linear_scan(a[0], b[0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        linear_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        linear_scan(a, b.half())
    with pytest.raises(ValueError, match="cuda or cpu"):
        linear_scan(a.to("meta"), b.to("meta"))
    # CPU tensors run the plain version and launch nothing.
    torch.testing.assert_close(linear_scan(a, b), ref_t.linear_scan_ref(a, b))
    assert linear_scan.launches == before


# ---------------------------------------------------------------------------
# The gradient: the reversed scan against autograd through the plain version
# ---------------------------------------------------------------------------


def _grads(fn, a, b, dh):
    a = a.clone().requires_grad_()
    b = b.clone().requires_grad_()
    h = fn(a, b)
    da, db = torch.autograd.grad(h, (a, b), dh)
    return h.detach(), da, db


@pytest.mark.parametrize("B,S,D", [(1, 1, 8), (2, 37, 5), (3, 96, 16),
                                   (1, 257, 33), (2, 1024, 8)])
def test_backward_equals_autograd_through_the_plain_version(B, S, D):
    """``linear_scan``'s gradient (the same scan over reversed time, then
    da = g * h_prev) equals autograd through ``linear_scan_ref`` exactly:
    each step rounds the product, then the sum, in both."""
    a, b = (torch.from_numpy(x) for x in _ab(B * S + D, B, S, D))
    dh = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, S, D)).astype(np.float32))
    before = dict(linear_scan.launches_by_path)
    got = _grads(linear_scan, a, b, dh)
    want = _grads(ref_t.linear_scan_ref, a, b, dh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert linear_scan.launches_by_path == before    # the CPU launches none


def test_backward_with_the_h0_fold():
    """The RG-LRU's carry folded in as step 0 (``models.recurrent
    .rglru_scan``'s ``cat``) differentiates through the fold: the grads of
    a, b and h0 equal autograd through ``linear_scan_ref(a, b, h0)``."""
    a, b = (torch.from_numpy(x) for x in _ab(11, 2, 40, 16))
    h0 = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 16)).astype(np.float32))
    dh = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 40, 16)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    af = torch.cat([torch.ones_like(leaves[0][:, :1]), leaves[0]], 1)
    bf = torch.cat([leaves[2][:, None], leaves[1]], 1)
    got = torch.autograd.grad(linear_scan(af, bf)[:, 1:], leaves, dh)
    leaves2 = [t.clone().requires_grad_() for t in (a, b, h0)]
    want = torch.autograd.grad(ref_t.linear_scan_ref(*leaves2), leaves2, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_backward_returns_the_operands_dtypes():
    """bf16 a and b: grads in bf16, each the rounding of the float32
    gradient through the plain version (the forward keeps h in float32
    for the backward, as autograd through the plain version does)."""
    a, b = (torch.from_numpy(x) for x in _ab(14, 2, 50, 8))
    a16, b16 = a.bfloat16(), b.bfloat16()
    dh = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 50, 8)).astype(np.float32)).bfloat16()
    h, da, db = _grads(linear_scan, a16, b16, dh)
    assert (h.dtype, da.dtype, db.dtype) == (torch.bfloat16,) * 3
    _, da_w, db_w = _grads(ref_t.linear_scan_ref, a16, b16, dh.float())
    torch.testing.assert_close(da, da_w.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(db, db_w.bfloat16(), rtol=0, atol=0)
    # Only the operand that requires grad gets one.
    bb = b.clone().requires_grad_()
    (gb,) = torch.autograd.grad(linear_scan(a, bb).sum(), (bb,))
    assert gb.shape == b.shape


def test_rglru_scan_differentiates_through_the_kernel_wrapper():
    """``models.recurrent.rglru_scan`` (gates, the h0 fold, the scan): the
    gradients of its parameters and inputs through ``linear_scan`` equal
    those through the plain version."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import recurrent as R

    cfg = reduced(ARCHS["recurrentgemma-2b"])
    gen = torch.Generator().manual_seed(0)
    p = R.rglru_block_init(gen, cfg, torch.float32, "cpu")
    rec = {k: p[k] for k in ("w_input_gate", "w_rec_gate", "lam")}
    xr = torch.randn((2, 24, cfg.lru_width), generator=gen)
    h0 = torch.randn((2, cfg.lru_width), generator=gen)

    def grads(scan):
        R.linear_scan = scan
        try:
            leaves = [rec["w_input_gate"]["w"], rec["w_rec_gate"]["w"],
                      rec["lam"], xr, h0]
            for t in leaves:
                t.requires_grad_()
            y, h_last = R.rglru_scan(rec, xr, h0)
            return torch.autograd.grad((y.sum() + h_last.square().sum()),
                                       leaves)
        finally:
            R.linear_scan = linear_scan

    for g, w in zip(grads(linear_scan),
                    grads(lambda a, b: ref_t.linear_scan_ref(a, b)
                          .to(b.dtype))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
