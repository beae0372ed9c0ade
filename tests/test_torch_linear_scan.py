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
