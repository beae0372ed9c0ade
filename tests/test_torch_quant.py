"""The port's fixed-point helpers (``repro_torch.core.quant``) against the
reference's (``repro.core.quant``) on edge grids: int32 rails, every
shift in -31..31, and round-half-to-even ties. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as qj
from repro_torch.core import quant as qt

I32 = np.iinfo(np.int32)


def _acc_grid() -> np.ndarray:
    """int32 accumulators at and near the rails, around every power of
    two, and a random spread."""
    pows = np.array([2 ** k for k in range(31)], np.int64)
    vals = np.concatenate([
        [I32.min, I32.min + 1, I32.max - 1, I32.max, 0, 1, -1],
        pows, pows - 1, pows + 1, -pows, -pows - 1, -pows + 1,
        np.random.default_rng(0).integers(I32.min, I32.max, 200,
                                          dtype=np.int64)])
    return np.clip(vals, I32.min, I32.max).astype(np.int32)


def test_round_half_to_even_in_all_three():
    ties = np.arange(-8, 8, dtype=np.float32) + np.float32(0.5)
    want = np.rint(ties)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(ties))),
                                  want)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(ties)).numpy(),
                                  want)
    # Half to even, not away from zero: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2.
    np.testing.assert_array_equal(want[8:11], [0, 2, 2])


def test_saturating_signed_shift_bit_identical():
    acc = _acc_grid()[:, None]
    sh = np.arange(-31, 32, dtype=np.int32)[None, :]
    want = np.asarray(qj.saturating_signed_shift(jnp.asarray(acc),
                                                 jnp.asarray(sh)))
    got = qt.saturating_signed_shift(torch.from_numpy(acc),
                                     torch.from_numpy(sh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 16])
def test_requantize_output_bit_identical(bits):
    acc = _acc_grid()[:, None]
    e_out = np.arange(-31, 32, dtype=np.int32)[None, :]
    want = np.asarray(qj.requantize_output(jnp.asarray(acc), 0,
                                           jnp.asarray(e_out), bits))
    got = qt.requantize_output(torch.from_numpy(acc), 0,
                               torch.from_numpy(e_out), bits)
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("e", [-6, -1, 0, 3])
def test_quantize_to_exponent_and_np_twin(bits, e):
    qmax = 2 ** (bits - 1) - 1
    # Every tie k + 0.5 across the rails, and a random float spread.
    ties = (np.arange(-qmax - 3, qmax + 3) + 0.5).astype(np.float32)
    rand = np.random.default_rng(e + bits).standard_normal(500).astype(
        np.float32) * qmax
    x = np.concatenate([ties, rand, [0.0, -0.0, 1e30, -1e30]]).astype(
        np.float32) * np.float32(2.0 ** e)
    want = np.asarray(qj.quantize_to_exponent(jnp.asarray(x), e, bits))
    got = qt.quantize_to_exponent(torch.from_numpy(x), e, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(qt.quantize_to_exponent_np(x, e, bits),
                                  want)
    np.testing.assert_array_equal(qj.quantize_to_exponent_np(x, e, bits),
                                  want)


def test_po2_scale_and_exponent_bit_identical():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 3, 4, 16)) *
         np.exp2(rng.integers(-12, 4, 16))).astype(np.float32)
    w[..., 0] = 0.0                       # dead channel: the 1e-12 floor
    for axis in (-1, 0):
        want = np.asarray(qj.po2_scale(jnp.asarray(w), axis))
        got = qt.po2_scale(torch.from_numpy(w), axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    one_d = rng.standard_normal(9).astype(np.float32)
    np.testing.assert_array_equal(
        qt.po2_scale(torch.from_numpy(one_d), 0).numpy(),
        np.asarray(qj.po2_scale(jnp.asarray(one_d), 0)))
    for amax in [0.0, 1e-12, 0.3, 1.0, 127.0, 128.0, 1000.0, 3.5e7]:
        for bits in (8, 16):
            assert qt.po2_exponent(amax, bits) == qj.po2_exponent(amax, bits)



@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_and_dequantize_po2_bit_identical(bits, axis):
    """``quantize_po2`` / ``dequantize_po2`` against the reference's, with
    channel scales whose exponents reach past +-13, where the reference's
    float32 ``exp2`` leaves the exact power of two."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((5, 3, 3, 12)) *
         np.exp2(rng.integers(-20, 8, 12))).astype(np.float32)
    if axis == 0:
        x = np.moveaxis(x, -1, 0).copy()
    q_want, e_want = qj.quantize_po2(jnp.asarray(x), axis, bits)
    q_got, e_got = qt.quantize_po2(torch.from_numpy(x), axis, bits)
    assert q_got.dtype == (torch.int8 if bits == 8 else torch.int16)
    np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want))
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    assert np.abs(np.asarray(e_want)).max() >= 13
    np.testing.assert_array_equal(
        qt.dequantize_po2(q_got, e_got, axis).numpy(),
        np.asarray(qj.dequantize_po2(q_want, e_want, axis)))


def test_align_partial_sums_bit_identical():
    rng = np.random.default_rng(3)
    psum = rng.integers(-2 ** 20, 2 ** 20, (4, 6, 8)).astype(np.int32)
    e_in = rng.integers(-8, 8, 8).astype(np.int32)
    e_common = np.int32(-2)
    for axis, e in ((-1, e_in), (1, e_in[:6])):
        want = np.asarray(qj.align_partial_sums(
            jnp.asarray(psum), jnp.asarray(e), jnp.asarray(e_common), axis))
        got = qt.align_partial_sums(torch.from_numpy(psum),
                                    torch.from_numpy(e),
                                    torch.tensor(e_common), axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
