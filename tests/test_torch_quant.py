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


def _quantize_in_frames(bits, e, dtype, n, frame=(4, 5, 3)):
    """``n`` frames on the format 2^e, each carrying the edges (ties
    +-0.5, +-1.5, +-2.5, values at and beyond +-qmax, +-inf, +-0.0) beside
    a random spread, which in float64 is not float32."""
    qmax = 2 ** (bits - 1) - 1
    edges = np.array([0.0, 0.5, 1.5, 2.5, qmax, qmax + 0.5, qmax + 1,
                      qmax + 1.5, qmax + 2, 10 * qmax, np.inf])
    rng = np.random.default_rng(100 * bits + e)
    x = rng.standard_normal((n, int(np.prod(frame)))) * (qmax / 2)
    x[:, :2 * len(edges)] = np.concatenate([edges, -edges])
    return (x * 2.0 ** e).astype(dtype).reshape((n,) + frame)


# 360 KB float32 frames: a chunk holds two, so the walk takes several
# chunks, and of a longer scratch it uses one chunk.
WIDE = (300, 300, 1)


@pytest.mark.parametrize("form", ["array", "list"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("e", [-7, 0, 3])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_into_out_equals_the_allocating_form(bits, e, dtype, form):
    """The ``out=`` form writes the allocating form's bits into the batch
    buffer and zeroes the rows past the frames, over stale data, in chunks
    of two frames through its own scratch, a reused one or a whole-batch
    one (7 and 9 frames into 9 rows)."""
    batch = 9
    assert qt.scratch_frames(WIDE) == 2
    scratches = (None, qt.quantize_scratch((batch,) + WIDE),
                 np.empty((batch,) + WIDE, np.float32))
    for n in (7, batch):
        x = _quantize_in_frames(bits, e, dtype, n, WIDE)
        want = qt.quantize_to_exponent_np(x, e, bits)
        src = x if form == "array" else list(x)
        for scratch in scratches:
            out = np.full((batch,) + WIDE, 77, want.dtype)
            assert qt.quantize_to_exponent_np(src, e, bits, out=out,
                                              scratch=scratch) is out
            np.testing.assert_array_equal(out[:n], want)
            assert not out[n:].any()


def test_quantize_into_out_takes_frames_torch_cannot_view():
    """Flipped (negative-stride), strided and read-only frames quantize
    as their copies do."""
    x = _quantize_in_frames(8, -2, np.float32, 4, WIDE)
    ro = x[3].copy()
    ro.flags.writeable = False
    frames = [x[0][:, ::-1], x[1][::-1], np.repeat(x[2], 2, 1)[:, ::2], ro]
    want = qt.quantize_to_exponent_np(
        np.stack([np.ascontiguousarray(f) for f in frames]), -2, 8)
    out = np.full((5,) + WIDE, 77, np.int8)
    scratch = qt.quantize_scratch(out.shape)
    qt.quantize_to_exponent_np(frames, -2, 8, out=out, scratch=scratch)
    np.testing.assert_array_equal(out[:4], want)
    qt.quantize_to_exponent_np(x[:, ::-1], -2, 8, out=out, scratch=scratch)
    np.testing.assert_array_equal(
        out[:4], qt.quantize_to_exponent_np(x[:, ::-1].copy(), -2, 8))
    assert not out[4:].any()


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_into_out_refuses_what_it_would_cast(bits):
    """An ``out`` of another dtype or frame shape, more frames than rows, a
    lone frame, or a scratch of another dtype or frame shape, is refused
    with nothing written."""
    x = _quantize_in_frames(bits, 0, np.float32, 3)
    good = np.int8 if bits == 8 else np.int16
    other = np.int16 if bits == 8 else np.int8
    cases = [(x, np.full((4, 4, 5, 3), 5, other), None),
             (x, np.full((4, 4, 5, 3), 5, np.int32), None),
             (x, np.full((4, 5, 4, 3), 5, good), None),
             (list(x), np.full((4, 4, 5, 2), 5, good), None),
             (x, np.full((2, 4, 5, 3), 5, good), None),
             (x[0], np.full((4, 4, 5, 3), 5, good), None),
             (x, np.full((4, 4, 5, 3), 5, good),
              np.empty((4, 4, 5, 3), np.float64)),
             (x, np.full((4, 4, 5, 3), 5, good),
              np.empty((4, 4, 4, 3), np.float32))]
    for src, out, scratch in cases:
        with pytest.raises(ValueError):
            qt.quantize_to_exponent_np(src, 0, bits, out=out,
                                       scratch=scratch)
        assert (out == 5).all()


@pytest.mark.parametrize("batch, frames", [
    ((16, 227, 227, 3), 1),         # AlexNet: 618 KB a frame
    ((16, 224, 224, 3), 1),         # VGG16: 602 KB
    ((16, 28, 28, 1), 16),          # LeNet: the whole batch
    ((4,) + WIDE, 2),               # 360 KB: two frames a chunk
])
def test_quantize_scratch_holds_whole_frames_within_a_mebibyte(batch,
                                                               frames):
    s = qt.quantize_scratch(batch)
    assert s.dtype == np.float32 and s.shape == (frames,) + batch[1:]
    assert s.nbytes <= qt.SCRATCH_BYTES or frames == 1
