"""The port's ``gemm_int8`` / ``conv2d_int8`` / ``fc_int8`` against the
reference's Pallas kernel (interpret mode) on the same numpy inputs. On CPU
tensors the port runs the kernel's plain version; the CUDA kernel itself is
held against that plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_int8 import ops as ops_j
from repro.kernels.conv2d_int8.kernel import gemm_int8 as gemm_j
from repro_torch.kernels.conv2d_int8 import ops as ops_t
from repro_torch.kernels.conv2d_int8 import ref as ref_t
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8 as gemm_t


def _gemm_inputs(n, k, m, seed, shift_lo=0, shift_hi=12):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, k), dtype=np.int64).astype(np.int8)
    w = rng.integers(-128, 128, (k, m), dtype=np.int64).astype(np.int8)
    shift = rng.integers(shift_lo, shift_hi + 1, m).astype(np.int32)
    bias = rng.integers(-2 ** 20, 2 ** 20, m).astype(np.int32)
    return x, w, shift, bias


def _both_gemm(x, w, shift, bias, **kw):
    want = np.asarray(gemm_j(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(shift),
                             None if bias is None else jnp.asarray(bias),
                             interpret=True, **kw))
    got = gemm_t(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(shift),
                 None if bias is None else torch.from_numpy(bias), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("n,k,m", [(17, 40, 33), (128, 128, 128),
                                   (300, 100, 260), (1, 9, 1)])
def test_gemm_int8_shapes(n, k, m):
    x, w, shift, _ = _gemm_inputs(n, k, m, n * k + m)
    got, want = _both_gemm(x, w, shift, None)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("emit_int32", [False, True])
def test_gemm_int8_epilogue_signed_shifts_bias(relu, emit_int32):
    # Shifts over all of -31..31 (negative = saturating left shift).
    x, w, shift, bias = _gemm_inputs(40, 70, 63, 5, -31, 31)
    shift = np.arange(-31, 32, dtype=np.int32)
    got, want = _both_gemm(x, w, shift, bias, relu=relu,
                           emit_int32=emit_int32)
    assert got.dtype == (np.int32 if emit_int32 else np.int8)
    np.testing.assert_array_equal(got, want)


def test_gemm_int8_row_views_with_leading_dimension():
    """A group's slice of conv weights is a row-major view with a leading
    dimension wider than its rows; the GEMM takes it as it is."""
    x, w, shift, bias = _gemm_inputs(9, 30, 40, 2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = gemm_t(xt[:, :20], wt[:20, 8:24], torch.from_numpy(shift[8:24]),
                 torch.from_numpy(bias[8:24]), relu=True)
    want = ref_t.gemm_int8_ref(xt[:, :20].contiguous(),
                               wt[:20, 8:24].contiguous(),
                               torch.from_numpy(shift[8:24]),
                               torch.from_numpy(bias[8:24]), relu=True)
    assert torch.equal(got, want)


def test_gemm_int8_refuses_bad_operands():
    x, w, shift, _ = _gemm_inputs(4, 8, 6, 0)
    xt, wt, st = map(torch.from_numpy, (x, w, shift))
    with pytest.raises(ValueError):
        gemm_t(xt.to(torch.int32), wt, st)
    with pytest.raises(ValueError):
        gemm_t(xt, wt.t().contiguous().t(), st)        # column-major w
    with pytest.raises(ValueError):
        gemm_t(xt, wt[:7], st)                         # K mismatch
    with pytest.raises(ValueError):
        gemm_t(xt, wt, st[:5])                         # shift length


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    x, w, shift, bias = _gemm_inputs(5, 11, 7, 1)
    before = gemm_t.launches
    got = gemm_t(*map(torch.from_numpy, (x, w, shift, bias)), relu=True)
    want = ref_t.gemm_int8_ref(*map(torch.from_numpy, (x, w, shift, bias)),
                               relu=True)
    assert torch.equal(got, want)
    assert gemm_t.launches == before


# (B, H, W, C, M, R, stride, groups, padding): the reference sweep plus
# grouped channels and asymmetric (lo, hi) padding as the paper's stems
# and pools produce it.
CONV_CASES = [
    (1, 12, 12, 16, 32, 3, 1, 1, "same"),
    (2, 9, 9, 8, 24, 5, 2, 1, "same"),
    (1, 7, 7, 3, 8, 1, 1, 1, "same"),
    (1, 10, 10, 4, 8, 7, 2, 1, "same"),
    (2, 9, 9, 8, 12, 3, 1, 2, "same"),
    (1, 16, 16, 3, 8, 3, 2, 1, ((0, 1), (0, 1))),
    (2, 11, 11, 6, 8, 5, 1, 2, ((2, 2), (2, 2))),
    (1, 8, 8, 4, 6, 3, 2, 2, ((1, 0), (0, 1))),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_int8_vs_reference(case):
    B, H, W, C, M, R, stride, groups, padding = case
    rng = np.random.default_rng(sum(case[:8]))
    x = rng.integers(-128, 128, (B, H, W, C), dtype=np.int64).astype(np.int8)
    w = rng.integers(-30, 30, (R, R, C // groups, M),
                     dtype=np.int64).astype(np.int8)
    shift = rng.integers(-3, 12, M).astype(np.int32)
    bias = rng.integers(-5000, 5000, M).astype(np.int32)
    for relu, emit in [(False, False), (True, False), (True, True)]:
        want = np.asarray(ops_j.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(shift),
            jnp.asarray(bias), stride=stride, padding=padding, groups=groups,
            relu=relu, interpret=True, emit_int32=emit))
        got = ops_t.conv2d_int8(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(shift),
            torch.from_numpy(bias), stride=stride, padding=padding,
            groups=groups, relu=relu, emit_int32=emit)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("emit_int32", [False, True])
def test_fc_int8_vs_reference(emit_int32):
    x, w, shift, bias = _gemm_inputs(3, 96, 50, 9, -4, 14)
    want = np.asarray(ops_j.fc_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(shift), jnp.asarray(bias),
        relu=not emit_int32, interpret=True, emit_int32=emit_int32))
    got = ops_t.fc_int8(*map(torch.from_numpy, (x, w, shift, bias)),
                        relu=not emit_int32, emit_int32=emit_int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_im2col_and_same_padding_match_reference():
    from repro.kernels.conv2d_int8 import ref as ref_j
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (2, 9, 7, 3), dtype=np.int64).astype(np.int8)
    for R, S, stride, pad in [(3, 3, 1, ((1, 1), (1, 1))),
                              (5, 3, 2, ((0, 2), (1, 0)))]:
        want = np.asarray(ref_j.im2col_int8(jnp.asarray(x), R, S, stride,
                                            pad))
        got = ref_t.im2col_int8(torch.from_numpy(x), R, S, stride, pad)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    for hw, k, s in [(227, 11, 4), (224, 3, 1), (13, 3, 2), (8, 2, 2)]:
        assert ref_t.same_padding(hw, k, s) == ref_j.same_padding(hw, k, s)
