"""The Hopper ``gemm_int8`` kernel on the card, against its plain version
on the same CUDA tensors, bit for bit. The CUDA kernel has no CPU mode, so
these tests are marked ``cuda`` and skip without a GPU; on a machine with
one (and ``nvcc``) run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none."""

import pytest
import torch

from repro_torch.kernels.conv2d_int8 import ops, ref
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _int(gen, shape, lo, hi, dtype=torch.int8):
    return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                         device="cuda")


@pytest.mark.parametrize("n,k,m", [(17, 40, 33), (128, 128, 128),
                                   (300, 100, 260), (1, 9, 1), (65, 363, 96),
                                   (16, 4096, 1000), (70, 65, 130)])
@pytest.mark.parametrize("relu,emit_int32", [(False, False), (True, False),
                                             (True, True)])
def test_kernel_matches_plain_version(gen, n, k, m, relu, emit_int32):
    x, w = _int(gen, (n, k), -128, 128), _int(gen, (k, m), -128, 128)
    shift = _int(gen, (m,), -31, 32, torch.int32)
    bias = _int(gen, (m,), -2 ** 30, 2 ** 30, torch.int32)
    before = gemm_int8.launches
    got = gemm_int8(x, w, shift, bias, relu=relu, emit_int32=emit_int32)
    want = ref.gemm_int8_ref(x, w, shift, bias, relu=relu,
                             emit_int32=emit_int32)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 1
    assert torch.equal(got, want)


def test_kernel_takes_unaligned_row_views(gen):
    """Operands that start off a 4-byte boundary or have an odd leading
    dimension take the kernel's byte-load path; a group's column slice of
    the weights takes the 4-byte path with ld > M."""
    xf, wf = _int(gen, (50, 301), -128, 128), _int(gen, (300, 90), -128, 128)
    shift = _int(gen, (90,), 0, 16, torch.int32)
    for x, w, s in [(xf[:, 1:], wf, shift),                 # unaligned x
                    (xf[:, :300], wf[:, 3:50], shift[3:50]),  # odd offset
                    (xf[:, :300], wf[:, 40:80], shift[40:80])]:
        got = gemm_int8(x, w, s, relu=True)
        want = ref.gemm_int8_ref(x, w, s, relu=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_grouped_conv_launches_once_per_group(gen):
    x = _int(gen, (2, 13, 13, 32), -128, 128)
    w = _int(gen, (3, 3, 16, 24), -40, 40)
    shift = _int(gen, (24,), 2, 12, torch.int32)
    bias = _int(gen, (24,), -5000, 5000, torch.int32)
    before = gemm_int8.launches
    got = ops.conv2d_int8(x, w, shift, bias, padding=((1, 1), (1, 1)),
                          groups=2, relu=True)
    want = ref.conv2d_int8_ref(x, w, shift, bias, padding=((1, 1), (1, 1)),
                               groups=2, relu=True)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 2
    assert torch.equal(got, want)
