"""The port's ``flash_attention`` (its plain version on CPU tensors)
against the reference's Pallas kernel in interpret mode and its
``attention_ref``, on the same numpy inputs, with the tolerances
``tests/test_kernels.py`` states: 2e-5 in float32, 3e-2 in bfloat16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as ref_j
from repro.kernels.flash_attention.ops import attention as attention_j
from repro_torch.kernels.flash_attention import ref as ref_t
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import attention as attention_t


def _qkv(seed, B, Sq, Skv, H, KV, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(dtype),
            rng.standard_normal((B, Skv, KV, d)).astype(dtype),
            rng.standard_normal((B, Skv, KV, d)).astype(dtype))


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("B,S,H,d,causal", [(1, 64, 1, 32, False),
                                            (2, 128, 2, 64, True),
                                            (3, 64, 2, 32, True),
                                            (1, 128, 1, 64, False)])
def test_matches_reference_kernel_and_ref(B, S, H, d, causal):
    q, k, v = _qkv(B * S + H * d, B, S, S, H, H, d)
    got = attention_t(*_t(q, k, v), causal=causal).numpy()
    for want in (attention_j(*_j(q, k, v), causal=causal, interpret=True),
                 ref_j.attention_ref(*_j(q, k, v), causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_window(dtype):
    """The reference's window case: S = 256, window 64, held against the
    float32 reference."""
    q, k, v = _qkv(7, 1, 256, 256, 2, 2, 64)
    tdt = getattr(torch, dtype)
    got = attention_t(*_t(q, k, v, dtype=tdt), causal=True, window=64)
    assert got.dtype == tdt
    # Both reference functions on the same (rounded) input values: the
    # kernel in this dtype, attention_ref in float32 as the reference's
    # test holds it.
    qj, kj, vj = _j(q, k, v, dtype=getattr(jnp, dtype))
    kernel_j = attention_j(qj, kj, vj, causal=True, window=64,
                           interpret=True)
    want = ref_j.attention_ref(qj.astype(jnp.float32),
                               kj.astype(jnp.float32),
                               vj.astype(jnp.float32), causal=True, window=64)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for ref in (want, kernel_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


def test_shorter_query_block_aligns_to_the_end():
    """Sq < Skv: query i sits at position i + Skv - Sq, as in the
    reference's kernel and ``attention_ref``."""
    q, k, v = _qkv(11, 2, 64, 128, 2, 2, 32)
    got = attention_t(*_t(q, k, v), causal=True).numpy()
    for want in (attention_j(*_j(q, k, v), causal=True, interpret=True),
                 ref_j.attention_ref(*_j(q, k, v), causal=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("KV", [1, 2])
def test_grouped_heads_equal_repeated_heads(KV):
    """K/V with KV heads for H = 8 query heads: query head h reads
    key/value head h // (H // KV), which is the reference's
    ``jnp.repeat(k, H // KV, axis=2)``; equal to the repeated call, and
    to the reference kernel on repeated heads."""
    H = 8
    q, k, v = _qkv(13, 2, 64, 64, H, KV, 16)
    got = attention_t(*_t(q, k, v), causal=True)
    kr, vr = (np.repeat(x, H // KV, axis=2) for x in (k, v))
    same = attention_t(*_t(q, kr, vr), causal=True)
    torch.testing.assert_close(got, same, rtol=0, atol=0)
    want = attention_j(*_j(q, kr, vr), causal=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_row_without_a_valid_key_averages_the_values():
    """Causal with Sq > Skv puts the first queries before every key: the
    reference's -1e30 mask (not -inf) gives those rows the mean of v."""
    q, k, v = _qkv(17, 1, 48, 16, 1, 1, 16)
    got = attention_t(*_t(q, k, v), causal=True).numpy()
    want = ref_j.attention_ref(*_j(q, k, v), causal=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0, :32, 0], np.broadcast_to(
        v[0, :, 0].mean(0), (32, 16)), rtol=1e-5, atol=1e-5)


def test_wrapper_validates_before_dispatch():
    q, k, v = _t(*_qkv(19, 1, 16, 16, 4, 2, 16))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[:, :, :1].expand(1, 16, 3, 16),
                        v[:, :, :1].expand(1, 16, 3, 16))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    # CPU tensors run the plain version and launch nothing.
    flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(flash_attention(q, k, v),
                               ref_t.attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(128, 32), (256, 64)])
def test_head_dim_256_mqa_window(S, window, dtype):
    """RecurrentGemma-2B's local attention, small: head dim 256, 10 query
    heads on one key/value head, causal with a window shorter than S;
    against the reference kernel (interpret mode, on K/V repeated to the
    query heads, as its ``_sdpa_pallas`` calls it) and ``attention_ref``
    in float32."""
    H = 10
    q, k, v = _qkv(23 + S, 1, S, S, H, 1, 256)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = attention_t(*_t(q, k, v, dtype=tdt), causal=True, window=window)
    assert got.dtype == tdt and got.shape == (1, S, H, 256)
    qj, kj, vj = _j(q, np.repeat(k, H, 2), np.repeat(v, H, 2), dtype=jdt)
    kernel_j = attention_j(qj, kj, vj, causal=True, window=window,
                           interpret=True)
    want = ref_j.attention_ref(qj.astype(jnp.float32),
                               kj.astype(jnp.float32),
                               vj.astype(jnp.float32), causal=True,
                               window=window)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for ref in (want, kernel_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)
