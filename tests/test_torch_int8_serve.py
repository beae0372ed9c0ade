"""The port's int8 weight-only models against the JAX reference on the
ten reduced configs (``configs.reduced``): the int8 forward and greedy
decode, on the reference's weights and inputs made with numpy from a
seed.

The quantized weights are the port's ``quantize_params_int8`` of the
reference's stacked tree, carried to the reference as numpy and to the
port by ``params_from_numpy``: ``tests/test_torch_int8.py`` holds that
quantization equal to the reference's, bit for bit, and this file spends
no eager JAX quantization (it compiles per leaf shape) a second time.

Tolerances:
* the int8 forward and layers at float32: rtol 1e-5 / atol 2e-5, the
  float32 tolerance of ``tests/test_torch_families.py`` (both sides
  dequantize to the same float32 weights and differ only in summation
  order);
* at bfloat16: the reference's own 6e-2 / 8e-2 (``tests/test_models.py``),
  as ``tests/test_torch_families.py`` holds the bf16 forwards;
* greedy ids at float32: equal.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.launch import steps as steps_j
from repro.models import transformer as TJ
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import steps as steps_t
from repro_torch.models import layers as LT
from repro_torch.models import transformer as TT

ALL = list(ARCHS)
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=8e-2)
B, S = 2, 16

_init_j = jax.jit(TJ.init_params, static_argnums=(0,),
                  static_argnames=("dtype",))
_forward_j = jax.jit(TJ.forward, static_argnums=(1,))


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _both(arch, dtype=jnp.float32):
    """The reduced config in both packages and the quantized weights as
    the reference takes them (stacked numpy leaves). The bf16 weights are
    the float32 draw cast leaf by leaf to the dtypes of the reference's
    bf16 init (``_dense_init`` draws in float32 and casts)."""
    cfg_j, cfg_t = reduced_j(ARCHS_J[arch]), reduced(ARCHS[arch])
    pj = jax.tree.map(np.asarray, _init_j(cfg_j, jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    if dtype != jnp.float32:
        like = jax.eval_shape(lambda: TJ.init_params(
            cfg_j, jax.random.PRNGKey(0), dtype=dtype))
        pj = jax.tree.map(lambda a, s: a.astype(s.dtype), pj, like)
    stacked = LT.quantize_params_int8(jax.tree.map(
        lambda a: TT._tensor_from_numpy(a, "cpu"), pj))
    return cfg_j, cfg_t, jax.tree.map(_numpy, stacked)


def _inputs(cfg, shape, dtype, seed=1):
    """Numpy inputs (tokens; the VLM's patch embeddings and M-RoPE
    positions; the encoder-decoder's frames), as both packages take
    them."""
    rng = np.random.default_rng(seed)
    Bx, Sx = shape
    if cfg.frontend_stub and cfg.family != "enc_dec":
        pos = np.broadcast_to(np.arange(Sx)[None, :, None] + np.array(
            [0, 3, 7]), (Bx, Sx, 3)).astype(np.int32)
        x = rng.standard_normal((Bx, Sx, cfg.d_model)).astype(np.float32)
        bj = {"embeds": jnp.asarray(x, dtype[0]),
              "positions": jnp.asarray(pos)}
        bt = {"embeds": torch.from_numpy(x).to(dtype[1]),
              "positions": torch.from_numpy(pos.copy())}
        return bj, bt
    tokens = rng.integers(0, cfg.vocab, shape)
    bj, bt = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(
        tokens)}
    if cfg.family == "enc_dec":
        x = rng.standard_normal((Bx, Sx, cfg.d_model)).astype(np.float32)
        bj["enc_embeds"] = jnp.asarray(x, dtype[0])
        bt["enc_embeds"] = torch.from_numpy(x).to(dtype[1])
    return bj, bt


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Forward, decode, DeepSeek
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL)
def test_int8_forward_matches_reference(arch):
    """The int8 forward, cache-less, at float32 and bfloat16 (the
    reference's 6e-2 / 8e-2), against the reference's int8 forward on
    the same quantized weights."""
    for dtype in ("float32", "bfloat16"):
        dts = (getattr(jnp, dtype), getattr(torch, dtype))
        cfg_j, cfg_t, qj = _both(arch, dts[0])
        qt = TT.params_from_numpy(qj, "cpu")
        bj, bt = _inputs(cfg_t, (B, S), dts)
        want, _, aux_j = _forward_j(qj, cfg_j, bj)
        got, _, aux_t = TT.forward(qt, cfg_t, bt)
        assert got.dtype == dts[1]
        np.testing.assert_allclose(
            _f32(got), _f32(want),
            **(F32_TOL if dtype == "float32" else BF16_TOL), err_msg=dtype)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5,
                                   atol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch", ALL)
def test_int8_greedy_ids_match_reference(arch):
    """Prefill + 5 greedy decode steps through both packages' steps on
    the int8 weights in float32 give the same ids; the decode step's
    inputs are the serve launchers' (the VLM's token embedded at M-RoPE
    position 0, the encoder-decoder's tokens only)."""
    cfg_j, cfg_t, qj = _both(arch)
    qt = TT.params_from_numpy(qj, "cpu")
    bj, bt = _inputs(cfg_t, (B, 8), (jnp.float32, torch.float32), seed=2)
    vlm = cfg_t.frontend_stub and cfg_t.family != "enc_dec"

    def run(prefill, decode, params, cache, batch, step_in, argmax, cat):
        last, cache = prefill(params, cache, batch)
        tok = argmax(last)[:, None]
        ids = [tok]
        for _ in range(5):
            nxt, cache = decode(params, cache, step_in(params, tok))
            tok = nxt[:, None]
            ids.append(tok)
        return np.asarray(cat(ids))

    ids_j = run(
        jax.jit(steps_j.make_prefill_step(cfg_j)),
        jax.jit(steps_j.make_serve_step(cfg_j)), qj,
        TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32), bj,
        lambda p, tok: ({"embeds": jnp.take(p["embed"], tok, axis=0),
                         "positions": jnp.zeros((B, 1, 3), jnp.int32)}
                        if vlm else {"tokens": tok}),
        lambda x: jnp.argmax(x.astype(jnp.float32), -1),
        lambda xs: jnp.concatenate(xs, 1))
    ids_t = run(
        steps_t.make_prefill_step(cfg_t), steps_t.make_serve_step(cfg_t),
        qt, TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu"),
        bt,
        lambda p, tok: ({"embeds": p["embed"][tok],
                         "positions": torch.zeros((B, 1, 3),
                                                  dtype=torch.int32)}
                        if vlm else {"tokens": tok}),
        lambda x: x.float().argmax(-1), lambda xs: torch.cat(xs, 1))
    np.testing.assert_array_equal(ids_t, ids_j)
