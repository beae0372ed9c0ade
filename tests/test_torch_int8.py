"""The port's int8 weight-only form against the JAX reference on the ten
reduced configs (``configs.reduced``), with the reference's weights
carried across by ``params_from_numpy`` and inputs made with numpy from a
seed: ``quantize_params_int8`` itself, the dequantized weight
``apply_dense`` multiplies (float32 and bfloat16), and DeepSeek-V2's int8
MLA (both paths) and MoE (int8 router and experts). The int8 forward and
greedy decode of every config are in ``tests/test_torch_int8_serve.py``.

The reference's ``quantize_params_int8`` is called eagerly, as
``examples/serve_batched.py`` calls it: under ``jax.jit`` XLA computes
``max / 127.0`` as a product with the reciprocal, which moves some scales
by one ulp from the eager (and the port's) division.

Tolerances:
* quantization, the dequantized weights and the MoE's routing at
  float32: equal, bit for bit;
* the MLA and MoE layers at float32: rtol 1e-5 / atol 2e-5, the float32
  tolerance of ``tests/test_torch_families.py`` (both sides dequantize
  to the same float32 weights and differ only in summation order).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.models import layers as LJ
from repro.models import transformer as TJ
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import layers as LT
from repro_torch.models import transformer as TT

ALL = list(ARCHS)
F32_TOL = dict(rtol=1e-5, atol=2e-5)
B = 2

_init_j = jax.jit(TJ.init_params, static_argnums=(0,),
                  static_argnames=("dtype",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _both(arch, dtype=jnp.float32):
    """The reduced config in both packages, the reference's weights (numpy
    leaves) and the reference's quantized tree (numpy), made once per
    file. The bf16 weights are the float32 draw cast leaf by leaf to the
    dtypes of the reference's bf16 init (``_dense_init`` draws in float32
    and casts, so they are its bf16 draw; the router and RWKV's float32
    leaves stay float32): one compiled init per config, not two."""
    cfg_j, cfg_t = reduced_j(ARCHS_J[arch]), reduced(ARCHS[arch])
    pj = _np(_init_j(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    if dtype != jnp.float32:
        like = jax.eval_shape(lambda: TJ.init_params(
            cfg_j, jax.random.PRNGKey(0), dtype=dtype))
        pj = jax.tree.map(lambda a, s: a.astype(s.dtype), pj, like)
    return cfg_j, cfg_t, pj, _np(LJ.quantize_params_int8(pj))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _leaves(node, path=""):
    """(path, leaf) pairs of a port tree, list indices in the path."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, node


def _assert_trees_equal(got, want):
    """Same paths, dtypes and values, bit for bit."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = want[path]
        assert t.dtype == w.dtype, path
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w), path


# ---------------------------------------------------------------------------
# quantize_params_int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL)
def test_quantize_matches_reference_both_ways(arch, dtype):
    """The reference's quantized tree, carried across, equals the port's
    quantization of the carried-across weights (per-layer lists), and the
    port's quantization of the stacked tree (before unstacking): every
    key, int8 leaf and float32 scale, bit for bit. The embedding keeps
    its dtype; the float32 router is quantized."""
    _, cfg_t, pj, qj = _both(arch, getattr(jnp, dtype))
    want = TT.params_from_numpy(qj, "cpu")
    per_layer = LT.quantize_params_int8(TT.params_from_numpy(pj, "cpu"))
    _assert_trees_equal(per_layer, want)
    stacked = LT.quantize_params_int8(jax.tree.map(
        lambda a: TT._tensor_from_numpy(a, "cpu"), pj))
    _assert_trees_equal(stacked, jax.tree.map(
        lambda a: TT._tensor_from_numpy(a, "cpu"), qj))
    assert want["embed"].dtype == getattr(torch, dtype)
    ints = [p for p, t in _leaves(want) if t.dtype == torch.int8]
    assert ints and all(p.endswith(("/w", "/wi", "/wg", "/wo"))
                        for p in ints)
    if cfg_t.moe_n_experts:
        moe = want["seg1"][0]["mlp"]
        assert moe["router"]["w"].dtype == torch.int8
        assert moe["wi_scale"].shape == (cfg_t.moe_n_experts,
                                         cfg_t.moe_d_ff)


def test_quantize_rounds_half_to_even_and_clips():
    """Values at exactly half a step round to even, as ``jnp.round`` does;
    the largest magnitude maps to +-127; an all-zero column takes the
    1e-8 floor and stays 0."""
    w = np.array([[254.0, 0.0], [1.0, 0.0], [3.0, 0.0], [-254.0, 0.0],
                  [5.0, 0.0]], np.float32)
    want = _np(LJ.quantize_params_int8({"w": jnp.asarray(w)}))
    got = LT.quantize_params_int8({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(got["w"].numpy(), want["w"])
    np.testing.assert_array_equal(got["w_scale"].numpy(), want["w_scale"])
    assert got["w"][:, 0].tolist() == [127, 0, 2, -127, 2]
    assert got["w_scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The dequantized weight
# ---------------------------------------------------------------------------


def _dense_nodes(node, path=""):
    """Every int8 dense dict ({"w", "w_scale"}) of a tree, by path."""
    if isinstance(node, dict):
        if "w_scale" in node:
            yield path, node
            return
        for k, v in node.items():
            yield from _dense_nodes(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _dense_nodes(v, f"{path}/{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-236b"])
def test_dequantized_weight_matches_reference(arch, dtype):
    """What ``apply_dense`` multiplies, ``w.to(dtype) * w_scale.to(dtype)``
    in the activations' dtype, equals the reference's bit for bit: the
    reference's ``apply_dense`` of an identity input returns it exactly.
    Every dense layer of the first decoder layers and the head, MLA's
    ``wkv_b`` among them."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, _, _, qj = _both(arch)
    qt = TT.params_from_numpy(qj, "cpu")
    first = {"seg0": [qt["seg0"][0]], "lm_head": qt.get("lm_head")}
    nodes = list(_dense_nodes(first))
    assert len(nodes) >= 5
    for path, p in nodes:
        pj = jax.tree.map(jnp.asarray, {k: p[k].numpy() for k in
                                        ("w", "w_scale")})
        eye = jnp.eye(p["w"].shape[0], dtype=jdt)
        want = np.asarray(LJ.apply_dense(pj, eye).astype(jnp.float32))
        got = LT.apply_dense_weight(p, tdt)
        assert got.dtype == tdt, path
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=path)


# ---------------------------------------------------------------------------
# DeepSeek-V2: int8 MLA and MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["decompressed", "absorbed"])
def test_int8_mla_matches_reference(path):
    """DeepSeek-V2's MLA with every projection int8 (``wkv_b``
    dequantized once for both paths): the decompressed forward, and a
    single-token call over a latent cache of 6 entries (the absorbed
    decode), at float32."""
    cfg_j, cfg_t, _, qj = _both("deepseek-v2-236b")
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), qj["seg0"]["attn"])
    pt = TT.params_from_numpy(qj, "cpu")["seg0"][0]["attn"]
    assert pt["wkv_b"]["w"].dtype == torch.int8
    mla_j = jax.jit(LJ.mla_apply, static_argnums=(1,))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (B, 7)).copy()
    if path == "decompressed":
        want, _ = mla_j(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
        got, _ = LT.mla_apply(pt, cfg_t, torch.from_numpy(x),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
        return
    cj = TJ._layer_cache("mla", cfg_j, B, 12, jnp.float32)
    ct = TT._layer_cache("mla", cfg_t, B, 12, torch.float32, "cpu")
    for sl in (slice(0, 6), slice(6, 7)):
        want, cj = mla_j(pj, cfg_j, jnp.asarray(x[:, sl]),
                         jnp.asarray(pos[:, sl]), cache=cj)
        got, ct = LT.mla_apply(pt, cfg_t, torch.from_numpy(x[:, sl]),
                               torch.from_numpy(pos[:, sl].copy()), cache=ct)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_int8_moe_local_matches_reference():
    """``_moe_local`` with an int8 router and int8 experts at float32: the
    routing (top-k ids, the dispatch table, the kept slots) equal to the
    reference's, computed from the same dequantized router; the layer's
    output within 1e-5 and the aux loss."""
    cfg_j, cfg_t, _, qj = _both("deepseek-v2-236b")
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), qj["seg1"]["mlp"])
    pt = TT.params_from_numpy(qj, "cpu")["seg1"][0]["mlp"]
    assert pt["router"]["w"].dtype == pt["wi"].dtype == torch.int8
    x = np.random.default_rng(11).standard_normal(
        (B, 12, cfg_t.d_model)).astype(np.float32)
    xt = x.reshape(-1, cfg_t.d_model)
    T, E, k = xt.shape[0], cfg_t.moe_n_experts, cfg_t.moe_top_k
    C = max(1, int(math.ceil(k * T / E * cfg_t.moe_capacity_factor)))
    gates = jax.nn.softmax(LJ.apply_dense(pj["router"], jnp.asarray(xt)), -1)
    _, topi = jax.lax.top_k(gates, k)
    flat_e = topi.reshape(-1)
    counts = jax.ops.segment_sum(jnp.ones_like(flat_e), flat_e,
                                 num_segments=E)
    offsets = jnp.cumsum(counts) - counts
    slot = offsets[:, None] + jnp.arange(C)[None, :]
    valid = np.asarray((jnp.arange(C)[None, :] < counts[:, None])
                       & (slot < T * k))
    tok_idx = np.asarray((jnp.argsort(flat_e) // k)[
        jnp.clip(slot, 0, T * k - 1)])
    r = LT.moe_route(pt, cfg_t, torch.from_numpy(xt))
    np.testing.assert_array_equal(r["topi"].numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r["valid"].numpy(), valid)
    np.testing.assert_array_equal(r["tok_idx"].numpy()[valid],
                                  tok_idx[valid])
    assert int(r["kept"].sum()) == int(valid.sum())
    want, aux_j = jax.jit(LJ._moe_local, static_argnums=(1,))(
        pj, cfg_j, jnp.asarray(x))
    got, aux_t = LT._moe_local(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_no_int8_refusal_is_left():
    """The int8 form runs through every dense path: no
    ``NotImplementedError`` for an int8 weight in the layers module."""
    import inspect
    src = inspect.getsource(LT)
    assert "NotImplementedError" not in src
