"""The port's dense decoders (``repro_torch.models``, ``launch.steps``,
``launch.serve``) against the JAX reference on reduced configs, with the
reference's weights carried across by ``params_from_numpy``.

Tolerances:
* float32 forward and decode: rtol 1e-5 / atol 2e-5. Both sides compute
  in float32 and differ only in summation order (measured max |diff|
  about 3e-6 on logits of magnitude about 4).
* bfloat16: the reference's own 6e-2 / 8e-2 (``tests/test_models.py``):
  the two frameworks round bf16 matmul outputs and elementwise ops at
  slightly different points.
* greedy ids in float32: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.launch import steps as steps_j
from repro.models import layers as LJ
from repro.models import transformer as TJ
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import serve as serve_t
from repro_torch.launch import steps as steps_t
from repro_torch.models import layers as LT
from repro_torch.models import transformer as TT

DENSE = ["yi-6b", "qwen3-1.7b", "granite-34b", "qwen2-72b"]
# The hybrid family is held in tests/test_torch_recurrent.py, the VLM,
# encoder-decoder, MLA/MoE and RWKV families in tests/test_torch_families.py.
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=8e-2)
B, S = 2, 16


def _both(arch, dtype=jnp.float32, **scaled):
    """The reduced config in both packages and the reference's weights in
    both (JAX tree, port tree on the CPU)."""
    cfg_j = reduced_j(ARCHS_J[arch]).scaled(**scaled)
    cfg_t = reduced(ARCHS[arch]).scaled(**scaled)
    pj = TJ.init_params(cfg_j, jax.random.PRNGKey(0), dtype=dtype)
    pt = TT.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return cfg_j, cfg_t, pj, pt


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, dtype):
    cfg_j, cfg_t, pj, pt = _both(arch, getattr(jnp, dtype))
    toks = _tokens(cfg_t, (B, S))
    want, _, _ = TJ.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    got, cache, aux = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    assert cache is None and float(aux) == 0.0
    assert got.shape == (B, S, cfg_t.vocab) and got.dtype == getattr(
        torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch):
    """A 5-token prefill then one decode step over a 16-slot cache: the
    logits of both calls and the cache's keys/values match."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    toks = _tokens(cfg_t, (B, 6))
    cj = TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu")
    for sl in (slice(0, 5), slice(5, 6)):
        lj, cj, _ = TJ.forward(pj, cfg_j, {"tokens": jnp.asarray(toks[:, sl])},
                               cache=cj)
        lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
            toks[:, sl])}, cache=ct)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    assert ct["_pos"] == int(cj["_pos"]) == 6
    for i, layer in enumerate(ct["seg0"]):
        assert layer["idx"] == int(cj["seg0"]["idx"][i]) == 6
        for name in ("k", "v"):
            np.testing.assert_allclose(_f32(layer[name]),
                                       _f32(cj["seg0"][name][i]), **F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_kernel_impl_matches_reference_pallas(arch, monkeypatch):
    """The forward on the "kernel" impl against the reference's forward on
    its Pallas kernel (interpret mode), as ``test_models.py`` holds the
    Pallas impl against the jax one; every layer's attention goes through
    the port's ``flash_attention`` wrapper (its plain version on CPU)."""
    cfg_j, cfg_t, pj, pt = _both(arch, jnp.bfloat16, n_layers=2, vocab=64)
    toks = _tokens(cfg_t, (2, 128))
    LJ.set_attention_impl("pallas")
    try:
        want, _, _ = TJ.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    finally:
        LJ.set_attention_impl("jax")
    calls = []
    real = LT.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(LT, "flash_attention", counted)
    LT.set_attention_impl("kernel")
    try:
        got, _, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    finally:
        LT.set_attention_impl(None)
    assert len(calls) == cfg_t.n_layers
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_full_forward(arch, dtype):
    """Teacher-forced decode over the cache reproduces the full forward's
    logits (the invariant of ``test_models.py``), on the kernel impl."""
    cfg = reduced(ARCHS[arch])
    pt = TT.init_params(cfg, seed=0, device="cpu",
                        dtype=getattr(torch, dtype))
    toks = torch.from_numpy(_tokens(cfg, (B, 8), seed=5))
    LT.set_attention_impl("kernel")
    try:
        full, _, _ = TT.forward(pt, cfg, {"tokens": toks})
    finally:
        LT.set_attention_impl(None)
    cache = TT.init_cache(cfg, B, 16, dtype=getattr(torch, dtype),
                          device="cpu")
    logits_p, cache, _ = TT.forward(pt, cfg, {"tokens": toks[:, :4]},
                                    cache=cache)
    outs = [logits_p[:, -1]]
    for t in range(4, 8):
        lg, cache, _ = TT.forward(pt, cfg, {"tokens": toks[:, t:t + 1]},
                                  cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    np.testing.assert_allclose(_f32(got), _f32(full[:, 3:8]),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_ids_match_reference_steps(arch):
    """Prefill + 6 greedy decode steps through both packages' ``steps`` in
    float32 give the same ids."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    toks = _tokens(cfg_t, (B, 8), seed=2)
    prefill_j = jax.jit(steps_j.make_prefill_step(cfg_j))
    decode_j = jax.jit(steps_j.make_serve_step(cfg_j))
    cj = TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32)
    last, cj = prefill_j(pj, cj, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(last.astype(jnp.float32), -1)[:, None]
    ids_j = [np.asarray(tok)]
    for _ in range(6):
        nxt, cj = decode_j(pj, cj, {"tokens": tok})
        tok = nxt[:, None]
        ids_j.append(np.asarray(tok))
    prefill_t = steps_t.make_prefill_step(cfg_t)
    decode_t = steps_t.make_serve_step(cfg_t)
    ct = TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu")
    last, ct = prefill_t(pt, ct, {"tokens": torch.from_numpy(toks)})
    tok = last.float().argmax(-1)[:, None]
    ids_t = [tok.numpy()]
    for _ in range(6):
        nxt, ct = decode_t(pt, ct, {"tokens": tok})
        tok = nxt[:, None]
        ids_t.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(ids_t, 1),
                                  np.concatenate(ids_j, 1))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_matches_reference(arch):
    """Full size, built on the meta device: the reference's count, inside
    the reference's nameplate range (``test_models.py``)."""
    expect = {"qwen2-72b": (69e9, 82e9), "yi-6b": (5.5e9, 6.8e9),
              "granite-34b": (30e9, 38e9), "deepseek-v3-671b": (640e9, 700e9),
              "deepseek-v2-236b": (220e9, 250e9), "rwkv6-7b": (6e9, 8.5e9),
              "recurrentgemma-2b": (2e9, 3.3e9), "qwen3-1.7b": (1.4e9, 2.4e9),
              "qwen2-vl-2b": (1.2e9, 2.4e9),
              "seamless-m4t-medium": (0.7e9, 1.6e9)}
    n = TT.param_count(ARCHS[arch])
    assert n == TJ.param_count(ARCHS_J[arch])
    lo, hi = expect[arch]
    assert lo <= n <= hi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norms_match_reference(norm, dtype):
    """Normalise in float32, cast back, then scale (and shift) in the
    input's dtype, as the reference does."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    if norm == "rms_norm":
        del p["bias"]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = getattr(LJ, norm)({k: jnp.asarray(v, jdt) for k, v in p.items()},
                             jnp.asarray(x, jdt))
    got = getattr(LT, norm)({k: torch.from_numpy(v).to(tdt)
                             for k, v in p.items()},
                            torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)      # one bf16 rounding of the product
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    """The three MLP kinds in float32; gelu is jax.nn.gelu's tanh
    approximation."""
    d, f = 16, 24
    pj = LJ.mlp_init(jax.random.PRNGKey(3), d, f, kind, jnp.float32)
    pt = TT.params_from_numpy({"mlp": jax.tree.map(np.asarray, pj)},
                              "cpu")["mlp"]
    x = np.random.default_rng(5).standard_normal((2, 3, d)).astype(
        np.float32)
    np.testing.assert_allclose(
        _f32(LT.mlp_apply(pt, torch.from_numpy(x), kind)),
        _f32(LJ.mlp_apply(pj, jnp.asarray(x), kind)), **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_sdpa_chunked_matches_reference(causal, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 32, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = LJ._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, q_offset=0,
                            chunk=8)
    got = LT._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           window=window, q_offset=0, chunk=8)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    # sdpa takes the chunked core above the logits threshold, as the
    # reference does, and it agrees with the direct core.
    direct = LT.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                     window=window)
    chunked = LT.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                      window=window, chunked_threshold=16)
    np.testing.assert_allclose(_f32(chunked), _f32(direct), **F32_TOL)


def test_attention_impl_switch():
    assert LT.attention_impl(torch.device("cpu")) == "torch"
    assert LT.attention_impl(torch.device("cuda")) == "kernel"
    LT.set_attention_impl("torch")
    try:
        assert LT.attention_impl(torch.device("cuda")) == "torch"
    finally:
        LT.set_attention_impl(None)
    with pytest.raises(ValueError):
        LT.set_attention_impl("pallas")


def test_serve_main_on_cpu():
    """The launcher's greedy ids equal the ones its steps give on the same
    seeded weights and prompt."""
    out = serve_t.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["arch"] == "yi-6b" and out["device"] == "cpu"
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4)
    assert out["prefill_s"] > 0 and out["decode_tok_s"] > 0
    cfg = reduced(ARCHS["yi-6b"])
    params = TT.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator(
        device="cpu").manual_seed(1))
    cache = TT.init_cache(cfg, 2, 12, device="cpu")
    last, cache = steps_t.make_prefill_step(cfg)(params, cache,
                                                 {"tokens": prompt})
    assert ids[:, 0].tolist() == last.float().argmax(-1).tolist()
