"""The port's other LM families against the JAX reference on reduced configs
(``configs.reduced``), with the reference's weights carried across by
``params_from_numpy`` and inputs made with numpy from a seed: the VLM
backbone with M-RoPE (Qwen2-VL-2B), the encoder-decoder (SeamlessM4T-
medium), MLA with the routed MoE (DeepSeek-V2 and V3) and RWKV6, end to
end: the parameter tree, the forward, a decode step, prefill plus
teacher-forced decode, greedy ids and the serve launcher. The layers, the
Pallas impl and the reference's faults are in
``tests/test_torch_family_layers.py``.

Tolerances, those of ``tests/test_torch_lm.py``:
* float32: rtol 1e-5 / atol 2e-5 (both sides compute in float32 and
  differ only in summation order);
* bfloat16: the reference's own 6e-2 / 8e-2 (``tests/test_models.py``);
* greedy ids in float32, the MoE's routing (top-k ids, the kept slots,
  the dispatch table) and cache indices: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.launch import steps as steps_j
from repro.models import transformer as TJ
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import serve as serve_t
from repro_torch.launch import steps as steps_t
from repro_torch.models import layers as LT
from repro_torch.models import transformer as TT

FAMILIES = ["qwen2-vl-2b", "seamless-m4t-medium", "deepseek-v2-236b",
            "deepseek-v3-671b", "rwkv6-7b"]
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=8e-2)
B, S = 2, 16

# The reference's init and forward, jitted: eager JAX compiles each
# primitive on first use, which costs the CPU tests more than the jit.
_init_j = jax.jit(TJ.init_params, static_argnums=(0,),
                  static_argnames=("dtype",))
_forward_j = jax.jit(TJ.forward, static_argnums=(1,))


def _both(arch, dtype=jnp.float32, **scaled):
    """The reduced config in both packages and the reference's weights in
    both (JAX tree, port tree on the CPU)."""
    cfg_j = reduced_j(ARCHS_J[arch]).scaled(**scaled)
    cfg_t = reduced(ARCHS[arch]).scaled(**scaled)
    pj = _init_j(cfg_j, jax.random.PRNGKey(0), dtype=dtype)
    pt = TT.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return cfg_j, cfg_t, pj, pt


def _inputs(cfg, shape, seed=1):
    """A batch of numpy inputs for ``cfg``: tokens; for the VLM patch
    embeddings with M-RoPE positions whose three components differ; for
    the encoder-decoder also encoder frames of the same length."""
    rng = np.random.default_rng(seed)
    Bx, Sx = shape
    if cfg.frontend_stub and cfg.family != "enc_dec":
        pos = np.arange(Sx)[None, :, None] + np.array([0, 3, 7])
        return {"embeds": rng.standard_normal((Bx, Sx, cfg.d_model)).astype(
                    np.float32),
                "positions": np.broadcast_to(pos, (Bx, Sx, 3)).astype(
                    np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, shape)}
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = rng.standard_normal(
            (Bx, Sx, cfg.d_model)).astype(np.float32)
    return batch


_FLOAT_INPUTS = ("embeds", "enc_embeds")


def _j(batch, dtype=jnp.float32, sl=slice(None)):
    return {k: jnp.asarray(v[:, sl] if k != "enc_embeds" else v,
                           dtype if k in _FLOAT_INPUTS else None)
            for k, v in batch.items()}


def _t(batch, dtype=torch.float32, sl=slice(None)):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(
            v[:, sl] if k != "enc_embeds" else v))
        out[k] = t.to(dtype) if k in _FLOAT_INPUTS else t
    return out


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _dtypes(dtype):
    return getattr(jnp, dtype), getattr(torch, dtype)


def _assert_caches_match(ct, cj, pos):
    """Every leaf of the port's per-layer caches against the reference's
    stacked ones; indices equal."""
    assert ct["_pos"] == int(cj["_pos"]) == pos
    for key, layers in ct.items():
        if key == "_pos":
            continue
        for i, layer in enumerate(layers):
            for name, leaf in layer.items():
                want = cj[key][name][i]
                if name == "idx":
                    assert leaf == int(want) == pos
                else:
                    np.testing.assert_allclose(_f32(leaf), _f32(want),
                                               **F32_TOL)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_tree_matches_reference(arch):
    """The port's own draw has the reference's tree: the same leaves, each
    layer's (and the encoder's) shapes and dtypes, the float32 leaves
    among bf16 ones (the router, RWKV's w0, u and ln_x_*) included."""
    cfg_j, cfg_t = reduced_j(ARCHS_J[arch]), reduced(ARCHS[arch])
    ref = jax.eval_shape(lambda: TJ.init_params(cfg_j,
                                                jax.random.PRNGKey(0)))
    got = TT.init_params(cfg_t, seed=0, device="cpu")

    def walk(t, j, stacked):
        if isinstance(t, list):
            assert len(t) == jax.tree.leaves(j)[0].shape[0]
            for lp in t:
                walk(lp, j, True)
            return
        if isinstance(t, dict):
            assert set(t) == set(j)
            for k in t:
                walk(t[k], j[k], stacked)
            return
        shape = j.shape[1:] if stacked else j.shape
        assert tuple(t.shape) == tuple(shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert bool(torch.isfinite(t.float()).all())

    walk(got, ref, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch, dtype):
    jdt, tdt = _dtypes(dtype)
    cfg_j, cfg_t, pj, pt = _both(arch, jdt)
    batch = _inputs(cfg_t, (B, S))
    want, _, aux_j = _forward_j(pj, cfg_j, _j(batch, jdt))
    got, cache, aux_t = TT.forward(pt, cfg_t, _t(batch, tdt))
    assert cache is None and got.shape == (B, S, cfg_t.vocab)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))
    # The MoE layers' summed load-balance loss (0 elsewhere).
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5,
                               atol=1e-6 if dtype == "float32" else 1e-2)
    assert (float(aux_t) > 0) == bool(cfg_t.moe_n_experts)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(arch):
    """A 5-token prefill then one decode step over a 16-slot cache: the
    logits of both calls and every cache leaf match (the MLA latent, the
    RWKV shifts and WKV state, the k/v caches)."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    batch = _inputs(cfg_t, (B, 6))
    cj = TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu")
    for sl in (slice(0, 5), slice(5, 6)):
        lj, cj, _ = _forward_j(pj, cfg_j, _j(batch, sl=sl), cache=cj)
        lt, ct, _ = TT.forward(pt, cfg_t, _t(batch, sl=sl), cache=ct)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    _assert_caches_match(ct, cj, 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_full_forward(arch, dtype):
    """Teacher-forced decode over the cache reproduces the full forward's
    logits, on the kernel impl: the VLM with its M-RoPE positions at every
    step, the encoder-decoder with its frames at every step, MLA through
    the absorbed path. The MoE's capacity factor is raised to E so that no
    step drops a token (C >= T): a full pass and a token-by-token decode
    legitimately drop differently, as the reference's own test says."""
    cfg = reduced(ARCHS[arch])
    if cfg.moe_n_experts:
        cfg = cfg.scaled(moe_capacity_factor=float(cfg.moe_n_experts))
    tdt = getattr(torch, dtype)
    pt = TT.init_params(cfg, seed=0, device="cpu", dtype=tdt)
    batch = _inputs(cfg, (B, 8), seed=5)
    LT.set_attention_impl("kernel")
    try:
        full, _, _ = TT.forward(pt, cfg, _t(batch, tdt))
    finally:
        LT.set_attention_impl(None)
    cache = TT.init_cache(cfg, B, 16, dtype=tdt, device="cpu")
    logits_p, cache, _ = TT.forward(pt, cfg, _t(batch, tdt, slice(0, 4)),
                                    cache=cache)
    outs = [logits_p[:, -1]]
    for t in range(4, 8):
        lg, cache, _ = TT.forward(pt, cfg, _t(batch, tdt, slice(t, t + 1)),
                                  cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    np.testing.assert_allclose(_f32(got), _f32(full[:, 3:8]),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def _serve_inputs(cfg, batch):
    """The prefill batch and the decode step's inputs of both packages'
    ``launch/serve.py``: the VLM's step embeds its token at M-RoPE
    position 0, the encoder-decoder's passes tokens only."""
    vlm = cfg.frontend_stub and cfg.family != "enc_dec"

    def step_j(params, tok):
        if vlm:
            return {"embeds": jnp.take(params["embed"], tok, axis=0),
                    "positions": jnp.zeros((tok.shape[0], 1, 3), jnp.int32)}
        return {"tokens": tok}

    def step_t(params, tok):
        if vlm:
            return {"embeds": params["embed"][tok],
                    "positions": torch.zeros((tok.shape[0], 1, 3),
                                             dtype=torch.int32)}
        return {"tokens": tok}

    return step_j, step_t


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_ids_match_reference_steps(arch):
    """Prefill + 6 greedy decode steps through both packages' ``steps`` in
    float32, on the serve launcher's inputs, give the same ids."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    batch = _inputs(cfg_t, (B, 8), seed=2)
    step_j, step_t = _serve_inputs(cfg_t, batch)
    prefill_j = jax.jit(steps_j.make_prefill_step(cfg_j))
    decode_j = jax.jit(steps_j.make_serve_step(cfg_j))
    cj = TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32)
    last, cj = prefill_j(pj, cj, _j(batch))
    tok = jnp.argmax(last.astype(jnp.float32), -1)[:, None]
    ids_j = [np.asarray(tok)]
    for _ in range(6):
        nxt, cj = decode_j(pj, cj, step_j(pj, tok))
        tok = nxt[:, None]
        ids_j.append(np.asarray(tok))
    prefill_t = steps_t.make_prefill_step(cfg_t)
    decode_t = steps_t.make_serve_step(cfg_t)
    ct = TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu")
    last, ct = prefill_t(pt, ct, _t(batch))
    tok = last.float().argmax(-1)[:, None]
    ids_t = [tok.numpy()]
    for _ in range(6):
        nxt, ct = decode_t(pt, ct, step_t(pt, tok))
        tok = nxt[:, None]
        ids_t.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(ids_t, 1),
                                  np.concatenate(ids_j, 1))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium",
                                  "deepseek-v2-236b", "rwkv6-7b"])
def test_serve_main_on_cpu(arch):
    """The launcher runs each new family: its greedy ids are in the vocab,
    and the first equals a prefill of the same seeded inputs; on the CPU
    no kernel launches."""
    out = serve_t.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    ids = np.asarray(out["ids"])
    cfg = reduced(ARCHS[arch])
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < cfg.vocab)).all()
    assert out["prefill_flash_attention_launches"] == 0
    params = TT.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(1)
    if cfg.frontend_stub and cfg.family != "enc_dec":
        batch = {"embeds": torch.randn((2, 8, cfg.d_model), generator=gen
                                       ).to(params["embed"].dtype),
                 "positions": torch.arange(8)[None, :, None].expand(2, 8, 3)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                         generator=gen)}
        if cfg.family == "enc_dec":
            batch["enc_embeds"] = torch.randn(
                (2, 8, cfg.d_model), generator=gen).to(params["embed"].dtype)
    cache = TT.init_cache(cfg, 2, 12, device="cpu")
    last, _ = steps_t.make_prefill_step(cfg)(params, cache, batch)
    assert ids[:, 0].tolist() == last.float().argmax(-1).tolist()
