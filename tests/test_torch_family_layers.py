"""The port's other LM families against the JAX reference, layer by layer,
on reduced configs with the reference's weights carried across: the
kernel impl against the reference's Pallas impl (Qwen2-VL-2B, SeamlessM4T-
medium), M-RoPE, MLA on both paths, the MoE's routing (exact at float32)
and local dispatch, RWKV6's WKV scan and blocks, the encoder and
cross-attention, and the three faults of the reference that the port
reproduces (ROADMAP C5-C7). The models end to end are in
``tests/test_torch_families.py``, whose helpers and tolerances this file
shares.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as LJ
from repro.models import recurrent as RJ
from repro.models import transformer as TJ
from repro_torch.models import layers as LT
from repro_torch.models import recurrent as RT
from repro_torch.models import transformer as TT
from test_torch_families import (B, BF16_TOL, F32_TOL, _assert_caches_match,
                                 _both, _dtypes, _f32, _forward_j, _inputs,
                                 _j, _serve_inputs, _t)

# The reference's layers, jitted (config static): eager JAX compiles each
# primitive on first use, which costs these tests more than the jit.
_mla_j = jax.jit(LJ.mla_apply, static_argnums=(1,))
_moe_j = jax.jit(LJ._moe_local, static_argnums=(1,))
_wkv_j = jax.jit(RJ.rwkv6_wkv_scan)
_rwkv_j = jax.jit(RJ.rwkv6_block_apply, static_argnums=(1,))
_cm_j = jax.jit(RJ.rwkv6_channel_mix)
_encode_j = jax.jit(TJ.encode, static_argnums=(1,))

@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_kernel_impl_matches_reference_pallas(arch, monkeypatch):
    """The forward on the "kernel" impl against the reference's forward on
    its Pallas kernel (interpret mode), at S 128: Qwen2-VL's GQA with
    M-RoPE, and Seamless's non-causal encoder, causal decoder and
    non-causal cross-attention (encoder and decoder of one length), each
    through the port's ``flash_attention`` wrapper."""
    cfg_j, cfg_t, pj, pt = _both(arch, jnp.bfloat16, vocab=64)
    batch = _inputs(cfg_t, (2, 128))
    LJ.set_attention_impl("pallas")
    try:
        want, _, _ = TJ.forward(pj, cfg_j, _j(batch, jnp.bfloat16))
    finally:
        LJ.set_attention_impl("jax")
    calls = []
    real = LT.flash_attention

    def counted(*args, **kw):
        calls.append(kw.get("causal", True))
        return real(*args, **kw)

    monkeypatch.setattr(LT, "flash_attention", counted)
    LT.set_attention_impl("kernel")
    try:
        got, _, _ = TT.forward(pt, cfg_t, _t(batch, torch.bfloat16))
    finally:
        LT.set_attention_impl(None)
    n = cfg_t.n_layers
    if cfg_t.n_enc_layers:     # encoder, decoder self, cross
        assert sorted(calls) == [False] * (cfg_t.n_enc_layers + n) + [True] * n
    else:
        assert calls == [True] * n
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, hd):
    """Each section rotated by its own position component; with equal
    components M-RoPE is plain RoPE."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9, 3)).astype(np.int32)
    want = LJ.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = LT.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-4)
    # Angles reach 4096 rad, where one ulp of a frequency (the sections
    # evaluate theta ** f over other vector lengths) moves them by ~4e-4.
    same = np.broadcast_to(pos[..., :1], pos.shape).copy()
    np.testing.assert_allclose(
        _f32(LT.apply_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                           sections)),
        _f32(LT.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]),
                           1e6)), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="sections"):
        LT.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      (1, 1, 1))


@pytest.mark.parametrize("path", ["decompressed", "absorbed"])
def test_mla_apply_matches_reference(path):
    """MLA on both paths: the decompressed forward (no cache), and a
    single-token call over a latent cache holding 6 earlier entries (the
    matrix-absorbed decode, scale 1/sqrt(nope + rope))."""
    cfg_j, cfg_t, pj, pt = _both("deepseek-v2-236b")
    pj, pt = pj["seg0"]["attn"], pt["seg0"][0]["attn"]
    pj = jax.tree.map(lambda a: a[0], pj)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (B, 7))
    if path == "decompressed":
        want, _ = _mla_j(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
        got, nc = LT.mla_apply(pt, cfg_t, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()))
        assert nc is None
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
        return
    cj = TJ._layer_cache("mla", cfg_j, B, 12, jnp.float32)
    ct = TT._layer_cache("mla", cfg_t, B, 12, torch.float32, "cpu")
    for sl in (slice(0, 6), slice(6, 7)):
        want, cj = _mla_j(pj, cfg_j, jnp.asarray(x[:, sl]),
                                jnp.asarray(pos[:, sl]), cache=cj)
        got, ct = LT.mla_apply(pt, cfg_t, torch.from_numpy(x[:, sl]),
                               torch.from_numpy(pos[:, sl].copy()), cache=ct)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    assert ct["idx"] == int(cj["idx"]) == 7
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(_f32(ct[name]), _f32(cj[name]), **F32_TOL)
    # The absorbed step equals the decompressed forward's last position.
    full, _ = LT.mla_apply(pt, cfg_t, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(full[:, -1]),
                               **F32_TOL)


def _moe_setup(router, capacity_factor, dtype=jnp.float32):
    cfg_j, cfg_t, pj, pt = _both("deepseek-v2-236b", dtype,
                                 moe_capacity_factor=capacity_factor)
    pj = jax.tree.map(lambda a: a[0], pj["seg1"]["mlp"])
    pt = pt["seg1"][0]["mlp"]
    if router == "tied":       # every gate 1/E: top-k ties everywhere
        pj = {**pj, "router": {"w": jnp.zeros_like(pj["router"]["w"])}}
        pt = {**pt, "router": {"w": torch.zeros_like(pt["router"]["w"])}}
    x = np.random.default_rng(11).standard_normal(
        (B, 12, cfg_t.d_model)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, x


def _reference_routing(p, cfg, xt):
    """The routing lines of ``repro/models/layers.py::_moe_local``: the
    top-k ids and the dispatch table (token per slot, slot valid)."""
    T = xt.shape[0]
    E, k = cfg.moe_n_experts, cfg.moe_top_k
    C = max(1, int(math.ceil(k * T / E * cfg.moe_capacity_factor)))
    gates = jax.nn.softmax(LJ.apply_dense(p["router"], xt), -1)
    topv, topi = jax.lax.top_k(gates, k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jax.ops.segment_sum(jnp.ones_like(flat_e), flat_e,
                                 num_segments=E)
    offsets = jnp.cumsum(counts) - counts
    slot = offsets[:, None] + jnp.arange(C)[None, :]
    valid = (jnp.arange(C)[None, :] < counts[:, None]) & (slot < T * k)
    tok_idx = (order // k)[jnp.clip(slot, 0, T * k - 1)]
    return np.asarray(topi), np.asarray(valid), np.asarray(tok_idx), C


@pytest.mark.parametrize("router,capacity_factor",
                         [("random", 1.25), ("random", 0.5),
                          ("tied", 1.25), ("random", 4.0)])
def test_moe_routing_is_exact(router, capacity_factor):
    """The routing at float32, equal to the reference's: the top-k ids
    (ties to the lower id, as ``jax.lax.top_k``: a tied router sends every
    token to experts 0 and 1), the kept slots (overflow past C dropped),
    and which token sits in each slot."""
    cfg_j, cfg_t, pj, pt, x = _moe_setup(router, capacity_factor)
    xt = x.reshape(-1, cfg_t.d_model)
    topi, valid, tok_idx, C = _reference_routing(pj, cfg_j, jnp.asarray(xt))
    r = LT.moe_route(pt, cfg_t, torch.from_numpy(xt))
    assert r["C"] == C
    np.testing.assert_array_equal(r["topi"].numpy(), topi)
    np.testing.assert_array_equal(r["valid"].numpy(), valid)
    np.testing.assert_array_equal(r["tok_idx"].numpy()[valid],
                                  tok_idx[valid])
    # Per choice: kept iff its slot is below C, and the slot holds it.
    kept = r["kept"].numpy()
    assert kept.sum() == valid.sum()
    for t, j in zip(*np.nonzero(kept)):
        e, c = int(r["topi"][t, j]), int(r["rank"][t, j])
        assert valid[e, c] and tok_idx[e, c] == t
    if router == "tied":
        assert (topi == np.arange(cfg_t.moe_top_k)).all()
    if capacity_factor < 1.25:
        assert kept.sum() < kept.size      # something was dropped
    if capacity_factor >= 4.0:
        assert kept.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["random", "tied"])
def test_moe_local_matches_reference(router, dtype):
    """The dispatch, the experts, the combine in ascending expert order,
    the shared experts and the aux loss."""
    jdt, tdt = _dtypes(dtype)
    cfg_j, cfg_t, pj, pt, x = _moe_setup(router, 1.25, jdt)
    assert pt["router"]["w"].dtype == torch.float32
    want, aux_j = _moe_j(pj, cfg_j, jnp.asarray(x, jdt))
    got, aux_t = LT._moe_local(pt, cfg_t, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and aux_t.dtype == torch.float32
    # In bf16 the layer's outputs reach ~30 (the reference scales the
    # experts' weights by 1/sqrt(E)) and its elements are sums that cancel;
    # the two frameworks round silu(g) * h and each product at other points,
    # one bf16 ulp of such a sum apart: hence atol 2 ulps at the output's
    # largest magnitude beside the reference's rtol.
    tol = F32_TOL
    if dtype == "bfloat16":
        top = float(np.abs(_f32(want)).max())
        tol = dict(rtol=BF16_TOL["rtol"], atol=max(
            BF16_TOL["atol"], 2 * 2.0 ** (math.floor(math.log2(top)) - 7)))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_expert_weights_dequantize_as_the_reference():
    """``_expert_w``'s int8 branch: per (expert, output channel) scales."""
    rng = np.random.default_rng(2)
    w = rng.integers(-127, 128, (3, 4, 5)).astype(np.int8)
    scale = rng.random((3, 5)).astype(np.float32)
    want = LJ._expert_w({"wi": jnp.asarray(w), "wi_scale": jnp.asarray(scale)},
                        "wi", jnp.float32)
    got = LT._expert_w({"wi": torch.from_numpy(w),
                        "wi_scale": torch.from_numpy(scale)}, "wi",
                       torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=0)


def _rwkv_setup(dtype=jnp.float32):
    cfg_j, cfg_t, pj, pt = _both("rwkv6-7b", dtype)
    return cfg_j, cfg_t, jax.tree.map(lambda a: a[0], pj["seg0"]["rwkv"]), \
        pt["seg0"][0]["rwkv"]


def test_rwkv6_wkv_scan_matches_reference():
    """The sequential WKV recurrence from a non-zero state, in float32."""
    cfg_j, cfg_t, pj, pt = _rwkv_setup()
    nh, hd = cfg_t.d_model // cfg_t.head_dim, cfg_t.head_dim
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((B, 10, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, 10, nh, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, nh, hd, hd)).astype(np.float32)
    o_j, s_j = _wkv_j(pj, *map(jnp.asarray, (r, k, v, w, s0)))
    o_t, s_t = RT.rwkv6_wkv_scan(pt, *map(torch.from_numpy, (r, k, v, w,
                                                             s0)))
    assert o_t.dtype == s_t.dtype == torch.float32
    np.testing.assert_allclose(_f32(o_t), _f32(o_j), **F32_TOL)
    np.testing.assert_allclose(_f32(s_t), _f32(s_j), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_block_apply_matches_reference(dtype):
    """Time-mix and channel-mix from a carried state. The dtype at each
    step, as in the reference: ``w0``, ``u`` and ``ln_x_*`` float32 leaves
    among bf16 ones; the decay ``exp(-exp(w0 + lora))``, the scan and its
    state, and the group norm (eps 64e-5) in float32; the time-mix output,
    the token shifts and the channel-mix output in the model's dtype."""
    jdt, tdt = _dtypes(dtype)
    cfg_j, cfg_t, pj, pt = _rwkv_setup(jdt)
    for name in ("w0", "u", "ln_x_scale", "ln_x_bias"):
        assert pt[name].dtype == torch.float32
    assert pt["wr"]["w"].dtype == tdt
    nh, hd, D = cfg_t.d_model // cfg_t.head_dim, cfg_t.head_dim, cfg_t.d_model
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 9, D)).astype(np.float32)
    st = {"shift_tm": rng.standard_normal((B, D)).astype(np.float32),
          "wkv": rng.standard_normal((B, nh, hd, hd)).astype(np.float32)
          * 0.1}
    st_j = {"shift_tm": jnp.asarray(st["shift_tm"], jdt),
            "wkv": jnp.asarray(st["wkv"])}
    st_t = {"shift_tm": torch.from_numpy(st["shift_tm"]).to(tdt),
            "wkv": torch.from_numpy(st["wkv"])}
    y_j, n_j = _rwkv_j(pj, cfg_j, jnp.asarray(x, jdt),
                                    state=st_j)
    y_t, n_t = RT.rwkv6_block_apply(pt, cfg_t, torch.from_numpy(x).to(tdt),
                                    state=st_t)
    assert y_t.dtype == n_t["shift_tm"].dtype == tdt
    assert n_t["wkv"].dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), **tol)
    np.testing.assert_allclose(_f32(n_t["wkv"]), _f32(n_j["wkv"]), **tol)
    h_j, s_j = _cm_j(pj, jnp.asarray(x, jdt),
                                    st_j["shift_tm"])
    h_t, s_t = RT.rwkv6_channel_mix(pt, torch.from_numpy(x).to(tdt),
                                    st_t["shift_tm"])
    assert h_t.dtype == tdt
    np.testing.assert_allclose(_f32(h_t), _f32(h_j), **tol)
    np.testing.assert_array_equal(_f32(s_t), _f32(s_j))


def test_rwkv6_bf16_drift_from_float32_is_the_references():
    """RWKV6 at random weights drifts from float32 in bf16 far more than
    the attention models do (``chip_smoke.py`` measures it at full
    width). The drift is the model's, not the port's: on a wider reduced
    config the port's mean |bf16 - float32| logits is within a factor 2
    of the reference's, and its float32 forward is the reference's."""
    kw = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
              d_ff=896, vocab=512)
    drift = {}
    for dtype in ("bfloat16", "float32"):
        jdt, _ = _dtypes(dtype)
        cfg_j, cfg_t, pj, pt = _both("rwkv6-7b", jdt, **kw)
        if dtype == "float32":     # the bf16 draw's values, in float32
            pt = TT.params_from_numpy(jax.tree.map(
                lambda a: np.asarray(a, np.float32), pj_bf16), "cpu")
            pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj_bf16)
        else:
            pj_bf16 = pj
        toks = np.random.default_rng(12).integers(0, 512, (1, 64))
        drift[dtype] = (
            _f32(_forward_j(pj, cfg_j, {"tokens": jnp.asarray(toks)})[0]),
            _f32(TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})[0]))
    (jb, tb), (jf, tf) = drift["bfloat16"], drift["float32"]
    np.testing.assert_allclose(tf, jf, **F32_TOL)
    ref, port = np.abs(jb - jf).mean(), np.abs(tb - tf).mean()
    assert ref > 0 and 0.5 <= port / ref <= 2.0, (port, ref)


def test_encode_matches_reference():
    """The bidirectional encoder: non-causal self-attention with q and k
    rotated from position 0, then the final norm."""
    cfg_j, cfg_t, pj, pt = _both("seamless-m4t-medium")
    e = np.random.default_rng(8).standard_normal(
        (B, 11, cfg_t.d_model)).astype(np.float32)
    want = _encode_j(pj, cfg_j, jnp.asarray(e))
    got = TT.encode(pt, cfg_t, torch.from_numpy(e))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_cross_attention_matches_reference():
    """``gqa_apply`` with projected encoder keys and values of another
    length than the queries: no mask, nothing rotated (the positions are
    ignored), no cache."""
    cfg_j, cfg_t, pj, pt = _both("seamless-m4t-medium")
    pj = jax.tree.map(lambda a: a[0], pj["seg0"]["xattn"])
    pt = pt["seg0"][0]["xattn"]
    rng = np.random.default_rng(9)
    KV, hd = cfg_t.n_kv_heads, cfg_t.head_dim
    x = rng.standard_normal((B, 5, cfg_t.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, 13, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(5), (B, 5))
    want, _ = LJ.gqa_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                           cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, nc = LT.gqa_apply(pt, cfg_t, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()),
                           cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert nc is None
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    moved, _ = LT.gqa_apply(pt, cfg_t, torch.from_numpy(x),
                            torch.from_numpy(pos + 100),
                            cross_kv=(torch.from_numpy(k),
                                      torch.from_numpy(v)))
    np.testing.assert_array_equal(moved.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# The reference's faults, reproduced (ROADMAP C5-C7)
# ---------------------------------------------------------------------------


def test_vlm_decode_positions_reproduce_reference_fault():
    """C5: the reference's VLM decode step rotates every generated token at
    M-RoPE position 0 (``repro/launch/serve.py:63-65``). The port's step
    gives the reference's logits, and they differ from the step at its
    true position prompt_len, which is what the forward computes."""
    cfg_j, cfg_t, pj, pt = _both("qwen2-vl-2b")
    batch = _inputs(cfg_t, (B, 9), seed=3)
    step_j, step_t = _serve_inputs(cfg_t, batch)
    cj = TJ.init_cache(cfg_j, B, 12, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 12, dtype=torch.float32, device="cpu")
    text = {"embeds": batch["embeds"],
            "positions": np.broadcast_to(np.arange(9)[None, :, None],
                                         (B, 9, 3)).astype(np.int32)}
    _, cj, _ = _forward_j(pj, cfg_j, _j(text, sl=slice(0, 8)), cache=cj)
    _, ct, _ = TT.forward(pt, cfg_t, _t(text, sl=slice(0, 8)), cache=ct)
    ct_true = {k: v if k == "_pos" else [dict(l, k=l["k"].clone(),
                                             v=l["v"].clone()) for l in v]
               for k, v in ct.items()}
    tok = np.array([[3], [5]])
    lj, _, _ = _forward_j(pj, cfg_j, step_j(pj, jnp.asarray(tok)), cache=cj)
    lt, _, _ = TT.forward(pt, cfg_t, step_t(pt, torch.from_numpy(tok)),
                          cache=ct)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    true_in = {"embeds": pt["embed"][torch.from_numpy(tok)],
               "positions": torch.full((B, 1, 3), 8, dtype=torch.int32)}
    lt_true, _, _ = TT.forward(pt, cfg_t, true_in, cache=ct_true)
    full, _, _ = TT.forward(pt, cfg_t, {
        "embeds": torch.cat([torch.from_numpy(text["embeds"][:, :8]),
                             true_in["embeds"]], 1),
        "positions": torch.from_numpy(text["positions"])})
    np.testing.assert_allclose(_f32(lt_true[:, 0]), _f32(full[:, -1]),
                               **F32_TOL)
    assert np.abs(_f32(lt) - _f32(lt_true)).max() > 1e-3


def test_encdec_decode_skips_encoder_reproduces_reference_fault():
    """C6: the reference's enc-dec decode step passes tokens only
    (``repro/launch/serve.py:67``), and ``forward`` encodes only when
    ``enc_embeds`` is in the batch, so decoded tokens never attend to the
    encoder. The port's step gives the reference's logits; passing the
    frames changes them."""
    cfg_j, cfg_t, pj, pt = _both("seamless-m4t-medium")
    batch = _inputs(cfg_t, (B, 8), seed=4)
    cj = TJ.init_cache(cfg_j, B, 12, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 12, dtype=torch.float32, device="cpu")
    _, cj, _ = _forward_j(pj, cfg_j, _j(batch, sl=slice(0, 7)), cache=cj)
    _, ct, _ = TT.forward(pt, cfg_t, _t(batch, sl=slice(0, 7)), cache=ct)
    step = {"tokens": batch["tokens"][:, 7:8]}
    lj, _, _ = _forward_j(pj, cfg_j, _j(step), cache=cj)
    ct_copy = {k: v if k == "_pos" else [dict(l, k=l["k"].clone(),
                                             v=l["v"].clone()) for l in v]
               for k, v in ct.items()}
    lt, _, _ = TT.forward(pt, cfg_t, _t(step), cache=ct)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    with_frames, _, _ = TT.forward(pt, cfg_t, _t(batch, sl=slice(7, 8)),
                                   cache=ct_copy)
    assert np.abs(_f32(lt) - _f32(with_frames)).max() > 1e-3


def test_mla_prefill_ignores_cache_reproduces_reference_fault():
    """C7: MLA's decompressed path with a non-empty cache attends only
    within the call (``repro/models/layers.py:461, 470``). A second
    4-token call after a 4-token prefill gives the reference's logits,
    which differ from the full forward's at those positions; the cache
    itself holds all 8 entries."""
    cfg_j, cfg_t, pj, pt = _both("deepseek-v2-236b",
                                 moe_capacity_factor=4.0)
    toks = _inputs(cfg_t, (B, 8), seed=6)["tokens"]
    cj = TJ.init_cache(cfg_j, B, 12, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 12, dtype=torch.float32, device="cpu")
    for sl in (slice(0, 4), slice(4, 8)):
        lj, cj, _ = _forward_j(pj, cfg_j, {"tokens": jnp.asarray(toks[:, sl])},
                               cache=cj)
        lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
            toks[:, sl])}, cache=ct)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    _assert_caches_match(ct, cj, 8)
    full, _, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    assert np.abs(_f32(lt) - _f32(full[:, 4:])).max() > 1e-3
