"""The port's hybrid family against the JAX reference: the RG-LRU block
(``repro_torch.models.recurrent``), the ring cache of ``attn_local``
(``models.layers``) and the reduced RecurrentGemma-2B (4 layers: rglru,
rglru, attn_local, rglru; window 32, MQA), with the reference's weights
carried across by ``params_from_numpy``.

Tolerances, as for the dense slice (``tests/test_torch_lm.py``):
* float32: rtol 1e-5 / atol 2e-5. Both sides compute in float32 and
  differ in summation order: the reference's RG-LRU recurrence runs
  through ``associative_scan`` (a tree), the port's through
  ``linear_scan`` (sequential).
* bfloat16: the reference's own 6e-2 / 8e-2 (``tests/test_models.py``).
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
from repro.models import recurrent as RJ
from repro.models import transformer as TJ
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.launch import serve as serve_t
from repro_torch.launch import steps as steps_t
from repro_torch.models import layers as LT
from repro_torch.models import recurrent as RT
from repro_torch.models import transformer as TT

ARCH = "recurrentgemma-2b"
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=8e-2)
B = 2


def _cfgs(**scaled):
    return (reduced_j(ARCHS_J[ARCH]).scaled(**scaled),
            reduced(ARCHS[ARCH]).scaled(**scaled))


def _both(dtype=jnp.float32, **scaled):
    """The reduced config in both packages and the reference's weights in
    both (JAX tree, port tree on the CPU)."""
    cfg_j, cfg_t = _cfgs(**scaled)
    pj = TJ.init_params(cfg_j, jax.random.PRNGKey(0), dtype=dtype)
    pt = TT.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return cfg_j, cfg_t, pj, pt


def _forward_j(cfg_j):
    """The reference's cache-less forward, jitted (the attention impl is
    read when it traces)."""
    return jax.jit(lambda p, t: TJ.forward(p, cfg_j, {"tokens": t})[0])


def _cached_j(cfg_j):
    """The reference's forward over a cache, jitted: (logits, cache)."""
    return jax.jit(lambda p, c, t: TJ.forward(p, cfg_j, {"tokens": t},
                                              cache=c)[:2])


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _rec_params(dtype=jnp.float32):
    """One RG-LRU block's weights (lru width 64) in both packages."""
    cfg_j, cfg_t = _cfgs()
    pj = RJ.rglru_block_init(jax.random.PRNGKey(4), cfg_j, dtype)
    pt = TT.params_from_numpy({"rec": jax.tree.map(np.asarray, pj)},
                              "cpu")["rec"]
    return cfg_j, cfg_t, pj, pt


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The RG-LRU block, function by function
# ---------------------------------------------------------------------------


def test_softplus_is_jax_softplus():
    """Over the reference's lambda range (4.3 .. 9.0) and beyond F.softplus's
    linear cut at 20, the port's softplus is jax.nn.softplus."""
    x = np.concatenate([np.linspace(-40, 40, 801),
                        np.linspace(4.3, 9.0, 101)]).astype(np.float32)
    np.testing.assert_allclose(_f32(RT._softplus(torch.from_numpy(x))),
                               _f32(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_rglru_coeffs_match_reference():
    _, _, pj, pt = _rec_params()
    lam = _f32(pt["lam"])
    assert pt["lam"].dtype == torch.float32 and 4.3 < lam.min() and \
        lam.max() < 9.0
    x = _x((B, 5, 64))
    aj, bj = RJ._rglru_coeffs(pj, jnp.asarray(x))
    at, bt = RT._rglru_coeffs(pt, torch.from_numpy(x))
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(_f32(at), _f32(aj), **F32_TOL)
    np.testing.assert_allclose(_f32(bt), _f32(bj), **F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    _, _, pj, pt = _rec_params()
    x = _x((B, 7, 64))
    st = _x((B, 3, 64), seed=4) if with_state else None
    oj, sj = RJ._causal_conv1d(pj["conv_w"], pj["conv_b"], jnp.asarray(x),
                               None if st is None else jnp.asarray(st))
    ot, s_t = RT._causal_conv1d(pt["conv_w"], pt["conv_b"],
                                torch.from_numpy(x),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_f32(ot), _f32(oj), **F32_TOL)
    np.testing.assert_allclose(_f32(s_t), _f32(sj), rtol=0, atol=0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    """The port's one ``linear_scan`` call (h0 folded in as a virtual step
    0) against the reference's associative scan."""
    _, _, pj, pt = _rec_params()
    x = _x((B, 48, 64))
    h0 = _x((B, 64), seed=5) if with_h0 else None
    before = linear_scan.launches
    yj, hj = RJ.rglru_scan(pj, jnp.asarray(x),
                           None if h0 is None else jnp.asarray(h0))
    yt, ht = RT.rglru_scan(pt, torch.from_numpy(x),
                           None if h0 is None else torch.from_numpy(h0))
    assert linear_scan.launches == before      # CPU: the plain version
    assert yt.dtype == torch.float32 and ht.dtype == torch.float32
    np.testing.assert_allclose(_f32(yt), _f32(yj), **F32_TOL)
    np.testing.assert_allclose(_f32(ht), _f32(hj), **F32_TOL)


def test_rglru_step_matches_reference():
    _, _, pj, pt = _rec_params()
    x, h = _x((B, 64)), _x((B, 64), seed=6)
    yj, hj = RJ.rglru_step(pj, jnp.asarray(x), jnp.asarray(h))
    yt, ht = RT.rglru_step(pt, torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(_f32(yt), _f32(yj), **F32_TOL)
    np.testing.assert_allclose(_f32(ht), _f32(hj), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_state", [(9, False), (9, True), (1, True)])
def test_rglru_block_apply_matches_reference(S, with_state, dtype):
    """The whole block: the sequence path without and with a carried state,
    and the single-step decode path (S = 1 with a state)."""
    cfg_j, cfg_t = _cfgs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, _, pj, pt = _rec_params(jdt)
    x = _x((B, S, cfg_t.d_model))
    if with_state:
        st_np = {"h": _x((B, 64), seed=7), "conv": _x((B, 3, 64), seed=8)}
        sj = {"h": jnp.asarray(st_np["h"]),
              "conv": jnp.asarray(st_np["conv"], jdt)}
        s_t = {"h": torch.from_numpy(st_np["h"]),
               "conv": torch.from_numpy(st_np["conv"]).to(tdt)}
    else:
        sj = s_t = None
    yj, nj = RJ.rglru_block_apply(pj, cfg_j, jnp.asarray(x, jdt), state=sj)
    yt, nt = RT.rglru_block_apply(pt, cfg_t, torch.from_numpy(x).to(tdt),
                                  state=s_t)
    assert yt.dtype == tdt and nt["h"].dtype == torch.float32 and \
        nt["conv"].dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(yt), _f32(yj), **tol)
    np.testing.assert_allclose(_f32(nt["h"]), _f32(nj["h"]), **tol)
    np.testing.assert_allclose(_f32(nt["conv"]), _f32(nj["conv"]), **tol)


# ---------------------------------------------------------------------------
# The reduced RecurrentGemma-2B
# ---------------------------------------------------------------------------


def test_reduced_config_is_the_hybrid_pattern():
    cfg = reduced(ARCHS[ARCH])
    assert cfg.layer_kinds() == ["rglru", "rglru", "attn_local", "rglru"]
    assert (cfg.window, cfg.n_kv_heads, cfg.lru_width) == (32, 1, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """The cache-less forward at S 64, twice the window, so the window
    mask cuts."""
    cfg_j, cfg_t, pj, pt = _both(getattr(jnp, dtype))
    toks = _tokens(cfg_t, (B, 64))
    want = _forward_j(cfg_j)(pj, jnp.asarray(toks))
    got, cache, aux = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    assert cache is None and float(aux) == 0.0
    assert got.shape == (B, 64, cfg_t.vocab) and got.dtype == getattr(
        torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def test_kernel_impl_matches_reference_pallas(monkeypatch):
    """The forward on the "kernel" impl against the reference's forward on
    its Pallas flash kernel (interpret mode): the attn_local layer's
    attention goes through the port's ``flash_attention`` wrapper with the
    window, and each RG-LRU layer's recurrence through ``linear_scan``
    once (their plain versions on CPU)."""
    cfg_j, cfg_t, pj, pt = _both(jnp.bfloat16, vocab=64)
    toks = _tokens(cfg_t, (2, 128))
    LJ.set_attention_impl("pallas")
    try:
        want = _forward_j(cfg_j)(pj, jnp.asarray(toks))
    finally:
        LJ.set_attention_impl("jax")
    calls = {"flash": [], "scan": []}
    real_flash, real_scan = LT.flash_attention, RT.linear_scan

    def flash(*args, **kw):
        calls["flash"].append(kw.get("window"))
        return real_flash(*args, **kw)

    def scan(a, b):
        calls["scan"].append(tuple(a.shape))
        return real_scan(a, b)

    monkeypatch.setattr(LT, "flash_attention", flash)
    monkeypatch.setattr(RT, "linear_scan", scan)
    LT.set_attention_impl("kernel")
    try:
        got, _, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    finally:
        LT.set_attention_impl(None)
    assert calls["flash"] == [cfg_t.window]
    assert calls["scan"] == [(2, 128, cfg_t.lru_width)] * 3
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def _assert_caches_match(ct, cj):
    """Every layer's cache: the ring's k, v, slot_pos and idx, the RG-LRU
    state's h and conv tail."""
    assert ct["_pos"] == int(cj["_pos"])
    for si, seg in enumerate(TT.segments(reduced(ARCHS[ARCH]))):
        for i, layer in enumerate(ct[f"seg{si}"]):
            ref = {k: v[i] for k, v in cj[f"seg{si}"].items()}
            if seg.kind == "attn_local":
                assert layer["idx"] == int(ref["idx"])
                np.testing.assert_array_equal(layer["slot_pos"].numpy(),
                                              np.asarray(ref["slot_pos"]))
                names = ("k", "v")
            else:
                names = ("h", "conv")
            for name in names:
                np.testing.assert_allclose(_f32(layer[name]),
                                           _f32(ref[name]), **F32_TOL)


def test_decode_step_matches_reference():
    """A 5-token prefill then one decode step over a 16-slot cache (a ring
    of 16: the cache is shorter than the window): the logits of both
    calls and every layer's cache match."""
    cfg_j, cfg_t, pj, pt = _both()
    toks = _tokens(cfg_t, (B, 6))
    cj = TJ.init_cache(cfg_j, B, 16, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 16, dtype=torch.float32, device="cpu")
    assert ct["seg1"][0]["k"].shape[1] == 16
    fwd_j = _cached_j(cfg_j)
    for sl in (slice(0, 5), slice(5, 6)):
        lj, cj = fwd_j(pj, cj, jnp.asarray(toks[:, sl]))
        lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
            toks[:, sl])}, cache=ct)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    _assert_caches_match(ct, cj)


def test_ring_cache_wraps_like_reference():
    """A 48-slot cache makes a ring of 32 (the window); a 20-token prefill
    and 16 decode steps wrap it. After every step the logits match, and
    at the end every layer's cache, the ring's slot_pos included."""
    cfg_j, cfg_t, pj, pt = _both()
    toks = _tokens(cfg_t, (B, 36), seed=3)
    cj = TJ.init_cache(cfg_j, B, 48, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 48, dtype=torch.float32, device="cpu")
    fwd_j = _cached_j(cfg_j)
    lj, cj = fwd_j(pj, cj, jnp.asarray(toks[:, :20]))
    lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
        toks[:, :20])}, cache=ct)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    for t in range(20, 36):
        lj, cj = fwd_j(pj, cj, jnp.asarray(toks[:, t:t + 1]))
        lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, cache=ct)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    ring = ct["seg1"][0]
    assert ring["k"].shape[1] == 32 and ring["idx"] == 36
    # Slots 0..3 hold positions 32..35 after the wrap, 4..31 positions 4..31.
    np.testing.assert_array_equal(
        ring["slot_pos"].numpy(),
        np.concatenate([np.arange(32, 36), np.arange(4, 32)]))
    _assert_caches_match(ct, cj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_full_forward(dtype):
    """Teacher-forced decode over the ring cache and the RG-LRU state
    reproduces the full forward's logits (the invariant of
    ``test_models.py``), on the kernel impl; 40 positions against a
    window of 32, so the ring wraps and the window cuts."""
    cfg = reduced(ARCHS[ARCH])
    tdt = getattr(torch, dtype)
    pt = TT.init_params(cfg, seed=0, device="cpu", dtype=tdt)
    toks = torch.from_numpy(_tokens(cfg, (B, 40), seed=5))
    LT.set_attention_impl("kernel")
    try:
        full, _, _ = TT.forward(pt, cfg, {"tokens": toks})
    finally:
        LT.set_attention_impl(None)
    cache = TT.init_cache(cfg, B, 48, dtype=tdt, device="cpu")
    logits_p, cache, _ = TT.forward(pt, cfg, {"tokens": toks[:, :8]},
                                    cache=cache)
    outs = [logits_p[:, -1]]
    for t in range(8, 40):
        lg, cache, _ = TT.forward(pt, cfg, {"tokens": toks[:, t:t + 1]},
                                  cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    np.testing.assert_allclose(_f32(got), _f32(full[:, 7:40]),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def test_greedy_ids_match_reference_steps():
    """Prefill + 6 greedy decode steps through both packages' ``steps`` in
    float32 give the same ids."""
    cfg_j, cfg_t, pj, pt = _both()
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


def test_prefill_longer_than_ring_reproduces_reference_fault():
    """A 48-token prefill into a 56-slot cache (a ring of 32, the window):
    the ring keeps only the last 32 keys, so the first 16 queries find no
    valid key and average every value (the reference's fault, ROADMAP C).
    The port's last logits equal the reference's, and both are measurably
    off the cache-less forward's."""
    cfg_j, cfg_t, pj, pt = _both()
    toks = _tokens(cfg_t, (B, 48), seed=9)
    cj = TJ.init_cache(cfg_j, B, 56, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, B, 56, dtype=torch.float32, device="cpu")
    lj, cj = _cached_j(cfg_j)(pj, cj, jnp.asarray(toks))
    lt, ct, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)},
                           cache=ct)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **F32_TOL)
    _assert_caches_match(ct, cj)
    full, _, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    gap = np.abs(_f32(lt[:, -1]) - _f32(full[:, -1])).max()
    # The control: a 24-token prefill fits the ring and matches the
    # forward's last logits.
    ct = TT.init_cache(cfg_t, B, 56, dtype=torch.float32, device="cpu")
    fit, _, _ = TT.forward(pt, cfg_t, {"tokens": torch.from_numpy(
        toks[:, :24])}, cache=ct)
    gap_fit = np.abs(_f32(fit[:, -1]) - _f32(full[:, 23])).max()
    print(f"last-logit gap to the forward: prefill 48 into a ring of 32 "
          f"{gap:.3g}, prefill 24 {gap_fit:.3g}; logits max |x| "
          f"{np.abs(_f32(full[:, -1])).max():.3g}")
    assert gap > 1e-3 and gap_fit < 2e-5, (gap, gap_fit)


def test_param_count_matches_reference():
    """Full size, built on the meta device: 2,894,481,920, the reference's
    count."""
    n = TT.param_count(ARCHS[ARCH])
    assert n == TJ.param_count(ARCHS_J[ARCH]) == 2_894_481_920


def test_init_params_shapes_and_dtypes():
    """Seeded init on the CPU has the reference's tree: every leaf's shape,
    lam in float32 in the reference's range, the rest in the model's
    dtype."""
    cfg_j, cfg_t = _cfgs()
    pt = TT.init_params(cfg_t, seed=0, device="cpu", dtype=torch.bfloat16)
    pj = jax.eval_shape(lambda: TJ.init_params(cfg_j, jax.random.PRNGKey(0),
                                               dtype=jnp.bfloat16))
    ref = TT.params_from_numpy(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), pj), "cpu")
    flat_t = dict(_flatten(pt))
    assert flat_t.keys() == dict(_flatten(ref)).keys()
    for name, leaf in _flatten(ref):
        assert flat_t[name].shape == leaf.shape, name
    lam = flat_t["seg0.0.rec.lam"]
    assert lam.dtype == torch.float32 and 4.3 < lam.min() and lam.max() < 9.0
    assert flat_t["seg0.0.rec.wx.w"].dtype == torch.bfloat16


def _flatten(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], node


def test_serve_main_on_cpu():
    """The launcher serves the hybrid family; its greedy ids equal the ones
    its steps give on the same seeded weights and prompt."""
    out = serve_t.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["arch"] == ARCH and out["device"] == "cpu"
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4)
    cfg = reduced(ARCHS[ARCH])
    params = TT.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator(
        device="cpu").manual_seed(1))
    cache = TT.init_cache(cfg, 2, 12, device="cpu")
    last, cache = steps_t.make_prefill_step(cfg)(params, cache,
                                                 {"tokens": prompt})
    assert ids[:, 0].tolist() == last.float().argmax(-1).tolist()
