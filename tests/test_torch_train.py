"""The port's training path against the JAX reference on the ten reduced
configs (``configs.reduced``), with the port's weights carried across
stacked (and the reference's gradients and updated weights carried back
by ``params_from_numpy``) and batches made with numpy from a seed: the loss
and every gradient leaf (``loss_fn`` + autograd against
``jax.value_and_grad`` of the reference's ``loss_fn``), bf16, remat, the
attention dispatch under autograd and the served steps. One whole
``make_train_step`` per family is in ``tests/test_torch_train_step.py``.

The reference trains RecurrentGemma's RG-LRU through
``jax.lax.associative_scan`` and RWKV6 through ``lax.scan``; the port
through ``linear_scan`` (with its reversed-scan gradient) and its
sequential WKV loop: the same functions summed in another order.

Tolerances (float32 on both sides):
* loss: rtol 1e-5;
* each gradient leaf within 1e-4 of that leaf's largest |g|;
* bf16: finite, and the loss within 2e-2 of the float32 loss.
``PYTHONPATH=src:tests python tests/test_torch_train.py`` prints the
measured distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ARCHS_J
from repro.configs import reduced as reduced_j
from repro.models import transformer as TJ
from repro_torch import optim as optim_t
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch import steps as steps_t
from repro_torch.models import layers as LT
from repro_torch.models import transformer as TT

ALL = sorted(ARCHS)
FAMILY_REPS = ["yi-6b", "deepseek-v2-236b", "seamless-m4t-medium",
               "recurrentgemma-2b", "qwen2-vl-2b", "rwkv6-7b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_LOSS_TOL = 2e-2
B, S = 2, 16

_value_and_grad_j = jax.jit(
    jax.value_and_grad(TJ.loss_fn, has_aux=True), static_argnums=(1,))


def _stacked(pt):
    """The port's float32 parameter tree as the reference's: each segment's
    (and the encoder's) layers stacked on a leading axis."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[conv(v) for v in node])
        # A copy: the port's step writes its params in place, and a jax
        # array on the CPU may share the numpy buffer it was made from.
        return jnp.asarray(node.detach().numpy().copy())
    return conv(pt)


def _both(arch):
    """The reduced config in both packages and one float32 draw in both
    (the port's, carried to the reference stacked: drawing with the
    reference's jitted init costs a compile per config)."""
    cfg_j, cfg_t = reduced_j(ARCHS_J[arch]), reduced(ARCHS[arch])
    pt = TT.init_params(cfg_t, seed=0, device="cpu", dtype=torch.float32)
    return cfg_j, cfg_t, _stacked(pt), pt


def _batch(cfg, seed=1):
    """numpy inputs and labels for ``cfg`` (some labels -1, masked): tokens;
    the VLM's patch embeddings and M-RoPE positions; the encoder-decoder's
    frames."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :2] = -1
    batch = {"labels": labels}
    if cfg.frontend_stub and cfg.family != "enc_dec":
        pos = np.arange(S)[None, :, None] + np.array([0, 3, 7])
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.broadcast_to(pos, (B, S, 3)).astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}


def _t(batch, dtype=torch.float32):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}


def _leaves(tree):
    return optim_t.adamw.tree_leaves(tree)


def _pairs(tree, ref):
    """(port leaf, reference leaf) pairs, matched by path (the reference's
    dicts come back with their keys sorted)."""
    return _leaves(optim_t.adamw.tree_map(lambda a, b: (a, b), tree, ref))


def _grads_t(pt, cfg_t, batch, remat=False):
    (total, metrics), grads = steps_t.value_and_grad(pt, cfg_t, batch,
                                                     remat=remat)
    return total, metrics, grads


def grad_distances(arch) -> dict:
    """The port's float32 loss and gradients against the reference's on one
    batch: the loss's relative error and, per leaf, |difference| over the
    leaf's largest |g| (the worst leaf)."""
    cfg_j, cfg_t, pj, pt = _both(arch)
    batch = _batch(cfg_t)
    (total_j, mj), gj = _value_and_grad_j(pj, cfg_j, _j(batch))
    total_t, mt, gt = _grads_t(pt, cfg_t, _t(batch))
    want = TT.params_from_numpy(jax.tree.map(np.asarray, gj), "cpu")
    rel = []
    for g, w in _pairs(gt, want):
        scale = float(w.abs().max())
        rel.append(float((g - w).abs().max()) / scale if scale else
                   float(g.abs().max()))
    return {"loss": float(mt["loss"]), "loss_ref": float(mj["loss"]),
            "total": float(total_t), "total_ref": float(total_j),
            "aux": float(mt["aux"]), "aux_ref": float(mj["aux"]),
            "loss_rel": abs(float(mt["loss"]) - float(mj["loss"]))
            / abs(float(mj["loss"])),
            "grad_rel_max": max(rel), "leaves": len(rel)}


@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_match_reference(arch):
    d = grad_distances(arch)
    np.testing.assert_allclose(d["loss"], d["loss_ref"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(d["total"], d["total_ref"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(d["aux"], d["aux_ref"], rtol=1e-5, atol=1e-6)
    assert d["grad_rel_max"] <= GRAD_TOL, d


def _nll_and_routes(pt, cfg, batch):
    """Per-position masked nll [B,S] (float32) and, for a MoE model, each
    MoE layer's top-k expert set per position."""
    routes = []
    route = LT.moe_route

    def recording(*a, **k):
        out = route(*a, **k)
        routes.append(out["topi"].sort(-1).values)
        return out

    LT.moe_route = recording
    try:
        (_, metrics), grads = steps_t.value_and_grad(pt, cfg, batch)
        logits, _, _ = TT.forward(pt, cfg, batch)
    finally:
        LT.moe_route = route
    labels = batch["labels"]
    logp = torch.log_softmax(logits.detach().float(), -1)
    nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (nll * (labels >= 0), float(metrics["loss"]), _leaves(grads),
            routes[len(routes) // 2:])


@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_bf16_loss_is_finite_and_near_float32(arch):
    """bf16 weights (the port's draw: each float32 weight rounded, the
    float32 leaves kept, as the reference's bf16 init) against float32 on
    one batch: finite loss and gradients in the params' dtypes, and the loss
    within 2e-2. A MoE's top-k may flip between near-tied gates in bf16
    (as in the reference, which flips elsewhere): positions whose expert
    set differs in any MoE layer are counted and set aside, and the loss
    is compared over the others."""
    cfg_t = reduced(ARCHS[arch])
    batch = _batch(cfg_t)
    runs = {}
    for tdt in (torch.float32, torch.bfloat16):
        pt = TT.init_params(cfg_t, seed=0, device="cpu", dtype=tdt)
        nll, loss, grads, routes = _nll_and_routes(pt, cfg_t,
                                                   _t(batch, tdt))
        assert np.isfinite(loss)
        assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
        assert all(g.dtype == p.dtype for g, p in zip(grads, _leaves(pt)))
        runs[tdt] = (nll, routes)
    (n32, r32), (n16, r16) = runs[torch.float32], runs[torch.bfloat16]
    agree = torch.ones(n32.shape, dtype=torch.bool)
    for a, b in zip(r32, r16):
        agree &= (a == b).all(-1).reshape(n32.shape)
    mask = agree & torch.from_numpy(batch["labels"] >= 0)
    assert int(mask.sum()) >= 0.9 * int((batch["labels"] >= 0).sum())
    gap = float((n16 - n32)[mask].sum() / mask.sum())
    assert abs(gap) <= BF16_LOSS_TOL, (gap, int((~agree).sum()))


def test_remat_gives_the_same_gradients():
    """A segment of 3 layers (the reference scans it, so remat recomputes
    each layer in the backward): equal loss and gradients with remat on
    and off."""
    cfg = reduced(ARCHS["yi-6b"]).scaled(n_layers=3)
    assert TT.segments(cfg)[0].scanned
    batch = _t(_batch(cfg))
    out = []
    for remat in (False, True):
        pt = TT.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        total, _, grads = _grads_t(pt, cfg, batch, remat=remat)
        out.append((total, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b)


def test_kernel_attention_under_grad_raises_and_default_trains_on_torch():
    """An explicit "kernel" stays "kernel" under autograd, and the kernel
    (which has no gradient, as the reference's has none) refuses, on the
    CPU too; the default resolves to "torch" for a call autograd records,
    also for CUDA tensors, and to "kernel" on the card otherwise."""
    cfg = reduced(ARCHS["yi-6b"])
    pt = TT.trainable(TT.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32))
    batch = _t(_batch(cfg))
    LT.set_attention_impl("kernel")
    try:
        with pytest.raises(RuntimeError, match="no gradient"):
            TT.loss_fn(pt, cfg, batch)
    finally:
        LT.set_attention_impl(None)
    q = torch.zeros((1, 128, 2, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])
    cuda = torch.device("cuda")
    assert LT.attention_impl(cuda, q) == "torch"
    assert LT.attention_impl(cuda, q.detach()) == "kernel"
    with torch.no_grad():
        assert LT.attention_impl(cuda, q) == "kernel"
    total, _ = TT.loss_fn(pt, cfg, batch)
    assert total.requires_grad


def test_served_steps_build_no_graph():
    """The serve steps run under ``inference_mode``: no graph even when the
    params require grad."""
    cfg = reduced(ARCHS["recurrentgemma-2b"])
    pt = TT.trainable(TT.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32))
    cache = TT.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    last, cache = steps_t.make_prefill_step(cfg)(pt, cache,
                                                 {"tokens": tokens[:, :8]})
    nxt, cache = steps_t.make_serve_step(cfg)(pt, cache,
                                              {"tokens": tokens[:, 8:9]})
    for t in (last, nxt, cache["seg0"][0]["h"]):
        assert not t.requires_grad and t.grad_fn is None


@pytest.mark.parametrize("preset", [False, True])
def test_train_step_puts_the_params_flags_back(preset):
    """``value_and_grad`` marks the params trainable for its own call only:
    after a step each leaf's ``requires_grad`` is as it was; with none set,
    a forward then builds no graph and the default attention dispatch
    picks the kernel on the card, as for a served forward."""
    cfg = reduced(ARCHS["yi-6b"])
    pt = TT.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    if preset:
        TT.trainable(pt)
    batch = _t(_batch(cfg))
    step = steps_t.make_train_step(cfg, lr=1e-3, remat=False)
    pt, _, m = step(pt, optim_t.adamw_init(pt, cfg.opt_moment_dtype), batch)
    assert np.isfinite(float(m["loss"]))
    leaves = optim_t.adamw.tree_leaves(pt)
    assert [t.requires_grad for t in leaves] == [preset] * len(leaves)
    if not preset:
        logits, _, _ = TT.forward(pt, cfg, batch)
        assert not logits.requires_grad and logits.grad_fn is None
        assert LT.attention_impl(torch.device("cuda"), *leaves) == "kernel"


def measure() -> dict:
    return {arch: {k: v for k, v in grad_distances(arch).items()
                   if k in ("loss_rel", "grad_rel_max")} for arch in ALL}


if __name__ == "__main__":
    for arch, d in measure().items():
        print(arch, {k: f"{v:.3g}" for k, v in d.items()})
