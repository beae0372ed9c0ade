"""Recurrent blocks, the port of ``repro/models/recurrent.py``: the RG-LRU
block (Griffin / RecurrentGemma) and RWKV6 (Finch) time-mix and
channel-mix. Each has a sequence path for the forward and prefill and a
state that makes decode O(1) in sequence length.

The reference's sequence path runs the diagonal recurrence
h_t = a_t h_{t-1} + b_t through ``jax.lax.associative_scan``, which XLA
lowers; PyTorch has no such scan, and the port runs it through its Hopper
``linear_scan`` kernel on CUDA tensors and the kernel's plain version on
CPU tensors: the same function, summed in another order (sequentially,
against a tree). A recorded divergence (ROADMAP, "Ground rules").

RWKV6's WKV recurrence keeps a [hd, hd] state per head, not an
elementwise one, and the reference runs it as a sequential ``lax.scan``
with no TPU kernel. The port runs the same sequential loop in float32,
one step per token, and adds no kernel (ROADMAP A).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.models.layers import Params, _normal, apply_dense, dense

_RGLRU_C = 8.0


def rglru_block_init(gen, cfg, dtype, device) -> Params:
    """Weights drawn from ``gen`` on ``device`` (on ``meta`` only the
    shapes). Lambda is drawn so that a = sigmoid(lam)^c spreads over
    (0.9, 0.999), and stays float32 whatever ``dtype`` is."""
    d, dr = cfg.d_model, cfg.lru_width or cfg.d_model
    W = cfg.conv1d_width
    if torch.device(device).type == "meta":
        lam = torch.empty((dr,), dtype=torch.float32, device="meta")
    else:
        lo, hi = 0.9 ** (1 / _RGLRU_C), 0.999 ** (1 / _RGLRU_C)
        u = torch.rand((dr,), generator=gen, dtype=torch.float32,
                       device=device) * (hi - lo) + lo
        lam = torch.log(u / (1 - u))
    return {
        "wx": dense(gen, d, dr, dtype, device),        # rnn branch in
        "wy": dense(gen, d, dr, dtype, device),        # gate branch in
        "conv_w": _normal(gen, (W, dr), 1.0 / math.sqrt(W), dtype, device),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "w_input_gate": dense(gen, dr, dr, dtype, device),
        "w_rec_gate": dense(gen, dr, dr, dtype, device),
        "lam": lam,
        "wo": dense(gen, dr, d, dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    linear cut (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(p: Params, xr: torch.Tensor):
    """Gate computations shared by the scan and step paths. xr [.., dr];
    a and b in float32."""
    i_gate = torch.sigmoid(apply_dense(p["w_input_gate"], xr).float())
    r_gate = torch.sigmoid(apply_dense(p["w_rec_gate"], xr).float())
    log_a = -_RGLRU_C * r_gate * _softplus(p["lam"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * i_gate * xr.float()
    return a, b


def rglru_scan(p: Params, xr: torch.Tensor, h0: torch.Tensor | None = None):
    """The diagonal linear recurrence h_t = a_t h_{t-1} + b_t over time,
    one ``linear_scan`` call. xr [B,S,dr] (post-conv). Returns
    (y [B,S,dr] in xr's dtype, h_last [B,dr] float32)."""
    a, b = _rglru_coeffs(p, xr)
    if h0 is not None:
        # Fold the carry state in as a virtual step 0.
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None, :].float(), b], dim=1)
    h = linear_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(xr.dtype), h[:, -1].float()


def rglru_step(p: Params, xr: torch.Tensor, h: torch.Tensor):
    """One decode step. xr [B,dr], h [B,dr] float32."""
    a, b = _rglru_coeffs(p, xr)
    h_new = a * h + b
    return h_new.to(xr.dtype), h_new


def _causal_conv1d(w, b, x, state=None):
    """Short causal conv (Griffin's width-4 temporal conv). x [B,S,dr];
    state [B,W-1,dr] carries the tail for decode."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W)) + b
    new_state = xp[:, -(W - 1):] if W > 1 else pad[:, :0]
    return out, new_state


def rglru_block_apply(p: Params, cfg, x, *, state: Params | None = None):
    """Full Griffin recurrent block: (gate branch GeLU) * (conv1d -> RG-LRU),
    then output projection. state = {"h": [B,dr], "conv": [B,W-1,dr]}.
    Returns (y [B,S,D], new_state)."""
    S = x.shape[1]
    # jax.nn.gelu defaults to the tanh approximation.
    gate = F.gelu(apply_dense(p["wy"], x), approximate="tanh")
    xr = apply_dense(p["wx"], x)
    conv_state = state["conv"] if state is not None else None
    xr, conv_state = _causal_conv1d(p["conv_w"], p["conv_b"], xr, conv_state)
    if state is not None and S == 1:
        y, h = rglru_step(p, xr[:, 0], state["h"])
        y = y[:, None, :]
    else:
        h0 = state["h"] if state is not None else None
        y, h = rglru_scan(p, xr, h0)
    new_state = {"h": h, "conv": conv_state.to(x.dtype)}
    return apply_dense(p["wo"], y * gate), new_state


def rglru_state_init(cfg, batch: int, dtype, device) -> Params:
    dr = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, dr),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV6 "Finch" time-mix + channel-mix (arXiv:2404.05892)
# ---------------------------------------------------------------------------

_DDLERP_RANK = 32
_DECAY_RANK = 64


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """Uniform(lo, hi) in float32 on ``device``; on ``meta`` the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device) * (hi - lo) + lo


def rwkv6_block_init(gen, cfg, dtype, device) -> Params:
    """Weights drawn from ``gen`` on ``device``. ``w0``, ``u`` and the
    group norm's ``ln_x_*`` stay float32 whatever ``dtype`` is. The
    reference draws the five token-shift mus (and the two channel-mix
    ones) from one key each, so its rows are equal; the port draws one
    row and repeats it."""
    d, hd = cfg.d_model, cfg.head_dim
    nh = d // hd

    def mixes(n):
        return _uniform(gen, (d,), 0.0, 1.0, device).to(dtype).expand(
            n, d).contiguous()

    return {
        # token-shift data-dependent lerp (ddlerp): base mus + low-rank delta
        "mu_base": mixes(5),                                   # r,k,v,w,g
        "ddl_w1": _normal(gen, (d, 5 * _DDLERP_RANK), 0.01, dtype, device),
        "ddl_w2": _normal(gen, (5, _DDLERP_RANK, d), 0.01, dtype, device),
        "wr": dense(gen, d, d, dtype, device),
        "wk": dense(gen, d, d, dtype, device),
        "wv": dense(gen, d, d, dtype, device),
        "wg": dense(gen, d, d, dtype, device),
        "wo": dense(gen, d, d, dtype, device),
        # data-dependent decay lora
        "w0": _uniform(gen, (d,), -8.0, -5.0, device),
        "dec_w1": _normal(gen, (d, _DECAY_RANK), 0.01, dtype, device),
        "dec_w2": _normal(gen, (_DECAY_RANK, d), 0.01, dtype, device),
        "u": _normal(gen, (nh, hd), 0.5, torch.float32, device),
        "ln_x_scale": torch.ones((d,), dtype=torch.float32, device=device),
        "ln_x_bias": torch.zeros((d,), dtype=torch.float32, device=device),
        # channel mix
        "mu_cm": mixes(2),                                     # r,k
        "cm_wr": dense(gen, d, d, dtype, device),
        "cm_wk": dense(gen, d, cfg.d_ff, dtype, device),
        "cm_wv": dense(gen, cfg.d_ff, d, dtype, device),
    }


def _token_shift(x, prev):
    """x [B,S,D] -> x shifted right by one; prev [B,D] fills slot 0."""
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
    dx = xs - x
    base = x[:, :, None, :] + dx[:, :, None, :] * p["mu_base"]  # [B,S,5,D]
    lo = torch.tanh((x + dx * 0.5) @ p["ddl_w1"])                # [B,S,5R]
    lo = lo.reshape(*lo.shape[:-1], 5, _DDLERP_RANK)
    delta = torch.einsum("bsfr,frd->bsfd", lo, p["ddl_w2"])
    return base + delta * dx[:, :, None, :]


def rwkv6_wkv_scan(p, r, k, v, w, state0):
    """The WKV6 recurrence, one step per token in float32. r, k, v, w
    [B,S,nh,hd] (w in (0, 1)); state [B,nh,hd,hd] float32.

    S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  o_t = r_t (S_{t-1} + u k_t^T v_t)

    Returns (o [B,S,nh,hd] float32, the last state)."""
    rs, ks, vs, ws = (t.float() for t in (r, k, v, w))
    u = p["u"][None, :, :, None]
    state = state0
    outs = []
    for t in range(rs.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", ks[:, t], vs[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rs[:, t], state + u * kv))
        state = ws[:, t, ..., None] * state + kv
    return torch.stack(outs, 1), state


def rwkv6_block_apply(p: Params, cfg, x, *, state: Params | None = None):
    """Time-mix. state = {"shift_tm" [B,D], "wkv" [B,nh,hd,hd] float32}.
    Returns (y [B,S,D], new_state).

    Dtypes step by step, as in the reference: the projections in x's
    dtype; the decay ``w0 + tanh(xw W1) W2`` promotes to float32 (``w0``
    is float32) and ``exp(-exp(.))`` stays there; the scan and the
    per-head group norm (eps 64e-5) run in float32, scaled and shifted by
    the float32 ``ln_x_*``, and cast back to x's dtype once, before the
    output gate."""
    B, S, D = x.shape
    hd = cfg.head_dim
    nh = p["wr"]["w"].shape[-1] // hd
    if state is None:
        state = {"shift_tm": torch.zeros((B, D), dtype=x.dtype,
                                         device=x.device),
                 "wkv": torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                                    device=x.device)}
    xs = _token_shift(x, state["shift_tm"])
    mixed = _ddlerp(p, x, xs)                                 # [B,S,5,D]
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))
    r = apply_dense(p["wr"], xr).reshape(B, S, nh, hd)
    k = apply_dense(p["wk"], xk).reshape(B, S, nh, hd)
    v = apply_dense(p["wv"], xv).reshape(B, S, nh, hd)
    g = apply_dense(p["wg"], xg)
    dec = p["w0"] + torch.tanh(xw @ p["dec_w1"]) @ p["dec_w2"]
    w = torch.exp(-torch.exp(dec.float())).reshape(B, S, nh, hd)
    o, wkv = rwkv6_wkv_scan(p, r, k, v, w, state["wkv"])
    og = o.float()
    og = (og - og.mean(-1, keepdim=True)) * torch.rsqrt(
        og.var(-1, keepdim=True, unbiased=False) + 64e-5)
    o = (og.reshape(B, S, nh * hd) * p["ln_x_scale"]
         + p["ln_x_bias"]).to(x.dtype)
    y = apply_dense(p["wo"], o * F.silu(g))
    return y, {"shift_tm": x[:, -1], "wkv": wkv}


def rwkv6_channel_mix(p: Params, x, shift_prev):
    """RWKV channel-mix (the FFN analogue). Returns (y, new_shift)."""
    xs = _token_shift(x, shift_prev)
    xr = x + (xs - x) * p["mu_cm"][0]
    xk = x + (xs - x) * p["mu_cm"][1]
    rgate = torch.sigmoid(apply_dense(p["cm_wr"], xr))
    kk = torch.square(torch.relu(apply_dense(p["cm_wk"], xk)))
    return rgate * apply_dense(p["cm_wv"], kk), x[:, -1]


def rwkv6_state_init(cfg, batch: int, dtype, device) -> Params:
    nh = cfg.d_model // cfg.head_dim
    return {"shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "wkv": torch.zeros((batch, nh, cfg.head_dim, cfg.head_dim),
                               dtype=torch.float32, device=device)}
