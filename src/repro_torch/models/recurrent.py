"""The RG-LRU recurrent block (Griffin / RecurrentGemma), the port of the
RG-LRU half of ``repro/models/recurrent.py``: a sequence path for the
forward and prefill, and a single-step path for decode, whose state is
O(1) in sequence length.

The reference's sequence path runs the diagonal recurrence
h_t = a_t h_{t-1} + b_t through ``jax.lax.associative_scan``, which XLA
lowers; PyTorch has no such scan, and the port runs it through its Hopper
``linear_scan`` kernel on CUDA tensors and the kernel's plain version on
CPU tensors: the same function, summed in another order (sequentially,
against a tree). A recorded divergence (ROADMAP, "Ground rules").

The RWKV6 half of the reference's module runs no TPU kernel and comes with
a later slice (ROADMAP A).
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
