"""Plain PyTorch reference of the int8 engine on a residual CNN (ResNet-50
v1.5), from a configuration's layer list, float parameters and a
calibration batch.

It computes what the engine's served logits must be, on its own:

1. a float32 forward (``float_forward``) over the calibration batch (TF32
   off), following the
   published layers: each layer reads its ``src`` (default: the layer
   before), a bottleneck's last conv adds its ``residual`` layer's output
   before its ReLU, the global average pool (``gap``) emits the sum over
   the map, and the fc after it runs on its weights divided by the map's
   area. It records each layer's output amax as its consumer sees it (a
   block's last conv after the add and ReLU, a projection before the add
   with no ReLU) and the input's;
2. the quantization rule, a frozen copy of the engine's: per-tensor po2
   activation exponents; per-output-channel po2 weight exponents floored
   so the bias fits 30 bits, the shift 31 and the aligned skip 24 bits;
   weights rounded with the engine's float32 ``exp(0.6931472 * x)``
   scale; biases rounded onto each accumulator's format; shifts clipped
   to [-31, 31]; the skip's alignment shift ``e_in + e_w[m] - e_s``
   clipped to [-24, 31]; the pool's sum requantized once onto its own
   format;
3. an integer forward: quantize-in, then every conv and fc as an exact
   integer sum (a float64 convolution or product of integers, rounded:
   every partial sum is an integer far below 2^53), bias and the aligned
   skip (a left shift, or an arithmetic right shift) added with int32
   wrap-around, ReLU, the saturating signed shift and the clip onto the
   activation's range; max pools on the integers; the pool's exact
   integer sum shifted onto its format; the last engine's int32
   accumulators times their po2 scale in float32.

Layouts are the configuration's: NHWC activations, HWIO conv weights,
``[in, out]`` fc weights. ``bits`` sets the integer width; the control
computes at 4 bits. Frames go through in blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN2_F32 = 0.6931472
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
# The widest left shift of an aligned skip: int8 << 24 fits int32.
SKIP_LEFT_MAX = 24


def layer_geometry(cfg: dict) -> list[dict]:
    """Each layer of ``cfg`` with the index of the layer it reads (``src_i``,
    -1 for the frames), of its skip (``res_i``, or None), its input and
    output size, its ``(lo, hi)`` padding (the layer's ``pad``, else SAME
    at stride 1 and whatever gives ``out_size`` elsewhere) and whether it
    applies ReLU (its ``relu``, else every compute layer but the last)."""
    layers = cfg["layers"]
    index = {l["name"]: i for i, l in enumerate(layers)}
    last = [l["name"] for l in layers if l["kind"] in ("conv", "fc")][-1]
    out = []
    for i, lyr in enumerate(layers):
        src = index[lyr["src"]] if lyr.get("src") else i - 1
        hw = cfg["input_hw"] if src < 0 else out[src]["out_hw"]
        k, s = lyr["kernel"], lyr.get("stride", 1)
        if lyr["kind"] in ("fc", "gap"):
            o, pad = 1, (0, 0)
        elif lyr.get("pad") is not None:
            pad = tuple(lyr["pad"])
            o = lyr.get("out_size") or (hw + sum(pad) - k) // s + 1
        else:
            o = lyr.get("out_size") or hw // s
            need = max((o - 1) * s + k - hw, 0)
            pad = (need // 2, need - need // 2)
        relu = lyr.get("relu")
        if relu is None:
            relu = lyr["kind"] in ("conv", "fc") and lyr["name"] != last
        out.append(dict(lyr, src_i=src, in_hw=hw, out_hw=o, pad=pad,
                        relu=relu, last=lyr["name"] == last,
                        res_i=(index[lyr["residual"]]
                               if lyr.get("residual") else None)))
    return out


def _last_reads(geo: list[dict]) -> dict[int, int]:
    last = {}
    for i, g in enumerate(geo):
        last[g["src_i"]] = i
        if g["res_i"] is not None:
            last[g["res_i"]] = i
    return last


def _pool(x: torch.Tensor, k: int, s: int, pad) -> torch.Tensor:
    """NHWC max pool with ``(lo, hi)`` padding that never wins the max."""
    lo, hi = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi),
               value=float("-inf"))
    return F.max_pool2d(xn, k, s).permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad,
          groups: int) -> torch.Tensor:
    """NHWC x HWIO convolution with ``(lo, hi)`` padding on both spatial
    dims, in the dtype of ``x``."""
    lo, hi = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _weights(geo: list[dict], params: dict, i: int) -> torch.Tensor:
    """Layer ``i``'s float weights, over the map's area after a ``gap``."""
    w = params[geo[i]["name"]]["w"]
    src = geo[i]["src_i"]
    if src >= 0 and geo[src]["kind"] == "gap":
        w = w / float(geo[src]["in_hw"] ** 2)
    return w


def _exponent(amax: float, qmax: int) -> int:
    return math.ceil(math.log2(max(float(amax), 1e-12) / qmax))


@torch.no_grad()
def float_forward(cfg: dict, params: dict, x: torch.Tensor,
                  record: dict | None = None) -> torch.Tensor:
    """The float32 forward (TF32 off) over frames ``x``: its logits, and
    with ``record`` each layer's output amax and the input's."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = x.to(torch.float32)
        if record is not None:
            record["__input__"] = float(torch.max(torch.abs(x)))
        geo = layer_geometry(cfg)
        last_read = _last_reads(geo)
        outs = {-1: x}
        for i, g in enumerate(geo):
            x = outs[g["src_i"]]
            if g["kind"] == "pool":
                x = _pool(x, g["kernel"], g.get("stride", 1), g["pad"])
            elif g["kind"] == "gap":
                x = x.sum(dim=(1, 2), keepdim=True)
            else:
                w, b = _weights(geo, params, i), params[g["name"]]["b"]
                if g["kind"] == "fc":
                    x = x.reshape(x.shape[0], -1) @ w + b
                else:
                    x = _conv(x, w, g.get("stride", 1), g["pad"],
                              g.get("groups", 1)) + b
                if g["res_i"] is not None:
                    x = x + outs[g["res_i"]]
                if g["relu"]:
                    x = torch.relu(x)
            if record is not None and g["kind"] != "pool":
                record[g["name"]] = float(torch.max(torch.abs(x)))
            outs[i] = x
            for j in [j for j in outs if j != i and last_read.get(j, -2) <= i]:
                del outs[j]
        return x
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def calibrate(cfg: dict, params: dict, calib: torch.Tensor) -> dict:
    """Per-layer output amax of the float32 forward over ``calib``."""
    amax: dict = {}
    float_forward(cfg, params, calib, record=amax)
    return amax


@torch.no_grad()
def quantize(cfg: dict, params: dict, amax: dict, bits: int = 8) -> dict:
    """The frozen formats: the input exponent and, per layer, its output
    exponent and, per compute layer, its integer weights (as float64 on
    the weights' device), bias, shift, skip shift and exponents."""
    qmax = 2 ** (bits - 1) - 1
    e_input = _exponent(amax["__input__"], qmax)
    out = {"e_input": e_input, "bits": bits, "layers": {}}
    geo = layer_geometry(cfg)
    e_of: list[int] = []
    for i, g in enumerate(geo):
        e_act = e_input if g["src_i"] < 0 else e_of[g["src_i"]]
        if g["kind"] == "pool":
            e_of.append(e_act)
            continue
        e_out = _exponent(amax[g["name"]], qmax)
        if g["kind"] == "gap":
            out["layers"][g["name"]] = {
                "shift": np.full(g["out_ch"], np.clip(e_out - e_act, -31, 31),
                                 np.int64)}
            e_of.append(e_out)
            continue
        w = _weights(geo, params, i).to(torch.float32)
        b = params[g["name"]]["b"]
        red = tuple(range(w.ndim - 1))
        wmax = torch.clamp(torch.amax(torch.abs(w), dim=red), min=1e-12)
        e_w = torch.ceil(torch.log2(wmax / qmax)).to(torch.int32)
        e_w = e_w.cpu().numpy().astype(np.int64)
        b64 = b.cpu().numpy().astype(np.float64)
        nz = np.abs(b64) > 0
        b_mag = np.full(b64.shape, -(10 ** 9), np.int64)
        b_mag[nz] = np.ceil(np.log2(np.abs(b64[nz])))
        e_w = np.maximum(e_w, np.maximum(b_mag - 30, e_out - 31) - e_act)
        skip_shift = None
        if g["res_i"] is not None:
            e_s = e_of[g["res_i"]]
            e_w = np.maximum(e_w, e_s - SKIP_LEFT_MAX - e_act)
            skip_shift = np.clip(e_act + e_w - e_s, -SKIP_LEFT_MAX, 31)
        scale = torch.exp(torch.tensor(LN2_F32)
                          * torch.as_tensor((-e_w).astype(np.float32)))
        wq = torch.clamp(torch.round(w * scale.to(w.device)),
                         -qmax - 1, qmax)
        acc_e = e_act + e_w
        bias_q = np.clip(np.round(b64 / np.exp2(acc_e)), INT32_MIN,
                         INT32_MAX).astype(np.int64)
        shift = np.clip(e_out - acc_e, -31, 31).astype(np.int64)
        out["layers"][g["name"]] = {
            "wq": wq.to(torch.float64), "bias": bias_q, "shift": shift,
            "e_in": e_act, "e_w": e_w, "skip_shift": skip_shift}
        e_of.append(e_out)
    return out


def _requantize(acc: torch.Tensor, shift: torch.Tensor,
                qmax: int) -> torch.Tensor:
    """int64 accumulators onto the output format: an arithmetic right
    shift for shift >= 0 (at most 31), a saturating left shift (at most
    16, the value first clamped so the int32 result keeps its sign) for
    shift < 0, then the clip onto [-qmax - 1, qmax]."""
    right = torch.bitwise_right_shift(acc, torch.clamp(shift, 0, 31))
    sl = torch.clamp(-shift, 0, 16)
    lo = torch.bitwise_right_shift(torch.full_like(sl, INT32_MIN), sl)
    hi = torch.bitwise_right_shift(torch.full_like(sl, INT32_MAX), sl)
    left = torch.bitwise_left_shift(torch.minimum(torch.maximum(acc, lo),
                                                  hi), sl)
    y = torch.where(shift >= 0, right, left)
    return torch.clamp(y, -qmax - 1, qmax)


def _align(skip: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The int64 skip on each channel's accumulator format."""
    return torch.where(
        shift >= 0, torch.bitwise_right_shift(skip, torch.clamp(shift, 0,
                                                                 31)),
        torch.bitwise_left_shift(skip, torch.clamp(-shift, 0,
                                                   SKIP_LEFT_MAX)))


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped onto int32, as the engine's int32 adds wrap."""
    return torch.remainder(v - INT32_MIN, 2 ** 32) + INT32_MIN


@torch.no_grad()
def int_forward(cfg: dict, q: dict, frames: torch.Tensor) -> np.ndarray:
    """Float logits ``[N, classes]`` (float32, numpy) of ``frames`` through
    the integer engine the formats ``q`` define."""
    qmax = 2 ** (q["bits"] - 1) - 1
    dev = frames.device
    x = frames.to(torch.float32) * np.float32(2.0 ** (-q["e_input"]))
    x = torch.clamp(torch.round(x), -qmax - 1, qmax).to(torch.float64)
    geo = layer_geometry(cfg)
    last_read = _last_reads(geo)
    outs = {-1: x}
    for i, g in enumerate(geo):
        x = outs[g["src_i"]]
        if g["kind"] == "pool":
            x = _pool(x, g["kernel"], g.get("stride", 1), g["pad"])
        elif g["kind"] == "gap":
            acc = torch.round(x.sum(dim=(1, 2), keepdim=True)).to(torch.int64)
            sh = torch.as_tensor(q["layers"][g["name"]]["shift"], device=dev)
            x = _requantize(acc, sh, qmax).to(torch.float64)
        else:
            L = q["layers"][g["name"]]
            if g["kind"] == "fc":
                acc = x.reshape(x.shape[0], -1) @ L["wq"]
            else:
                acc = _conv(x, L["wq"], g.get("stride", 1), g["pad"],
                            g.get("groups", 1))
            acc = torch.round(acc).to(torch.int64)
            acc = acc + torch.as_tensor(L["bias"], device=dev)
            if g["res_i"] is not None:
                skip = outs[g["res_i"]].to(torch.int64)
                acc = acc + _align(skip, torch.as_tensor(L["skip_shift"],
                                                         device=dev))
            acc = _wrap32(acc)
            if g["last"]:
                acc32 = acc.reshape(acc.shape[0], -1).to(torch.int32)
                scale = np.exp2(np.asarray(L["e_in"] + L["e_w"], np.float32))
                return acc32.cpu().numpy().astype(np.float32) * scale[None, :]
            if g["relu"]:
                acc = torch.clamp(acc, min=0)
            x = _requantize(acc, torch.as_tensor(L["shift"], device=dev),
                            qmax).to(torch.float64)
        outs[i] = x
        for j in [j for j in outs if j != i and last_read.get(j, -2) <= i]:
            del outs[j]
    raise ValueError("configuration has no compute layer")


def logits(cfg: dict, params: dict, calib: torch.Tensor,
           frames: torch.Tensor, *, bits: int = 8,
           block: int = 16) -> np.ndarray:
    """Calibrate, quantize and run ``frames`` in blocks of ``block``."""
    q = quantize(cfg, params, calibrate(cfg, params, calib), bits)
    return np.concatenate([int_forward(cfg, q, frames[i:i + block])
                           for i in range(0, len(frames), block)])
