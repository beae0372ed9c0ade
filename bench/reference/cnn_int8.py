"""Plain PyTorch reference of the int8 CNN engine, from a configuration's
layer list, float parameters and a calibration batch.

It computes what the engine's served logits must be, on its own:

1. a float32 forward over the calibration batch (TF32 off) records each
   layer's output amax (after ReLU on hidden layers) and the input's;
2. the quantization rule, a frozen copy of the engine's: per-tensor po2
   activation exponents, per-output-channel po2 weight exponents floored
   so the bias fits 30 bits and the shift 31, weights rounded with the
   engine's float32 ``exp(0.6931472 * x)`` scale, biases rounded onto each
   accumulator's format, shifts clipped to [-31, 31];
3. an integer forward: quantize-in, then every conv and fc as an exact
   integer sum (a float64 convolution or product of integers, rounded:
   every partial sum is an integer far below 2^53), bias, ReLU, the
   saturating signed shift and the clip onto the activation's range; max
   pools on the integers; the last engine's int32 accumulators times
   their po2 scale in float32.

Layouts are the configuration's: NHWC activations, HWIO conv weights,
``[in, out]`` fc weights with the flatten in NHWC order. ``bits`` sets the
integer width; the control computes at 4 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN2_F32 = 0.6931472
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


def layer_geometry(cfg: dict) -> list[dict]:
    """Each layer of ``cfg`` with its input and output size and its
    ``(lo, hi)`` spatial padding: SAME at stride 1, and whatever padding
    gives the published output size elsewhere."""
    out = []
    hw = cfg["input_hw"]
    for lyr in cfg["layers"]:
        if lyr["kind"] == "fc":
            o = 1
        elif lyr.get("out_size") is not None:
            o = lyr["out_size"]
        else:
            o = hw // lyr.get("stride", 1)
        need = max((o - 1) * lyr.get("stride", 1) + lyr["kernel"] - hw, 0)
        out.append(dict(lyr, in_hw=hw, out_hw=o,
                        pad=(need // 2, need - need // 2)))
        hw = o
    return out


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


def _exponent(amax: float, qmax: int) -> int:
    return math.ceil(math.log2(max(float(amax), 1e-12) / qmax))


@torch.no_grad()
def calibrate(cfg: dict, params: dict, calib: torch.Tensor) -> dict:
    """Per-layer output amax of the float32 forward over ``calib``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = calib.to(torch.float32)
        amax = {"__input__": float(torch.max(torch.abs(x)))}
        geo = layer_geometry(cfg)
        last = [g for g in geo if g["kind"] != "pool"][-1]["name"]
        for g in geo:
            if g["kind"] == "pool":
                x = _pool(x, g["kernel"], g.get("stride", 1), g["pad"])
                continue
            w, b = params[g["name"]]["w"], params[g["name"]]["b"]
            if g["kind"] == "fc":
                x = x.reshape(x.shape[0], -1) @ w + b
            else:
                x = _conv(x, w, g.get("stride", 1), g["pad"],
                          g.get("groups", 1)) + b
            if g["name"] != last:
                x = torch.relu(x)
            amax[g["name"]] = float(torch.max(torch.abs(x)))
        return amax
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@torch.no_grad()
def quantize(cfg: dict, params: dict, amax: dict, bits: int = 8) -> dict:
    """The frozen formats: the input exponent and, per compute layer, its
    integer weights (as float64 on the weights' device), bias, shift and
    exponents."""
    qmax = 2 ** (bits - 1) - 1
    e_act = _exponent(amax["__input__"], qmax)
    out = {"e_input": e_act, "bits": bits, "layers": {}}
    for g in layer_geometry(cfg):
        if g["kind"] == "pool":
            continue
        w = params[g["name"]]["w"].to(torch.float32)
        b = params[g["name"]]["b"]
        red = tuple(range(w.ndim - 1))
        wmax = torch.clamp(torch.amax(torch.abs(w), dim=red), min=1e-12)
        e_w = torch.ceil(torch.log2(wmax / qmax)).to(torch.int32)
        e_w = e_w.cpu().numpy().astype(np.int64)
        e_out = _exponent(amax[g["name"]], qmax)
        b64 = b.cpu().numpy().astype(np.float64)
        nz = np.abs(b64) > 0
        b_mag = np.full(b64.shape, -(10 ** 9), np.int64)
        b_mag[nz] = np.ceil(np.log2(np.abs(b64[nz])))
        e_w = np.maximum(e_w, np.maximum(b_mag - 30, e_out - 31) - e_act)
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
            "e_in": e_act, "e_w": e_w}
        e_act = e_out
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


@torch.no_grad()
def int_forward(cfg: dict, q: dict, frames: torch.Tensor) -> np.ndarray:
    """Float logits ``[N, classes]`` (float32, numpy) of ``frames`` through
    the integer engine the formats ``q`` define."""
    bits = q["bits"]
    qmax = 2 ** (bits - 1) - 1
    dev = frames.device
    x = frames.to(torch.float32) * np.float32(2.0 ** (-q["e_input"]))
    x = torch.clamp(torch.round(x), -qmax - 1, qmax).to(torch.float64)
    geo = layer_geometry(cfg)
    last = [g for g in geo if g["kind"] != "pool"][-1]["name"]
    for g in geo:
        if g["kind"] == "pool":
            x = _pool(x, g["kernel"], g.get("stride", 1), g["pad"])
            continue
        L = q["layers"][g["name"]]
        if g["kind"] == "fc":
            acc = x.reshape(x.shape[0], -1) @ L["wq"]
        else:
            acc = _conv(x, L["wq"], g.get("stride", 1), g["pad"],
                        g.get("groups", 1))
        acc = torch.round(acc).to(torch.int64)
        acc = acc + torch.as_tensor(L["bias"], device=dev)
        if g["name"] == last:
            acc32 = acc.reshape(acc.shape[0], -1).to(torch.int32)
            scale = np.exp2(np.asarray(L["e_in"] + L["e_w"], np.float32))
            return acc32.cpu().numpy().astype(np.float32) * scale[None, :]
        acc = torch.clamp(acc, min=0)
        x = _requantize(acc, torch.as_tensor(L["shift"], device=dev),
                        qmax).to(torch.float64)
    raise ValueError("configuration has no compute layer")


def logits(cfg: dict, params: dict, calib: torch.Tensor,
           frames: torch.Tensor, *, bits: int = 8,
           block: int = 16) -> np.ndarray:
    """Calibrate, quantize and run ``frames`` in blocks of ``block``."""
    q = quantize(cfg, params, calibrate(cfg, params, calib), bits)
    return np.concatenate([int_forward(cfg, q, frames[i:i + block])
                           for i in range(0, len(frames), block)])
