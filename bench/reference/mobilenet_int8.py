"""Plain PyTorch reference of the int8 engine on MobileNetV2 (inverted
residual blocks of a 1x1 expansion, a 3x3 depthwise conv and a linear 1x1
projection), from a configuration's layer list, float parameters and a
calibration batch. It imports nothing of the program.

It computes what the engine's served logits must be, on its own, with the
residual graph's helpers (``resnet_int8``: the layer geometry, the convs,
the requantize shift, the skip's alignment, the int32 wrap) as they are:

1. a float32 forward (``float_forward``, TF32 off) over the calibration
   batch: each conv and fc, the skip added where a layer names one (with
   no activation after the add: MobileNetV2's projections are linear),
   ReLU6 (``min(max(x, 0), 6)``) where a layer sets ``relu6``, the global
   average pool as the sum over the map and the fc on its weights over
   the map's area. It records each layer's output amax and the input's;
2. the quantization rule, a frozen copy of the engine's (``resnet_int8``'s
   ``quantize``, unchanged), plus one rule of its own: a ReLU6 layer's
   integer output is clipped at its ceiling ``min(qmax, floor(6 *
   2^-e_out))``, 6 on its output format;
3. an integer forward: quantize-in, then every conv and fc as an exact
   integer sum (a float64 convolution of integers, rounded: every partial
   sum is an integer far below 2^53; a depthwise conv is ``F.conv2d`` with
   ``groups=C``), bias and the aligned skip added with int32 wrap-around,
   ReLU, the saturating signed shift, the clip onto ``[-qmax - 1, qmax]``
   and, for a ReLU6 layer, onto its ceiling; the pool's exact integer sum
   shifted onto its format; the last engine's int32 accumulators times
   their po2 scale in float32.

Where this departs from the paper's description of MobileNetV2
(Sandler et al., arXiv:1801.04381) and its float network:

* BatchNorm is folded into each conv's weights and bias: the net has no
  normalisation layer;
* ReLU6 is a clamp on integers: the ceiling holds the int8 value at 6 on
  the layer's po2 format, after the floor shift (the shift is monotone and
  exact at the ceiling, so it is the float clamp at 6 rounded as every
  activation is rounded);
* the global average pool emits the exact integer sum of the 7 x 7 map,
  and its 1/49 is folded into the fc's float weights before they are
  quantized (a po2 format cannot hold 1/49).

Layouts are the configuration's: NHWC activations, HWIO conv weights
(``[3, 3, 1, C]`` for a depthwise conv), ``[in, out]`` fc weights.
``bits`` sets the integer width; the control computes at 4 bits. Frames
go through in blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resnet_int8 as R

# ReLU6's bound, in the float network's units.
SIX = 6.0


def layer_geometry(cfg: dict) -> list[dict]:
    """``resnet_int8.layer_geometry``, with each layer's ``relu6``."""
    return [dict(g, relu6=bool(g.get("relu6"))) for g in
            R.layer_geometry(cfg)]


def ceiling(e_out: int, qmax: int) -> int:
    """A ReLU6 layer's largest integer output on its format ``e_out``."""
    six = 6 << -e_out if e_out <= 0 else 6 >> e_out
    return min(qmax, six)


@torch.no_grad()
def float_forward(cfg: dict, params: dict, x: torch.Tensor,
                  record: dict | None = None) -> torch.Tensor:
    """The float32 forward (TF32 off) over frames ``x``: its logits, and
    with ``record`` each layer's output amax (after the skip add, the ReLU
    and ReLU6's clamp) and the input's."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = x.to(torch.float32)
        if record is not None:
            record["__input__"] = float(torch.max(torch.abs(x)))
        geo = layer_geometry(cfg)
        last_read = R._last_reads(geo)
        outs = {-1: x}
        for i, g in enumerate(geo):
            x = outs[g["src_i"]]
            if g["kind"] == "pool":
                x = R._pool(x, g["kernel"], g.get("stride", 1), g["pad"])
            elif g["kind"] == "gap":
                x = x.sum(dim=(1, 2), keepdim=True)
            else:
                w, b = R._weights(geo, params, i), params[g["name"]]["b"]
                if g["kind"] == "fc":
                    x = x.reshape(x.shape[0], -1) @ w + b
                else:
                    x = R._conv(x, w, g.get("stride", 1), g["pad"],
                                g.get("groups", 1)) + b
                if g["res_i"] is not None:
                    x = x + outs[g["res_i"]]
                if g["relu"]:
                    x = torch.relu(x)
                if g["relu6"]:
                    x = torch.clamp(x, max=SIX)
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


def quantize(cfg: dict, params: dict, amax: dict, bits: int = 8) -> dict:
    """``resnet_int8.quantize``'s formats, and each ReLU6 layer's
    ``ceiling``."""
    q = R.quantize(cfg, params, amax, bits)
    qmax = 2 ** (bits - 1) - 1
    for g in layer_geometry(cfg):
        if g["relu6"]:
            q["layers"][g["name"]]["ceiling"] = ceiling(
                R._exponent(amax[g["name"]], qmax), qmax)
    return q


@torch.no_grad()
def int_forward(cfg: dict, q: dict, frames: torch.Tensor) -> np.ndarray:
    """Float logits ``[N, classes]`` (float32, numpy) of ``frames`` through
    the integer engine the formats ``q`` define."""
    qmax = 2 ** (q["bits"] - 1) - 1
    dev = frames.device
    x = frames.to(torch.float32) * np.float32(2.0 ** (-q["e_input"]))
    x = torch.clamp(torch.round(x), -qmax - 1, qmax).to(torch.float64)
    geo = layer_geometry(cfg)
    last_read = R._last_reads(geo)
    outs = {-1: x}
    for i, g in enumerate(geo):
        x = outs[g["src_i"]]
        if g["kind"] == "pool":
            x = R._pool(x, g["kernel"], g.get("stride", 1), g["pad"])
        elif g["kind"] == "gap":
            acc = torch.round(x.sum(dim=(1, 2), keepdim=True)).to(torch.int64)
            sh = torch.as_tensor(q["layers"][g["name"]]["shift"], device=dev)
            x = R._requantize(acc, sh, qmax).to(torch.float64)
        else:
            L = q["layers"][g["name"]]
            if g["kind"] == "fc":
                acc = x.reshape(x.shape[0], -1) @ L["wq"]
            else:
                acc = R._conv(x, L["wq"], g.get("stride", 1), g["pad"],
                              g.get("groups", 1))
            acc = torch.round(acc).to(torch.int64)
            acc = acc + torch.as_tensor(L["bias"], device=dev)
            if g["res_i"] is not None:
                skip = outs[g["res_i"]].to(torch.int64)
                acc = acc + R._align(skip, torch.as_tensor(L["skip_shift"],
                                                           device=dev))
            acc = R._wrap32(acc)
            if g["last"]:
                acc32 = acc.reshape(acc.shape[0], -1).to(torch.int32)
                scale = np.exp2(np.asarray(L["e_in"] + L["e_w"], np.float32))
                return acc32.cpu().numpy().astype(np.float32) * scale[None, :]
            if g["relu"]:
                acc = torch.clamp(acc, min=0)
            x = R._requantize(acc, torch.as_tensor(L["shift"], device=dev),
                              qmax)
            if g["relu6"]:
                x = torch.clamp(x, max=L["ceiling"])
            x = x.to(torch.float64)
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
