"""What a run is fed, made from ``--seed`` on the device: the float weights,
the calibration frame and the pool of frames the traffic cycles through.
The same seed gives the same inputs; the program and the reference are
handed the same tensors."""

from __future__ import annotations

import math

import numpy as np
import torch

# Standard deviation of the random biases: small beside the He-scaled
# activations, but nonzero, so the bias path and its exponent floor run.
BIAS_STD = 0.01


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one of a run's streams (weights, frames, ...),
    seeded from ``seed`` whatever its size or sign."""
    mixed = (int(seed) * 1_000_003 + stream) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def weight_shape(lyr: dict) -> tuple[int, ...]:
    if lyr["kind"] == "fc":
        return (lyr["in_ch"], lyr["out_ch"])
    return (lyr["kernel"], lyr["kernel"], lyr["in_ch"] // lyr.get("groups", 1),
            lyr["out_ch"])


def make_params(cfg: dict, seed: int, device) -> dict:
    """``{layer: {"w", "b"}}`` float32 tensors on ``device``: He-scaled
    normal weights and ``BIAS_STD`` normal biases, drawn in one call and
    cut into views."""
    layers = [l for l in cfg["layers"] if l["kind"] != "pool"]
    sizes = [(weight_shape(l), l["out_ch"]) for l in layers]
    total = sum(math.prod(w) + b for w, b in sizes)
    flat = torch.randn(total, generator=_generator(seed, 1, device),
                       device=device, dtype=torch.float32)
    params, o = {}, 0
    for lyr, (wshape, nb) in zip(layers, sizes):
        nw = math.prod(wshape)
        w = flat[o:o + nw].view(wshape)
        w.mul_(1.0 / math.sqrt(nw // lyr["out_ch"]))
        b = flat[o + nw:o + nw + nb]
        b.mul_(BIAS_STD)
        params[lyr["name"]] = {"w": w, "b": b}
        o += nw + nb
    return params


def make_frames(cfg: dict, n: int, seed: int, device,
                stream: int = 2) -> torch.Tensor:
    """``n`` standard-normal float32 frames ``[n, H, W, C]`` on ``device``."""
    hw, ch = cfg["input_hw"], cfg["input_ch"]
    return torch.randn((n, hw, hw, ch), generator=_generator(seed, stream,
                                                              device),
                       device=device, dtype=torch.float32)


def make_calib(cfg: dict, seed: int, device) -> torch.Tensor:
    """The one-frame calibration batch that freezes the activation
    formats."""
    return make_frames(cfg, 1, seed, device, stream=3)


def host_pool(frames: torch.Tensor) -> np.ndarray:
    """The frame pool as the clients hold it: float32 on the host."""
    return frames.cpu().numpy()
