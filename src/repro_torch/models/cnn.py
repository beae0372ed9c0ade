"""CNN substrate in PyTorch: the paper's four benchmark models (VGG16,
AlexNet, ZF, YOLO) as runnable networks, in float and in the paper's
channel-wise fixed-point arithmetic. Twin of ``repro/models/cnn.py``.

The layer graph comes from ``repro_torch.core.workload`` and execution is
owned by ``repro_torch.core.program``. Parameters are plain dictionaries
``{layer: {"w": HWIO or [F, M] float32, "b": [M] float32}}`` of tensors on
one device, in the reference's layouts, so weights carry across with
:func:`params_from_numpy`.
"""

from __future__ import annotations

import math
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.program import (compile_model, float_forward,
                                      resolve_device)
from repro_torch.core.workload import CNNModel

Params = dict[str, dict[str, Any]]


def init_params_np(model: CNNModel, seed: int = 0) -> dict[str, dict[str,
                                                               np.ndarray]]:
    """Seeded He-style float32 weights and zero biases as numpy arrays.
    Each layer draws from its own stream, ``default_rng([seed, crc32(name)])``,
    so a layer's weights do not depend on the layers before it. The draw
    is deterministic but not the reference's: ``jax.random`` bits cannot be
    reproduced, so the same seed gives other weights than
    ``repro.models.cnn.init_params``."""
    p: dict[str, dict[str, np.ndarray]] = {}
    for lyr in model.layers:
        if not lyr.computes:
            continue
        rng = np.random.default_rng([seed, zlib.crc32(lyr.name.encode())])
        if lyr.kind == "fc":
            fan_in = lyr.in_ch
            shape = (lyr.in_ch, lyr.out_ch)
        else:
            fan_in = lyr.kernel * lyr.kernel * lyr.in_ch // lyr.groups
            shape = (lyr.kernel, lyr.kernel, lyr.in_ch // lyr.groups,
                     lyr.out_ch)
        w = rng.standard_normal(shape, dtype=np.float32)
        p[lyr.name] = {"w": w / np.float32(math.sqrt(fan_in)),
                       "b": np.zeros((lyr.out_ch,), np.float32)}
    return p


def params_from_numpy(params, device=None) -> Params:
    """Carry a ``{layer: {"w", "b"}}`` tree of arrays (numpy, or anything
    ``np.asarray`` takes, e.g. the reference's params) onto ``device``
    (default ``cuda``) as float32 tensors, layouts unchanged."""
    device = resolve_device(device)
    return {name: {k: torch.tensor(np.asarray(v, np.float32),
                                   device=device)
                   for k, v in p.items()}
            for name, p in params.items()}


def init_params(model: CNNModel, seed: int = 0, *, device=None) -> Params:
    """:func:`init_params_np` on ``device`` (default ``cuda``)."""
    return params_from_numpy(init_params_np(model, seed), device)


def forward(params: Params, model: CNNModel, x, quantized: bool = False,
            bits: int = 8, use_kernel: bool = False) -> torch.Tensor:
    """x [B,H,W,C] float, on the params' device. quantized=True compiles an
    EngineProgram with scales calibrated on ``x`` and runs the paper's
    fixed-point pipeline; use_kernel=True routes its MACs through the
    Hopper ``gemm_int8`` (its plain version on CPU tensors).

    This wrapper recompiles (and recalibrates on ``x``) every call; for
    repeated inference compile once with ``compile_model``."""
    device = next(iter(params.values()))["w"].device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if not quantized:
        return float_forward(params, model, x)
    prog = compile_model(model, params, bits=bits, calib_batch=x,
                         device=device)
    return prog.run(x, use_kernel=use_kernel)
