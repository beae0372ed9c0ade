"""Device lists for the serving plane. PyTorch twin of
``repro/launch/mesh.py::device_slices``.

The reference's mesh builders (``make_production_mesh``,
``make_debug_mesh``) build ``jax.sharding`` meshes for the LM substrate and
have no counterpart here. Importing this module touches no device.
"""

from __future__ import annotations

import torch


def cuda_devices() -> list[torch.device]:
    """``[cuda:0, ..., cuda:n-1]``; raises when there is no CUDA device (the
    port never carries on on the CPU unasked: pass devices explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices explicitly (e.g. "
                           "[torch.device('cpu')]) to run on the CPU")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def device_slices(n_slices: int, devices=None) -> list[list]:
    """Split the device list into ``n_slices`` contiguous near-equal
    slices (sizes differ by at most one) — the replica pool's stage-shard
    mode gives each pipeline replica one slice and stage-pipelines across
    it. With more slices than devices, slices wrap round-robin so every
    replica still owns a device (they then share, which is the one-card
    case). ``devices`` defaults to every CUDA device."""
    if n_slices < 1:
        raise ValueError(f"n_slices={n_slices} < 1")
    devs = list(cuda_devices() if devices is None else devices)
    if not devs:
        raise ValueError("no devices to slice")
    if n_slices >= len(devs):
        return [[devs[i % len(devs)]] for i in range(n_slices)]
    base, extra = divmod(len(devs), n_slices)
    out, i = [], 0
    for s in range(n_slices):
        k = base + (1 if s < extra else 0)
        out.append(devs[i:i + k])
        i += k
    return out
