"""Device lists for the serving plane, the PyTorch twin of
``repro/launch/mesh.py::device_slices``, and the production mesh's shape.

The reference's mesh builders (``make_production_mesh``,
``make_debug_mesh``) build ``jax.sharding`` meshes over devices. Here
``production_mesh_shape`` gives only the production mesh's axes and sizes,
which the sharding rules (``runtime/sharding.py``) and the dry run read;
a mesh of devices and process groups comes with the mesh runtime (ROADMAP
A3). Importing this module touches no device.
"""

from __future__ import annotations

import torch


def production_mesh_shape(multi_pod: bool = False) -> dict[str, int]:
    """The shape of the reference's ``make_production_mesh``, axes in
    order: one pod is (16, 16) chips over (data, model); two pods are
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


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
