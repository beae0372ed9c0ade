"""Meshes and device lists: the PyTorch twin of ``repro/launch/mesh.py``.

``make_production_mesh`` and ``make_debug_mesh`` build a
``torch.distributed`` ``DeviceMesh`` with the reference's axis names and
order over the ranks of the default process group, which the caller
initialises first with a world size equal to the mesh's size: ``nccl`` for
``device_type="cuda"`` (the default), ``gloo`` for ``"cpu"``, and the
``fake`` group of ``fake_process_group`` for ``"meta"`` (one process
standing for every rank, the dry run's way to place meta tensors and count
collectives). ``set_mesh`` / ``ambient_mesh`` make a mesh current for a
block, the counterpart of ``jax.set_mesh`` and ``repro/compat.py``'s
``ambient_mesh``: the MoE reads it to take its expert-parallel dispatch.
``production_mesh_shape`` gives the production mesh's axes and sizes
without any group, for the sharding rules' pure functions. The pipeline
mesh, (data, stage, tp), is ``core/pipeline.py::make_pipeline_mesh``'s.

``device_slices`` splits a device list for the serving plane's replicas.
Importing this module touches no device and no process group.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_DEVICE_TYPES = ("cuda", "cpu", "meta")
_MESH: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def production_mesh_shape(multi_pod: bool = False) -> dict[str, int]:
    """The shape of the reference's ``make_production_mesh``, axes in
    order: one pod is (16, 16) chips over (data, model); two pods are
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The assigned production mesh: one pod = (16, 16) ranks over (data,
    model); two pods = (2, 16, 16) over (pod, data, model)."""
    return build_mesh(production_mesh_shape(multi_pod), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, n_pod: int = 1, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for tests: (n_data, n_model) over (data, model), or
    (n_pod, n_data, n_model) over (pod, data, model) when ``n_pod > 1``."""
    if n_pod > 1:
        return build_mesh({"pod": n_pod, "data": n_data, "model": n_model},
                          device_type)
    return build_mesh({"data": n_data, "model": n_model}, device_type)


def build_mesh(axes: dict[str, int],
               device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``axes`` (``{name: size}`` in order,
    ``production_mesh_shape``'s form) over the default group's ranks. A
    meta mesh is typed ``cpu``: DTensor places meta tensors on a CPU-typed
    mesh (its sharding propagation fails on a meta-typed one)."""
    shape, names = tuple(axes.values()), tuple(axes)
    if device_type not in MESH_DEVICE_TYPES:
        raise ValueError(f"device_type must be one of {MESH_DEVICE_TYPES}, "
                         f"not {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {axes} mesh needs the default process "
            f"group: call torch.distributed.init_process_group with "
            f"world_size={math.prod(shape)} first (nccl for cuda, gloo for "
            f"cpu, fake_process_group for meta)")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"a {axes} mesh needs a world of "
            f"{math.prod(shape)} ranks; the default group has "
            f"{dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu' (gloo) "
                           "or 'meta' (the fake group) to build a mesh "
                           "without one")
    if device_type == "meta" and dist.get_backend() != "fake":
        raise RuntimeError(f"a meta mesh runs on the fake group "
                           f"(fake_process_group), not "
                           f"{dist.get_backend()!r}")
    return init_device_mesh("cpu" if device_type == "meta" else device_type,
                            shape, mesh_dim_names=names)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """The default process group as ``torch.distributed``'s ``fake``
    backend: one process stands for ``world_size`` ranks, and every
    collective returns at once without moving data (shapes and dispatch
    are real; values are not). Destroyed on exit. The backend lives in a
    private torch module (``torch.testing._internal.distributed.fake_pg``);
    without it this raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"this torch ({torch.__version__}) has no fake process group "
            f"(torch.testing._internal.distributed.fake_pg): the dry run's "
            f"collectives need it") from e
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh for the block (per thread and task,
    a ``contextvars`` variable), the counterpart of ``jax.set_mesh``."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh() -> DeviceMesh | None:
    """The mesh made current by :func:`set_mesh`, or None outside one."""
    return _MESH.get()


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's order, the sharding rules'
    argument (``production_mesh_shape``'s form)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


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
