"""The kernel wrappers' rule for placed operands (DTensors on a mesh).

A kernel takes plain tensors: its device check, its ``data_ptr`` and its
launch know nothing of a mesh. A wrapper given DTensors therefore runs
itself on each rank's local shard through ``local_map``, under placements
for which its function is local to a shard: the batch dim over the batch
axes (``pod``, ``data``) where the batch divides them, one dim over
``model`` where it divides (attention's heads, the scan's channels),
every other dim whole. Operands that arrive in other placements are
redistributed first, so the collective is dispatched (and counted by
``CommDebugMode``) like any other. Each rank then launches its kernel, or
on the CPU runs its plain version, and counts its own launches. This is a
dispatch rule, not a fallback: nothing is caught or retried.

The models apply the same rule (``run_local``, ``per_axis``) to what
DTensor has no rule for, or runs as hundreds of ops (``models/layers.py``:
the plain attention cores, the MoE, the embedding lookup, cache writes;
``models/recurrent.py``: RWKV6's WKV loop), and use ``reshape``,
``reduced``, ``replicated`` and ``replicating`` where DTensor's own
propagation fails (ROADMAP, "The mesh runtime").
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  local_map)

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


def is_placed(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def replicating(*tensors):
    """``implicit_replication()`` when any of ``tensors`` is placed, else a
    null context. A placed forward makes plain tensors of its own
    (positions, masks, a zero aux loss, the optimizer's scalars), the same
    on every rank; DTensor takes them as replicated only inside it.
    Inside an outer such block it is a null context: torch's own context
    manager does not nest (its exit turns the rule off for the outer block,
    where a backward may still recompute a forward)."""
    if is_placed(*tensors) and \
            not DTensor._op_dispatcher._allow_implicit_replication:
        return implicit_replication()
    return contextlib.nullcontext()


def replicated(t):
    """A placed ``t`` redistributed to ``Replicate()`` on every mesh dim
    (a ``Partial`` sum reduced); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def reduced(t):
    """A placed ``t`` with each ``Partial`` sum reduced (to
    ``Replicate()``) and its other placements kept; a plain tensor as it
    is. Before a product: DTensor's rule for a partial operand may split
    the product's flattened rows over a batch axis that the batch itself
    does not divide, and then fails to unflatten them."""
    if not isinstance(t, DTensor) or not any(
            pl.is_partial() for pl in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in t.placements])


def mesh_of(*tensors) -> DeviceMesh:
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def batch_split(mesh: DeviceMesh, batch: int) -> bool:
    """Whether ``batch`` splits over the mesh's batch axes (the reference's
    rule: divisible and at least one a shard)."""
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                  for a in BATCH_AXES if a in mesh.mesh_dim_names)
    return batch % n == 0 and batch >= n


def model_split(mesh: DeviceMesh, *sizes: int) -> bool:
    """Whether every one of ``sizes`` splits over the ``model`` axis."""
    if MODEL_AXIS not in mesh.mesh_dim_names:
        return False
    n = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    return all(s % n == 0 and s >= n for s in sizes)


def per_axis(mesh: DeviceMesh, batch: bool, batch_pl, model_pl,
             other=Replicate()) -> list:
    """One placement per mesh dim: ``model_pl`` on ``model``, ``batch_pl``
    on the batch axes when ``batch`` (the batch splits over them),
    ``other`` elsewhere. A list: ``local_map`` reads a tuple of out
    placements as several outputs."""
    return [model_pl if a == MODEL_AXIS else
            batch_pl if a in BATCH_AXES and batch else other
            for a in mesh.mesh_dim_names]


def local_placements(mesh: DeviceMesh, *, batch: bool,
                     model_dim: int | None) -> list:
    """``Shard(0)`` on the batch axes when ``batch``, ``Shard(model_dim)``
    on ``model`` unless it is None, ``Replicate()`` elsewhere."""
    return per_axis(mesh, batch, Shard(0), Replicate() if model_dim is None
                    else Shard(model_dim))


def as_placed(t: torch.Tensor, mesh: DeviceMesh,
              placements: Sequence) -> DTensor:
    """``t`` on ``placements``: a DTensor is redistributed (a no-op when it
    is already there); a plain tensor, the same value on every rank, is
    taken as replicated first."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, tuple(placements))


def run_local(fn: Callable, args: Sequence, placements: Sequence,
              out_placements, mesh: DeviceMesh, *,
              in_grad_placements: Sequence | None = None, **kwargs):
    """``fn(*local shards, **kwargs)`` on every rank through ``local_map``:
    each of ``args`` redistributed to its entry of ``placements`` (None for
    an argument that is not a tensor), the result a DTensor (or a tuple of
    them) on ``out_placements``."""
    placed = [a if pl is None else as_placed(a, mesh, pl)
              for a, pl in zip(args, placements)]
    body = functools.partial(fn, **kwargs) if kwargs else fn
    return local_map(body, out_placements=out_placements,
                     in_placements=tuple(placements),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(in_grad_placements)),
                     device_mesh=mesh)(*placed)


def reshape(t, shape: Sequence[int]):
    """``t.reshape(shape)``, where shape splits or merges t's trailing
    dims (heads in and out of a projection's width). A placed t whose
    split dim lies over mesh dims whose product does not divide the
    split's leading factor (16 ``model`` ranks over 8 KV heads) is first
    gathered on those mesh dims, in the forward and for the gradient of a
    merge: DTensor refuses an uneven unflatten, where XLA reshards. A dim
    of size 1 split over a mesh dim of size 1 (one KV head on a one-rank
    ``model`` axis) is first marked replicated, which moves nothing:
    DTensor drops a size-1 dim from a merge and refuses to drop a split
    one."""
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _even_reshape(t, shape)

    @staticmethod
    def backward(ctx, grad):
        return _even_reshape(grad, ctx.shape), None


def _even_reshape(t: DTensor, shape: tuple) -> DTensor:
    if any(isinstance(pl, Shard) and t.shape[pl.dim] == 1
           for pl in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if isinstance(pl, Shard) and t.shape[pl.dim] == 1
            else pl for pl in t.placements])
    if len(shape) > t.ndim:             # the last dim is split
        d = t.ndim - 1
        on = [i for i, pl in enumerate(t.placements)
              if isinstance(pl, Shard) and pl.dim == d]
        if shape[d] % math.prod(t.device_mesh.size(i) for i in on):
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in on else pl
                for i, pl in enumerate(t.placements)])
    return t.reshape(shape)
