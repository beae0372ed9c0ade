"""Sharding rules of the pjit (TP + DP [+ pod]) path, the port of
``repro/runtime/sharding.py``'s rules as pure functions over a mesh's
shape: an ordered dict of axis sizes (``launch/mesh.py::
production_mesh_shape``).

Rules are keyed by parameter path suffix; they compose Megatron-style
tensor parallelism over the ``model`` axis with FSDP-style parameter
sharding over ``data`` for the very large archs, ZeRO-1 optimizer-state
sharding, and pod data parallelism.

Each function maps a tree (dicts, lists and the optimizer's named tuple)
of tensors, or of anything with ``shape`` and ``dtype``, to a tree of the
same structure whose leaves are specs: a tuple with one entry per dim,
each ``None`` (replicated), an axis name, or a tuple of axis names (the
dim split over their product), the entries of the reference's
``PartitionSpec``. ``shard_bytes`` gives the bytes one device holds of a
leaf under its spec; the dry run (``launch/dryrun.py``) reads these rules
to count the bytes each device holds.

``q8_specs`` is the reference dry run's rule for AdamW's int8 moments
(``_opt_shardings``): a moment's block codes split their block dim over
every axis of (pod, data, model) when the block count divides the
product, else replicated; the shape code replicated. ``opt_shardings``
places an optimizer state by it.

``param_shardings``, ``batch_shardings``, ``cache_shardings`` and
``opt_state_shardings`` turn the specs into :class:`Sharding` objects, the
counterpart of ``jax.sharding.NamedSharding``: a ``DeviceMesh`` and one
DTensor placement per mesh dimension. A mesh dimension named by a tensor
dimension's entry gets ``Shard(that dim)``, every other one
``Replicate()``; a tuple such as ``("pod", "data")`` puts ``Shard(d)`` on
each of its mesh dimensions, which splits d over their product with the
first one major, as a ``PartitionSpec`` does (the tuple must follow the
mesh's order, as every rule here writes it). ``place`` puts a tree on
its shardings (``distribute_tensor``), the counterpart of
``jax.device_put``.

The port keeps each segment as a list of per-layer dicts where the
reference stacks them on a leading axis. Parameter rules describe the
trailing dims, so a per-layer leaf gets the stacked leaf's spec without
its leading ``None``; a path joins dict keys only, as the reference's
does. The cache rule names the batch and sequence dims by position, 1
and 2 of the reference's stacked [L, B, S, ...] leaves: here 0 and 1 of a
per-layer leaf. Host ints (the port's cache ``idx`` and ``_pos``) hold no
device bytes and are replicated.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_shape

Spec = tuple

# (regex over the "/"-joined path, spec of the trailing dims). Leading
# layer-stack dims are handled generically: specs below describe the
# *trailing* dims and are left-padded with None.
_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", "fsdp")),             # [V, D] vocab-parallel
    (r"lm_head/w$", ("fsdp", "model")),         # [D, V]
    (r"(wq|wk|wv|wi|wg)/w$", ("fsdp", "model")),
    (r"(wo|cm_wv)/w$", ("model", "fsdp")),
    (r"(wq_b|wkv_b|cm_wk)/w$", ("fsdp", "model")),
    (r"(wq_a|wkv_a)/w$", ("fsdp", None)),
    (r"router/w$", (None, None)),
    (r"mlp/(wi|wg)$", ("model", "fsdp", None)),     # MoE expert stacks [E,D,F]
    (r"mlp/wo$", ("model", None, "fsdp")),          # [E,F,D]
    (r"(w_input_gate|w_rec_gate)/w$", ("fsdp", "model")),
    (r"(wx|wy)/w$", ("fsdp", "model")),
    (r"(ddl_w1|dec_w1)$", ("fsdp", None)),
    (r"(ddl_w2)$", (None, None, "fsdp")),
    (r"(dec_w2)$", (None, "fsdp")),
    (r"shared/(wi|wg)/w$", ("fsdp", "model")),
    (r"shared/wo/w$", ("model", "fsdp")),
]


def _spec_for(path: str, ndim: int, fsdp: bool) -> Spec:
    for pat, dims in _RULES:
        if re.search(pat, path):
            trail = [("data" if d == "fsdp" and fsdp else
                      (None if d == "fsdp" else d)) for d in dims]
            pad = [None] * (ndim - len(trail))
            return tuple(pad + trail)
    return ()  # replicated (norms, biases, small vectors)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    """A leaf's shape; a host int (the cache's ``idx``) is a scalar."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree`` (dicts, lists, named
    tuples; ``None`` stays ``None``). The path joins dict keys and named
    tuple fields with "/"; list indices (a segment's layers) are left
    out, so a per-layer leaf has its stacked counterpart's path."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(
            fn, getattr(tree, f), f"{path}/{f}" if path else f)
            for f in tree._fields))
    if tree is None:
        return None
    return fn(path, tree)


def _split(entry) -> tuple:
    """The mesh axes a spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divides(dim: int, entry, mesh_shape: dict) -> bool:
    n = math.prod(mesh_shape[a] for a in _split(entry))
    return dim % n == 0 and dim >= n


def shard_shape(shape: tuple, spec: Spec, mesh_shape: dict) -> tuple:
    """The shape of one device's shard of ``shape`` under ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        n = math.prod(mesh_shape[a] for a in _split(
            spec[i] if i < len(spec) else None))
        if dim % n:
            raise ValueError(f"dim {i} of {shape} does not split over "
                             f"{spec[i]} ({n} devices)")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(t, spec: Spec, mesh_shape: dict) -> int:
    """Bytes one device holds of ``t`` under ``spec``; 0 for a host int."""
    if not hasattr(t, "shape"):
        return 0
    return math.prod(shard_shape(tuple(t.shape), spec, mesh_shape)) * \
        t.dtype.itemsize


def tree_shard_bytes(tree, specs, mesh_shape: dict) -> int:
    """``shard_bytes`` summed over the leaves of ``tree`` and their specs
    (a tree of ``tree``'s structure)."""
    total = 0

    def add(node, spec):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                add(v, spec[k])
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                add(v, s)
        elif node is not None:
            total += shard_bytes(node, spec, mesh_shape)

    add(tree, specs)
    return total


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, mesh_shape: dict, params: Any,
                fsdp: bool | None = None) -> Any:
    """A spec per leaf of a params tree. fsdp defaults to on for models
    too big for TP-only sharding (over 16e9 parameters)."""
    if fsdp is None:
        from repro_torch.models.transformer import param_count
        # >16B params: shard over the data axis as well (memory roof).
        fsdp = param_count(cfg) > 16e9

    def one(path, leaf):
        shape = _shape(leaf)
        spec = _spec_for(path, len(shape), fsdp)
        spec = spec + (None,) * (len(shape) - len(spec))
        # Drop axes that do not divide the mesh axis size.
        return tuple(ax if ax is not None and _divides(dim, ax, mesh_shape)
                     else None for dim, ax in zip(shape, spec))

    return map_with_path(one, params)


def _batch_axes(mesh_shape: dict, names=("pod", "data")) -> tuple:
    return tuple(a for a in names if a in mesh_shape)


def batch_specs(mesh_shape: dict, batch: Any, seq_shard: bool = False) -> Any:
    """Batch dims over (pod, data); optionally shard seq instead when the
    per-shape batch is too small (32k prefill with batch < data axis)."""
    axes = _batch_axes(mesh_shape)

    def one(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if not shape:
            return ()
        if _divides(shape[0], axes, mesh_shape):
            spec[0] = axes
        elif seq_shard and len(shape) >= 2 and \
                shape[1] % math.prod(mesh_shape[a] for a in axes) == 0:
            spec[1] = axes
        return tuple(spec)

    return map_with_path(one, batch)


def cache_specs(mesh_shape: dict, cache: Any) -> Any:
    """KV caches: the batch dim (0 of a per-layer leaf) over (pod, data)
    where divisible, and the sequence / head dim (1) over ``model``, so a
    32k cache fits per-device memory. Integer leaves (a ring's
    ``slot_pos``) and host ints are replicated."""
    axes = _batch_axes(mesh_shape)

    def one(path, leaf):
        shape = _shape(leaf)
        if not hasattr(leaf, "shape") or not leaf.dtype.is_floating_point:
            return (None,) * len(shape)   # idx / slot_pos bookkeeping
        spec = [None] * len(shape)
        if len(shape) >= 1 and _divides(shape[0], axes, mesh_shape):
            spec[0] = axes
        if len(shape) >= 2 and _divides(shape[1], "model", mesh_shape):
            spec[1] = "model"
        return tuple(spec)

    return map_with_path(one, cache)


CODE_AXES = ("pod", "data", "model")


def is_q8(node) -> bool:
    """Whether ``node`` is an int8 moment's code (``optim/adamw.py``)."""
    return isinstance(node, dict) and set(node) == {"q", "scale", "shape"}


def q8_code_spec(blocks: int, mesh_shape: dict) -> Spec:
    """The spec of an int8 moment's ``q`` [blocks, 128] and ``scale``
    [blocks, 1]: the block dim over every axis of (pod, data, model) in
    the mesh when ``blocks`` divides their product, else replicated (the
    reference dry run's ``_opt_shardings``)."""
    axes = tuple(a for a in CODE_AXES if a in mesh_shape)
    n = math.prod(mesh_shape[a] for a in axes)
    return (axes, None) if axes and blocks % n == 0 else (None, None)


def q8_specs(code: dict, mesh_shape: dict) -> dict:
    """The specs of an int8 moment's code (``is_q8``): ``q8_code_spec``
    for ``q`` and ``scale``, ``shape`` replicated."""
    spec = q8_code_spec(code["q"].shape[0], mesh_shape)
    return {"q": spec, "scale": spec,
            "shape": (None,) * len(code["shape"].shape)}


def opt_state_specs(param_sp: Any) -> Any:
    """ZeRO-1 as the reference's rules module states it: moments inherit
    parameter specs (they are further split over 'data' where fsdp
    already shards params there). The dry run's own rule, which also
    splits a replicated dim, is ``launch/dryrun.py::opt_specs``; int8
    codes are placed by ``q8_specs`` (``opt_shardings``)."""
    if isinstance(param_sp, dict):
        return {k: opt_state_specs(v) for k, v in param_sp.items()}
    if isinstance(param_sp, list):
        return [opt_state_specs(v) for v in param_sp]
    return param_sp


# ---------------------------------------------------------------------------
# Shardings on a DeviceMesh, and placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh, the spec, and the DTensor placements (one per mesh
    dimension) it gives: the counterpart of ``NamedSharding``."""
    mesh: DeviceMesh
    spec: Spec
    placements: tuple


def named_sharding(mesh: DeviceMesh, spec: Spec) -> Sharding:
    """``spec``'s placements on ``mesh``: ``Shard(d)`` on each mesh
    dimension that the entry of tensor dim d names, ``Replicate()`` on the
    rest."""
    names = mesh.mesh_dim_names
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _split(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {names}")
            if a in owner:
                raise ValueError(f"spec {spec} names {a!r} twice")
            owner[a] = d
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
    return Sharding(mesh, tuple(spec), tuple(
        Shard(owner[a]) if a in owner else Replicate() for a in names))


def _shardings(mesh: DeviceMesh, specs: Any) -> Any:
    return map_with_path(lambda _, spec: named_sharding(mesh, spec), specs)


def param_shardings(cfg: ModelConfig, mesh: DeviceMesh, params: Any,
                    fsdp: bool | None = None) -> Any:
    """A :class:`Sharding` per leaf of a params tree (``param_specs``)."""
    return _shardings(mesh, param_specs(cfg, mesh_shape(mesh), params, fsdp))


def batch_shardings(mesh: DeviceMesh, batch: Any,
                    seq_shard: bool = False) -> Any:
    """A :class:`Sharding` per leaf of a batch (``batch_specs``)."""
    return _shardings(mesh, batch_specs(mesh_shape(mesh), batch, seq_shard))


def cache_shardings(mesh: DeviceMesh, cache: Any) -> Any:
    """A :class:`Sharding` per leaf of a cache (``cache_specs``); host ints
    get one too and stay host ints when placed."""
    return _shardings(mesh, cache_specs(mesh_shape(mesh), cache))


def opt_state_shardings(param_sh: Any) -> Any:
    """ZeRO-1 as the reference's rules module states it: the moments'
    shardings are the parameters' (``opt_state_specs``). An int8 moment's
    code is placed by ``opt_shardings``."""
    return opt_state_specs(param_sh)


def opt_shardings(mesh: DeviceMesh, opt_state: Any, param_sh: Any) -> Any:
    """A :class:`Sharding` per leaf of an AdamW state (``optim/adamw.py``'s
    ``AdamWState``) beside params placed on ``param_sh``, the counterpart of
    the reference dry run's ``_opt_shardings`` for the port's update: an
    int8 moment's code by ``q8_specs``; a float32 or bfloat16 moment and
    the error-feedback residual on its parameter's sharding, as
    ``adamw_init`` places them; the step None (a plain tensor on every
    rank, which ``place`` leaves as it is)."""
    shape = mesh_shape(mesh)

    def moment(node, psh):
        if is_q8(node):
            return _shardings(mesh, q8_specs(node, shape))
        if isinstance(node, dict):
            return {k: moment(v, psh[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [moment(v, s) for v, s in zip(node, psh)]
        return psh

    return opt_state._replace(
        step=None, mu=moment(opt_state.mu, param_sh),
        nu=moment(opt_state.nu, param_sh),
        err=None if opt_state.err is None else param_sh)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` with each tensor leaf a DTensor on its :class:`Sharding`
    (a tree of ``tree``'s structure), the counterpart of
    ``jax.device_put``; host ints, and leaves whose sharding is None, stay
    as they are. Every rank holds the leaf's whole value, as every process
    of a jax program holds a global array's: each takes its own shard, and
    no data moves between ranks
    (``src_data_rank=None``). The placed tree shares no storage with
    ``tree`` (AdamW writes placed params in place). A DTensor leaf is
    redistributed."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor) or sh is None:
            return leaf
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        placed = distribute_tensor(leaf, sh.mesh, sh.placements,
                                   src_data_rank=None)
        if placed.to_local().untyped_storage().data_ptr() == \
                leaf.untyped_storage().data_ptr():
            placed = placed.clone()     # the shard was a view of the leaf
        return placed
    return _zip_map(one, tree, shardings)


def _zip_map(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, node)`` over ``tree``'s leaves and the nodes at the same
    places of ``other`` (dicts, lists, tuples, named tuples; ``None``
    stays)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    if isinstance(tree, tuple):
        items = (_zip_map(fn, v, o) for v, o in zip(tree, other))
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    if tree is None:
        return None
    return fn(tree, other)
