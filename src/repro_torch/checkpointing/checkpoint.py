"""Sharded, atomic checkpointing (no external deps), the port of
``repro/checkpointing/checkpoint.py``.

Layout:  <dir>/step_<N>/shard_<host>.npz + manifest.json
* atomic: writes go to step_<N>.tmp, manifest last, then rename; a
  crashed writer never corrupts the latest complete step, and a step
  without its manifest is ignored;
* keys are the tree's paths joined by "/" (dict keys, list indices, a
  NamedTuple's fields as ".name"), as the reference writes them;
* bfloat16 leaves are widened to float32 in the ``.npz`` (exact);
  ``restore`` casts back into ``like``'s dtypes on ``like``'s device.

The port keeps a segment's layers as a list (``params["seg0"][i]``) where
the reference stacks them on a leading axis (``params["seg0"]``), so
``restore`` also reads the reference's files: a key missing under its
list index is read from the stacked array at that index.

Each leaf goes to the host and into the archive on its own, so a
full-width state never stands on the host whole. A placed tree (DTensor
leaves on a mesh) has one writer, rank 0 of the default process group:
every rank gathers each leaf in turn (``full_tensor``, a collective), rank
0 writes it, then the manifest last; a barrier holds every rank until the
step is complete. ``restore_resharded`` restores and places the tree
under the current mesh's shardings, whatever mesh wrote it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import zipfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime.sharding import place


def _items(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs of ``tree`` in order; a path is a tuple of dict
    keys, list or tuple indices and NamedTuple fields (".name")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()      # exact; restore casts back
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any, *, host_id: int = 0,
         n_hosts: int = 1, keep: int = 3) -> str:
    """Write this host's shard; host 0 writes the manifest last (atomic).
    A placed tree is written whole by rank 0 alone (``host_id`` 0 of one
    host), every rank of the default group taking part in each leaf's
    gather; every rank returns once the step is complete."""
    placed = any(isinstance(leaf, DTensor) for _, leaf in _items(tree))
    if placed:
        host_id, n_hosts = 0, 1
    writer = not placed or dist.get_rank() == 0
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    keys = {}
    if writer:
        os.makedirs(tmp, exist_ok=True)
    # np.savez's own layout (one .npy per key in a zip64 archive), written
    # one leaf at a time.
    with (zipfile.ZipFile(os.path.join(tmp, f"shard_{host_id}.npz"), "w",
                          zipfile.ZIP_STORED, allowZip64=True)
          if writer else contextlib.nullcontext()) as zf:
        for path, leaf in _items(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()       # every rank gathers
            if not writer:
                continue
            arr = _to_numpy(leaf)
            key = _key(path)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            keys[key] = [list(arr.shape), str(arr.dtype)]
            del leaf, arr
    if writer and host_id == 0:
        manifest = {"step": step, "n_hosts": n_hosts, "keys": keys}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(directory, keep)
    if placed:
        dist.barrier()
    return final


def _gc(directory: str, keep: int) -> None:
    for s in _complete_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def _complete_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def _read(z, path: tuple) -> np.ndarray:
    """The array at ``path``, or, where a list index in the path names a
    layer of a segment the reference wrote stacked, that layer of the
    stacked array."""
    key = _key(path)
    if key in z.files:
        return z[key]
    for i, p in enumerate(path):
        if isinstance(p, int):
            stacked = _key(path[:i] + path[i + 1:])
            if stacked in z.files:
                return z[stacked][p]
    raise KeyError(f"checkpoint has no array for {key!r}")


def _map(fn, tree: Any, prefix: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, its
    structure kept (dicts, lists, tuples, NamedTuples; None stays)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, prefix + (f".{k}",))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def skeleton(tree: Any) -> tuple[Any, torch.device]:
    """``(like, device)``: ``tree`` with every leaf an empty tensor of its
    shape and dtype on the ``meta`` device, and the one device all its
    leaves lie on. ``restore(..., like, device=device)`` then needs
    nothing of ``tree``, which can be let go first."""
    devices = {leaf.device for _, leaf in _items(tree)}
    if len(devices) != 1:
        raise ValueError(f"a tree on one device is needed, not {devices}")
    like = _map(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                         device="meta"), tree)
    return like, devices.pop()


def restore(directory: str, step: int, like: Any, *, host_id: int = 0,
            device=None) -> Any:
    """Restore into the structure, shapes and dtypes of ``like``, on each
    leaf's device (``device``, where given, for every leaf: ``like`` may
    then be built on the ``meta`` device, shapes only). An array whose
    shape is not its ``like`` leaf's raises ``ValueError``."""
    path = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(path, f"shard_{host_id}.npz")) as z:
        def build(prefix, node):
            arr = np.require(_read(z, prefix), requirements=["C", "W"])
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(
                    f"checkpoint {path}: {_key(prefix)!r} has shape "
                    f"{tuple(arr.shape)}, the state {tuple(node.shape)}")
            return torch.from_numpy(arr).to(
                device=device if device is not None else node.device,
                dtype=node.dtype)
        return _map(build, like)


def restore_resharded(directory: str, step: int, like: Any,
                      shardings: Any) -> Any:
    """Elastic restore: ``restore`` into ``like``'s structure, shapes and
    dtypes (on each leaf's device), then ``place`` under the current
    mesh's shardings (``runtime/sharding.py``), which may be of another
    shape than the mesh that saved the step: every rank reads the whole
    step and keeps its own shard."""
    return place(restore(directory, step, like), shardings)
