"""AdamW with a configurable moment dtype (float32 / bfloat16 / int8
blockwise), global-norm clipping, a warmup-stable-decay schedule, and int8
gradient compression with error feedback: the port of
``repro/optim/adamw.py``.

Trees are the port's parameter trees: dicts and lists of tensors. The
int8 moments are blockwise (128) absmax-scaled codes, each a dict
``{"q", "scale", "shape"}`` in place of the tensor, with the reference's
"dynamic" (mu-law) code; the gradient compression uses its "linear" code.

``adamw_update`` writes the new parameters and moments into the tensors it
was given (the counterpart of donated buffers under ``jax.jit``) and
returns them: a full-width model's state then needs no second copy. The
step counter, the learning rate and the bias corrections are float32
tensors, as in the reference; every leaf is updated in float32 and cast
back to its parameter's dtype.

Placed params (DTensors) take float32 or bfloat16 moments, placed as
their leaves, and int8 moments in the reference's block layout: a leaf's
code keeps the blocks of its flat, row-major order, placed by
``runtime/sharding.py::q8_specs`` (the block dim over every axis of (pod,
data, model) where the block count divides the product, else replicated),
whatever the leaf's own placement. Each rank updates the blocks it holds:
it brings its share of the parameter and the gradient into block order
(the layout transfer below), decodes its codes, runs the unplaced update's
ops in float32, encodes, and sends the new parameter back to the
parameter's placement. The transfer only copies, so the result is the
unplaced update's, bit for bit; where a rank's blocks are its own shard,
no data moves. It needs a mesh over the whole default process group.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

_BLOCK = 128
_DYN_K = 65535.0      # companding constant: ~4.8 decades of dynamic range


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any          # first moment (an int8 code dict per leaf at int8)
    nu: Any          # second moment
    err: Any | None  # error-feedback residual for grad compression (or None)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists of tensors) and
    the nodes at the same places in ``rest``, which may hold whole
    subtrees (an int8 code) where ``tree`` holds a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# Blockwise int8 moment quantization
# ---------------------------------------------------------------------------


def _encode_blocks(blocks: torch.Tensor, code: str):
    """(q, scale) of float32 ``blocks`` [n, 128]."""
    amax = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    if code == "dynamic":
        # mu-law companding (bnb-style dynamic quantization): linear int8
        # zeroes small second moments and Adam explodes; log-spaced codes
        # keep ~9% relative error across the whole block range.
        u = torch.log1p(blocks.abs() / amax * _DYN_K) / math.log1p(_DYN_K)
        q = torch.clamp(torch.round(u * 127.0), 0, 127) * torch.sign(blocks)
        scale = amax
    else:
        q = torch.clamp(torch.round(blocks / (amax / 127.0)), -127, 127)
        scale = amax / 127.0
    return q.to(torch.int8), scale.float()


def _decode_blocks(q: torch.Tensor, scale: torch.Tensor,
                   code: str) -> torch.Tensor:
    """The float32 values of codes ``q`` [n, 128] and ``scale`` [n, 1],
    flat."""
    q = q.float()
    if code == "dynamic":
        mag = torch.expm1(q.abs() / 127.0 * math.log1p(_DYN_K)) / _DYN_K \
            * scale
        return (mag * torch.sign(q)).reshape(-1)
    return (q * scale).reshape(-1)


def _shape_code(shape, code: str, device) -> torch.Tensor:
    marker = 1 if code == "linear" else 2
    return torch.tensor(tuple(shape) + (marker,), dtype=torch.int32,
                        device=device)


def _q8_encode(x: torch.Tensor, code: str = "linear") -> dict:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    q, scale = _encode_blocks(flat.reshape(-1, _BLOCK), code)
    return {"q": q, "scale": scale,
            "shape": _shape_code(x.shape, code, x.device)}


def _q8_decode(enc: dict, shape, code: str = "linear") -> torch.Tensor:
    flat = _decode_blocks(enc["q"], enc["scale"], code)
    return flat[:math.prod(shape)].reshape(shape)


def _moment_like(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        if isinstance(p, DTensor):
            return _placed_zero_code(p)
        return _q8_encode(torch.zeros_like(p, dtype=torch.float32),
                          code="dynamic")
    return torch.zeros_like(p, dtype=getattr(torch, dtype))


def adamw_init(params, moment_dtype: str = "float32",
               error_feedback: bool = False) -> AdamWState:
    """Zero moments beside every leaf, on the leaf's device (placed as
    the leaf, for a placed tree; an int8 moment's code by the block rule,
    ``runtime/sharding.py::q8_specs``, on the leaf's mesh)."""
    with torch.no_grad():
        mu = tree_map(lambda p: _moment_like(p, moment_dtype), params)
        nu = tree_map(lambda p: _moment_like(p, moment_dtype), params)
        err = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params) if error_feedback else None)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          mu, nu, err)


def _read_moment(m, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(m, shape, code="dynamic")
    return m.float()


def _write_moment(dst, x: torch.Tensor, dtype: str) -> None:
    if dtype == "int8":
        enc = _q8_encode(x, code="dynamic")
        dst["q"].copy_(enc["q"])
        dst["scale"].copy_(enc["scale"])
    else:
        dst.copy_(x)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, moment_dtype: str = "float32"):
    """One AdamW step, leaf by leaf in float32, written in place into
    ``params`` and ``state``'s moments. Returns (params, new state). A
    placed leaf with int8 moments is updated where its blocks live
    (``_update_placed_q8``), bit for bit the unplaced update."""
    step = state.step + 1
    # A replicated step (the dry run places every argument) is its local
    # value: the scalars below then enter each rank's own blocks as they
    # enter an unplaced leaf.
    step_ = step.to_local() if isinstance(step, DTensor) else step
    f32 = dict(dtype=torch.float32, device=step_.device)
    lr_t = lr(step_) if callable(lr) else torch.tensor(lr, **f32)
    stepf = step_.float()
    bc1 = 1 - torch.tensor(b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(b2, **f32) ** stepf

    def adam(p32, g32, m, v):
        """The float32 update of one leaf: (new p, new m, new v)."""
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        upd_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return p32 - lr_t * (upd_ + weight_decay * p32), m, v

    def upd(p, g, mu, nu):
        if moment_dtype == "int8" and isinstance(p, DTensor):
            return _update_placed_q8(p, g, mu, nu, adam)
        p32, m, v = adam(p.float(), g.float(),
                         _read_moment(mu, p.shape, moment_dtype),
                         _read_moment(nu, p.shape, moment_dtype))
        p.copy_(p32)
        _write_moment(mu, m, moment_dtype)
        _write_moment(nu, v, moment_dtype)

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step, state.mu, state.nu, state.err)


# ---------------------------------------------------------------------------
# int8 moments of placed leaves: the block layout and its transfer
# ---------------------------------------------------------------------------
#
# A leaf of global shape S holds n elements in flat, row-major order; its
# code holds ceil(n / 128) blocks of 128 of them. A rank's *box* is its
# parameter shard (a range on each dim: the placements' even split, mesh
# dims first-major, as DTensor splits), its *range* the elements of the
# blocks it holds ([lo * 128, hi * 128) clipped to n; padding past n is
# zeros, as in ``_q8_encode``). Along a box's local flat order the global
# flat index only grows, so the box's elements in any range are one
# contiguous slice of the box's local memory; in the range they fall on
# runs of the box's last partial dim, found without visiting elements.
#
# ``to_blocks`` brings each rank its range's elements from the boxes;
# ``from_blocks`` brings each rank its box's elements from the ranges. A
# rank takes a piece from the holder that shares its coordinates on the
# mesh dims over which the source layout is replicated (itself, where it
# holds the piece). Off-rank pieces move in one ``all_to_all_single`` of
# the default group (a rank's own pieces are copied locally); where no
# rank needs an off-rank piece, nothing is dispatched. Under gloo a CUDA
# tensor goes through pinned host buffers (gloo gathers, scatters and
# sends no CUDA tensor); ``fake`` (the dry run) exchanges shapes only.
#
# Bit for bit: the update's ops are elementwise but for each block's
# absmax, which is exact. A CUDA kernel computes every element alike; on
# the CPU, ATen splits a large op over threads at offsets that need not
# be multiples of the vector width, and ``expm1``/``log1p`` on a scalar
# tail may differ in the last bit from the vector body: the placed and
# the unplaced update agree there when each runs on one thread.

transfer_counts = {"calls": 0, "bytes": 0, "ms": 0.0}
_CHUNK_BLOCKS = 1 << 17      # blocks updated at once: 16.8 M elements


def reset_transfer_counts() -> None:
    """Zero ``transfer_counts``: the transfer's collectives on this rank,
    the bytes it sent off-rank and the host ms spent in them."""
    transfer_counts.update(calls=0, bytes=0, ms=0.0)


def _shard_dims(placements) -> tuple:
    """Per mesh dim, the tensor dim it shards, or None (replicated)."""
    out = []
    for pl in placements:
        if isinstance(pl, Shard):
            out.append(pl.dim)
        elif isinstance(pl, Replicate):
            out.append(None)
        else:
            raise NotImplementedError(
                f"int8 moments of a leaf placed {tuple(placements)}: only "
                f"Shard and Replicate placements are taken")
    return tuple(out)


def _box(shape: tuple, dims: tuple, sizes: tuple, coord: tuple) -> tuple:
    """The (start, stop) of each dim of the shard at mesh ``coord``, for a
    tensor of ``shape`` split on ``dims`` (per mesh dim: a tensor dim or
    None) over mesh dims of ``sizes``: evenly, mesh dims first-major."""
    lo, ext = [0] * len(shape), list(shape)
    for i, d in enumerate(dims):
        if d is None:
            continue
        if ext[d] % sizes[i]:
            raise ValueError(f"dim {d} of {shape} does not split evenly "
                             f"over mesh dims {sizes}")
        ext[d] //= sizes[i]
        lo[d] += coord[i] * ext[d]
    return tuple((a, a + e) for a, e in zip(lo, ext))


def _below(shape: tuple, box: tuple, x: int) -> int:
    """How many of ``box``'s elements have a global flat index below x."""
    ext = [b - a for a, b in box]
    n = math.prod(shape)
    if x >= n:
        return math.prod(ext)
    total, inner = 0, math.prod(ext)
    for d, (a, b) in enumerate(box):
        inner //= max(ext[d], 1)
        i = (x // math.prod(shape[d + 1:])) % shape[d]
        total += min(max(i - a, 0), b - a) * inner
        if not a <= i < b:
            break
    return total


def _runs(shape: tuple, box: tuple, x0: int, x1: int):
    """``box``'s elements with global index in [x0, x1): (local start,
    local stop) in the box's flat order, and the global starts and lengths
    of the runs they fall on (numpy int64)."""
    lo, hi = _below(shape, box, x0), _below(shape, box, x1)
    if hi <= lo:
        return lo, lo, np.zeros(0, np.int64), np.zeros(0, np.int64)
    partial = [d for d, ((a, b), s) in enumerate(zip(box, shape))
               if b - a < s]
    if not partial:
        return lo, hi, np.array([lo], np.int64), np.array([hi - lo], np.int64)
    j = partial[-1]
    stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    run = (box[j][1] - box[j][0]) * stride[j]
    m = np.arange(lo // run, (hi - 1) // run + 1, dtype=np.int64)
    start = np.maximum(m * run, lo)
    length = np.minimum((m + 1) * run, hi) - start
    first = start - m * run + box[j][0] * stride[j]
    rest = m
    for d in range(j - 1, -1, -1):
        ext = box[d][1] - box[d][0]
        first += (box[d][0] + rest % ext) * stride[d]
        rest //= ext
    return lo, hi, first, length


class _Plan(NamedTuple):
    """One rank's transfers for one leaf (peers as flat mesh coordinates).
    ``to_send``: (peer, box slice) to send in ``to_blocks``; ``to_recv``:
    (peer, range runs) to receive, this rank's own first where it holds a
    piece; ``from_send`` / ``from_recv`` the same for ``from_blocks``, runs
    and slices swapped. ``to_moves`` / ``from_moves``: whether any rank
    needs an off-rank piece."""
    n: int
    first: int          # this rank's first element (its first block x 128)
    span: int           # its blocks x 128
    to_send: tuple
    to_recv: tuple
    from_send: tuple
    from_recv: tuple
    to_moves: bool
    from_moves: bool


def _code_range(n: int, q_dims: tuple, sizes: tuple, coord: tuple) -> tuple:
    blocks = -(-n // _BLOCK)
    (b0, b1), _ = _box((blocks, _BLOCK), q_dims, sizes, coord)
    return b0 * _BLOCK, b1 * _BLOCK


@functools.lru_cache(maxsize=4096)
def _plan(shape: tuple, p_dims: tuple, q_dims: tuple, sizes: tuple,
          coord: tuple) -> _Plan:
    n = math.prod(shape)
    coords = list(np.ndindex(*sizes))
    box = {c: _box(shape, p_dims, sizes, c) for c in coords}
    rng = {c: _code_range(n, q_dims, sizes, c) for c in coords}

    def flat(c):
        return int(np.ravel_multi_index(c, sizes)) if c else 0

    def source(piece, dst, dims):
        """The holder of ``piece`` (its coordinates on the mesh dims that
        ``dims`` shard) that shares ``dst``'s coordinates elsewhere."""
        return tuple(p if d is not None else t
                     for p, t, d in zip(piece, dst, dims))

    def inside(c):   # |box(c) & range(c)|
        x0, x1 = rng[c]
        return _below(shape, box[c], x1) - _below(shape, box[c], x0)

    me, (e0, e1) = coord, rng[coord]
    to_moves = any(inside(c) < max(min(rng[c][1], n) - rng[c][0], 0)
                   for c in coords)
    from_moves = any(inside(c) < math.prod(b - a for a, b in box[c])
                     for c in coords)
    to_send, to_recv, from_send, from_recv = [], [], [], []
    for c in coords:
        # to_blocks: c's range from this rank's box, where c takes it here.
        if source(me, c, p_dims) == me:
            lo, hi, _, _ = _runs(shape, box[me], *rng[c])
            if hi > lo:
                to_send.append((flat(c), lo, hi))
        # from_blocks: c's box from this rank's range, where c takes it here.
        if source(me, c, q_dims) == me:
            _, _, first, length = _runs(shape, box[c], *rng[me])
            if len(length):
                from_send.append((flat(c), first - e0, length))
    for piece in {tuple(c[i] if p_dims[i] is not None else me[i]
                        for i in range(len(sizes))) for c in coords}:
        _, _, first, length = _runs(shape, box[piece], e0, e1)
        if len(length):
            to_recv.append((flat(piece), first - e0, length))
    for piece in {tuple(c[i] if q_dims[i] is not None else me[i]
                        for i in range(len(sizes))) for c in coords}:
        lo, hi, _, _ = _runs(shape, box[me], *rng[piece])
        if hi > lo:
            from_recv.append((flat(piece), lo, hi))
    return _Plan(n, e0, e1 - e0, tuple(to_send), tuple(sorted(
        to_recv, key=lambda r: r[0])), tuple(from_send),
        tuple(sorted(from_recv)), to_moves, from_moves)


def layout_case(p: DTensor, q: DTensor) -> int:
    """Which layout transfer a placed leaf ``p`` with block codes ``q``
    takes: 1, every rank's blocks are its own shard (no data moves); 2,
    both placed and elements move; 3, one of the two replicated and the
    other not; 0, both replicated."""
    p_rep = all(d is None for d in _shard_dims(p.placements))
    q_rep = all(d is None for d in _shard_dims(q.placements))
    if p_rep and q_rep:
        return 0
    if p_rep or q_rep:
        return 3
    plan = _plan_of(p, q)
    return 2 if plan.to_moves or plan.from_moves else 1


def _plan_of(p: DTensor, q: DTensor) -> _Plan:
    mesh = p.device_mesh
    if q.device_mesh != mesh:
        raise ValueError("a placed leaf's int8 codes must lie on its mesh")
    if mesh.size() != dist.get_world_size():
        raise NotImplementedError(
            f"int8 moments on a mesh of {mesh.size()} ranks in a default "
            f"group of {dist.get_world_size()}: the layout transfer "
            f"exchanges over the default group")
    return _plan(tuple(p.shape), _shard_dims(p.placements),
                 _shard_dims(q.placements), tuple(mesh.mesh.shape),
                 tuple(mesh.get_coordinate()))


def _positions(first: np.ndarray, length: np.ndarray,
               device) -> torch.Tensor:
    """The element indices of runs (``first``, ``length``), in order."""
    total = int(length.sum())
    if torch.device(device).type == "meta":
        return torch.empty(total, dtype=torch.long, device="meta")
    offset = first - (np.cumsum(length) - length)
    return torch.from_numpy(np.repeat(offset, length)).to(device) + \
        torch.arange(total, device=device)


def _run_views(buf: torch.Tensor, first: np.ndarray,
               length: np.ndarray) -> list | None:
    """Views of the contiguous ``buf`` (a row per element) that cover the
    runs (``first``, ``length``) in order: runs of one length at one
    stride (a sharded dim's rows) as one strided view, a first and a last
    run cut short by the range's ends alone. None where the runs follow no
    such pattern (then an index)."""
    n, tail = len(first), tuple(buf.shape[1:])
    k = math.prod(tail)

    def run(i):
        return buf[int(first[i]):int(first[i] + length[i])]

    def uniform(a, b):
        return b - a >= 2 and bool((length[a:b] == length[a]).all()) and \
            bool((np.diff(first[a:b]) == first[a + 1] - first[a]).all())

    if n <= 2:
        return [run(i) for i in range(n)]
    for a, b in ((0, n), (1, n), (0, n - 1), (1, n - 1)):
        if uniform(a, b):
            stride, m, ln = int(first[a + 1] - first[a]), b - a, int(length[a])
            mid = buf.as_strided((m, ln) + tail,
                                 (stride * k, k) + buf.stride()[1:],
                                 buf.storage_offset() + int(first[a]) * k)
            return [run(i) for i in range(a)] + [mid] + \
                [run(i) for i in range(b, n)]
    return None


def _scatter(buf: torch.Tensor, first, length, src: torch.Tensor) -> None:
    """Write ``src`` (rows in order) to the runs of ``buf``."""
    views = _run_views(buf, first, length)
    if views is None:
        buf[_positions(first, length, buf.device)] = src
        return
    at = 0
    for v in views:
        n = math.prod(v.shape[:v.ndim - buf.ndim + 1])
        v.copy_(src[at:at + n].view(v.shape))
        at += n


def _gather(buf: torch.Tensor, first, length) -> torch.Tensor:
    """The rows of ``buf``'s runs, in order."""
    views = _run_views(buf, first, length)
    if views is None:
        return buf[_positions(first, length, buf.device)]
    tail = tuple(buf.shape[1:])
    return torch.cat([v.reshape((-1,) + tail) for v in views])


def _exchange(mesh, chunks: list, counts: list, like: torch.Tensor) -> list:
    """Send each (peer, tensor) of ``chunks`` and receive (peer, count)
    rows of ``counts`` (peers as flat mesh coordinates) in one
    ``all_to_all_single`` over the default group; the received tensors in
    ``counts``' order."""
    ranks = mesh.mesh.reshape(-1).tolist()
    world = dist.get_world_size()
    send_n, recv_n = [0] * world, [0] * world
    for peer, t in chunks:
        send_n[ranks[peer]] = t.shape[0]
    for peer, k in counts:
        recv_n[ranks[peer]] = k
    order = sorted(range(len(chunks)), key=lambda i: ranks[chunks[i][0]])
    tail = tuple(like.shape[1:])
    send = torch.cat([chunks[i][1] for i in order]) if chunks else \
        like.new_empty((0,) + tail)
    recv = like.new_empty((sum(recv_n),) + tail)
    backend = dist.get_backend()
    staged = like.device.type == "cuda" and backend == "gloo"
    if like.device.type == "cuda" and backend not in ("gloo", "nccl"):
        raise NotImplementedError(f"the int8 moments' transfer of CUDA "
                                  f"tensors under {backend!r}")
    t0 = time.perf_counter()
    if staged:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        send = host.copy_(send)
        out = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
    else:
        out = recv
    dist.all_to_all_single(out, send, recv_n, send_n)
    if staged:
        recv.copy_(out)
    transfer_counts["calls"] += 1
    transfer_counts["bytes"] += send.numel() * send.element_size()
    transfer_counts["ms"] += (time.perf_counter() - t0) * 1e3
    pieces = recv.split([recv_n[ranks[peer]] for peer, _ in sorted(
        counts, key=lambda r: ranks[r[0]])])
    by_peer = {peer: t for (peer, _), t in zip(sorted(
        counts, key=lambda r: ranks[r[0]]), pieces)}
    return [by_peer[peer] for peer, _ in counts]


def _to_blocks(plan: _Plan, mesh, me: int, box: torch.Tensor) -> torch.Tensor:
    """This rank's range [span, k] from the local box ``box`` [box n, k],
    zeros past the leaf's end."""
    out = box.new_zeros((plan.span,) + tuple(box.shape[1:]))
    own = [(p, f, ln) for p, f, ln in plan.to_recv if p == me]
    peers = [(p, f, ln) for p, f, ln in plan.to_recv if p != me]
    src = [box[lo:hi] for p, lo, hi in plan.to_send if p == me]
    if plan.to_moves:
        src += _exchange(mesh, [(p, box[lo:hi]) for p, lo, hi in
                                plan.to_send if p != me],
                         [(p, int(ln.sum())) for p, _, ln in peers], box)
    for (_, first, length), rows in zip(own + peers, src):
        _scatter(out, first, length, rows)
    return out


def _from_blocks(plan: _Plan, mesh, me: int, rng: torch.Tensor,
                 box: torch.Tensor) -> None:
    """Write into the local box ``box`` [box n] its elements from the
    ranks' ranges, this rank's being ``rng`` [span]."""
    for p, lo, hi in plan.from_recv:
        if p == me:
            f, ln = next((f, ln) for q, f, ln in plan.from_send if q == me)
            box[lo:hi] = _gather(rng, f, ln)
    if not plan.from_moves:
        return
    peers = [(p, lo, hi) for p, lo, hi in plan.from_recv if p != me]
    got = _exchange(mesh, [(p, _gather(rng, f, ln))
                           for p, f, ln in plan.from_send if p != me],
                    [(p, hi - lo) for p, lo, hi in peers], rng)
    for (_, lo, hi), t in zip(peers, got):
        box[lo:hi] = t


def _update_placed_q8(p: DTensor, g, mu: dict, nu: dict, adam) -> None:
    """The int8-moment update of a placed leaf, each rank on its blocks:
    its share of p and g into block order (``to_blocks``), the moments
    decoded, ``adam`` (the unplaced update's ops), the moments encoded
    into the local codes, the new p back to p's placement."""
    from repro_torch.kernels import _local
    for m in (mu, nu):
        if not isinstance(m["q"], DTensor) or \
                m["q"].placements != mu["q"].placements:
            raise ValueError("the int8 moments of a placed leaf must be "
                             "placed by runtime/sharding.py::opt_shardings "
                             "(adamw_init on the placed params)")
    mesh = p.device_mesh
    plan = _plan_of(p, mu["q"])
    me = int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                  tuple(mesh.mesh.shape)))
    p_loc = p.to_local()
    g_loc = _local.as_placed(g, mesh, p.placements).to_local()
    # One exchange carries both; float32 where their dtypes differ (exact).
    dt = p_loc.dtype if g_loc.dtype == p_loc.dtype else torch.float32
    pg = _to_blocks(plan, mesh, me, torch.stack(
        (p_loc.reshape(-1).to(dt), g_loc.reshape(-1).to(dt)), dim=1))
    codes = [(m["q"].to_local(), m["scale"].to_local()) for m in (mu, nu)]
    valid = min(plan.n - plan.first, plan.span)
    new_p = p_loc.new_empty(valid)
    # Chunks of whole blocks bound the float32 temporaries (each block's
    # update is its own: the result does not depend on the chunking).
    for b0 in range(0, plan.span // _BLOCK, _CHUNK_BLOCKS):
        x0 = b0 * _BLOCK
        x1 = min(x0 + _CHUNK_BLOCKS * _BLOCK, plan.span)
        b1 = x1 // _BLOCK
        p32, m, v = adam(pg[x0:x1, 0].float(), pg[x0:x1, 1].float(),
                         *(_decode_blocks(q[b0:b1], scale[b0:b1], "dynamic")
                           for q, scale in codes))
        for x, (q, scale) in zip((m, v), codes):
            x[max(valid - x0, 0):] = 0
            q[b0:b1], scale[b0:b1] = _encode_blocks(x.reshape(-1, _BLOCK),
                                                    "dynamic")
        new_p[x0:min(x1, valid)] = p32[:min(x1, valid) - x0]
    del pg
    box = p_loc.view(-1) if p_loc.is_contiguous() else \
        p_loc.new_empty(p_loc.numel())
    _from_blocks(plan, mesh, me, new_p, box)
    if not p_loc.is_contiguous():
        p_loc.copy_(box.view(p_loc.shape))


def _placed_zero_code(p: DTensor) -> dict:
    """The zero int8 code of a placed leaf, placed by the block rule on its
    mesh: each rank makes its own shard (no data moves)."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.runtime import sharding as SH
    mesh = p.device_mesh
    blocks = -(-p.numel() // _BLOCK)
    sh = SH.named_sharding(mesh, SH.q8_code_spec(blocks, mesh_shape(mesh)))
    rows = SH.shard_shape((blocks, 1), sh.spec, mesh_shape(mesh))[0]
    device = p.to_local().device

    def placed(local, shape, placements):
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=(shape[1], 1) if len(shape) == 2
                                  else (1,))

    # The zero block's scale is _q8_encode's floor on its absmax.
    return {"q": placed(torch.zeros((rows, _BLOCK), dtype=torch.int8,
                                    device=device), (blocks, _BLOCK),
                        sh.placements),
            "scale": placed(torch.full((rows, 1), 1e-12, device=device),
                            (blocks, 1), sh.placements),
            "shape": placed(_shape_code(p.shape, "dynamic", device),
                            (p.ndim + 1,), [Replicate()] * mesh.ndim)}


# ---------------------------------------------------------------------------
# Gradient clipping / schedule / compression
# ---------------------------------------------------------------------------


@torch.no_grad()
def _norm_and_scale(leaves, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """(grads scaled to a global L2 norm of at most ``max_norm``, in their
    own dtypes; the norm before scaling, a float32 tensor)."""
    gn, scale = _norm_and_scale(tree_leaves(grads), max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """``clip_by_global_norm`` written into ``grads`` in place (the same
    values), so that no second gradient tree is allocated; returns the
    norm before scaling."""
    leaves = tree_leaves(grads)
    gn, scale = _norm_and_scale(leaves, max_norm)
    for g in leaves:
        g.copy_((g.float() * scale).to(g.dtype))
    return gn


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1):
    """Warmup-stable-decay (linear warmup, constant, cosine tail), in
    float32 on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        decay_start = total * (1 - decay_frac)
        t = torch.clamp((s - decay_start) / max(total - decay_start, 1),
                        0, 1)
        return peak_lr * w * (0.5 * (1 + torch.cos(math.pi * t))
                              if decay_frac > 0 else 1.0)
    return lr


@torch.no_grad()
def compress_grads(grads, err):
    """int8 blockwise compression with error feedback: returns
    (compressed tree, new_err). Decompress with ``decompress_grads`` after
    the all-reduce."""
    def one(g, e):
        g32 = g.float() + e
        enc = _q8_encode(g32)
        return enc, g32 - _q8_decode(enc, g.shape)
    pairs = tree_map(one, grads, err)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i):
    """The ``i``-th element of every (code, residual) pair of ``tree``."""
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]


@torch.no_grad()
def decompress_grads(comp, shapes):
    """The float32 gradients of ``comp``, shaped as the leaves of
    ``shapes``."""
    return tree_map(lambda ref, enc: _q8_decode(enc, ref.shape), shapes,
                    comp)
