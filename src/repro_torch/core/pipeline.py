"""The flexible layer pipeline on ``torch.distributed``, the port of
``repro/core/pipeline.py`` (the paper's architecture at LM scale).

The pod's model axis is factored into ``stage x tp`` (the stage count and
boundaries from ``core/allocator.py::plan_pipeline``, Algorithm 1's
analogue). Every stage is resident at once, one rank per (pod, data,
stage, tp) coordinate, one process each. Microbatches stream through the
stages in a GPipe fill and drain of K + S - 1 ticks: every stage computes
every tick, stage 0 taking microbatch ``clip(t - s, 0, K - 1)``, and the
last stage keeping its valid ticks. Between ticks each stage hands its
output to the next (``_StageHandoff``, point to point on the ``stage``
group: the counterpart of ``lax.ppermute``; stage 0 takes its next
microbatch instead), and the hand-off's backward sends the gradient the
other way, so the loss is one differentiable function of the params.
Within a stage a unit runs Megatron-style tensor parallel over ``tp`` on
plain local shards (``_apply_unit_tp``).

The embedding and the LM head stay outside the body, split over the
vocabulary across (stage, tp): a masked lookup summed over the group, the
last stage's output handed to every stage, a vocab-parallel head and
log-softmax. The loss is the mean over the whole batch across the batch
axes (pod, data).

Where the reference's ``shard_map`` and its transposes place the sums,
the port places them itself, and every rank holds the same value of a
replicated tensor and the whole gradient of it:

* ``_Reduce`` sums over groups in the forward (a block's output, the
  embedding's masked rows, the loss over the batch shards) and passes the
  gradient through;
* ``_Copy`` passes the forward through and sums the gradient over groups:
  at a block's entry (each tp rank computes a part), on every parameter
  leaf the batch axes replicate, and on every unit leaf that tp does not
  split (each tp rank's gradient is a part of it, as the reference's
  transpose of an unmapped input sums it);
* ``_FromStage`` hands the last stage's output to every stage; the head's
  ``_Copy`` has already summed its gradient.

That gives the sequential gradient: ``torch.distributed.nn.functional.
all_reduce`` would give T times it (PR 21's finding). Every rank of a
group runs the same collectives in the same order: the tp ranks of a
stage and the batch ranks of a (stage, tp) coordinate build the same
graph, and the stage group's collectives lie on one chain of data
dependencies (the hand-offs tick by tick, the head before them in the
backward, the embedding's after).

Every collective is an all-reduce of sums or the hand-off's send and
receive. gloo neither sends nor receives CUDA tensors (a ``writev`` of a
device address aborts the process on the card's machine): under gloo the
hand-off stages a CUDA tensor through pinned host buffers; the
all-reduces take CUDA tensors (gloo stages those itself). On the ``meta``
device (the dry run's one-rank trace in a fake group) the hand-off moves
nothing. ``comm_counts`` counts the module's collectives by kind, with
their bytes, since ``CommDebugMode`` sees no point-to-point op.

The port keeps one parameter dict per unit: ``stage_stack`` gives per-stage
lists of unit dicts, padded with the stage's last unit, and the reference's
[S, Lmax] mask; a masked slot leaves x unchanged (the body skips it).
``build_pipeline_params`` draws each unit from its own generator, seeded by
(seed, unit index), so one rank can build only its own stage's units and
tp slices (``coords``) and a sequential check draw the same weights
(a recorded divergence: the reference draws with ``jax.random``;
``pipeline_params_from_numpy`` carries its params across).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import build_mesh
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

Params = dict[str, Any]

SUPPORTED_UNIT_KINDS = ("attn", "attn_local", "moe", "mla", "mla_moe",
                        "rwkv")
BATCH_AXES = ("pod", "data")
VOCAB_AXES = ("tp", "stage")


def mesh_axes(n_data: int, n_stage: int, n_tp: int,
              n_pod: int = 1) -> dict[str, int]:
    """The pipeline mesh's axes and sizes, in order: (data, stage, tp), or
    (pod, data, stage, tp) when ``n_pod > 1``."""
    axes = {"pod": n_pod} if n_pod > 1 else {}
    axes.update(data=n_data, stage=n_stage, tp=n_tp)
    return axes


def make_pipeline_mesh(n_data: int, n_stage: int, n_tp: int,
                       n_pod: int = 1, *, device_type: str = "cuda"):
    """The pod's model axis factored into (stage, tp): a ``DeviceMesh``
    of ``mesh_axes`` over the default group's ranks
    (``launch/mesh.py::build_mesh``). Its ``get_group("stage")`` and
    ``get_group("tp")`` are the pipeline's groups."""
    return build_mesh(mesh_axes(n_data, n_stage, n_tp, n_pod), device_type)


# ---------------------------------------------------------------------------
# Stage-stacked parameters
# ---------------------------------------------------------------------------


def _slots(boundaries: tuple[int, ...], n_units: int):
    """Each stage's unit index per slot ([S][Lmax]) and the mask [S, Lmax]:
    a stage's padded slots repeat its last unit."""
    S = len(boundaries) - 1
    counts = [boundaries[s + 1] - boundaries[s] for s in range(S)]
    lmax = max(counts)
    idx = [[min(boundaries[s] + min(j, max(counts[s] - 1, 0)), n_units - 1)
            for j in range(lmax)] for s in range(S)]
    mask = torch.tensor([[j < counts[s] for j in range(lmax)]
                         for s in range(S)], dtype=torch.bool)
    return idx, mask


def stage_stack(units: list, boundaries: tuple[int, ...]):
    """A list of unit dicts -> (per-stage lists of Lmax unit dicts, mask
    [S, Lmax]). A padded slot holds its stage's last unit (the same dict)
    and is masked. ``boundaries`` may be non-uniform: Algorithm 1's output
    when the units are heterogeneous."""
    idx, mask = _slots(tuple(boundaries), len(units))
    return [[units[i] for i in row] for row in idx], mask


def uniform_boundaries(n_units: int, S: int) -> tuple[int, ...]:
    base, rem = divmod(n_units, S)
    bounds = [0]
    for s in range(S):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    return tuple(bounds)


# ---------------------------------------------------------------------------
# Tensor parallelism within a stage
# ---------------------------------------------------------------------------


def _tp_view(cfg: ModelConfig, T: int) -> ModelConfig:
    """Per-tp-rank view: heads / ff / experts divided by T (kv heads
    replicated when T does not divide them)."""
    return cfg.scaled(
        n_heads=cfg.n_heads // T,
        n_kv_heads=(cfg.n_kv_heads // T if cfg.n_kv_heads % T == 0
                    else cfg.n_kv_heads),
        d_ff=cfg.d_ff // T,
        moe_n_experts=(cfg.moe_n_experts // T if cfg.moe_n_experts else 0),
    )


_COL = (r"(^|/)(wq|wk|wv)/w$", r"mlp/(wi|wg)/w$", r"(wq_b|wkv_b)/w$",
        r"shared/(wi|wg)/w$", r"rwkv/(wr|wk|wv|wg)/w$", r"rwkv/cm_wk/w$")
_ROW = (r"(^|/)wo/w$", r"shared/wo/w$", r"rwkv/cm_wv/w$")


def _tp_dim_for(path: str, ndim: int, cfg: ModelConfig, T: int) -> int | None:
    """Which dim of one unit's leaf (``path`` its keys joined by ``/``)
    tp splits: the reference's rule for its [S, Lmax, ...] leaf, less the
    two leading dims. Patterns are anchored at a path-segment boundary so
    that e.g. ``cm_wv/w`` (row-split) never matches the generic ``wv/w``
    column rule."""
    if re.search(r"mlp/(wi|wg|wo)$", path):        # MoE stacks [E, D, F]
        return 0
    if re.search(r"rwkv/(w0|ln_x_scale|ln_x_bias|dec_w2)$", path) \
            or re.search(r"(^|/)(wq|wk|wv|wi|wg)/b$", path):
        return ndim - 1
    if re.search(r"rwkv/u$", path):
        return ndim - 2
    if any(re.search(pat, path) for pat in _ROW):
        return ndim - 2
    if any(re.search(pat, path) for pat in _COL):
        if re.search(r"(^|/)(wk|wv)/w$", path) and cfg.n_kv_heads % T:
            return None                             # replicate small kv
        return ndim - 1
    return None


def _paths(node, prefix: str = ""):
    """(path, leaf) of a unit dict, keys joined by ``/``."""
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, path)
        else:
            yield path, v


def _map(fn, node, prefix: str = ""):
    """``fn(path, leaf)`` over a unit dict, the same nesting."""
    return {k: (_map(fn, v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict)
                else fn(f"{prefix}/{k}" if prefix else k, v))
            for k, v in node.items()}


def unit_tp_dims(cfg: ModelConfig, T: int, unit: Params) -> dict:
    """{path: the tp-split dim} of each leaf of a whole (unsplit) unit,
    None where tp replicates it: ``_tp_dim_for``'s dim where T divides it
    (the reference's ``_unit_specs``)."""
    dims = {}
    for path, leaf in _paths(unit):
        d = _tp_dim_for(path, leaf.ndim, cfg, T)
        dims[path] = d if d is not None and leaf.shape[d] % T == 0 else None
    return dims


def _moe_apply_tp(p: Params, cfg: ModelConfig, x, T: int, tp: int):
    """Expert-parallel MoE within a stage: the same routing on every tp
    rank (the router replicated), each rank running its E/T experts with
    the deterministic ascending-id combine, and its part of the shared
    experts (tp-split) added before the caller's sum over tp. No aux
    loss, as in the reference."""
    B, S, D = x.shape
    r = L.moe_route_shard(p, cfg, x.reshape(B * S, D), tp, T)
    y = L._moe_routed(p, x, r, tp * (cfg.moe_n_experts // T))
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, "swiglu")
    return y


def _apply_unit_tp(kind: str, cfg: ModelConfig, lp: Params, x, positions,
                   pm: "PipelineCoords"):
    """One unit, tensor-parallel over ``tp`` on local shards. Each block
    enters through ``_Copy`` (its gradient summed over tp) and its output
    is summed over tp (``_Reduce``), so the residual stream stays
    replicated within the stage. RWKV runs with no state and a zero
    channel-mix shift."""
    lcfg = _tp_view(cfg, pm.T)
    h_in = L.rms_norm(lp["ln1"], _enter(x, pm))
    if kind == "rwkv":
        h, _ = R.rwkv6_block_apply(lp["rwkv"], lcfg, h_in, state=None)
        x = x + _exit(h, pm)
        h2, _ = R.rwkv6_channel_mix(lp["rwkv"],
                                    L.rms_norm(lp["ln2"], _enter(x, pm)),
                                    torch.zeros_like(x[:, 0]))
        return x + _exit(h2, pm)
    if kind in ("mla", "mla_moe"):
        h, _ = L.mla_apply(lp["attn"], lcfg, h_in, positions)
    else:
        h, _ = L.gqa_apply(lp["attn"], lcfg, h_in, positions,
                           window=cfg.window if kind == "attn_local" else 0)
    x = x + _exit(h, pm)
    h_in2 = L.rms_norm(lp["ln2"], _enter(x, pm))
    if kind.endswith("moe"):
        h2 = _moe_apply_tp(lp["mlp"], cfg, h_in2, pm.T, pm.tp)
    else:
        h2 = L.mlp_apply(lp["mlp"], h_in2, cfg.mlp_kind)
    return x + _exit(h2, pm)


# ---------------------------------------------------------------------------
# A rank's coordinates and groups; the collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineCoords:
    """One rank's place on a pipeline mesh: its index and the axis size
    along each axis (``pod`` and ``data`` of size 1 when absent), and the
    mesh's process groups by axis (None without a mesh)."""
    stage: int
    S: int
    tp: int
    T: int
    batch: int = 0          # row-major over (pod, data)
    n_batch: int = 1
    groups: dict | None = None

    @classmethod
    def of(cls, mesh) -> "PipelineCoords":
        names = mesh.mesh_dim_names
        at = dict(zip(names, mesh.get_coordinate()))
        size = {a: mesh.size(i) for i, a in enumerate(names)}
        return cls(stage=at["stage"], S=size["stage"], tp=at["tp"],
                   T=size["tp"],
                   batch=at.get("pod", 0) * size["data"] + at["data"],
                   n_batch=size.get("pod", 1) * size["data"],
                   groups={a: (mesh.get_group(a), size[a]) for a in names})

    @property
    def vp(self) -> int:
        """The rank's index over (stage, tp), the vocabulary split."""
        return self.stage * self.T + self.tp

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` over the batch axes."""
        if n % self.n_batch:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.n_batch} batch ranks")
        b = n // self.n_batch
        return slice(self.batch * b, (self.batch + 1) * b)

    def axes(self, *names: str) -> list:
        """(group, size) of each named axis the mesh has with more than one
        rank."""
        return [self.groups[a] for a in names
                if self.groups and a in self.groups and self.groups[a][1] > 1]


def _vocab_range(V: int, n: int, r: int) -> tuple[int, int]:
    """Rank r's rows [lo, hi) of a vocabulary of V split over n ranks
    (ceil(V / n) a rank, the last ones shorter)."""
    chunk = -(-V // n)
    lo = min(r * chunk, V)
    return lo, min(lo + chunk, V)


comm_counts = {"all-reduce": {"calls": 0, "bytes": 0},
               "collective-permute": {"calls": 0, "bytes": 0}}


def reset_comm_counts() -> None:
    for row in comm_counts.values():
        row["calls"] = row["bytes"] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    comm_counts[kind]["calls"] += 1
    comm_counts[kind]["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, axes: list) -> torch.Tensor:
    """``t`` summed in place over each (group, size) of ``axes``."""
    for group, _ in axes:
        _count("all-reduce", t)
        dist.all_reduce(t, group=group)
    return t


class _Reduce(torch.autograd.Function):
    """Forward: the sum over ``axes`` (one all-reduce an axis). Backward:
    the gradient as it is (each rank holds the whole gradient of the
    replicated sum)."""

    @staticmethod
    def forward(ctx, t, axes):
        return _all_reduce(t.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward: ``t`` as it is. Backward: the gradient summed over
    ``axes``: the ranks there computed parts of it."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axes), None


def _sum_over(t, axes):
    return _Reduce.apply(t, axes) if axes else t


def _grad_sum_over(t, axes):
    return _Copy.apply(t, axes) if axes else t


def _enter(x, pm: PipelineCoords):
    return _grad_sum_over(x, pm.axes("tp"))


def _exit(h, pm: PipelineCoords):
    return _sum_over(h, pm.axes("tp"))


class _FromStage(torch.autograd.Function):
    """The last stage's ``t`` on every stage (a sum over ``stage`` of it and
    zeros). Backward: the gradient on the last stage, zeros elsewhere: the
    head's ``_Copy`` has already summed it over (stage, tp)."""

    @staticmethod
    def forward(ctx, t, pm):
        ctx.last = pm.stage == pm.S - 1
        out = t.clone() if ctx.last else torch.zeros_like(t)
        return _all_reduce(out, pm.axes("stage"))

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _from_last_stage(t, pm: PipelineCoords):
    return _FromStage.apply(t, pm) if pm.S > 1 else t


def _send_recv(send: torch.Tensor | None, dst: int | None,
               recv_like: torch.Tensor, src: int | None,
               group) -> torch.Tensor:
    """Send ``send`` to stage ``dst`` and receive a tensor like
    ``recv_like`` from stage ``src`` on the stage ``group`` (None: no
    peer; nothing received gives zeros). Counts the sends. Under gloo a
    CUDA tensor goes through pinned host buffers; on ``meta`` nothing
    moves."""
    if send is not None:
        _count("collective-permute", send)
    out = torch.zeros_like(recv_like)
    if recv_like.device.type == "meta":
        return out
    staged = recv_like.device.type == "cuda" and \
        dist.get_backend(group) == "gloo"

    def host(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    ops, buf = [], None
    if send is not None:
        payload = send.contiguous()
        if staged:
            payload = host(send).copy_(payload)
        ops.append(dist.P2POp(dist.isend, payload,
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        buf = host(out) if staged else out
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if staged and buf is not None:
        out.copy_(buf)
    return out


class _StageHandoff(torch.autograd.Function):
    """The counterpart of the reference's ``ppermute`` on ``stage``: stage
    s sends ``y`` to s + 1 and takes what s - 1 sent; stage 0 takes
    ``x_first`` (its next microbatch) instead. Backward: the reverse
    permutation (s sends the gradient of what it took to s - 1 and takes
    that of its ``y`` from s + 1; the last stage's is zero)."""

    @staticmethod
    def forward(ctx, y, x_first, pm):
        ctx.pm = pm
        s, S = pm.stage, pm.S
        group = pm.groups["stage"][0]
        got = _send_recv(y if s < S - 1 else None,
                         s + 1 if s < S - 1 else None, y,
                         s - 1 if s > 0 else None, group)
        return x_first.clone() if s == 0 else got

    @staticmethod
    def backward(ctx, g):
        pm = ctx.pm
        s, S = pm.stage, pm.S
        gy = _send_recv(g if s > 0 else None, s - 1 if s > 0 else None, g,
                        s + 1 if s < S - 1 else None, pm.groups["stage"][0])
        return gy, (g if s == 0 else None), None


# ---------------------------------------------------------------------------
# The pipelined body, loss and prefill
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineContext:
    cfg: ModelConfig
    unit_kind: str
    S: int                  # stages
    T: int                  # tensor parallel within stage
    n_micro: int
    remat: bool = True


def pipeline_body_fn(ctx: PipelineContext, mesh):
    """The GPipe body on this rank: ``body(units, unit_mask, x0,
    positions)`` with this stage's Lmax local unit dicts, its mask (Lmax
    bools), x0 [Bl, Seq, D] (this rank's batch rows) and their positions.
    Returns this stage's K microbatch outputs in order, [Bl, Seq, D]: on the
    last stage the body's output. Each unit is rematerialised in the
    backward when ``ctx.remat`` (``checkpoint``, where the reference's
    ``jax.checkpoint`` wraps its unit body)."""
    cfg, K = ctx.cfg, ctx.n_micro
    pm = PipelineCoords.of(mesh)
    if (pm.S, pm.T) != (ctx.S, ctx.T):
        raise ValueError(f"the context's (S, T) = {(ctx.S, ctx.T)} is not "
                         f"the mesh's {(pm.S, pm.T)}")

    def unit(x, lp, pos):
        return _apply_unit_tp(ctx.unit_kind, cfg, lp, x, pos, pm)

    def body(units, unit_mask, x0, positions):
        Bl = x0.shape[0]
        if Bl % K:
            raise ValueError(f"{Bl} rows do not split into {K} microbatches")
        mask = [bool(m) for m in unit_mask]
        # The body reads the embedding on stage 0 only: its gradient is
        # summed over the stages (stage 0's, zeros elsewhere).
        x0 = _grad_sum_over(x0, pm.axes("stage"))
        x_mb, pos_mb = x0.split(Bl // K), positions.split(Bl // K)
        remat = ctx.remat and torch.is_grad_enabled()

        def apply_stage(x, pos):
            for lp, on in zip(units, mask):
                if on:
                    x = (checkpoint(unit, x, lp, pos, use_reentrant=False)
                         if remat else unit(x, lp, pos))
            return x

        s, last = pm.stage, K + ctx.S - 2
        outs = []
        x_in = x_mb[0] if s == 0 else torch.zeros_like(x_mb[0])
        for t in range(last + 1):
            y = apply_stage(x_in, pos_mb[min(max(t - s, 0), K - 1)])
            if 0 <= t - s < K:
                outs.append(y)
            elif t == last:
                # The reference's where(take, ...): this tick's output is
                # not kept but stays in the graph (a zero gradient), so
                # every stage runs every hand-off's backward, in turn with
                # its neighbours'.
                outs[-1] = torch.where(torch.zeros((), dtype=torch.bool,
                                                   device=y.device),
                                       y, outs[-1])
            if t < last:
                x_in = _StageHandoff.apply(y, x_mb[min(t + 1, K - 1)], pm)
        return torch.cat(outs)

    return body


def _positions(cfg: ModelConfig, batch: dict, rows: slice, Seq: int,
               device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"][rows]
    B = rows.stop - rows.start
    return T._positions(cfg, B, Seq, 0, device)


def _embed(table, tokens, lo: int, pm: PipelineCoords):
    """The vocab-parallel lookup: each rank's rows [lo, lo + len) and zeros
    elsewhere, summed over (stage, tp)."""
    rows = tokens.long() - lo
    inside = (rows >= 0) & (rows < table.shape[0])
    got = table[torch.where(inside, rows, 0)] * inside[..., None].to(
        table.dtype)
    return _sum_over(got, pm.axes(*VOCAB_AXES))


def _head(params: Params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]


def _grad_sums(params: Params, ctx: PipelineContext,
               pm: PipelineCoords) -> Params:
    """``params`` with every floating leaf behind a ``_Copy`` over the axes
    that replicate it: the batch axes, and tp too for the unit leaves tp
    does not split (their tp ranks' gradients are parts of it). A leaf two
    slots share is wrapped once."""
    batch = pm.axes(*BATCH_AXES)
    tp = pm.axes("tp")
    dims = unit_tp_dims(ctx.cfg, ctx.T, T._layer_init(
        ctx.unit_kind, ctx.cfg, None, torch.float32, "meta"))
    seen: dict[int, torch.Tensor] = {}

    def wrap(t, axes):
        if not t.is_floating_point():
            return t
        if id(t) not in seen:
            seen[id(t)] = _grad_sum_over(t, axes)
        return seen[id(t)]

    def unit(u):
        return _map(lambda path, t: wrap(
            t, batch if dims[path] is not None else batch + tp), u)

    out = {k: (v if k in ("units", "unit_mask") else
               {n: wrap(t, batch) for n, t in v.items()}
               if isinstance(v, dict) else wrap(v, batch))
           for k, v in params.items()}
    out["units"] = [unit(u) for u in params["units"]]
    return out


def _vocab_parallel_nll(logits, labels, lo: int, pm: PipelineCoords):
    """-log softmax(logits)[label] with the vocabulary split over (stage,
    tp): each rank's log-sum-exp and its target logit (zero when the label
    is another rank's), gathered and summed by one all-reduce an axis."""
    n = pm.S * pm.T
    lse = torch.logsumexp(logits, -1)
    local = labels.long() - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    tgt = logits.gather(-1, local.clamp(0, max(logits.shape[-1] - 1, 0))
                        [..., None])[..., 0] * inside
    zero = torch.zeros_like(lse)
    slots = [lse if r == pm.vp else zero for r in range(n)]
    got = _sum_over(torch.stack(slots + [tgt]), pm.axes(*VOCAB_AXES))
    return torch.logsumexp(got[:n], 0) - got[n]


def pipeline_loss_fn(ctx: PipelineContext, mesh, unit_mask=None):
    """The pipelined training loss on this rank: ``loss(params, batch)``
    with this rank's params (``shard_pipeline_params`` or
    ``build_pipeline_params(coords=)``) and the whole batch ({"tokens"} or
    {"embeds"}, "labels", optionally "positions"; each rank takes its batch
    rows). Embed -> body -> the last stage's output on every stage ->
    final norm -> vocab-parallel head and float32 cross-entropy, the mean
    over the positions whose label is >= 0 of the whole batch. The same
    value on every rank; its gradient is the sequential one (no MoE aux
    term, as in the reference). ``unit_mask`` overrides the params'."""
    cfg = ctx.cfg
    pm = PipelineCoords.of(mesh)
    body = pipeline_body_fn(ctx, mesh)
    lo, _ = _vocab_range(cfg.vocab, pm.S * pm.T, pm.vp)

    def loss(params, batch):
        p = _grad_sums(params, ctx, pm)
        labels = batch["labels"]
        rows = pm.rows(labels.shape[0])
        if "tokens" in batch:
            x0 = _embed(p["embed"], batch["tokens"][rows], lo, pm)
        else:
            x0 = batch["embeds"][rows]
        positions = _positions(cfg, batch, rows, x0.shape[1], x0.device)
        mask = params["unit_mask"] if unit_mask is None else unit_mask
        y = _from_last_stage(body(p["units"], mask, x0, positions), pm)
        y = L.rms_norm(p["final_norm"], y)
        y = _grad_sum_over(y, pm.axes(*VOCAB_AXES))
        logits = (y @ _head(p, cfg)).float()
        nll = _vocab_parallel_nll(logits, labels[rows], lo, pm)
        keep = labels >= 0
        total = _sum_over((nll * keep[rows]).sum(), pm.axes(*BATCH_AXES))
        return total / torch.clamp(keep.sum(), min=1).float()

    return loss


def pipeline_prefill_fn(ctx: PipelineContext, mesh, unit_mask=None):
    """Forward-only pipelined prefill: ``prefill(params, batch)`` ->
    the last token's float32 logits [B, V] of the whole batch, the same on
    every rank (each rank computes its batch rows' share of its vocabulary
    rows; one all-reduce an axis assembles them). Runs under
    ``torch.no_grad``, so attention on CUDA takes ``flash_attention``.

    (Serving would also emit the per-stage KV caches; the collective and
    compute structure is the same: the cache write is a local store.)"""
    cfg = ctx.cfg
    pm = PipelineCoords.of(mesh)
    body = pipeline_body_fn(ctx, mesh)
    lo, hi = _vocab_range(cfg.vocab, pm.S * pm.T, pm.vp)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        B = tokens.shape[0]
        rows = pm.rows(B)
        x0 = _embed(params["embed"], tokens[rows], lo, pm)
        positions = _positions(cfg, batch, rows, x0.shape[1], x0.device)
        mask = params["unit_mask"] if unit_mask is None else unit_mask
        y = body(params["units"], mask, x0, positions)[:, -1:]
        y = L.rms_norm(params["final_norm"], _from_last_stage(y, pm))
        out = torch.zeros((B, cfg.vocab), dtype=torch.float32,
                          device=y.device)
        out[rows, lo:hi] = (y @ _head(params, cfg)).float()[:, 0]
        return _all_reduce(out, pm.axes(*VOCAB_AXES, *BATCH_AXES))

    return prefill


# ---------------------------------------------------------------------------
# The sequential function the pipeline computes (the checks' reference)
# ---------------------------------------------------------------------------


def _sequential_hidden(params: Params, cfg: ModelConfig, kind: str,
                       batch: dict, remat: bool = False):
    if "tokens" in batch:
        x = params["embed"][batch["tokens"].long()]
    else:
        x = batch["embeds"]
    B, Seq = x.shape[:2]
    pos = _positions(cfg, batch, slice(0, B), Seq, x.device)
    mask = params["unit_mask"]
    for s, stage in enumerate(params["units"]):
        for j, lp in enumerate(stage):
            if not bool(mask[s, j]):
                continue
            if remat and torch.is_grad_enabled():
                x = checkpoint(lambda x, lp: T._layer_apply(
                    kind, lp, cfg, x, pos, None)[0], x, lp,
                    use_reentrant=False)
            else:
                x = T._layer_apply(kind, lp, cfg, x, pos, None)[0]
    return L.rms_norm(params["final_norm"], x)


def sequential_loss(params: Params, cfg: ModelConfig, kind: str,
                    batch: dict, remat: bool = False):
    """What ``pipeline_loss_fn`` computes, on one device over the whole
    (unsplit) params of ``build_pipeline_params``: the real units in order
    (``transformer._layer_apply``; no MoE aux term), the head, the float32
    cross-entropy's mean over labels >= 0 (the reference test's
    ``ref_loss``)."""
    x = _sequential_hidden(params, cfg, kind, batch, remat)
    logp = torch.log_softmax((x @ _head(params, cfg)).float(), -1)
    labels = batch["labels"]
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    keep = (labels >= 0).float()
    return (nll * keep).sum() / torch.clamp(keep.sum(), min=1.0)


@torch.no_grad()
def sequential_prefill(params: Params, cfg: ModelConfig, kind: str,
                       batch: dict):
    """What ``pipeline_prefill_fn`` computes, on one device: the last
    token's float32 logits [B, V]."""
    x = _sequential_hidden(params, cfg, kind, batch)[:, -1]
    return (x @ _head(params, cfg)).float()


# ---------------------------------------------------------------------------
# Building pipeline params from a config
# ---------------------------------------------------------------------------


def dominant_segment(cfg: ModelConfig):
    return max(T.segments(cfg), key=lambda s: s.count)


def supports_pipeline(cfg: ModelConfig) -> bool:
    return dominant_segment(cfg).kind in SUPPORTED_UNIT_KINDS


def _seed(seed: int, *key: int) -> int:
    """A generator seed for (seed, key): one stream per unit and table."""
    return int(np.random.SeedSequence([seed, *key]).generate_state(
        1, np.uint64)[0] >> 1)


def _shard_unit(unit: Params, dims: dict, pm: PipelineCoords) -> Params:
    def one(path, t):
        d = dims[path]
        if d is None:
            return t
        n = t.shape[d] // pm.T
        return t.narrow(d, pm.tp * n, n).clone()
    return _map(one, unit)


def _shard(embed, final_norm, lm_head, stage_units: list, unit_mask,
           cfg: ModelConfig, pm: PipelineCoords) -> Params:
    """This rank's params: its stage's units, each leaf tp-sliced; its
    vocabulary rows of the embedding and columns of the head."""
    lo, hi = _vocab_range(cfg.vocab, pm.S * pm.T, pm.vp)
    out = {"embed": embed[lo:hi].clone(), "units": stage_units,
           "unit_mask": unit_mask, "final_norm": final_norm}
    if lm_head is not None:
        out["lm_head"] = {"w": lm_head["w"][:, lo:hi].clone()}
    return out


def shard_pipeline_params(params: Params, cfg: ModelConfig,
                          coords: PipelineCoords) -> Params:
    """The whole params (``build_pipeline_params`` without ``coords``, or
    ``pipeline_params_from_numpy``) -> one rank's: ``units`` its stage's
    Lmax unit dicts (leaves tp-sliced and copied; shared slots stay
    shared), ``unit_mask`` its stage's row, the embedding's vocabulary rows
    and the head's columns of its (stage, tp) index."""
    dims = unit_tp_dims(cfg, coords.T, params["units"][0][0])
    done: dict[int, Params] = {}
    units = []
    for u in params["units"][coords.stage]:
        if id(u) not in done:
            done[id(u)] = _shard_unit(u, dims, coords)
        units.append(done[id(u)])
    return _shard(params["embed"], params["final_norm"],
                  params.get("lm_head"), units,
                  params["unit_mask"][coords.stage], cfg, coords)


def build_pipeline_params(cfg: ModelConfig, S: int,
                          boundaries: tuple[int, ...] | None = None,
                          abstract: bool = False, *, seed: int = 0,
                          device=None, coords: PipelineCoords | None = None
                          ) -> tuple[Params, str]:
    """Returns (params, unit_kind). The dominant homogeneous segment forms
    the pipeline units (a MoE arch's leading dense layers are left out, as
    in the reference): ``embed``, ``units`` (S lists of Lmax unit dicts,
    ``stage_stack``), ``unit_mask`` [S, Lmax], ``final_norm``, and
    ``lm_head`` unless the embeddings are tied. Unit i is drawn from a
    ``torch.Generator`` seeded by (seed, 0, i), the embedding by (seed, 1),
    the head by (seed, 2), on ``device`` (None: the card, raising without
    one). ``abstract`` builds shapes on the ``meta`` device. With
    ``coords``, only that rank's part (``shard_pipeline_params``'s form),
    each unit drawn whole then sliced."""
    main = dominant_segment(cfg)
    if main.kind not in SUPPORTED_UNIT_KINDS:
        raise ValueError(f"pipeline unsupported for unit kind {main.kind}")
    bounds = tuple(boundaries or uniform_boundaries(main.count, S))
    if len(bounds) != S + 1 or bounds[0] != 0 or bounds[-1] != main.count:
        raise ValueError(f"boundaries {bounds} do not split {main.count} "
                         f"units into {S} stages")
    device = torch.device("meta") if abstract else T._device(device)
    dtype = getattr(torch, cfg.dtype)

    def gen(*key):
        return None if device.type == "meta" else \
            torch.Generator(device=device).manual_seed(_seed(seed, *key))

    def unit(i):
        return T._layer_init(main.kind, cfg, gen(0, i), dtype, device)

    with torch.no_grad():
        embed = L._normal(gen(1), (cfg.vocab, cfg.d_model), 0.02, dtype,
                          device)
        final_norm = L.rms_norm_init(cfg.d_model, dtype, device)
        lm_head = None if cfg.tie_embeddings else \
            L.dense(gen(2), cfg.d_model, cfg.vocab, dtype, device)
        idx, mask = _slots(bounds, main.count)
        if coords is None:
            made: dict[int, Params] = {}
            for i in sorted({i for row in idx for i in row}):
                made[i] = unit(i)
            params = {"embed": embed, "unit_mask": mask,
                      "units": [[made[i] for i in row] for row in idx],
                      "final_norm": final_norm}
            if lm_head is not None:
                params["lm_head"] = lm_head
            return params, main.kind
        if coords.S != S:
            raise ValueError(f"coords for {coords.S} stages, not {S}")
        dims = unit_tp_dims(cfg, coords.T, T._layer_init(
            main.kind, cfg, None, dtype, "meta"))
        mine: dict[int, Params] = {}
        for i in idx[coords.stage]:
            if i not in mine:
                mine[i] = _shard_unit(unit(i), dims, coords)
        units = [mine[i] for i in idx[coords.stage]]
        return _shard(embed, final_norm, lm_head, units,
                      mask[coords.stage], cfg, coords), main.kind


def pipeline_params_from_numpy(tree: Params, unit_mask=None,
                               device=None) -> Params:
    """The reference's ``build_pipeline_params`` output (numpy leaves, the
    units stacked [S, Lmax, ...]) as the port's whole params: each slot a
    unit dict of tensors on ``device``. With the mask (``tree["unit_mask"]``
    or ``unit_mask``), a padded slot is its stage's last unit's dict, as
    ``stage_stack`` makes it (the reference's padded rows are copies of
    it)."""
    device = T._device(device)
    if unit_mask is None:
        unit_mask = tree.get("unit_mask")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return T._tensor_from_numpy(node, device)

    def slot(node, s, j):
        if isinstance(node, dict):
            return {k: slot(v, s, j) for k, v in node.items()}
        return node[s, j]

    first = next(v for _, v in _paths(tree["units"]))
    S, lmax = first.shape[:2]
    mask = (np.ones((S, lmax), bool) if unit_mask is None
            else np.asarray(unit_mask, bool))
    staged = []
    for s in range(S):
        row = []
        for j in range(lmax):
            if mask[s, j] or not row:
                row.append(convert(slot(tree["units"], s, j)))
            else:
                row.append(row[-1])
        staged.append(row)
    out = {k: convert(v) for k, v in tree.items()
           if k not in ("units", "unit_mask")}
    out["units"] = staged
    out["unit_mask"] = torch.from_numpy(mask.copy())
    return out
