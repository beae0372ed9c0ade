"""Resource-allocation framework (paper Section 4, Algorithms 1 and 2).

Two modes:

* **FPGA mode** (faithful reproduction): allocate Θ DSP multipliers across
  conv-layer engines (Algorithm 1) and BRAM/DDR bandwidth via row
  parallelism K (Algorithm 2), exactly as the paper's pseudo-code.
* **Mesh mode** (TPU port): the same objective — balance per-stage time to
  maximize utilization — applied to a pod's ``model`` mesh axis: factor it
  into ``stage x tensor``, assign layers to stages (contiguous partition that
  minimizes the slowest stage = the paper's T_rowmax), and choose the
  microbatch granularity (the K analogue) so weight streaming stays under
  the HBM-bandwidth roof subject to the HBM-capacity roof.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.workload import LayerWorkload

# ---------------------------------------------------------------------------
# Algorithm 1 — computation resources (faithful)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerAlloc:
    layer: LayerWorkload
    theta: int          # multipliers assigned (= C' * M' * R * S)
    Cp: int             # input-channel parallelism C'
    Mp: int             # output-channel parallelism M'
    K: int = 1          # row parallelism (Algorithm 2)
    weights_resident: bool = False   # full weight set pinned in BRAM
    cycle_model: str = "packed"   # see engine_cycles()

    @property
    def t_row(self) -> float:
        """Eq. (2): cycles for this engine to produce K output rows."""
        l = self.layer
        if l.macs == 0:
            return 0.0
        if self.cycle_model == "packed":
            pe = max(1, self.Cp * self.Mp)
            if l.kind == "fc":
                return float(math.ceil(l.C * l.M / pe))
            return float(self.K * math.ceil(l.W * l.C * l.M / pe))
        return (self.K * l.W * math.ceil(l.C / self.Cp)
                * math.ceil(l.M / self.Mp))

    @property
    def t_per_output_row(self) -> float:
        """Cycles per single output row of this layer."""
        return self.t_row / max(self.K, 1)


def _decompose_theta(theta_pe: int, C: int, M: int,
                     cycle_model: str = "packed") -> tuple[int, int]:
    """Split ``theta_pe`` (= theta/(R*S)) into (C', M') — line 9 of Alg. 1.

    The paper's flexible activation buffer removes the power-of-two and
    producer/consumer-matching constraints, so any (C', M') with
    ``C'*M' <= theta_pe`` is legal — the pair need not factor theta_pe
    exactly (non-divisor budgets would otherwise clamp out of bounds; the
    old divisor-only fallback could do exactly that).

    Under the packed cycle model a row costs ``ceil(W*C*M / (C'*M'))``, so
    the best split maximizes the PE product; under the strict ceil model it
    minimizes ``ceil(C/C')*ceil(M/M')`` and, on ties, the PE count (fewer
    multipliers for the same cycles = strictly better DSP efficiency).
    Always returns ``1 <= C' <= C``, ``1 <= M' <= M``, ``C'*M' <= theta_pe``.
    """
    t = max(1, theta_pe)
    if t >= C * M:
        return C, M
    best: tuple[int, int] | None = None
    best_key: tuple | None = None
    for cp in range(1, min(C, t) + 1):
        mp = min(M, t // cp)
        if cycle_model == "packed":
            key = (-(cp * mp), abs(cp - mp))
        else:
            # Same ceil(M/mp) is reachable with the minimal mp in its
            # block — shrink so equal-cycle splits spend fewer PEs.
            mp = math.ceil(M / math.ceil(M / mp))
            key = (math.ceil(C / cp) * math.ceil(M / mp), cp * mp,
                   abs(cp - mp))
        if best_key is None or key < best_key:
            best, best_key = (cp, mp), key
    assert best is not None
    return best


def engine_cycles(l: LayerWorkload, theta: int,
                  cycle_model: str = "packed") -> float:
    """Engine-busy cycles per frame for a given multiplier budget.

    ``cycle_model="packed"`` (default, paper-faithful): the flexible
    activation buffer's address generator packs partial channel groups
    across the row, so a row of W output pixels costs
    ``ceil(W*C*M / PE)`` group-cycles — quantization loss is one cycle per
    row. This is the model under which the paper's reported 96-98% DSP
    efficiencies are achievable at all; strict per-group scheduling caps
    VGG16 below 93% for any allocation (we verified by exhaustive
    waterfilling), so the paper's numbers imply packing.

    ``cycle_model="ceil"``: strict per-group scheduling,
    ``W * ceil(C/C') * ceil(M/M')`` per row at the best decomposition —
    what an inflexible buffer (e.g. DNNBuilder's, with its pow2 and
    producer=consumer parallelism constraints) is limited to.
    """
    pe = max(1, theta // (l.R * l.S))
    if cycle_model == "packed":
        work = l.C * l.M  # group-cycles per output pixel * PE
        if l.kind == "fc":
            return float(math.ceil(work / pe))
        return float(l.H * math.ceil(l.W * work / pe))
    cp, mp = _decompose_theta(pe, l.C, l.M, cycle_model="ceil")
    cycles = math.ceil(l.C / cp) * math.ceil(l.M / mp)
    if l.kind == "fc":
        return float(cycles)
    return float(l.H * l.W * cycles)


def _ceil_blocks(n: int) -> list[int]:
    """Distinct values of ceil(n/k) for k in 1..n, in O(sqrt n)."""
    if n <= 1:
        return [max(1, n)]
    vals = set()
    m = n - 1
    i = 1
    while i <= m:
        q = m // i
        vals.add(q + 1)
        i = m // q + 1
    vals.add(1)
    return sorted(vals)


def _theta_min_for_bound(l: LayerWorkload, bound: float,
                         cycle_model: str = "packed") -> int | None:
    """Min theta such that engine_cycles(l, theta) <= bound, or None."""
    if cycle_model == "packed":
        if l.kind == "fc":
            rows, work = 1, l.C * l.M
        else:
            rows, work = l.H, l.W * l.C * l.M
        per_row = int(bound // rows)
        if per_row < 1:
            return None
        pe = min(l.C * l.M, math.ceil(work / per_row))
        if math.ceil(work / pe) > per_row:
            return None
        return pe * l.R * l.S
    per_px = bound if l.kind == "fc" else bound / (l.H * l.W)
    if per_px < 1.0:
        return None
    best: int | None = None
    for a in _ceil_blocks(l.C):            # a = ceil(C / C') candidate
        cp = math.ceil(l.C / a)
        a_eff = math.ceil(l.C / cp)
        b_max = int(per_px // a_eff)
        if b_max < 1:
            continue
        mp = min(l.M, math.ceil(l.M / b_max))
        pe = cp * mp
        if math.ceil(l.C / cp) * math.ceil(l.M / mp) <= per_px:
            if best is None or pe < best:
                best = pe
    if best is None:
        return None
    return best * l.R * l.S


def _waterfill(compute: list[LayerWorkload], theta_total: int,
               cycle_model: str = "packed") -> dict[str, int] | None:
    """Global optimum of max-engine-cycles via binary search on the bound.

    For a candidate bottleneck B, each engine independently needs
    theta_min(B) multipliers; the bound is feasible iff they sum within
    Theta. engine_cycles is monotone non-increasing in theta, so binary
    search over B converges to the optimum (up to float resolution).
    """
    lo = max(engine_cycles(l, l.C * l.M * l.R * l.S, cycle_model)
             for l in compute)
    hi = max(engine_cycles(l, l.R * l.S, cycle_model) for l in compute)

    def feasible(B: float) -> dict[str, int] | None:
        out: dict[str, int] = {}
        tot = 0
        for l in compute:
            t = _theta_min_for_bound(l, B, cycle_model)
            if t is None:
                return None
            out[l.name] = t
            tot += t
            if tot > theta_total:
                return None
        return out

    best = feasible(hi)
    if best is None:
        return None
    for _ in range(64):
        mid = math.sqrt(lo * hi) if lo > 0 else (lo + hi) / 2
        got = feasible(mid)
        if got is not None:
            best, hi = got, mid
        else:
            lo = mid
        if hi - lo < 0.5:
            break
    return best


def allocate_compute(
    layers: Sequence[LayerWorkload],
    theta_total: int,
    *,
    objective: str = "optimal",
    cycle_model: str = "packed",
) -> list[LayerAlloc]:
    """Algorithm 1 — allocate multipliers to each compute layer.

    1. pi_i = H*W*R*S*C*M (MACs)
    2. theta_hat_i = pi_i * Theta / sum(pi)
    3. theta_i = [theta_hat_i / (R_i*S_i)] * R_i*S_i   (>= R_i*S_i)
    4. while spare DSPs remain: give R_j*S_j more to the layer with the
       largest pi_j/theta_j (the slowest one).
    5. decompose theta_i into C'_i x M'_i.

    objective="paper" is the pseudo-code verbatim (slowness proxy
    pi_i/theta_i, add-only greedy). objective="exact" (beyond-paper — see
    EXPERIMENTS.md §Perf) optimizes the true per-frame engine cycles
    including ceil losses, and adds a multi-donor rebalance: the step-3
    quantization can strand the bottleneck engine one R*S quantum short,
    which an add-only greedy cannot repair once Theta is exhausted;
    stealing single quanta from several fast engines can.
    objective="optimal" (default) solves the min-max exactly by binary
    search on the bottleneck bound (waterfilling), then runs the exact
    local search on the result.
    """
    compute = [l for l in layers if l.macs > 0]
    if not compute:
        return [LayerAlloc(l, 0, 1, 1) for l in layers]
    total_pi = sum(l.macs for l in compute)
    theta: dict[str, int] = {}
    if objective == "optimal":
        wf = _waterfill(compute, theta_total, cycle_model)
        if wf is not None:
            theta.update(wf)
            _rebalance_exact(compute, theta, theta_total, cycle_model)
            return _finalize(layers, theta, cycle_model)
        objective = "exact"  # infeasible budget: fall back to greedy
    for l in compute:
        hat = l.macs * theta_total / total_pi
        rs = l.R * l.S
        theta[l.name] = max(rs, round(hat / rs) * rs)
    # Rounding may overshoot Theta; shave from the fastest until feasible.
    slowness = ((lambda l: engine_cycles(l, theta[l.name], cycle_model))
                if objective == "exact"
                else (lambda l: l.macs / theta[l.name]))
    while sum(theta.values()) > theta_total:
        order = sorted(compute, key=slowness)
        for j in order:
            rs = j.R * j.S
            if theta[j.name] > rs:
                theta[j.name] -= rs
                break
        else:
            break

    # Greedy refinement (lines 4-8): feed the slowest layer.
    while True:
        order = sorted(compute, key=slowness, reverse=True)
        placed = False
        for j in order:
            rs = j.R * j.S
            if theta[j.name] + rs > j.C * j.M * rs:
                continue  # already at full parallelism
            if sum(theta.values()) + rs <= theta_total:
                theta[j.name] += rs
                placed = True
                break
        if not placed:
            break

    if objective == "exact":
        _rebalance_exact(compute, theta, theta_total, cycle_model)

    return _finalize(layers, theta, cycle_model)


def _finalize(layers: Sequence[LayerWorkload], theta: dict[str, int],
              cycle_model: str = "packed") -> list[LayerAlloc]:
    allocs = []
    for l in layers:
        if l.macs == 0:
            allocs.append(LayerAlloc(l, 0, 1, 1, cycle_model=cycle_model))
            continue
        cp, mp = _decompose_theta(theta[l.name] // (l.R * l.S), l.C, l.M,
                                  cycle_model=cycle_model)
        allocs.append(LayerAlloc(l, cp * mp * l.R * l.S, cp, mp,
                                 cycle_model=cycle_model))
    return allocs


def _rebalance_exact(compute: list[LayerWorkload], theta: dict[str, int],
                     theta_total: int, cycle_model: str = "packed",
                     max_rounds: int = 400) -> None:
    """Multi-donor local search on the exact frame-cycle objective.

    Repeatedly: take the bottleneck engine b; to fund one extra R_b*S_b
    quantum, steal single quanta from the engines that stay fastest after
    donating; commit only if the global bottleneck strictly improves
    (ties broken by the number of engines sitting at the bottleneck).
    """
    def state() -> tuple[float, int]:
        times = [engine_cycles(l, theta[l.name], cycle_model) for l in compute]
        mx = max(times)
        return mx, sum(1 for t in times if t >= mx * (1 - 1e-12))

    for _ in range(max_rounds):
        cur_max, cur_ties = state()
        order = sorted(compute, key=lambda l: engine_cycles(l, theta[l.name], cycle_model),
                       reverse=True)
        improved = False
        for b in order:
            if engine_cycles(b, theta[b.name], cycle_model) < cur_max * (1 - 1e-12):
                break  # only engines at the bottleneck are worth funding
            rs_b = b.R * b.S
            if theta[b.name] + rs_b > b.C * b.M * rs_b:
                continue
            need = rs_b - (theta_total - sum(theta.values()))
            trial = dict(theta)
            trial[b.name] += rs_b
            ok = True
            while need > 0:
                donors = [d for d in compute
                          if d.name != b.name and trial[d.name] > d.R * d.S]
                donors = [d for d in donors
                          if engine_cycles(d, trial[d.name] - d.R * d.S,
                                           cycle_model)
                          < cur_max * (1 - 1e-12)]
                if not donors:
                    ok = False
                    break
                d = min(donors,
                        key=lambda d: engine_cycles(
                            d, trial[d.name] - d.R * d.S, cycle_model))
                trial[d.name] -= d.R * d.S
                need -= d.R * d.S
            if not ok:
                continue
            new_max = max(engine_cycles(l, trial[l.name], cycle_model) for l in compute)
            new_ties = sum(1 for l in compute
                           if engine_cycles(l, trial[l.name], cycle_model)
                           >= new_max * (1 - 1e-12))
            if (new_max, new_ties) < (cur_max, cur_ties):
                theta.clear()
                theta.update(trial)
                improved = True
                break
        if not improved:
            break


# ---------------------------------------------------------------------------
# Algorithm 2 — BRAM vs DDR bandwidth (faithful)
# ---------------------------------------------------------------------------

BRAM18_BYTES = 18 * 1024 // 8  # one BRAM18 block stores 18 Kbit


def bram_for_layer(alloc: LayerAlloc, prev_K: int, act_bytes: int = 1) -> int:
    """Activation-buffer BRAM18 blocks for one layer (Sections 3.3 / 4.2).

    Buffer rows: K_{i-1} (write side) + R_i + G_i*(K_i - 1) (read window).
    Each row holds W_i * C_i pixels split over the channelBuffers; BRAM
    blocks are allocated per channelBuffer (they cannot be subdivided).
    """
    l = alloc.layer
    rows = prev_K + l.R + l.stride * (alloc.K - 1)
    n_chan_buf = max(alloc.Cp, 1)
    row_px = l.W * math.ceil(l.C / n_chan_buf)
    per_buf = max(1, math.ceil(row_px * rows * act_bytes / BRAM18_BYTES))
    return per_buf * n_chan_buf


def weight_bram_for_layer(alloc: LayerAlloc, weight_bytes_el: int = 1) -> int:
    """Weight-buffer BRAM18 blocks for one compute engine.

    Non-resident engines stream their weights from DDR through a
    *double-buffered* ping-pong tile holding the PE grid's working set
    (C' x M' x R x S weights: one half feeds the multipliers while DDR
    fills the other — the weight-side twin of the activation double
    buffer). Engines Algorithm 2 marked ``weights_resident`` instead pin
    the full weight set on-chip (one copy, loaded once per frame), which
    collapses their reload traffic from ``omega_i = weight_bytes *
    ceil(H/K)`` to a single ``weight_bytes`` fetch.
    """
    l = alloc.layer
    if l.macs == 0:
        return 0
    if alloc.weights_resident:
        return max(1, math.ceil(l.weight_bytes / BRAM18_BYTES))
    tile = alloc.Cp * alloc.Mp * l.R * l.S * weight_bytes_el
    return 2 * max(1, math.ceil(tile / BRAM18_BYTES))


def total_bram(allocs: Sequence[LayerAlloc], act_bytes: int = 1, *,
               weights: bool = False,
               weight_bytes_el: int | None = None) -> int:
    """Total BRAM18 blocks: activation line buffers always; with
    ``weights=True`` also the weight buffers (streaming ping-pong tiles +
    any resident weight sets — the Table I "BRAM" column model)."""
    total, prev_K = 0, 1
    for a in allocs:
        if a.layer.kind in ("conv", "pool"):
            total += bram_for_layer(a, prev_K, act_bytes)
            prev_K = a.K
        if weights:
            total += weight_bram_for_layer(
                a, act_bytes if weight_bytes_el is None else weight_bytes_el)
    return total


def weight_traffic_per_frame(a: LayerAlloc) -> float:
    """Bytes of weights fetched from DDR per frame: a full reload once per
    K output rows (omega_i in Algorithm 2); a single load for engines
    whose weights are pinned on-chip."""
    if a.weights_resident:
        return float(a.layer.weight_bytes)
    reloads = max(1, math.ceil(a.layer.H / max(1, a.K)))
    return a.layer.weight_bytes * reloads


def allocate_buffers(
    allocs: list[LayerAlloc],
    *,
    bram_total: int,
    bandwidth_bytes: float,
    freq_hz: float,
    act_bytes: int = 1,
    weights: bool = False,
    strict: bool = False,
    max_iters: int = 100_000,
) -> list[LayerAlloc]:
    """Algorithm 2 — raise row parallelism K_i to fit the bandwidth roof.

    While the aggregate weight traffic B = FPS * sum(omega_i) exceeds the
    board bandwidth beta, bump K of the worst-traffic conv layer, paying
    activation-buffer BRAMs; stop when BRAM budget alpha would be exceeded.

    With ``weights=True`` the alpha test also charges weight buffers
    (:func:`weight_bram_for_layer`: double-buffered streaming tiles), and
    a second phase spends the surplus BRAM pinning whole conv weight sets
    on-chip — greedily by DDR traffic saved per BRAM block — which cuts
    reload traffic beyond what K alone can (the model behind the paper's
    reported BRAM utilization totals; see ``tests/test_allocator.py``'s
    regression against Table I).

    The phases only ever *add* BRAM to a K=1 baseline, so a budget the
    baseline itself does not fit is returned as-is (best effort, the
    paper assumes alpha covers the mandatory buffers); pass
    ``strict=True`` to get a ``ValueError`` instead of a silently
    over-budget plan (e.g. when sweeping small boards for feasibility).
    """
    from repro_torch.core.throughput import pipeline_fps

    convs = [a for a in allocs if a.layer.macs > 0 and a.layer.kind == "conv"]

    def used() -> int:
        return total_bram(allocs, act_bytes, weights=weights)

    def demand() -> float:
        f = pipeline_fps(allocs, freq_hz=freq_hz)
        return f * sum(weight_traffic_per_frame(a) for a in convs)

    if strict and used() > bram_total:
        raise ValueError(
            f"BRAM budget alpha={bram_total} cannot hold the K=1 "
            f"baseline ({used()} blocks of mandatory activation"
            f"{'/weight' if weights else ''} buffers)")

    for _ in range(max_iters):
        if demand() <= bandwidth_bytes:
            break
        cand = max(convs, key=weight_traffic_per_frame)
        if cand.K >= cand.layer.H:
            break
        cand.K += 1
        if used() > bram_total:
            cand.K -= 1
            break
    if not weights:
        return allocs

    # Phase 2 — weight residency: surplus alpha buys the hottest weight
    # streams a permanent home. Order by traffic saved per BRAM block so
    # a huge layer cannot starve two cheaper, hotter ones.
    def saving(a: LayerAlloc) -> float:
        reloads = max(1, math.ceil(a.layer.H / max(1, a.K)))
        return a.layer.weight_bytes * (reloads - 1)

    def blocks(a: LayerAlloc) -> int:
        return max(1, math.ceil(a.layer.weight_bytes / BRAM18_BYTES))

    for a in sorted((a for a in convs if saving(a) > 0),
                    key=lambda a: saving(a) / blocks(a), reverse=True):
        a.weights_resident = True
        if used() > bram_total:
            a.weights_resident = False
    return allocs


# ---------------------------------------------------------------------------
# Mesh mode — the TPU-pod port of Algorithms 1 + 2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshHw:
    """Per-chip hardware roofs (defaults: TPU v5e)."""

    peak_flops: float = 197e12     # bf16
    hbm_bytes: float = 16e9
    hbm_bw: float = 819e9
    ici_bw: float = 50e9           # per link


V5E = MeshHw()


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Output of the mesh allocator: the flexible pipeline layout."""

    n_stages: int                    # S
    tensor_parallel: int             # T; S*T == model axis size
    boundaries: tuple[int, ...]      # len S+1 layer indices (contiguous)
    microbatches: int                # GPipe microbatch count
    stage_flops: tuple[int, ...]     # flops per stage (global batch)
    t_stage_max: float               # sec/microbatch, the T_rowmax analogue
    bubble_fraction: float
    step_time: float                 # sec (predicted)
    utilization: float               # ideal/achieved = DSP-efficiency analogue
    mem_per_chip: float              # bytes (params+opt+activations)

    @property
    def layers_per_stage(self) -> tuple[int, ...]:
        return tuple(self.boundaries[i + 1] - self.boundaries[i]
                     for i in range(self.n_stages))


def _partition_min_max(weights: Sequence[float], k: int) -> tuple[list[int], float]:
    """Optimal contiguous partition of ``weights`` into k parts minimizing
    the max part-sum (DP). This is Algorithm 1's balance objective solved
    exactly for the mesh setting: "give more multipliers to the slowest
    layer" becomes "give fewer layers to the slowest stage".
    """
    n = len(weights)
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    INF = math.inf
    dp = [[INF] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for p in range(j - 1, i):
                cost = max(dp[p][j - 1], prefix[i] - prefix[p])
                if cost < dp[i][j]:
                    dp[i][j] = cost
                    cut[i][j] = p
    bounds = [n]
    i, j = n, k
    while j > 0:
        i = cut[i][j]
        bounds.append(i)
        j -= 1
    bounds.reverse()
    return bounds, dp[n][k]


def plan_pipeline(
    layers: Sequence[LayerWorkload],
    *,
    model_axis: int,
    data_axis: int,
    global_batch: int,
    seq_len: int,
    train: bool,
    hw: MeshHw = V5E,
    dtype_bytes: int = 2,
    d_model: int | None = None,
    stage_choices: Sequence[int] | None = None,
    max_microbatches: int = 128,
    overlap_comm: bool = False,
    zero1: bool = True,
    allow_infeasible: bool = False,
) -> StagePlan:
    """Mesh-mode Algorithms 1 + 2.

    For each stage count S dividing the model axis, partition layers to
    minimize the slowest stage (Alg. 1), then sweep the microbatch count —
    the FPGA row-parallelism K maps to tokens-per-weight-residency
    ``total_tokens / microbatches``; more microbatches shrink the pipeline
    bubble but re-stream stage weights from HBM more often (Alg. 2's
    bandwidth-vs-buffer trade, with alpha -> HBM capacity, beta -> HBM bw).
    """
    mult = 3.0 if train else 1.0
    flops = [l.macs * 2.0 * mult for l in layers]
    wbytes = [float(l.weight_bytes) for l in layers]
    total_flops = sum(flops)
    n_chips = model_axis * data_axis
    if d_model is None:
        d_model = max(l.C for l in layers)
    tokens_per_shard = max(1, global_batch // max(1, data_axis)) * seq_len

    if stage_choices is None:
        stage_choices = [s for s in (1, 2, 4, 8, 16) if model_axis % s == 0]

    best: StagePlan | None = None
    for S in stage_choices:
        if S > max(1, len(layers)):
            continue
        T = model_axis // S
        bounds, _ = _partition_min_max(flops, S)
        stage_fl = [sum(flops[bounds[i]:bounds[i + 1]]) for i in range(S)]
        stage_wb = [sum(wbytes[bounds[i]:bounds[i + 1]]) for i in range(S)]
        max_fl, max_wb = max(stage_fl), max(stage_wb)

        layers_max = max(bounds[i + 1] - bounds[i] for i in range(S))
        for mb in [2 ** p for p in range(0, 1 + int(math.log2(max_microbatches)))]:
            if S > 1 and mb < S:
                continue  # degenerate pipeline
            # Per-microbatch, per-chip times for the slowest stage.
            t_comp = max_fl / mb / (T * data_axis) / hw.peak_flops
            t_wt = (max_wb / T) / hw.hbm_bw           # weights re-read per mb
            mb_act = tokens_per_shard / mb * d_model * dtype_bytes
            # Megatron TP all-reduces: 2/layer fwd (+2 bwd) on the tp ring.
            n_ar = 2 * (2 if train else 1)
            t_tp = (layers_max * n_ar * 2.0 * (T - 1) / T * mb_act
                    / hw.ici_bw) if T > 1 else 0.0
            # Inter-stage transfer (the activation line buffer).
            t_xfer = (mb_act / hw.ici_bw) if S > 1 else 0.0
            if overlap_comm:
                t_mb = max(t_comp, t_wt, t_tp + t_xfer)
            else:
                t_mb = max(t_comp, t_wt) + t_tp + t_xfer
            step = t_mb * (mb + S - 1)

            # HBM capacity (the alpha test).
            param_chip = max_wb / T
            opt_chip = (param_chip * 6.0 / (data_axis if zero1 else 1)
                        if train else 0.0)
            inflight = min(mb, S) if train else 1
            act_chip = (tokens_per_shard / mb) * d_model * dtype_bytes \
                * inflight / T
            mem = param_chip + opt_chip + act_chip
            if mem > hw.hbm_bytes:
                continue

            ideal = total_flops / (n_chips * hw.peak_flops)
            util = min(1.0, ideal / step) if step > 0 else 0.0
            plan = StagePlan(
                n_stages=S, tensor_parallel=T, boundaries=tuple(bounds),
                microbatches=mb, stage_flops=tuple(int(f) for f in stage_fl),
                t_stage_max=max_fl / mb / (T * data_axis) / hw.peak_flops,
                bubble_fraction=(S - 1) / (mb + S - 1),
                step_time=step, utilization=util, mem_per_chip=mem,
            )
            if best is None or plan.utilization > best.utilization:
                best = plan
    if best is None:
        if allow_infeasible:
            # Best-effort plan ignoring the HBM cap (flagged by caller via
            # mem_per_chip > hbm_bytes): weight sharding over data (the
            # pjit FSDP path) is then required.
            return plan_pipeline(
                layers, model_axis=model_axis, data_axis=data_axis,
                global_batch=global_batch, seq_len=seq_len, train=train,
                hw=dataclasses.replace(hw, hbm_bytes=float("inf")),
                dtype_bytes=dtype_bytes, d_model=d_model,
                stage_choices=stage_choices,
                max_microbatches=max_microbatches,
                overlap_comm=overlap_comm, zero1=zero1,
                allow_infeasible=False)
        raise ValueError(
            "no feasible pipeline plan fits HBM; increase mesh or reduce model")
    return best
