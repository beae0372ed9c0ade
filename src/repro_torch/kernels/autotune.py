"""Static tiling ranker for the port's Hopper kernels, the counterpart of
``repro/kernels/autotune.py``.

The reference ranks Pallas blocks structurally against a TPU's VMEM and
its 128x128 MXU. This module ranks the tilings the port's own CUDA
kernels are built for, the same way, from the H100's numbers:

* ``gemm_int8``: the ``Plan``s of ``conv2d_int8/kernel.py::plans`` (the
  ``GEMM_CASE`` instantiations of ``gemm_int8.cu``), each a ``wgmma``
  width by 64 rows per consumer warpgroup, with the shared-memory ring
  that ``gemm_int8.cu``'s ``WgTile`` gives it;
* ``flash_attention``: query tiles of one or two consumer warpgroups (64
  or 128 rows; the kernel is built with two) by key tiles of the two
  ``wgmma`` widths ``flash_attention.cu`` issues (n64 and n128), each
  with its two-stage K/V ring.

Hard constraints: a block's shared memory within the 227 KB an H100 block
may take; ``wgmma`` widths multiples of 8 up to 256; rows in 64 per
warpgroup; for attention, the accumulators within a consumer thread's
registers. Ranking, in this order, each step keeping the candidates
within ``TIE`` (1%) of the best: (1) MMA occupancy, the useful share of
the MACs the tiles issue (ragged edges, K padded to whole 128-byte boxes,
the masked part of causal or windowed key tiles); (2) how evenly the
tiles fill the 132 SMs (tiles over whole waves of blocks); (3) HBM bytes
(``gemm_int8``: x re-read once per column tile, w once per row tile,
the output once; attention: q and o once, K and V once per query tile
that visits them); (4) shared memory.

Nothing here launches a kernel or replaces the wrappers' rules:
``plan_for`` stays ``gemm_int8``'s choice and ``flash_attention.cu``'s
tiles are fixed at build. ``chip_smoke.py`` prints the picks beside
``plan_for``'s choice, the built tiles and the measured fastest tiling.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels.conv2d_int8.kernel import BOX_K, Plan, plans

SMS = 132                       # H100 SXM
SMEM_PER_BLOCK = 227 * 1024     # the most shared memory one block may take
SMEM_PER_SM = 228 * 1024
WGMMA_MAX_N = 256
WG_ROWS = 64                    # rows of one warpgroup's wgmma (m64)
TIE = 0.01                      # keys within 1% of the best tie

# gemm_int8.cu's WgTile: the ring takes what its budget allows up to
# MAX_STAGES stages; one block an SM with two consumer warpgroups, two
# with one.
GEMM_MAX_STAGES = 8
GEMM_BUDGET = {1: 100 * 1024, 2: 200 * 1024}     # by consumer warpgroups

# flash_attention.cu's wgmma kernel: two K/V stages, 240 registers a
# consumer thread, and the key widths it issues.
ATTN_STAGES = 2
ATTN_CONSUMER_REGS = 240
ATTN_REG_OVERHEAD = 24          # softmax state, addresses, loop counters
ATTN_BQ = (64, 128)
ATTN_BKV = (64, 128)


@dataclasses.dataclass(frozen=True)
class GemmCandidate:
    bn: int               # rows of x a tile
    bm: int               # output columns a tile
    bk: int               # K bytes a pipeline stage
    smem_bytes: int       # the block's shared-memory ring
    hbm_bytes: float      # total traffic for the whole GEMM
    mxu_occupancy: float  # useful share of the MACs the tiles issue
    sm_fill: float        # tiles over whole waves of blocks
    plan: Plan


def _wgmma_ok(width: int, rows: int) -> bool:
    return width % 8 == 0 and 8 <= width <= WGMMA_MAX_N \
        and rows % WG_ROWS == 0


def _fill(tiles: int, slots: int) -> float:
    return tiles / (math.ceil(tiles / slots) * slots)


def gemm_smem_bytes(plan: Plan) -> int:
    """The shared memory of ``plan``'s block: ``gemm_int8.cu``'s ring of
    stages, each ``k_boxes`` 128-byte boxes of both operands' tile rows,
    plus 1 KB for alignment."""
    rows = WG_ROWS * plan.warpgroups
    stage = plan.k_boxes * (rows + plan.width) * BOX_K
    stages = min(GEMM_BUDGET[plan.warpgroups] // stage, GEMM_MAX_STAGES)
    return stages * stage + 1024


def gemm_candidates(N: int, K: int, M: int, *,
                    in_bytes: int = 1) -> list[GemmCandidate]:
    """Every built tiling that can take N rows of x, with its costs; those
    that break a hard constraint are left out."""
    out = []
    for plan in plans(N):
        rows = WG_ROWS * plan.warpgroups
        if plan.path == "small_n":     # the swapped problem: rows over M
            bn, bm = plan.width, rows
        else:
            bn, bm = rows, plan.width
        bk = BOX_K * plan.k_boxes
        smem = gemm_smem_bytes(plan)
        blocks_per_sm = 2 if plan.warpgroups == 1 else 1
        if not _wgmma_ok(plan.width, rows) or smem > SMEM_PER_BLOCK \
                or blocks_per_sm * smem > SMEM_PER_SM:
            continue
        gn, gm = math.ceil(N / bn), math.ceil(M / bm)
        gk = math.ceil(K * in_bytes / bk)
        occ = (N * M * K * in_bytes) / (gn * bn * gm * bm * gk * bk)
        hbm = (N * K * gm + K * M * gn) * in_bytes + N * M  # int8 out
        fill = _fill(gn * gm, SMS * blocks_per_sm)
        out.append(GemmCandidate(bn, bm, bk, smem, hbm, occ, fill, plan))
    return out


def _rank(cands: list, keys) -> object:
    """The best candidate by ``keys`` in order, each (attribute, sign):
    at each step keep the candidates within ``TIE`` of the best value."""
    for attr, sign in keys:
        best = max(sign * getattr(c, attr) for c in cands)
        cands = [c for c in cands
                 if sign * getattr(c, attr) >= best - TIE * abs(best)]
    return cands[0]


def pick_gemm_blocks(N: int, K: int, M: int, **kw) -> GemmCandidate:
    """Best candidate: max MMA occupancy, then max SM fill, then min HBM
    traffic, then min shared memory."""
    cands = gemm_candidates(N, K, M, **kw)
    if not cands:
        raise ValueError("no built tiling fits the H100's shared memory")
    return _rank(cands, [("mxu_occupancy", 1), ("sm_fill", 1),
                         ("hbm_bytes", -1), ("smem_bytes", -1)])


@dataclasses.dataclass(frozen=True)
class AttnCandidate:
    bq: int
    bkv: int
    smem_bytes: int
    hbm_bytes: float
    mxu_occupancy: float   # useful share of the QK^T / PV MACs issued
    sm_fill: float
    regs: int              # a consumer thread's accumulator registers


def _attn_work(S: int, bq: int, bkv: int, causal: bool, window: int):
    """(key tiles the query tiles visit, valid query-key pairs) of one
    head: query i sees keys up to i when causal, above i - window with a
    window, the masks of ``flash_attention``."""
    def span(i0, i1):           # the keys some query in [i0, i1] sees
        return (max(0, i0 - window + 1) if window else 0,
                i1 if causal else S - 1)

    tiles = sum(hi // bkv - lo // bkv + 1 for lo, hi in
                (span(q0, min(q0 + bq, S) - 1) for q0 in range(0, S, bq)))
    pairs = sum(hi - lo + 1 for lo, hi in (span(i, i) for i in range(S)))
    return tiles, pairs


def attention_candidates(S: int, d: int, *, batch: int = 1, heads: int = 1,
                         causal: bool = True, window: int = 0,
                         dtype_bytes: int = 2) -> list[AttnCandidate]:
    out = []
    for bq in ATTN_BQ:
        for bkv in ATTN_BKV:
            smem = (bq * d + 2 * ATTN_STAGES * bkv * d) * dtype_bytes \
                + 16 * 8 + 1024
            regs = d // 2 + bkv // 2 + bkv // 4 + ATTN_REG_OVERHEAD
            if not (_wgmma_ok(bkv, bq) and _wgmma_ok(d, bq)) \
                    or smem > SMEM_PER_BLOCK or regs > ATTN_CONSUMER_REGS:
                continue
            kv_tiles, pairs = _attn_work(S, bq, bkv, causal, window)
            occ = pairs / (kv_tiles * bq * bkv)
            hbm = dtype_bytes * batch * heads * d * (
                2 * S + 2 * bkv * kv_tiles)
            fill = _fill(batch * heads * math.ceil(S / bq), SMS)
            out.append(AttnCandidate(bq, bkv, smem, hbm, occ, fill, regs))
    return out


def pick_attention_blocks(S: int, d: int, **kw) -> AttnCandidate:
    """Flash-attention query/key tiles: max MMA occupancy, then max SM
    fill, then min HBM traffic (K/V re-read once per query tile), then
    min shared memory."""
    cands = attention_candidates(S, d, **kw)
    if not cands:
        raise ValueError("no attention tiling fits a block")
    return _rank(cands, [("mxu_occupancy", 1), ("sm_fill", 1),
                         ("hbm_bytes", -1), ("smem_bytes", -1)])


def built_attention_blocks(d: int) -> tuple[int, int]:
    """The (query, key) tile ``flash_attention.cu``'s wgmma kernel is
    built with at head dim ``d`` (bf16 at d 64, 128, 256): 128 x 128, and
    128 x 64 at d 256."""
    if d not in (64, 128, 256):
        raise ValueError(f"the wgmma kernel is built for d 64, 128, 256, "
                         f"not {d}")
    return 128, 64 if d == 256 else 128
