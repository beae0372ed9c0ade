"""``repro_torch.kernels.autotune``, the static tiling ranker, in the manner
of the reference's ``tests/test_kernels.py::
test_autotuner_picks_feasible_aligned_blocks``: its picks are feasible on
an H100 and aligned to ``wgmma``, drawn from the tilings the kernels are
built for, and its constants are the CUDA sources'."""

import re
from pathlib import Path

import pytest

from repro_torch.kernels import autotune as A
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel

# (N, K, M): the reference's shape, AlexNet's and VGG16's at batch 16
# (conv and fc), N across the small-N limit, ragged edges.
GEMM_SHAPES = [(50176, 576, 128), (48400, 363, 96), (11664, 1200, 128),
               (2704, 2304, 384), (802816, 27, 64), (3136, 4608, 512),
               (16, 9216, 4096), (16, 4096, 1000), (1, 100, 10),
               (17, 4096, 1000), (64, 300, 96), (65, 300, 96),
               (300, 10000, 64)]


def _aligned(c):
    rows = c.plan.warpgroups * A.WG_ROWS
    return (c.plan.width % 8 == 0 and 8 <= c.plan.width <= 256
            and rows % 64 == 0 and c.bk % gemm_kernel.BOX_K == 0)


@pytest.mark.parametrize("N,K,M", GEMM_SHAPES)
def test_gemm_pick_is_a_feasible_aligned_built_tiling(N, K, M):
    c = A.pick_gemm_blocks(N, K, M)
    assert c.plan in gemm_kernel.plans(N)
    assert c.smem_bytes <= A.SMEM_PER_BLOCK and _aligned(c)
    assert 0 < c.mxu_occupancy <= 1 and 0 < c.sm_fill <= 1
    # Every built tiling that can take N is a candidate, all feasible.
    cands = A.gemm_candidates(N, K, M)
    assert [x.plan for x in cands] == gemm_kernel.plans(N)
    assert all(x.smem_bytes <= A.SMEM_PER_BLOCK and _aligned(x)
               for x in cands)
    # The pick leads on the first key, within the 1% tie.
    assert c.mxu_occupancy >= (1 - A.TIE) * max(x.mxu_occupancy
                                                for x in cands)


def test_gemm_ranking_order():
    """Occupancy first (M = 96 fits the 96-wide tile whole), then the SM
    fill (AlexNet conv3: 64-row tiles fill 2704 rows closer), then HBM
    bytes (VGG16 conv2_1: the 128-wide tile reads x once), then shared
    memory."""
    assert A.pick_gemm_blocks(48400, 363, 96).plan.width == 96
    c = A.pick_gemm_blocks(2704, 2304, 384)
    assert (c.plan.width, c.plan.warpgroups) == (64, 1)
    c = A.pick_gemm_blocks(200704, 576, 128)
    assert (c.plan.width, c.plan.warpgroups) == (128, 2)
    # N <= 64: the narrowest swapped width that holds N.
    assert A.pick_gemm_blocks(16, 4096, 4096).plan == gemm_kernel.Plan(
        "small_n", 16, 1)
    assert A.pick_gemm_blocks(17, 4096, 1000).plan.width == 32


def test_gemm_smem_is_the_sources_ring():
    """``gemm_int8.cu``'s WgTile: the budgets by blocks an SM and the
    stage cap that ``gemm_smem_bytes`` models."""
    text = Path(gemm_kernel.SOURCE).read_text()
    assert re.search(r"BUDGET = B == 1 \? 200 \* 1024 : 100 \* 1024", text)
    assert re.search(r"constexpr int MAX_STAGES = 8;", text)
    assert re.search(r"constexpr int BK = 128;", text)
    assert A.GEMM_BUDGET == {2: 200 * 1024, 1: 100 * 1024}
    assert A.GEMM_MAX_STAGES == 8 and gemm_kernel.BOX_K == 128
    # large_n 128 x 128: 32 KB a stage, 6 stages in 200 KB, + alignment.
    assert A.gemm_smem_bytes(gemm_kernel.Plan("large_n", 128, 2)) == \
        6 * 32768 + 1024


@pytest.mark.parametrize("S,d,causal,window", [
    (32768, 128, False, 0), (2048, 128, True, 0), (4096, 256, True, 2048),
    (2048, 64, False, 0), (1000, 64, True, 0)])
def test_attention_pick_is_feasible_and_aligned(S, d, causal, window):
    a = A.pick_attention_blocks(S, d, causal=causal, window=window)
    assert a.smem_bytes <= A.SMEM_PER_BLOCK
    assert a.regs <= A.ATTN_CONSUMER_REGS
    assert a.bq % 64 == 0 and a.bkv % 8 == 0 and a.bkv <= 256
    assert (a.bq, a.bkv) in {(q, k) for q in A.ATTN_BQ for k in A.ATTN_BKV}


def test_attention_ranking():
    """Bigger query tiles amortise K/V re-reads (the reference's own
    check) where nothing else separates them; a causal mask makes smaller
    tiles waste less on the diagonal; at d 256 the accumulators leave no
    room for 128-key tiles, which is why the kernel takes 64 there."""
    assert A.pick_attention_blocks(32768, 128, causal=False).bq == 128
    causal = A.pick_attention_blocks(2048, 128, causal=True)
    assert (causal.bq, causal.bkv) == (64, 64)
    assert all(c.bkv == 64 for c in A.attention_candidates(4096, 256))
    assert any(c.bkv == 128 for c in A.attention_candidates(4096, 128))


def test_attention_built_tiles_are_the_sources():
    """``built_attention_blocks`` names the tiles ``flash_attention.cu``
    is built with, and each is a feasible candidate at its head dim."""
    text = Path(flash_kernel.SOURCE).read_text()
    assert re.search(r"constexpr int WG_BQ = 128;", text)
    assert re.search(r"BKV = D == 256 \? 64 : 128;", text)
    assert re.search(r"STAGES = 2;", text)
    assert re.search(r"CONSUMER_REGS = 240;", text)
    assert A.ATTN_STAGES == 2 and A.ATTN_CONSUMER_REGS == 240
    assert A.built_attention_blocks(128) == (128, 128)
    assert A.built_attention_blocks(256) == (128, 64)
    with pytest.raises(ValueError, match="d 64, 128, 256"):
        A.built_attention_blocks(32)
    for d in (64, 128, 256):
        tiles = {(c.bq, c.bkv) for c in A.attention_candidates(2048, d)}
        assert A.built_attention_blocks(d) in tiles


def test_no_feasible_tiling_raises():
    with pytest.raises(ValueError, match="attention"):
        A.pick_attention_blocks(2048, 512)
