// Blockwise (flash) softmax attention, forward, written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`, pallas_call at :80): out[b, i, h]
// = softmax over the keys j of (q[b, i, h] . k[b, j, h'] / sqrt(d),
// masked) times v[b, j, h'], with an online softmax whose running max m,
// denominator l and accumulator stay in fp32. Causal (kpos <= qpos) and
// sliding-window (kpos > qpos - window) masks; query i sits at qpos = i +
// Skv - Sq. Grouped-query attention reads key/value head h' = h / (H / KV)
// in place: the same function as the reference's jnp.repeat of K/V over
// the heads, without materialising the repeat.
//
// Numerics, in the reference's order: logits = fp32 dot * (1/sqrt(d));
// masked logits = -1e30 and m starts at -1e30; p = exp(logits - m_new),
// corr = exp(m_prev - m_new), l = l * corr + sum(p); p is cast to v's
// dtype before the PV product; out = acc / max(l, 1e-30), cast to q's
// dtype. Keys past Skv (the ragged last tile) are not masked but absent:
// their logit is -inf, so p = 0 exactly. A key tile that the causal or
// window mask covers whole is skipped: had it run first, its p = 1 terms
// would be wiped by corr = exp(-1e30 - m) = 0 once the row's first valid
// key arrives; had it run later, its p would be 0. The one case where a
// row has no valid key at all (causal with Sq > Skv, qpos < 0) is the case
// where a block skips nothing: such a row then averages every value, as
// the reference's does. The wgmma kernel keeps the logits in log2 units
// (scaled by log2(e) / sqrt(d), -1e30 and -inf as they are) and takes
// exp2, which is the same function up to fp32 rounding.
//
// Layout: q/k/v/o are [B, S, H, d] with d contiguous, read through their
// batch/sequence/head strides (no transposes on the host). Each block takes
// one (batch, head, query tile); the loop over key tiles runs inside it.
//
// What bounds it on the H100 at the Yi-6B shape (B 2, S 2048, H 32, KV 4,
// d 128, bf16, causal): 6.9e10 multiply-adds x 2 against 75 MB of q/k/v/o,
// so the tensor cores' bf16 rate (989 TFLOP/s), not memory, is the limit:
// 0.07 ms. At the RecurrentGemma-2B shape (B 2, S 4096, H 10, KV 1, d 256,
// causal, window 2048) each (b, h) computes 6,292,480 query-key pairs:
// 1.29e11 FLOP, 0.130 ms, again the tensor cores' rate.
//
// Three kernels:
//   * bf16 at d 64, 128 and 256, the head dims the configs use
//     (`flash_fwd_wgmma`). Only `wgmma` reaches the tensor cores' full
//     rate, and it wants its operands in shared memory in the layout TMA
//     writes, fed by loads that no compute thread issues. So a block of
//     three warpgroups takes a 128-row query tile:
//       - one producer thread loads Q once and the K/V tiles by TMA
//         (4-D tensor maps over the [B, S, H, d] views, encoded on the
//         host at each launch; rows are 64-column boxes of 128 bytes,
//         128-byte swizzled, 2 boxes a row at d 128 and 4 at d 256;
//         rows past S arrive as zeros) into a two-stage ring whose
//         full/empty mbarriers let the loads of the next tiles run under
//         the products on this one; its warpgroup gives up registers
//         (setmaxnreg.dec);
//       - two consumer warpgroups (setmaxnreg.inc) take 64 query rows
//         each and read each K/V tile from the ring once for 128 queries:
//         S = Q K^T by wgmma with both operands in shared memory, K-major
//         as stored; the online softmax in registers (the accumulator's
//         rows are 16 warp + lane / 4 and + 8, so the row max and sum are
//         quad shuffles as with mma.sync); P cast to bf16 in registers as
//         wgmma's A operand (the accumulator and A fragment layouts line
//         up); O += P V by wgmma with V read as it lies in memory,
//         [keys][d], MN-major through the transpose bit, one 64-column
//         box per product; O stays in registers (128 words a thread at
//         d 256, so the key tile is 64 there and 128 below). Shared
//         memory: Q 64 KB + 2 stages x (K + V) 64 KB = 192 KB at d 256.
//       - The products run under the softmax twice over. Within a
//         warpgroup, QK^T of key tile j goes out together with PV of
//         tile j - 1, so the softmax of tile j runs while PV of j - 1 is
//         on the tensor cores (S, P and O live at once: 64 + 32 + 64
//         registers at d 128, 32 + 16 + 128 at d 256). Between the two
//         warpgroups, named barriers make them take turns issuing, so
//         one's softmax runs under the other's products. Registers that
//         an asynchronous product reads or writes are pinned before
//         wgmma.fence and after the wait, so ptxas never serialises the
//         products (it reports it when it does).
//     Query tiles run heaviest first: the grid is (H, B, query tile) with
//     the tile index reversed, so the causal tiles with the most keys
//     start in the first wave and the short ones fill the tail. Key tiles
//     run from the last to the first, so the tiles the diagonal cuts come
//     first.
//   * bf16 at d 16 and 32 (`flash_fwd_bf16`): 4 warps, 64 query rows,
//     64-key tiles, mma.sync m16n8k16 with fp32 accumulation, K/V by
//     cp.async into a two-stage ring, fragments by ldmatrix (V's by
//     ldmatrix.trans), S repacked in registers as PV's A operand. A row
//     of 16 or 32 bf16 is narrower than the 128-byte TMA box and swizzle
//     the wgmma kernel is built on; no config uses these head dims.
//   * fp32 at every head dim (`flash_fwd_f32`): plain FMA (no TF32: the
//     reference's tests hold fp32 to 2e-5), 32 query rows x 32-key tiles,
//     4 threads a row.
// Tiles wholly outside the causal/window band are skipped, as `key_tiles`
// says; only the tiles that cross the diagonal, the window's edge or the
// ragged end are masked element by element.
//
// What remains: O is stored from registers rather than through shared
// memory and TMA; there is no persistent scheduler (one block a query
// tile, one block an SM, so the last wave of a causal grid runs short
// tiles on part of the card); no fp8; no backward (the reference has
// none). `chip_smoke.py` reports ptxas's registers, spill bytes and
// performance notes for every instantiation.

#include <cuda_bf16.h>
#include <math.h>

#include "../../csrc/hopper.cuh"   // mbarriers, wgmma fences, tensor maps

namespace {

constexpr float MASKED = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, seq, head
  int Sq, Skv, H, group;                 // group = H / KV
  int causal, window;
  float scale;                           // 1 / sqrt(d)
  float scale_log2;                      // log2(e) / sqrt(d)
};

// The key range [lo, hi) a query tile [q0, q0 + rows) must visit, cut to
// whole tiles of `bkv` keys.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int rows,
                                          int bkv, int* t0, int* t1) {
  const int off = p.Skv - p.Sq;
  const int first = q0 + off;                       // qpos of the first row
  const int last = min(q0 + rows, p.Sq) - 1 + off;  // qpos of the last row
  int lo = 0, hi = p.Skv;
  const bool every_row_has_a_key = !(p.causal && first < 0);
  if (every_row_has_a_key) {
    if (p.causal) hi = min(p.Skv, last + 1);
    if (p.window) lo = max(0, first - p.window + 1);
  }
  *t0 = lo / bkv;
  *t1 = (hi + bkv - 1) / bkv;
}

// One logit after scaling and masking, as the reference computes it.
__device__ __forceinline__ float masked_logit(const Params& p, float dot,
                                              int qpos, int kpos) {
  if (kpos >= p.Skv) return -INFINITY;  // past the ragged end: absent
  const float x = dot * p.scale;
  if (p.causal && kpos > qpos) return MASKED;
  if (p.window && kpos <= qpos - p.window) return MASKED;
  return x;
}

// ---------------------------------------------------------------------------
// bf16 at d 16 and 32: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ16 = 64;       // query rows per block
constexpr int BKV16 = 64;      // keys per tile
constexpr int WARPS16 = 4;
constexpr int PAD16 = 8;       // shared rows padded by 8 bf16 (16 bytes)
constexpr int STAGES16 = 2;    // K/V tiles in flight

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3). Without .trans lane l receives
// M[l / 4][2 (l % 4) .. +1] of each matrix; with .trans,
// M[2 (l % 4) .. +1][l / 4].
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows x D bf16 from global rows [r0, r0 + rows) (zero past `limit`)
// into a padded shared tile, 16 bytes a thread per step.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride,
    int r0, int limit, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = tid; c < ROWS * CH; c += WARPS16 * 32) {
    const int r = c / CH, c8 = c % CH;
    const bool valid = r0 + r < limit;
    const __nv_bfloat16* g = valid ? src + (r0 + r) * row_stride + c8 * 8
                                   : src;
    cp_async16(dst + r * (D + PAD16) + c8 * 8, g, valid);
  }
}

// Q's A fragment of k-step kk for this thread: rows g and g + 8 of the
// warp's 16, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of the step's 16.
template <int LD>
__device__ __forceinline__ void load_q_frag(uint32_t a[4],
                                            const __nv_bfloat16* Qs,
                                            int warp, int g, int t, int kk) {
  const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * LD + 2 * t + kk * 16;
  const __nv_bfloat16* r1 = r0 + 8 * LD;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

template <int D>
__global__ void __launch_bounds__(WARPS16 * 32)
flash_fwd_bf16(Params p) {
  constexpr int LD = D + PAD16;          // Qs, Ks, Vs: [rows][LD]
  constexpr int KSTEPS = D / 16;         // k-steps of QK^T
  constexpr int NT_S = BKV16 / 8;        // n-tiles of S (8 keys each)
  constexpr int NT_O = D / 8;            // n-tiles of O (8 dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ16 * LD;                 // [STAGES16][BKV16][LD]
  __nv_bfloat16* Vs = Ks + STAGES16 * BKV16 * LD;     // [STAGES16][BKV16][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int q0 = blockIdx.x * BQ16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q)
      + b * p.qs[0] + h * p.qs[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k)
      + b * p.ks[0] + hk * p.ks[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v)
      + b * p.vs[0] + hk * p.vs[2];

  int t0, t1;
  key_tiles(p, q0, BQ16, BKV16, &t0, &t1);

  // Q tile and the first K/V tile in flight together.
  load_tile_async<D, BQ16>(Qs, qg, p.qs[1], q0, p.Sq, tid);
  load_tile_async<D, BKV16>(Ks, kg, p.ks[1], t0 * BKV16, p.Skv, tid);
  load_tile_async<D, BKV16>(Vs, vg, p.vs[1], t0 * BKV16, p.Skv, tid);
  cp_async_commit();

  // Each thread holds rows g and g + 8 of its warp's 16.
  const int off = p.Skv - p.Sq;
  const int qpos0 = q0 + warp * 16 + g + off;
  const int qpos1 = qpos0 + 8;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[KSTEPS][4];          // Q's A fragments, for the whole loop

  // ldmatrix lane offsets (elements) within a 16-row slab: K as the
  // non-transposed B operand (matrices: keys 0-7/d 0-7, keys 0-7/d 8-15,
  // keys 8-15/d 0-7, keys 8-15/d 8-15), V as the transposed one
  // (keys 0-7/d 0-7, keys 8-15/d 0-7, keys 0-7/d 8-15, keys 8-15/d 8-15).
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * LD
      + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD
      + (lane >> 4) * 8;

  for (int kt = t0; kt < t1; ++kt) {
    const int stage = (kt - t0) % STAGES16;
    if (kt + 1 < t1) {             // the next tile loads under this one
      const int next = (kt + 1 - t0) % STAGES16;
      load_tile_async<D, BKV16>(Ks + next * BKV16 * LD, kg, p.ks[1],
                                (kt + 1) * BKV16, p.Skv, tid);
      load_tile_async<D, BKV16>(Vs + next * BKV16 * LD, vg, p.vs[1],
                                (kt + 1) * BKV16, p.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == t0) {                // Q's A fragments, once
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        load_q_frag<LD>(qf[kk], Qs, warp, g, t, kk);
    }
    const __nv_bfloat16* Kst = Ks + stage * BKV16 * LD;
    const __nv_bfloat16* Vst = Vs + stage * BKV16 * LD;
    const int k0 = kt * BKV16;

    // S = Q K^T, 16 x 64 for this warp, fp32.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kst + j * 8 * LD + kk * 16 + k_lane));
        mma_bf16(s[j], qf[kk], bk[0], bk[1]);
        mma_bf16(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Scale, mask, running max over the quad (the row's four threads).
    // Only tiles that cross the causal diagonal, the window's edge or the
    // ragged end need the per-element mask; the rest are valid whole.
    const bool need_mask = k0 + BKV16 > p.Skv
        || (p.causal && k0 + BKV16 - 1 > q0 + off)
        || (p.window && k0 <= q0 + BQ16 - 1 + off - p.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      if (need_mask) {
        const int kpos = k0 + j * 8 + 2 * t;
        s[j][0] = masked_logit(p, s[j][0], qpos0, kpos);
        s[j][1] = masked_logit(p, s[j][1], qpos0, kpos + 1);
        s[j][2] = masked_logit(p, s[j][2], qpos1, kpos);
        s[j][3] = masked_logit(p, s[j][3], qpos1, kpos + 1);
      } else {
        s[j][0] *= p.scale;
        s[j][1] *= p.scale;
        s[j][2] *= p.scale;
        s[j][3] *= p.scale;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + sum0;        // this thread's share of the row sum
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P V: P (cast to bf16, v's dtype) from the S registers as A;
    // V's B fragments by transposing loads of the row-major tile.
#pragma unroll
    for (int kk = 0; kk < BKV16 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(Vst + kk * 16 * LD + n * 8
                                        + v_lane));
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();               // this stage is free for the next load
  }

  // The row sums over the quad, then out = acc / max(l, 1e-30) as bf16.
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0]
      + h * p.os[2];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row0 * p.os[1] + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row1 * p.os[1] + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}


// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

constexpr int BQ32 = 32;       // query rows per block, 4 threads a row
constexpr int BKV32 = 32;      // keys per tile
constexpr int THREADS32 = 128;

template <int D>
__global__ void __launch_bounds__(THREADS32)
flash_fwd_f32(Params p) {
  constexpr int LD = D + 1;      // Qs, Ks: [rows][LD], conflict-free columns
  constexpr int PER = D / 4;     // output dims per thread: c, c + 4, ...
  constexpr int KPT = BKV32 / 4; // keys per thread per tile: c, c + 4, ...
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Vs = reinterpret_cast<float*>(smem_raw);  // [BKV32][D]
  float* Qs = Vs + BKV32 * D;
  float* Ks = Qs + BQ32 * LD;
  float* Ps = Ks + BKV32 * LD;                     // [BQ32][BKV32 + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * BQ32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0]
      + h * p.qs[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0]
      + hk * p.ks[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0]
      + hk * p.vs[2];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int CH = D / 4;      // 16-byte chunks per row

  for (int i = tid; i < BQ32 * CH; i += THREADS32) {
    const int rr = i / CH, c4 = i % CH;
    const int qi = q0 + rr;
    const float4 val = qi < p.Sq
        ? *reinterpret_cast<const float4*>(qg + qi * p.qs[1] + c4 * 4) : zero;
    float* dst = Qs + rr * LD + c4 * 4;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }

  const int qpos = q0 + r + (p.Skv - p.Sq);
  float m = MASKED, l = 0.f;
  float o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;

  int t0, t1;
  key_tiles(p, q0, BQ32, BKV32, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * BKV32;
    __syncthreads();
    for (int i = tid; i < BKV32 * CH; i += THREADS32) {
      const int rr = i / CH, c4 = i % CH;
      const int kj = k0 + rr;
      const bool in = kj < p.Skv;
      const float4 kv = in ? *reinterpret_cast<const float4*>(
          kg + kj * p.ks[1] + c4 * 4) : zero;
      const float4 vv = in ? *reinterpret_cast<const float4*>(
          vg + kj * p.vs[1] + c4 * 4) : zero;
      float* dk = Ks + rr * LD + c4 * 4;
      dk[0] = kv.x; dk[1] = kv.y; dk[2] = kv.z; dk[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + rr * D + c4 * 4) = vv;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        s[j] = fmaf(qd, Ks[(c + 4 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = masked_logit(p, s[j], qpos, k0 + c + 4 * j);
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = expf(s[j] - m);
      sum += s[j];
      Ps[r * (BKV32 + 1) + c + 4 * j] = s[j];
    }
    l = l * corr + sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) o[i] *= corr;
    __syncwarp();                  // the row's four threads share Ps[r]
    for (int j = 0; j < BKV32; ++j) {
      const float pj = Ps[r * (BKV32 + 1) + j];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        o[i] = fmaf(pj, Vs[j * D + c + 4 * i], o[i]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int row = q0 + r;
  if (row < p.Sq) {
    float* og = static_cast<float*>(p.o) + b * p.os[0] + row * p.os[1]
        + h * p.os[2];
#pragma unroll
    for (int i = 0; i < PER; ++i) og[c + 4 * i] = o[i] * inv;
  }
}


// ---------------------------------------------------------------------------
// bf16 at d 64, 128, 256: TMA, mbarriers, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;         // query rows per block: two warpgroups of 64
constexpr int WG_THREADS = 384;    // consumer warpgroups 0 and 1, producer 2
constexpr int BOX = 64;            // bf16 columns per TMA box: 128 bytes
constexpr int PRODUCER_REGS = 24;   // 128 x 24 + 256 x 240 <= 65,536
constexpr int CONSUMER_REGS = 240;

// Keys per tile: 128 up to d 128; 64 at d 256, where the output
// accumulator already takes 128 registers a thread. Two K/V stages: a
// third (which fits up to d 128) ran no faster.
template <int D> struct WgTile {
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;   // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES
      + 16 * 8 + 1024;                           // barriers, alignment
};

// One TMA box [rows][64] of a [B, S, heads, d] tensor, at column c0, row
// s0 of head h, batch b, into shared memory (128-byte swizzle); the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(s0), "r"(h), "r"(b)
      : "memory");
}

// The two consumer warpgroups' turns: 256 threads meet on barrier `id`
// (0 is __syncthreads'); a warpgroup waits with sync and signals the
// other with arrive.
template <int ID>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, 256;\n" :: "n"(ID) : "memory");
}

template <int ID>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, 256;\n" :: "n"(ID) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One logit after scaling to log2 units and masking (the -1e30 and -inf
// stay as they are: exp2 of either minus the running max is what exp of
// the unscaled one is).
__device__ __forceinline__ float masked_logit2(const Params& p, float dot,
                                               int qpos, int kpos) {
  if (kpos >= p.Skv) return -INFINITY;  // past the ragged end: absent
  if (p.causal && kpos > qpos) return MASKED;
  if (p.window && kpos <= qpos - p.window) return MASKED;
  return dot * p.scale_log2;
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
// (descriptors), both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory
// (descriptors), both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the
// mma.sync A fragment of each warp's 16 rows), B from shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, Params p) {
  using Tile = WgTile<D>;
  constexpr int BKV = Tile::BKV;
  constexpr int STAGES = Tile::STAGES;
  constexpr int ATOMS = D / BOX;           // 64-column boxes per row
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms must sit on 1024-byte boundaries.
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;
  const uint32_t Ks = Qs + Tile::Q_BYTES;            // [stage]
  const uint32_t Vs = Ks + STAGES * Tile::KV_BYTES;  // [stage]
  const uint32_t bars = Vs + STAGES * Tile::KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, v_full = bars + 8 * (1 + STAGES);
  const uint32_t k_empty = bars + 8 * (1 + 2 * STAGES);
  const uint32_t v_empty = bars + 8 * (1 + 3 * STAGES);

  // Heaviest causal query tiles first: the grid's slowest index runs the
  // query tiles from the last to the first.
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_BQ;
  const int hk = h / p.group;
  int t0, t1;
  key_tiles(p, q0, WG_BQ, BKV, &t0, &t1);
  const int n = t1 - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every load; the warpgroup keeps few
    // registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect(q_full, Tile::Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load(Qs + a * WG_BQ * 128, &tq, q_full, a * BOX, q0, h, b);
      // Key tiles from the last to the first: the tiles that the causal
      // diagonal cuts come first.
      for (int it = 0; it < n; ++it) {
        const int kt = t1 - 1 - it, s = it % STAGES;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect(k_full + 8 * s, Tile::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load(Ks + s * Tile::KV_BYTES + a * BKV * 128, &tk,
                   k_full + 8 * s, a * BOX, kt * BKV, hk, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect(v_full + 8 * s, Tile::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load(Vs + s * Tile::KV_BYTES + a * BKV * 128, &tv,
                   v_full + 8 * s, a * BOX, kt * BKV, hk, b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63. Thread tid
    // holds rows 16 warp + g and + 8 of them (the wgmma accumulator
    // layout), columns 8 j + 2 t, + 1 of every 8-column block j.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int off = p.Skv - p.Sq;
    const int qw = q0 + wg * 64;                   // this warpgroup's rows
    const int qpos0 = qw + warp * 16 + g + off, qpos1 = qpos0 + 8;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
    float o[ATOMS][32];
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;

    uint32_t pa[BKV / 16][4];     // P (bf16) of the tile whose PV is next
    float corr0 = 1.f, corr1 = 1.f;

    // S = Q K^T of key tile `it`: both K-major in shared memory; a
    // 16-column k-step moves 32 bytes inside a swizzle atom, four a box.
    // Descriptors are a base plus a compile-time offset (in 16-byte units
    // of the address field, which no offset here carries out of).
    const uint64_t q_desc = smem_desc(Qs + wg * 64 * 128, 16, 1024);
    auto issue_qk = [&](int it) {
      const uint64_t k_desc = smem_desc(
          Ks + (it % STAGES) * Tile::KV_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = q_desc + (((kk / 4) * WG_BQ * 128 + col) >> 4);
        const uint64_t db = k_desc + (((kk / 4) * BKV * 128 + col) >> 4);
        if constexpr (BKV == 128) wgmma_ss_n128(s, da, db, kk > 0);
        else wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of key tile `it`: V as it lies in memory, [keys][d],
    // MN-major through the transpose bit; a 16-key k-step is two swizzle
    // atoms (2048 bytes), one 64-column box per product.
    auto issue_pv = [&](int it) {
      const uint64_t v_desc = smem_desc(
          Vs + (it % STAGES) * Tile::KV_BYTES, BKV * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          wgmma_rs_n64(o[a], pa[kk],
                       v_desc + ((a * BKV * 128 + kk * 2048) >> 4));
      wgmma_commit();
    };
    // The online softmax of key tile `it`'s S, in place: the running max
    // over the quad (the row's four threads), corr, l, and p left in s;
    // m is in log2 units. A tile that crosses the causal diagonal, the
    // window's edge or the ragged end is scaled and masked element by
    // element first and takes p = exp2(s - m), so a row whose logits so
    // far are all -1e30 gets p = exp2(0) = 1 exactly, as the reference's
    // does. Any other tile holds only valid logits, so its row max is
    // finite and p = exp2(s * scale - m) is one fused multiply-add.
    auto softmax = [&](int it) {
      const int k0 = (t1 - 1 - it) * BKV;
      const bool need_mask = k0 + BKV > p.Skv
          || (p.causal && k0 + BKV - 1 > qw + off)
          || (p.window && k0 <= qw + 63 + off - p.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          const int kpos = k0 + j * 8 + 2 * t;
          s[4 * j] = masked_logit2(p, s[4 * j], qpos0, kpos);
          s[4 * j + 1] = masked_logit2(p, s[4 * j + 1], qpos0, kpos + 1);
          s[4 * j + 2] = masked_logit2(p, s[4 * j + 2], qpos1, kpos);
          s[4 * j + 3] = masked_logit2(p, s[4 * j + 3], qpos1, kpos + 1);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      if (!need_mask) {            // the max of raw logits, scaled once
        mx0 *= p.scale_log2;
        mx1 *= p.scale_log2;
      }
      mx0 = fmaxf(m0, mx0);
      mx1 = fmaxf(m1, mx1);
      corr0 = fast_exp2(m0 - mx0);
      corr1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          s[4 * j] = fast_exp2(s[4 * j] - m0);
          s[4 * j + 1] = fast_exp2(s[4 * j + 1] - m0);
          s[4 * j + 2] = fast_exp2(s[4 * j + 2] - m1);
          s[4 * j + 3] = fast_exp2(s[4 * j + 3] - m1);
        }
      } else {
        const float sc = p.scale_log2;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          s[4 * j] = fast_exp2(fmaf(s[4 * j], sc, -m0));
          s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sc, -m0));
          s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sc, -m1));
          s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sc, -m1));
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * corr0 + sum0;        // this thread's share of the row sum
      l1 = l1 * corr1 + sum1;
    };
    // P cast to bf16 (v's dtype) as the A operand of PV: k-step kk takes
    // the S blocks 2 kk and 2 kk + 1 (the accumulator and A fragment
    // layouts line up).
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    // O, rescaled to the newest running max before the next PV.
    auto rescale_o = [&]() {
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          o[a][i] *= corr0;
          o[a][i + 1] *= corr0;
          o[a][i + 2] *= corr1;
          o[a][i + 3] *= corr1;
        }
    };
    // The registers a product reads or accumulates into are settled
    // before wgmma.fence and after the wait, so no other instruction
    // defines them while it runs.
    auto fence_pv = [&]() {
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
      fence_regs(pa);
    };
    // The two warpgroups take turns issuing products (named barriers 1
    // and 2, warpgroup 0 first), so one's softmax runs under the other's
    // products. Warpgroup 1 skips its last signal, so every barrier ends
    // with as many arrivals as waits.
    auto turn_begin = [&]() {
      if (wg == 0) named_sync<1>();
      else named_sync<2>();
    };
    auto turn_end = [&](bool last) {
      if (wg == 0) named_arrive<2>();
      else if (!last) named_arrive<1>();
    };

    if (wg == 1) named_arrive<1>();
    mbar_wait(q_full, 0);
    // Key tile 0: QK^T and its softmax.
    mbar_wait(k_full, 0);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    issue_qk(0);
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty);
    softmax(0);
    pack_p();
    // Tile it's QK^T goes out with tile it - 1's PV, so tile it's
    // softmax runs while PV of tile it - 1 is on the tensor cores.
    for (int it = 1; it < n; ++it) {
      const int st = it % STAGES, pst = (it - 1) % STAGES;
      mbar_wait(k_full + 8 * st, (it / STAGES) & 1);
      turn_begin();
      fence_regs(s);
      wgmma_fence();
      issue_qk(it);
      rescale_o();
      mbar_wait(v_full + 8 * pst, ((it - 1) / STAGES) & 1);
      fence_pv();
      wgmma_fence();
      issue_pv(it - 1);
      turn_end(false);
      wgmma_wait<1>();             // QK^T done; PV still running
      fence_regs(s);
      mbar_arrive(k_empty + 8 * st);
      softmax(it);
      wgmma_wait<0>();
      fence_pv();
      mbar_arrive(v_empty + 8 * pst);
      pack_p();
    }
    // The last tile's PV.
    const int lst = (n - 1) % STAGES;
    mbar_wait(v_full + 8 * lst, ((n - 1) / STAGES) & 1);
    turn_begin();
    rescale_o();
    fence_pv();
    wgmma_fence();
    issue_pv(n - 1);
    turn_end(true);
    wgmma_wait<0>();
    fence_pv();
    mbar_arrive(v_empty + 8 * lst);

    // The row sums over the quad, then out = acc / max(l, 1e-30) as bf16.
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int row0 = qw + warp * 16 + g, row1 = row0 + 8;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0]
        + h * p.os[2];
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * BOX + j * 8 + 2 * t;
        if (row0 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + row0 * p.os[1] + col) =
              pack_bf16(o[a][4 * j] * inv0, o[a][4 * j + 1] * inv0);
        if (row1 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + row1 * p.os[1] + col) =
              pack_bf16(o[a][4 * j + 2] * inv1, o[a][4 * j + 3] * inv1);
      }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int rows, size_t smem,
                   const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows - 1) / rows, p.H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// A tensor map over a bf16 [B, S, heads, d] tensor with element strides
// st (batch, sequence, head), d contiguous, read in boxes of 64 columns x
// `rows` rows, 128-byte swizzled; rows past S read as zero.
bool tensor_map(CUtensorMap* map, const void* base, const long long* st,
                int B, int S, int heads, int d, int rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int B, int KV,
                         cudaStream_t stream) {
  using Tile = WgTile<D>;
  const int nq = (p.Sq + WG_BQ - 1) / WG_BQ;
  if (B > 65535 || nq > 65535) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = bind_device_context(&dev);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.qs, B, p.Sq, p.H, D, WG_BQ)
      || !tensor_map(&tk, p.k, p.ks, B, p.Skv, KV, D, Tile::BKV)
      || !tensor_map(&tv, p.v, p.vs, B, p.Skv, KV, D, Tile::BKV))
    return cudaErrorInvalidValue;
  err = set_smem(flash_fwd_wgmma<D>, Tile::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B, nq);
  flash_fwd_wgmma<D><<<grid, WG_THREADS, Tile::SMEM, stream>>>(tq, tk, tv,
                                                               p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float)
      * ((size_t)BKV32 * D + (size_t)(BQ32 + BKV32) * (D + 1)
         + (size_t)BQ32 * (BKV32 + 1));
  return launch(flash_fwd_f32<D>, THREADS32, BQ32, smem, p, B, stream);
}

template <int D>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16)
      * (size_t)(BQ16 + 2 * STAGES16 * BKV16) * (D + PAD16);
  return launch(flash_fwd_bf16<D>, WARPS16 * 32, BQ16, smem, p, B, stream);
}

}  // namespace

// q [B, Sq, H, d], k/v [B, Skv, KV, d], o [B, Sq, H, d], all bf16 (bf16 = 1)
// or all fp32, d contiguous; `strides` holds the batch, sequence and head
// strides (in elements) of q, k, v and o, in that order. Every pointer and
// stride is 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int Sq, int Skv, int H, int KV, int d,
                                      int causal, int window, int bf16,
                                      cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.Sq = Sq; p.Skv = Skv; p.H = H; p.group = H / KV;
  p.causal = causal; p.window = window;
  p.scale = (float)(1.0 / sqrt((double)d));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  cudaError_t err;
  if (bf16) {
    switch (d) {
      case 16: err = launch_mma<16>(p, B, stream); break;
      case 32: err = launch_mma<32>(p, B, stream); break;
      case 64: err = launch_wgmma<64>(p, B, KV, stream); break;
      case 128: err = launch_wgmma<128>(p, B, KV, stream); break;
      case 256: err = launch_wgmma<256>(p, B, KV, stream); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 16: err = launch_f32<16>(p, B, stream); break;
      case 32: err = launch_f32<32>(p, B, stream); break;
      case 64: err = launch_f32<64>(p, B, stream); break;
      case 128: err = launch_f32<128>(p, B, stream); break;
      case 256: err = launch_f32<256>(p, B, stream); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
