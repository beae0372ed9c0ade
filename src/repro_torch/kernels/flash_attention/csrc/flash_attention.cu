// Blockwise (flash) softmax attention, forward, written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`): out[b, i, h] = softmax over the
// keys j of (q[b, i, h] . k[b, j, h'] / sqrt(d), masked) times v[b, j, h'],
// with an online softmax whose running max m, denominator l and accumulator
// stay in fp32. Causal (kpos <= qpos) and sliding-window
// (kpos > qpos - window) masks; query i sits at qpos = i + Skv - Sq.
// Grouped-query attention reads key/value head h' = h / (H / KV) in place:
// the same function as the reference's jnp.repeat of K/V over the heads,
// without materialising the repeat.
//
// Numerics, in the reference's order: logits = fp32 dot * (1/sqrt(d));
// masked logits = -1e30 and m starts at -1e30; p = expf(logits - m_new),
// corr = expf(m_prev - m_new), l = l * corr + sum(p); p is cast to v's
// dtype before the PV product; out = acc / max(l, 1e-30), cast to q's
// dtype. Keys past Skv (the ragged last tile) are not masked but absent:
// their logit is -inf, so p = 0 exactly. A key tile that the causal or
// window mask covers whole is skipped: had it run first, its p = 1 terms
// would be wiped by corr = expf(-1e30 - m) = 0 once the row's first valid
// key arrives (the diagonal always is one); had it run later, its p would
// be 0. The one case where a row has no valid key at all (causal with
// Sq > Skv, qpos < 0) is the case where a block skips nothing: such a row
// then averages every value, as the reference's does.
//
// Layout: q/k/v/o are [B, S, H, d] with d contiguous, read through their
// batch/sequence/head strides (no transposes on the host). Each block takes
// one (batch, head, query tile); the loop over key tiles runs inside it.
//
// Two kernels, each for head dims 16, 32, 64, 128 and 256:
//   * bf16: 4 warps, 64 query rows (16 a warp), 64-key tiles. QK^T and PV
//     are mma.sync m16n8k16 bf16 products with fp32 accumulation. K/V tiles
//     come in by cp.async into a two-stage ring in shared memory, the next
//     tile loading while the products run on this one. Up to d 128, Q's
//     fragments stay in registers for the whole loop; K's and V's come from
//     shared memory by ldmatrix (V's transposed by ldmatrix.trans, so V is
//     staged row-major as it lies in memory); S = QK^T stays in registers
//     and is repacked in place as the A operand of PV (the C and A fragment
//     layouts line up); the output accumulator (16 x d a warp) stays in
//     registers. Shared rows are padded by 16 bytes, so the 8-row ldmatrix
//     reads are free of bank conflicts.
//   * fp32: plain fp32 FMA (no TF32: the reference's tests hold fp32 to
//     2e-5), 32 query rows x 32-key tiles, 4 threads a row.
//
// Head dim 256 (RecurrentGemma-2B's local attention: 10 query heads on one
// KV head, window 2048). In bf16 a thread would hold 128 fp32 accumulator
// words, 64 words of Q fragments and 32 of S, about 224 of the 255
// registers a thread may have before any address: ptxas would spill. So at
// d 256 Q's fragments are not kept in registers but read from the Q tile,
// which sits in shared memory for the whole loop anyway, at every k-step
// of QK^T (four 32-bit loads, free of bank conflicts: the 8 rows of a
// fragment are 528 bytes apart, 4 banks). The key tile stays at 64 and the
// block's shared memory is (64 + 2 stages x 2 x 64) rows x 264 x 2 bytes =
// 168,960 bytes, under the 232,448 a block may opt into; one block an SM.
// The fp32 kernel needs 102,784 bytes at d 256 and keeps 64 accumulator
// words a thread. `chip_smoke.py` reports ptxas's registers and spill
// bytes for every instantiation.
//
// What bounds it on the H100 at the Yi-6B shape (B 2, S 2048, H 32, KV 4,
// d 128, bf16, causal): 6.9e10 multiply-adds x 2 against 75 MB of q/k/v/o,
// so the tensor cores' bf16 rate, not memory, is the limit. At the
// RecurrentGemma-2B shape (B 2, S 4096, H 10, KV 1, d 256, causal, window
// 2048) each (b, h) computes 6,292,480 query-key pairs: 1.29e11 FLOP,
// 0.130 ms at 989 TFLOP/s, again the tensor cores' rate. Tiles below the
// window's edge are skipped and tiles crossing it masked, so a block visits
// at most 33 key tiles. This kernel stays below that rate: mma.sync rather
// than wgmma (whose asynchronous 64-row products are the only way to the
// card's full rate), the softmax's exponentials and rescaling on the CUDA
// cores in the same warps as the products (nothing overlaps them), and
// 64-row query tiles that read each K/V tile once per 64 queries. A later
// design: TMA loads of K/V tiles into a deeper ring with mbarriers, wgmma
// for QK^T and PV, a producer warp and two consumer warpgroups that take
// turns between softmax and products (warp specialisation), and 128-row
// query tiles; at d 256 the accumulator then has to be split across two
// consumer warpgroups by output columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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
  float scale;
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
// bf16: mma.sync m16n8k16
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
  // Q's fragments in registers for the whole loop up to d 128; at d 256
  // they would spill, and come from the shared Q tile at every k-step.
  constexpr bool Q_IN_REGS = D <= 128;
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
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];

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
    if constexpr (Q_IN_REGS) {
      if (kt == t0) {              // Q's A fragments, once
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          load_q_frag<LD>(qf[kk], Qs, warp, g, t, kk);
      }
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
      uint32_t qa[4];
      if constexpr (Q_IN_REGS) {
        qa[0] = qf[kk][0];
        qa[1] = qf[kk][1];
        qa[2] = qf[kk][2];
        qa[3] = qf[kk][3];
      } else {
        load_q_frag<LD>(qa, Qs, warp, g, t, kk);
      }
#pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kst + j * 8 * LD + kk * 16 + k_lane));
        mma_bf16(s[j], qa, bk[0], bk[1]);
        mma_bf16(s[j + 1], qa, bk[2], bk[3]);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int rows, size_t smem,
                   const Params& p, int B, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.Sq + rows - 1) / rows, p.H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Params& p, int B, int bf16, cudaStream_t stream) {
  if (bf16) {
    const size_t smem = sizeof(__nv_bfloat16)
        * (size_t)(BQ16 + 2 * STAGES16 * BKV16) * (D + PAD16);
    return launch(flash_fwd_bf16<D>, WARPS16 * 32, BQ16, smem, p, B, stream);
  }
  const size_t smem = sizeof(float)
      * ((size_t)BKV32 * D + (size_t)(BQ32 + BKV32) * (D + 1)
         + (size_t)BQ32 * (BKV32 + 1));
  return launch(flash_fwd_f32<D>, THREADS32, BQ32, smem, p, B, stream);
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
  cudaError_t err;
  switch (d) {
    case 16: err = dispatch<16>(p, B, bf16, stream); break;
    case 32: err = dispatch<32>(p, B, bf16, stream); break;
    case 64: err = dispatch<64>(p, B, bf16, stream); break;
    case 128: err = dispatch<128>(p, B, bf16, stream); break;
    case 256: err = dispatch<256>(p, B, bf16, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
