// int8 GEMM with a fused integer epilogue, written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with plain C entry points, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/conv2d_int8/kernel.py::gemm_int8
// (Pallas body `_kernel`, pallas_call at :90): out[N, M] = epilogue(x[N, K]
// @ w[K, M]) with int32 accumulation, then + int32 bias[M], optional ReLU,
// and a per-column saturating signed shift (negative = left shift, capped
// at 16, clamped before the shift) clipped to [-128, qmax]: qmax is 127, or
// a ReLU6 engine's ceiling (6 on the output's po2 format, a runtime
// argument, so no kernel is instantiated twice for it). With emit_int32 the
// epilogue stops after bias/ReLU and writes the int32 values. With a
// residual (a bottleneck's skip: int8 res[N, M], any row stride, and an
// int32 res_shift[M]) the skip, aligned onto each column's accumulator
// format, is added before the ReLU; every kernel is instantiated with and
// without it (the RES template flag), so a call with no residual runs the
// code it ran before the residual existed.
//
// What bounds it on the H100: the fc layers at N = 16 rows are bound by
// the weight bytes they must read (fc6 reads 37.7 MB for 0.6 G
// multiply-adds); AlexNet's convs at batch 16 are bound by bytes too, at
// the tensor cores' int8 rate; VGG16's conv4_x and conv5_x are bound by
// operations. Only wgmma reaches the int8 rate, so the main path runs on
// it; the CUDA cores' __dp4a reach a few percent of it.
//
// Three kernels, picked by the wrapper (kernel.py) from N and the layout:
//   * `gemm_wgmma<W, G, 1, false>`, large N (the fc layers at large
//     batches, and the convs that the implicit form below cannot take:
//     patches built by im2col outside the kernel): a block takes
//     64 G rows of x by W output channels: 128-row tiles (G = 2) W = 64,
//     96 or 128 wide (wgmma s8 widths, so M = 96 and 128 fit one tile,
//     384 three; wider tiles are not built), or 64 x 64 tiles (G = 1)
//     where the larger ones would leave SMs idle.
//     wgmma takes s8 operands only K-major from shared memory, so x
//     [N, K] is A as it lies, and the weights come K-major: [M, K] rows,
//     made once at lowering (core/program.py), passed as a [K, M] view
//     whose stride along K is 1. One producer thread brings 128-byte K
//     stages of both by TMA (2-D tensor maps encoded at each launch,
//     128-byte swizzle; TMA zero-fills past N, M and K, so K needs no
//     padding in content, only rows whose byte stride is a multiple of 16)
//     into a ring of full/empty mbarriers; G consumer warpgroups of 64
//     rows run wgmma.m64nWk32.s32.s8.s8 on each stage as it lands, keeping
//     one group of products in flight, and release the stage behind it.
//     With G = 2 (one block an SM) the producer's warpgroup gives up
//     registers (setmaxnreg.dec) and the consumers take them
//     (setmaxnreg.inc); with G = 1 two blocks share an SM. int8 output
//     rows of a multiple of 16 bytes are staged in shared memory and
//     stored a whole row at a time in 16-byte pieces.
//   * the same kernel as an implicit-GEMM conv (`gemm_wgmma<W, G, 1,
//     false, RES, A_IM2COL*>`, launched by gemm_int8_conv_launch): A, the
//     patches, is read straight from the conv's int8 NHWC input by TMA's
//     im2col mode, so no patch matrix is written to device memory. The
//     map covers one channel group (base at its first channel, Cg
//     channels, pixels C bytes apart); the conv's padding is the map's
//     box corners (TMA fills zeros there) and its stride the traversal
//     stride. A load brings the 64 G output pixels of a tile, in A's row
//     order (image, row, column), at one filter tap (r, s): the load's
//     im2col offsets. K stays ordered (r, s, c), so the K-major weights
//     and their 2-D map are unchanged. A 128-byte stage is one tap's box
//     where Cg is a multiple of 128, else two 64-byte boxes (64-byte
//     swizzle, which the A descriptors follow).
//   * `gemm_wgmma<W, 1, 2, true>`, small N (N <= 64: the fc layers at a
//     batch of 16): the operands swap, out^T[M, N] = w_k[M, K] . x[N, K]^T,
//     so the weights are wgmma's 64-row A and x's rows its width W (16, 32
//     or 64; rows past N arrive as zeros). A stage brings two 128-byte K
//     boxes (256 bytes of each weight row). The output tile is transposed
//     on the store.
//   * `gemm_int8_kernel` (__dp4a, 64 x 64 tiles, 64-deep stages loaded by
//     the compute threads, the ragged edges masked by hand) stays for the
//     operands TMA cannot take: bases or row strides off 16 bytes, a
//     row-major w passed directly by a caller, K = 0. The main paths never
//     take it.
// The wrapper picks the kernel's width and G from the shape (kernel.py::
// plan_for); chip_smoke.py times every wgmma tiling built here at every
// AlexNet and VGG16 batch-16 shape (its `gemm_int8_tilings` lines).
//
// The epilogue's math (bias add wrapping as uint32, ReLU, `requantize`) is
// the same code in every kernel. No product uses .satfinite: |x w| summed
// over K < 2^17 stays below 2^31, and the bias add then wraps as the plain
// version's int32 add does.
//
// What remains: the convs whose group width is not a multiple of 64
// bytes (the 3-channel stems, AlexNet's conv2) still take patches made
// outside the kernel; one launch per channel group; no persistent
// scheduler (a tile's epilogue does not overlap the next tile's loads);
// the output is stored from registers, not through shared memory and TMA.

#include <limits.h>

#include <atomic>

#include "../../csrc/hopper.cuh"   // mbarriers, wgmma fences, tensor maps
#include "wgmma_s8.cuh"

namespace {

// ---------------------------------------------------------------------------
// The epilogue, shared by every kernel
// ---------------------------------------------------------------------------

// The Fig. 3(c) output stage: saturating signed shift, clip onto
// [-128, hi] (hi: 127, or a ReLU6 engine's ceiling; the shift is monotone
// and exact on the ceiling, so clipping before or after it is the same).
__device__ __forceinline__ int8_t requantize(int v, int sh, int hi) {
  int y;
  if (sh >= 0) {
    y = v >> (sh < 31 ? sh : 31);
  } else {
    const int sl = sh < -16 ? 16 : -sh;
    const int lo = INT_MIN >> sl;
    const int hi = INT_MAX >> sl;
    const int c = v < lo ? lo : (v > hi ? hi : v);
    y = (int)((unsigned)c << sl);
  }
  return (int8_t)(y < -128 ? -128 : (y > hi ? hi : y));
}

// Accumulator + bias (wrapping as the int32 add does), then ReLU.
__device__ __forceinline__ int bias_relu(int acc, unsigned bias, int relu) {
  const int v = (int)((unsigned)acc + bias);
  return relu && v < 0 ? 0 : v;
}

// Accumulator + the int8 skip s aligned onto its format, wrapping as the
// int32 add does: an arithmetic right shift by rs >= 0 (at most 31), an
// exact left shift by -rs (at most 24) for rs < 0.
__device__ __forceinline__ int add_skip(int acc, int s, int rs) {
  const int a = rs >= 0 ? s >> (rs < 31 ? rs : 31)
                        : (int)((unsigned)s << (rs < -24 ? 24 : -rs));
  return (int)((unsigned)acc + (unsigned)a);
}

// ---------------------------------------------------------------------------
// __dp4a: the operands TMA cannot take
// ---------------------------------------------------------------------------

constexpr int BN = 64;        // output rows (rows of x) per block
constexpr int BM = 64;        // output columns (columns of w) per block
constexpr int BKQ = 64;       // reduction depth per shared-memory stage
constexpr int KQ = BKQ / 4;   // packed 4-byte quads per stage
constexpr int PAD = 4;        // shared rows stay 16-byte aligned
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ int pack_bytes(unsigned b0, unsigned b1,
                                          unsigned b2, unsigned b3) {
  return (int)((b0 & 0xffu) | ((b1 & 0xffu) << 8) | ((b2 & 0xffu) << 16) |
               ((b3 & 0xffu) << 24));
}

// x[n, k .. k+3] packed (byte j = x[n, k+j]); zero outside [0, N) x [0, K).
__device__ __forceinline__ int load_x_quad(const int8_t* __restrict__ x,
                                           long long ldx, int n, int k,
                                           int N, int K, bool vec) {
  if (n >= N) return 0;
  const int8_t* p = x + (long long)n * ldx + k;
  if (vec && k + 3 < K) return *reinterpret_cast<const int*>(p);
  unsigned b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = (k + j < K) ? (unsigned)(int)p[j] : 0u;
  return pack_bytes(b[0], b[1], b[2], b[3]);
}

// w[k, m .. m+3] packed (byte j = w[k, m+j]), w[k, m] at k swk + m swm;
// zero outside [0, K) x [0, M).
__device__ __forceinline__ unsigned load_w_word(const int8_t* __restrict__ w,
                                                long long swk, long long swm,
                                                int k, int m, int K, int M,
                                                bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = w + (long long)k * swk + (long long)m * swm;
  if (vec && m + 3 < M) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (m + j < M) v |= ((unsigned)(int)p[j * swm] & 0xffu) << (8 * j);
  return v;
}

template <bool RES>
__global__ void __launch_bounds__(THREADS)
gemm_int8_kernel(const int8_t* __restrict__ x, long long ldx,
                 const int8_t* __restrict__ w, long long swk, long long swm,
                 const int32_t* __restrict__ shift,
                 const int32_t* __restrict__ bias, void* __restrict__ out,
                 int N, int K, int M, int relu, int emit_int32, int qmax,
                 int vec_x, int vec_w, const int8_t* __restrict__ res,
                 long long ldr,
                 const int32_t* __restrict__ res_shift) {
  __shared__ __align__(16) int xs[KQ][BN + PAD];  // xs[q][n]: x[n, 4q..4q+3]
  __shared__ __align__(16) int ws[KQ][BM + PAD];  // ws[q][m]: w[4q..4q+3, m]

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // output columns tx*4 .. tx*4+3
  const int ty = tid >> 4;           // output rows ty*4 .. ty*4+3
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.x * BM;
  const int xr = tid >> 2;           // loads x row xr, quads xq .. xq+3
  const int xq = (tid & 3) * 4;
  const int wq = tid >> 4;           // loads w quad wq, columns wc .. wc+3
  const int wc = (tid & 15) * 4;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BKQ) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xs[xq + i][xr] =
          load_x_quad(x, ldx, n0 + xr, k0 + 4 * (xq + i), N, K, vec_x);
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = load_w_word(w, swk, swm, k0 + 4 * wq + i, m0 + wc, K, M,
                         vec_w);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ws[wq][wc + j] = pack_bytes(r[0] >> (8 * j), r[1] >> (8 * j),
                                  r[2] >> (8 * j), r[3] >> (8 * j));
    __syncthreads();

#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int4 a = *reinterpret_cast<const int4*>(&xs[q][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&ws[q][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx * 4 + j;
      if (m >= M) continue;
      int a = acc[i][j];
      if constexpr (RES)
        a = add_skip(a, res[(long long)n * ldr + m], res_shift[m]);
      const int v = bias_relu(a, bias ? (unsigned)bias[m] : 0u, relu);
      const long long o = (long long)n * M + m;
      if (emit_int32)
        static_cast<int32_t*>(out)[o] = v;
      else
        static_cast<int8_t*>(out)[o] = requantize(v, shift[m], qmax);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: TMA, mbarriers, warp specialisation
// ---------------------------------------------------------------------------

constexpr int BK = 128;             // K bytes a TMA box: one swizzled row
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int MAX_DEVICES = 64;

// A block of G consumer warpgroups (A tile: 64 G rows) and one producer
// warpgroup, sized so that B blocks fit on an SM; a stage holds KB boxes
// of 128 K bytes of each operand, and the ring takes what shared memory
// allows up to MAX_STAGES. With G = 2 (one block an SM) the consumers
// take the registers the producer gives up; with G = 1 (two blocks an
// SM) every thread keeps the 128 the launch bound gives it.
template <int W, int G, int KB>
struct WgTile {
  static constexpr int B = G == 1 ? 2 : 1;           // blocks an SM
  static constexpr int THREADS = (G + 1) * 128;
  static constexpr int CONSUMERS = G * 128;
  static constexpr int ROWS = 64 * G;                 // A rows per tile
  static constexpr int A_BOX = ROWS * BK;             // one box of A
  static constexpr int B_BOX = W * BK;
  static constexpr int A_BYTES = KB * A_BOX;          // a stage's A, then B
  static constexpr int STAGE = KB * (A_BOX + B_BOX);  // multiple of 1024
  static constexpr int BUDGET = B == 1 ? 200 * 1024 : 100 * 1024;
  static constexpr int STAGES =
      BUDGET / STAGE < MAX_STAGES ? BUDGET / STAGE : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment
  static constexpr int START_REGS = (65536 / (THREADS * B)) & ~7;
  static constexpr int CONSUMER_REGS =
      (START_REGS + (START_REGS - PRODUCER_REGS) / 2) & ~7;   // G = 2
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(W <= 128, "wider tiles are not built");
  static_assert(G == 1 || CONSUMER_REGS <= 256, "setmaxnreg's limit");
};

// How the producer brings A (gemm_wgmma's AM).
enum AMode : int {
  A_TILED = 0,     // a 2-D map over an int8 [rows, K] matrix
  A_IM2COL = 1,    // a conv's patches by im2col: one 128-byte box a stage
  A_IM2COL64 = 2,  // the same in two 64-byte boxes a stage
};

// A conv's geometry, for the im2col loads.
struct ConvGeom {
  int cg;           // the group's channels: K = R S cg, ordered (r, s, c)
  int s, rs;        // the filter's width S, and R S
  int hw, wo;       // output pixels an image, and a row
  int stride;       // both spatial dims
  int pad_t, pad_l;
};

struct WgParams {
  const int32_t* shift;
  const int32_t* bias;      // or null
  const int8_t* res;        // [N, M] int8 skip, row stride ldr (RES only)
  long long ldr;
  const int32_t* res_shift; // [M] (RES only)
  void* out;                // [N, M] int8, or int32 with emit_int32
  int rows_a, rows_b;       // A's and B's rows: N and M, or M and N swapped
  int M;                    // the output's row length
  int k_iters;              // stages of KB BK over K
  int relu, emit_int32;
  int qmax;                 // the clip's upper bound: 127, or ReLU6's
  ConvGeom conv;            // AM != A_TILED only
};

// One TMA box [rows][128 bytes] of a 2-D int8 tensor, at byte column k of
// row r, into shared memory (128-byte swizzle); the barrier counts its
// bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(r)
      : "memory");
}

// One im2col box of a 4-D [b, h, w, c] map into shared memory: `rows`
// pixels (the map's) of the box's channels from channel c, the first at
// input (h, w) of image b, the traversal's start, each read at filter tap
// (r, s); the barrier counts its bytes.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int b, int s, int r) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
         "r"(w), "r"(h), "r"(b), "h"((unsigned short)s),
         "h"((unsigned short)r)
      : "memory");
}

// The consumer threads (and only they) meet on barrier 1.
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

template <int W, int G, int KB, bool SWAP, bool RES, int AM>
__global__ void __launch_bounds__((G + 1) * 128, (WgTile<W, G, KB>::B))
gemm_wgmma(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb, const WgParams p) {
  using T = WgTile<W, G, KB>;
  constexpr int REGS = W / 2;
  // A's boxes: BOXES a 128-byte K stage, rows of A_ROW bytes swizzled in
  // A_ROW, A_SUB bytes a box.
  constexpr int BOXES = AM == A_IM2COL64 ? 2 : 1;
  constexpr int A_ROW = BK / BOXES;
  constexpr int A_SUB = T::ROWS * A_ROW;
  static_assert(AM == A_TILED || (KB == 1 && !SWAP),
                "im2col feeds the large-N kernel's A");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * T::STAGES];
  // Swizzle atoms must sit on 1024-byte boundaries.
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = smem_addr(bars), empty = full + 8 * T::STAGES;

  const int a0 = blockIdx.y * T::ROWS, b0 = blockIdx.x * W;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G) {
    // Producer: one thread issues every load.
    if constexpr (G == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(PRODUCER_REGS));
    if (threadIdx.x == G * 128) {
      // im2col: the tile's first output pixel (image img, row ho, column
      // wo) and the input pixel its filter's top-left tap reads, where the
      // traversal starts; it walks the output pixels in A's row order,
      // across rows and images.
      int img = 0, h = 0, w = 0;
      if constexpr (AM != A_TILED) {
        img = a0 / p.conv.hw;
        const int q = a0 - img * p.conv.hw, ho = q / p.conv.wo;
        h = ho * p.conv.stride - p.conv.pad_t;
        w = (q - ho * p.conv.wo) * p.conv.stride - p.conv.pad_l;
      }
      for (int it = 0; it < p.k_iters; ++it) {
        const int s = it % T::STAGES;
        mbar_wait(empty + 8 * s, ((it / T::STAGES) & 1) ^ 1);
        mbar_expect(full + 8 * s, T::STAGE);
        const uint32_t dst = ring + s * T::STAGE;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int k = (it * KB + kb) * BK;
          if constexpr (AM == A_TILED) {
            tma_load(dst + kb * T::A_BOX, &ta, full + 8 * s, k, a0);
          } else {
#pragma unroll
            for (int j = 0; j < BOXES; ++j) {
              // The box's tap and first channel; a box past K (the last
              // of an odd count of 64-byte boxes) reads tap 0, which
              // meets B's zeros there.
              int tap = (k + j * A_ROW) / p.conv.cg;
              int c = k + j * A_ROW - tap * p.conv.cg;
              if (tap >= p.conv.rs) tap = c = 0;
              const int r = tap / p.conv.s;
              tma_load_im2col(dst + kb * T::A_BOX + j * A_SUB, &ta,
                              full + 8 * s, c, w, h, img, tap - r * p.conv.s,
                              r);
            }
          }
          tma_load(dst + T::A_BYTES + kb * T::B_BOX, &tb, full + 8 * s, k,
                   b0);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: A rows a0 + 64 wg .. + 63 against all W rows
    // of the B tile.
    if constexpr (G == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x;                 // 0 .. CONSUMERS - 1
    int acc[REGS];
#pragma unroll
    for (int i = 0; i < REGS; ++i) acc[i] = 0;
    // Descriptors are a base plus offsets in 16-byte units: the stage, the
    // box, and 32 bytes a k-step inside the swizzled row (A's 64-byte
    // boxes: the second two k-steps in the stage's second box).
    const uint64_t da = smem_desc(ring + wg * 64 * A_ROW, 16, 8 * A_ROW,
                                  A_ROW);
    const uint64_t db = smem_desc(ring + T::A_BYTES, 16, 1024);
    fence_regs(acc);
    for (int it = 0; it < p.k_iters; ++it) {
      const int s = it % T::STAGES;
      mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
      const uint64_t off = (uint64_t)((s * T::STAGE) >> 4);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<W>(acc,
                      da + off + ((kb * T::A_BOX + 32 * kk / A_ROW * A_SUB
                                   + 32 * kk % A_ROW) >> 4),
                      db + off + ((kb * T::B_BOX) >> 4) + 2 * kk);
      wgmma_commit();
      // The previous stage's products are done: hand its slot back.
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // The epilogue on the registers. Thread tid holds A rows r0 and r0 + 8
    // and, in every 8-column block j, B rows c0 + 8 j and + 1.
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = a0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = b0 + 2 * (lane % 4);
    if constexpr (!SWAP) {
      // A rows are output rows n, B rows output channels m. int8 rows of a
      // multiple of 16 bytes go out through shared memory (the ring is
      // free once every consumer's products are done): each thread puts
      // its pairs in the tile, then the warpgroup stores whole rows in
      // 16-byte pieces. Other outputs go straight from the registers.
      const bool staged = !p.emit_int32 && p.M % 16 == 0;
      if (staged) consumers_sync<T::CONSUMERS>();
      constexpr int LD = W + 16;                   // staged row, bytes
      unsigned char* tile = smem_raw + (ring - smem_addr(smem_raw))
          + wg * 64 * LD;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int m = c0 + 8 * j;
        if (m >= p.M) continue;
        const bool two = m + 1 < p.M;
        const unsigned bz0 = p.bias ? (unsigned)p.bias[m] : 0u;
        const unsigned bz1 = p.bias && two ? (unsigned)p.bias[m + 1] : 0u;
        const int sh0 = p.emit_int32 ? 0 : p.shift[m];
        const int sh1 = p.emit_int32 || !two ? 0 : p.shift[m + 1];
        int rs0 = 0, rs1 = 0;
        if constexpr (RES) {
          rs0 = p.res_shift[m];
          rs1 = two ? p.res_shift[m + 1] : 0;
        }
        // Pairs go out as one store where M is even (then n M + m is).
        const bool pair = two && !(p.M & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          if constexpr (RES) {
            const int n = r0 + 8 * h;
            if (n < p.rows_a) {
              const int8_t* r = p.res + (long long)n * p.ldr + m;
              a0 = add_skip(a0, r[0], rs0);
              if (two) a1 = add_skip(a1, r[1], rs1);
            }
          }
          const int v0 = bias_relu(a0, bz0, p.relu);
          const int v1 = bias_relu(a1, bz1, p.relu);
          if (staged) {
            const int r = warp * 16 + lane / 4 + 8 * h;
            *reinterpret_cast<char2*>(tile + r * LD + m - b0) =
                make_char2(requantize(v0, sh0, p.qmax),
                           requantize(v1, sh1, p.qmax));
            continue;
          }
          const int n = r0 + 8 * h;
          if (n >= p.rows_a) continue;
          const long long o = (long long)n * p.M + m;
          if (p.emit_int32) {
            int32_t* out = static_cast<int32_t*>(p.out) + o;
            if (pair) {
              *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
            } else {
              out[0] = v0;
              if (two) out[1] = v1;
            }
          } else {
            int8_t* out = static_cast<int8_t*>(p.out) + o;
            const int8_t q0 = requantize(v0, sh0, p.qmax);
            if (pair) {
              *reinterpret_cast<char2*>(out) =
                  make_char2(q0, requantize(v1, sh1, p.qmax));
            } else {
              out[0] = q0;
              if (two) out[1] = requantize(v1, sh1, p.qmax);
            }
          }
        }
      }
      if (staged) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
        // This warpgroup's 64 rows, W / 16 pieces a row, the columns
        // past M left out (M and b0 are multiples of 16).
        constexpr int PIECES = W / 16;
        const int cols = min(W, p.M - b0);
        const int t = tid % 128;
        for (int i = t; i < 64 * PIECES; i += 128) {
          const int r = i / PIECES, c = (i % PIECES) * 16;
          const int n = a0 + wg * 64 + r;
          if (n < p.rows_a && c < cols)
            *reinterpret_cast<int4*>(static_cast<int8_t*>(p.out)
                                     + (long long)n * p.M + b0 + c) =
                *reinterpret_cast<const int4*>(tile + r * LD + c);
        }
      }
    } else {
      // A rows are output channels m, B rows output rows n: the tile is
      // transposed on the store.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m >= p.rows_a) continue;
        const unsigned bz = p.bias ? (unsigned)p.bias[m] : 0u;
        const int sh = p.emit_int32 ? 0 : p.shift[m];
        int rs = 0;
        if constexpr (RES) rs = p.res_shift[m];
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = c0 + 8 * j + e;
            if (n >= p.rows_b) continue;
            int a = acc[4 * j + 2 * h + e];
            if constexpr (RES)
              a = add_skip(a, p.res[(long long)n * p.ldr + m], rs);
            const int v = bias_relu(a, bz, p.relu);
            const long long o = (long long)n * p.M + m;
            if (p.emit_int32)
              static_cast<int32_t*>(p.out)[o] = v;
            else
              static_cast<int8_t*>(p.out)[o] = requantize(v, sh, p.qmax);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A tensor map over an int8 [rows, K] matrix with row stride ld bytes,
// read in boxes of 128 bytes x `box_rows` rows, 128-byte swizzled; bytes
// past K and rows past `rows` read as zero.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int K,
                long long ld, int box_rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cuTensorMapEncodeIm2col, looked up as the tiled encoder is.
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeIm2col im2col_encoder() {
  static const EncodeIm2col fn = reinterpret_cast<EncodeIm2col>(
      driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// An im2col tensor map over one channel group of a conv's int8 NHWC input
// [B, H, W, C]: cg channels from `base` (the group's first), pixels `pix`
// bytes apart. A load brings `rows` pixels of `box_c` channels (128 or 64
// bytes, swizzled in as many), walking the positions of the filter's
// top-left tap, from -pad to the last that the filter reaches, `stride`
// apart, row by row and image by image; a position in the padding reads
// as zero.
bool im2col_map(CUtensorMap* map, const void* base, int B, int H, int W,
                int cg, long long pix, int R, int S, int stride, int pad_t,
                int pad_b, int pad_l, int pad_r, int box_c, int rows) {
  EncodeIm2col fn = im2col_encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cg, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pix, (cuuint64_t)(pix * W),
                                 (cuuint64_t)(pix * W * H)};
  const int lower[2] = {-pad_l, -pad_t};                 // (w, h)
  const int upper[2] = {pad_r - (S - 1), pad_b - (R - 1)};
  const cuuint32_t traversal[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride,
                                   1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base),
            dims, strides, lower, upper, (cuuint32_t)box_c,
            (cuuint32_t)rows, traversal, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_c == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches gemm_wgmma on encoded maps; p.k_iters is set here from K.
template <int W, int G, int KB, bool SWAP, bool RES, int AM>
cudaError_t run_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, int K,
                      WgParams p, int dev, cudaStream_t stream) {
  using T = WgTile<W, G, KB>;
  static_assert(T::STAGES * T::STAGE >= G * 64 * (W + 16),
                "the staged output tile fits in the ring");
  p.k_iters = (K + KB * BK - 1) / (KB * BK);
  const long long tiles_a = ((long long)p.rows_a + T::ROWS - 1) / T::ROWS;
  const long long tiles_b = ((long long)p.rows_b + W - 1) / W;
  if (tiles_a > 65535 || tiles_b > 65535)
    return cudaErrorInvalidValue;
  // The shared-memory limit is set once per device (a driver call costs
  // host time on every launch otherwise). Several host threads may launch
  // at once: the flags are atomic, and two threads that both find one
  // unset both set the same attribute, which is harmless.
  static std::atomic<bool> configured[MAX_DEVICES];   // zero: all false
  if (!configured[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma<W, G, KB, SWAP, RES, AM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((unsigned)tiles_b, (unsigned)tiles_a);
  gemm_wgmma<W, G, KB, SWAP, RES, AM>
      <<<grid, T::THREADS, T::SMEM, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// The device whose primary context the calling thread now holds, or an
// error.
cudaError_t current_device(int* dev) {
  const cudaError_t err = bind_device_context(dev);
  if (err != cudaSuccess) return err;
  return *dev < MAX_DEVICES ? cudaSuccess : cudaErrorInvalidDevice;
}

template <int W, int G, int KB, bool SWAP, bool RES>
cudaError_t launch_wgmma(const void* a, long long lda, const void* b,
                         long long ldb, int K, WgParams p,
                         cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, p.rows_a, K, lda, WgTile<W, G, KB>::ROWS)
      || !tensor_map(&tb, b, p.rows_b, K, ldb, W))
    return cudaErrorInvalidValue;
  return run_wgmma<W, G, KB, SWAP, RES, A_TILED>(ta, tb, K, p, dev, stream);
}

// The implicit-GEMM conv on tiling (W, G): A by im2col from x (one channel
// group), B the K-major weights [M, K] with row stride ldw.
template <int W, int G>
cudaError_t launch_conv(const void* x, int B, int H, int Wd, long long pix,
                        int R, int S, int pad_b, int pad_r, const void* wk,
                        long long ldw, WgParams p, bool res,
                        cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  const ConvGeom& g = p.conv;
  const bool wide = g.cg % 128 == 0;
  const int K = g.rs * g.cg;
  CUtensorMap ta, tb;
  if (!im2col_map(&ta, x, B, H, Wd, g.cg, pix, R, S, g.stride, g.pad_t,
                  pad_b, g.pad_l, pad_r, wide ? 128 : 64,
                  WgTile<W, G, 1>::ROWS)
      || !tensor_map(&tb, wk, p.rows_b, K, ldw, W))
    return cudaErrorInvalidValue;
  if (wide)
    return res ? run_wgmma<W, G, 1, false, true, A_IM2COL>(ta, tb, K, p, dev,
                                                           stream)
               : run_wgmma<W, G, 1, false, false, A_IM2COL>(ta, tb, K, p,
                                                            dev, stream);
  return res ? run_wgmma<W, G, 1, false, true, A_IM2COL64>(ta, tb, K, p, dev,
                                                           stream)
             : run_wgmma<W, G, 1, false, false, A_IM2COL64>(ta, tb, K, p,
                                                            dev, stream);
}

}  // namespace

// The __dp4a kernel. x [N, K] int8 with row stride ldx; w [K, M] int8 with
// w[k, m] at k swk + m swm (any layout with unit stride along K or M);
// shift [M] int32; bias [M] int32 or NULL; out [N, M] contiguous, int8, or
// int32 with emit_int32; qmax the int8 clip's upper bound (127, or a ReLU6
// engine's ceiling); res [N, M] int8 with row stride ldr and res_shift
// [M] int32, or both NULL. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int gemm_int8_launch(const void* x, long long ldx, const void* w,
                                long long swk, long long swm,
                                const void* shift, const void* bias,
                                void* out, int N, int K, int M, int relu,
                                int emit_int32, int qmax, const void* res,
                                long long ldr, const void* res_shift,
                                void* stream) {
  if (N <= 0 || M <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long row_tiles = ((long long)N + BN - 1) / BN;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int vec_x = ((uintptr_t)x % 4 == 0) && (ldx % 4 == 0);
  const int vec_w = swm == 1 && ((uintptr_t)w % 4 == 0) && (swk % 4 == 0);
  const dim3 grid((M + BM - 1) / BM, (unsigned)row_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const int32_t* sh = static_cast<const int32_t*>(shift);
  const int32_t* bz = static_cast<const int32_t*>(bias);
  const int8_t* rs = static_cast<const int8_t*>(res);
  const int32_t* rsh = static_cast<const int32_t*>(res_shift);
  if (res)
    gemm_int8_kernel<true><<<grid, THREADS, 0, s>>>(
        xs, ldx, ws, swk, swm, sh, bz, out, N, K, M, relu, emit_int32, qmax,
        vec_x, vec_w, rs, ldr, rsh);
  else
    gemm_int8_kernel<false><<<grid, THREADS, 0, s>>>(
        xs, ldx, ws, swk, swm, sh, bz, out, N, K, M, relu, emit_int32, qmax,
        vec_x, vec_w, rs, ldr, rsh);
  return (int)cudaGetLastError();
}

// The wgmma kernels. x [N, K] int8 with row stride ldx bytes; wk [M, K]
// int8 (the weights K-major) with row stride ldw bytes; both bases and
// strides 16-byte aligned, K >= 1; qmax, res and res_shift as for
// gemm_int8_launch (the RES instantiation where res is not NULL). `swap`
// picks the small-N kernel,
// `width` its wgmma width, `warpgroups` the consumer warpgroups (64 rows
// each), `k_boxes` the 128-byte K boxes a stage brings (a tiling no
// kernel is built for is refused). Returns the first cudaError_t met (0 on
// success); it does not synchronise.
extern "C" int gemm_int8_wgmma_launch(const void* x, long long ldx,
                                      const void* wk, long long ldw,
                                      const void* shift, const void* bias,
                                      void* out, int N, int K, int M,
                                      int relu, int emit_int32, int qmax,
                                      int swap,
                                      int width, int warpgroups, int k_boxes,
                                      const void* res, long long ldr,
                                      const void* res_shift, void* stream) {
  if (N <= 0 || M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  WgParams p;
  p.shift = static_cast<const int32_t*>(shift);
  p.bias = static_cast<const int32_t*>(bias);
  p.res = static_cast<const int8_t*>(res);
  p.ldr = ldr;
  p.res_shift = static_cast<const int32_t*>(res_shift);
  p.out = out;
  p.rows_a = swap ? M : N;
  p.rows_b = swap ? N : M;
  p.M = M;
  p.relu = relu;
  p.emit_int32 = emit_int32;
  p.qmax = qmax;
  const void* a = swap ? wk : x;
  const void* b = swap ? x : wk;
  const long long lda = swap ? ldw : ldx, ldb = swap ? ldx : ldw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define GEMM_CASE(W_, G_, KB_, SWAP_)                                       \
  else if (width == W_ && warpgroups == G_ && k_boxes == KB_                \
           && (bool)swap == SWAP_)                                          \
    err = res ? launch_wgmma<W_, G_, KB_, SWAP_, true>(a, lda, b, ldb, K,   \
                                                       p, s)                \
              : launch_wgmma<W_, G_, KB_, SWAP_, false>(a, lda, b, ldb, K,  \
                                                        p, s);
  if (false) {}
  GEMM_CASE(64, 2, 1, false)
  GEMM_CASE(96, 2, 1, false)
  GEMM_CASE(128, 2, 1, false)
  GEMM_CASE(64, 1, 1, false)
  GEMM_CASE(16, 1, 2, true)
  GEMM_CASE(32, 1, 2, true)
  GEMM_CASE(64, 1, 2, true)
#undef GEMM_CASE
  return (int)err;
}

// The implicit-GEMM conv: one channel group of an int8 NHWC input x
// [B, H, W, C] (x points at the group's first channel; pixels `pix` = C
// bytes apart), cg channels (a multiple of 64), an R x S filter at
// `stride` with padding (pad_t, pad_b) on H and (pad_l, pad_r) on W,
// against the group's K-major weights wk [M, K = R S cg] with row stride
// ldw bytes; out [B Ho Wo, M] and the epilogue's operands as for
// gemm_int8_wgmma_launch. x, wk, pix and ldw 16-byte aligned. `width` and
// `warpgroups` pick one of the large-N tilings. Returns the first
// cudaError_t met (0 on success); it does not synchronise.
extern "C" int gemm_int8_conv_launch(const void* x, int B, int H, int W,
                                     long long pix, int cg, int R, int S,
                                     int stride, int pad_t, int pad_b,
                                     int pad_l, int pad_r, const void* wk,
                                     long long ldw, const void* shift,
                                     const void* bias, void* out, int M,
                                     int relu, int emit_int32, int qmax,
                                     int width,
                                     int warpgroups, const void* res,
                                     long long ldr, const void* res_shift,
                                     void* stream) {
  const int Ho = (H + pad_t + pad_b - R) / stride + 1;
  const int Wo = (W + pad_l + pad_r - S) / stride + 1;
  if (B <= 0 || M <= 0 || cg <= 0 || cg % 64 || R <= 0 || S <= 0
      || stride <= 0 || H + pad_t + pad_b < R || W + pad_l + pad_r < S)
    return (int)cudaErrorInvalidValue;
  const long long N = (long long)B * Ho * Wo;
  if (N > INT_MAX) return (int)cudaErrorInvalidValue;
  WgParams p;
  p.shift = static_cast<const int32_t*>(shift);
  p.bias = static_cast<const int32_t*>(bias);
  p.res = static_cast<const int8_t*>(res);
  p.ldr = ldr;
  p.res_shift = static_cast<const int32_t*>(res_shift);
  p.out = out;
  p.rows_a = (int)N;
  p.rows_b = M;
  p.M = M;
  p.relu = relu;
  p.emit_int32 = emit_int32;
  p.qmax = qmax;
  p.conv = {cg, S, R * S, Ho * Wo, Wo, stride, pad_t, pad_l};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define CONV_CASE(W_, G_)                                                   \
  else if (width == W_ && warpgroups == G_)                                 \
    err = launch_conv<W_, G_>(x, B, H, W, pix, R, S, pad_b, pad_r, wk, ldw,  \
                              p, res != nullptr, s);
  if (false) {}
  CONV_CASE(64, 2)
  CONV_CASE(96, 2)
  CONV_CASE(128, 2)
  CONV_CASE(64, 1)
#undef CONV_CASE
  return (int)err;
}
