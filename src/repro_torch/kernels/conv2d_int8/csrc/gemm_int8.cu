// int8 GEMM with a fused integer epilogue, written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/conv2d_int8/kernel.py::gemm_int8
// (Pallas body `_kernel`): out[N, M] = epilogue(x[N, K] @ w[K, M]) with
// int32 accumulation, then + int32 bias[M], optional ReLU, and a
// per-column saturating signed shift (negative = left shift, capped at 16,
// clamped before the shift) clipped to int8. With emit_int32 the epilogue
// stops after bias/ReLU and writes the int32 values.
//
// What bounds it on the H100: the fc layers at N = 16 rows are bound by the
// weight bytes they must read (fc6 reads 37.7 MB for 0.6 G multiply-adds).
// The convs are bound by int8 multiply-accumulates on this design: at the
// tensor cores' int8 rate even they would be bound by bytes, but __dp4a on
// the CUDA cores runs far below that rate.
//
// Design (simple and right first):
//   * one block computes a 64 x 64 output tile with 256 threads, 4 x 4
//     outputs each, accumulating in int32 registers;
//   * the reduction runs as a loop inside the block over 64-deep stages:
//     the TPU's sequential k-grid with its VMEM scratch becomes registers;
//   * x and w stages go to shared memory packed as 4-byte quads along K,
//     so every multiply-accumulate is one __dp4a (4 int8 products summed
//     into the int32 accumulator); w is transposed into quads on the way;
//   * the kernel masks the ragged N / K / M edges itself (K = 363 on the
//     AlexNet stem, M = 1000 on fc8): out-of-range bytes load as zero and
//     out-of-range outputs are not stored. There is no host-side padding.
//     Rows of x and w may have any leading dimension (a group's slice of
//     the conv weights is used in place); 4-byte loads are taken where
//     the base and the leading dimension allow, byte loads elsewhere.
//   * the epilogue runs on the registers. C++ before C++20 leaves a left
//     shift of a negative int undefined, so the saturating left shift runs
//     on uint32_t after the clamp; the right shift stays arithmetic on
//     int32_t with min(shift, 31). The bias add wraps like the int32 add
//     of the plain version.
//
// What it leaves on the table: no tensor cores (the card's int8 peak is
// wgmma s8's, far above what __dp4a on the CUDA cores reaches), no TMA or
// cp.async pipelining of the stages, im2col done outside the kernel, one
// launch per channel group, and 64-row tiles that waste 75% of their rows
// on the N = 16 fc layers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BN = 64;        // output rows (rows of x) per block
constexpr int BM = 64;        // output columns (columns of w) per block
constexpr int BK = 64;        // reduction depth per shared-memory stage
constexpr int KQ = BK / 4;    // packed 4-byte quads per stage
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

// w[k, m .. m+3] packed (byte j = w[k, m+j]); zero outside [0, K) x [0, M).
__device__ __forceinline__ unsigned load_w_word(const int8_t* __restrict__ w,
                                                long long ldw, int k, int m,
                                                int K, int M, bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = w + (long long)k * ldw + m;
  if (vec && m + 3 < M) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (m + j < M) v |= ((unsigned)(int)p[j] & 0xffu) << (8 * j);
  return v;
}

// The Fig. 3(c) output stage: saturating signed shift, clip to int8.
__device__ __forceinline__ int8_t requantize(int v, int sh) {
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
  return (int8_t)(y < -128 ? -128 : (y > 127 ? 127 : y));
}

__global__ void __launch_bounds__(THREADS)
gemm_int8_kernel(const int8_t* __restrict__ x, long long ldx,
                 const int8_t* __restrict__ w, long long ldw,
                 const int32_t* __restrict__ shift,
                 const int32_t* __restrict__ bias, void* __restrict__ out,
                 int N, int K, int M, int relu, int emit_int32, int vec_x,
                 int vec_w) {
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

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xs[xq + i][xr] =
          load_x_quad(x, ldx, n0 + xr, k0 + 4 * (xq + i), N, K, vec_x);
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = load_w_word(w, ldw, k0 + 4 * wq + i, m0 + wc, K, M, vec_w);
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
      const unsigned b = bias ? (unsigned)bias[m] : 0u;
      int v = (int)((unsigned)acc[i][j] + b);
      if (relu && v < 0) v = 0;
      const long long o = (long long)n * M + m;
      if (emit_int32)
        static_cast<int32_t*>(out)[o] = v;
      else
        static_cast<int8_t*>(out)[o] = requantize(v, shift[m]);
    }
  }
}

}  // namespace

// x [N, K] int8 with row stride ldx; w [K, M] int8 with row stride ldw;
// shift [M] int32; bias [M] int32 or NULL; out [N, M] contiguous, int8, or
// int32 with emit_int32. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int gemm_int8_launch(const void* x, long long ldx, const void* w,
                                long long ldw, const void* shift,
                                const void* bias, void* out, int N, int K,
                                int M, int relu, int emit_int32,
                                void* stream) {
  if (N <= 0 || M <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long row_tiles = ((long long)N + BN - 1) / BN;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int vec_x = ((uintptr_t)x % 4 == 0) && (ldx % 4 == 0);
  const int vec_w = ((uintptr_t)w % 4 == 0) && (ldw % 4 == 0);
  const dim3 grid((M + BM - 1) / BM, (unsigned)row_tiles);
  gemm_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), ldx, static_cast<const int8_t*>(w), ldw,
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(bias),
      out, N, K, M, relu, emit_int32, vec_x, vec_w);
  return (int)cudaGetLastError();
}
