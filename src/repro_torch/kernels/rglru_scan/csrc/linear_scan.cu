// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t over [B, S, D],
// written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py::linear_scan
// (Pallas body `_kernel`, pallas_call at :60): h_{-1} = 0, the recurrence
// in fp32, the output in b's dtype. The Pallas kernel cuts S into chunks,
// scans each chunk in VMEM and carries h from chunk to chunk in scratch
// along a sequential grid dimension. Any S is taken here (the Pallas
// kernel's S % chunk == 0 is a tiling limit, not part of the function); a
// ragged D edge is masked.
//
// Numerics: h = (a_t * h) + b_t in fp32 with both roundings, as the plain
// version and the reference's scan body compute it: __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA. A fused fmaf rounds
// once a step instead, and the two drift apart: on the card, with a in
// (0.99, 0.9999) over 4096 steps, beyond the reference's 2e-5. Inputs are
// read as float32 or bf16 and widened; the output is cast to b's dtype at
// the store only. Every channel's chain runs its steps in order from
// h_{-1} = 0, so the result equals the plain version bit for bit.
//
// What bounds it on the H100: it does 2 flops per 12 bytes (fp32 a, b, h),
// so memory. At the RecurrentGemma-2B forward's shape (B 2, S 4096,
// D 2560, fp32) it reads a and b and writes h, 252 MB: 75 us at
// 3.35 TB/s. A design with one thread per (b, d) channel walking all S
// steps puts only B * D = 5120 threads on 132 SMs, too few bytes in flight
// to cover device-memory latency (it ran at 550 GB/s).
//
// This design cuts S into chunks of CHUNK steps and D into tiles of 32
// channels; a block takes one (chunk, b, channel tile):
//   1. all 256 threads copy the chunk's a and b tiles into shared memory
//      at once (cp.async, 16 bytes a thread per copy, coalesced rows), so
//      every resident block has its whole tile in flight;
//   2. one warp, a lane per channel, waits for the exact end h of the
//      same channels in chunk c - 1, runs the chain over the chunk from
//      shared memory with the two roundings, writes each h_t over b_t
//      there and publishes its end h for chunk c + 1;
//   3. all 256 threads store the h tile, 16 bytes a thread per store.
// Storing h_t from the chain warp itself, one 4-byte store a lane a step,
// put every store on the chain's critical path and made them the
// bottleneck; staged in shared memory they leave in wide, coalesced
// stores after the hand-off.
// The hand-off is one 64-bit word per (chunk, b, channel): the h bits in
// the low half and 1 in the high half, written once by a single store, so
// a reader that sees the flag sees the value with it; the wrapper zeroes
// the words before every launch. Blocks take their (chunk, b, tile) from
// an atomic ticket in chunk-major order, so the block a waiting block
// depends on took an earlier ticket and is running or done: no deadlock,
// whatever order the hardware schedules blocks in. The serial part is the
// chain itself, S dependent multiply-then-add steps a channel, plus one
// hand-off a chunk; the loads of later chunks overlap it.
//
// What remains: a and b are the RG-LRU gates' outputs, materialised in
// fp32 by separate elementwise passes (PERF.md); computing them inside
// this kernel from the gate pre-activations would cut the bytes the
// forward moves, but changes the kernel's function.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;     // channels per block: one warp, a lane each
constexpr int CHUNK = 256;    // time steps per block
constexpr int THREADS = 256;  // threads that load and store the tiles

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// One step, rounded after the product and after the sum (no FMA).
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows x LANES elements of [.., D] from global row t0, columns d0.. into
// dst[rows][LANES]; columns past D read as zero. With `vec`, D is a
// multiple of 8 and the base 16-byte aligned, and each copy is 16 bytes.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int D,
                                          int rows, int d0, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);       // elements per copy
    constexpr int CPR = LANES / PER;          // copies per row
    for (int i = tid; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * PER;
      const bool valid = d0 + c < D;
      const T* g = valid ? src + (long long)r * D + d0 + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(dst + r * LANES + c)), "l"(g),
                      "r"(valid ? 16 : 0));
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < rows * LANES; i += THREADS) {
      const int r = i / LANES, c = i % LANES;
      dst[i] = d0 + c < D ? src[(long long)r * D + d0 + c] : T(0.f);
    }
  }
}

// The tile back: src[rows][LANES] into rows x LANES elements of [.., D]
// from row t0, columns d0..; columns past D are not written.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int D,
                                           int rows, int d0, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    constexpr int CPR = LANES / PER;
    for (int i = tid; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * PER;
      if (d0 + c < D)
        *reinterpret_cast<uint4*>(dst + (long long)r * D + d0 + c) =
            *reinterpret_cast<const uint4*>(src + r * LANES + c);
    }
  } else {
    for (int i = tid; i < rows * LANES; i += THREADS) {
      const int r = i / LANES, c = i % LANES;
      if (d0 + c < D) dst[(long long)r * D + d0 + c] = src[i];
    }
  }
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v)
               : "memory");
}

// scratch: word 0 the ticket; then (n_chunks - 1) x B x Dp hand-off
// words, Dp = D rounded up to LANES.
template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
linear_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   TB* __restrict__ h, unsigned long long* scratch, int B,
                   int S, int D, int tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* As = reinterpret_cast<TA*>(smem_raw);              // [CHUNK][LANES]
  TB* Bs = reinterpret_cast<TB*>(As + CHUNK * LANES);    // [CHUNK][LANES]
  __shared__ unsigned int ticket;
  const int tid = threadIdx.x;
  if (tid == 0)
    ticket = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const unsigned int row = B * tiles;          // blocks per chunk
  const int chunk = ticket / row;
  const int bt = ticket % row;
  const int bi = bt / tiles, d0 = (bt % tiles) * LANES;
  const int t0 = chunk * CHUNK;
  const int rows = min(CHUNK, S - t0);
  const long long base = ((long long)bi * S + t0) * D;

  load_tile(As, a + base, D, rows, d0, vec, tid);
  load_tile(Bs, b + base, D, rows, d0, vec, tid);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (tid < LANES) {
    // The chain: chunk c - 1's exact end h once flagged, then every step
    // in order from shared memory; h_t overwrites b_t in place (h is in
    // b's dtype), and the end h goes out before the tile is stored.
    const int d = d0 + tid;
    const long long Dp = (long long)tiles * LANES;
    unsigned long long* words = scratch + 1;
    float acc = 0.f;
    if (chunk > 0) {
      const unsigned long long* w =
          words + ((long long)(chunk - 1) * B + bi) * Dp + d;
      unsigned long long v;
      while (!((v = load_word(w)) >> 32)) {
      }
      acc = __uint_as_float((uint32_t)v);
    }
    constexpr int U = 32;        // shared loads issued ahead of the chain
    int t = 0;
    for (; t + U <= rows; t += U) {
      float av[U], bv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        av[u] = widen(As[(t + u) * LANES + tid]);
        bv[u] = widen(Bs[(t + u) * LANES + tid]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc = step(av[u], acc, bv[u]);
        Bs[(t + u) * LANES + tid] = narrow<TB>(acc);
      }
    }
    for (; t < rows; ++t) {
      acc = step(widen(As[t * LANES + tid]), acc, widen(Bs[t * LANES + tid]));
      Bs[t * LANES + tid] = narrow<TB>(acc);
    }
    if (t0 + CHUNK < S)          // publish for chunk c + 1
      store_word(words + ((long long)chunk * B + bi) * Dp + d,
                 (1ull << 32) | __float_as_uint(acc));
  }
  __syncthreads();
  store_tile(h + base, Bs, D, rows, d0, vec, tid);
}

long long n_chunks(int S) { return (S + CHUNK - 1) / CHUNK; }
long long n_tiles(int D) { return (D + LANES - 1) / LANES; }

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* h, void* scratch,
                   int B, int S, int D, cudaStream_t stream) {
  const long long tiles = n_tiles(D);
  const long long blocks = n_chunks(S) * B * tiles;
  if (blocks > 0x7fffffffLL || B * tiles > 0xffffffffLL)
    return cudaErrorInvalidValue;
  const int vec = D % 8 == 0 && (uintptr_t)a % 16 == 0
      && (uintptr_t)b % 16 == 0 && (uintptr_t)h % 16 == 0;
  const size_t smem = (size_t)CHUNK * LANES * (sizeof(TA) + sizeof(TB));
  auto kernel = linear_scan_kernel<TA, TB>;
  // Dynamic shared memory past 48 KB, with the static ticket beside it,
  // only by opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TB*>(h), static_cast<unsigned long long*>(scratch), B, S,
      D, (int)tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// 64-bit words of scratch one launch at [B, S, D] needs, all zero at the
// launch: the ticket and the chunk-to-chunk hand-offs.
extern "C" long long linear_scan_scratch_words(int B, int S, int D) {
  return 1 + (n_chunks(S) - 1) * B * n_tiles(D) * LANES;
}

// a, b, h [B, S, D] contiguous; a and b each fp32 (flag 0) or bf16 (flag
// 1); h in b's dtype; `scratch` holds linear_scan_scratch_words(B, S, D)
// zeroed 64-bit words. Returns the launch's cudaError_t.
extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  void* scratch, int B, int S, int D,
                                  int a_bf16, int b_bf16,
                                  cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (a_bf16)
    err = b_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, b, h, scratch, B,
                                                         S, D, stream)
                 : launch<__nv_bfloat16, float>(a, b, h, scratch, B, S, D,
                                                stream);
  else
    err = b_bf16 ? launch<float, __nv_bfloat16>(a, b, h, scratch, B, S, D,
                                                stream)
                 : launch<float, float>(a, b, h, scratch, B, S, D, stream);
  return (int)err;
}
