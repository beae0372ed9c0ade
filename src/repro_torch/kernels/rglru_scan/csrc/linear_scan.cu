// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t over [B, S, D],
// written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py::linear_scan
// (Pallas body `_kernel`, pallas_call at :60): h_{-1} = 0, the recurrence
// in fp32, the output in b's dtype. The Pallas kernel cuts S into chunks,
// scans each chunk in VMEM and carries h from chunk to chunk in scratch
// along a sequential grid dimension. On Hopper blocks run in no order and
// carry nothing between them, so here each thread owns one (b, d) channel
// and walks t = 0 .. S-1 itself with h in a register: no carry crosses a
// block. Any S is taken (the Pallas kernel's S % chunk == 0 is a tiling
// limit, not part of the function); a ragged D edge is masked.
//
// Numerics: h = (a_t * h) + b_t in fp32 with both roundings, as the plain
// version and the reference's scan body compute it: __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA. A fused fmaf rounds
// once a step instead, and the two drift apart: on the card, with a in
// (0.99, 0.9999) over 4096 steps, beyond the reference's 2e-5. Inputs are read as float32 or bf16 and widened; the output is
// cast to b's dtype at the store only.
//
// What bounds it on the H100: it does 2 flops per 12 bytes (fp32 a, b, h),
// so memory. At the RecurrentGemma-2B forward's shape (B 2, S 4096,
// D 2560, fp32) it reads a and b and writes h, 252 MB: 75 us at
// 3.35 TB/s. This design does not reach that. Neighbouring threads take
// neighbouring d, so every step's loads and stores are coalesced 128-byte
// lines, and the time loop is unrolled by 16 so that 32 independent loads
// are in flight before the chain of steps consumes them. But B * D = 5120
// threads are 80 blocks of 64 on 132 SMs, one or two warps an SM: too few
// bytes in flight to cover device-memory latency, so it is latency-bound.
// The later design is the TPU kernel's chunk-with-carry made parallel
// across blocks, in three passes: every block scans one (chunk, channel
// tile) and keeps the chunk's product of a and its end value; a short pass
// carries h across the chunks; a fix-up adds (prod_{s<=t} a_s) * carry to
// each h_t of a chunk. That puts S / chunk times more warps on the card
// for about 1.5x the bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 64;   // channels per block
constexpr int UNROLL = 16;    // time steps loaded ahead of the chain

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

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
linear_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   TB* __restrict__ h, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  a += base;
  b += base;
  h += base;
  float acc = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = (long long)(t + u) * D;
      av[u] = widen(a[o]);
      bv[u] = widen(b[o]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc = step(av[u], acc, bv[u]);
      h[(long long)(t + u) * D] = narrow<TB>(acc);
    }
  }
  for (; t < S; ++t) {
    const long long o = (long long)t * D;
    acc = step(widen(a[o]), acc, widen(b[o]));
    h[o] = narrow<TB>(acc);
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S,
                   int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  linear_scan_kernel<TA, TB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TB*>(h), S, D);
  return cudaGetLastError();
}

}  // namespace

// a, b, h [B, S, D] contiguous; a and b each fp32 (flag 0) or bf16 (flag
// 1); h in b's dtype. Returns the launch's cudaError_t.
extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  int B, int S, int D, int a_bf16,
                                  int b_bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (a_bf16)
    err = b_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, b, h, B, S, D,
                                                         stream)
                 : launch<__nv_bfloat16, float>(a, b, h, B, S, D, stream);
  else
    err = b_bf16 ? launch<float, __nv_bfloat16>(a, b, h, B, S, D, stream)
                 : launch<float, float>(a, b, h, B, S, D, stream);
  return (int)err;
}
