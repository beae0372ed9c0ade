// Quantize-in on the card: float32 frames rounded onto the program's frozen
// int8 input format, written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C entry point, loaded with ctypes (kernels/quantize_in/kernel.py).
//
// It replaces no TPU kernel: the JAX package rounds its frames on the host
// in numpy (CompiledRunner.quantize), as the port did, a chunk of frames at
// a time; a host-bound serve loop spent most of its time there. Now the
// host only copies the float frames into a pinned slot and this kernel,
// the first node of stage 0's CUDA graph, rounds them.
//
//   q[i] = clamp(rint(x[i] * scale), -128, 127),  scale = 2^-e_input
//
// The multiply is one float32 product rounded to nearest (__fmul_rn), the
// rounding half to even (__float2int_rn, which saturates past the int32
// range, so +-inf land on the rails; NaN gives 0), then the clamp: the
// same integers as numpy's float32 multiply, rint and clip on the host.
// No fast-math flag: subnormal inputs and products are not flushed.
//
// What bounds it: bytes. Four bytes read and one written an element, no
// reuse: a VGG16 batch of 16 (2,408,448 elements) moves 12.0 MB, 3.6 us at
// 3.35 TB/s. A thread takes 16 consecutive elements: four 16-byte float4
// loads and one 16-byte store. The last n % 16 elements, where the count is
// not a multiple of 16 (an AlexNet frame has 154,587), go one a thread to
// the first threads of the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned round4(float4 v, float scale) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int r = __float2int_rn(__fmul_rn(f[k], scale));
    r = r < -128 ? -128 : (r > 127 ? 127 : r);
    word |= (unsigned)(r & 0xff) << (8 * k);
  }
  return word;
}

__global__ void __launch_bounds__(256)
quantize_in_int8(const float4* __restrict__ x, uint4* __restrict__ q,
                 const float* __restrict__ x_tail,
                 int8_t* __restrict__ q_tail, long long groups, int tail,
                 float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < groups) {
    const float4* src = x + 4 * i;
    const float4 a = src[0], b = src[1], c = src[2], d = src[3];
    q[i] = make_uint4(round4(a, scale), round4(b, scale), round4(c, scale),
                      round4(d, scale));
  }
  if (i < tail) {
    int r = __float2int_rn(__fmul_rn(x_tail[i], scale));
    q_tail[i] = (int8_t)(r < -128 ? -128 : (r > 127 ? 127 : r));
  }
}

}  // namespace

// x: n contiguous float32 on a 16-byte base; q: n int8 on a 16-byte base;
// scale: 2^-e_input. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int quantize_in_int8_launch(const void* x, void* q, long long n,
                                       float scale, void* stream) {
  if (n <= 0 || (uintptr_t)x % 16 || (uintptr_t)q % 16)
    return (int)cudaErrorInvalidValue;
  const long long groups = n / 16;
  const int tail = (int)(n % 16);
  const int threads = 256;
  const long long work = groups > tail ? groups : tail;
  const long long blocks = (work + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  int8_t* qb = static_cast<int8_t*>(q);
  quantize_in_int8<<<(unsigned)blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint4*>(q),
      xf + 16 * groups, qb + 16 * groups, groups, tail, scale);
  return (int)cudaGetLastError();
}
