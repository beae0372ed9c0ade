// Hopper (sm_90a) plumbing shared by the port's TMA + wgmma kernels
// (conv2d_int8/csrc/gemm_int8.cu, flash_attention/csrc/flash_attention.cu):
// shared-memory addresses, the mbarrier ring's operations, the wgmma
// fences and descriptors, and the host's lookup of the driver's tensor-map
// encoders.
// Included by each source, which _build.py compiles alone; _build.py
// hashes this directory into every library's name, so an edit here
// rebuilds them all.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (header only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers: a full/empty pair per stage of a TMA ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A wgmma shared-memory descriptor for a tile swizzled in rows of
// `swizzle` bytes (128 or 64) whose swizzle atoms (8 such rows, aligned to
// their size) lie `sbo` bytes apart along the 8-row direction and `lbo`
// bytes apart along the other.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              int swizzle = 128) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;  // 128- or 64-byte
  return (uint64_t)((addr & 0x3ffff) >> 4)
      | ((uint64_t)(lbo >> 4) << 16)
      | ((uint64_t)(sbo >> 4) << 32)
      | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N of this warpgroup's committed groups of products
// are still running (they finish in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator or operand
// registers across the asynchronous products around them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// ---------------------------------------------------------------------------
// Host: TMA tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (no
// -lcuda at link time); null if the driver does not have it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor-map encoder works in the calling thread's current context. A
// host thread whose first CUDA call is one of these launches (a pipeline
// stage worker whose tensors all came from other threads) has none yet,
// and the encoder refuses. cudaSetDevice makes the current device's
// primary context current (CUDA 12); it is called once per thread and
// device. Sets *dev to the current device.
inline cudaError_t bind_device_context(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  thread_local int bound = -1;
  if (bound != *dev) {
    err = cudaSetDevice(*dev);
    if (err != cudaSuccess) return err;
    bound = *dev;
  }
  return cudaSuccess;
}

// A driver entry point looked up in libcuda through the runtime; null if
// the driver does not have it.
inline void* driver_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &ptr, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault,
                                            &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? ptr : nullptr;
}

// Looked up once: a function-local static is initialised by one thread
// while concurrent callers wait (C++11), so host threads launching at once
// never read it half-written.
EncodeTiled encoder() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

}  // namespace
