// Depthwise 3x3 int8 convolution with the engine's fused integer epilogue,
// written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C entry point, loaded with ctypes (kernels/dwconv_int8/kernel.py).
//
// It replaces no TPU kernel: the JAX package has no depthwise model, and
// runs a grouped conv as one GEMM per group, which for a depthwise conv
// (one input channel per output channel) would be one launch per channel
// with K = 9. MobileNetV2's inverted residual blocks run their 17
// depthwise convs here instead.
//
//   out[b, ho, wo, c] = clip(shift((relu?)(acc + bias[c]), shift[c]),
//                            -128, qmax)
//   acc = sum_{r, s < 3} x[b, ho st + r - 1, wo st + s - 1, c] w[r, s, c]
//
// x [B, H, W, C] int8 NHWC (zeros outside the map), w [3, 3, C] int8,
// stride st 1 or 2, padding 1 on every side, channel multiplier 1, int32
// accumulation; the epilogue is gemm_int8's (bias added wrapping as the
// int32 add does, ReLU, the per-channel saturating signed shift, the clip
// onto [-128, qmax], qmax 127 or a ReLU6 engine's ceiling).
//
// What bounds it: bytes. A depthwise layer does 9 multiply-adds per
// output byte, against the hundreds of a dense conv, so on the H100 it
// can never approach the int8 rate: MobileNetV2's 17 depthwise layers do
// 0.66 G operations at batch 16 (0.33 us at 1979 TOP/s) but move 96.7 MB
// (28.9 us at 3.35 TB/s). The design reads each input byte from HBM about
// once and writes each output byte once:
//   * a block takes a tile of TH x TW output pixels of one image over CB
//     channels (CB / 4 threads across the channels, TW down the columns);
//     it stages the tile's input with its halo, ((TH - 1) st + 3) x
//     ((TW - 1) st + 3) pixels of CB bytes, in shared memory, in 16-byte
//     loads along C (8 or 4 where C is not a multiple of 16), zeros for
//     the padding; and the 9 x CB weights once;
//   * a thread computes four channels of one output column, row by row:
//     the nine 4-channel words of a pixel's window are transposed in
//     registers (__byte_perm) into per-channel words of four taps, so
//     __dp4a sums four taps a channel at once (taps 0-3, 4-7, and tap 8
//     against a weight word holding it in the channel's own byte); the
//     weights are transposed once a thread;
//   * the four results are requantized and stored as one 4-byte word;
//     consecutive threads store consecutive words, so a warp writes whole
//     128-byte lines.
// The host wrapper picks CB, TW and TH (kernel.py::plan_for).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// The Fig. 3(c) output stage, as gemm_int8.cu has it: saturating signed
// shift (negative = left shift, capped at 16, clamped before the shift),
// clip onto [-128, hi].
__device__ __forceinline__ int requantize(int v, int sh, int hi) {
  int y;
  if (sh >= 0) {
    y = v >> (sh < 31 ? sh : 31);
  } else {
    const int sl = sh < -16 ? 16 : -sh;
    const int lo = INT_MIN >> sl;
    const int up = INT_MAX >> sl;
    const int c = v < lo ? lo : (v > up ? up : v);
    y = (int)((unsigned)c << sl);
  }
  return y < -128 ? -128 : (y > hi ? hi : y);
}

// Four words of four bytes, word t holding byte j of channel j, to four
// words of four bytes, word j holding channel j's bytes from words 0-3.
__device__ __forceinline__ void transpose4(unsigned a, unsigned b,
                                           unsigned c, unsigned d,
                                           unsigned r[4]) {
  const unsigned t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const unsigned t1 = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const unsigned t2 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const unsigned t3 = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  r[0] = __byte_perm(t0, t1, 0x5410);             // a0 b0 c0 d0
  r[1] = __byte_perm(t0, t1, 0x7632);             // a1 b1 c1 d1
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

template <int VL> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned; };

// VL: bytes a staging load moves along C (16, 8 or 4; C and the block's
// channels are multiples of it). blockDim = (CB / 4, TW).
template <int VL>
__global__ void __launch_bounds__(1024)
dwconv3x3_int8(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ shift,
               const int32_t* __restrict__ bias, int8_t* __restrict__ out,
               int H, int W, int C, int Ho, int Wo, int stride, int relu,
               int qmax, int th, int tiles_w) {
  using V = typename Vec<VL>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CB = 4 * blockDim.x, tw = blockDim.y;
  const int IH = (th - 1) * stride + 3, IW = (tw - 1) * stride + 3;
  unsigned char* xs = smem;                       // [IH][IW][CB]
  unsigned char* ws = smem + IH * IW * CB;        // [9][CB]
  const int b = blockIdx.z, c0 = blockIdx.x * CB;
  const int oh0 = (blockIdx.y / tiles_w) * th;
  const int ow0 = (blockIdx.y % tiles_w) * tw;
  const int ih0 = oh0 * stride - 1, iw0 = ow0 * stride - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nv = CB / VL;
  const int8_t* xb = x + (long long)b * H * W * C;

  for (int i = tid; i < IH * IW * nv; i += nthreads) {
    const int v = i % nv, pix = i / nv;
    const int ih = ih0 + pix / IW, iw = iw0 + pix % IW, c = c0 + v * VL;
    V val = {};
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C)
      val = *reinterpret_cast<const V*>(xb + ((long long)ih * W + iw) * C
                                        + c);
    *reinterpret_cast<V*>(xs + pix * CB + v * VL) = val;
  }
  for (int i = tid; i < 9 * nv; i += nthreads) {
    const int v = i % nv, t = i / nv, c = c0 + v * VL;
    V val = {};
    if (c < C) val = *reinterpret_cast<const V*>(w + (long long)t * C + c);
    *reinterpret_cast<V*>(ws + t * CB + v * VL) = val;
  }
  __syncthreads();

  const int c = c0 + 4 * threadIdx.x, ow = ow0 + threadIdx.y;
  if (c >= C || ow >= Wo) return;
  unsigned wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    wt[t] = *reinterpret_cast<const unsigned*>(ws + t * CB
                                               + 4 * threadIdx.x);
  unsigned w0[4], w1[4], w2[4];
  transpose4(wt[0], wt[1], wt[2], wt[3], w0);
  transpose4(wt[4], wt[5], wt[6], wt[7], w1);
  int bz[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w2[j] = wt[8] & (0xffu << (8 * j));     // tap 8 in channel j's byte
    bz[j] = bias ? bias[c + j] : 0;
    sh[j] = shift[c + j];
  }
  const int rows = min(th, Ho - oh0);
  const unsigned char* col = xs + threadIdx.y * stride * CB
      + 4 * threadIdx.x;
  int8_t* o = out + (((long long)b * Ho + oh0) * Wo + ow) * C + c;
  for (int r = 0; r < rows; ++r) {
    const unsigned char* p = col + r * stride * IW * CB;
    unsigned xt[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        xt[3 * i + j] = *reinterpret_cast<const unsigned*>(
            p + (i * IW + j) * CB);
    unsigned x0[4], x1[4];
    transpose4(xt[0], xt[1], xt[2], xt[3], x0);
    transpose4(xt[4], xt[5], xt[6], xt[7], x1);
    unsigned packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int acc = __dp4a((int)x0[j], (int)w0[j], 0);
      acc = __dp4a((int)x1[j], (int)w1[j], acc);
      acc = __dp4a((int)xt[8], (int)w2[j], acc);
      int v = (int)((unsigned)acc + (unsigned)bz[j]);
      if (relu && v < 0) v = 0;
      packed |= ((unsigned)requantize(v, sh[j], qmax) & 0xffu) << (8 * j);
    }
    *reinterpret_cast<unsigned*>(o + (long long)r * Wo * C) = packed;
  }
}

template <int VL>
cudaError_t launch(const void* x, const void* w, const void* shift,
                   const void* bias, void* out, int B, int H, int W, int C,
                   int Ho, int Wo, int stride, int relu, int qmax, int cb,
                   int tw, int th, cudaStream_t s) {
  const int tiles_w = (Wo + tw - 1) / tw, tiles_h = (Ho + th - 1) / th;
  const size_t smem = (size_t)((th - 1) * stride + 3)
      * ((tw - 1) * stride + 3) * cb + 9 * (size_t)cb;
  const dim3 grid((C + cb - 1) / cb, tiles_w * tiles_h, B);
  const dim3 block(cb / 4, tw);
  dwconv3x3_int8<VL><<<grid, block, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(bias),
      static_cast<int8_t*>(out), H, W, C, Ho, Wo, stride, relu, qmax, th,
      tiles_w);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] int8 NHWC, contiguous; w [3, 3, C] int8, contiguous;
// shift [C] int32; bias [C] int32 or NULL; out [B, Ho, Wo, C] int8,
// contiguous; stride 1 or 2, padding 1; qmax the clip's upper bound. C,
// cb and the bases of x, w and out multiples of vl (16, 8 or 4 bytes); cb
// at most C rounded up to vl, cb / 4 x tw threads at most 1024, the
// block's shared memory ((th - 1) stride + 3) ((tw - 1) stride + 3) cb +
// 9 cb bytes at most 48 KiB. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int dwconv_int8_launch(const void* x, const void* w,
                                  const void* shift, const void* bias,
                                  void* out, int B, int H, int W, int C,
                                  int stride, int relu, int qmax, int vl,
                                  int cb, int tw, int th, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (stride != 1 && stride != 2)
      || cb <= 0 || cb % vl || C % vl || tw <= 0 || th <= 0
      || (cb / 4) * tw > 1024
      || (size_t)((th - 1) * stride + 3) * ((tw - 1) * stride + 3) * cb
         + 9 * (size_t)cb > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vl) {
    case 16:
      return (int)launch<16>(x, w, shift, bias, out, B, H, W, C, Ho, Wo,
                             stride, relu, qmax, cb, tw, th, s);
    case 8:
      return (int)launch<8>(x, w, shift, bias, out, B, H, W, C, Ho, Wo,
                            stride, relu, qmax, cb, tw, th, s);
    case 4:
      return (int)launch<4>(x, w, shift, bias, out, B, H, W, C, Ho, Wo,
                            stride, relu, qmax, cb, tw, th, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
