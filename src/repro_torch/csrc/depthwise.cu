// Depthwise convolution, stride 1, SAME padding, NHWC:
// out[n, h, w, c] = sum_dh sum_dw xpad[n, h + dh, w + dw, c] * f[dh, dw, c]
// for x (N, H, W, C) and f (kh, kw, C), where xpad is x with ph = (kh-1)/2
// zero rows before and kh-1-ph after, and pw = (kw-1)/2 zero columns
// before and kw-1-pw after.
//
// Replaces the Pallas kernel depthwise_pallas (_dw_kernel,
// src/repro/kernels/depthwise/kernel.py), which reads a pre-shifted tap
// stack (kh, N, H, W_pad, C) that its caller builds in memory; here the
// kernel pads in its loads (an out-of-range tap reads the value 0) and no
// padded copy or tap stack exists. The arithmetic is the reference's, in
// its order: an f32 sum from 0, taps dh outer, dw inner, each product
// rounded, then added (__fmul_rn / __fadd_rn keep nvcc from contracting
// them into FMAs), so the kernel is bitwise equal to a plain version that
// does the same adds in the same order. A bf16 input multiplies in bf16 as
// the reference does (the exact product of two bf16 values rounded once to
// bf16) and adds in f32; the output has x's type.
//
// What bounds it on an H100: bytes. kh x kw multiply-adds per output
// element against 4 bytes in and 4 out (f32): 2 x 49 flops per 8 bytes at
// 7 x 7, far below the ~20 flops per byte where f32 FMA would bound it.
//
// Design: one thread per output element, channels fastest, so a warp's
// loads of one tap are 32 neighbouring channels (coalesced); the kh x kw
// re-reads of each input element come from L1/L2, not device memory. No
// shared-memory halo tiles yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the product as the reference's type computes it
__device__ __forceinline__ float product(float a, float b, float) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float product(float a, float b, __nv_bfloat16) {
  // exact in f32 (two 8-bit significands), then rounded once to bf16
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <class E>
__global__ void __launch_bounds__(NT)
    depthwise_kernel(const E* __restrict__ x, const E* __restrict__ f,
                     E* __restrict__ out, long total, int H, int W, int C,
                     int kh, int kw) {
  const long idx = (long)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long rest = idx / C;
  const int w = (int)(rest % W);
  rest /= W;
  const int h = (int)(rest % H);
  const long n = rest / H;
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const E* xn = x + n * H * W * C;
  float acc = 0.f;
  for (int dh = 0; dh < kh; ++dh) {
    const int y = h + dh - ph;
    const bool row_in = y >= 0 && y < H;
    for (int dw = 0; dw < kw; ++dw) {
      const int xc = w + dw - pw;
      const float xv = row_in && xc >= 0 && xc < W
                           ? widen(xn[((long)y * W + xc) * C + c])
                           : 0.f;
      const float fv = widen(f[(dh * kw + dw) * C + c]);
      acc = __fadd_rn(acc, product(xv, fv, E()));
    }
  }
  put(out + idx, acc);
}

template <class E>
int launch(const void* x, const void* f, void* out, int N, int H, int W,
           int C, int kh, int kw, cudaStream_t stream) {
  const long total = (long)N * H * W * C;
  const long blocks = (total + NT - 1) / NT;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  depthwise_kernel<E><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(f),
      static_cast<E*>(out), total, H, W, C, kh, kw);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) contiguous, f: (kh, kw, C) contiguous, out: (N, H, W, C)
// contiguous, all f32 (bf16 = 0) or all bf16 (1). Returns cudaError_t.
extern "C" int depthwise_conv(int bf16, const void* x, const void* f,
                              void* out, int N, int H, int W, int C, int kh,
                              int kw, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, f, out, N, H, W, C, kh, kw, s)
              : launch<float>(x, f, out, N, H, W, C, kh, kw, s);
}
