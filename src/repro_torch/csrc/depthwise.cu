// Depthwise convolution, stride 1, SAME padding, NHWC:
// out[n, h, w, c] = sum_dh sum_dw xpad[n, h + dh, w + dw, c] * f[dh, dw, c]
// for x (N, H, W, C) and f (kh, kw, C), where xpad is x with ph = (kh-1)/2
// zero rows before and kh-1-ph after, and pw = (kw-1)/2 zero columns
// before and kw-1-pw after.
//
// Replaces the Pallas kernel depthwise_pallas (_dw_kernel,
// src/repro/kernels/depthwise/kernel.py), which reads a pre-shifted tap
// stack (kh, N, H, W_pad, C) that its caller builds in memory; here the
// padding is zero-fill at the edges of a shared-memory tile and no padded
// copy or tap stack exists. The arithmetic is the reference's, in its
// order: for each output, an f32 sum from 0, taps dh outer, dw inner, each
// product rounded, then added (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into FMAs), so the kernel is bitwise equal to a plain
// version that does the same adds in the same order. A bf16 input
// multiplies in bf16 as the reference does (the exact product of two bf16
// values rounded once to bf16) and adds in f32; the output has x's type.
//
// What bounds it on an H100: bytes at 3 x 3 (4 bytes in and 4 out per f32
// output against 9 products), issue slots at 7 x 7: the bitwise order
// forbids FMA, so each tap is two f32 instructions, and 2 x 49 of them per
// output over the 33.5 T non-FMA f32 instructions a second exceed the
// bytes' time.
//
// Design: a block computes a TH x TW tile of outputs over CV 16-byte
// channel vectors (4 f32 or 8 bf16 channels each). It first stages its
// halo, (TH + kh - 1) x (TW + kw - 1) pixels x CV vectors, and the filter
// taps of its channels in shared memory with cp.async (16-byte copies;
// pixels outside the image are zero-filled, which is the SAME padding),
// so each input is read from L2 once per block, not kh x kw times. A
// thread owns OW = 4 neighbouring outputs along W of one channel vector:
// for each filter row it walks the OW + kw - 1 inputs of its window once,
// each loaded from shared memory once and fed to every output that takes
// it (kw a template constant up to 7, so the window is registers), and it
// stores each output as one 16-byte streaming store. C not a multiple of
// the vector width is staged and stored element by element (a zero-filled
// channel tail). The tile shape is chosen from the shapes so that the grid
// gives every SM several blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cuda_error.cuh"

namespace {

constexpr int OW = 4;             // outputs along W per thread
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 96 * 1024;
// the tile plan (make_plan): up to PLAN_CV_MAX channel vectors a block,
// and at least PLAN_BLOCKS blocks per SM, made by cutting the channels per
// block down to PLAN_CV_MIN vectors, then the rows (constants swept on an
// H100)
constexpr int PLAN_BLOCKS = 4;
constexpr int PLAN_CV_MIN = 8;
constexpr int PLAN_CV_MAX = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// A 16-byte vector of E widened to VEC floats (bf16 -> f32 is exact).
template <class E>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float product(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // exact in f32 (two 8-bit significands), then rounded once to bf16
  static __device__ __forceinline__ float product(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The tile geometry of a launch: CV channel vectors, SW strips of OW
// outputs along W, TH rows; the grid (W tiles x C tiles, H tiles, N).
struct Plan {
  int cv, sw, th, wt, ht, ct;
  __host__ __device__ int tw() const { return sw * OW; }
  __host__ __device__ int threads() const { return cv * sw * th; }
};

// Stage a (rows x wc pixels x cv vectors) tile into dst, [row][col][v]:
// `src(y, xc, c, in)` gives the global address of the vector at tile row y,
// column xc, first channel c, and whether it lies inside the image and the
// channels. A thread keeps one channel vector v and steps over the pixels,
// so no index is divided per vector. Vector path: 16-byte cp.async,
// zero-filled outside (the source is then `base`, never read); element
// path (C not a multiple of the vector): element loads, zeros outside.
template <class E, class Src>
__device__ __forceinline__ void stage(uint4* dst, int rows, int wc, int cv,
                                      int c_blk, bool vec, int C,
                                      const E* base, Src src) {
  constexpr int V = Vec<E>::N;
  const int v = threadIdx.x % cv, step = blockDim.x / cv;
  const int c = c_blk + v * V;
  int p = threadIdx.x / cv, y = p / wc, xc = p % wc;
  const int sy = step / wc, sx = step % wc;
  for (; y < rows; p += step) {
    bool in;
    const E* ptr = src(y, xc, c, in);
    in = in && c < C;
    if (vec) {
      cp_async16(dst + p * cv + v, in ? ptr : base, in ? 16 : 0);
    } else {
      __align__(16) E e[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        e[k] = in && c + k < C ? ptr[k] : E(0.f);
      dst[p * cv + v] = *reinterpret_cast<const uint4*>(e);
    }
    y += sy;
    xc += sx;
    if (xc >= wc) xc -= wc, ++y;
  }
}

template <class E, int KW>
__global__ void __launch_bounds__(MAX_THREADS)
    depthwise_kernel(const E* __restrict__ x, const E* __restrict__ f,
                     E* __restrict__ out, int H, int W, int C, int kh,
                     int kw_rt, Plan pl) {
  using VE = Vec<E>;
  constexpr int V = VE::N;
  const int kw = KW > 0 ? KW : kw_rt;
  extern __shared__ uint4 smem[];
  const int cb = blockIdx.x % pl.ct, wb = blockIdx.x / pl.ct;
  const int h0 = blockIdx.y * pl.th, w0 = wb * pl.tw(), n = blockIdx.z;
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int hr = pl.th + kh - 1, wc = pl.tw() + kw - 1;
  const bool vec = C % V == 0;
  const int c_blk = cb * pl.cv * V;
  uint4* halo = smem;                          // [hr][wc][cv]
  uint4* filt = smem + hr * wc * pl.cv;        // [kh][kw][cv]
  const E* xn = x + (long)n * H * W * C;

  stage<E>(halo, hr, wc, pl.cv, c_blk, vec, C, x,
           [&](int y, int xc, int c, bool& in) {
             y += h0 - ph;
             xc += w0 - pw;
             in = y >= 0 && y < H && xc >= 0 && xc < W;
             return xn + ((long)y * W + xc) * C + c;
           });
  stage<E>(filt, kh, kw, pl.cv, c_blk, vec, C, f,
           [&](int dh, int dw, int c, bool& in) {
             in = true;
             return f + (long)(dh * kw + dw) * C + c;
           });
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();

  const int t = threadIdx.x, v = t % pl.cv, s = (t / pl.cv) % pl.sw,
            r = t / (pl.cv * pl.sw);
  const int h = h0 + r, wo = w0 + s * OW, c0 = c_blk + v * V;
  if (h >= H || c0 >= C) return;

  float acc[OW][V];
#pragma unroll
  for (int o = 0; o < OW; ++o)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[o][k] = 0.f;
  for (int dh = 0; dh < kh; ++dh) {
    const uint4* row = halo + ((r + dh) * wc + s * OW) * pl.cv + v;
    const uint4* frow = filt + dh * kw * pl.cv + v;
    if constexpr (KW > 0) {
      // input j of the window feeds output o through tap dw = j - o; for
      // each output the taps arrive in dw order
      float fw[KW][V];
#pragma unroll
      for (int dw = 0; dw < KW; ++dw) VE::widen(frow[dw * pl.cv], fw[dw]);
#pragma unroll
      for (int j = 0; j < OW + KW - 1; ++j) {
        float xv[V];
        VE::widen(row[j * pl.cv], xv);
#pragma unroll
        for (int o = 0; o < OW; ++o) {
          const int dw = j - o;
          if (dw >= 0 && dw < KW) {
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc[o][k] =
                  __fadd_rn(acc[o][k], VE::product(xv[k], fw[dw][k]));
          }
        }
      }
    } else {
      for (int dw = 0; dw < kw; ++dw) {
        float fv[V];
        VE::widen(frow[dw * pl.cv], fv);
#pragma unroll
        for (int o = 0; o < OW; ++o) {
          float xv[V];
          VE::widen(row[(o + dw) * pl.cv], xv);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[o][k] = __fadd_rn(acc[o][k], VE::product(xv[k], fv[k]));
        }
      }
    }
  }

  E* on = out + (((long)n * H + h) * W) * C;
#pragma unroll
  for (int o = 0; o < OW; ++o) {
    const int w = wo + o;
    if (w >= W) break;
    E* p = on + (long)w * C + c0;
    if (vec) {  // a streaming store: the outputs are not read again here
      __stcs(reinterpret_cast<uint4*>(p), VE::narrow(acc[o]));
    } else {
      for (int k = 0; k < V && c0 + k < C; ++k) put(p + k, acc[o][k]);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

size_t smem_bytes(const Plan& p, int kh, int kw) {
  return 16 * (size_t)p.cv *
         ((size_t)(p.th + kh - 1) * (p.tw() + kw - 1) + (size_t)kh * kw);
}

// the least-waste count in [lo, hi] of units to cover n (ties: the larger)
int least_waste(int n, int lo, int hi) {
  int best = hi, waste = 1 << 30;
  for (int d = hi; d >= lo; --d) {
    const int wd = ceil_div(n, d) * d - n;
    if (wd < waste) waste = wd, best = d;
  }
  return best;
}

// The tile shape: strips covering W with the least waste up to 16
// columns; all the channel vectors up to PLAN_CV_MAX (above it, the count
// in [PLAN_CV_MAX / 2, PLAN_CV_MAX] that wastes the fewest) and 8 rows;
// then fewer channel
// vectors (down to PLAN_CV_MIN), then fewer rows, until there are
// PLAN_BLOCKS blocks an SM; within 256 threads and MAX_SMEM.
Plan make_plan(int N, int H, int W, int C, int kh, int kw, int vec,
               int sms) {
  Plan p;
  const int cvt = ceil_div(C, vec);
  p.sw = 1;
  for (int sw = std::min(16 / OW, ceil_div(W, OW)), waste = 1 << 30; sw >= 1;
       --sw) {
    const int wd = ceil_div(W, sw * OW) * sw * OW - W;
    if (wd < waste) waste = wd, p.sw = sw;
  }
  p.cv = cvt <= PLAN_CV_MAX
             ? cvt
             : least_waste(cvt, PLAN_CV_MAX / 2, PLAN_CV_MAX);
  p.th = 8;
  while (p.th > 1 && p.th / 2 >= H) p.th /= 2;
  auto tiles = [&](const Plan& q) {
    return (long)N * ceil_div(H, q.th) * ceil_div(W, q.tw()) *
           ceil_div(cvt, q.cv);
  };
  const long target = (long)PLAN_BLOCKS * sms;
  while (p.cv > PLAN_CV_MIN && tiles(p) < target)
    p.cv = std::max(PLAN_CV_MIN, p.cv / 2);
  while (p.th > 1 && tiles(p) < target) p.th /= 2;
  auto fits = [&](const Plan& q) {
    return q.threads() <= MAX_THREADS && smem_bytes(q, kh, kw) <= MAX_SMEM;
  };
  while (p.th > 1 && !fits(p)) p.th /= 2;
  while (p.sw > 1 && !fits(p)) p.sw /= 2;
  while (p.cv > 1 && !fits(p)) p.cv = ceil_div(p.cv, 2);
  p.ht = ceil_div(H, p.th);
  p.wt = ceil_div(W, p.tw());
  p.ct = ceil_div(cvt, p.cv);
  return p;
}

template <class E, int KW>
int launch_kw(const E* x, const E* f, E* out, int N, int H, int W, int C,
              int kh, int kw, const Plan& p, size_t smem,
              cudaStream_t stream) {
  auto kern = depthwise_kernel<E, KW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)p.wt * p.ct, p.ht, N);
  kern<<<grid, p.threads(), smem, stream>>>(x, f, out, H, W, C, kh, kw, p);
  return (int)cudaGetLastError();
}

template <class E>
int launch(const void* xv, const void* fv, void* ov, int N, int H, int W,
           int C, int kh, int kw, cudaStream_t stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Plan p = make_plan(N, H, W, C, kh, kw, Vec<E>::N, sms);
  const size_t smem = smem_bytes(p, kh, kw);
  if (smem > MAX_SMEM || (long)p.wt * p.ct > 0x7fffffffL || p.ht > 65535 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  const E* x = static_cast<const E*>(xv);
  const E* f = static_cast<const E*>(fv);
  E* out = static_cast<E*>(ov);
  switch (kw) {
    case 1:
      return launch_kw<E, 1>(x, f, out, N, H, W, C, kh, kw, p, smem, stream);
    case 3:
      return launch_kw<E, 3>(x, f, out, N, H, W, C, kh, kw, p, smem, stream);
    case 5:
      return launch_kw<E, 5>(x, f, out, N, H, W, C, kh, kw, p, smem, stream);
    case 7:
      return launch_kw<E, 7>(x, f, out, N, H, W, C, kh, kw, p, smem, stream);
    default:
      return launch_kw<E, 0>(x, f, out, N, H, W, C, kh, kw, p, smem, stream);
  }
}

}  // namespace

// x: (N, H, W, C) contiguous, f: (kh, kw, C) contiguous, out: (N, H, W, C)
// contiguous, all 16-byte aligned, all f32 (bf16 = 0) or all bf16 (1).
// Returns cudaError_t.
extern "C" int depthwise_conv(int bf16, const void* x, const void* f,
                              void* out, int N, int H, int W, int C, int kh,
                              int kw, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, f, out, N, H, W, C, kh, kw, s)
              : launch<float>(x, f, out, N, H, W, C, kh, kw, s);
}
