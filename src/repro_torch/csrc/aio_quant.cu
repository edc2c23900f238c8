// AIO quantizer: per-row power-of-two scale and 8-bit-or-narrower codes.
//
// Replaces the Pallas kernel aio_quant_pallas
// (src/repro/kernels/aio_quant/kernel.py). Per row m of x (M, N) float32:
//   scale[m] = pow2_ceil(max(max_n |x[m, n]|, floor) / max_finite)
//   codes[m, n] = encode(x[m, n] / scale[m])        (fp formats: RNE onto
//                 the format's grid, saturating; int formats:
//                 clip(rint(x / scale)) & mask)
// as int8 codes (M, N) and a float32 (M, 1) scale. The reference computes
// the row max in a separate pass; here the block does it. `floor` is an
// argument: the reference kernel floors at 1e-30, quantize_scaled (the
// activation stage of a resident-weight matmul) at FLT_MIN.
//
// Non-finite inputs follow the plain version (and the reference's
// quantize_scaled): the row max carries a NaN through, and pow2_ceil of a
// NaN or infinite max is 1 (frexp reports exponent 0 for both), so such a
// row is coded at scale 1: +-inf saturates, a NaN becomes code 0 (fp: its
// sign bit alone).
//
// Exactness: every power of two is exact — pow2_ceil is assembled from
// IEEE bits, scaling uses ldexpf (exact, 0 ulp), rounding is rintf (half
// to even), and x is DIVIDED by the scale (__fdiv_rn), never multiplied by
// its inverse (which differs at the format's subnormal edge). Built
// without -ftz, so float32 subnormals are kept, as the plain version keeps
// them.
//
// What bounds it on an H100: bytes (4 read + 1 written per element, a few
// integer and float operations each). Design: one 256-thread block per
// row; pass 1 reduces the row max (warp shuffles, then shared memory),
// pass 2 re-reads the row (L1/L2-resident) and writes its codes, four at a
// time where N allows 16-byte loads. At the decode width (M = 8) only 8
// blocks run: splitting long rows across blocks is a later step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace {

constexpr int THREADS = 256;

struct Fmt {
  int is_fp;       // 1: fp [sign | e | m] without specials; 0: integer
  int ebits, mbits, bias;
  float max_finite;
  float int_min, int_max;
  int mask;        // (1 << bits) - 1 for integer formats
};

// max that carries a NaN through (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// exact 2^ceil(log2(r)) for positive r, from IEEE bits (down to 2^-149)
__device__ __forceinline__ float pow2_ceil(float r) {
  if (!isfinite(r)) return 1.f;   // frexp's exponent 0, as the plain version
  int e2;
  const float frac = frexpf(r, &e2);
  const int e = frac == 0.5f ? e2 - 1 : e2;
  unsigned bits;
  if (e >= -126) {
    const int f = min(e + 127, 255);
    bits = (unsigned)f << 23;
  } else {
    bits = 1u << max(e + 149, 0);
  }
  return __uint_as_float(bits);
}

// round-to-nearest-even encode onto an fp format without specials,
// saturating at max_finite (the reference's encode / encode_fp_code)
__device__ __forceinline__ int encode_fp(float v, const Fmt& f) {
  const int sign_bit = (signbit(v) ? 1 : 0) << (f.ebits + f.mbits);
  const float a = fabsf(v);
  if (a == 0.f || isnan(a)) return sign_bit;
  const int emin = 1 - f.bias;
  const float min_sub = ldexpf(1.f, emin - f.mbits);
  int e2;
  frexpf(fmaxf(a, min_sub), &e2);
  const int step = max(e2 - 1, emin) - f.mbits;
  float q = ldexpf(rintf(ldexpf(a, -step)), step);
  q = fminf(q, f.max_finite);
  // the exponent after rounding (it may cross a binade)
  frexpf(fmaxf(q, min_sub), &e2);
  const int ebq = max(e2 - 1, emin);
  if (q >= ldexpf(1.f, emin)) {
    const int m = (int)rintf(ldexpf(q, f.mbits - ebq)) - (1 << f.mbits);
    return sign_bit | ((ebq + f.bias) << f.mbits) | m;
  }
  return sign_bit | (int)rintf(ldexpf(q, f.mbits - emin));
}

__device__ __forceinline__ int8_t encode(float x, float scale, const Fmt& f) {
  const float v = __fdiv_rn(x, scale);
  if (f.is_fp) return (int8_t)encode_fp(v, f);
  if (isnan(v)) return 0;
  const float r = fminf(fmaxf(rintf(v), f.int_min), f.int_max);
  return (int8_t)((int)r & f.mask);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
aio_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                 float* __restrict__ scales, int N, float floor, Fmt f) {
  __shared__ float warp_max[THREADS / 32];
  __shared__ float row_scale;
  const size_t row = blockIdx.x;
  const float* xr = x + row * N;
  int8_t* cr = codes + row * N;

  float amax = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < N / 4; i += THREADS) {
      const float4 v = x4[i];
      amax = nan_max(amax, nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                                   nan_max(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = threadIdx.x; i < N; i += THREADS)
      amax = nan_max(amax, fabsf(xr[i]));
  }
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < THREADS / 32; ++w) m = nan_max(m, warp_max[w]);
    row_scale = pow2_ceil(__fdiv_rn(nan_max(m, floor), f.max_finite));
    scales[row] = row_scale;
  }
  __syncthreads();
  const float scale = row_scale;

  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* c4 = reinterpret_cast<char4*>(cr);
    for (int i = threadIdx.x; i < N / 4; i += THREADS) {
      const float4 v = x4[i];
      c4[i] = make_char4(encode(v.x, scale, f), encode(v.y, scale, f),
                         encode(v.z, scale, f), encode(v.w, scale, f));
    }
  } else {
    for (int i = threadIdx.x; i < N; i += THREADS)
      cr[i] = encode(xr[i], scale, f);
  }
}

}  // namespace

// x (M, N) float32 contiguous -> codes (M, N) int8, scales (M,) float32.
// Returns the launch's cudaError_t.
extern "C" int aio_quant(const void* x, void* codes, void* scales, int M,
                         int N, float floor, int is_fp, int ebits, int mbits,
                         int bias, float max_finite, int int_min, int int_max,
                         int mask, void* stream) {
  const Fmt f{is_fp, ebits, mbits, bias, max_finite, (float)int_min,
              (float)int_max, mask};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 4 == 0;   // rows stay 16-byte aligned
  if (vec)
    aio_quant_kernel<true><<<M, THREADS, 0, s>>>(
        (const float*)x, (int8_t*)codes, (float*)scales, N, floor, f);
  else
    aio_quant_kernel<false><<<M, THREADS, 0, s>>>(
        (const float*)x, (int8_t*)codes, (float*)scales, N, floor, f);
  return (int)cudaGetLastError();
}
