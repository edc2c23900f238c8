// AIO quantizer: per-row power-of-two scale and 8-bit-or-narrower codes.
//
// Replaces the Pallas kernel aio_quant_pallas
// (src/repro/kernels/aio_quant/kernel.py). Per row m of x (M, N) float32:
//   scale[m] = pow2_ceil(max(max_n |x[m, n]|, floor) / max_finite)
//   codes[m, n] = encode(x[m, n] / scale[m])        (fp formats: RNE onto
//                 the format's grid, saturating; int formats:
//                 clip(rint(x / scale)) & mask)
// as int8 codes (M, N) and a float32 (M, 1) scale. The reference computes
// the row max in a separate pass; here the launch does it. `floor` is an
// argument: the reference kernel floors at 1e-30, quantize_scaled (the
// activation stage of a resident-weight matmul) at FLT_MIN.
//
// Non-finite inputs follow the plain version (and the reference's
// quantize_scaled): the row max carries a NaN through, and pow2_ceil of a
// NaN or infinite max is 1 (frexp reports exponent 0 for both), so such a
// row is coded at scale 1: +-inf saturates, a NaN becomes code 0 (fp: its
// sign bit alone).
//
// What bounds it on an H100: bytes (4 read + 1 written per element), with
// a few instructions an element to hide under them; at the decode width
// (M = 8, 48-280 KB) the fixed cost of a launch. The design:
// - A row is spread over a thread-block cluster of C blocks (1, 2, 4 or 8,
//   the portable sizes; set at launch with cudaLaunchKernelEx, so one
//   instance serves every C), each block a contiguous part of the row, so
//   the decode width fills the card as a 256-token chunk does. Each warp
//   reduces its max with shuffles and writes it into a slot of every block
//   of the cluster with st.async, which counts the bytes on that block's
//   mbarrier; each block waits for its own slots alone, and every warp
//   computes the same scale from them (rank 0 stores it). A cluster is
//   what makes a one-launch cross-block max safe: its blocks are resident
//   together, where blocks waiting on a last-arriver counter could wait on
//   blocks that never get an SM. A block touches a peer's shared memory
//   only after every block of the cluster has started (the arrive/wait
//   pair around the loads) and before the peer's own wait, the last thing
//   the peer waits for, so no block exits while a peer may still write
//   it. With C = 1 the launch is a plain one (a cluster launch cost ~0.3
//   us at M = 256) and the slots a __syncthreads exchange.
// - Each thread holds its values in registers (UPT 16-byte vectors, or
//   floats where N % 4 != 0) from the max to the encode: x is read once,
//   with every load in flight before the first use. The plan
//   (kernels/aio_quant/ops.py quant_plan) caps them; a row past the cap
//   takes the UPT = 0 instance, which reads its part twice.
// - The encoders are a few integer and float instructions on the IEEE
//   bits (below), not frexpf/ldexpf/division chains; four codes go out as
//   one 4-byte store.
//
// Exactness (the plain version and the reference bitwise):
// - The scale: r = max(amax, floor) / max_finite, rounded once
//   (__fdiv_rn), then 2^ceil(log2 r) from r's bits.
// - The quotient: scale = 2^k, so x / scale is x * 2^-k, and an IEEE
//   multiply by an exact power of two rounds the exact product once, to
//   nearest even, as __fdiv_rn(x, scale) rounds the exact quotient: the
//   same real number, so the same float, f32 subnormal quotients included.
//   2^-k is a float for k >= -127; a subnormal scale below that multiplies
//   by 2^64 and then by 2^(-k-64), both exact (the row's |x| <= 2^-111,
//   and every quotient ends below 2 max_finite).
// - fp formats (1 + e + m = 8 bits, bias, no specials), on a = |v|: at or
//   above the format's least normal, a + 2^(E + 23 - m) - 2^(E + 23 - m)
//   (E a's exponent, the constant built from a's bits) rounds a to m
//   mantissa bits, to nearest even, in the float adder, the carry crossing
//   into the next binade by itself; its bits shifted right by 23 - m, less
//   the rebias (127 - bias) << m, are the code. Below the least normal,
//   a * 2^(m - emin) (exact) + 2^23 in one FMA rounds to the subnormal
//   code, to nearest even, and a round-up onto the least normal gives its
//   code (2^m) by itself. Of the two the larger is the right one (the
//   normal formula undershoots below the least normal, the subnormal one
//   is clamped at 2^m above it); then saturate at the all-ones magnitude
//   (max_finite; +-inf, and the huge values whose constant overflows, too)
//   and put the sign of v on top. fmaxf(|v|, 0) turns a NaN into 0, so it
//   gives its sign bit alone.
// - Integer formats: clamp, then v + 1.5 * 2^23 rounds to an integer,
//   nearest even, in the low bits of the sum (exact for |v| <= 2^22; the
//   clamp keeps it there); a NaN gives 0.
// Built without -ftz, so float32 subnormals are kept, as the plain version
// keeps them. tests/test_torch_cuda.py holds every f32 bit pattern at scale
// 1, and every pattern of the edge binades at scales from subnormal to the
// largest, to the plain version, bitwise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_error.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;   // ops.py MAX_THREADS
constexpr int MAX_CLUSTER = 8;     // the portable cluster sizes: 1, 2, 4, 8

// the encoders' constants, from the format
struct Enc {
  // fp (8-bit: 1 + ebits + mbits = 8)
  int shift;          // 23 - mbits
  unsigned magic;     // shift << 23
  int rebias;         // (127 - bias) << mbits
  int max_mag;        // (1 << 7) - 1: max_finite's magnitude code
  float min_normal;   // 2^emin, emin = 1 - bias
  float sub_mul;      // 2^(mbits - emin)
  // integer
  float lo, hi;
  unsigned mask;
};

// max that carries a NaN through (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The row's scale 2^k = pow2_ceil(max(amax, floor) / max_finite), exact,
// from IEEE bits (down to 2^-149; a NaN or infinite quotient gives 1, as
// frexp's exponent 0 does in the plain version), and the two multipliers
// that divide by it exactly: 2^-k and 1, or 2^64 and 2^(-k-64) where 2^-k
// is past the float range (k < -127).
struct RowScale {
  float scale, mul1, mul2;
};

__device__ __forceinline__ RowScale row_scale(float amax, float floor,
                                              float max_finite) {
  const float r = __fdiv_rn(nan_max(amax, floor), max_finite);   // r > 0
  const unsigned b = __float_as_uint(r);
  int k = 0;   // ceil(log2(r))
  if (isfinite(r))
    k = b >= 0x00800000u ? (int)(b >> 23) - 127 + ((b & 0x7fffffu) != 0)
                         : 32 - __clz(b - 1) - 149;
  RowScale s;
  s.scale = __uint_as_float(k >= -126 ? (unsigned)min(k + 127, 255) << 23
                                      : 1u << (k + 149));
  const int kc = min(k, 126);
  s.mul1 = __uint_as_float(kc >= -127 ? (unsigned)(127 - kc) << 23
                                      : 191u << 23);              // 2^64
  s.mul2 = __uint_as_float(kc >= -127 ? 127u << 23
                                      : (unsigned)(63 - kc) << 23);
  return s;
}

// x / scale, rounded once (see Exactness)
__device__ __forceinline__ float quotient(float x, float mul1, float mul2) {
  return (x * mul1) * mul2;
}

// fp: the code of |v|, without its sign (a NaN: 0)
__device__ __forceinline__ unsigned fp_magnitude(float v, const Enc& e) {
  const float a = fmaxf(fabsf(v), 0.f);                  // NaN -> 0
  const unsigned ab = __float_as_uint(a);
  // 2^(E + 23 - mbits), E the exponent of a: a + it - it rounds a to
  // mbits mantissa bits, nearest even (f32 normals; the rest is the
  // subnormal code's or saturates)
  const float magic = __uint_as_float((ab & 0x7f800000u) + e.magic);
  const int n = (int)(__float_as_uint((a + magic) - magic) >> e.shift)
                - e.rebias;
  const int s = (int)__float_as_uint(fmaf(fminf(a, e.min_normal), e.sub_mul,
                                          8388608.f)) - 0x4B000000;
  return (unsigned)min(max(n, s), e.max_mag);
}

__device__ __forceinline__ unsigned int_code(float v, const Enc& e) {
  const float c = fminf(fmaxf(v, e.lo), e.hi);
  const unsigned code = __float_as_uint(c + 12582912.f) & e.mask;
  return isnan(v) ? 0u : code;
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the max over a warp of values >= 0 (or NaN), in one redux: such floats
// order as their bits do, and a NaN's bits are above +inf's
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

__device__ __forceinline__ float abs_max(float a, float v) {
  return nan_max(a, fabsf(v));
}
__device__ __forceinline__ float abs_max(float a, float4 v) {
  return nan_max(nan_max(a, nan_max(fabsf(v.x), fabsf(v.y))),
                 nan_max(fabsf(v.z), fabsf(v.w)));
}

template <bool FP>
__device__ __forceinline__ void put(int8_t* c, int i, float x, float m1,
                                    float m2, const Enc& e) {
  const float v = quotient(x, m1, m2);
  c[i] = (int8_t)(FP ? fp_magnitude(v, e) | ((__float_as_uint(v) >> 24)
                                             & 0x80u)
                     : int_code(v, e));
}
// four codes as one 4-byte store; fp: the four signs in one word (prmt's
// selector nibbles 0xB / 0xF copy the top bit of v's top byte over a byte)
template <bool FP>
__device__ __forceinline__ void put(int8_t* c, int i, float4 x, float m1,
                                    float m2, const Enc& e) {
  const float v0 = quotient(x.x, m1, m2), v1 = quotient(x.y, m1, m2);
  const float v2 = quotient(x.z, m1, m2), v3 = quotient(x.w, m1, m2);
  unsigned word;
  if constexpr (FP) {
    word = prmt(prmt(fp_magnitude(v0, e), fp_magnitude(v1, e), 0x40),
                prmt(fp_magnitude(v2, e), fp_magnitude(v3, e), 0x40), 0x5410);
    const unsigned signs =
        prmt(prmt(__float_as_uint(v0), __float_as_uint(v1), 0xFB),
             prmt(__float_as_uint(v2), __float_as_uint(v3), 0xFB), 0x5410);
    word |= signs & 0x80808080u;
  } else {
    word = prmt(prmt(int_code(v0, e), int_code(v1, e), 0x40),
                prmt(int_code(v2, e), int_code(v3, e), 0x40), 0x5410);
  }
  reinterpret_cast<unsigned*>(c)[i] = word;
}

// The cluster's exchange of partial maxima: each block's `full` mbarrier
// expects one 4-byte slot from every warp of the cluster, and a warp's
// lane r writes its max into block r's slot with st.async.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void exchange_init(unsigned long long* full,
                                              unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(full)) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(full)), "r"(bytes) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void exchange_put(float* slot,
                                             unsigned long long* full,
                                             int rank, float v) {
  unsigned dst, bar;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(dst) : "r"(smem_addr(slot)), "r"(rank));
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(bar) : "r"(smem_addr(full)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void exchange_wait(unsigned long long* full) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_addr(full)) : "memory");
}

// One block of a row's cluster: units (float4s, or floats where N % 4 !=
// 0) [rank * part, (rank + 1) * part) of the row; thread t holds units
// t + j * blockDim.x, j < UPT, in registers (UPT = 0: reads them twice).
// Every warp then reduces the cluster's slots and computes the row's scale
// itself.
template <bool VEC, int UPT, bool FP>
__global__ void __launch_bounds__(MAX_THREADS)
aio_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                 float* __restrict__ scales, int n, int part, int csize,
                 float floor, float max_finite, Enc e) {
  using Unit = std::conditional_t<VEC, float4, float>;
  constexpr int W = VEC ? 4 : 1;
  __shared__ float slots[MAX_CLUSTER * MAX_THREADS / 32];
  __shared__ __align__(8) unsigned long long full;
  const int rank = csize > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / csize;
  const int t = threadIdx.x, nt = blockDim.x, warps = nt / 32;
  const int begin = rank * part;
  const int count = max(0, min(part, n / W - begin));
  const Unit* xr = reinterpret_cast<const Unit*>(x + row * n) + begin;
  int8_t* cr = codes + row * n + (size_t)begin * W;

  // every load in flight before the first use (a use beside its guarded
  // load made each load wait for the one before), and before the exchange's
  // set-up, whose fence would hold them back; read once, so evict first
  Unit r[UPT > 0 ? UPT : 1];
  if constexpr (UPT > 0) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int i = t + j * nt;
      r[j] = i < count ? __ldcs(xr + i) : Unit{};
    }
  }
  if (csize > 1) {
    if (t == 0) exchange_init(&full, 4u * csize * warps);
    // this block's mbarrier is ready: peers may write its slots once
    // every block of the cluster has arrived here
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  float amax = 0.f;
  if constexpr (UPT > 0) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) amax = abs_max(amax, r[j]);
  } else {
    for (int i = t; i < count; i += nt) amax = abs_max(amax, xr[i]);
  }
  amax = warp_max(amax);
  const int lane = t & 31;
  if (csize > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (lane < csize)
      exchange_put(&slots[rank * warps + (t >> 5)], &full, lane, amax);
    exchange_wait(&full);   // every warp's max is in this block's slots
  } else {
    if (lane == 0) slots[t >> 5] = amax;
    __syncthreads();
  }
  float m = 0.f;
  for (int i = lane; i < csize * warps; i += 32) m = nan_max(m, slots[i]);
  m = warp_max(m);
  const RowScale s = row_scale(m, floor, max_finite);
  if (rank == 0 && t == 0) scales[row] = s.scale;

  if constexpr (UPT > 0) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int i = t + j * nt;
      if (i < count) put<FP>(cr, i, r[j], s.mul1, s.mul2, e);
    }
  } else {
    for (int i = t; i < count; i += nt)
      put<FP>(cr, i, xr[i], s.mul1, s.mul2, e);
  }
}

struct Launch {
  const float* x;
  int8_t* codes;
  float* scales;
  int m, n, part, cluster, threads;
  float floor, max_finite;
  Enc e;
  cudaStream_t stream;
};

template <bool VEC, int UPT, bool FP>
cudaError_t launch(const Launch& l) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(l.m * l.cluster));
  cfg.blockDim = dim3((unsigned)l.threads);
  cfg.stream = l.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = l.cluster > 1 ? 1 : 0;   // a cluster launch costs ~0.3 us
  return cudaLaunchKernelEx(&cfg, aio_quant_kernel<VEC, UPT, FP>, l.x,
                            l.codes, l.scales, l.n, l.part, l.cluster,
                            l.floor, l.max_finite, l.e);
}

template <bool VEC, bool FP>
cudaError_t launch_upt(int upt, const Launch& l) {
  switch (upt) {
    case 0: return launch<VEC, 0, FP>(l);
    case 1: return launch<VEC, 1, FP>(l);
    case 2: return launch<VEC, 2, FP>(l);
    case 4: return launch<VEC, 4, FP>(l);
    case 8: return launch<VEC, 8, FP>(l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, N) float32 contiguous -> codes (M, N) int8, scales (M,) float32,
// launched as `cluster` blocks of `threads` a row, each thread holding
// `vals` values (0: the re-read path); the plan is
// kernels/aio_quant/ops.py quant_plan's. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int aio_quant(const void* x, void* codes, void* scales, int M,
                         int N, float floor, int is_fp, int ebits, int mbits,
                         int bias, float max_finite, int int_min, int int_max,
                         int mask, int cluster, int threads, int vals,
                         void* stream) {
  const bool vec = N % 4 == 0;   // rows stay 16-byte aligned
  const int w = vec ? 4 : 1;
  const int units = N / w;
  const int upt = vals / w;
  const bool ok_cluster = cluster == 1 || cluster == 2 || cluster == 4
                          || cluster == 8;
  if (!ok_cluster || threads < 32 || threads > MAX_THREADS || threads % 32
      || vals % w || (long long)M * cluster > 0x7fffffffLL
      || (is_fp && ebits + mbits != 7))
    return (int)cudaErrorInvalidValue;
  const int part = (units + cluster - 1) / cluster;
  if (upt > 0 && (long long)threads * upt < part)
    return (int)cudaErrorInvalidValue;
  Enc e{};
  if (is_fp) {
    const int emin = 1 - bias;
    e.shift = 23 - mbits;
    e.magic = (unsigned)e.shift << 23;
    e.rebias = (127 - bias) << mbits;
    e.max_mag = (1 << (ebits + mbits)) - 1;
    e.min_normal = ldexpf(1.f, emin);
    e.sub_mul = ldexpf(1.f, mbits - emin);
  } else {
    e.lo = (float)int_min;
    e.hi = (float)int_max;
    e.mask = (unsigned)mask;
  }
  const Launch l{(const float*)x, (int8_t*)codes, (float*)scales, M, N, part,
                 cluster, threads, floor, max_finite, e,
                 (cudaStream_t)stream};
  cudaError_t err;
  if (vec)
    err = is_fp ? launch_upt<true, true>(upt, l)
                : launch_upt<true, false>(upt, l);
  else
    err = is_fp ? launch_upt<false, true>(upt, l)
                : launch_upt<false, false>(upt, l);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
