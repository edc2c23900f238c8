// AIO multi-format GEMM: out (M, N) f32 = ((float)(x . w) * xs[m]) * ws[n]
// over codes in five modes.
//
// Replaces the Pallas kernel aio_matmul_pallas (_mm_kernel, unpack_x,
// unpack_w; src/repro/kernels/aio_matmul/kernel.py). Modes and operands
// (x row-major (M, K), w row-major (K, N), both contiguous):
//   bf16  x, w bf16; f32 accumulation; no scales.
//   fp8   x, w int8 fp8a/fp8b codes, decoded exactly to bf16 (every fp8a /
//         fp8b value is a bf16 value); bf16 MMA, f32 accumulation. The
//         repo's fp8a (max 480) and fp8b (max 114688) do not fit Hopper's
//         native e4m3fn/e5m2, so codes are never cast to native fp8.
//   int8  x, w int8; int32 accumulation.
//   int4  w packed two codes per byte along K ((K+1)/2 rows; low nibble =
//         even k, sign-extended; an odd K ends in a phantom nibble, which
//         meets x's zero fill past K); x one int4 code per byte (low
//         nibble, as the quantizer writes it). Both unpacked to int8 in
//         shared memory; int8 MMA, int32 accumulation.
// Epilogue ((float)acc * xs[m]) * ws[n] in f32, in that order (scales
// optional in bf16 mode). Integer modes are exact, so they equal the
// reference bitwise.
//
// What bounds it on an H100: at the decode width (M = 8) bytes: every
// weight byte is read once (int4 gate/up 6.9 MB, 2 us at 3.35 TB/s) for
// 2 M operations per weight element. At the chunk width (M = 256) the
// weight is still read from HBM once, but the block tiles re-read x and w
// from L2 and the fp8/int4 tiles must be decoded on chip, so the L2 traffic
// and the decode work, not the tensor cores, set the pace.
//
// Design (one template for every M; 256 threads = 8 warps):
// - Block tile BM x BN: BN (64 or 128) is part of the launch plan, a
//   function of (K, N, mode) alone (`gemm_plan` in kernels/aio_matmul/
//   kernel.py); M only chooses how many 16-row MMA tiles a block holds
//   (BM = 16, 32 or 64), and MMA tiles wholly past M are skipped.
// - Split K: the plan cuts K into `slices` ranges of whole K tiles, one
//   block per (tile, slice), so the down projection (K 8960, N 1536) and
//   the narrow projections fill the 132 SMs at both widths. The slices'
//   partial tiles are summed in index order by the tile's last block
//   (splitk.cuh): deterministic, no float atomics.
// - Staging: a ring of NS stages in dynamic shared memory (as many as fit
//   in 100 KB with the decoded tiles, two blocks an SM), filled by
//   cp.async.cg 16-byte copies (zero fill at ragged edges; a synchronous
//   byte path where an operand's rows are not 16-byte aligned). A stage
//   holds 64 K values of every x row (128 in the integer modes) and the
//   matching w rows: four MMA k-steps between barriers.
// - Decode once per staged tile per block: fp8 codes are decoded to bf16
//   by all 256 threads (an exact shift and a bf16x2 multiply by a power of
//   two, two codes an instruction, no table), int4 x codes sign-extended
//   in place, and the s8 weight tile transposed to [n][k] as 8 x 4 byte
//   blocks (prmt, 8-byte stores; the raw tile's 16-byte chunks are
//   XOR-swizzled so the reads are conflict-free); int4 nibbles unpack to
//   s8 in the same pass. bf16 needs no pass: w stays [k][n] as it arrives
//   and is read with ldmatrix.trans.
// - Tensor cores: ldmatrix + mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8
//   -> s32); a warp owns (BM / WM) x (BN / WN) of the tile. Not wgmma: at
//   these shapes the tensor cores are not the bound (above), and wgmma's
//   descriptor layouts would be a second set per mode. A second decode
//   buffer, so that one tile is decoded while the MMAs run on the last,
//   measured no faster on the card and is not kept.
//
// The order of a row's K reduction depends on (K, N, mode) only, never on
// M: a slice's K tiles in increasing order, within a tile the MMA k-steps
// in increasing order, each output element accumulated by one MMA chain
// from zero; then the slices summed in index order; then the epilogue. So
// a row's result is bitwise the same at the decode and the chunk width.
// Ragged M, N and K are masked in the kernel; no operand is padded or
// copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_error.cuh"
#include "splitk.cuh"

namespace {

enum Mode { BF16 = 0, FP8 = 1, INT8 = 2, INT4 = 3 };

constexpr int THREADS = 256;

template <int MODE, int MT, int BN>
struct Cfg {
  static constexpr bool kInt = MODE == INT8 || MODE == INT4;
  static constexpr int BM = 16 * MT;
  static constexpr int XRB = MODE == FP8 ? 64 : 128;  // x bytes a row a stage
  static constexpr int BK = MODE == BF16 ? XRB / 2 : XRB;  // K values a stage
  static constexpr int AB = 128;                      // A row bytes (MMA)
  static constexpr int AROW = AB + 16;                // conflict-free stride
  static constexpr int KSTEPS = AB / 32;              // MMA k-steps a stage
  // B in the MMA layout: s8 [n][k] (K-major), 16-bit [k][n] (N-major)
  static constexpr int BROW = kInt ? BK + 16 : 2 * BN + 16;
  static constexpr int WROWS = MODE == INT4 ? BK / 2 : BK;  // raw w rows
  static constexpr int WRB = MODE == BF16 ? 2 * BN : BN;    // raw w row bytes
  static constexpr int XST = BM * (MODE == FP8 ? XRB : AROW);
  static constexpr int WST = MODE == BF16 ? BK * BROW : WROWS * WRB;
  static constexpr int STAGE = XST + WST;
  static constexpr int ADEC = MODE == FP8 ? BM * AROW : 0;
  static constexpr int BDEC = MODE == BF16 ? 0 : (kInt ? BN : BK) * BROW;
  // ring depth: as many stages as fit in 100 KB (two blocks an SM), <= 8
  static constexpr int NS_FIT = (100 * 1024 - ADEC - BDEC) / STAGE;
  static constexpr int NS = NS_FIT > 8 ? 8 : NS_FIT;
  static_assert(NS >= 3, "the ring needs three stages");
  static constexpr int SMEM = NS * STAGE + ADEC + BDEC;
  // warps: WM along M x WN along N; each owns WMT 16-row x NTW 8-col tiles
  static constexpr int WM = MT == 1 ? 1 : 2;
  static constexpr int WN = 8 / WM;
  static constexpr int WMT = MT / WM;
  static constexpr int NTW = BN / WN / 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes at byte column cb of row r of a row-major byte matrix (nrows
// rows of rowb bytes) into shared memory, zero outside it: cp.async when
// the rows are 16-byte aligned (vec), else byte loads and one store.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* base,
                                       long long r, long long nrows,
                                       long long cb, long long rowb,
                                       bool vec) {
  const bool in = r < nrows && cb < rowb;
  const uint8_t* p = in ? base + r * rowb + cb : base;
  if (vec) {
    const long long left = in ? rowb - cb : 0;
    cp_async16(dst, p, left >= 16 ? 16 : (int)left);
    return;
  }
  uint32_t v[4] = {0, 0, 0, 0};
  if (in) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (cb + i < rowb) v[i >> 2] |= (uint32_t)p[i] << ((i & 3) * 8);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// sign-extend the low nibble of each byte of a word
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  const uint32_t lo = v & 0x0f0f0f0fu;
  return lo | (((lo & 0x08080808u) >> 3) * 0xf0u);
}

// two fp8 codes (no specials, 7 magnitude bits), one in the low byte of
// each 16-bit lane of p -> their bf16 values: the magnitude bits placed
// under the bf16 exponent field (shift = 7 - mantissa bits) and both
// lanes multiplied by 2^(127 - bias) (exact: a subnormal code is a bf16
// subnormal, scaled to a normal value without flushing), then the signs
__device__ __forceinline__ uint32_t fp8x2_to_bf16(uint32_t p, int shift,
                                                  __nv_bfloat162 scale) {
  uint32_t mag = (p & 0x007f007fu) << shift;
  const __nv_bfloat162 v =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&mag), scale);
  return *reinterpret_cast<const uint32_t*>(&v) | ((p & 0x00800080u) << 8);
}

// four codes of a word -> four bf16 (two words, lowest code first)
__device__ __forceinline__ uint2 fp8x4_to_bf16(uint32_t v, int shift,
                                               __nv_bfloat162 scale) {
  return make_uint2(fp8x2_to_bf16(__byte_perm(v, 0, 0x4140), shift, scale),
                    fp8x2_to_bf16(__byte_perm(v, 0, 0x4342), shift, scale));
}

// transpose a 4 x 4 byte block: v[r] byte c -> o[c] byte r
__device__ __forceinline__ void transpose4(const uint32_t* v, uint32_t* o) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 consecutive partials at p of which `valid` exist (L2 loads: other
// blocks wrote them), zero past them; one 16-byte load when vec
template <class T>
__device__ __forceinline__ void ld4cg(T* v, const T* p, int valid, bool vec) {
  if (vec && valid >= 4) {
    using V4 = typename std::conditional<std::is_same<T, int>::value, int4,
                                         float4>::type;
    const V4 u = __ldcg(reinterpret_cast<const V4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < valid ? __ldcg(p + q) : T(0);
}

// a fragment's two adjacent values at p (the second when `two`): one
// 8-byte store when the row length is even (pair)
template <class T>
__device__ __forceinline__ void put2(T* p, T a, T b, bool two, bool pair) {
  if (two && pair) {
    using V = typename std::conditional<std::is_same<T, int>::value, int2,
                                        float2>::type;
    *reinterpret_cast<V*>(p) = V{a, b};
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

template <int MODE, int MT, int BN>
__global__ void __launch_bounds__(THREADS, 2)
aio_mm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ xs, const float* __restrict__ ws,
              float* __restrict__ out, void* __restrict__ work,
              int* __restrict__ counters, int M, int N, int K, int slices,
              bool x_vec, bool w_vec, int fp8_shift, float fp8_scale) {
  using C = Cfg<MODE, MT, BN>;
  using Acc = typename std::conditional<C::kInt, int, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ring = smem;
  uint8_t* const adec = smem + C::NS * C::STAGE;   // fp8: decoded x
  uint8_t* const bdec = adec + C::ADEC;            // fp8/int: decoded w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = (warp / C::WN) * C::WMT * 16;
  const int wcol0 = (warp % C::WN) * C::NTW * 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int slice = blockIdx.z;

  const int KT = (K + C::BK - 1) / C::BK;
  const int per = (KT + slices - 1) / slices;
  const int kt0 = min(KT, slice * per);
  const int nkt = min(KT, kt0 + per) - kt0;
  const int rows = min(C::BM, M - m0);             // rows of x to stage

  constexpr int WES = MODE == BF16 ? 2 : 1;
  const long long x_rowb = (long long)K * WES;
  const long long w_rows = MODE == INT4 ? (K + 1) / 2 : K;
  const long long w_rowb = (long long)N * WES;

  // one stage: XRB bytes of each of the block's x rows, the matching raw w
  // rows (s8: 16-byte chunks XOR-swizzled by the row's 8 x 4 block row).
  // Each thread's chunks, source offsets and destinations are fixed; a
  // stage only moves the K offset. Tiles wholly inside both operands (all
  // but the ragged last) take one unmasked cp.async a chunk.
  constexpr int XSTR = MODE == FP8 ? C::XRB : C::AROW;
  constexpr int XCH = C::XRB / 16;                   // x chunks a row
  constexpr int XRS = THREADS / XCH;                 // x rows a pass
  constexpr int XIT = (C::BM + XRS - 1) / XRS;
  constexpr int CPR = C::WRB / 16;                   // w chunks a row
  constexpr int WRS = THREADS / CPR;                 // w rows a pass
  constexpr int WIT = (C::WROWS + WRS - 1) / WRS;
  constexpr int RPB = MODE == INT4 ? 4 : 8;          // raw rows per 8 k
  static_assert(THREADS % XCH == 0 && THREADS % CPR == 0, "chunk passes");
  const int xr0 = tid / XCH, xq = tid % XCH, wr0 = tid / CPR, wq = tid % CPR;
  const long long xbase = (long long)(m0 + xr0) * x_rowb + xq * 16;
  const long long wcolb = (long long)n0 * WES + wq * 16;
  const long long wbase = wr0 * w_rowb + wcolb;
  const bool wcol = wcolb + 16 <= w_rowb;
  auto load = [&](int kt, int st) {
    uint8_t* sd = ring + st * C::STAGE;
    const long long xk = (long long)kt * C::XRB;
    const bool xin = x_vec && xk + C::XRB <= x_rowb;
#pragma unroll
    for (int i = 0; i < XIT; ++i) {
      const int r = xr0 + i * XRS;
      if (r >= rows || (C::BM % XRS != 0 && r >= C::BM)) continue;
      uint8_t* dst = sd + r * XSTR + xq * 16;
      if (xin)
        cp_async16(dst, x + xbase + (long long)i * XRS * x_rowb + xk, 16);
      else
        copy16(dst, x, m0 + r, M, xk + xq * 16, x_rowb, x_vec);
    }
    const long long wk = (long long)kt * C::WROWS;
    const bool win = w_vec && wcol && wk + C::WROWS <= w_rows;
#pragma unroll
    for (int i = 0; i < WIT; ++i) {
      const int r = wr0 + i * WRS;
      if (C::WROWS % WRS != 0 && r >= C::WROWS) continue;
      uint8_t* dst;
      if constexpr (MODE == BF16)
        dst = sd + C::XST + r * C::BROW + wq * 16;
      else if constexpr (C::kInt)
        dst = sd + C::XST + r * C::WRB + (wq ^ ((r / RPB) & (CPR - 1))) * 16;
      else
        dst = sd + C::XST + r * C::WRB + wq * 16;
      if (win)
        cp_async16(dst, w + wbase + (wk + (long long)i * WRS) * w_rowb, 16);
      else
        copy16(dst, w, wk + r, w_rows, wcolb, w_rowb, w_vec);
    }
  };

  const __nv_bfloat162 fp8_scale2 = __float2bfloat162_rn(fp8_scale);
  // the decode pass of one staged tile, by all threads, into the layouts
  // the MMAs read
  auto unpack = [&](int st) {
    uint8_t* xr = ring + st * C::STAGE;
    const uint8_t* wr = xr + C::XST;
    if constexpr (MODE == FP8) {
      for (int i = tid; i < rows * 8; i += THREADS) {
        const int r = i >> 3, c = i & 7;
        const uint2 v = *reinterpret_cast<const uint2*>(xr + r * 64 + c * 8);
        const uint2 lo = fp8x4_to_bf16(v.x, fp8_shift, fp8_scale2);
        const uint2 hi = fp8x4_to_bf16(v.y, fp8_shift, fp8_scale2);
        *reinterpret_cast<uint4*>(adec + r * C::AROW + c * 16) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      constexpr int IPR = BN / 8;
#pragma unroll
      for (int j = 0; j < C::BK * IPR / THREADS; ++j) {
        const int i = j * THREADS + tid, r = i / IPR, c = i % IPR;
        const uint2 v = *reinterpret_cast<const uint2*>(wr + r * BN + c * 8);
        const uint2 lo = fp8x4_to_bf16(v.x, fp8_shift, fp8_scale2);
        const uint2 hi = fp8x4_to_bf16(v.y, fp8_shift, fp8_scale2);
        *reinterpret_cast<uint4*>(bdec + r * C::BROW + c * 16) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    } else if constexpr (C::kInt) {
      // item (kb, n4): k 8 kb .. 8 kb + 7 of columns 4 n4 .. 4 n4 + 3; a
      // warp takes 8 consecutive kb (distinct swizzled chunks) x 4 n4
      constexpr int CPR = BN / 16, NV = BN / 4;
      for (int it = tid; it < C::BK / 8 * NV; it += THREADS) {
        const int kb = (it & 7) + 8 * (it / (8 * NV)), n4 = (it >> 3) % NV;
        const int pc = ((n4 >> 2) ^ (kb & (CPR - 1))) * 16 + (n4 & 3) * 4;
        uint2 col[4];
        if constexpr (MODE == INT8) {
          uint32_t v[8], lo[4], hi[4];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            v[r] = *reinterpret_cast<const uint32_t*>(wr + (8 * kb + r) * BN
                                                      + pc);
          transpose4(v, lo);
          transpose4(v + 4, hi);
#pragma unroll
          for (int c = 0; c < 4; ++c) col[c] = make_uint2(lo[c], hi[c]);
        } else {  // packed row 4 kb + r holds k = 8 kb + 2r (low), + 1 (high)
          uint32_t v[4], p[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            v[r] = *reinterpret_cast<const uint32_t*>(wr + (4 * kb + r) * BN
                                                      + pc);
          transpose4(v, p);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t lo = sext_nibbles(p[c]);
            const uint32_t hi = sext_nibbles(p[c] >> 4);
            col[c] = make_uint2(__byte_perm(lo, hi, 0x5140),
                                __byte_perm(lo, hi, 0x7362));
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint2*>(bdec + (4 * n4 + c) * C::BROW + 8 * kb) =
              col[c];
      }
      if constexpr (MODE == INT4) {   // x codes: low nibbles, in place
        for (int i = tid; i < rows * 8; i += THREADS) {
          uint4* p = reinterpret_cast<uint4*>(xr + (i >> 3) * C::AROW +
                                              (i & 7) * 16);
          const uint4 v = *p;
          *p = make_uint4(sext_nibbles(v.x), sext_nibbles(v.y),
                          sext_nibbles(v.z), sext_nibbles(v.w));
        }
      }
    }
  };

  bool live[C::WMT];
  bool any = false;
#pragma unroll
  for (int mt = 0; mt < C::WMT; ++mt) {
    live[mt] = m0 + wrow0 + mt * 16 < M;
    any = any || live[mt];
  }
  Acc acc[C::WMT][C::NTW][4];
#pragma unroll
  for (int mt = 0; mt < C::WMT; ++mt)
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // the MMAs of one staged tile: A [m][k] rows of AROW bytes, B s8 [n][k]
  // or 16-bit [k][n] rows of BROW bytes
  auto mma_tile = [&](const uint8_t* A, const uint8_t* B) {
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      uint32_t a[C::WMT][4], b[C::NTW][2];
#pragma unroll
      for (int mt = 0; mt < C::WMT; ++mt)
        if (live[mt])
          ldsm_x4(a[mt], A + (wrow0 + mt * 16 + (lane & 15)) * C::AROW +
                             ks * 32 + (lane >> 4) * 16);
      const int q = lane >> 3, r = lane & 7;
#pragma unroll
      for (int j = 0; j < C::NTW; j += 2) {
        if constexpr (C::kInt) {
          if (j + 1 < C::NTW) {
            uint32_t v[4];
            ldsm_x4(v, B + (wcol0 + (j + (q >> 1)) * 8 + r) * C::BROW +
                           ks * 32 + (q & 1) * 16);
            b[j][0] = v[0], b[j][1] = v[1], b[j + 1][0] = v[2],
            b[j + 1][1] = v[3];
          } else {
            ldsm_x2(b[j], B + (wcol0 + j * 8 + r) * C::BROW + ks * 32 +
                              (q & 1) * 16);
          }
        } else {
          if (j + 1 < C::NTW) {
            uint32_t v[4];
            ldsm_x4_t(v, B + (ks * 16 + (q & 1) * 8 + r) * C::BROW +
                             (wcol0 + (j + (q >> 1)) * 8) * 2);
            b[j][0] = v[0], b[j][1] = v[1], b[j + 1][0] = v[2],
            b[j + 1][1] = v[3];
          } else {
            ldsm_x2_t(b[j], B + (ks * 16 + (q & 1) * 8 + r) * C::BROW +
                                (wcol0 + j * 8) * 2);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < C::WMT; ++mt)
        if (live[mt])
#pragma unroll
          for (int j = 0; j < C::NTW; ++j) mma(acc[mt][j], a[mt], b[j]);
    }
  };

#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < nkt) load(kt0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<C::NS - 2>();
    __syncthreads();   // tile i is in; every warp is done with tile i - 1
    const int nxt = i + C::NS - 1;
    if (nxt < nkt) load(kt0 + nxt, nxt % C::NS);
    cp_async_commit();
    const uint8_t* st = ring + (i % C::NS) * C::STAGE;
    if constexpr (MODE == BF16) {
      if (any) mma_tile(st, st + C::XST);
    } else {
      unpack(i % C::NS);
      __syncthreads();
      if (any) mma_tile(MODE == FP8 ? adec : st, bdec);
    }
  }
  cp_async_wait<0>();

  // fragment (mt, j, e): row wrow0 + 16 mt + g + 8 (e >> 1), column
  // wcol0 + 8 j + 2 t + (e & 1)
  const bool pair = (N & 1) == 0;
  if (slices > 1) {
    Acc* part = static_cast<Acc*>(work);
#pragma unroll
    for (int mt = 0; mt < C::WMT; ++mt)
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wrow0 + mt * 16 + g + 8 * h;
          const int n = n0 + wcol0 + j * 8 + 2 * t;
          if (m < M && n < N)
            put2(part + ((long long)slice * M + m) * N + n,
                 acc[mt][j][2 * h], acc[mt][j][2 * h + 1], n + 1 < N, pair);
        }
    if (!splitk_arrive(counters + blockIdx.y * gridDim.x + blockIdx.x,
                       slices))
      return;
    // the last block: the tile's slices summed in index order, read and
    // written in row order, 4 columns a thread at a time (16-byte loads
    // where N allows), a slice's loads all in flight at once
    constexpr int V = BN / 4;                         // vectors a tile row
    constexpr int PER = (C::BM * V + THREADS - 1) / THREADS;
    const bool vec = (N & 3) == 0;
    Acc sum[PER][4];
    for (int s = 0; s < slices; ++s)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * THREADS + tid, r = e / V, c = n0 + 4 * (e % V);
        if (r >= rows || c >= N) continue;
        const Acc* p = part + ((long long)s * M + m0 + r) * N + c;
        Acc v[4];
        ld4cg(v, p, N - c, vec);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sum[i][q] = s == 0 ? v[q] : sum[i][q] + v[q];
      }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = i * THREADS + tid, r = e / V, c = n0 + 4 * (e % V);
      if (r >= rows || c >= N) continue;
      const int m = m0 + r;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = (float)sum[i][q];
        if (xs != nullptr && c + q < N)
          o[q] = __fmul_rn(__fmul_rn(o[q], xs[m]), ws[c + q]);
      }
      float* dst = out + (long long)m * N + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < N) dst[q] = o[q];
      }
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < C::WMT; ++mt)
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wrow0 + mt * 16 + g + 8 * h;
        const int n = n0 + wcol0 + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        float r0 = (float)acc[mt][j][2 * h], r1 = (float)acc[mt][j][2 * h + 1];
        if (xs != nullptr) {
          r0 = __fmul_rn(__fmul_rn(r0, xs[m]), ws[n]);
          if (n + 1 < N) r1 = __fmul_rn(__fmul_rn(r1, xs[m]), ws[n + 1]);
        }
        put2(out + (long long)m * N + n, r0, r1, n + 1 < N, pair);
      }
}

template <int MODE, int MT, int BN>
int launch(const void* x, const void* w, const void* xs, const void* ws,
           void* out, void* work, int* counters, int M, int N, int K,
           int slices, bool x_vec, bool w_vec, int shift, float scale,
           cudaStream_t s) {
  using C = Cfg<MODE, MT, BN>;
  auto kern = aio_mm_kernel<MODE, MT, BN>;
  static bool sized = false;   // above 48 KB only after this attribute
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + C::BM - 1) / C::BM, slices);
  kern<<<grid, THREADS, C::SMEM, s>>>(
      (const uint8_t*)x, (const uint8_t*)w, (const float*)xs,
      (const float*)ws, (float*)out, work, counters, M, N, K, slices, x_vec,
      w_vec, shift, scale);
  return (int)cudaGetLastError();
}

// M chooses only the number of 16-row MMA tiles a block holds
template <int MODE, int BN>
int launch_m(const void* x, const void* w, const void* xs, const void* ws,
             void* out, void* work, int* counters, int M, int N, int K,
             int slices, bool x_vec, bool w_vec, int shift, float scale,
             cudaStream_t s) {
  if (M <= 16)
    return launch<MODE, 1, BN>(x, w, xs, ws, out, work, counters, M, N, K,
                               slices, x_vec, w_vec, shift, scale, s);
  if (M <= 32)
    return launch<MODE, 2, BN>(x, w, xs, ws, out, work, counters, M, N, K,
                               slices, x_vec, w_vec, shift, scale, s);
  return launch<MODE, 4, BN>(x, w, xs, ws, out, work, counters, M, N, K,
                             slices, x_vec, w_vec, shift, scale, s);
}

template <int MODE>
int launch_mode(int bn, const void* x, const void* w, const void* xs,
                const void* ws, void* out, void* work, int* counters, int M,
                int N, int K, int slices, bool x_vec, bool w_vec, int shift,
                float scale, cudaStream_t s) {
  if (bn == 128)
    return launch_m<MODE, 128>(x, w, xs, ws, out, work, counters, M, N, K,
                               slices, x_vec, w_vec, shift, scale, s);
  return launch_m<MODE, 64>(x, w, xs, ws, out, work, counters, M, N, K,
                            slices, x_vec, w_vec, shift, scale, s);
}

}  // namespace

// mode: 0 bf16, 1 fp8 (codes of 7 magnitude bits: value bits = (code &
// 0x7f) << fp8_shift as bf16, times fp8_scale = 2^(127 - bias)), 2 int8,
// 3 int4. x (M, K) (int4: one code per byte), w (K, N) (int4: (K+1)/2
// packed rows), xs (M,) and ws (N,) float32 or both null (bf16 only), out
// (M, N) float32. The plan (bn 64 or 128, slices >= 1) is the caller's,
// from (K, N, mode) alone; with slices > 1, work holds slices x M x N
// partials (float32, int32 in the integer modes) and counters one zeroed
// int32 per output tile (ceil(M / BM) x ceil(N / bn), BM >= 16), which
// the launch leaves zeroed. x_vec / w_vec: the operand's rows are 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int aio_matmul(int mode, const void* x, const void* w,
                          const void* xs, const void* ws, void* out,
                          void* work, void* counters, int M, int N, int K,
                          int bn, int slices, int x_vec, int w_vec,
                          int fp8_shift, float fp8_scale, void* stream) {
  if ((bn != 64 && bn != 128) || slices < 1 ||
      (slices > 1 && (work == nullptr || counters == nullptr)) || M < 1 ||
      N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* c = static_cast<int*>(counters);
  switch (mode) {
    case BF16:
      return launch_mode<BF16>(bn, x, w, xs, ws, out, work, c, M, N, K,
                               slices, x_vec, w_vec, fp8_shift, fp8_scale, s);
    case FP8:
      return launch_mode<FP8>(bn, x, w, xs, ws, out, work, c, M, N, K,
                              slices, x_vec, w_vec, fp8_shift, fp8_scale, s);
    case INT8:
      return launch_mode<INT8>(bn, x, w, xs, ws, out, work, c, M, N, K,
                               slices, x_vec, w_vec, fp8_shift, fp8_scale, s);
    case INT4:
      return launch_mode<INT4>(bn, x, w, xs, ws, out, work, c, M, N, K,
                               slices, x_vec, w_vec, fp8_shift, fp8_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
