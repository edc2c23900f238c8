// AIO multi-format GEMM: out (M, N) f32 = ((float)(x . w) * xs[m]) * ws[n]
// over codes in five modes.
//
// Replaces the Pallas kernel aio_matmul_pallas (_mm_kernel, unpack_x,
// unpack_w; src/repro/kernels/aio_matmul/kernel.py). Modes and operands
// (x row-major (M, K), w row-major (K, N), both contiguous):
//   bf16  x, w bf16; f32 accumulation; no scales.
//   fp8   x, w int8 fp8a/fp8b codes, decoded to bf16 through a 256-entry
//         table built on the host from the exact decode (every fp8a/fp8b
//         value is a bf16 value, so the decode is exact); bf16 MMA, f32
//         accumulation. The repo's fp8a (max 480) and fp8b (max 114688) do
//         not fit Hopper's native e4m3fn/e5m2, so codes are never cast to
//         native fp8.
//   int8  x, w int8; int32 accumulation.
//   int4  w packed two codes per byte along K ((K+1)/2 rows; low nibble =
//         even k, sign-extended; an odd K ends in a zero phantom nibble);
//         x one int4 code per byte (low nibble, as the quantizer writes
//         it). Both unpacked to int8 in shared memory; int8 MMA, int32
//         accumulation.
// Epilogue ((float)acc * xs[m]) * ws[n] in f32, in that order (scales
// optional in bf16 mode). Integer modes are exact, so they equal the
// reference bitwise.
//
// What bounds it on an H100: at the decode width (M = 8) bytes — every
// weight byte is read once (int4 gate/up: 6.9 MB, 2 us at 3.35 TB/s) for
// 2 x M operations per weight element; at the chunk width (M = 256) the
// product is still short of the ~295 operations per byte where the tensor
// cores (989 TFLOP/s bf16, 1,979 TOPS int8) would bound it.
//
// Design: mma.sync tensor-core tiles (m16n8k16 bf16 -> f32, m16n8k32 s8 ->
// s32). A block of 4 warps owns a BM x BN output tile: at the decode width
// (M <= 16) 16 x BN with BN (64, 32 or 16) chosen from the shape so enough
// blocks fill the 132 SMs; wider, 64 x 32, so each staged weight tile
// feeds four 16-row MMA tiles. The warps split K: warp w takes K tiles w,
// w+4, w+8, ... (64 bytes of K each: 32 bf16/fp8 values or 64 int8/int4
// values), stages each through its own
// shared-memory tile — x as [m][k], w transposed to [n][k] with the fp8
// decode or int4 unpack done on the way — and runs the MMAs on it while
// the next tile's global loads are in flight in registers. The 4 partial
// tiles are then summed in a fixed order ((w0 + w1) + w2) + w3 and the
// epilogue applied. The order of the K reduction depends on K only, never
// on M or BN: a row's result is the same at the decode and the chunk
// width. Ragged M, N and K are masked in the kernel (zero fill); no
// operand is padded or copied.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_error.cuh"

namespace {

enum Mode { BF16 = 0, FP8 = 1, INT8 = 2, INT4 = 3 };

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KB = 64;       // bytes of K a warp stages per tile
constexpr int ROW = KB + 16; // shared-memory row stride: conflict-free reads

template <int MODE>
struct Traits {
  static constexpr bool kInt = MODE == INT8 || MODE == INT4;
  static constexpr int BK = kInt ? 64 : 32;          // K values per tile
  static constexpr int XES = MODE == BF16 ? 2 : 1;   // x bytes per value
  static constexpr int WES = MODE == BF16 ? 2 : 1;   // w bytes per value
  // w rows a tile spans (int4: packed rows of two k each)
  static constexpr int WROWS = MODE == INT4 ? 32 : BK;
};

// 16 bytes at (row, col_b) of a row-major byte matrix, zero outside
// [0, nrows) x [0, row_bytes); one vector load when the chunk lies inside
// and rows are 16-byte aligned (vec).
__device__ __forceinline__ uint4 ld16(const uint8_t* base, long long row,
                                      long long nrows, long long col_b,
                                      long long row_bytes,
                                      long long stride, bool vec) {
  if (row >= nrows) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = base + row * stride + col_b;
  if (vec && col_b + 16 <= row_bytes)
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t b = col_b + i < row_bytes ? p[i] : 0u;
    w[i >> 2] |= b << ((i & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  return (word(v, j >> 2) >> ((j & 3) * 8)) & 0xffu;
}

// sign-extend the low nibble of each byte of a word
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  const uint32_t lo = v & 0x0f0f0f0fu;
  return lo | (((lo & 0x08080808u) >> 3) * 0xf0u);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT: 16-row MMA tiles per block (BM = 16 MT output rows)
template <int MODE, int MT, int BN>
__global__ void __launch_bounds__(THREADS)
aio_mm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ xs, const float* __restrict__ ws,
              const uint16_t* __restrict__ table, float* __restrict__ out,
              int M, int N, int K, bool x_vec, bool w_vec) {
  using T = Traits<MODE>;
  using Acc = typename std::conditional<T::kInt, int, float>::type;
  constexpr int BM = 16 * MT;
  constexpr int NT = BN / 8;                          // n8 MMA tiles
  constexpr int A_CHUNKS = BM * T::BK * T::XES / 16 / 32;  // per lane
  constexpr int WCPR = BN * T::WES / 16;              // w chunks per row
  constexpr int B_CHUNKS = T::WROWS * WCPR / 32;      // per lane
  constexpr int WARP_BYTES = (BM + BN) * ROW;
  static_assert(BM * BN * 4 <= WARPS * WARP_BYTES,
                "the reduction tile aliases the staging tiles");

  __shared__ __align__(16) uint8_t smem[WARPS * WARP_BYTES];
  __shared__ uint16_t lut[256];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  uint8_t* As = smem + warp * WARP_BYTES;
  uint8_t* Bs = As + BM * ROW;

  if (MODE == FP8) {
    for (int i = threadIdx.x; i < 256; i += THREADS) lut[i] = table[i];
    __syncthreads();
  }

  const long long x_row_bytes = (long long)K * T::XES;
  const long long w_rows = MODE == INT4 ? (K + 1) / 2 : K;
  const long long w_row_bytes = (long long)N * T::WES;
  const int KT = (K + T::BK - 1) / T::BK;

  uint4 ra[A_CHUNKS], rb[B_CHUNKS];
  auto load = [&](int kt) {
    const long long k0b = (long long)kt * T::BK * T::XES;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      constexpr int CPR = T::BK * T::XES / 16;
      ra[i] = ld16(x, m0 + c / CPR, M, k0b + (c % CPR) * 16, x_row_bytes,
                   x_row_bytes, x_vec);
    }
    const long long r0 = (long long)kt * T::WROWS;
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      rb[i] = ld16(w, r0 + c % T::WROWS, w_rows,
                   (long long)n0 * T::WES + (c / T::WROWS) * 16, w_row_bytes,
                   w_row_bytes, w_vec);
    }
  };
  // registers -> shared memory: x as [m][k] (fp8 decoded to bf16, int4
  // sign-extended to int8), w transposed to [n][k] (likewise)
  auto stage = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      constexpr int CPR = T::BK * T::XES / 16;
      const int r = c / CPR, j = c % CPR;
      if (MODE == FP8) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(As + r * ROW + j * 32);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = lut[byte_of(ra[i], 2 * e)] |
                   ((uint32_t)lut[byte_of(ra[i], 2 * e + 1)] << 16);
      } else {
        uint4 v = ra[i];
        if (MODE == INT4)
          v = make_uint4(sext_nibbles(v.x), sext_nibbles(v.y),
                         sext_nibbles(v.z), sext_nibbles(v.w));
        *reinterpret_cast<uint4*>(As + r * ROW + j * 16) = v;
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      const int r = c % T::WROWS, nc = c / T::WROWS;
      if (MODE == BF16) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          reinterpret_cast<uint16_t*>(Bs + (nc * 8 + j) * ROW)[r] =
              (uint16_t)(word(rb[i], j >> 1) >> ((j & 1) * 16));
      } else if (MODE == FP8) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          reinterpret_cast<uint16_t*>(Bs + (nc * 16 + j) * ROW)[r] =
              lut[byte_of(rb[i], j)];
      } else if (MODE == INT8) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[(nc * 16 + j) * ROW + r] = (uint8_t)byte_of(rb[i], j);
      } else {  // INT4: packed row r holds k = 2r (low) and 2r + 1 (high)
        const bool hi_ok = (long long)kt * T::BK + 2 * r + 1 < K;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t b = byte_of(rb[i], j);
          const uint32_t lo = sext_nibbles(b) & 0xffu;
          const uint32_t hi = hi_ok ? sext_nibbles(b >> 4) & 0xffu : 0u;
          reinterpret_cast<uint16_t*>(Bs + (nc * 16 + j) * ROW)[r] =
              (uint16_t)(lo | (hi << 8));
        }
      }
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  int kt = warp;
  if (kt < KT) load(kt);
  for (; kt < KT; kt += WARPS) {
    stage(kt);
    __syncwarp();
    if (kt + WARPS < KT) load(kt + WARPS);   // in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int o = ks * 32 + 4 * t;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* r0 = As + (mt * 16 + g) * ROW + o;
        const uint8_t* r1 = r0 + 8 * ROW;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* b = Bs + (j * 8 + g) * ROW + o;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (T::kInt)
            mma_s8(acc[mt][j], a[mt], b0, b1);
          else
            mma_bf16(acc[mt][j], a[mt], b0, b1);
        }
      }
    }
    __syncwarp();   // the tile is rewritten by the next stage()
  }

  // sum the warps' partial tiles in a fixed order, ((w0 + w1) + w2) + w3,
  // into one shared tile, then the epilogue
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(smem);
  for (int v = 0; v < WARPS; ++v) {
    if (warp == v) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Acc* r0 = red + (mt * 16 + g) * BN + j * 8 + 2 * t;
          Acc* r1 = r0 + 8 * BN;
          r0[0] = v == 0 ? acc[mt][j][0] : r0[0] + acc[mt][j][0];
          r0[1] = v == 0 ? acc[mt][j][1] : r0[1] + acc[mt][j][1];
          r1[0] = v == 0 ? acc[mt][j][2] : r1[0] + acc[mt][j][2];
          r1[1] = v == 0 ? acc[mt][j][3] : r1[1] + acc[mt][j][3];
        }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    float r = (float)red[e];
    if (xs != nullptr) r = __fmul_rn(__fmul_rn(r, xs[m]), ws[n]);
    out[(long long)m * N + n] = r;
  }
}

template <int MODE, int MT, int BN>
void launch(const void* x, const void* w, const void* xs, const void* ws,
            const void* table, void* out, int M, int N, int K, bool x_vec,
            bool w_vec, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT));
  aio_mm_kernel<MODE, MT, BN><<<grid, THREADS, 0, s>>>(
      (const uint8_t*)x, (const uint8_t*)w, (const float*)xs,
      (const float*)ws, (const uint16_t*)table, (float*)out, M, N, K, x_vec,
      w_vec);
}

// The block tile of an (M, N) product: above the decode width 64 x 32;
// up to it 16 x BN, the widest BN of 64, 32, 16 that still gives two
// blocks per SM of an H100 (132 SMs). The tile never changes the order in
// which a row's K reduction is summed.
template <int MODE>
void launch_mode(const void* x, const void* w, const void* xs,
                 const void* ws, const void* table, void* out, int M, int N,
                 int K, bool x_vec, bool w_vec, cudaStream_t s) {
  if (M > 16) {
    launch<MODE, 4, 32>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec, s);
    return;
  }
  int bn = 64;
  while (bn > 16 && (N + bn - 1) / bn < 2 * 132) bn /= 2;
  if (bn == 64)
    launch<MODE, 1, 64>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec, s);
  else if (bn == 32)
    launch<MODE, 1, 32>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec, s);
  else
    launch<MODE, 1, 16>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec, s);
}

}  // namespace

// mode: 0 bf16, 1 fp8 (through `table`, 256 bf16 bit patterns), 2 int8,
// 3 int4. x (M, K) (int4: one code per byte), w (K, N) (int4: (K+1)/2
// packed rows), xs (M,) and ws (N,) float32 or both null (bf16 only),
// out (M, N) float32. x_vec / w_vec: the operand's rows are 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int aio_matmul(int mode, const void* x, const void* w,
                          const void* xs, const void* ws, const void* table,
                          void* out, int M, int N, int K, int x_vec,
                          int w_vec, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case BF16:
      launch_mode<BF16>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec,
                        s);
      break;
    case FP8:
      launch_mode<FP8>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec,
                       s);
      break;
    case INT8:
      launch_mode<INT8>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec,
                        s);
      break;
    case INT4:
      launch_mode<INT4>(x, w, xs, ws, table, out, M, N, K, x_vec, w_vec,
                        s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
