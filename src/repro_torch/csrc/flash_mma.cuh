// The tensor-core machinery of the varlen flash-prefill kernel
// (flash_prefill.cu) and the full-sequence flash kernel (flash_full.cu):
// bf16 MMA operands split from f32 values, and one warp's online-softmax
// step over a tile of 32 keys.
//
// Products run as mma.sync m16n8k16 bf16 with f32 accumulation on operands
// split into bf16 terms: each f32 value x = hi + mid + lo (hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid)), which keeps ~24 bits. bf16
// K/V are exact in bf16, so Q.K^T and P.V take 3 MMAs each (lo, mid, hi
// into one accumulator); K/V split into three terms keep the 6 term
// products with i + j <= 2. P.V of a tile is taken into a fresh accumulator
// and added with acc = fmaf(acc, alpha, pv), so a tile whose p are all 0
// for a row leaves its acc unchanged.
//
// A warp owns an m16 tile of query rows: lane holds rows ra = lane / 4 and
// rb = ra + 8 of it, and columns 2 (lane % 4) + {0, 1} of every 8-column
// tile of the scores and of the accumulator. Masked scores use the finite
// -1e30 of flash_common.cuh (NEG_INF): a tile whose keys are all masked for
// a row before its first valid key gives p = 1 there, and the first valid
// key wipes it with alpha = exp(-1e30 - m) = 0.
#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace repro {
namespace tc {

constexpr int PK = 32;   // keys per tile
constexpr int PAD = 8;   // bf16 per shared row past DP: other banks
constexpr int MAX_NT = MAX_D / 8;

using bf16 = __nv_bfloat16;

__host__ __device__ inline int padded_d(int D) { return (D + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// x = hi + mid + lo in bf16 terms, each the nearest bf16 to what is left
struct Split3 {
  bf16 t[3];
};
__device__ __forceinline__ Split3 split3(float x) {
  Split3 s;
  s.t[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(s.t[0]));
  s.t[1] = __float2bfloat16_rn(r);
  s.t[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(s.t[1])));
  return s;
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// The running softmax state of a warp's rows ra and rb (max m, sum l) and
// its accumulator columns.
struct WarpState {
  float m_a, m_b, l_a, l_b;
  float acc[MAX_NT][4];
  __device__ __forceinline__ void init() {
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;
#pragma unroll
    for (int n = 0; n < MAX_NT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
};

// Where a warp's step reads its operands, all bf16 in shared memory at a
// row stride of st elements: q, the warp's 16 rows of Q's first term, the
// next terms qts elements apart; k and v, the tile's 32 key rows of K's
// and V's first term, the next terms kvts apart (KT = 1: bf16 K/V, read as
// staged; KT = 3: the three terms of f32 K/V). dp: D padded to 16.
struct TileOperands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int qts, kvts, st, dp;
};

// The term products of a split A operand (a[0..2] = hi, mid, lo) and a B
// operand into one accumulator, smallest terms first: a B of one term
// (exact in bf16) takes 3 (lo, mid, hi), a B of three terms the 6 with
// i + j <= 2. Product p is A term PA<KT>(p) times B term PB<KT>(p).
template <int KT>
__device__ __forceinline__ constexpr int PA(int p) {
  return KT == 1 ? 2 - p : (p < 3 ? 2 - p : (p < 5 ? 4 - p : 0));
}
template <int KT>
__device__ __forceinline__ constexpr int PB(int p) {
  return KT == 1 ? 0 : (p < 3 ? p : (p < 5 ? p - 3 : 0));
}

// One warp's rows against the keys [t0, t0 + 32): qpa / qpb the absolute
// positions of rows ra / rb, va / vb whether they are real queries. A key
// is kept for a row when the row is real, key < lk, key <= its position if
// causal and, with a window, key > its position - window: the reference's
// mask. s = (q . k) * scale, softcap before the mask, then the online
// softmax and acc = acc * alpha + P V.
//
// The MMAs interleave 4 accumulators: each term product is issued for 4
// 8-column tiles in turn, so a warp keeps 4 MMAs in flight instead of one
// dependent chain (each tile's products to the end before the next took
// 1.2-1.3x as long on an H100 in both kernels, with the same bits: every
// accumulator takes its products in the same order).
template <int KT>
__device__ __forceinline__ void tile_step(WarpState& w,
                                          const TileOperands& op, int t0,
                                          int lane, int qpa, int qpb, bool va,
                                          bool vb, int lk, bool causal,
                                          int window, float scale,
                                          float softcap) {
  static_assert(KT == 1 || KT == 3, "K/V of one term (bf16) or three");
  constexpr int NP = KT == 1 ? 3 : 6;  // term products a product
  constexpr int NI = 4;                // accumulators interleaved
  const int ST = op.st;
  // scores s = Q K^T of the tile: 4 tiles of 8 keys
  float s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = 0; kk < op.dp / 16; ++kk) {
    uint32_t qa[3][4];
#pragma unroll
    for (int t = 0; t < 3; ++t)
      ldsm_x4(qa[t], op.q + t * op.qts + (lane & 15) * ST + kk * 16 +
                         (lane >> 4) * 8);
    // lane's key row and column for a pair of 8-key tiles
    const int koff = ((lane >> 4) * 8 + (lane & 7)) * ST + kk * 16 +
                     ((lane >> 3) & 1) * 8;
    uint32_t kb[KT][2][4];  // each load: two 8-key tiles
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4(kb[t][h], op.k + t * op.kvts + 2 * h * 8 * ST + koff);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma(s[n], qa[PA<KT>(p)], kb[PB<KT>(p)][n >> 1] + (n & 1) * 2);
  }
  // scale, softcap, mask; the online softmax of rows ra and rb
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
      const int qp = e < 2 ? qpa : qpb;
      float x = s[n][e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool keep = (e < 2 ? va : vb) && key < lk;
      if (causal) keep = keep && key <= qp;
      if (window > 0) keep = keep && key > qp - window;
      x = keep ? x : NEG_INF;
      s[n][e] = x;
      if (e < 2)
        mx_a = fmaxf(mx_a, x);
      else
        mx_b = fmaxf(mx_b, x);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
  }
  const float mn_a = fmaxf(w.m_a, mx_a), mn_b = fmaxf(w.m_b, mx_b);
  const float al_a = expf(w.m_a - mn_a), al_b = expf(w.m_b - mn_b);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[n][e] - (e < 2 ? mn_a : mn_b));
      s[n][e] = p;
      if (e < 2)
        sum_a += p;
      else
        sum_b += p;
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
  }
  w.l_a = fmaf(w.l_a, al_a, sum_a);
  w.l_b = fmaf(w.l_b, al_b, sum_b);
  w.m_a = mn_a;
  w.m_b = mn_b;
  // P as the A operand of two 16-key steps, in three bf16 terms
  uint32_t pa[2][3][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 2 * kk + (j >> 1), e = (j & 1) * 2;
      const Split3 x0 = split3(s[n][e]), x1 = split3(s[n][e + 1]);
#pragma unroll
      for (int t = 0; t < 3; ++t) pa[kk][t][j] = pack2(x0.t[t], x1.t[t]);
    }
  // acc = acc * alpha + P V, 4 tiles of 8 head dims at a time
  const int nt = op.dp / 8;
#pragma unroll
  for (int n0 = 0; n0 < MAX_NT; n0 += NI) {
    if (n0 < nt) {
      float pv[NI][4];
      uint32_t vb4[KT][NI][4];
#pragma unroll
      for (int g = 0; g < NI; ++g) {
        pv[g][0] = pv[g][1] = pv[g][2] = pv[g][3] = 0.f;
        if (n0 + g < nt)
#pragma unroll
          for (int t = 0; t < KT; ++t)
            ldsm_x4_t(vb4[t][g], op.v + t * op.kvts + lane * ST +
                                     (n0 + g) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int g = 0; g < NI; ++g)
            if (n0 + g < nt)
              mma(pv[g], pa[kk][PA<KT>(p)], vb4[PB<KT>(p)][g] + kk * 2);
#pragma unroll
      for (int g = 0; g < NI; ++g) {
        if (n0 + g < nt) {
          float* acc = w.acc[n0 + g];
          acc[0] = fmaf(acc[0], al_a, pv[g][0]);
          acc[1] = fmaf(acc[1], al_a, pv[g][1]);
          acc[2] = fmaf(acc[2], al_b, pv[g][2]);
          acc[3] = fmaf(acc[3], al_b, pv[g][3]);
        }
      }
    }
  }
}

}  // namespace tc
}  // namespace repro
