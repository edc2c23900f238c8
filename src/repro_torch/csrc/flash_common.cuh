// Shared parts of the flash-decode, varlen flash-prefill and full-sequence
// kernels: the masked-score sentinel, the cp.async copies, and the K/V
// sources (bf16, f32, or int8 codes times an f32 scale); and the decode
// kernel's pieces: its staging of a tile of 32 keys into shared memory as
// stored, with cp.async (a tile's copies closed into one group, all in
// flight at once, no registers spent) from a flat per-row cache or through
// a block table from a paged pool, and its per-warp online-softmax step
// over one tile. (The tensor-core step of the prefill and full-sequence
// kernels is in flash_mma.cuh.)
//
// In the decode step a warp owns up to RW = 8 packed query rows (the GQA
// group of one kv-head, times the queries of the launch) and their running
// softmax state in registers: max m, sum l, and a float4 of the
// accumulator per row — a lane owns 4 of the head dims (so D <= 128). For
// each tile of TK = 32 keys, widened to f32 as they are read from shared
// memory:
//   1. scores, one key per lane: s = (q . k) * scale, optional softcap,
//      masked to NEG_INF;
//   2. per row: m' = max(m, max s) across the warp, alpha = exp(m - m'),
//      p = exp(s - m'), l = l * alpha + sum(p);
//   3. acc = acc * alpha + p @ V, a lane per 4 head dims.
// Masked scores use the finite -1e30, never -inf: a tile whose keys are all
// masked for a row before its first valid key gives p = 1 there, and the
// first valid key wipes it with alpha = exp(-1e30 - m) = 0; with -inf,
// exp(-inf - -inf) would be NaN. This is the Pallas kernels' arithmetic.
//
// The products are written with fmaf explicitly, and the int8 dequant with
// __fmul_rn, so nvcc's contraction cannot fuse the dequant multiply into
// the score product: the fused int8 path sees exactly the f32 values that
// dequantize-then-kernel loads, and the two agree bitwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads per block
constexpr int TK = 32;          // keys per tile: one per lane
constexpr int RW = 8;           // packed query rows per warp
constexpr int MAX_D = 128;      // a lane owns 4 head dims

enum KVKind { KV_BF16 = 0, KV_F32 = 1, KV_INT8 = 2 };

// A tile of TK keys as stored, in shared memory: key rows at a stride of
// D * ES + 16 bytes (the pad puts the lanes — one key each — on other
// banks), value rows at D * ES bytes, and for int8 one f32 scale per key.
struct Tile {
  char* k;
  char* v;
  float* ks;
  float* vs;
};

__host__ __device__ inline int tile_bytes(int D, int es) {
  return TK * (D * es + 16) + TK * D * es + 2 * TK * (int)sizeof(float);
}

__device__ __forceinline__ Tile carve_tile(char* base, int D, int es) {
  Tile t;
  t.k = base;
  t.v = t.k + TK * (D * es + 16);
  t.ks = reinterpret_cast<float*>(t.v + TK * D * es);
  t.vs = t.ks + TK;
  return t;
}

// Asynchronous global -> shared copies (sm_80+). With src_bytes == 0 the
// destination is zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// Close this thread's issued copies into a group; wait until at most N of
// its groups are in flight (a barrier then publishes them to others).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(x[0]);  // bf16 -> f32 is exact
  const float2 b = __bfloat1622float2(x[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// The K/V sources: a cache or pool of element type E, contiguous, plus one
// f32 pow2 scale per position (same layout, last dim 1) when E is int8
// codes. Both copies stage keys [base, base + TK) into a Tile with `n`
// threads of which this is `i0`, and close this thread's copies into one
// cp.async group (the caller waits for it); keys past hi are zero-filled,
// never read and never looked up. key4 / val4 read 4 head dims of tile key
// t back, widened to f32.
//
// `copy` reads a flat cache (B, Hkv, Lk, D) at rows kv_row0 + kpos.
// `copy_paged` reads a block pool (P, Hkv, bs, D) through row b's block
// table (`table` points at its nblk entries): key kpos lives in physical
// block table[kpos / bs], at row (table[kpos / bs] * Hkv + h) * bs +
// kpos % bs. The address is resolved per key, so a tile may span several
// blocks (bs < TK) or part of one (bs > TK), and the walk over keys, and
// so the order of every sum, is the flat cache's for any bs. Each lane
// looks up the row of tile key `lane` once (only keys <= hi, so only
// table entries the row owns are read), and every 16-byte copy of key t
// takes it from lane t by a shuffle: one table load per key, not per copy.
// The flat copy keeps its own loop and its caller's base (b * Hkv + h) * Lk
// computed as one int times Lk: these kernels are latency-bound (one warp
// per scheduler), and a shared address functor whose base was a 64-bit
// ((long)b * Hkv + h) * Lk cost the flat decode kernel 12% on an H100.
template <typename E, bool SCALED>
struct KVSource {
  const E* k;
  const E* v;
  const float* ks;  // SCALED only
  const float* vs;
  static constexpr int ES = sizeof(E);

  __device__ __forceinline__ void copy(const Tile& tl, long kv_row0,
                                       int base, int hi, int D, int i0,
                                       int n) const {
    const int cpr = D * ES / 16;  // 16-byte chunks per row
    for (int i = i0; i < TK * cpr; i += n) {
      const int t = i / cpr, c = i % cpr, kpos = base + t;
      const long row = kv_row0 + (kpos <= hi ? kpos : 0);
      const int bytes = kpos <= hi ? 16 : 0;
      cp_async16(tl.k + t * (D * ES + 16) + c * 16,
                 reinterpret_cast<const char*>(k + row * D) + c * 16, bytes);
      cp_async16(tl.v + t * D * ES + c * 16,
                 reinterpret_cast<const char*>(v + row * D) + c * 16, bytes);
    }
    if (SCALED) {
      for (int t = i0; t < TK; t += n) {
        const int kpos = base + t;
        const long row = kv_row0 + (kpos <= hi ? kpos : 0);
        const int bytes = kpos <= hi ? 4 : 0;
        cp_async4(tl.ks + t, ks + row, bytes);
        cp_async4(tl.vs + t, vs + row, bytes);
      }
    }
    cp_async_commit();
  }

  // n is a multiple of 32 (whole warps) and TK * cpr too, so a warp's
  // lanes run the loops together and each shuffle has them all
  __device__ __forceinline__ void copy_paged(const Tile& tl,
                                             const int* table, int hkv,
                                             int h, int bs, int base, int hi,
                                             int D, int i0, int n) const {
    const int cpr = D * ES / 16;
    const int key = base + (i0 & 31);
    const long my_row =
        key <= hi
            ? ((long)__ldg(table + key / bs) * hkv + h) * bs + key % bs
            : 0;
    for (int i = i0; i < TK * cpr; i += n) {
      const int t = i / cpr, c = i % cpr;
      const long row = __shfl_sync(0xffffffffu, my_row, t);
      const int bytes = base + t <= hi ? 16 : 0;
      cp_async16(tl.k + t * (D * ES + 16) + c * 16,
                 reinterpret_cast<const char*>(k + row * D) + c * 16, bytes);
      cp_async16(tl.v + t * D * ES + c * 16,
                 reinterpret_cast<const char*>(v + row * D) + c * 16, bytes);
    }
    if (SCALED) {
      for (int t = i0; t < TK; t += n) {  // t is the lane: my_row is t's
        const int bytes = base + t <= hi ? 4 : 0;
        cp_async4(tl.ks + t, ks + my_row, bytes);
        cp_async4(tl.vs + t, vs + my_row, bytes);
      }
    }
    cp_async_commit();
  }

  // int8 dequant: codes * scale rounded to f32 (the q dtype, so the
  // rounding through it is the identity) — exactly `codes.float() * scale`
  // of the plain version; __fmul_rn keeps nvcc from contracting it
  static __device__ __forceinline__ float4 scale4(const float4& x, float s) {
    return make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s),
                       __fmul_rn(x.z, s), __fmul_rn(x.w, s));
  }
  __device__ __forceinline__ float4 key4(const Tile& tl, int t, int d,
                                         int D) const {
    const float4 x =
        widen4(reinterpret_cast<const E*>(tl.k + t * (D * ES + 16)) + d);
    return SCALED ? scale4(x, tl.ks[t]) : x;
  }
  __device__ __forceinline__ float4 val4(const Tile& tl, int t, int d,
                                         int D) const {
    const float4 x = widen4(reinterpret_cast<const E*>(tl.v + t * D * ES) + d);
    return SCALED ? scale4(x, tl.vs[t]) : x;
  }
};

using KVBf16 = KVSource<__nv_bfloat16, false>;
using KVF32 = KVSource<float, false>;
using KVInt8 = KVSource<int8_t, true>;

// The running softmax state of a warp's rows (every lane holds m and l of
// each row; acc holds the lane's 4 head dims).
struct Rows {
  float m[RW], l[RW];
  float4 acc[RW];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}

// One warp, its RW rows (the first nr real, warp-uniform) against the tile
// of keys [base, base + TK) in `tl`, read through the K/V source `kv`. Qs:
// the rows' queries [RW][D] (finite past nr); qpos: their absolute
// positions; valid: whether each is a real query. Ps: the warp's own
// [RW][TK] scratch. A key is kept for row r when r < nr, valid[r], kpos <
// lk, kpos <= qpos[r] and, with a window, kpos > qpos[r] - window: the
// reference's mask.
template <class KV>
__device__ __forceinline__ void warp_tile(Rows& st, const KV& kv,
                                          const Tile& tl, const float* Qs,
                                          const int* qpos, const int* valid,
                                          int nr, float* Ps, int base, int lk,
                                          int D, int window, float scale,
                                          float softcap, int lane) {
  // every one of the RW rows is computed, with no branch on nr: a branch a
  // row made each row's loads wait alone (~9 us a tile on an H100). Rows
  // past nr are zero queries, masked, and never read back by the caller.
  float s[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = kv.key4(tl, lane, d, D);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(Qs + r * D + d);
      s[r] = fmaf(q4.x, k4.x, s[r]);
      s[r] = fmaf(q4.y, k4.y, s[r]);
      s[r] = fmaf(q4.z, k4.z, s[r]);
      s[r] = fmaf(q4.w, k4.w, s[r]);
    }
  }
  // the rows' max and sum reductions run side by side, 8 shuffles a stage
  const int kpos = base + lane;
  float x[RW], red[RW], alpha[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    float y = s[r] * scale;
    if (softcap > 0.f) y = softcap * tanhf(y / softcap);
    const int qp = qpos[r];
    bool keep = r < nr && valid[r] && kpos < lk && kpos <= qp;
    if (window > 0) keep = keep && kpos > qp - window;
    x[r] = keep ? y : NEG_INF;
    red[r] = x[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RW; ++r)
      red[r] = fmaxf(red[r], __shfl_xor_sync(0xffffffffu, red[r], o));
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float m_new = fmaxf(st.m[r], red[r]);
    x[r] = expf(x[r] - m_new);  // p
    alpha[r] = expf(st.m[r] - m_new);
    st.m[r] = m_new;
    red[r] = x[r];
    Ps[r * TK + lane] = x[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RW; ++r)
      red[r] += __shfl_xor_sync(0xffffffffu, red[r], o);
#pragma unroll
  for (int r = 0; r < RW; ++r) st.l[r] = fmaf(st.l[r], alpha[r], red[r]);
  __syncwarp();
  if (lane * 4 < D) {
    float4 pv[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) pv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = 0; t < TK; ++t) {
      const float4 v4 = kv.val4(tl, t, lane * 4, D);
#pragma unroll
      for (int r = 0; r < RW; ++r) fma4(pv[r], Ps[r * TK + t], v4);
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float4& a = st.acc[r];
      a.x = fmaf(a.x, alpha[r], pv[r].x);
      a.y = fmaf(a.y, alpha[r], pv[r].y);
      a.z = fmaf(a.z, alpha[r], pv[r].z);
      a.w = fmaf(a.w, alpha[r], pv[r].w);
    }
  }
  __syncwarp();  // Ps (and the caller's tile) may be rewritten after this
}

// Call launch(kv) with the K/V source of storage kind kv_kind (bf16, f32,
// or int8 codes with f32 scales); returns its cudaError_t.
template <class Launch>
int with_kv_source(int kv_kind, const void* k, const void* v,
                   const void* k_scale, const void* v_scale, Launch launch) {
  switch (kv_kind) {
    case KV_BF16:
      return launch(KVBf16{static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), nullptr,
                           nullptr});
    case KV_F32:
      return launch(KVF32{static_cast<const float*>(k),
                          static_cast<const float*>(v), nullptr, nullptr});
    case KV_INT8:
      return launch(KVInt8{static_cast<const int8_t*>(k),
                           static_cast<const int8_t*>(v),
                           static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale)});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the default 48 KB (without it the launch is refused and never runs).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
