// Grouped GEMM, the morphable multi-tenant MAC plane: out[t] = x[t] @
// w[gid[t / bm]] for x (T, K), w (G, K, N) and the row tiles' group ids
// gid (T / bm,) int32 on the device; f32 accumulation, an f32 or bf16
// output. Rows are sorted by group and every group's row count is a
// multiple of bm (the caller's contract, `make_group_ids`), so a row tile
// never straddles two groups. Optional group extents group_k (G,) and
// group_n (G,) (int32, on the device): group g's product uses only
// k < group_k[g] and writes zeros at n >= group_n[g] — the zero padding
// `pack_tenants` adds to short tenants is skipped, not multiplied.
//
// Replaces the Pallas kernel grouped_matmul_pallas (_gmm_kernel,
// src/repro/kernels/grouped_matmul/kernel.py), where the group ids are the
// scalar-prefetch operand that routes each row tile's weight tiles. Here
// each block reads its own tile's group id and offsets its weight pointer:
// one launch serves every tenant.
//
// What bounds it on an H100: f32 arithmetic at the tenant shapes (2 T K N
// flops over 67 TFLOP/s of f32 FMA, against (T K + G K N + T N) x 4 bytes
// over 3.35 TB/s). The products stay on the f32 CUDA cores, not TF32 tensor
// cores, which would put the result ~1e-3 from the f32 reference; bf16
// operands are widened to f32 as they are staged, so their products are
// exact and the sums f32 as well.
//
// Design: a block owns a TM x 64 output tile (TM 128, 64, 32 or 16, which
// divides bm, so the tile lies in one group) with 256 threads as
// 16 x 16; thread (ty, tx) owns a TM/16 x 4 register tile (8 x 4 at
// 128 x 64: 32 FMAs for three float4 shared reads), its rows split in two
// halves of the tile when it owns 8, so a warp's reads are conflict-free.
// (A 128 x 128 tile, 8 x 8 a thread, measured slower on every tenant mix
// of chip_smoke.py: it spills at two blocks an SM and leaves fewer blocks.)
// The K loop stages 16 k per step in a double-buffered pair of shared
// tiles, x transposed to [k][m] (padded by 4 floats) and w as [k][n], both
// widened to f32; the global loads of step k + 1 (16-byte vectors where
// the rows allow) are in flight in registers during the FMAs of step k,
// one barrier a step. (cp.async cannot transpose x or widen bf16, so the
// loads go through registers.) Ragged T, K and N edges are zero-filled in
// the loads; no operand is padded or copied. A block whose columns lie
// wholly past its group's group_n writes zeros and returns; a block's K
// loop ends at its group's group_k.
// Split K: the plan (`grouped_plan` in kernels/grouped_matmul/kernel.py, by
// shape) cuts K into slices of kc, one block per (tile, slice), about 5 M
// MACs a block, so that a few long tiles still spread over the 132 SMs; a
// tile's slices past its group's group_k do not run, and the live slices'
// partial tiles are summed in index order by the tile's last block
// (splitk.cuh): deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"
#include "splitk.cuh"

namespace {

constexpr int KT = 16;   // K per staged step
constexpr int TN = 64;   // output columns a block
constexpr int RN = 4;    // output columns a thread
constexpr int NT = 256;  // threads: 16 x 16

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive elements at p, of which the first `valid` (0..4) exist,
// widened to f32 (zero past them); one vector load when all 4 exist and
// the address is aligned (vec)
__device__ __forceinline__ float4 ld4(const float* p, int valid, bool vec) {
  if (valid >= 4 && vec) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < valid ? __ldg(p + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int valid,
                                      bool vec) {
  if (valid >= 4 && vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < valid ? widen(p[i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int clamp4(int n) {
  return n < 0 ? 0 : n > 4 ? 4 : n;
}

// register tile index -> offset in the block tile: with 8 a thread, two
// halves of 4 (i < 4 at 4 u + i, else at W / 2 + 4 u + i - 4); else R
// consecutive at R u
template <int R, int W>
__device__ __forceinline__ int sub(int u, int i) {
  if constexpr (R == 8) return (i >> 2) * (W / 2) + 4 * u + (i & 3);
  return R * u + i;
}

template <int R>
__device__ __forceinline__ void lds(float* v, const float* row, int u,
                                    int half) {
  if constexpr (R == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * u);
    const float4 b = *reinterpret_cast<const float4*>(row + half + 4 * u);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if constexpr (R == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * u);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * u);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = row[u];
  }
}

template <int TM, class E, class O>
__global__ void __launch_bounds__(NT)
    grouped_matmul_kernel(const E* __restrict__ x, const E* __restrict__ w,
                          const int* __restrict__ gid,
                          const int* __restrict__ group_k,
                          const int* __restrict__ group_n,
                          O* __restrict__ out, float* __restrict__ work,
                          int* __restrict__ counters, int T, int K, int N,
                          int bm, int kc, bool x_vec, bool w_vec) {
  constexpr int RM = TM / 16;                 // register tile rows
  constexpr int XV = (TM * KT / 4 + NT - 1) / NT;   // x vectors a thread
  constexpr int WV = (KT * TN / 4 + NT - 1) / NT;   // w vectors a thread
  __shared__ __align__(16) float Xs[2][KT][TM + 4];
  __shared__ __align__(16) float Ws[2][KT][TN + 4];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN, s = blockIdx.z;
  const int g = gid[m0 / bm];
  const int kg = group_k != nullptr ? min(group_k[g], K) : K;
  const int ng = group_n != nullptr ? min(group_n[g], N) : N;
  const int live = max(1, (kg + kc - 1) / kc);   // slices with work

  if (n0 >= ng) {   // every column past the group's: zeros, from slice 0
    if (s == 0)
      for (int i = tid; i < TM * TN; i += NT) {
        const int c = n0 + i % TN;
        if (c < N) put(out + (long)(m0 + i / TN) * N + c, 0.f);
      }
    return;
  }
  if (s >= live) return;
  const int kb = s * kc, ke = min(kb + kc, kg);
  const E* wg = w + (long)g * K * N;

  float4 xr[XV], wr[WV];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = v * NT + tid;     // (row, 4 k) of the x tile
      if (XV * NT == TM * KT / 4 || i < TM * KT / 4) {
        const int r = i / (KT / 4), kk = k0 + 4 * (i % (KT / 4));
        xr[v] = ld4(x + (long)(m0 + r) * K + kk, clamp4(ke - kk), x_vec);
      }
    }
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int i = v * NT + tid;     // (k, 4 n) of the w tile
      if (WV * NT == KT * TN / 4 || i < KT * TN / 4) {
        const int r = i / (TN / 4), c = n0 + 4 * (i % (TN / 4));
        const int kk = k0 + r;
        wr[v] = kk < ke ? ld4(wg + (long)kk * N + c, clamp4(ng - c), w_vec)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store = [&](int b) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = v * NT + tid;
      if (XV * NT == TM * KT / 4 || i < TM * KT / 4) {
        const int r = i / (KT / 4), k = 4 * (i % (KT / 4));
        Xs[b][k][r] = xr[v].x, Xs[b][k + 1][r] = xr[v].y;
        Xs[b][k + 2][r] = xr[v].z, Xs[b][k + 3][r] = xr[v].w;
      }
    }
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int i = v * NT + tid;
      if (WV * NT == KT * TN / 4 || i < KT * TN / 4)
        *reinterpret_cast<float4*>(&Ws[b][i / (TN / 4)][4 * (i % (TN / 4))])
            = wr[v];
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  load(kb);
  store(0);
  __syncthreads();
  int b = 0;
  for (int k0 = kb; k0 < ke; k0 += KT, b ^= 1) {
    const bool more = k0 + KT < ke;
    if (more) load(k0 + KT);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[RM], c[RN];
      lds<RM>(a, Xs[b][kk], ty, TM / 2);
      lds<RN>(c, Ws[b][kk], tx, TN / 2);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    if (more) store(b ^ 1);   // read last in the step before; all are past it
    __syncthreads();
  }

  if (live > 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long row = m0 + sub<RM, TM>(ty, i);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + sub<RN, TN>(tx, j);
        if (col < N) work[((long)s * T + row) * N + col] = acc[i][j];
      }
    }
    if (!splitk_arrive(counters + blockIdx.x * gridDim.y + blockIdx.y, live))
      return;
    // the last block: the tile's live slices summed in index order, read
    // and written in row order, 4 columns a thread at a time (16-byte loads
    // where N allows), a slice's loads all in flight at once
    constexpr int V = TN / 4;                          // vectors a tile row
    constexpr int PER = (TM * V + NT - 1) / NT;
    float4 sum[PER];
    for (int q = 0; q < live; ++q)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * NT + tid, r = e / V, c = n0 + 4 * (e % V);
        if (e >= TM * V || c >= N) continue;
        const float* p = work + ((long)q * T + m0 + r) * N + c;
        float4 v;
        if (w_vec) {
          v = __ldcg(reinterpret_cast<const float4*>(p));
        } else {
          float u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = c + j < N ? __ldcg(p + j) : 0.f;
          v = make_float4(u[0], u[1], u[2], u[3]);
        }
        if (q == 0) {
          sum[i] = v;
        } else {
          sum[i].x += v.x, sum[i].y += v.y, sum[i].z += v.z, sum[i].w += v.w;
        }
      }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = i * NT + tid, r = e / V, c = n0 + 4 * (e % V);
      if (e >= TM * V || c >= N) continue;
      O* dst = out + (long)(m0 + r) * N + c;
      const float o[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N) put(dst + j, o[j]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long row = m0 + sub<RM, TM>(ty, i);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + sub<RN, TN>(tx, j);
      if (col < N) put(out + row * N + col, acc[i][j]);
    }
  }
}

template <int TM, class E, class O>
int launch(const void* x, const void* w, const int* gid, const int* gk,
           const int* gn, void* out, float* work, int* counters, int T,
           int K, int N, int bm, int kc, int slices, cudaStream_t stream) {
  const dim3 grid(T / TM, (N + TN - 1) / TN, slices);
  grouped_matmul_kernel<TM, E, O><<<grid, NT, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), gid, gk, gn,
      static_cast<O*>(out), work, counters, T, K, N, bm, kc, K % 4 == 0,
      N % 4 == 0);
  return (int)cudaGetLastError();
}

template <class E, class O>
int launch_tile(int tm, const void* x, const void* w, const int* gid,
                const int* gk, const int* gn, void* out, float* work,
                int* counters, int T, int K, int N, int bm, int kc,
                int slices, cudaStream_t s) {
  switch (tm) {
    case 128:
      return launch<128, E, O>(x, w, gid, gk, gn, out, work, counters, T, K,
                               N, bm, kc, slices, s);
    case 64:
      return launch<64, E, O>(x, w, gid, gk, gn, out, work, counters, T, K,
                              N, bm, kc, slices, s);
    case 32:
      return launch<32, E, O>(x, w, gid, gk, gn, out, work, counters, T, K,
                              N, bm, kc, slices, s);
    case 16:
      return launch<16, E, O>(x, w, gid, gk, gn, out, work, counters, T, K,
                              N, bm, kc, slices, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (T, K) row-major, w: (G, K, N) row-major, both f32 (in_bf16 = 0) or
// both bf16 (1); gid: (T / bm,) int32 on the device, every entry in
// [0, G); group_k, group_n: (G,) int32 on the device, or null (the full K
// and N); out: (T, N) row-major, f32 (out_bf16 = 0) or bf16 (1). T a
// multiple of bm, bm a multiple of 16. The plan (the caller's): a tm x 64
// block tile (tm 128, 64, 32 or 16, dividing bm) and K cut into `slices`
// chunks of kc (a multiple of 16);
// with slices > 1, work holds slices x T x N float32 partials and counters
// one zeroed int32 per output tile, which the launch leaves zeroed.
// Returns cudaError_t.
extern "C" int grouped_matmul(int in_bf16, int out_bf16, const void* x,
                              const void* w, const void* gid,
                              const void* group_k, const void* group_n,
                              void* out, void* work, void* counters, int T,
                              int K, int N, int bm, int tm, int kc,
                              int slices, void* stream) {
  if (bm < 16 || bm % 16 || T % bm || T < 1 || K < 1 || N < 1 ||
      tm < 16 || bm % tm || kc < 16 || kc % 16 || slices < 1 ||
      (long)kc * slices < K ||
      (slices > 1 && (work == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* g = static_cast<const int*>(gid);
  const int* gk = static_cast<const int*>(group_k);
  const int* gn = static_cast<const int*>(group_n);
  float* wk = static_cast<float*>(work);
  int* c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch_tile<__nv_bfloat16, __nv_bfloat16>(
                     tm, x, w, g, gk, gn, out, wk, c, T, K, N, bm, kc,
                     slices, s)
               : launch_tile<__nv_bfloat16, float>(tm, x, w, g, gk, gn,
                                                   out, wk, c, T, K, N, bm,
                                                   kc, slices, s);
  return out_bf16
             ? launch_tile<float, __nv_bfloat16>(tm, x, w, g, gk, gn,
                                                 out, wk, c, T, K, N, bm, kc,
                                                 slices, s)
             : launch_tile<float, float>(tm, x, w, g, gk, gn, out, wk, c,
                                         T, K, N, bm, kc, slices, s);
}
