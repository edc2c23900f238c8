// Grouped GEMM, the morphable multi-tenant MAC plane: out[t] = x[t] @
// w[gid[t / bm]] for x (T, K), w (G, K, N) and the row tiles' group ids
// gid (T / bm,) int32 on the device; f32 accumulation, an f32 or bf16
// output. Rows are sorted by group and every group's row count is a
// multiple of bm (the caller's contract, `make_group_ids`), so a row tile
// never straddles two groups.
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
// Design: a block owns a TM x 64 output tile (TM = 64, 32 or 16: the
// largest that divides bm, so the tile lies in one group) with 256 threads
// as 16 x 16; thread (ty, tx) owns rows TM/16 ty .. and columns 4 tx ..
// 4 tx + 3. The K loop stages 16 columns of x (transposed, [k][m]) and 16
// rows of the group's w ([k][n]) in shared memory per step, widened to f32,
// with ragged T, K and N edges zero-filled in the loads (no operand is
// padded or copied), and each thread accumulates its register tile from
// float4 reads of both. Stores are masked at the ragged edges. No
// double-buffered staging yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int TN = 64;   // output columns per block
constexpr int KT = 16;   // K per staged step
constexpr int NT = 256;  // threads: 16 x 16

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int TM, class E, class O>
__global__ void __launch_bounds__(NT)
    grouped_matmul_kernel(const E* __restrict__ x, const E* __restrict__ w,
                          const int* __restrict__ gid, O* __restrict__ out,
                          int T, int K, int N, int bm) {
  constexpr int RM = TM / 16;  // rows per thread
  // x tile padded by 4 floats: the transposing stores fall on 2-way
  // conflicting banks, not 16-way, and rows stay 16-byte aligned
  __shared__ __align__(16) float Xs[KT][TM + 4];
  __shared__ __align__(16) float Ws[KT][TN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const E* wg = w + (long)gid[m0 / bm] * K * N;  // this tile's group

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int i = tid; i < TM * KT; i += NT) {  // x tile: k fastest in memory
      const int r = i / KT, c = i % KT, row = m0 + r, kk = k0 + c;
      Xs[c][r] = row < T && kk < K ? widen(x[(long)row * K + kk]) : 0.f;
    }
    for (int i = tid; i < KT * TN; i += NT) {  // w tile: n fastest
      const int r = i / TN, c = i % TN, kk = k0 + r, col = n0 + c;
      Ws[r][c] = kk < K && col < N ? widen(wg[(long)kk * N + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      float a[RM];
      if constexpr (RM == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
        a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
      } else if constexpr (RM == 2) {
        const float2 a2 = *reinterpret_cast<const float2*>(&Xs[kk][ty * 2]);
        a[0] = a2.x, a[1] = a2.y;
      } else {
        a[0] = Xs[kk][ty];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) put(out + (long)row * N + col, acc[i][j]);
    }
  }
}

template <int TM, class E, class O>
int launch(const void* x, const void* w, const int* gid, void* out, int T,
           int K, int N, int bm, cudaStream_t stream) {
  const dim3 grid((T + TM - 1) / TM, (N + TN - 1) / TN);
  grouped_matmul_kernel<TM, E, O><<<grid, NT, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), gid,
      static_cast<O*>(out), T, K, N, bm);
  return (int)cudaGetLastError();
}

template <class E, class O>
int launch_tm(const void* x, const void* w, const int* gid, void* out, int T,
              int K, int N, int bm, cudaStream_t s) {
  if (bm % 64 == 0) return launch<64, E, O>(x, w, gid, out, T, K, N, bm, s);
  if (bm % 32 == 0) return launch<32, E, O>(x, w, gid, out, T, K, N, bm, s);
  return launch<16, E, O>(x, w, gid, out, T, K, N, bm, s);
}

}  // namespace

// x: (T, K) row-major, w: (G, K, N) row-major, both f32 (in_bf16 = 0) or
// both bf16 (1); gid: (T / bm,) int32 on the device, every entry in
// [0, G); out: (T, N) row-major, f32 (out_bf16 = 0) or bf16 (1). T a
// multiple of bm, bm a multiple of 16. Returns cudaError_t.
extern "C" int grouped_matmul(int in_bf16, int out_bf16, const void* x,
                              const void* w, const void* gid, void* out,
                              int T, int K, int N, int bm, void* stream) {
  if (bm < 16 || bm % 16 || T % bm || T < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int* g = static_cast<const int*>(gid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch_tm<__nv_bfloat16, __nv_bfloat16>(x, w, g, out, T, K,
                                                         N, bm, s)
               : launch_tm<__nv_bfloat16, float>(x, w, g, out, T, K, N, bm,
                                                 s);
  return out_bf16
             ? launch_tm<float, __nv_bfloat16>(x, w, g, out, T, K, N, bm, s)
             : launch_tm<float, float>(x, w, g, out, T, K, N, bm, s);
}
