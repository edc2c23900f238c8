// Full-sequence flash attention (forward): q (B, Hq, Lq, D) against k, v
// (B, Hkv, Lk, D) with GQA (q-head h reads kv-head h / (Hq / Hkv)), a
// scalar query offset (query i sits at position offset + i), causal or
// not, an optional sliding window and an optional logit softcap. Lk of any
// length: the tail past Lk is masked in the kernel, never padded in memory.
//
// Replaces the Pallas kernel flash_attention_pallas (_fa_kernel,
// src/repro/kernels/flash_attention/kernel.py). Its arithmetic: f32
// scores s = (q . k) * scale, softcap before the mask, the finite -1e30
// mask (kpos < Lk; causal kpos <= qpos; window kpos > qpos - window), an
// online softmax (m, l, acc), and acc / max(l, 1e-30) at the end. A query
// row with no valid key at all (a window that ends before Lk) returns a
// finite value that depends on the key tiles walked; the Pallas kernel's
// depends on its 128-key blocks. No path of the system makes such rows.
//
// What bounds it on an H100: f32 arithmetic. A 64-query block reuses every
// key it stages 64 times, ~2 x 64 x 2 flops per K/V element read, far above
// the ~20 flops per byte where 67 TFLOP/s of f32 FMA overtakes 3.35 TB/s;
// the bound is the flops of the kept (query, key) pairs. The products stay
// on the f32 CUDA cores: TF32 tensor cores would miss the 1e-4 agreement
// with the f32 reference.
//
// Design: one block per (64-query block, batch row x q-head), 256 threads
// as a 16 x 16 grid. The block stages its queries once, then walks the keys
// from its window's lower bound to its causal frontier (the whole of Lk
// when not causal), 32 keys per tile: K and V staged in shared memory as
// f32 (widened from bf16 on the way), K rows padded by 4 floats so the
// lanes' row reads fall on distinct banks. Thread (ty, tx) computes the
// scores of queries ty + 16 i (i < 4) against keys tx + 16 j (j < 2), a
// register tile fed by float4 reads; a row's max and sum are reduced over
// the 16 lanes that share it by shuffles; the probabilities go through
// shared memory to the P @ V product, where the thread owns the same 4
// queries and head dims 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3,
// with its softmax state (m, l) in registers. The q-blocks run last to
// first, so the long causal rows start first. No tensor cores, no
// double-buffered staging yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;          // queries per block
constexpr int BK = 32;          // keys per tile
constexpr int NT = 256;         // threads: 16 x 16
constexpr int RQ = BQ / 16;     // query rows per thread
constexpr int RK = BK / 16;     // keys per thread in the score tile
constexpr int MAX_D = 128;      // a thread owns 8 head dims of the output

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);  // bf16 -> f32 is exact
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// max / sum over the 16 lanes of a half warp (the lanes sharing a row)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}

__host__ __device__ inline size_t smem_bytes(int D) {
  const int dp = D + 4;  // padded row of Q and K
  return sizeof(float) *
         ((size_t)BQ * dp + (size_t)BK * dp + (size_t)BK * D + BQ * (BK + 4));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[3], ks[3], vs[3];  // element strides of dims 0..2
  int Hq, Hkv, Lq, Lk, D, offset, causal, window;
  float scale, softcap;
};

template <class EQ, class EKV>
__global__ void __launch_bounds__(NT) flash_full_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, dp = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][dp]
  float* Ks = Qs + BQ * dp;                     // [BK][dp]
  float* Vs = Ks + BK * dp;                     // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][BK + 4]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qb = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qb * BQ;
  const EQ* q = static_cast<const EQ*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const EKV* k = static_cast<const EKV*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const EKV* v = static_cast<const EKV*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  const int d4 = D / 4;
  for (int i = tid; i < BQ * d4; i += NT) {
    const int r = i / d4, d = (i % d4) * 4;
    store4(Qs + r * dp + d,
           q0 + r < a.Lq ? load4(q + (q0 + r) * a.qs[2] + d)
                         : make_float4(0.f, 0.f, 0.f, 0.f));
  }

  // keys [lo, hi] can be kept by some query of the block
  const int qlast = a.offset + min(q0 + BQ, a.Lq) - 1;
  const int hi = a.causal ? min(a.Lk - 1, qlast) : a.Lk - 1;
  const int lo = a.window > 0 ? max(0, a.offset + q0 - a.window + 1) : 0;

  float m[RQ], l[RQ];
  float4 acc[RQ][2];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int c0 = tx * 4, c1 = 64 + tx * 4;  // the thread's output dims

  for (int t0 = lo; t0 <= hi; t0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * d4; i += NT) {
      const int t = i / d4, d = (i % d4) * 4, kpos = t0 + t;
      const bool in = kpos <= hi;
      store4(Ks + t * dp + d, in ? load4(k + kpos * a.ks[2] + d)
                                 : make_float4(0.f, 0.f, 0.f, 0.f));
      store4(Vs + t * D + d, in ? load4(v + kpos * a.vs[2] + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 kv[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = load4(Ks + (tx + 16 * j) * dp + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qv = load4(Qs + (ty + 16 * i) * dp + d);
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, qpos = a.offset + q0 + r;
      float x[RK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = t0 + tx + 16 * j;
        float y = s[i][j] * a.scale;
        if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
        bool keep = kpos < a.Lk;
        if (a.causal) keep = keep && kpos <= qpos;
        if (a.window > 0) keep = keep && kpos > qpos - a.window;
        x[j] = keep ? y : NEG_INF;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(x[j] - m_new);
        Ps[r * (BK + 4) + tx + 16 * j] = p;
        ps += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = fmaf(l[i], alpha, half_sum(ps));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncthreads();  // Ps complete

    for (int t = 0; t < BK; ++t) {
      const float4 v0 =
          c0 < D ? load4(Vs + t * D + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v1 =
          c1 < D ? load4(Vs + t * D + c1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 4) + t];
        fma4(acc[i][0], p, v0);
        fma4(acc[i][1], p, v1);
      }
    }
  }

  EQ* out = static_cast<EQ*>(a.out) + ((long)bh * a.Lq) * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = c ? c1 : c0;
      if (col < D)
        store4(out + (long)r * D + col,
               make_float4(acc[i][c].x / den, acc[i][c].y / den,
                           acc[i][c].z / den, acc[i][c].w / den));
    }
  }
}

template <class EQ, class EKV>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  auto kernel = flash_full_kernel<EQ, EKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.Lq + BQ - 1) / BQ, B * a.Hq);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, Lq, D) with element strides (qsb, qsh, qsl, 1); k, v: (B, Hkv,
// Lk, D) with strides (ksb, ksh, ksl, 1) and (vsb, vsh, vsl, 1); out: (B,
// Hq, Lq, D) contiguous, of q's type. q_bf16 / kv_bf16: 1 for bf16, 0 for
// f32 (k and v share a type). D a multiple of 4, at most 128; every row
// start 16-byte aligned (f32) or 8-byte aligned (bf16). Hq a multiple of
// Hkv. window <= 0 means none; softcap <= 0 means none. Returns
// cudaError_t.
extern "C" int flash_attention_full(
    int q_bf16, int kv_bf16, const void* q, long long qsb, long long qsh,
    long long qsl, const void* k, long long ksb, long long ksh, long long ksl,
    const void* v, long long vsb, long long vsh, long long vsl, void* out,
    int B, int Hq, int Hkv, int Lq, int Lk, int D, int offset, int causal,
    int window, float scale, float softcap, void* stream) {
  if (D % 4 || D < 4 || D > MAX_D || Hkv < 1 || Hq % Hkv || Lq < 1 ||
      Lk < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q,   k,   v,   out, {qsb, qsh, qsl}, {ksb, ksh, ksl},
         {vsb, vsh, vsl}, Hq, Hkv, Lq, Lk, D, offset, causal, window,
         scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return kv_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, B, s)
                   : launch<__nv_bfloat16, float>(a, B, s);
  return kv_bf16 ? launch<float, __nv_bfloat16>(a, B, s)
                 : launch<float, float>(a, B, s);
}
