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
// What bounds it on an H100: arithmetic. A block of 128 packed rows reuses
// every key it stages 128 times, far above the ~20 flops per byte where
// 67 TFLOP/s of f32 FMA overtakes 3.35 TB/s, and above the ~295 where the
// bf16 tensor cores do. The first design ran every product on the f32 CUDA
// cores (33% of their bound, 1.8x SDPA at the forward's shape).
//
// Design (the prefill kernel's, csrc/flash_prefill.cu, on the tensor-core
// step both share in flash_mma.cuh):
// - Products: mma.sync m16n8k16 bf16 with f32 accumulation on operands
//   split into three bf16 terms. f32 K/V take the 6 term products with
//   i + j <= 2 (the model's case), bf16 K/V 3. mma.sync and cp.async, not
//   wgmma and TMA: the operands are split terms that the warps build and
//   read with ldmatrix, and the prefill's step, measured on the card, is
//   reused as it is.
// - Terms once: a first kernel splits K and V, read through their strides
//   (rows need only 8-byte alignment), into a workspace of bf16 terms (B x
//   Hkv, K/V x term, Lk, D padded to 16; bf16 K/V: one term, a copy), so
//   the row blocks of a kv-head that read a key tile (up to 96 at the
//   forward's shape) do not each split it again. Splitting each raw f32
//   tile in the block instead, as the prefill does (a second barrier a
//   tile), took 1.2x as long at the forward's shape on an H100.
// - Rows: a block is 8 warps of one m16 tile each, 128 packed rows of one
//   kv-head: its `group` query heads packed query-major (packed row
//   i * group + g is query i of head hk * group + g), so the 6 q-heads of
//   a qwen2 kv-head share every K/V tile the block stages. The grid is (B
//   x Hkv, ceil(Lq * group / 128)) with no key splits (768 blocks at the
//   forward's 4 x 2048 tokens); its second axis runs last to first, so the
//   blocks with the longest causal rows start first.
// - Pipeline: the K/V term tiles of 32 keys are double-buffered with
//   cp.async, one barrier a tile: after the barrier of tile t the copies
//   of tile t + 1 go out into the buffer tile t - 1 held, and fly while
//   tile t is computed. A block walks the keys from its window's lower
//   bound to its causal frontier (all of Lk when not causal), in tiles at
//   absolute multiples of 32; a warp skips the tiles past its own rows'
//   frontier (all masked for them: their state would not change).
// - q of either type is read through its strides and split into terms
//   once; the output is written in q's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace repro {
namespace full {

using namespace tc;

constexpr int FW = 8;         // warps a block
constexpr int FT = 32 * FW;   // threads a block
constexpr int FR = 16 * FW;   // packed rows a block (an m16 tile a warp)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);  // bf16 -> f32 is exact
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 4 consecutive values x as T bf16 terms at dst, dst + stride, ...
template <int T>
__device__ __forceinline__ void store_terms(bf16* dst, long stride,
                                            float4 x) {
  const Split3 a = split3(x.x), b = split3(x.y), c = split3(x.z),
               e = split3(x.w);
#pragma unroll
  for (int t = 0; t < T; ++t)
    *reinterpret_cast<uint2*>(dst + t * stride) =
        make_uint2(pack2(a.t[t], b.t[t]), pack2(c.t[t], e.t[t]));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  bf16* terms;                    // (B * Hkv, 2 * T, Lk, DP)
  long long qs[3], ks[3], vs[3];  // element strides of dims 0..2
  int B, Hq, Hkv, Lq, Lk, D, offset, causal, window;
  float scale, softcap;
};

// K and V, as strided as they come, into their T bf16 terms: row `key` of
// term t of K (c = 0) or V (c = 1) of kv-row bh at terms + ((bh * 2 * T +
// c * T + t) * Lk + key) * DP, the columns past D zero.
template <class EKV, int T>
__global__ void __launch_bounds__(256) split_kv_kernel(Args a) {
  const int DP = padded_d(a.D), c4 = DP / 4;
  const long n = (long)a.B * a.Hkv * 2 * a.Lk * c4;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int col = (int)(i % c4) * 4;
    long r = i / c4;
    const int key = (int)(r % a.Lk);
    r /= a.Lk;
    const int c = (int)(r % 2), bh = (int)(r / 2);
    const int b = bh / a.Hkv, h = bh % a.Hkv;
    const long long* s = c ? a.vs : a.ks;
    const EKV* src = static_cast<const EKV*>(c ? a.v : a.k) + b * s[0] +
                     h * s[1] + key * s[2] + col;
    const float4 x =
        col < a.D ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    store_terms<T>(
        a.terms + (((long)bh * 2 * T + c * T) * a.Lk + key) * DP + col,
        (long)a.Lk * DP, x);
  }
}

template <class EQ, int T>
__global__ void __launch_bounds__(FT, 1) flash_full_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, DP = padded_d(D), ST = DP + PAD;
  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.x, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * FR;  // long rows first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  bf16* Qt = reinterpret_cast<bf16*>(smem4);  // [3][FR][ST]
  bf16* kvs = Qt + 3 * FR * ST;               // [2][K, V][T][PK][ST]
  const int buf_elems = 2 * T * PK * ST;

  // keys [lo, hi] can be kept by some query of the block
  const int q_first = r0 / group;
  const int q_last = min((r0 + FR - 1) / group, a.Lq - 1);
  const int hi = a.causal ? min(a.Lk - 1, a.offset + q_last) : a.Lk - 1;
  const int lo = a.window > 0 ? max(0, a.offset + q_first - a.window + 1)
                              : 0;
  const int k_begin = lo / PK * PK;
  const int ntile = hi >= k_begin ? (hi - k_begin) / PK + 1 : 0;

  // staging: keys [t0, t0 + PK) of every term of K and V into buffer buf
  // (rows kv * T + t of 32 keys, the workspace's order), keys past hi
  // zero-filled and never read; one cp.async group
  const int cpr = DP / 8;  // 16-byte chunks of a term row
  const bf16* src = a.terms + (long)bh * 2 * T * a.Lk * DP;
  auto issue = [&](int t0, int buf) {
    bf16* dst = kvs + buf * buf_elems;
    for (int i = tid; i < 2 * T * PK * cpr; i += FT) {
      const int row = i / cpr, c = i % cpr, key = t0 + (row & (PK - 1));
      const bool in = key <= hi;
      cp_async16(dst + row * ST + c * 8,
                 src + ((long)(row / PK) * a.Lk + (in ? key : 0)) * DP +
                     c * 8,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (ntile > 0) issue(k_begin, 0);

  // the block's queries into Q's three bf16 terms (zeros past Lq and D)
  const int group_q = hk * group;
  for (int i = tid; i < FR * (DP / 4); i += FT) {
    const int r = i / (DP / 4), col = (i % (DP / 4)) * 4;
    const int pr = r0 + r, qi = pr / group;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < a.Lq && col < D)
      x = load4(static_cast<const EQ*>(a.q) + b * a.qs[0] +
                (long)(group_q + pr % group) * a.qs[1] + qi * a.qs[2] + col);
    store_terms<3>(Qt + r * ST + col, (long)FR * ST, x);
  }

  // the warp's rows ra = 16 warp + lane / 4 and rb = ra + 8
  const int wr = warp * 16, ra = wr + (lane >> 2), rb = ra + 8;
  const int qia = (r0 + ra) / group, qib = (r0 + rb) / group;
  const bool va = qia < a.Lq, vb = qib < a.Lq;
  const int qpa = a.offset + qia, qpb = a.offset + qib;
  const bool live = __any_sync(0xffffffffu, va || vb);
  // past this key every key is masked for all the warp's rows (causal)
  const int w_hi = a.causal
                       ? a.offset + min((r0 + wr + 15) / group, a.Lq - 1)
                       : a.Lk;
  WarpState w;
  w.init();
  for (int it = 0; it < ntile; ++it) {
    const int t0 = k_begin + it * PK, buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) in place; tile it - 1 done with
    if (it + 1 < ntile) issue(t0 + PK, buf ^ 1);
    if (live && t0 <= w_hi) {
      const bf16* kt = kvs + buf * buf_elems;
      const TileOperands op{Qt + wr * ST, kt, kt + T * PK * ST, FR * ST,
                            PK * ST, ST, DP};
      tile_step<T>(w, op, t0, lane, qpa, qpb, va, vb, a.Lk, a.causal != 0,
                   a.window, a.scale, a.softcap);
    }
  }

  // out = acc / max(l, 1e-30), in q's type
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra, qi = half ? qib : qia;
    if (qi >= a.Lq) continue;
    EQ* o = static_cast<EQ*>(a.out) +
            (((long)b * a.Hq + group_q + (r0 + r) % group) * a.Lq + qi) * D;
    const float den = fmaxf(half ? w.l_b : w.l_a, 1e-30f);
#pragma unroll
    for (int n = 0; n < MAX_NT; ++n) {
      const int d = n * 8 + c0;
      if (d < D)
        store2(o + d, w.acc[n][2 * half] / den, w.acc[n][2 * half + 1] / den);
    }
  }
}

__host__ inline size_t smem_bytes(int D, int T) {
  const int st = padded_d(D) + PAD;
  return sizeof(bf16) * ((size_t)3 * FR * st + (size_t)2 * 2 * T * PK * st);
}

template <class EQ, class EKV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int T = std::is_same<EKV, bf16>::value ? 1 : 3;
  const long n = (long)a.B * a.Hkv * 2 * a.Lk * (padded_d(a.D) / 4);
  const int blocks = (int)std::min<long>((n + 255) / 256, 132L * 16);
  split_kv_kernel<EKV, T><<<blocks, 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = flash_full_kernel<EQ, T>;
  const size_t smem = smem_bytes(a.D, T);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long rblocks = ((long)a.Lq * (a.Hq / a.Hkv) + FR - 1) / FR;
  if (rblocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.B * a.Hkv, (unsigned)rblocks);
  kernel<<<grid, FT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace full
}  // namespace repro

// q: (B, Hq, Lq, D) with element strides (qsb, qsh, qsl, 1); k, v: (B, Hkv,
// Lk, D) with strides (ksb, ksh, ksl, 1) and (vsb, vsh, vsl, 1); out: (B,
// Hq, Lq, D) contiguous, of q's type. q_bf16 / kv_bf16: 1 for bf16, 0 for
// f32 (k and v share a type). work: bf16 workspace of B * Hkv * 2 * T * Lk
// * DP elements, T = 1 for bf16 K/V and 3 for f32, DP = D rounded up to 16
// (kernels/flash_attention/full.py full_workspace). D a multiple of 4, at
// most 128; every row start 16-byte aligned (f32) or 8-byte aligned
// (bf16). Hq a multiple of Hkv. window <= 0 means none; softcap <= 0 means
// none. Returns cudaError_t.
extern "C" int flash_attention_full(
    int q_bf16, int kv_bf16, const void* q, long long qsb, long long qsh,
    long long qsl, const void* k, long long ksb, long long ksh, long long ksl,
    const void* v, long long vsb, long long vsh, long long vsl, void* out,
    void* work, int B, int Hq, int Hkv, int Lq, int Lk, int D, int offset,
    int causal, int window, float scale, float softcap, void* stream) {
  using namespace repro;
  using bf16 = __nv_bfloat16;
  if (D % 4 || D < 4 || D > MAX_D || Hkv < 1 || Hq % Hkv || Lq < 1 ||
      Lk < 1 || B < 1 || !work)
    return (int)cudaErrorInvalidValue;
  full::Args a{q, k, v, out, static_cast<bf16*>(work), {qsb, qsh, qsl},
               {ksb, ksh, ksl}, {vsb, vsh, vsl}, B, Hq, Hkv, Lq, Lk, D,
               offset, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return kv_bf16 ? full::launch<bf16, bf16>(a, s)
                   : full::launch<bf16, float>(a, s);
  return kv_bf16 ? full::launch<float, bf16>(a, s)
                 : full::launch<float, float>(a, s);
}
