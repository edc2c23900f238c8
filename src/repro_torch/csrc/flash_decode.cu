// Flash-decode: short-query (Lq <= 8) causal attention over a long per-row
// KV cache, dense (bf16 or f32 K/V) and fused int8-KV.
//
// Replaces the Pallas kernels flash_decode_pallas and
// flash_decode_quant_pallas (src/repro/kernels/flash_attention/decode.py),
// and, as `flash_decode_paged`, flash_decode_paged_pallas and
// flash_decode_paged_quant_pallas: the same kernel reading a (P, Hkv, bs, D)
// block pool through a per-row block table (`copy_paged` in
// flash_common.cuh), bitwise equal to the flat kernel on the gathered cache
// for any block size bs, since the key walk does not depend on bs.
//
// What bounds it on an H100: bytes. Each step reads every K/V position a
// row needs (2 x keys x D per kv-head, in bf16 or int8 plus a scale) and
// does only ~2 x group x Lq flops per K/V element read, far below the ~20
// flops per byte at which 67 TFLOP/s of f32 arithmetic, not 3.35 TB/s of
// memory, would be the limit.
//
// Design: one thread block per (batch row, kv-head, group of <= 8 packed
// query rows) — the GQA group of the kv-head times the Lq queries, so the
// 6 query heads of a qwen2 kv-head share every K/V tile a block reads. The
// block reads the row's cache position from the device vector `pos` (no
// host sync) and walks exactly the keys [max(pos - window + 1, 0),
// pos + Lq - 1]: keys outside that range are never read, so work scales
// with the row's resident context (or its window), not max_len. The key
// range is dealt to the block's 4 warps in KV blocks of `bkv` keys; each
// warp streams its blocks through its own shared-memory tile, 32 keys at a
// time (cp.async: a tile's copies all in flight at once), with its own
// online-softmax state in registers, and the warps' states are merged at
// the end (max, rescaled sums). The cache is staged in its storage type
// and widened in registers; no f32 copy of it is made. Still far from the
// byte bound: only B x Hkv blocks (16 at serving width on 132 SMs), and a
// warp waits for each tile before computing it. Splitting each row's key
// range across blocks, and double-buffering the tiles, are the next steps.
#include "flash_common.cuh"

namespace repro {

// per warp: a tile and its [RW][TK] probabilities; after the key loop the
// same space holds the warps' states for the merge
__host__ __device__ inline int decode_warp_bytes(int D, int es) {
  return tile_bytes(D, es) + RW * TK * (int)sizeof(float);
}

__host__ __device__ inline size_t decode_smem_bytes(int D, int es) {
  const size_t merge = sizeof(float) * ((size_t)2 * WARPS * RW +
                                        (size_t)WARPS * RW * D);
  const size_t warps = (size_t)WARPS * decode_warp_bytes(D, es);
  return sizeof(float) * ((size_t)RW * D + 2 * RW) +
         (warps > merge ? warps : merge);
}

template <class KV, bool PAGED>
__global__ void __launch_bounds__(NT)
    flash_decode_kernel(KV kv, const float* __restrict__ q, long qsb,
                        long qsh, long qsl, const int* __restrict__ pos,
                        float* __restrict__ out, int Hkv, int group, int Lq,
                        int D, int Lk, int bkv, int window, float scale,
                        float softcap, const int* __restrict__ table,
                        int nblk, int bs) {
  extern __shared__ float4 smem4[];
  const int rows = group * Lq;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int r0 = blockIdx.y * RW, nr = min(RW, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * group;

  float* Qs = reinterpret_cast<float*>(smem4);     // [RW][D]
  int* qpos = reinterpret_cast<int*>(Qs + RW * D);  // [RW]
  int* valid = qpos + RW;                           // [RW]
  float* wbuf = reinterpret_cast<float*>(valid + RW);
  char* mine =
      reinterpret_cast<char*>(wbuf) + warp * decode_warp_bytes(D, KV::ES);
  const Tile tl = carve_tile(mine, D, KV::ES);
  float* Ps = reinterpret_cast<float*>(mine + tile_bytes(D, KV::ES));

  // packed row r0 + r = g * Lq + i is query i of head h * group + g, at
  // absolute position pos[b] + i
  const int start = pos[b];
  for (int i = tid; i < nr * D; i += NT) {
    const int pr = r0 + i / D, d = i % D, g = pr / Lq, qi = pr % Lq;
    Qs[i] = q[b * qsb + (long)(h * group + g) * qsh + qi * qsl + d];
  }
  for (int r = tid; r < nr; r += NT) {
    qpos[r] = start + (r0 + r) % Lq;
    valid[r] = 1;
  }
  __syncthreads();

  const int hi = min(start + Lq - 1, Lk - 1);
  const int lo = window > 0 ? max(start - window + 1, 0) : 0;
  const long kv_row0 = (long)bh * Lk;
  if (PAGED) table += (long)b * nblk;  // row b's block table
  Rows st;
  st.init();
  // KV blocks of bkv keys, dealt to the warps in turn
  for (int blk = lo + warp * bkv; blk <= hi; blk += WARPS * bkv) {
    const int end = min(blk + bkv - 1, hi);
    for (int t0 = blk; t0 <= end; t0 += TK) {
      if constexpr (PAGED)
        kv.copy_paged(tl, table, Hkv, h, bs, t0, end, D, lane, 32);
      else
        kv.copy(tl, kv_row0, t0, end, D, lane, 32);
      __syncwarp();
      warp_tile(st, kv, tl, Qs, qpos, valid, nr, Ps, t0, Lk, D, window,
                scale, softcap, lane);
    }
  }

  // merge the warps' states: M = max m_w, L = sum l_w e_w,
  // ACC = sum acc_w e_w with e_w = exp(m_w - M); out = ACC / max(L, 1e-30)
  __syncthreads();  // every warp is done with its tile buffer
  float* Cm = wbuf;               // [WARPS][RW]
  float* Cl = Cm + WARPS * RW;    // [WARPS][RW]
  float* Ca = Cl + WARPS * RW;    // [WARPS][RW][D]
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r < nr) {
      if (lane == 0) {
        Cm[warp * RW + r] = st.m[r];
        Cl[warp * RW + r] = st.l[r];
      }
      if (lane * 4 < D)
        *reinterpret_cast<float4*>(Ca + (warp * RW + r) * D + lane * 4) =
            st.acc[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i % D;
    float M = NEG_INF;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Cm[w * RW + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(Cm[w * RW + r] - M);
      L = fmaf(Cl[w * RW + r], e, L);
      A = fmaf(Ca[(w * RW + r) * D + d], e, A);
    }
    const int pr = r0 + r, g = pr / Lq, qi = pr % Lq;
    out[(((long)b * Hq + h * group + g) * Lq + qi) * D + d] =
        A / fmaxf(L, 1e-30f);
  }
}

template <bool PAGED, class KV>
static int launch(KV kv, const int* table, int nblk, int bs, const float* q,
                  long qsb, long qsh, long qsl, const int* pos, float* out,
                  int B, int Hkv, int group, int Lq, int D, int Lk, int bkv,
                  int window, float scale, float softcap,
                  cudaStream_t stream) {
  if (D % 4 || D > MAX_D || (D * KV::ES) % 16 || bkv < TK || bkv % TK ||
      (PAGED && (bs < 1 || nblk < 1 || !table)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = decode_smem_bytes(D, KV::ES);
  cudaError_t err = allow_smem(flash_decode_kernel<KV, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (group * Lq + RW - 1) / RW);
  flash_decode_kernel<KV, PAGED><<<grid, NT, smem, stream>>>(
      kv, q, qsb, qsh, qsl, pos, out, Hkv, group, Lq, D, Lk, bkv, window,
      scale, softcap, table, nblk, bs);
  return (int)cudaGetLastError();
}

}  // namespace repro

// q: (B, Hq, Lq, D) f32 with element strides (qsb, qsh, qsl, 1);
// k, v: (B, Hkv, Lk, D) contiguous, bf16 / f32 / int8 by kv_kind;
// k_scale, v_scale: (B, Hkv, Lk, 1) f32 (int8 only, else null);
// pos: (B,) int32 on the device; out: (B, Hq, Lq, D) f32 contiguous.
// D <= 128, D * element size a multiple of 16 bytes; bkv a multiple of 32.
// window <= 0 means none; softcap <= 0 means none. Returns cudaError_t.
extern "C" int flash_decode(int kv_kind, const void* q, long long qsb,
                            long long qsh, long long qsl, const void* k,
                            const void* v, const void* k_scale,
                            const void* v_scale, const void* pos, void* out,
                            int B, int Hkv, int group, int Lq, int D, int Lk,
                            int bkv, int window, float scale, float softcap,
                            void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return launch<false>(kv, nullptr, 0, 0, static_cast<const float*>(q),
                         qsb, qsh, qsl, static_cast<const int*>(pos),
                         static_cast<float*>(out), B, Hkv, group, Lq, D, Lk,
                         bkv, window, scale, softcap,
                         static_cast<cudaStream_t>(stream));
  });
}

// Paged: k, v: (P, Hkv, bs, D) block pools, k_scale, v_scale: (P, Hkv, bs,
// 1); table: (B, nblk) int32 on the device, row b's logical block j at
// physical block table[b, j] (every entry a row's frontier reaches must
// name a block of the pool); the row's keys are positions [0, nblk * bs).
// The rest as flash_decode.
extern "C" int flash_decode_paged(int kv_kind, const void* q, long long qsb,
                                  long long qsh, long long qsl, const void* k,
                                  const void* v, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* pos, void* out, int B, int Hkv,
                                  int group, int Lq, int D, int nblk, int bs,
                                  int bkv, int window, float scale,
                                  float softcap, void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return launch<true>(kv, static_cast<const int*>(table), nblk, bs,
                        static_cast<const float*>(q), qsb, qsh, qsl,
                        static_cast<const int*>(pos),
                        static_cast<float*>(out), B, Hkv, group, Lq, D,
                        nblk * bs, bkv, window, scale, softcap,
                        static_cast<cudaStream_t>(stream));
  });
}
