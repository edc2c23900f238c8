// Varlen flash-prefill: causal attention of a right-padded chunk of W query
// tokens per row, at per-row cache positions `pos` with per-row valid
// lengths `lengths`, over the (B, Hkv, Lk, D) cache that already holds the
// chunk's keys. Dense (bf16 or f32 K/V) and fused int8-KV.
//
// Replaces the Pallas kernels flash_prefill_pallas and
// flash_prefill_quant_pallas (src/repro/kernels/flash_attention/prefill.py),
// and, as `flash_prefill_paged`, flash_prefill_paged_pallas and
// flash_prefill_paged_quant_pallas: the same kernel reading a (P, Hkv, bs,
// D) block pool through a per-row block table (`copy_paged` in
// flash_common.cuh), bitwise equal to the flat kernel on the gathered cache
// for any block size bs, since the key walk does not depend on bs.
//
// What bounds it on an H100: at the serving shapes (group 6, W = 32), f32
// arithmetic. A q-block of 32 queries times 6 heads does ~2 x 192 flops per
// K/V element it reads, above the ~20 flops per byte where 67 TFLOP/s of
// f32 FMA overtakes 3.35 TB/s of memory; the bound is the flops of the kept
// (query, key) pairs.
//
// Design: the Pallas grid (batch row x kv-head, q-block of bq queries),
// with the q-block's group x bq packed rows split further over blocks of
// 32 rows (one query head of a 32-query q-block), so a serving chunk runs
// 96 blocks instead of 16. A q-block starting at or past lengths[b] writes
// zeros and exits: a row with 3 real tokens does one q-block of work. A
// live block walks the keys from its window lower bound (its first query's
// position - window + 1, else 0) to the q-block's causal frontier
// pos + min((iq+1) bq, len) - 1, 32 keys per tile staged in shared memory
// in the cache's storage type (cp.async) and widened as it is read. Its 4
// warps own 8 rows each, with the softmax state and accumulator in
// registers (a lane per 4 head dims), and share every tile. Invalid (pad) query rows return exact
// zeros. The products run on the f32 CUDA cores, not the tensor cores
// (TF32 would miss the 1e-4 agreement with the f32 reference), and the
// block waits for each tile before computing it (no double buffering yet).
#include "flash_common.cuh"

namespace repro {

constexpr int RB = WARPS * RW;  // packed rows per block

__host__ __device__ inline size_t prefill_smem_bytes(int D, int es) {
  return sizeof(float) * ((size_t)RB * D + 2 * RB + (size_t)WARPS * RW * TK) +
         tile_bytes(D, es);
}

template <class KV, bool PAGED>
__global__ void __launch_bounds__(NT)
    flash_prefill_kernel(KV kv, const float* __restrict__ q, long qsb,
                         long qsh, long qsl, const int* __restrict__ pos,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, int Hkv, int group, int W,
                         int bq, int D, int Lk, int window, float scale,
                         float softcap, const int* __restrict__ table,
                         int nblk, int bs) {
  extern __shared__ float4 smem4[];
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int rows = group * bq, r0 = blockIdx.z * RB;
  const int nr = min(RB, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * group, d4 = lane * 4;
  const int start = pos[b], ln = lengths[b], qlo = blockIdx.y * bq;

  // packed row r0 + r = g * bq + i is query qlo + i of head h * group + g;
  // its output, or null past the chunk width
  auto out_at = [&](int r) -> float* {
    const int pr = r0 + r, g = pr / bq, qi = qlo + pr % bq;
    return qi < W ? out + (((long)b * Hq + h * group + g) * W + qi) * D
                  : nullptr;
  };
  if (qlo >= ln) {  // the whole q-block is padding: exact zeros
    for (int i = tid; i < nr * D; i += NT) {
      float* o = out_at(i / D);
      if (o) o[i % D] = 0.f;
    }
    return;
  }

  float* Qs = reinterpret_cast<float*>(smem4);     // [RB][D]
  int* qpos = reinterpret_cast<int*>(Qs + RB * D);  // [RB]
  int* valid = qpos + RB;                           // [RB]
  float* Ps = reinterpret_cast<float*>(valid + RB) + warp * RW * TK;
  const Tile tl = carve_tile(
      reinterpret_cast<char*>(reinterpret_cast<float*>(valid + RB) +
                              WARPS * RW * TK),
      D, KV::ES);
  for (int i = tid; i < nr * D; i += NT) {
    const int pr = r0 + i / D, d = i % D, g = pr / bq, qi = qlo + pr % bq;
    Qs[i] = qi < W
        ? q[b * qsb + (long)(h * group + g) * qsh + qi * qsl + d] : 0.f;
  }
  for (int r = tid; r < nr; r += NT) {
    const int qrel = qlo + (r0 + r) % bq;
    qpos[r] = start + qrel;
    valid[r] = qrel < ln;
  }
  __syncthreads();

  // the q-block's causal frontier is its last VALID query; a window adds
  // a lower bound from its first query
  const int qhi = min(qlo + bq, ln) - 1;
  const int hi = min(start + qhi, Lk - 1);
  const int lo = window > 0 ? min(max(start + qlo - window + 1, 0), hi) : 0;
  const int wr0 = warp * RW, wnr = max(0, min(RW, nr - wr0));
  if (PAGED) table += (long)b * nblk;  // row b's block table
  Rows st;
  st.init();
  for (int t0 = lo; t0 <= hi; t0 += TK) {
    if constexpr (PAGED)
      kv.copy_paged(tl, table, Hkv, h, bs, t0, hi, D, tid, NT);
    else
      kv.copy(tl, (long)bh * Lk, t0, hi, D, tid, NT);
    __syncthreads();
    if (wnr > 0)
      warp_tile(st, kv, tl, Qs + wr0 * D, qpos + wr0, valid + wr0, wnr, Ps,
                t0, Lk, D, window, scale, softcap, lane);
    __syncthreads();
  }

  if (d4 < D) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r >= wnr) continue;
      float* o = out_at(wr0 + r);
      if (!o) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid[wr0 + r]) {
        const float den = fmaxf(st.l[r], 1e-30f);
        v = make_float4(st.acc[r].x / den, st.acc[r].y / den,
                        st.acc[r].z / den, st.acc[r].w / den);
      }
      *reinterpret_cast<float4*>(o + d4) = v;
    }
  }
}

template <bool PAGED, class KV>
static int launch(KV kv, const int* table, int nblk, int bs, const float* q,
                  long qsb, long qsh, long qsl, const int* pos,
                  const int* lengths, float* out, int B, int Hkv, int group,
                  int W, int bq, int D, int Lk, int window, float scale,
                  float softcap, cudaStream_t stream) {
  if (D % 4 || D > MAX_D || (D * KV::ES) % 16 || bq < 1 || bq > W ||
      (PAGED && (bs < 1 || nblk < 1 || !table)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = prefill_smem_bytes(D, KV::ES);
  cudaError_t err = allow_smem(flash_prefill_kernel<KV, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (W + bq - 1) / bq, (group * bq + RB - 1) / RB);
  flash_prefill_kernel<KV, PAGED><<<grid, NT, smem, stream>>>(
      kv, q, qsb, qsh, qsl, pos, lengths, out, Hkv, group, W, bq, D, Lk,
      window, scale, softcap, table, nblk, bs);
  return (int)cudaGetLastError();
}

}  // namespace repro

// q: (B, Hq, W, D) f32 with element strides (qsb, qsh, qsl, 1);
// k, v: (B, Hkv, Lk, D) contiguous, bf16 / f32 / int8 by kv_kind;
// k_scale, v_scale: (B, Hkv, Lk, 1) f32 (int8 only, else null);
// pos, lengths: (B,) int32 on the device; out: (B, Hq, W, D) f32
// contiguous. D <= 128, D * element size a multiple of 16 bytes,
// 1 <= bq <= W. window <= 0 means none;
// softcap <= 0 means none. Returns cudaError_t.
extern "C" int flash_prefill(int kv_kind, const void* q, long long qsb,
                             long long qsh, long long qsl, const void* k,
                             const void* v, const void* k_scale,
                             const void* v_scale, const void* pos,
                             const void* lengths, void* out, int B, int Hkv,
                             int group, int W, int bq, int D, int Lk,
                             int window, float scale, float softcap,
                             void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return launch<false>(kv, nullptr, 0, 0, static_cast<const float*>(q),
                         qsb, qsh, qsl, static_cast<const int*>(pos),
                         static_cast<const int*>(lengths),
                         static_cast<float*>(out), B, Hkv, group, W, bq, D,
                         Lk, window, scale, softcap,
                         static_cast<cudaStream_t>(stream));
  });
}

// Paged: k, v: (P, Hkv, bs, D) block pools, k_scale, v_scale: (P, Hkv, bs,
// 1); table: (B, nblk) int32 on the device, row b's logical block j at
// physical block table[b, j] (every entry a row's frontier reaches must
// name a block of the pool); the row's keys are positions [0, nblk * bs).
// The rest as flash_prefill.
extern "C" int flash_prefill_paged(int kv_kind, const void* q, long long qsb,
                                   long long qsh, long long qsl,
                                   const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* pos,
                                   const void* lengths, void* out, int B,
                                   int Hkv, int group, int W, int bq, int D,
                                   int nblk, int bs, int window, float scale,
                                   float softcap, void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return launch<true>(kv, static_cast<const int*>(table), nblk, bs,
                        static_cast<const float*>(q), qsb, qsh, qsl,
                        static_cast<const int*>(pos),
                        static_cast<const int*>(lengths),
                        static_cast<float*>(out), B, Hkv, group, W, bq, D,
                        nblk * bs, window, scale, softcap,
                        static_cast<cudaStream_t>(stream));
  });
}
