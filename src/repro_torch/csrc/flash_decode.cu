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
// memory, would be the limit. The first design reached under 1% of that
// bound: one block per (row, kv-head), 16 blocks on 132 SMs at the serving
// shapes, each warp walking 16 tiles of a 2,047-key row one after another
// and waiting for each tile's copy before computing it (~13 us a tile).
//
// Design:
// - Rows. One block per (batch row, kv-head, group of <= 8 packed query
//   rows: the GQA group of the kv-head times the Lq queries, head-major),
//   so the 6 query heads of a qwen2 kv-head share every K/V tile a block
//   reads.
// - Splits. The keys are cut at absolute multiples of `span` (a multiple
//   of the 32-key tile); the grid is (row x kv-head, row group, split),
//   sized from shapes alone. The block reads the row's position from the
//   device vector `pos` (no host sync): a block whose split lies past the
//   row's causal frontier pos + Lq - 1, or before its window, exits at
//   once. A live block walks its split's keys in 32-key tiles at absolute
//   multiples of 32 and, when the row needs more than one split, stores
//   its partial (m, l, acc) in the workspace and arrives on its row
//   group's counter (csrc/splitk.cuh); the last to arrive merges the
//   partials in split order and writes the output.
// - Inside a block the warps work on keys: tile i of the block's walk goes
//   to warp i % 4, which stages it into its own shared-memory buffer with
//   cp.async, all the block's tiles and its queries in flight at once (at
//   the module's span of 128 keys a warp has one tile a split; at larger
//   spans a warp stages its next tile into its buffer once it has computed
//   the one there). Each warp keeps its rows' online-softmax state in
//   registers (flash_common.cuh `warp_tile`: f32 FMA, one key a lane for
//   the scores and 4 head dims a lane for P.V); the block merges its
//   warps' states in warp order (max, rescaled sums). The cache is staged
//   in its storage type and widened in registers; no f32 copy of it is
//   made.
// - Since every cut is absolute, a row's sums depend only on its position,
//   its keys and Lk: not on the other rows of the batch, nor on the block
//   size of a paged pool. Tiles, warps and splits that hold none of a
//   query's keys leave its state bitwise as it was (their p are exactly 0,
//   or, before its first key, wiped by alpha = exp(-1e30 - m) = 0), and
//   the merge's fixed order makes the result the same run to run.
#include "flash_common.cuh"
#include "splitk.cuh"

namespace repro {
namespace decode {

// per warp: a tile buffer and its [RW][TK] probabilities
__host__ __device__ inline int warp_bytes(int D, int es) {
  return tile_bytes(D, es) + RW * TK * (int)sizeof(float);
}

// the rows' queries and positions, then the warps' buffers; after the key
// walk the same space holds the warps' states for the merge
__host__ __device__ inline size_t smem_bytes(int D, int es) {
  const size_t merge = sizeof(float) * ((size_t)2 * WARPS * RW +
                                        (size_t)WARPS * RW * D);
  const size_t warps = (size_t)WARPS * warp_bytes(D, es);
  return sizeof(float) * ((size_t)RW * D + 2 * RW) +
         (warps > merge ? warps : merge);
}

template <class KV, bool PAGED>
__global__ void __launch_bounds__(NT)
    flash_decode_kernel(KV kv, const float* __restrict__ q, long qsb,
                        long qsh, long qsl, const int* __restrict__ pos,
                        float* __restrict__ out, float* __restrict__ work,
                        int* __restrict__ counters, int Hkv, int group,
                        int Lq, int D, int Lk, int span, int window,
                        float scale, float softcap,
                        const int* __restrict__ table, int nblk, int bs) {
  extern __shared__ float4 smem4[];
  const int rows = group * Lq;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int r0 = blockIdx.y * RW, nr = min(RW, rows - r0);
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * group;

  // the keys the row needs, [lo, hi], and this split's share of them
  const int start = pos[b];
  const int hi = min(start + Lq - 1, Lk - 1);
  const int lo = window > 0 ? min(max(start - window + 1, 0), hi) : 0;
  const int s_lo = lo / span, s_hi = hi / span;
  if (split < s_lo || split > s_hi) return;
  const int nlive = s_hi - s_lo + 1;
  const int k_begin = max(split * span, lo / TK * TK);
  const int k_end = min(split * span + span - 1, hi);
  const int ntile = (k_end - k_begin) / TK + 1;

  float* Qs = reinterpret_cast<float*>(smem4);     // [RW][D]
  int* qpos = reinterpret_cast<int*>(Qs + RW * D);  // [RW]
  int* valid = qpos + RW;                           // [RW]
  char* wbase = reinterpret_cast<char*>(valid + RW);
  char* mine = wbase + warp * warp_bytes(D, KV::ES);
  float* Ps = reinterpret_cast<float*>(mine + tile_bytes(D, KV::ES));
  const Tile tl = carve_tile(mine, D, KV::ES);

  // warp w's tiles are tiles i = w + 4 j of the walk
  const long kv_row0 = (long)bh * Lk;
  if (PAGED) table += (long)b * nblk;  // row b's block table
  auto stage = [&](int i) {
    if constexpr (PAGED)
      kv.copy_paged(tl, table, Hkv, h, bs, k_begin + i * TK, k_end, D, lane,
                    32);
    else
      kv.copy(tl, kv_row0, k_begin + i * TK, k_end, D, lane, 32);
  };
  if (warp < ntile) stage(warp);

  // packed row r0 + r = g * Lq + i is query i of head h * group + g, at
  // absolute position pos[b] + i; rows past nr are zeros and invalid. Staged
  // with 4-byte cp.async (q's strides are any), in flight with the tiles
  for (int i = tid; i < RW * D; i += NT) {
    const int r = i / D, d = i % D, pr = r0 + r, g = pr / Lq, qi = pr % Lq;
    cp_async4(Qs + i,
              r < nr ? q + b * qsb + (long)(h * group + g) * qsh + qi * qsl + d
                     : q,
              r < nr ? 4 : 0);
  }
  cp_async_commit();
  for (int r = tid; r < RW; r += NT) {
    qpos[r] = start + (r0 + r) % Lq;
    valid[r] = r < nr;
  }
  // Q's group is the newest: waiting for it waits for the first tile too
  cp_async_wait<0>();
  __syncthreads();

  Rows st;
  st.init();
  for (int i = warp; i < ntile; i += WARPS) {
    cp_async_wait<0>();
    __syncwarp();
    warp_tile(st, kv, tl, Qs, qpos, valid, nr, Ps, k_begin + i * TK, Lk, D,
              window, scale, softcap, lane);
    if (i + WARPS < ntile) stage(i + WARPS);
  }

  // merge the warps' states: M = max m_w, L = sum l_w e_w,
  // ACC = sum acc_w e_w with e_w = exp(m_w - M)
  __syncthreads();  // every warp is done with its tile buffers
  float* Cm = reinterpret_cast<float*>(wbase);  // [WARPS][RW]
  float* Cl = Cm + WARPS * RW;                   // [WARPS][RW]
  float* Ca = Cl + WARPS * RW;                   // [WARPS][RW][D]
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
  // one split: out = ACC / max(L, 1e-30); else the block's partial
  const long nblocks = (long)gridDim.x * gridDim.y * gridDim.z;
  const long rgi = (long)bh * gridDim.y + blockIdx.y;  // row group index
  const long base = rgi * gridDim.z;                   // its split 0
  float* wacc = work + (base + split) * RW * D;
  float* wml = work + nblocks * RW * D + (base + split) * RW * 2;
  auto out_at = [&](int r) {
    const int pr = r0 + r, g = pr / Lq, qi = pr % Lq;
    return out + (((long)b * Hq + h * group + g) * Lq + qi) * D;
  };
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
    if (nlive == 1) {
      out_at(r)[d] = A / fmaxf(L, 1e-30f);
    } else {
      wacc[r * D + d] = A;
      if (d == 0) {
        wml[r * 2] = M;
        wml[r * 2 + 1] = L;
      }
    }
  }
  if (nlive == 1 || !splitk_arrive(counters + rgi, nlive)) return;
  // the last block: from the empty state (m = -1e30, l = 0, acc = 0;
  // merging a partial into it copies the partial exactly), each split in
  // order, 4 head dims a thread
  const int q4 = D / 4;
  for (int i = tid; i < nr * q4; i += NT) {
    const int r = i / q4, c = i % q4;
    const float* ml = work + nblocks * RW * D + base * RW * 2 + r * 2;
    const float* pa = work + base * RW * D + r * D + c * 4;
    float m = NEG_INF, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = s_lo; sp <= s_hi; ++sp) {
      const float m2 = __ldcg(ml + sp * RW * 2);
      const float l2 = __ldcg(ml + sp * RW * 2 + 1);
      const float4 a2 =
          __ldcg(reinterpret_cast<const float4*>(pa + (long)sp * RW * D));
      const float mn = fmaxf(m, m2);
      const float x1 = expf(m - mn), x2 = expf(m2 - mn);
      l = fmaf(l, x1, l2 * x2);
      a.x = fmaf(a.x, x1, a2.x * x2);
      a.y = fmaf(a.y, x1, a2.y * x2);
      a.z = fmaf(a.z, x1, a2.z * x2);
      a.w = fmaf(a.w, x1, a2.w * x2);
      m = mn;
    }
    const float den = fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(out_at(r) + c * 4) =
        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
}

template <bool PAGED, class KV>
static int launch(KV kv, const int* table, int nblk, int bs, const float* q,
                  long qsb, long qsh, long qsl, const int* pos, float* out,
                  float* work, int* counters, int B, int Hkv, int group,
                  int Lq, int D, int Lk, int span, int window, float scale,
                  float softcap, cudaStream_t stream) {
  if (D % 4 || D > MAX_D || (D * KV::ES) % 16 || span < TK || span % TK ||
      !work || !counters || (PAGED && (bs < 1 || nblk < 1 || !table)))
    return (int)cudaErrorInvalidValue;
  const long groups = (group * Lq + RW - 1) / RW;
  const long splits = (Lk + span - 1) / span;
  if (groups > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, KV::ES);
  cudaError_t err = allow_smem(flash_decode_kernel<KV, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (unsigned)groups, (unsigned)splits);
  flash_decode_kernel<KV, PAGED><<<grid, NT, smem, stream>>>(
      kv, q, qsb, qsh, qsl, pos, out, work, counters, Hkv, group, Lq, D, Lk,
      span, window, scale, softcap, table, nblk, bs);
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace repro

// q: (B, Hq, Lq, D) f32 with element strides (qsb, qsh, qsl, 1);
// k, v: (B, Hkv, Lk, D) contiguous, bf16 / f32 / int8 by kv_kind;
// k_scale, v_scale: (B, Hkv, Lk, 1) f32 (int8 only, else null);
// pos: (B,) int32 on the device; out: (B, Hq, Lq, D) f32 contiguous.
// work: f32 workspace of B * Hkv * G * S * 8 * (D + 2) floats and
// counters: B * Hkv * G zeroed int32 (left zeroed), where G = ceil(group *
// Lq / 8) row groups and S = ceil(Lk / span) splits
// (kernels/flash_attention/decode.py decode_plan). span: keys per split, a
// multiple of 32. D <= 128, D * element size a multiple of 16 bytes.
// window <= 0 means none; softcap <= 0 means none. Returns cudaError_t.
extern "C" int flash_decode(int kv_kind, const void* q, long long qsb,
                            long long qsh, long long qsl, const void* k,
                            const void* v, const void* k_scale,
                            const void* v_scale, const void* pos, void* out,
                            void* work, void* counters, int B, int Hkv,
                            int group, int Lq, int D, int Lk, int span,
                            int window, float scale, float softcap,
                            void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return decode::launch<false>(
        kv, nullptr, 0, 0, static_cast<const float*>(q), qsb, qsh, qsl,
        static_cast<const int*>(pos), static_cast<float*>(out),
        static_cast<float*>(work), static_cast<int*>(counters), B, Hkv,
        group, Lq, D, Lk, span, window, scale, softcap,
        static_cast<cudaStream_t>(stream));
  });
}

// Paged: k, v: (P, Hkv, bs, D) block pools, k_scale, v_scale: (P, Hkv, bs,
// 1); table: (B, nblk) int32 on the device, row b's logical block j at
// physical block table[b, j] (every entry a row's frontier reaches must
// name a block of the pool); the row's keys are positions [0, nblk * bs),
// so Lk = nblk * bs. The rest as flash_decode.
extern "C" int flash_decode_paged(int kv_kind, const void* q, long long qsb,
                                  long long qsh, long long qsl, const void* k,
                                  const void* v, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* pos, void* out, void* work,
                                  void* counters, int B, int Hkv, int group,
                                  int Lq, int D, int nblk, int bs, int span,
                                  int window, float scale, float softcap,
                                  void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return decode::launch<true>(
        kv, static_cast<const int*>(table), nblk, bs,
        static_cast<const float*>(q), qsb, qsh, qsl,
        static_cast<const int*>(pos), static_cast<float*>(out),
        static_cast<float*>(work), static_cast<int*>(counters), B, Hkv,
        group, Lq, D, nblk * bs, span, window, scale, softcap,
        static_cast<cudaStream_t>(stream));
  });
}
