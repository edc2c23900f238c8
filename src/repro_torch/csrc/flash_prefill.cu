// Varlen flash-prefill: causal attention of a right-padded chunk of W query
// tokens per row, at per-row cache positions `pos` with per-row valid
// lengths `lengths`, over the (B, Hkv, Lk, D) cache that already holds the
// chunk's keys. Dense (bf16 or f32 K/V) and fused int8-KV.
//
// Replaces the Pallas kernels flash_prefill_pallas and
// flash_prefill_quant_pallas (src/repro/kernels/flash_attention/prefill.py),
// and, as `flash_prefill_paged`, flash_prefill_paged_pallas and
// flash_prefill_paged_quant_pallas: the same kernel reading a (P, Hkv, bs,
// D) block pool through a per-row block table, bitwise equal to the flat
// kernel on the gathered cache for any block size bs, since the key walk
// does not depend on bs.
//
// What bounds it on an H100: at the serving shapes (group 6, W = 32) the
// f32 flops of the kept (query, key) pairs at 67 TFLOP/s; a q-block of 32
// queries x 6 heads does ~2 x 192 flops per K/V element it reads, above
// the ~20 flops per byte where f32 FMA overtakes 3.35 TB/s of memory. The
// first design (one block walking a row's whole key range, 32 keys a tile,
// on the f32 CUDA cores) reached 0.9% of that: a row at position 2000 walks
// ~63 tiles one after another in 16 x 6 blocks.
//
// Design:
// - Rows. The q-block of bq queries x the kv-head's `group` query heads is
//   packed query-major (packed row i * group + g), so a short row's few
//   valid queries share one 64-row block; a block is 4 warps of 16 rows
//   (one m16 MMA tile each).
// - Splits. The keys are cut at absolute multiples of `span` (a multiple
//   of the 32-key tile); the grid is (row x kv-head, q-block x row block,
//   split), sized from shapes alone. A block whose split lies past its
//   rows' causal frontier or before their window exits at once. A live
//   block walks its split's tiles (aligned to absolute multiples of 32)
//   with the online softmax and, when its rows need more than one split,
//   stores its partial (m, l, acc) in the workspace and arrives on its row
//   block's counter (csrc/splitk.cuh); the last to arrive merges the
//   partials in split order and writes the output. Since every boundary is
//   absolute, a query's sums depend only on its own position, its keys and
//   Lk: tiles and splits that hold none of its keys leave its state
//   bitwise as it was (their p are exactly 0, or, before its first key,
//   wiped by alpha = exp(-1e30 - m) = 0). So a query's output does not
//   depend on the chunk width it arrived in or on the other rows, and
//   paged equals flat.
// - Pipeline. The tiles are double-buffered: tile t + 1's cp.async copies
//   are in flight while tile t is computed.
// - Tensor cores (flash_mma.cuh, shared with flash_full.cu): mma.sync
//   m16n8k16 bf16 products with f32 accumulation on operands split into
//   three bf16 terms; bf16 K/V take 3 MMAs a product, f32 K/V the 6 term
//   products with i + j <= 2, a warp's MMAs interleaving 4 accumulators.
//   int8 K/V are dequantized (codes x pow2 scale,
//   __fmul_rn, as KVSource::scale4 does) while the tile is split in shared
//   memory and then run the f32 instruction sequence unchanged: the fused
//   int8 kernel is bitwise the kernel on the dequantized f32 K/V by
//   construction.
// - Invalid (pad) query rows return exact zeros. The masked-score sentinel
//   and its arithmetic are those of flash_common.cuh (NEG_INF = -1e30).
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "splitk.cuh"

namespace repro {
namespace prefill {

constexpr int PW = 4;          // warps per block
constexpr int PT = 32 * PW;    // threads per block
constexpr int RB = 16 * PW;    // packed rows per block (an m16 tile a warp)
using namespace tc;
static_assert(PT == 2 * RB, "the merge takes two threads a row");

// The kinds of K/V storage: bf16 is read by the MMAs as staged; f32 and
// int8 (codes x f32 scales) are staged raw and split into bf16 terms.
template <class KV>
struct Kind {
  using E = typename std::remove_cv<
      typename std::remove_pointer<decltype(KV::k)>::type>::type;
  static constexpr bool DIRECT = std::is_same<E, bf16>::value;
  static constexpr bool SCALED = std::is_same<E, int8_t>::value;
  static constexpr int ES = sizeof(E);
};

// Shared memory: Q's three terms [3][RB][ST] bf16, the rows' positions and
// validity, then bf16 K/V [2 buffers][K, V][PK][ST], or raw K/V [2][K,
// V][PK][D] (+ [2][K, V][PK] scales) and their terms [K, V][3][PK][ST].
template <class KV>
struct Smem {
  int st, raw, q, kv;
  __host__ __device__ explicit Smem(int D) {
    st = padded_d(D) + PAD;
    q = 3 * RB * st * 2 + 2 * RB * 4;
    raw = 2 * PK * D * Kind<KV>::ES + (Kind<KV>::SCALED ? 2 * PK * 4 : 0);
    kv = Kind<KV>::DIRECT ? 2 * 2 * PK * st * 2
                          : 2 * raw + 2 * 3 * PK * st * 2;
  }
  __host__ __device__ int bytes() const { return q + kv; }
};

template <class KV, bool PAGED>
__global__ void __launch_bounds__(PT, 1)
    flash_prefill_kernel(KV kv, const float* __restrict__ q, long qsb,
                         long qsh, long qsl, const int* __restrict__ pos,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ work,
                         int* __restrict__ counters, int Hkv, int group,
                         int W, int bq, int D, int Lk, int span, int window,
                         float scale, float softcap,
                         const int* __restrict__ table, int nblk, int bs) {
  using K = Kind<KV>;
  using E = typename K::E;
  constexpr int ES = K::ES;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Smem<KV> lay(D);
  const int ST = lay.st, DP = padded_d(D);
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int nrb = (group * bq + RB - 1) / RB;
  const int qlo = (blockIdx.y / nrb) * bq, r0 = (blockIdx.y % nrb) * RB;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * group;
  const int start = pos[b], ln = lengths[b];
  const int rows = min(RB, group * bq - r0);  // packed rows that exist
  const int qend = min(qlo + bq, W);

  // packed row r0 + r is query qlo + (r0 + r) / group of head h * group +
  // (r0 + r) % group; its output row, or null past the chunk
  auto out_at = [&](int r) -> float* {
    const int pr = r0 + r, qi = qlo + pr / group;
    return r < rows && qi < qend
               ? out + (((long)b * Hq + h * group + pr % group) * W + qi) * D
               : nullptr;
  };
  const int q_first = qlo + r0 / group;
  const int q_last = min(min(qlo + (r0 + rows - 1) / group, qend - 1),
                         ln - 1);  // the block's last VALID query
  if (q_first > q_last) {          // no valid row: exact zeros, once
    if (split == 0)
      for (int i = tid; i < rows * D; i += PT) {
        float* o = out_at(i / D);
        if (o) o[i % D] = 0.f;
      }
    return;
  }
  // the keys the block's rows need: up to the causal frontier of its last
  // valid query, from its first query's window lower bound
  const int hi = min(start + q_last, Lk - 1);
  const int lo =
      window > 0 ? min(max(start + q_first - window + 1, 0), hi) : 0;
  const int s_lo = lo / span, s_hi = hi / span;
  if (split < s_lo || split > s_hi) return;
  const int nlive = s_hi - s_lo + 1;
  const int k_begin = max(split * span, lo / PK * PK);
  const int k_end = min(split * span + span - 1, hi);
  const int ntile = (k_end - k_begin) / PK + 1;

  bf16* Qt = reinterpret_cast<bf16*>(sm);  // [3][RB][ST]
  int* qpos = reinterpret_cast<int*>(Qt + 3 * RB * ST);
  int* qvalid = qpos + RB;
  char* kvs = sm + lay.q;
  // the block's queries, f32 [RB][D], staged with cp.async in the K/V
  // buffers (all copies in flight at once; zeros past the chunk), then
  // split into Q's three bf16 terms
  float* qraw = reinterpret_cast<float*>(kvs);
  const int q4 = D / 4;
  for (int i = tid; i < RB * q4; i += PT) {
    const int r = i / q4, c = i % q4, pr = r0 + r, qi = qlo + pr / group;
    const bool in = r < rows && qi < qend;
    cp_async16(qraw + r * D + c * 4,
               in ? q + b * qsb + (long)(h * group + pr % group) * qsh +
                        qi * qsl + c * 4
                  : q,
               in ? 16 : 0);
  }
  cp_async_commit();
  for (int r = tid; r < RB; r += PT) {
    const int qi = qlo + (r0 + r) / group;
    qpos[r] = start + qi;
    qvalid[r] = r < rows && qi < qend && qi < ln;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < RB * DP; i += PT) {
    const int r = i / DP, d = i % DP;
    const Split3 s = split3(d < D ? qraw[r * D + d] : 0.f);
#pragma unroll
    for (int t = 0; t < 3; ++t) Qt[(t * RB + r) * ST + d] = s.t[t];
  }
  __syncthreads();  // the K/V buffers are written below
  // bf16 tiles are read as staged: zero their pad columns once
  if (K::DIRECT && DP > D)
    for (int i = tid; i < 2 * 2 * PK * (DP - D); i += PT) {
      const int row = i / (DP - D), d = D + i % (DP - D);
      reinterpret_cast<bf16*>(kvs)[row * ST + d] = __float2bfloat16_rn(0.f);
    }
  __syncthreads();  // qpos and qvalid are read by every warp below

  // ---- staging: keys [t0, t0 + PK) into buffer buf, keys past k_end
  // zero-filled and never read; cp.async, committed as one group
  const int cpr = D * ES / 16;  // 16-byte chunks per key row
  const long kv_row0 = (long)bh * Lk;
  if (PAGED) table += (long)b * nblk;
  auto dst_k = [&](int buf) -> char* {
    return K::DIRECT ? kvs + buf * 2 * PK * ST * 2 : kvs + buf * lay.raw;
  };
  const int kv_gap = K::DIRECT ? PK * ST * 2 : PK * D * ES;  // K -> V
  const int row_b = K::DIRECT ? ST * 2 : D * ES;             // key stride
  auto issue = [&](int t0, int buf) {
    char* dk = dst_k(buf);
    long my_row = 0;  // PAGED: the row of key t0 + lane, for the warp
    if (PAGED) {
      const int key = t0 + lane;
      if (key <= k_end)
        my_row = ((long)__ldg(table + key / bs) * Hkv + h) * bs + key % bs;
    }
    // PK * cpr is a multiple of 32, so a warp's lanes run the loop together
    for (int i = tid; i < PK * cpr; i += PT) {
      const int t = i / cpr, c = i % cpr, key = t0 + t;
      long row;
      if (PAGED)
        row = __shfl_sync(0xffffffffu, my_row, t);
      else
        row = kv_row0 + (key <= k_end ? key : 0);
      const int bytes = key <= k_end ? 16 : 0;
      cp_async16(dk + t * row_b + c * 16,
                 reinterpret_cast<const char*>(kv.k + row * D) + c * 16,
                 bytes);
      cp_async16(dk + kv_gap + t * row_b + c * 16,
                 reinterpret_cast<const char*>(kv.v + row * D) + c * 16,
                 bytes);
    }
    if (K::SCALED && tid < PK) {  // warp 0: lane t holds key t's row
      const int key = t0 + tid;
      const long row = PAGED ? my_row : kv_row0 + (key <= k_end ? key : 0);
      float* ks = reinterpret_cast<float*>(dk + 2 * kv_gap);
      const int bytes = key <= k_end ? 4 : 0;
      cp_async4(ks + tid, kv.ks + row, bytes);
      cp_async4(ks + PK + tid, kv.vs + row, bytes);
    }
    cp_async_commit();
  };
  // f32 / int8: the raw tile of buffer buf -> bf16 terms [K, V][3][PK][ST]
  // (pad columns 0); int8 dequantized on the way, as KVSource::scale4 does
  bf16* terms = reinterpret_cast<bf16*>(kvs + 2 * lay.raw);
  auto split_tile = [&](int buf) {
    const char* raw = kvs + buf * lay.raw;
    const float* scales = reinterpret_cast<const float*>(raw + 2 * kv_gap);
    const int per = PK * DP / 4;
    for (int i = tid; i < 2 * per; i += PT) {
      const int sel = i / per, j = i % per, t = j / (DP / 4),
                d = (j % (DP / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < D) {
        x = widen4(reinterpret_cast<const E*>(raw + sel * kv_gap) + t * D +
                   d);
        if (K::SCALED) x = KV::scale4(x, scales[sel * PK + t]);
      }
      const Split3 a = split3(x.x), b2 = split3(x.y), c = split3(x.z),
                   e = split3(x.w);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        *reinterpret_cast<uint2*>(terms + ((sel * 3 + s) * PK + t) * ST +
                                  d) =
            make_uint2(pack2(a.t[s], b2.t[s]), pack2(c.t[s], e.t[s]));
    }
  };

  // ---- per-warp state: rows ra = 16 warp + lane / 4 and rb = ra + 8; a
  // lane holds columns 2 (lane % 4) + {0, 1} of every 8-column tile
  const int wr = warp * 16, ra = wr + (lane >> 2), rb = ra + 8;
  const int qpa = qpos[ra], qpb = qpos[rb];
  const bool va = qvalid[ra], vb = qvalid[rb];
  const bool live = __any_sync(0xffffffffu, va || vb);
  WarpState w;
  w.init();

  issue(k_begin, 0);
  for (int it = 0; it < ntile; ++it) {
    const int t0 = k_begin + it * PK, buf = it & 1;
    if (it + 1 < ntile) {
      issue(t0 + PK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!K::DIRECT) {
      split_tile(buf);
      __syncthreads();
    }
    if (live) {
      // K and V term bases (bf16: the staged tile, one term)
      const bf16* kt = K::DIRECT ? reinterpret_cast<const bf16*>(dst_k(buf))
                                 : terms;
      const bf16* vt = K::DIRECT ? kt + PK * ST : terms + 3 * PK * ST;
      const TileOperands op{Qt + wr * ST, kt, vt, RB * ST, PK * ST, ST, DP};
      tile_step<K::DIRECT ? 1 : 3>(w, op, t0, lane, qpa, qpb, va, vb, Lk,
                                   true, window, scale, softcap);
    }
    __syncthreads();  // the buffers may be rewritten after this
  }

  // ---- one split: normalize and write; else store the partial, and the
  // last block of the row block merges the partials in split order
  const int c0 = (lane & 3) * 2;
  if (nlive == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      float* o = out_at(r);
      if (!o) continue;
      const bool v = half ? vb : va;
      const float den = fmaxf(half ? w.l_b : w.l_a, 1e-30f);
#pragma unroll
      for (int n = 0; n < MAX_NT; ++n) {
        const int d = n * 8 + c0;
        if (d < D)
          *reinterpret_cast<float2*>(o + d) =
              v ? make_float2(w.acc[n][2 * half] / den,
                              w.acc[n][2 * half + 1] / den)
                : make_float2(0.f, 0.f);
      }
    }
    return;
  }
  const long nblocks = (long)gridDim.x * gridDim.y * gridDim.z;
  const long rbi = (long)bh * gridDim.y + blockIdx.y;  // row block index
  const long base = rbi * gridDim.z;                   // its split 0
  float* wacc = work + (base + split) * RB * D;
  float* wml = work + nblocks * RB * D + (base + split) * RB * 2;
#pragma unroll
  for (int half = 0; half < 2 && live; ++half) {
    const int r = half ? rb : ra;
#pragma unroll
    for (int n = 0; n < MAX_NT; ++n) {
      const int d = n * 8 + c0;
      if (d < D)
        *reinterpret_cast<float2*>(wacc + r * D + d) =
            make_float2(w.acc[n][2 * half], w.acc[n][2 * half + 1]);
    }
    if ((lane & 3) == 0) {
      wml[r * 2] = half ? w.m_b : w.m_a;
      wml[r * 2 + 1] = half ? w.l_b : w.l_a;
    }
  }
  if (!splitk_arrive(counters + rbi, nlive)) return;
  // merge: two threads a row, each D / 8 of its 4-column chunks; from the
  // empty state (m = -1e30, l = 0, acc = 0; merging a partial into it
  // copies the partial exactly), each split in order, a split's loads all
  // issued before its arithmetic
  constexpr int MC = MAX_D / 8;  // chunks a thread
  const int r = tid >> 1, nc = (D / 4 + 1) / 2, c_lo = (tid & 1) * nc;
  const int nmine = min(nc, D / 4 - c_lo);
  float* o = out_at(r);
  if (!o) return;
  float4 a[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (qvalid[r]) {
    const float* ml = work + nblocks * RB * D + base * RB * 2 + r * 2;
    const float* pa = work + base * RB * D + r * D + c_lo * 4;
    float m = NEG_INF, l = 0.f;
    for (int sp = s_lo; sp <= s_hi; ++sp) {
      const float m2 = __ldcg(ml + sp * RB * 2);
      const float l2 = __ldcg(ml + sp * RB * 2 + 1);
      float4 a2[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < nmine)
          a2[j] = __ldcg(reinterpret_cast<const float4*>(
              pa + (long)sp * RB * D + j * 4));
      const float mn = fmaxf(m, m2);
      const float x1 = expf(m - mn), x2 = expf(m2 - mn);
      l = fmaf(l, x1, l2 * x2);
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        if (j < nmine) {
          a[j].x = fmaf(a[j].x, x1, a2[j].x * x2);
          a[j].y = fmaf(a[j].y, x1, a2[j].y * x2);
          a[j].z = fmaf(a[j].z, x1, a2[j].z * x2);
          a[j].w = fmaf(a[j].w, x1, a2[j].w * x2);
        }
      }
      m = mn;
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < MC; ++j)
      a[j] = make_float4(a[j].x / den, a[j].y / den, a[j].z / den,
                         a[j].w / den);
  }
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < nmine) *reinterpret_cast<float4*>(o + (c_lo + j) * 4) = a[j];
}

template <bool PAGED, class KV>
int launch(KV kv, const int* table, int nblk, int bs, const float* q,
           long qsb, long qsh, long qsl, const int* pos, const int* lengths,
           float* out, float* work, int* counters, int B, int Hkv, int group,
           int W, int bq, int D, int Lk, int span, int window, float scale,
           float softcap, cudaStream_t stream) {
  if (D % 4 || D > MAX_D || (D * Kind<KV>::ES) % 16 || bq < 1 || bq > W ||
      qsb % 4 || qsh % 4 || qsl % 4 || span < PK || span % PK || !work ||
      !counters ||
      (PAGED && (bs < 1 || nblk < 1 || !table)))
    return (int)cudaErrorInvalidValue;
  const long rblocks = (long)((W + bq - 1) / bq) * ((group * bq + RB - 1) / RB);
  const long splits = (Lk + span - 1) / span;
  if (rblocks > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = Smem<KV>(D).bytes();
  cudaError_t err = allow_smem(flash_prefill_kernel<KV, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (unsigned)rblocks, (unsigned)splits);
  flash_prefill_kernel<KV, PAGED><<<grid, PT, smem, stream>>>(
      kv, q, qsb, qsh, qsl, pos, lengths, out, work, counters, Hkv, group, W,
      bq, D, Lk, span, window, scale, softcap, table, nblk, bs);
  return (int)cudaGetLastError();
}

}  // namespace prefill
}  // namespace repro

// q: (B, Hq, W, D) f32 with element strides (qsb, qsh, qsl, 1), each a
// multiple of 4 (16-byte query rows);
// k, v: (B, Hkv, Lk, D) contiguous, bf16 / f32 / int8 by kv_kind;
// k_scale, v_scale: (B, Hkv, Lk, 1) f32 (int8 only, else null);
// pos, lengths: (B,) int32 on the device; out: (B, Hq, W, D) f32
// contiguous. work: f32 workspace of B * Hkv * R * S * 64 * (D + 2)
// floats and counters: B * Hkv * R zeroed int32 (left zeroed), where R =
// ceil(W / bq) * ceil(group * bq / 64) row blocks and S = ceil(Lk / span)
// splits (kernels/flash_attention/prefill.py prefill_plan). span: keys per
// split, a multiple of 32. D <= 128, D a multiple of 4 and D * element size
// of 16 bytes, 1 <= bq <= W. window <= 0 means none; softcap <= 0 means
// none. Returns cudaError_t.
extern "C" int flash_prefill(int kv_kind, const void* q, long long qsb,
                             long long qsh, long long qsl, const void* k,
                             const void* v, const void* k_scale,
                             const void* v_scale, const void* pos,
                             const void* lengths, void* out, void* work,
                             void* counters, int B, int Hkv, int group, int W,
                             int bq, int D, int Lk, int span, int window,
                             float scale, float softcap, void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return prefill::launch<false>(
        kv, nullptr, 0, 0, static_cast<const float*>(q), qsb, qsh, qsl,
        static_cast<const int*>(pos), static_cast<const int*>(lengths),
        static_cast<float*>(out), static_cast<float*>(work),
        static_cast<int*>(counters), B, Hkv, group, W, bq, D, Lk, span,
        window, scale, softcap, static_cast<cudaStream_t>(stream));
  });
}

// Paged: k, v: (P, Hkv, bs, D) block pools, k_scale, v_scale: (P, Hkv, bs,
// 1); table: (B, nblk) int32 on the device, row b's logical block j at
// physical block table[b, j] (every entry a row's frontier reaches must
// name a block of the pool); the row's keys are positions [0, nblk * bs),
// so Lk = nblk * bs. The rest as flash_prefill.
extern "C" int flash_prefill_paged(int kv_kind, const void* q, long long qsb,
                                   long long qsh, long long qsl,
                                   const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* pos,
                                   const void* lengths, void* out, void* work,
                                   void* counters, int B, int Hkv, int group,
                                   int W, int bq, int D, int nblk, int bs,
                                   int span, int window, float scale,
                                   float softcap, void* stream) {
  using namespace repro;
  return with_kv_source(kv_kind, k, v, k_scale, v_scale, [&](auto kv) {
    return prefill::launch<true>(
        kv, static_cast<const int*>(table), nblk, bs,
        static_cast<const float*>(q), qsb, qsh, qsl,
        static_cast<const int*>(pos), static_cast<const int*>(lengths),
        static_cast<float*>(out), static_cast<float*>(work),
        static_cast<int*>(counters), B, Hkv, group, W, bq, D, nblk * bs,
        span, window, scale, softcap, static_cast<cudaStream_t>(stream));
  });
}
