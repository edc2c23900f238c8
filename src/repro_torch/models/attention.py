"""GQA attention block with a KV cache: QKV bias (qwen2), logit softcap
and sliding window, the int8 KV cache format, and the paged block-pool
layout of both; and the encoder-decoder cross attention (whisper), which
has neither RoPE nor a cache.

The caches are updated IN PLACE: each step writes its new K/V into the
preallocated (B, Hkv, max_len, D) buffers, or into the (P, Hkv, bs, D)
block pool through each row's block table, and advances `pos`. That takes
the place of the JAX engine's buffer donation (`donate_argnums`): no step
copies the KV residency.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..api import ops as aio_ops
from ..core.formats import pow2_ceil
from .layers import Linear, QuantPolicy, rope

__all__ = ["KVCache", "QuantKVCache", "PagedKVCache", "PagedQuantKVCache",
           "PAGED_TYPES", "init_kv_cache", "init_paged_kv_cache",
           "paged_kv_cache", "striped_table", "pool_fields",
           "pool_block_values", "store_pool_blocks", "Attention",
           "CrossAttention"]


@dataclasses.dataclass
class KVCache:
    """Preallocated decode cache. k/v: (B, Hkv, L_max, D); pos: (B,) int32 —
    every batch row ("slot" in the serving engine) sits at its own
    position."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


@dataclasses.dataclass
class QuantKVCache:
    """INT8 KV cache: int8 codes with a per-(row, head, position)
    power-of-two scale; dequantized at attention time (inside the kernels).
    pos: (B,) per-row vector, like KVCache."""
    k_codes: torch.Tensor      # (B, Hkv, L, D) int8
    k_scale: torch.Tensor      # (B, Hkv, L, 1) f32, power of two
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    pos: torch.Tensor


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool decode cache: all rows share one pool of fixed-size KV
    blocks, and row b's logical block j is physical block table[b, j], so
    rows pay only for the context they hold and equal prompt prefixes can
    alias the same blocks (copy-on-write, managed by the serving engine).

    k/v:   (P + 1, Hkv, bs, D) — P pool blocks of bs positions, then one
           trash block (index P) that no table names: writes the update
           drops (pad tokens, positions past the table) land there
    table: (B, nblk) int32 — per-row logical -> physical block map
    pos:   (B,) — per-row write frontier, as KVCache.pos
    """
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    pos: torch.Tensor


@dataclasses.dataclass
class PagedQuantKVCache:
    """INT8 block-pool cache: the PagedKVCache layout with QuantKVCache
    formats — codes (P + 1, Hkv, bs, D) int8, scales (P + 1, Hkv, bs, 1) f32
    pow2, the last block the trash block."""
    k_codes: torch.Tensor
    k_scale: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    table: torch.Tensor
    pos: torch.Tensor


PAGED_TYPES = (PagedKVCache, PagedQuantKVCache)


def init_kv_cache(batch: int, n_kv: int, max_len: int, head_dim: int, *,
                  device, dtype=torch.bfloat16, quantized: bool = False):
    pos = torch.zeros(batch, dtype=torch.int32, device=device)
    shape = (batch, n_kv, max_len, head_dim)
    if quantized:
        sshape = (batch, n_kv, max_len, 1)
        return QuantKVCache(
            k_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            v_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            pos=pos)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=pos)


def striped_table(batch: int, nblk: int, pool_blocks: int, *,
                  device) -> torch.Tensor:
    """The (batch, nblk) int32 striped identity block table (row b's
    logical block j -> physical (b * nblk + j) mod P): a fresh paged cache
    behaves like per-slot stripes until an allocator rewrites it."""
    return ((torch.arange(batch, device=device)[:, None] * nblk
             + torch.arange(nblk, device=device)[None, :])
            % pool_blocks).to(torch.int32)


def paged_kv_cache(table: torch.Tensor, pos: torch.Tensor, **pools):
    """The port's paged cache over P-block pools, given as k, v (a
    PagedKVCache) or k_codes, k_scale, v_codes, v_scale (a
    PagedQuantKVCache): each pool gets the trash block appended (zeros,
    ones for the scales). With `_paged_update`, the one place that knows
    the trash block exists; callers see P blocks."""
    def grow(name, pool):
        trash = torch.full((1,) + tuple(pool.shape[1:]),
                           1.0 if name.endswith("_scale") else 0.0,
                           dtype=pool.dtype, device=pool.device)
        return torch.cat([pool, trash])

    kind = PagedQuantKVCache if "k_codes" in pools else PagedKVCache
    return kind(table=table, pos=pos,
                **{name: grow(name, p) for name, p in pools.items()})


def init_paged_kv_cache(n_kv: int, pool_blocks: int, block_size: int,
                        head_dim: int, table: torch.Tensor, *,
                        dtype=torch.bfloat16, quantized: bool = False):
    """Block-pool cache init: empty pools of pool_blocks blocks, read
    through `table` (B, nblk), used as it is (the layers of a model share
    one table tensor), on the table's device."""
    device = table.device
    pos = torch.zeros(table.shape[0], dtype=torch.int32, device=device)
    shape = (pool_blocks, n_kv, block_size, head_dim)
    if quantized:
        sshape = shape[:3] + (1,)
        return paged_kv_cache(
            table, pos,
            k_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            v_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=device))
    return paged_kv_cache(table, pos,
                          k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device))


def pool_fields(cache) -> tuple:
    """The names of a paged cache's block pools, in field order."""
    if isinstance(cache, PagedKVCache):
        return ("k", "v")
    if isinstance(cache, PagedQuantKVCache):
        return ("k_codes", "k_scale", "v_codes", "v_scale")
    raise TypeError(f"not a paged cache: {type(cache).__name__}")


def pool_block_values(cache, ids: torch.Tensor) -> dict:
    """Physical pool blocks `ids` ((C,) long, on the cache's device) of one
    paged cache: each pool narrowed to those C blocks, as new tensors
    {name: (C, Hkv, bs, X)}. `store_pool_blocks` is its exact inverse; the
    two are the device halves of KV block swap-out and swap-in."""
    return {name: getattr(cache, name).index_select(0, ids)
            for name in pool_fields(cache)}


def store_pool_blocks(cache, values: dict, dst: torch.Tensor) -> None:
    """Write `pool_block_values`-shaped block contents into the pools at
    physical blocks `dst` ((C,) long), in place (the pool tensors keep
    their storage). A destination equal to the pool size P is padding: it
    lands in the trash block P, which no table names — so a fixed-width,
    sentinel-padded `dst` writes only the real blocks (the reference's
    `mode="drop"`)."""
    for name in pool_fields(cache):
        pool = getattr(cache, name)
        pool.index_copy_(0, dst, values[name].to(pool.device, pool.dtype))


def _cache_heads(cache) -> int:
    """The KV heads a (flat or paged, dense or int8) cache holds."""
    return (cache.k_codes if hasattr(cache, "k_codes") else cache.k).shape[1]


def _q8(x: torch.Tensor):
    """Per-(b, h, position) row int8 quantization with a pow2 scale.
    torch.round is half-to-even, like jnp.round."""
    amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    scale = pow2_ceil(amax.to(torch.float32) / 127.0)
    codes = torch.clamp(torch.round(x.to(torch.float32) / scale),
                        -128, 127).to(torch.int8)
    return codes, scale


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, n, -1).transpose(1, 2)           # (B, H, L, D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _row_update(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                keep_row: Optional[torch.Tensor] = None) -> None:
    """Per-row cache write, in place. buf: (B, H, L_max, X); new: (B, H, l,
    X); start: (B,) — row b's new tokens land at start[b]..start[b]+l-1.

    Positions at or past L_max are DROPPED (never clamped: a clamped window
    would shift a final partial chunk's valid tokens onto wrong positions);
    rows where keep_row is False keep their contents. Done without a host
    sync: every row rewrites a window of l distinct positions
    [min(start, L_max - l), +l), which covers all its in-range targets, with
    the new value where it lands and the old value elsewhere.
    """
    b, _, lmax, _ = buf.shape
    l = new.shape[2]
    ar = torch.arange(l, device=buf.device)
    base = start.clamp(max=lmax - l)
    wpos = base[:, None] + ar                                 # (B, l)
    rel = wpos - start[:, None]                               # < l always
    take = rel >= 0
    if keep_row is not None:
        take = take & keep_row[:, None]
    rows = torch.arange(b, device=buf.device)[:, None]
    # advanced indices (rows, wpos) lead: these views are (B, l, H, X)
    old = buf[rows, :, wpos]
    fresh = new.to(buf.dtype).transpose(1, 2)[rows, rel.clamp(min=0)]
    buf[rows, :, wpos] = torch.where(take[..., None, None], fresh, old)


def _paged_update(updates, start: torch.Tensor, table: torch.Tensor,
                  lengths: Optional[torch.Tensor]) -> None:
    """Scatter (B, H, l, X) updates into (P + 1, H, bs, X) block pools, in
    place; `updates` holds (pool, new) pairs of one layout (the K and V
    pools, with the int8 scales), which share one index computation.
    Token i of row b lands at physical block table[b, (start[b] + i) //
    bs], offset (start[b] + i) % bs. Positions at or past lengths[b] (right
    pad, or a row sitting the launch out) or past the table's reach are
    DROPPED: written to the trash block P, which no table names, never
    clamped onto a live position. Valid writes of one call never alias: a
    row writes only positions at or past its frontier, which lie in blocks
    it owns alone (shared prefix blocks end below it; the engine forks the
    boundary block). No host sync: start and lengths stay on the device."""
    pool, new = updates[0]
    l, trash, bs = new.shape[2], pool.shape[0] - 1, pool.shape[2]
    nblk = table.shape[1]
    tok = start[:, None].long() + torch.arange(l, device=pool.device)
    lb = tok // bs                                           # (B, l)
    phys = torch.gather(table.long(), 1, lb.clamp(max=nblk - 1))
    valid = lb < nblk
    if lengths is not None:
        valid &= torch.arange(l, device=pool.device)[None, :] \
            < lengths[:, None]
    phys, off = torch.where(valid, phys, trash), tok % bs
    for pool, new in updates:
        # advanced indices around a slice: the view is (B, l, H, X)
        pool[phys, :, off] = new.to(pool.dtype).transpose(1, 2)


def _cached_attn(q, ck, cv, start, causal, window, softcap, lengths=None,
                 k_scale=None, v_scale=None, block_tables=None):
    """Cache attention: row b's query positions start[b]..start[b]+l-1 over
    a cache of static length; the per-row offset lines the causal mask up
    and also masks the not-yet-written tail. With k_scale/v_scale, ck/cv are
    int8 codes (dequantized inside the kernels or at dispatch); with
    block_tables, they are block pools. A bf16 cache goes to the kernels as
    it is stored: they widen it to f32 as they read it (bf16 -> f32 is
    exact); the ref route widens it up front."""
    return aio_ops.attention(q, ck, cv, causal=causal, window=window,
                             softcap=softcap, offset=start, lengths=lengths,
                             k_scale=k_scale, v_scale=v_scale,
                             block_tables=block_tables)


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 qkv_bias: bool = False, *, rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None, gen=None, device="cuda",
                 dtype=torch.float32, policy: QuantPolicy = QuantPolicy()):
        super().__init__()
        kw = dict(gen=gen, device=resolve_device(device), dtype=dtype,
                  policy=policy)
        self.q = Linear(d_model, n_heads * head_dim, qkv_bias, **kw)
        self.k = Linear(d_model, n_kv * head_dim, qkv_bias, **kw)
        self.v = Linear(d_model, n_kv * head_dim, qkv_bias, **kw)
        self.o = Linear(n_heads * head_dim, d_model, False, **kw)
        self.n_heads, self.n_kv = n_heads, n_kv
        self.rope_theta = rope_theta
        self.window, self.softcap = window, softcap

    def _tp_heads(self) -> int:
        """The model-parallel ranks this rank's heads are split over: R
        when q, k and v are column-parallel and o row-parallel over R ranks,
        the q and the kv heads both divide by R (so a rank's q heads and
        their kv heads are its own) and nothing is quantized; else 1 (a
        sharded weight is then all-gathered and the heads computed
        replicated)."""
        mods = (self.q, self.k, self.v, self.o)
        if not all(m.tp == t for m, t in zip(mods, ("col",) * 3 + ("row",))):
            return 1
        ranks = self.q.shards["w"][2]
        if self.n_heads % ranks or self.n_kv % ranks \
                or any(m.policy.active for m in mods):
            return 1
        return ranks

    def cache_heads(self) -> int:
        """The KV heads this rank's cache holds: its own under head
        parallelism (n_kv / R), else all of them."""
        return self.n_kv // self._tp_heads()

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                cache=None, lengths: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Self attention. With a cache, x holds the new token(s) and
        attends to cache[:pos[b]] + x per batch row; the cache is updated in
        place.

        lengths: optional (B,) count of VALID new tokens per row. Rows with
        lengths[b] == 0 keep their cache and position untouched; rows with
        0 < lengths[b] < l advance by lengths[b], so the pad tail is never
        inside any row's causal frontier.

        Under head parallelism (`_tp_heads` R > 1) the cache holds this
        rank's n_kv / R heads (`init_caches(..., model=)`); a cache of
        another head count raises ValueError.
        """
        b, l, _ = x.shape
        ranks = self._tp_heads()
        if cache is not None and _cache_heads(cache) != self.n_kv // ranks:
            raise ValueError(
                f"a cache of {_cache_heads(cache)} KV heads for an attention "
                f"layer that holds {self.n_kv // ranks} on this rank; build "
                "the caches with init_caches(..., model=)")
        if ranks > 1:          # this rank's heads; o all-reduces
            q = _split_heads(self.q.local(x), self.n_heads // ranks)
            k = _split_heads(self.k.local(x), self.n_kv // ranks)
            v = _split_heads(self.v.local(x), self.n_kv // ranks)
        else:
            q = _split_heads(self.q(x), self.n_heads)
            k = _split_heads(self.k(x), self.n_kv)
            v = _split_heads(self.v(x), self.n_kv)

        if cache is None:
            positions = torch.arange(l, device=x.device)
            q, k = rope(q, positions, self.rope_theta), \
                rope(k, positions, self.rope_theta)
            out = aio_ops.attention(q, k, v, causal=causal,
                                    window=self.window, softcap=self.softcap)
            if ranks > 1:
                return self.o.local(_merge_heads(out))
            return self.o(_merge_heads(out))

        start = cache.pos
        positions = start[:, None] + torch.arange(l, device=x.device)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        keep_row = None if lengths is None else lengths > 0
        if isinstance(cache, PagedQuantKVCache):
            kc, ks = _q8(k)
            vc, vs = _q8(v)
            _paged_update(((cache.k_codes, kc), (cache.k_scale, ks),
                           (cache.v_codes, vc), (cache.v_scale, vs)),
                          start, cache.table, lengths)
            out = _cached_attn(q, cache.k_codes, cache.v_codes, start, True,
                               self.window, self.softcap, lengths=lengths,
                               k_scale=cache.k_scale, v_scale=cache.v_scale,
                               block_tables=cache.table)
        elif isinstance(cache, PagedKVCache):
            _paged_update(((cache.k, k), (cache.v, v)), start, cache.table,
                          lengths)
            out = _cached_attn(q, cache.k, cache.v, start, True, self.window,
                               self.softcap, lengths=lengths,
                               block_tables=cache.table)
        elif isinstance(cache, QuantKVCache):
            kc, ks = _q8(k)
            vc, vs = _q8(v)
            for buf, new in ((cache.k_codes, kc), (cache.k_scale, ks),
                             (cache.v_codes, vc), (cache.v_scale, vs)):
                _row_update(buf, new, start, keep_row)
            # codes + scales go to attention unmaterialized: the kernels
            # dequantize tile by tile
            out = _cached_attn(q, cache.k_codes, cache.v_codes, start, True,
                               self.window, self.softcap, lengths=lengths,
                               k_scale=cache.k_scale, v_scale=cache.v_scale)
        else:
            _row_update(cache.k, k, start, keep_row)
            _row_update(cache.v, v, start, keep_row)
            out = _cached_attn(q, cache.k, cache.v, start, True, self.window,
                               self.softcap, lengths=lengths)
        cache.pos = start + (l if lengths is None
                             else lengths.to(start.dtype))
        if ranks > 1:
            return self.o.local(_merge_heads(out))
        return self.o(_merge_heads(out))


class CrossAttention(nn.Module):
    """Encoder-decoder cross attention (whisper's decoder): q from x, k and
    v from the encoder's `memory` (B, T, d_model), recomputed every call
    (no cache, as in the reference), no RoPE; non-causal, so the call goes
    where `attention_route` sends it (the full-sequence kernel for a
    128-aligned query, the `ref` route otherwise)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, gen=None, device="cuda", dtype=torch.float32,
                 policy: QuantPolicy = QuantPolicy()):
        super().__init__()
        kw = dict(gen=gen, device=resolve_device(device), dtype=dtype,
                  policy=policy)
        self.q = Linear(d_model, n_heads * head_dim, **kw)
        self.k = Linear(d_model, n_kv * head_dim, **kw)
        self.v = Linear(d_model, n_kv * head_dim, **kw)
        self.o = Linear(n_heads * head_dim, d_model, **kw)
        self.n_heads, self.n_kv = n_heads, n_kv

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        q = _split_heads(self.q(x), self.n_heads)
        k = _split_heads(self.k(memory), self.n_kv)
        v = _split_heads(self.v(memory), self.n_kv)
        out = aio_ops.attention(q, k, v, causal=False)
        return self.o(_merge_heads(out))
