"""GQA attention block with a per-row KV cache: QKV bias (qwen2), logit
softcap and sliding window, and the int8 KV cache format.

The caches are updated IN PLACE: each step writes its new K/V into the
preallocated (B, Hkv, max_len, D) buffers and advances `pos`. That takes
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

__all__ = ["KVCache", "QuantKVCache", "init_kv_cache", "Attention"]


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


def _cached_attn(q, ck, cv, start, causal, window, softcap, lengths=None,
                 k_scale=None, v_scale=None):
    """Cache attention: row b's query positions start[b]..start[b]+l-1 over
    a cache of static length; the per-row offset lines the causal mask up
    and also masks the not-yet-written tail. With k_scale/v_scale, ck/cv are
    int8 codes (dequantized inside the kernels or at dispatch). A bf16 cache
    goes to the kernels as it is stored: they widen it to f32 as they read
    it (bf16 -> f32 is exact); the ref route widens it up front."""
    return aio_ops.attention(q, ck, cv, causal=causal, window=window,
                             softcap=softcap, offset=start, lengths=lengths,
                             k_scale=k_scale, v_scale=v_scale)


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
        """
        b, l, _ = x.shape
        q = _split_heads(self.q(x), self.n_heads)
        k = _split_heads(self.k(x), self.n_kv)
        v = _split_heads(self.v(x), self.n_kv)

        if cache is None:
            positions = torch.arange(l, device=x.device)
            q, k = rope(q, positions, self.rope_theta), \
                rope(k, positions, self.rope_theta)
            out = aio_ops.attention(q, k, v, causal=causal,
                                    window=self.window, softcap=self.softcap)
            return self.o(_merge_heads(out))

        start = cache.pos
        positions = start[:, None] + torch.arange(l, device=x.device)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        keep_row = None if lengths is None else lengths > 0
        if isinstance(cache, QuantKVCache):
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
        return self.o(_merge_heads(out))
