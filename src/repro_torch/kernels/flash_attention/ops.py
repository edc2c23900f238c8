"""Attention: registry implementations.

"cuda" is the full-sequence flash kernel (128-aligned, scalar-offset,
unquantized calls: the cacheless attention of the full-sequence forward);
"cuda-prefill" is the varlen flash-prefill kernel (multi-token right-padded
chunks over a cache at per-row positions); "cuda-decode" is the
flash-decode kernel (short Lq over a long per-row cache); "ref" is the
plain eager reference. `repro_torch.api.ops.attention` owns the dispatch
(see `attention_route`).

Every impl accepts optional `k_scale`/`v_scale`: when given, k/v are int8
codes with per-position pow2 scales (the QuantKVCache layout) and the impl
dequantizes — inside the kernels, up front on the ref route. Every impl
also accepts `lengths`: the varlen prefill kernel zeroes rows past it; the
others ignore it (their outputs at invalid positions are never consumed).
And every impl accepts `block_tables`: when given, k/v (and the scales)
are (P, Hkv, bs, .) block pools and block_tables the (B, nblk) int32
per-row map — the kernels read through it, the ref route gathers the pages
(`pool[table]`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register
from .full import flash_attention
from .decode import (flash_decode, flash_decode_paged,
                     flash_decode_paged_quant, flash_decode_quant)
from .prefill import (flash_prefill, flash_prefill_paged,
                      flash_prefill_paged_quant, flash_prefill_quant)
from .ref import chunked_attention, mha_ref
from .shared import dequant, gather_pages

__all__ = ["REF_ONE_SHOT_SCORES"]

# The most scores (Lq x Lk) the ref route materializes in one piece; past it
# it walks the keys in `policy.chunk` blocks (the reference's rule).
REF_ONE_SHOT_SCORES = 4096 * 8192


def _maybe_dequant(q, k, v, k_scale, v_scale):
    if k_scale is None:
        return k, v
    return dequant(k, k_scale, q.dtype), dequant(v, v_scale, q.dtype)


@register("attention", "cuda")
def _attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, offset=0,
                    lengths: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    policy: ExecutionPolicy) -> torch.Tensor:
    assert block_tables is None, \
        "the full-sequence kernel has no paged route (dispatch sends paged " \
        "cache-shaped calls to cuda-prefill/cuda-decode/ref)"
    k, v = _maybe_dequant(q, k, v, k_scale, v_scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, offset=offset)


@register("attention", "cuda-prefill")
def _attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None, offset=0,
                       lengths: Optional[torch.Tensor] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       block_tables: Optional[torch.Tensor] = None,
                       policy: ExecutionPolicy) -> torch.Tensor:
    assert causal, "the varlen prefill kernel is causal by construction"
    if block_tables is not None:
        if k_scale is not None:
            return flash_prefill_paged_quant(
                q, k, k_scale, v, v_scale, table=block_tables, pos=offset,
                lengths=lengths, window=window, softcap=softcap, scale=scale,
                bq=policy.bq)
        return flash_prefill_paged(q, k, v, table=block_tables, pos=offset,
                                   lengths=lengths, window=window,
                                   softcap=softcap, scale=scale, bq=policy.bq)
    if k_scale is not None:
        return flash_prefill_quant(q, k, k_scale, v, v_scale, pos=offset,
                                   lengths=lengths, window=window,
                                   softcap=softcap, scale=scale, bq=policy.bq)
    return flash_prefill(q, k, v, pos=offset, lengths=lengths, window=window,
                         softcap=softcap, scale=scale, bq=policy.bq)


@register("attention", "cuda-decode")
def _attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None, offset=0,
                      lengths: Optional[torch.Tensor] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      block_tables: Optional[torch.Tensor] = None,
                      policy: ExecutionPolicy) -> torch.Tensor:
    assert causal, "the decode kernel is causal by construction"
    if block_tables is not None:
        if k_scale is not None:
            return flash_decode_paged_quant(
                q, k, k_scale, v, v_scale, table=block_tables, pos=offset,
                window=window, softcap=softcap, scale=scale, bkv=policy.bkv)
        return flash_decode_paged(q, k, v, table=block_tables, pos=offset,
                                  window=window, softcap=softcap, scale=scale,
                                  bkv=policy.bkv)
    if k_scale is not None:
        return flash_decode_quant(q, k, k_scale, v, v_scale, pos=offset,
                                  window=window, softcap=softcap, scale=scale,
                                  bkv=policy.bkv)
    return flash_decode(q, k, v, pos=offset, window=window, softcap=softcap,
                        scale=scale, bkv=policy.bkv)


@register("attention", "ref")
def _attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None, offset=0,
                   lengths: Optional[torch.Tensor] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None,
                   block_tables: Optional[torch.Tensor] = None,
                   policy: ExecutionPolicy) -> torch.Tensor:
    if block_tables is not None:
        # gather codes AND scales through the table, then dequantize: the
        # values of dequantize-then-gather, without an f32 pool copy
        k, v = gather_pages(k, block_tables), gather_pages(v, block_tables)
        if k_scale is not None:
            k_scale = gather_pages(k_scale, block_tables)
            v_scale = gather_pages(v_scale, block_tables)
    k, v = _maybe_dequant(q, k, v, k_scale, v_scale)
    lq, lk = q.shape[2], k.shape[2]
    # One-shot scores up to 4k x 8k: under layer-level remat the score
    # matrix is transient, and autograd through it is cheap. Past that the
    # online-softmax walk, with or without grad, as the reference does.
    if lq == 1 or lq * lk <= REF_ONE_SHOT_SCORES:
        return mha_ref(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale, offset=offset)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, offset=offset,
                             chunk=policy.chunk)
