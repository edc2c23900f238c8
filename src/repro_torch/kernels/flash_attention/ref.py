"""Attention references: the naive oracle and the memory-bounded chunked
implementation. Both support GQA, causal masking at a scalar or per-row
offset, sliding window and logit softcapping.

`mha_ref` materializes the full score matrix: the test oracle, and the
`ref` route up to 4096 x 8192 scores. `chunked_attention` walks the keys
in `chunk`-long blocks with an online softmax, O(Lq x chunk) live memory a
head: the `ref` route past that size (`ops._attention_ref`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .shared import NEG_INF

__all__ = ["mha_ref", "chunked_attention"]


def _mask(lq: int, lk: int, causal: bool, window: Optional[int], offset,
          device) -> torch.Tensor:
    """Boolean keep-mask. offset = kv length already cached, so query i sits
    at absolute position offset + i. offset may be a scalar -> (lq, lk) mask,
    or a per-batch-row vector (B,) -> (B, lq, lk) mask (continuous batching:
    each row's cache is at its own position, and the per-row causal frontier
    is what masks a row's not-yet-valid / pad key slots)."""
    off = torch.as_tensor(offset, device=device)
    qpos = off[..., None, None] + torch.arange(lq, device=device)[:, None]
    kpos = torch.arange(lk, device=device)[None, :]
    keep = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool, device=device)
    if causal:
        keep = keep & (kpos <= qpos)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


def _apply_mask(s: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """s: (B, H, lq, lk); keep: (lq, lk) or (B, lq, lk)."""
    keep = keep[None, None] if keep.dim() == 2 else keep[:, None]
    return torch.where(keep, s, torch.full((), NEG_INF, dtype=s.dtype,
                                           device=s.device))


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None, scale: Optional[float] = None,
            offset=0) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k,v: (B, Hkv, Lk, D) -> (B, Hq, Lq, D).

    offset: scalar or per-row (B,) query-position offset (see _mask)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kr = k.repeat_interleave(group, dim=1).to(torch.float32)
    vr = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * scale
    s = _softcap(s, softcap)
    s = _apply_mask(s, _mask(lq, lk, causal, window, offset, q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None, offset=0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over `chunk`-long key blocks: the
    reference's scan, step for step, as a loop. q: (B, Hq, Lq, D); k,v:
    (B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's dtype.

    K/V are zero-padded to a multiple of `chunk` and the pad keys masked
    (kpos < Lk). A masked score is -1e30 (softcap first), so a row with no
    valid key in a block weighs that block's keys equally until a valid key
    rescales them away (alpha = exp(m - m_new) = 0); a row with none at all
    ends as the mean of every (padded) key's value, as the reference's
    scan gives."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    nchunks = -(-lk // chunk)
    pad = nchunks * chunk - lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.to(torch.float32)
    off = torch.as_tensor(offset, device=dev)
    # (lq, 1) for a scalar offset, (B, lq, 1) for per-row offsets
    qpos = off[..., None, None] + torch.arange(lq, device=dev)[:, None]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    m = torch.full((b, hq, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, lq, d), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        blk = slice(c * chunk, (c + 1) * chunk)
        kq = k[:, :, blk].repeat_interleave(group, dim=1).to(torch.float32)
        vq = v[:, :, blk].repeat_interleave(group, dim=1).to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kq) * scale
        s = _softcap(s, softcap)
        kpos = c * chunk + torch.arange(chunk, device=dev)[None, :]
        keep = (kpos < lk).expand(torch.broadcast_shapes(qpos.shape,
                                                         kpos.shape))
        if causal:
            keep = keep & (kpos <= qpos)
        if window is not None:
            keep = keep & (kpos > qpos - window)
        keep = keep[None, None] if keep.dim() == 2 else keep[:, None]
        s = torch.where(keep, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vq)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)
