"""Attention reference: the naive oracle that materializes the full score
matrix. Supports GQA, causal masking at a scalar or per-row offset, sliding
window and logit softcapping. This is the `ref` route and the test oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from .shared import NEG_INF

__all__ = ["mha_ref"]


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
