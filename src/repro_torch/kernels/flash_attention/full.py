"""Full-sequence flash attention (forward): the kernel of the
`attention_route` "cuda" route — 128-aligned, scalar-offset, unquantized
calls, which the full-sequence forward makes in every layer.

`flash_attention` launches the CUDA kernel of `csrc/flash_full.cu` on CUDA
tensors (its K/V split into bf16 terms first, into a workspace sized by
`full_workspace`, then the tensor-core kernel over them: one launch of the
entry point) and runs `flash_attention_plain` on CPU tensors; it counts its
kernel launches in `flash_attention.launches`. q is (B, Hq, Lq, D) and k, v
are (B, Hkv, Lk, D), f32 or bf16 (q's type and K/V's may differ; the output
has q's), any of them a strided view with a unit-stride last dimension (the
head split of a projection). GQA maps q-head h to kv-head h // (Hq / Hkv);
query i sits at position offset + i; Lk is any length (the tail is masked,
not padded).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import call_kernel, check_cuda
from .shared import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain", "full_workspace"]

_DTYPES = (torch.float32, torch.bfloat16)
_LL, _P, _I, _F = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, \
    ctypes.c_float
# q/kv types; q, k, v pointers with 3 strides each; out, workspace; B, Hq,
# Hkv, Lq, Lk, D, offset, causal, window; scale, softcap
_ARGTYPES = [_I, _I] + ([_P] + [_LL] * 3) * 3 + [_P] * 2 + [_I] * 9 \
    + [_F] * 2


def full_workspace(b: int, hkv: int, lk: int, d: int, kv_bf16: bool) -> int:
    """bf16 elements of the kernel's K/V term workspace: for each of B x
    Hkv kv-rows, K and V in T terms (1 for bf16 K/V, 3 for f32) of Lk rows
    of D padded to 16."""
    terms = 1 if kv_bf16 else 3
    return b * hkv * 2 * terms * lk * (-(-d // 16) * 16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, offset: int = 0,
                          bk: int = 128) -> torch.Tensor:
    """Plain version, the reference kernel's arithmetic block by block:
    f32 scores, softcap before the mask, the finite -1e30 mask (kpos < Lk,
    causal kpos <= qpos, window kpos > qpos - window, qpos = i + offset),
    an online softmax over bk-key blocks (K/V zero-padded to a multiple of
    bk, as the reference pads them), and acc / max(l, 1e-30)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    dev = q.device
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    m = torch.full((b, hq, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, lq, d), dtype=torch.float32, device=dev)
    qpos = int(offset) + torch.arange(lq, device=dev)[:, None]
    for k0 in range(0, lk, bk):
        kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        if kb.shape[2] < bk:                     # the zero-padded tail
            pad = (0, 0, 0, bk - kb.shape[2])
            kb = torch.nn.functional.pad(kb, pad)
            vb = torch.nn.functional.pad(vb, pad)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = k0 + torch.arange(bk, device=dev)[None, :]
        keep = kpos < lk
        if causal:
            keep = keep & (kpos <= qpos)
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.where(keep, s, torch.full((), NEG_INF, device=dev))
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_cur
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _check(q, k, v, window, softcap):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Hq, Lq, D) and equal "
                         "(B, Hkv, Lk, D)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] < 1:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if d % 4 or d > 128:
        raise ValueError(f"head_dim {d} must be a multiple of 4 and at most "
                         "128 (a warp's accumulator holds 128 columns)")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: want "
                        "float32 or bfloat16, k and v alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, contiguous=False)
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit-stride last dimension and "
                             "strides that are multiples of 4 elements (the "
                             "kernel reads rows 4 elements at a time)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (module docstring); offset is a scalar."""
    offset = int(offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     offset=offset)
    _check(q, k, v, window, softcap)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    if lq == 0 or b == 0:
        return out
    kv_bf16 = k.dtype == torch.bfloat16
    work = torch.empty(full_workspace(b, hkv, lk, d, kv_bf16),
                       dtype=torch.bfloat16, device=q.device)
    call_kernel("flash_attention_full", _ARGTYPES,
                int(q.dtype == torch.bfloat16), int(kv_bf16),
                q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                v.data_ptr(), *v.stride()[:3], out.data_ptr(),
                work.data_ptr(), b, hq, hkv, lq, lk, d, offset, int(causal),
                window or 0,
                d ** -0.5 if scale is None else scale, softcap or 0.0,
                source="flash_full")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
