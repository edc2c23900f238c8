"""Helpers shared by the serving attention kernels (decode + varlen
prefill, flat and paged): the masked-score sentinel, per-row scalar-vector
normalization, the int8-KV dequant rounding rule, the page gather of the
plain versions, and the operand checks and ctypes argument types of the
kernels (launched through `kernels.common.call_kernel`).

The dequant lives here so there is exactly ONE copy of the rounding
contract on the Python side (codes * scale cast through the q dtype, the
reference's `_dq8` rule); the CUDA K/V sources in csrc/flash_common.cuh
implement the same rule.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import check_cuda

__all__ = ["NEG_INF", "as_row_vector", "dequant", "gather_pages", "kv_kind",
           "launch_args", "ARGTYPES"]

NEG_INF = -1e30

# K/V storage kinds the CUDA loaders take (csrc/flash_common.cuh KVKind)
_KV_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def as_row_vector(x, b: int, device, fill: int = 0) -> torch.Tensor:
    """Normalize a per-row scalar argument to a (B,) int32 tensor on
    `device`: None -> `fill`, a scalar broadcasts, a (B,) vector passes
    through."""
    if x is None:
        x = fill
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.reshape(-1).expand(b) if x.dim() else x.expand(b)


def dequant(codes: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """int8-KV dequant: (codes * scale) rounded through `dtype` (the q
    dtype), back in f32 — what the fused kernels load."""
    return (codes.to(torch.float32) * scale).to(dtype).to(torch.float32)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A (P, Hkv, bs, X) block pool as per-row cache-shaped (B, Hkv,
    nblk * bs, X), through the (B, nblk) block table: the plain versions'
    view of a paged cache (the reference's `_gather_pages`). Positions past
    a row's frontier hold whatever the mapped blocks hold; the causal mask
    removes them."""
    g = pool[table.long()]                       # (B, nblk, Hkv, bs, X)
    b, nblk, h, bs, x = g.shape
    return g.transpose(1, 2).reshape(b, h, nblk * bs, x)


def kv_kind(k: torch.Tensor) -> int:
    if k.dtype not in _KV_KINDS:
        raise TypeError(f"K/V dtype {k.dtype} not in {list(_KV_KINDS)}")
    return _KV_KINDS[k.dtype]


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], window: Optional[int],
                softcap: Optional[float],
                table: Optional[torch.Tensor] = None):
    """Validate the operands every kernel takes and return the leading
    launch arguments of `call_kernel` (kv kind, q and its strides, K/V, the
    scales or None, and with a block table the table). q may be a strided view
    (the head split of a projection); its last dimension must be
    unit-stride. Flat K/V are (B, Hkv, Lk, D) caches; with `table` (B,
    nblk) int32, K/V are (P, Hkv, bs, D) block pools that the table's
    entries index (not checked: reading them would sync with the host)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    b, hq, _, d = q.shape
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    check_cuda("q", q, contiguous=False)
    if q.stride(-1) != 1:
        raise ValueError("q's last dimension must be contiguous")
    kind = kv_kind(k)
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} differ")
    rows = b if table is None else k.shape[0]    # cache rows or pool blocks
    if k.dim() != 4 or k.shape[0] != rows or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if d > 128 or (d * k.element_size()) % 16:
        raise ValueError(
            f"head_dim {d} must be at most 128 (a lane of the kernels owns 4 "
            f"head dims) and a cache row of it a multiple of 16 bytes (the "
            f"kernels stage rows with 16-byte copies)")
    for name, t in (("k", k), ("v", v)):
        check_cuda(name, t)
    if (kind == 2) != (k_scale is not None):
        raise ValueError("int8 K/V need k_scale/v_scale, and only they do")
    scales = (None, None)
    if k_scale is not None:
        want = k.shape[:3] + (1,)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.float32 or t.shape != want:
                raise ValueError(f"{name} must be float32 {want}")
            check_cuda(name, t)
        scales = (k_scale, v_scale)
    args = [kind, q, *q.stride()[:3], k, v, *scales]
    if table is not None:
        if (table.dtype != torch.int32 or table.dim() != 2
                or table.shape[0] != b or table.shape[1] < 1):
            raise ValueError(f"block table must be int32 (B={b}, nblk >= 1), "
                             f"got {table.dtype} {tuple(table.shape)}")
        check_cuda("table", table)
        args.append(table)
    return args


# ctypes of each entry point's arguments, the trailing stream excluded
_LEAD = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]               # kv kind, q + strides, k, v, scales
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    # pos, out, workspace, counters; B, Hkv, group, Lq, D, Lk, span,
    # window; scale, softcap
    "flash_decode": _LEAD + [_P] * 4 + [_I] * 8 + [_F] * 2,
    # table, pos, out, workspace, counters; B, Hkv, group, Lq, D, nblk, bs,
    # span, window; ...
    "flash_decode_paged": _LEAD + [_P] * 5 + [_I] * 9 + [_F] * 2,
    # pos, lengths, out, workspace, counters; B, Hkv, group, W, bq, D, Lk,
    # span, window; ...
    "flash_prefill": _LEAD + [_P] * 5 + [_I] * 9 + [_F] * 2,
    # table, pos, lengths, out, workspace, counters; B, Hkv, group, W, bq,
    # D, nblk, bs, span, window; ...
    "flash_prefill_paged": _LEAD + [_P] * 6 + [_I] * 10 + [_F] * 2,
}
