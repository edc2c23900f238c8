"""Helpers shared by the serving attention kernels (decode + varlen
prefill): the masked-score sentinel, per-row scalar-vector normalization,
the int8-KV dequant rounding rule, and the operand checks and ctypes
argument types of both kernels (launched through `kernels.common.call_kernel`).

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

__all__ = ["NEG_INF", "as_row_vector", "dequant", "kv_kind", "launch_args",
           "ARGTYPES"]

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


def kv_kind(k: torch.Tensor) -> int:
    if k.dtype not in _KV_KINDS:
        raise TypeError(f"K/V dtype {k.dtype} not in {list(_KV_KINDS)}")
    return _KV_KINDS[k.dtype]


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], window: Optional[int],
                softcap: Optional[float]):
    """Validate the operands every kernel takes and return the leading
    ctypes arguments (kv kind, q pointer and strides, K/V and scale
    pointers). q may be a strided view (the head split of a projection);
    its last dimension must be unit-stride."""
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
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
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
        scales = (k_scale.data_ptr(), v_scale.data_ptr())
    return [kind, q.data_ptr(), *q.stride()[:3], k.data_ptr(), v.data_ptr(),
            *scales]


# ctypes of each entry point's arguments, the trailing stream excluded
ARGTYPES = {
    "flash_decode": [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p] +
                    [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float],
    "flash_prefill": [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] +
                     [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float],
}

