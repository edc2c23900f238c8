"""The grouped GEMM kernel: out[t] = x[t] @ w[group_ids[t // bm]], f32
accumulation, for x (T, K) and w (G, K, N), float32 or bfloat16 (alike),
and the row tiles' group ids (T // bm,) int32 on x's device. Rows are
sorted by group and every group's row count is a multiple of bm
(`ops.make_group_ids`), so a row tile never straddles two groups.

`grouped_matmul` launches the CUDA kernel of `csrc/grouped_matmul.cu` on
CUDA tensors and runs `grouped_matmul_plain` on CPU tensors; it counts its
kernel launches in `grouped_matmul.launches`. The kernel takes bm a
multiple of 16 (its row tile is the largest of 64, 32, 16 dividing bm) and
any K and N (ragged edges masked in the kernel); its output is float32 or
bfloat16.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import call_kernel, check_cuda

__all__ = ["grouped_matmul", "grouped_matmul_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
# in/out types; x, w, group ids, out; T, K, N, bm
_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4


def _check_shapes(group_ids, x, w, bm):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want "
                         "(T, K) and (G, K, N)")
    t = x.shape[0]
    if bm < 1 or t % bm or tuple(group_ids.shape) != (t // bm,):
        raise ValueError(f"T={t} must be a multiple of bm={bm} and the group "
                         f"ids (T // bm,), got {tuple(group_ids.shape)}")


def grouped_matmul_plain(group_ids: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, *, bm: int = 128,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version: one float32 matmul per run of row tiles that share a
    group."""
    _check_shapes(group_ids, x, w, bm)
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    ids = group_ids.tolist()
    start = 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[start]:
            rows = slice(start * bm, i * bm)
            out[rows] = x[rows].to(torch.float32) @ w[ids[start]].to(
                torch.float32)
            start = i
    return out.to(out_dtype)


def grouped_matmul(group_ids: torch.Tensor, x: torch.Tensor,
                   w: torch.Tensor, *, bm: int = 128,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The grouped GEMM (module docstring) -> (T, N) out_dtype."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(group_ids, x, w, bm=bm,
                                    out_dtype=out_dtype)
    _check_shapes(group_ids, x, w, bm)
    if bm % 16:
        raise ValueError(f"bm={bm}: the kernel takes multiples of 16 (its "
                         "row tile must lie inside one group's rows)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x {x.dtype} and w {w.dtype}: want both float32 or "
                        "both bfloat16")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: want float32 or bfloat16")
    if group_ids.dtype != torch.int32:
        raise TypeError(f"group ids must be int32, got {group_ids.dtype}")
    for name, a in (("x", x), ("w", w), ("group_ids", group_ids)):
        check_cuda(name, a)
    t, k = x.shape
    n = w.shape[2]
    out = torch.empty((t, n), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    call_kernel("grouped_matmul", _ARGTYPES, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
                group_ids.data_ptr(), out.data_ptr(), t, k, n, bm)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
