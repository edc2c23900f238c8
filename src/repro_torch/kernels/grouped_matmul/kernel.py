"""The grouped GEMM kernel: out[t] = x[t] @ w[group_ids[t // bm]], f32
accumulation, for x (T, K) and w (G, K, N), float32 or bfloat16 (alike),
and the row tiles' group ids (T // bm,) int32 on x's device. Rows are
sorted by group and every group's row count is a multiple of bm
(`ops.make_group_ids`), so a row tile never straddles two groups.

Optional group extents `group_k` and `group_n`, lists of G ints: group
g's operands are zero at k >= group_k[g] (x's columns, w's rows) and at
n >= group_n[g] (w's columns), as `pack_tenants` pads short tenants. The
product is the same with or without them; the kernel skips the padding
they mark instead of multiplying it (and writes the padded columns as 0).
The plain version has no use for them: on CPU tensors they are checked
and the padding is multiplied.

`grouped_matmul` launches the CUDA kernel of `csrc/grouped_matmul.cu` on
CUDA tensors and runs `grouped_matmul_plain` on CPU tensors; it counts its
kernel launches in `grouped_matmul.launches`. The kernel takes bm a
multiple of 16 (its row tile divides bm) and any K and N (ragged edges
masked in the kernel); its output is float32 or bfloat16. Its launch plan
(`grouped_plan`: tile and K slices) depends on the launch's shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ..common import call_kernel, ceil_div, check_cuda, tile_counters

__all__ = ["grouped_matmul", "grouped_matmul_plain", "grouped_plan"]

_DTYPES = (torch.float32, torch.bfloat16)
# in/out types; x, w, group ids, group_k, group_n, out, workspace,
# counters; T, K, N, bm, tm, kc, slices
_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
SMS = 132                  # streaming multiprocessors of an H100 SXM
TN = 64                    # the kernel's block tile columns
# its block tile rows, largest first: 8 x 4 outputs a thread at 128 x 64
# down to 1 x 4 at 16 x 64
ROW_TILES = (128, 64, 32, 16)
BLOCK_MACS = 5 << 20       # MACs a block (tile x K slice) aims at
Extents = Optional[Sequence[int]]


def grouped_plan(t: int, k: int, n: int, bm: int) -> tuple:
    """(tm, kc, slices) of a launch: the most block tile rows (dividing bm)
    that still give at least half the 132 SMs a tm x 64 tile, else the
    fewest; then K cut into slices of kc (a multiple of 16) of about
    BLOCK_MACS each, so that long tiles spread over the SMs (the measured
    optimum on chip_smoke.py's tenant mixes)."""
    fits = [tm for tm in ROW_TILES if bm % tm == 0]
    for tm in fits:
        if t // tm * ceil_div(n, TN) * 2 >= SMS:
            break
    slices = max(1, min(k // 16, round(k * tm * TN / BLOCK_MACS)))
    kc = ceil_div(ceil_div(k, slices), 16) * 16
    return tm, kc, ceil_div(k, kc)


def _check_shapes(group_ids, x, w, bm):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want "
                         "(T, K) and (G, K, N)")
    t = x.shape[0]
    if bm < 1 or t % bm or tuple(group_ids.shape) != (t // bm,):
        raise ValueError(f"T={t} must be a multiple of bm={bm} and the group "
                         f"ids (T // bm,), got {tuple(group_ids.shape)}")


def _extents(ext: Extents, g: int, full: int, name: str) -> Optional[list]:
    """A group extent checked: a list of G ints in [0, full], or None."""
    if ext is None:
        return None
    if torch.is_tensor(ext):
        raise ValueError(f"{name} must be a list of {g} ints, not a tensor")
    vals = [int(v) for v in ext]
    if len(vals) != g or not all(0 <= v <= full for v in vals):
        raise ValueError(f"{name} must hold {g} extents in [0, {full}], got "
                         f"{vals}")
    return vals


@functools.lru_cache(maxsize=64)
def _extents_on(vals: tuple, device: torch.device) -> torch.Tensor:
    """A checked extent list as int32 on the card, copied there once."""
    return torch.tensor(vals, dtype=torch.int32, device=device)


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
                   out_dtype: torch.dtype = torch.float32,
                   group_k: Extents = None, group_n: Extents = None
                   ) -> torch.Tensor:
    """The grouped GEMM (module docstring) -> (T, N) out_dtype."""
    _check_shapes(group_ids, x, w, bm)
    g, k, n = w.shape
    ext = [_extents(e, g, full, name) for e, full, name in
           ((group_k, k, "group_k"), (group_n, n, "group_n"))]
    if x.device.type == "cpu":
        return grouped_matmul_plain(group_ids, x, w, bm=bm,
                                    out_dtype=out_dtype)
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
    t = x.shape[0]
    ext = [None if e is None else _extents_on(tuple(e), x.device)
           for e in ext]
    out = torch.empty((t, n), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    tm, kc, slices = grouped_plan(t, k, n, bm)
    work = counters = None
    if slices > 1:
        work = torch.empty((slices, t, n), dtype=torch.float32,
                           device=x.device)
        counters = tile_counters(x.device, t // tm * ceil_div(n, TN))
    call_kernel("grouped_matmul", _ARGTYPES, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), x, w, group_ids, *ext, out,
                work, counters,
                t, k, n, bm, tm, kc, slices)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
