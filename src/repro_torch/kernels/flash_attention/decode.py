"""Flash-decode: short-query attention over a long per-row KV cache.

The serving engine's hottest loop is Lq=1 attention over a (B, Hkv,
max_len, D) cache where every batch row ("slot") sits at its own position.
`flash_decode` / `flash_decode_quant` launch the CUDA kernel in
`csrc/flash_decode.cu` on CUDA tensors: blocks over (row x kv-head, a group
of <= 8 packed query rows: the GQA group times the Lq queries, a split of
`SPLIT_KEYS` keys at absolute positions), the grid, the workspace for the
splits' partial softmax states and the row groups' arrival counters sized
by `decode_plan` from the shapes alone (pos stays on the device). A block
walks only the keys [max(pos - window + 1, 0), pos + Lq - 1] of its split,
and blocks past them exit at once, so work scales with the row's resident
context (or its window), not max_len; the last block of a row to finish
merges the splits in order. A row's output depends only on its own
position and keys, not on the other rows. The int8-KV variant takes
`(codes, pow2 scale)` and dequantizes inside the kernel, bit-identical to
dequantize-then-dense-kernel.

`flash_decode_paged` / `flash_decode_paged_quant` are the same kernel over
a (P, Hkv, bs, D) block pool shared by all rows: row b's logical block j
is physical block table[b, j], and the kernel resolves each key's address
through the table (the `flash_decode_paged` entry point of the same
source). A paged launch is bitwise equal to the flat kernel on the gathered
cache, for any block size.

On CPU tensors each wrapper runs its plain PyTorch version
(`flash_decode_plain`, `flash_decode_quant_plain`; the paged ones gather
the pages, then run those), which the tests and `chip_smoke.py` also
compare the kernel against on the card. Each wrapper counts its kernel
launches in `.launches`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .ref import mha_ref
from ..common import call_kernel, ceil_div, tile_counters
from .shared import ARGTYPES, as_row_vector, dequant, gather_pages, launch_args

__all__ = ["flash_decode", "flash_decode_quant", "flash_decode_plain",
           "flash_decode_quant_plain", "flash_decode_paged",
           "flash_decode_paged_quant", "flash_decode_paged_plain",
           "flash_decode_paged_quant_plain", "decode_plan", "DecodePlan",
           "SPLIT_KEYS", "ROWS_PER_BLOCK", "TILE_KEYS"]

ROWS_PER_BLOCK = 8       # packed query rows a block (csrc/flash_common.cuh RW)
TILE_KEYS = 32           # keys a tile (TK); splits are whole tiles
SPLIT_KEYS = 128         # keys a split, cut at absolute positions


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The launch of the decode kernel for a set of shapes: its grid (row x
    kv-head, row group, split), the keys of a split, and the f32 workspace
    (one partial (acc, m, l) of 8 rows per block) and int32 counters (one
    per row group) it needs."""
    grid: Tuple[int, int, int]
    span: int          # split s holds the cache positions [s span, (s+1) span)
    workspace: int
    counters: int


def decode_plan(b: int, hkv: int, group: int, lq: int, lk: int,
                d: int) -> DecodePlan:
    """The decode launch for B rows, Hkv kv-heads of `group` query heads,
    Lq queries a row, Lk cache positions and head dim D: from these shapes
    alone, never from the rows' positions. Every launch cuts the keys into
    splits of `SPLIT_KEYS`: the split is the order of a row's sums, so one
    span for all launches keeps a row's output the same paged as flat.

    The workspace holds a partial for every block, live or not (the live
    ones depend on the positions, which stay on the device): 1.06 MB at the
    serving shapes (8 rows, 2 kv-heads, 2,048 keys), 68 MB at 32 rows x
    32k keys."""
    groups = ceil_div(group * lq, ROWS_PER_BLOCK)
    splits = ceil_div(lk, SPLIT_KEYS)
    blocks = b * hkv * groups * splits
    return DecodePlan(grid=(b * hkv, groups, splits), span=SPLIT_KEYS,
                      workspace=blocks * ROWS_PER_BLOCK * (d + 2),
                      counters=b * hkv * groups)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       pos, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: masked dense attention at per-row offsets `pos`."""
    pos = as_row_vector(pos, q.shape[0], q.device)
    return mha_ref(q, k, v, causal=True, window=window, softcap=softcap,
                   scale=scale, offset=pos)


def flash_decode_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                             k_scale: torch.Tensor, v_codes: torch.Tensor,
                             v_scale: torch.Tensor, *, pos,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the int8-KV variant: dequantize, then attend."""
    return flash_decode_plain(q, dequant(k_codes, k_scale, q.dtype),
                              dequant(v_codes, v_scale, q.dtype), pos=pos,
                              window=window, softcap=softcap, scale=scale)


def flash_decode_paged_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, table: torch.Tensor, pos,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the paged kernel: gather the pages, then attend."""
    return flash_decode_plain(q, gather_pages(k, table),
                              gather_pages(v, table), pos=pos, window=window,
                              softcap=softcap, scale=scale)


def flash_decode_paged_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                                   k_scale: torch.Tensor,
                                   v_codes: torch.Tensor,
                                   v_scale: torch.Tensor, *,
                                   table: torch.Tensor, pos,
                                   window: Optional[int] = None,
                                   softcap: Optional[float] = None,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain version of the paged int8-KV kernel: gather codes and scales,
    dequantize, then attend."""
    return flash_decode_quant_plain(
        q, *(gather_pages(a, table) for a in (k_codes, k_scale, v_codes,
                                              v_scale)),
        pos=pos, window=window, softcap=softcap, scale=scale)


def _launch(wrapper, q, k, v, k_scale, v_scale, pos, window, softcap, scale,
            bkv, table=None) -> torch.Tensor:
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    args = launch_args(q, k, v, k_scale, v_scale, window, softcap, table)
    if bkv < 32 or bkv % 32:
        raise ValueError(f"bkv must be a multiple of 32, got {bkv}")
    pos = as_row_vector(pos, b, q.device).contiguous()
    out = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    # flat: the cache length; paged: the table width and the block size
    keys = [k.shape[2]] if table is None else [table.shape[1], k.shape[2]]
    lk = keys[0] if table is None else keys[0] * keys[1]
    plan = decode_plan(b, hkv, hq // hkv, lq, lk, d)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    counters = tile_counters(q.device, plan.counters)
    entry = "flash_decode" if table is None else "flash_decode_paged"
    call_kernel(entry, ARGTYPES[entry], *args, pos.data_ptr(),
                out.data_ptr(), work.data_ptr(), counters.data_ptr(), b, hkv,
                hq // hkv, lq, d, *keys, plan.span, window or 0,
                d ** -0.5 if scale is None else scale, softcap or 0.0,
                source="flash_decode")
    wrapper.launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, pos,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 bkv: int = 128) -> torch.Tensor:
    """q: (B, Hq, Lq, D) f32 short query; k, v: (B, Hkv, Lk, D) cache
    (bf16 or f32). pos: per-row (B,) cache position (or a scalar): row b's
    queries sit at pos[b]..pos[b]+Lq-1 and attend causally. bkv: the
    reference's KV block length, checked (a multiple of 32) and otherwise
    unused: the kernel's key walk is fixed by `decode_plan` (32-key tiles
    dealt to the warps of each `SPLIT_KEYS` split), so that every launch,
    flat or paged, sums a row's keys in one order."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos=pos, window=window,
                                  softcap=softcap, scale=scale)
    return _launch(flash_decode, q, k, v, None, None, pos, window, softcap,
                   scale, bkv)


def flash_decode_quant(q: torch.Tensor, k_codes: torch.Tensor,
                       k_scale: torch.Tensor, v_codes: torch.Tensor,
                       v_scale: torch.Tensor, *, pos,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None,
                       bkv: int = 128) -> torch.Tensor:
    """Fused int8-KV decode: codes (B, Hkv, Lk, D) int8 + per-position pow2
    scales (B, Hkv, Lk, 1) f32, dequantized inside the kernel."""
    if q.device.type == "cpu":
        return flash_decode_quant_plain(q, k_codes, k_scale, v_codes,
                                        v_scale, pos=pos, window=window,
                                        softcap=softcap, scale=scale)
    return _launch(flash_decode_quant, q, k_codes, v_codes, k_scale, v_scale,
                   pos, window, softcap, scale, bkv)


def flash_decode_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, table: torch.Tensor, pos,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None,
                       bkv: int = 128) -> torch.Tensor:
    """Paged decode. k, v: (P, Hkv, bs, D) block pools (bf16 or f32) shared
    by all rows; table: (B, nblk) int32 block table, row b's cache position
    j * bs + i at pool block table[b, j], offset i (a row reaches positions
    up to nblk * bs - 1). Every entry up to a row's frontier must name a
    pool block. The rest as `flash_decode`."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k, v, table=table, pos=pos,
                                        window=window, softcap=softcap,
                                        scale=scale)
    return _launch(flash_decode_paged, q, k, v, None, None, pos, window,
                   softcap, scale, bkv, table)


def flash_decode_paged_quant(q: torch.Tensor, k_codes: torch.Tensor,
                             k_scale: torch.Tensor, v_codes: torch.Tensor,
                             v_scale: torch.Tensor, *, table: torch.Tensor,
                             pos, window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None,
                             bkv: int = 128) -> torch.Tensor:
    """Paged int8-KV decode: codes (P, Hkv, bs, D) int8 + pow2 scales
    (P, Hkv, bs, 1) f32 pools, read through the table and dequantized
    inside the kernel."""
    if q.device.type == "cpu":
        return flash_decode_paged_quant_plain(
            q, k_codes, k_scale, v_codes, v_scale, table=table, pos=pos,
            window=window, softcap=softcap, scale=scale)
    return _launch(flash_decode_paged_quant, q, k_codes, v_codes, k_scale,
                   v_scale, pos, window, softcap, scale, bkv, table)


flash_decode.launches = 0
flash_decode_quant.launches = 0
flash_decode_paged.launches = 0
flash_decode_paged_quant.launches = 0
