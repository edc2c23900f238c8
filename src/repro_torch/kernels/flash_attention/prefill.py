"""Varlen flash-prefill: batched variable-length prompt-chunk attention over
a cache-shaped K/V.

Admission feeds each admitted slot a fixed-width chunk of prompt tokens
(right-padded) whose queries sit at that row's own cache position.
`flash_prefill` / `flash_prefill_quant` launch the CUDA kernel in
`csrc/flash_prefill.cu` on CUDA tensors: blocks over (row x kv-head, 64
packed rows of a q-block of bq queries x the GQA group, a split of
`SPLIT_KEYS` keys at absolute positions), the grid, the workspace for the
splits' partial softmax states and the row blocks' arrival counters sized
by `prefill_plan` from the shapes alone (pos and lengths stay on the
device). Blocks past their rows' causal frontier, or before their window,
exit at once; row blocks with no valid query write zeros. A query's output
depends only on its own position and keys, not on the chunk width or the
other rows. Invalid (pad) query rows return EXACT zeros. The int8-KV
variant dequantizes inside the kernel, bit-identical to
dequantize-then-dense-kernel.

`flash_prefill_paged` / `flash_prefill_paged_quant` are the same kernel
over a (P, Hkv, bs, D) block pool read through a per-row block table (the
`flash_prefill_paged` entry point of the same source), bitwise equal to the
flat kernel on the gathered cache for any block size.

On CPU tensors each wrapper runs its plain PyTorch version
(`flash_prefill_plain`, `flash_prefill_quant_plain`; the paged ones gather
the pages, then run those). Each wrapper counts its kernel launches in
`.launches`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .ref import mha_ref
from ..common import call_kernel, ceil_div, tile_counters
from .shared import ARGTYPES, as_row_vector, dequant, gather_pages, launch_args

__all__ = ["flash_prefill", "flash_prefill_quant", "flash_prefill_plain",
           "flash_prefill_quant_plain", "flash_prefill_paged",
           "flash_prefill_paged_quant", "flash_prefill_paged_plain",
           "flash_prefill_paged_quant_plain", "prefill_plan", "PrefillPlan",
           "SPLIT_KEYS", "ROWS_PER_BLOCK", "TILE_KEYS"]

ROWS_PER_BLOCK = 64      # packed query rows a block (csrc/flash_prefill.cu RB)
TILE_KEYS = 32           # keys a tile (PK); splits are whole tiles
SPLIT_KEYS = 256         # keys a split, cut at absolute positions


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """The launch of the prefill kernel for a set of shapes: its grid (row
    x kv-head, q-block x row block, split), the keys of a split, and the
    f32 workspace (one partial (acc, m, l) of 64 rows per block) and int32
    counters (one per row block) it needs."""
    grid: Tuple[int, int, int]
    span: int          # split s holds the cache positions [s span, (s+1) span)
    workspace: int
    counters: int


def prefill_plan(b: int, hkv: int, group: int, w: int, bq: int, lk: int,
                 d: int) -> PrefillPlan:
    """The prefill launch for B rows, Hkv kv-heads of `group` query heads,
    a W-token chunk in q-blocks of bq, Lk cache positions and head dim D:
    from these shapes alone, never from the rows' positions or lengths.
    Every launch cuts the keys into splits of `SPLIT_KEYS`: the split is the
    order of a query's sums, so one span for all launches keeps a query's
    output independent of its chunk and the same paged as flat."""
    bq = max(1, min(bq, w))
    rblocks = ceil_div(w, bq) * ceil_div(group * bq, ROWS_PER_BLOCK)
    splits = ceil_div(lk, SPLIT_KEYS)
    blocks = b * hkv * rblocks * splits
    return PrefillPlan(grid=(b * hkv, rblocks, splits), span=SPLIT_KEYS,
                       workspace=blocks * ROWS_PER_BLOCK * (d + 2),
                       counters=b * hkv * rblocks)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        pos, lengths=None, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: masked dense attention at per-row offsets, with the
    query rows at or past lengths[b] set to exact zeros."""
    b, _, lq, _ = q.shape
    pos = as_row_vector(pos, b, q.device)
    lens = as_row_vector(lengths, b, q.device, fill=lq)
    out = mha_ref(q, k, v, causal=True, window=window, softcap=softcap,
                  scale=scale, offset=pos)
    valid = torch.arange(lq, device=q.device)[None, :] < lens[:, None]
    return torch.where(valid[:, None, :, None], out, torch.zeros_like(out))


def flash_prefill_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                              k_scale: torch.Tensor, v_codes: torch.Tensor,
                              v_scale: torch.Tensor, *, pos, lengths=None,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the int8-KV variant: dequantize, then attend."""
    return flash_prefill_plain(q, dequant(k_codes, k_scale, q.dtype),
                               dequant(v_codes, v_scale, q.dtype), pos=pos,
                               lengths=lengths, window=window,
                               softcap=softcap, scale=scale)


def flash_prefill_paged_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, table: torch.Tensor, pos,
                              lengths=None, window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the paged kernel: gather the pages, then attend."""
    return flash_prefill_plain(q, gather_pages(k, table),
                               gather_pages(v, table), pos=pos,
                               lengths=lengths, window=window,
                               softcap=softcap, scale=scale)


def flash_prefill_paged_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                                    k_scale: torch.Tensor,
                                    v_codes: torch.Tensor,
                                    v_scale: torch.Tensor, *,
                                    table: torch.Tensor, pos, lengths=None,
                                    window: Optional[int] = None,
                                    softcap: Optional[float] = None,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain version of the paged int8-KV kernel: gather codes and scales,
    dequantize, then attend."""
    return flash_prefill_quant_plain(
        q, *(gather_pages(a, table) for a in (k_codes, k_scale, v_codes,
                                              v_scale)),
        pos=pos, lengths=lengths, window=window, softcap=softcap,
        scale=scale)


def _launch(wrapper, q, k, v, k_scale, v_scale, pos, lengths, window,
            softcap, scale, bq, table=None) -> torch.Tensor:
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    args = launch_args(q, k, v, k_scale, v_scale, window, softcap, table)
    if any(st % 4 for st in q.stride()[:3]):
        raise ValueError(f"q's strides {q.stride()} must be multiples of 4 "
                         "elements (the kernel copies 16-byte query rows)")
    bq = max(1, min(bq, lq))
    pos = as_row_vector(pos, b, q.device).contiguous()
    lens = as_row_vector(lengths, b, q.device, fill=lq).contiguous()
    out = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    # flat: the cache length; paged: the table width and the block size
    keys = [k.shape[2]] if table is None else [table.shape[1], k.shape[2]]
    lk = keys[0] if table is None else keys[0] * keys[1]
    plan = prefill_plan(b, hkv, hq // hkv, lq, bq, lk, d)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    counters = tile_counters(q.device, plan.counters)
    entry = "flash_prefill" if table is None else "flash_prefill_paged"
    call_kernel(entry, ARGTYPES[entry], *args, pos, lens, out, work,
                counters, b, hkv, hq // hkv, lq, bq, d, *keys,
                plan.span, window or 0, d ** -0.5 if scale is None else scale,
                softcap or 0.0, source="flash_prefill")
    wrapper.launches += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, pos,
                  lengths=None, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  bq: int = 32) -> torch.Tensor:
    """q: (B, Hq, Lq, D) f32 right-padded prompt chunk; k, v: (B, Hkv, Lk,
    D) cache (bf16 or f32) already holding the chunk's keys at
    pos[b]..pos[b]+lengths[b]-1. pos: per-row (B,) cache position (or a
    scalar). lengths: per-row (B,) valid query count (None = all Lq valid);
    queries at i >= lengths[b] return zeros."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, pos=pos, lengths=lengths,
                                   window=window, softcap=softcap,
                                   scale=scale)
    return _launch(flash_prefill, q, k, v, None, None, pos, lengths, window,
                   softcap, scale, bq)


def flash_prefill_quant(q: torch.Tensor, k_codes: torch.Tensor,
                        k_scale: torch.Tensor, v_codes: torch.Tensor,
                        v_scale: torch.Tensor, *, pos, lengths=None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        bq: int = 32) -> torch.Tensor:
    """Fused int8-KV prefill: codes (B, Hkv, Lk, D) int8 + per-position
    pow2 scales (B, Hkv, Lk, 1) f32, dequantized inside the kernel."""
    if q.device.type == "cpu":
        return flash_prefill_quant_plain(q, k_codes, k_scale, v_codes,
                                         v_scale, pos=pos, lengths=lengths,
                                         window=window, softcap=softcap,
                                         scale=scale)
    return _launch(flash_prefill_quant, q, k_codes, v_codes, k_scale,
                   v_scale, pos, lengths, window, softcap, scale, bq)


def flash_prefill_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, table: torch.Tensor, pos, lengths=None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        bq: int = 32) -> torch.Tensor:
    """Paged varlen prefill. k, v: (P, Hkv, bs, D) block pools (bf16 or
    f32) already holding the chunk's keys; table: (B, nblk) int32 block
    table (the keys of row b are positions [0, nblk * bs)). The rest as
    `flash_prefill`."""
    if q.device.type == "cpu":
        return flash_prefill_paged_plain(q, k, v, table=table, pos=pos,
                                         lengths=lengths, window=window,
                                         softcap=softcap, scale=scale)
    return _launch(flash_prefill_paged, q, k, v, None, None, pos, lengths,
                   window, softcap, scale, bq, table)


def flash_prefill_paged_quant(q: torch.Tensor, k_codes: torch.Tensor,
                              k_scale: torch.Tensor, v_codes: torch.Tensor,
                              v_scale: torch.Tensor, *, table: torch.Tensor,
                              pos, lengths=None,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None,
                              bq: int = 32) -> torch.Tensor:
    """Paged int8-KV prefill: codes (P, Hkv, bs, D) int8 + pow2 scales
    (P, Hkv, bs, 1) f32 pools, read through the table and dequantized
    inside the kernel."""
    if q.device.type == "cpu":
        return flash_prefill_paged_quant_plain(
            q, k_codes, k_scale, v_codes, v_scale, table=table, pos=pos,
            lengths=lengths, window=window, softcap=softcap, scale=scale)
    return _launch(flash_prefill_paged_quant, q, k_codes, v_codes, k_scale,
                   v_scale, pos, lengths, window, softcap, scale, bq, table)


flash_prefill.launches = 0
flash_prefill_quant.launches = 0
flash_prefill_paged.launches = 0
flash_prefill_paged_quant.launches = 0
