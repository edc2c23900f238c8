"""Flash-decode: short-query attention over a long per-row KV cache.

The serving engine's hottest loop is Lq=1 attention over a (B, Hkv,
max_len, D) cache where every batch row ("slot") sits at its own position.
`flash_decode` / `flash_decode_quant` launch the CUDA kernel in
`csrc/flash_decode.cu` on CUDA tensors: one block per (row, kv-head) walks
only the keys [max(pos - window + 1, 0), pos + Lq - 1] it needs, dealt to
its warps in KV blocks of `bkv` keys, with the GQA group packed into its
query rows. The int8-KV variant takes `(codes, pow2 scale)` and
dequantizes inside the kernel, bit-identical to dequantize-then-dense-kernel.

`flash_decode_paged` / `flash_decode_paged_quant` are the same kernel over
a (P, Hkv, bs, D) block pool shared by all rows: row b's logical block j
is physical block table[b, j], and the kernel resolves each key's address
through the table (the `flash_decode_paged` entry point of the same
source). At the same `bkv` a paged launch is bitwise equal to the flat
kernel on the gathered cache, for any block size.

On CPU tensors each wrapper runs its plain PyTorch version
(`flash_decode_plain`, `flash_decode_quant_plain`; the paged ones gather
the pages, then run those), which the tests and `chip_smoke.py` also
compare the kernel against on the card. Each wrapper counts its kernel
launches in `.launches`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import mha_ref
from ..common import call_kernel
from .shared import ARGTYPES, as_row_vector, dequant, gather_pages, launch_args

__all__ = ["flash_decode", "flash_decode_quant", "flash_decode_plain",
           "flash_decode_quant_plain", "flash_decode_paged",
           "flash_decode_paged_quant", "flash_decode_paged_plain",
           "flash_decode_paged_quant_plain"]


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
    entry = "flash_decode" if table is None else "flash_decode_paged"
    call_kernel(entry, ARGTYPES[entry], *args, pos.data_ptr(),
                out.data_ptr(), b, hkv, hq // hkv, lq, d, *keys, bkv,
                window or 0, d ** -0.5 if scale is None else scale,
                softcap or 0.0, source="flash_decode")
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
    length of the KV blocks the kernel deals to its warps in turn (a
    multiple of 32)."""
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
