"""Flash-decode: short-query attention over a long per-row KV cache.

The serving engine's hottest loop is Lq=1 attention over a (B, Hkv,
max_len, D) cache where every batch row ("slot") sits at its own position.
`flash_decode` / `flash_decode_quant` launch the CUDA kernel in
`csrc/flash_decode.cu` on CUDA tensors: one block per (row, kv-head) walks
only the keys [max(pos - window + 1, 0), pos + Lq - 1] it needs, dealt to
its warps in KV blocks of `bkv` keys, with the GQA group packed into its
query rows. The int8-KV variant takes `(codes, pow2 scale)` and
dequantizes inside the kernel, bit-identical to dequantize-then-dense-kernel.

On CPU tensors each wrapper runs its plain PyTorch version
(`flash_decode_plain`, `flash_decode_quant_plain`), which the tests and
`chip_smoke.py` also compare the kernel against on the card. Each wrapper
counts its kernel launches in `.launches`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import mha_ref
from ..common import call_kernel
from .shared import ARGTYPES, as_row_vector, dequant, launch_args

__all__ = ["flash_decode", "flash_decode_quant", "flash_decode_plain",
           "flash_decode_quant_plain"]


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


def _launch(wrapper, q, k, v, k_scale, v_scale, pos, window, softcap, scale,
            bkv) -> torch.Tensor:
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    args = launch_args(q, k, v, k_scale, v_scale, window, softcap)
    if bkv < 32 or bkv % 32:
        raise ValueError(f"bkv must be a multiple of 32, got {bkv}")
    pos = as_row_vector(pos, b, q.device).contiguous()
    out = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    call_kernel("flash_decode", ARGTYPES["flash_decode"], *args,
                pos.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, lq, d, lk,
                bkv, window or 0, d ** -0.5 if scale is None else scale,
                softcap or 0.0)
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


flash_decode.launches = 0
flash_decode_quant.launches = 0
