"""The depthwise conv kernel: stride 1, SAME padding, NHWC,
out[n,h,w,c] = sum_dh sum_dw xpad[n,h+dh,w+dw,c] * f[dh,dw,c] with
ph = (kh-1)//2 zero rows before and kh-1-ph after (the same for the
columns), accumulated in float32 from 0 in the reference's tap order (dh
outer, dw inner), each product rounded before its add.

`depthwise_conv` launches the CUDA kernel of `csrc/depthwise.cu` on CUDA
tensors and runs `depthwise_plain` on CPU tensors; it counts its kernel
launches in `depthwise_conv.launches`. The kernel pads in its loads (no
padded copy, no tap stack) and is bitwise equal to `depthwise_plain`. x and
the filter are float32 or bfloat16 (alike; bf16 multiplies in bf16 and
adds in f32, as the reference does); the output has x's type.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import call_kernel, check_cuda

__all__ = ["depthwise_conv", "depthwise_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
# bf16; x, filt, out; N, H, W, C, kh, kw
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6


def _check_shapes(x, filt):
    if x.dim() != 4 or filt.dim() != 3 or filt.shape[2] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} and filt {tuple(filt.shape)}: "
                         "want (N, H, W, C) and (kh, kw, C)")


def depthwise_plain(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Plain version: the SAME-padded input, then the reference kernel's
    sum acc = acc + xpad[.., h+dh, w+dw, :] * f[dh, dw] from acc = 0 in f32,
    dh outer, dw inner."""
    _check_shapes(x, filt)
    _, h, w, _ = x.shape
    kh, kw, _ = filt.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dh in range(kh):
        for dw in range(kw):
            acc = acc + xp[:, dh:dh + h, dw:dw + w, :] * filt[dh, dw]
    return acc.to(x.dtype)


def depthwise_conv(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """The depthwise conv (module docstring): x (N, H, W, C), filt (kh, kw,
    C) -> (N, H, W, C)."""
    if x.device.type == "cpu":
        return depthwise_plain(x, filt)
    _check_shapes(x, filt)
    if x.dtype not in _DTYPES or filt.dtype != x.dtype:
        raise TypeError(f"x {x.dtype} and filt {filt.dtype}: want both "
                        "float32 or both bfloat16")
    for name, a in (("x", x), ("filt", filt)):
        check_cuda(name, a)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n, h, w, c = x.shape
    kh, kw, _ = filt.shape
    call_kernel("depthwise_conv", _ARGTYPES, int(x.dtype == torch.bfloat16),
                x, filt, out, n, h, w, c, kh,
                kw, source="depthwise")
    depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0
