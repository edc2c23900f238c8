"""The AIO quantizer: x (M, N) float32 -> (int8 codes (M, N), per-row pow2
scale (M, 1) float32), the vector-unit stage that feeds the AIO GEMM.

`aio_quant` launches the CUDA kernel of `csrc/aio_quant.cu` on CUDA tensors
and runs `aio_quant_plain` on CPU tensors; the tests and `chip_smoke.py`
hold the kernel to the plain version on the card, bitwise. It counts its
kernel launches in `aio_quant.launches`.

`floor` is the least row max the scale is computed from: the reference's
quantizer kernel uses `KERNEL_FLOOR` (1e-30), `formats.quantize_scaled`
(and so the activation stage of `matmul_codes`) `formats.FLT_MIN`. With
`floor=FLT_MIN` the output is `quantize_scaled(x, fmt, axis=1)` bitwise.

Registry impls of the `quantize` op: "cuda" (this kernel, floor 1e-30, as
the reference's kernel route) and "ref" (`aio_quant_ref`).
"""
from __future__ import annotations

import ctypes

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register
from ...core import formats as F
from ..common import call_kernel, check_cuda, encode_fp_code
from .ref import aio_quant_ref

__all__ = ["aio_quant", "aio_quant_plain", "KERNEL_FLOOR", "QUANT_FORMATS"]

KERNEL_FLOOR = 1e-30
# the formats whose codes fit the kernel's int8 output
QUANT_FORMATS = ("fp8a", "fp8b", "int8", "int4", "uint8", "uint4")

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3)


def _format(fmt_name: str) -> F.AIOFormat:
    if fmt_name not in QUANT_FORMATS:
        raise ValueError(f"quantizer format {fmt_name!r} not in "
                         f"{QUANT_FORMATS}")
    return F.REGISTRY[fmt_name]


def aio_quant_plain(x: torch.Tensor, *, fmt_name: str,
                    floor: float) -> tuple:
    """Plain version: the kernel's arithmetic in eager PyTorch."""
    fmt = _format(fmt_name)
    x = x.to(torch.float32)
    amax = x.abs().amax(1, keepdim=True).clamp_min(floor)
    scale = F.pow2_ceil(amax / fmt.max_finite)
    xs = x / scale
    if fmt.kind == "fp":
        codes = encode_fp_code(xs, fmt.ebits, fmt.mbits, fmt.bias)
    else:
        codes = torch.round(xs).clamp(fmt.int_min, fmt.int_max).to(
            torch.int32) & ((1 << fmt.bits) - 1)
    return codes.to(torch.int8), scale


def aio_quant(x: torch.Tensor, *, fmt_name: str, floor: float) -> tuple:
    """x (M, N) float32 -> (codes int8 (M, N), scale float32 (M, 1))."""
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be (M, N) with N > 0, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return aio_quant_plain(x, fmt_name=fmt_name, floor=floor)
    fmt = _format(fmt_name)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    check_cuda("x", x)
    m, n = x.shape
    codes = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return codes, scale
    is_fp = fmt.kind == "fp"
    call_kernel("aio_quant", _ARGTYPES, x.data_ptr(), codes.data_ptr(),
                scale.data_ptr(), m, n, floor, int(is_fp), fmt.ebits,
                fmt.mbits, fmt.bias, fmt.max_finite,
                0 if is_fp else fmt.int_min, 0 if is_fp else fmt.int_max,
                0 if is_fp else (1 << fmt.bits) - 1)
    aio_quant.launches += 1
    return codes, scale


aio_quant.launches = 0


@register("quantize", "cuda")
def _quantize_cuda(x: torch.Tensor, *, policy: ExecutionPolicy):
    return aio_quant(x, fmt_name=policy.format, floor=KERNEL_FLOOR)


@register("quantize", "ref")
def _quantize_ref(x: torch.Tensor, *, policy: ExecutionPolicy):
    codes, scale = aio_quant_ref(x, fmt_name=policy.format)
    return codes.to(torch.int8), scale.to(torch.float32)
