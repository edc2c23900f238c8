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

The launch plan is `quant_plan(m, n)`, from the shapes alone: the blocks a
row (a thread-block cluster of 1, 2, 4 or 8, so that the decode width M = 8
fills the card), the threads a block, and the values a thread holds in
registers from the row max to the encode (0: a row past the register cap,
whose part the kernel reads twice). A sweep monkeypatches it.

Registry impls of the `quantize` op: "cuda" (this kernel, floor 1e-30, as
the reference's kernel route) and "ref" (`aio_quant_ref`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register
from ...core import formats as F
from ..common import call_kernel, ceil_div, check_cuda, encode_fp_code
from .ref import aio_quant_ref

__all__ = ["aio_quant", "aio_quant_plain", "quant_plan", "plan_with",
           "QuantPlan", "KERNEL_FLOOR", "QUANT_FORMATS", "CLUSTER_SIZES",
           "MAX_THREADS", "MAX_UNITS"]

KERNEL_FLOOR = 1e-30
# the formats whose codes fit the kernel's int8 output
QUANT_FORMATS = ("fp8a", "fp8b", "int8", "int4", "uint8", "uint4")

CLUSTER_SIZES = (1, 2, 4, 8)  # the portable thread-block cluster sizes
MAX_THREADS = 512       # threads a block (csrc/aio_quant.cu MAX_THREADS)
MAX_UNITS = 8           # units (16-byte vectors, or floats) a thread holds
FILL_BLOCKS = 128       # rows widen into clusters until M x C reaches this
PART_CAP = 1536         # ... or until a block's part is at most this many
MIN_PART = 32           # ... while each block keeps at least this many units
THREAD_TARGET = 320     # threads a block the plan keeps within where it can

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6)


def _format(fmt_name: str) -> F.AIOFormat:
    if fmt_name not in QUANT_FORMATS:
        raise ValueError(f"quantizer format {fmt_name!r} not in "
                         f"{QUANT_FORMATS}")
    return F.REGISTRY[fmt_name]


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """The quantizer's launch: `cluster` blocks a row (grid M x cluster),
    `threads` a block, `vals` values a thread held in registers (0: the
    re-read path)."""
    cluster: int
    threads: int
    vals: int


def plan_with(n: int, cluster: int,
              units: Optional[int] = None) -> QuantPlan:
    """The plan of a row of n values over `cluster` blocks, each thread
    holding `units` units in registers, at the fewest whole warps that
    cover a block's part (0: the re-read path, at THREAD_TARGET threads).
    By default the units `quant_plan` takes at that cluster size: the
    fewest (1, 2, 4, MAX_UNITS) that keep a block within THREAD_TARGET
    threads, or within MAX_THREADS at MAX_UNITS; past that, 0."""
    unit = 4 if n % 4 == 0 else 1
    part = ceil_div(ceil_div(n, unit), cluster)
    if units is None:
        fits = [u for u in (1, 2, 4, MAX_UNITS)
                if ceil_div(part, u) <= THREAD_TARGET]
        units = fits[0] if fits else (
            MAX_UNITS if ceil_div(part, MAX_UNITS) <= MAX_THREADS else 0)
    if units == 0:
        return QuantPlan(cluster, THREAD_TARGET, 0)
    threads = 32 * ceil_div(ceil_div(part, units), 32)
    return QuantPlan(cluster, threads, units * unit)


def quant_plan(m: int, n: int) -> QuantPlan:
    """The launch for (M, N), from the shapes alone: clusters double while
    the grid has fewer than FILL_BLOCKS blocks or a block's part is more
    than PART_CAP units (16-byte vectors, or floats where N % 4 != 0), as
    long as each block keeps at least MIN_PART units; the threads and the
    values a thread holds are `plan_with`'s."""
    units = ceil_div(n, 4 if n % 4 == 0 else 1)
    cluster = 1
    while (cluster < CLUSTER_SIZES[-1]
           and (m * cluster < FILL_BLOCKS
                or ceil_div(units, cluster) > PART_CAP)
           and ceil_div(units, 2 * cluster) >= MIN_PART):
        cluster *= 2
    return plan_with(n, cluster)


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
    plan = quant_plan(m, n)
    call_kernel("aio_quant", _ARGTYPES, x, codes, scale, m, n, floor,
                int(is_fp), fmt.ebits, fmt.mbits, fmt.bias, fmt.max_finite,
                0 if is_fp else fmt.int_min, 0 if is_fp else fmt.int_max,
                0 if is_fp else (1 << fmt.bits) - 1, plan.cluster,
                plan.threads, plan.vals)
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
