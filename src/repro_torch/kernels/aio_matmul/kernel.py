"""The AIO multi-format GEMM kernel: out (M, N) float32 =
((float)(x . w) * x_scale[m]) * w_scale[n] over codes in five modes.

`aio_matmul` launches the CUDA kernel of `csrc/aio_matmul.cu` on CUDA
tensors and runs `aio_matmul_plain` on CPU tensors; the tests and
`chip_smoke.py` hold the kernel to the plain version on the card (integer
modes bitwise). It counts its kernel launches in `aio_matmul.launches`.

Operands, per mode:
    bf16        x (M, K), w (K, N) bfloat16; no scales.
    fp8a, fp8b  x (M, K), w (K, N) int8 bit codes.
    int8        x (M, K), w (K, N) int8.
    int4        x (M, K) int8, one code per byte (low nibble); w
                ((K+1)//2, N) int8, two codes per byte along K (low nibble
                = even k), as `formats.quantize_weight` packs it.
Scales: x_scale (M, 1) and w_scale (1, N) float32, both or neither
(neither only in bf16 mode).

The launch plan (`gemm_plan`: the block tile's width and the number of K
slices) is a function of (K, N, mode) alone, so a row's result does not
depend on M (the kernel's source note gives the reduction order).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core import formats as F
from ..common import (call_kernel, ceil_div, check_cuda, decode_fp_code,
                      tile_counters)

__all__ = ["MODES", "aio_matmul", "aio_matmul_plain", "gemm_plan"]

MODES = ("bf16", "fp8a", "fp8b", "int8", "int4")
_MODE_IDS = {"bf16": 0, "fp8a": 1, "fp8b": 1, "int8": 2, "int4": 3}
# mode; x, w, x_scale, w_scale, out, workspace, counters; M, N, K, bn,
# slices, x_vec, w_vec, fp8 shift; fp8 scale
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float])
SMS = 132              # streaming multiprocessors of an H100 SXM
SLICE_K = 384          # K values a slice of a narrow grid holds at least


def _check_shapes(x, w, x_scale, w_scale, mode) -> tuple:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must "
                         "be 2-D")
    m, k = x.shape
    n = w.shape[1]
    w_rows = (k + 1) // 2 if mode == "int4" else k
    if w.shape[0] != w_rows:
        raise ValueError(f"{mode}: w has {w.shape[0]} rows, x's K={k} needs "
                         f"{w_rows}")
    if (x_scale is None) != (w_scale is None) or (
            x_scale is None and mode != "bf16"):
        raise ValueError(f"{mode}: x_scale and w_scale go together, and only "
                         "bf16 may omit them")
    if x_scale is not None and (x_scale.numel() != m or w_scale.numel() != n):
        raise ValueError(f"scales {tuple(x_scale.shape)} / "
                         f"{tuple(w_scale.shape)} do not fit ({m}, {n})")
    return m, k, n


def aio_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None, *,
                     mode: str) -> torch.Tensor:
    """Plain version: decode, multiply, rescale. Integer modes accumulate
    exactly (a float64 product of integers below 2^53, as the kernel's
    int32 accumulation), float modes in float32."""
    m, k, n = _check_shapes(x, w, x_scale, w_scale, mode)
    if mode == "bf16":
        acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    elif mode in ("fp8a", "fp8b"):
        fmt = F.REGISTRY[mode]
        args = (fmt.ebits, fmt.mbits, fmt.bias)
        acc = torch.matmul(decode_fp_code(x, *args), decode_fp_code(w, *args))
    else:
        xv = x.to(torch.int32)
        if mode == "int4":
            xv = (xv << 28) >> 28                    # low nibble, signed
            wv = F.unpack_int4(w.t(), k=k).t()
        else:
            wv = w
        acc = torch.matmul(xv.to(torch.float64), wv.to(torch.float64)).to(
            torch.float32)
    if x_scale is not None:
        acc = (acc * x_scale.reshape(m, 1)) * w_scale.reshape(1, n)
    return acc


def gemm_plan(k: int, n: int, mode: str) -> tuple:
    """(bn, slices): the block tile's width (64 or 128 columns) and the
    number of K slices of a launch, from (K, N, mode) alone, never M.
    128 columns where N or K is long, else 64. A grid with a block for
    every other SM does not split K; a narrower one splits it into slices
    of at least SLICE_K values (each slice costs the chunk width a partial
    tile), but no more than put a block on every SM at the decode width.
    Slices are whole K tiles (a stage of the kernel: 64 values, 128 in the
    integer modes)."""
    bk = 128 if mode in ("int8", "int4") else 64
    kt = ceil_div(k, bk)
    bn = 128 if max(k, n) >= 4096 else 64
    nb = ceil_div(n, bn)
    want = 1 if 2 * nb >= SMS else min(ceil_div(k, SLICE_K),
                                        ceil_div(SMS, nb))
    per = ceil_div(kt, min(want, kt))
    return bn, ceil_div(kt, per)


def _fp8_params(mode: str) -> tuple:
    """The kernel's exact fp8 decode: a code's 7 magnitude bits shifted
    under the bf16 exponent field, times 2^(127 - bias)."""
    fmt = F.REGISTRY[mode]
    if fmt.ebits + fmt.mbits != 7:
        raise AssertionError(f"{mode}: the kernel decodes 1-byte codes")
    return 7 - fmt.mbits, 2.0 ** (127 - fmt.bias)


def aio_matmul(x: torch.Tensor, w: torch.Tensor,
               x_scale: Optional[torch.Tensor] = None,
               w_scale: Optional[torch.Tensor] = None, *,
               mode: str) -> torch.Tensor:
    """The GEMM over codes (operands in the module docstring) -> (M, N)
    float32."""
    if x.device.type == "cpu":
        return aio_matmul_plain(x, w, x_scale, w_scale, mode=mode)
    m, k, n = _check_shapes(x, w, x_scale, w_scale, mode)
    want = torch.bfloat16 if mode == "bf16" else torch.int8
    for name, t in (("x", x), ("w", w)):
        if t.dtype != want:
            raise TypeError(f"{mode}: {name} must be {want}, got {t.dtype}")
        check_cuda(name, t)
    scales = (None, None)
    if x_scale is not None:
        scales = tuple(s.reshape(-1).contiguous() for s in (x_scale, w_scale))
        for name, s in zip(("x_scale", "w_scale"), scales):
            if s.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {s.dtype}")
            check_cuda(name, s)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bn, slices = gemm_plan(k, n, mode)
    work = counters = None
    if slices > 1:
        acc = torch.int32 if mode in ("int8", "int4") else torch.float32
        work = torch.empty((slices, m, n), dtype=acc, device=x.device)
        counters = tile_counters(x.device, ceil_div(m, 16) * ceil_div(n, bn))
    shift, scale = _fp8_params(mode) if mode in ("fp8a", "fp8b") else (0, 1.0)
    es = x.element_size()
    call_kernel("aio_matmul", _ARGTYPES, _MODE_IDS[mode], x, w, *scales,
                out, work, counters,
                m, n, k, bn, slices, int(k * es % 16 == 0),
                int(n * w.element_size() % 16 == 0), shift, scale)
    aio_matmul.launches += 1
    return out


aio_matmul.launches = 0
