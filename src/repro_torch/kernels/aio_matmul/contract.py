"""Launch contracts of the AIO matmul impls (`matmul`, `matmul_codes`).

Both reach `csrc/aio_matmul.cu` `aio_matmul`. The contract takes the
launch plan from the wrapper's own `gemm_plan` (the block tile's width and
the K slices, from (K, N, mode) alone), the block rows from M as
`launch_m` picks them, and the dynamic shared memory from `Cfg<MODE, MT,
BN>::SMEM`. A block (x, y, z) reads rows [m0, m0 + BM) of x and columns
[n0, n0 + BN) of w over the K tiles of slice z (int4 weights two codes a
byte along K); with one slice it scales and writes its output tile, with
more it stores its partial tile in slice z of the (slices, M, N)
workspace and arrives on its tile's counter, and the last block of a tile
sums the slices and writes it. `matmul_codes` first quantizes the
activations on the quantizer kernel (the `quantize` contract's launch).

Flat offsets into x, w, the workspace and out are 64-bit (`long long`);
the scale vectors are indexed by `int` row and column, the counters by the
32-bit `blockIdx.y * gridDim.x + blockIdx.x`.
"""
from __future__ import annotations

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import (BlockContract, KernelLaunch, LaunchContract,
                             register_contract)
from ...core import formats as F
from ..aio_quant.contract import quant_launch
from ..common import ceil_div
from ..contracts import SPLITK_STATIC, card_and_plain, span
from .kernel import MODES, gemm_plan
from .ops import _matmul_codes_cuda, _matmul_cuda

__all__ = ["matmul_contract", "matmul_codes_contract", "gemm_launch",
           "gemm_smem"]

THREADS = 256
SMEM_TARGET = 100 * 1024           # the ring fills up to this (Cfg NS_FIT)

# one case per mode, shapes deliberately not tile multiples (the
# reference's cases), then the serving shapes of qwen2-1.5B (decode and
# chunk widths, the down projection and the narrow k/v projections) and
# an odd K
_CASES = tuple({"m": 96, "k": 192, "n": 160, "mode": mode} for mode in MODES)
_CASES += tuple({"m": m, "k": k, "n": n, "mode": mode}
                for m, k, n, mode in (
                    (8, 1536, 256, "int8"), (8, 8960, 1536, "int4"),
                    (256, 1536, 8960, "fp8a"), (8, 1536, 1536, "fp8b"),
                    (33, 8960, 1536, "bf16"), (17, 1537, 96, "int4")))


def gemm_smem(mode: str, mt: int, bn: int) -> int:
    """`Cfg<MODE, MT, BN>::SMEM`: a ring of NS stages (x rows and the
    matching raw w rows) plus the decoded tiles, NS as many as fit in
    100 KB, at most 8."""
    k_int = mode in ("int8", "int4")
    fp8 = mode in ("fp8a", "fp8b")
    bm = 16 * mt
    xrb = 64 if fp8 else 128
    bk = xrb // 2 if mode == "bf16" else xrb
    arow = 128 + 16
    brow = bk + 16 if k_int else 2 * bn + 16
    wrows = bk // 2 if mode == "int4" else bk
    wrb = 2 * bn if mode == "bf16" else bn
    xst = bm * (xrb if fp8 else arow)
    wst = bk * brow if mode == "bf16" else wrows * wrb
    adec = bm * arow if fp8 else 0
    bdec = 0 if mode == "bf16" else (bn if k_int else bk) * brow
    ns = min(8, (SMEM_TARGET - adec - bdec) // (xst + wst))
    return ns * (xst + wst) + adec + bdec


def gemm_launch(m: int, k: int, n: int, mode: str) -> KernelLaunch:
    """The aio_mm_kernel launch of an (M, K) x (K, N) product in `mode`."""
    bn, slices = gemm_plan(k, n, mode)
    mt = 1 if m <= 16 else 2 if m <= 32 else 4
    bm = 16 * mt
    bk = 128 if mode in ("int8", "int4") else 64
    kt = ceil_div(k, bk)
    per = ceil_div(kt, slices)
    grid = (ceil_div(n, bn), ceil_div(m, bm), slices)
    int4 = mode == "int4"
    w_rows = (k + 1) // 2 if int4 else k
    es = 2 if mode == "bf16" else 1

    def kspan(z):
        kt0 = min(kt, z * per)
        return kt0 * bk, min(kt, kt0 + per) * bk

    def rows(y):
        return span(y * bm, min(y * bm + bm, m))

    def cols(x):
        return span(x * bn, min(x * bn + bn, n))

    def x_tile(x, y, z):
        k0, k1 = kspan(z)
        return (rows(y), span(k0, min(k1, k)))

    def w_tile(x, y, z):
        k0, k1 = kspan(z)
        if int4:
            k0, k1 = k0 // 2, k1 // 2
        return (span(k0, min(k1, w_rows)), cols(x))

    def out_tile(x, y, z):
        return (rows(y), cols(x))

    def part(x, y, z):
        return None if slices == 1 else (z, rows(y), cols(x))

    def counter(x, y, z):
        return None if slices == 1 else (y * grid[0] + x,)

    rev = (2,) if slices > 1 else ()
    quant = None if mode == "bf16" else mode
    blocks = [
        BlockContract("x", (m, k), (1, 1), x_tile, dtype_bytes=es,
                      quant=quant),
        BlockContract("w", (w_rows, n), (1, 1), w_tile, dtype_bytes=es,
                      quant=quant),
    ]
    if mode != "bf16":
        blocks += [
            BlockContract("x_scale", (m, 1), (1, 1),
                          lambda x, y, z: (rows(y), 0), scale_for="x",
                          index_bits=32),
            BlockContract("w_scale", (1, n), (1, 1),
                          lambda x, y, z: (0, cols(x)), scale_for="w",
                          index_bits=32),
        ]
    blocks += [
        BlockContract("out", (m, n), (1, 1), out_tile, is_output=True,
                      revisits=rev),
        BlockContract("work", (slices, m, n), (1, 1, 1), part,
                      is_output=True),
        # the wrapper asks for one counter per 16-row tile
        BlockContract("counters", (ceil_div(m, 16) * ceil_div(n, bn),),
                      (1,), counter, is_output=True, revisits=rev,
                      index_bits=32),
    ]
    return KernelLaunch("aio_mm_kernel", grid, tuple(blocks),
                        threads=THREADS, smem_bytes=gemm_smem(mode, mt, bn),
                        static_smem=SPLITK_STATIC)


def _tol(mode: str) -> float:
    """Integer modes are exact; float modes sum in f32 in another order
    than the plain version."""
    return 0.0 if mode in ("int8", "int4") else 1e-4


def _operands(case, g: torch.Generator):
    m, k, n = case["m"], case["k"], case["n"]
    return (torch.randn(m, k, generator=g), torch.randn(k, n, generator=g))


@register_contract("matmul", "cuda", cases=_CASES)
def matmul_contract(case: dict, policy: ExecutionPolicy) -> LaunchContract:
    m, k, n, mode = case["m"], case["k"], case["n"], case["mode"]
    pol = policy.override(format=mode)

    def body():
        x, w = _operands(case, torch.Generator().manual_seed(0))
        return card_and_plain(_matmul_cuda, x, w, policy=pol)
    return LaunchContract((gemm_launch(m, k, n, mode),), entry="aio_matmul",
                          body=body, tol=_tol(mode))


# formats a weight can be resident in (matmul_codes' operands)
_CODES_CASES = tuple(c for c in _CASES if c["mode"] in F.RESIDENT_FORMATS)


@register_contract("matmul_codes", "cuda", cases=_CODES_CASES)
def matmul_codes_contract(case: dict,
                          policy: ExecutionPolicy) -> LaunchContract:
    m, k, n, mode = case["m"], case["k"], case["n"], case["mode"]

    def body():
        x, w = _operands(case, torch.Generator().manual_seed(0))
        wq = F.quantize_weight(w, mode)
        return card_and_plain(_matmul_codes_cuda, x, wq, policy=policy)
    return LaunchContract(
        (quant_launch(m, k, mode), gemm_launch(m, k, n, mode)),
        entry="aio_matmul", body=body, tol=_tol(mode))
