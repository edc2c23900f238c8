"""Launch contract of the quantizer impl (`quantize`, `csrc/aio_quant.cu`).

The launch is the wrapper's `quant_plan(M, N)`: `cluster` blocks a row (a
thread-block cluster along x, grid M x cluster), `threads` a block, no
dynamic shared memory and the kernel's static `slots` and mbarrier (520
bytes). Block x is block `rank = x % cluster` of row `x // cluster`: it
reads and encodes the units [rank * part, (rank + 1) * part) of its row
(16-byte vectors, or floats where N % 4 != 0), clipped to the row, and
rank 0 writes the row's scale. Offsets are `size_t`.

Cases: the reference's (`repro/kernels/aio_quant/contract.py`), then the
serving shapes (decode M = 8 at every cluster size, a 256-token chunk of
the down projection's input), a row that is not a multiple of 4, and a
row past the register cap (the kernel's re-read path).
"""
from __future__ import annotations

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import (BlockContract, KernelLaunch, LaunchContract,
                             register_contract)
from ..common import ceil_div
from ..contracts import card_and_plain, span
from .ops import MAX_THREADS, _quantize_cuda, quant_plan

__all__ = ["quantize_contract", "quant_launch"]

MAX_CLUSTER = 8
# `slots[MAX_CLUSTER * MAX_THREADS / 32]` floats and the 8-byte mbarrier
STATIC_SMEM = 4 * MAX_CLUSTER * MAX_THREADS // 32 + 8

_CASES = (
    # the reference's cases
    {"m": 96, "n": 320, "fmt": "int8"},
    {"m": 256, "n": 96, "fmt": "int8"},
    {"m": 96, "n": 96, "fmt": "fp8a"},
    {"m": 96, "n": 96, "fmt": "int4"},
    # decode and chunk widths of qwen2-1.5B, every cluster size
    {"m": 8, "n": 1536, "fmt": "int8"},
    {"m": 8, "n": 8960, "fmt": "fp8b"},
    {"m": 1, "n": 1536, "fmt": "fp8a"},
    {"m": 256, "n": 8960, "fmt": "int4"},
    {"m": 5, "n": 97, "fmt": "uint8"},
    {"m": 2, "n": 600000, "fmt": "int8"},
)


def quant_launch(m: int, n: int, fmt: str) -> KernelLaunch:
    """The aio_quant_kernel launch of an (M, N) float32 input."""
    plan = quant_plan(m, n)
    c = plan.cluster
    w = 4 if n % 4 == 0 else 1
    part = ceil_div(n // w, c)

    def units(x):
        begin = x % c * part
        return x // c, span(begin * w, min(begin + part, n // w) * w)

    def row_part(x):
        row, cols = units(x)
        return None if cols is None else (row, cols)

    def scale(x):
        return (x // c, 0) if x % c == 0 else None

    blocks = (
        BlockContract("x", (m, n), (1, 1), row_part),
        BlockContract("codes", (m, n), (1, 1), row_part, dtype_bytes=1,
                      is_output=True, quant=fmt),
        BlockContract("scale", (m, 1), (1, 1), scale, is_output=True,
                      scale_for="codes"),
    )
    return KernelLaunch("aio_quant_kernel", (m * c,), blocks,
                        threads=plan.threads, static_smem=STATIC_SMEM,
                        cluster=c)


@register_contract("quantize", "cuda", cases=_CASES)
def quantize_contract(case: dict, policy: ExecutionPolicy) -> LaunchContract:
    m, n, fmt = case["m"], case["n"], case["fmt"]
    pol = policy.override(format=fmt)

    def body():
        g = torch.Generator().manual_seed(0)
        x = torch.randn(m, n, generator=g) * 3.0
        return card_and_plain(_quantize_cuda, x, policy=pol)
    return LaunchContract((quant_launch(m, n, fmt),), entry="aio_quant",
                          body=body)
