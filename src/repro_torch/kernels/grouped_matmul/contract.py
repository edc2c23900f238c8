"""Launch contract of the grouped-GEMM impl (`grouped_matmul`,
`csrc/grouped_matmul.cu`).

The impl pads K to the policy's bk and N to its bn, builds the row tiles'
group ids (one per bm rows) and launches the wrapper's `grouped_plan`:
tm x 64 block tiles (tm dividing bm) over K cut into `slices` chunks of
kc. A block (x, y, z) reads its group id gid[x * tm / bm], rows [x tm,
(x + 1) tm) of x and its group's weight over the K chunk z and columns
[y 64, (y + 1) 64), each clipped to the group's own extents where the
multi-tenant path gives them; a column tile past its group's N writes
zeros from slice 0. With one live slice it writes its output tile, with
more it stores a partial in slice z of the (slices, T, N) workspace and
arrives on its tile's counter. The kernel's tiles are static shared
memory (two x and two w stages). Offsets are 64-bit (`long`) but the
group ids' and the counters' (32-bit).

Cases: the reference's (`repro/kernels/grouped_matmul/contract.py`, group
sizes multiples of every swept bm), the two-tenant morphable mix of
chip_smoke phase 3d with its own extents, and one long-K group.
"""
from __future__ import annotations

import numpy as np
import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import (BlockContract, KernelLaunch, LaunchContract,
                             register_contract)
from ..common import ceil_div
from ..contracts import SPLITK_STATIC, card_and_plain, span
from .kernel import grouped_plan
from .ops import _grouped_cuda

__all__ = ["grouped_matmul_contract"]

KT, TN, THREADS = 16, 64, 256          # csrc/grouped_matmul.cu


def static_smem(tm: int) -> int:
    """`Xs[2][KT][TM + 4]` and `Ws[2][KT][TN + 4]` floats, and `s_last`."""
    return 2 * KT * (tm + 4) * 4 + 2 * KT * (TN + 4) * 4 + SPLITK_STATIC


_CASES = (
    # the reference's cases
    {"group_sizes": (128, 384, 128), "k": 192, "n": 160},
    {"group_sizes": (256, 128), "k": 96, "n": 96},
    # two tenants with their own K and N inside the padded operands
    {"group_sizes": (256, 128), "k": 1536, "n": 1000,
     "extents": ((1536, 900), (1000, 320))},
    {"group_sizes": (128,), "k": 8960, "n": 256},
)


@register_contract("grouped_matmul", "cuda", cases=_CASES,
                   sweep_fields=("bm", "bn", "bk"))
def grouped_matmul_contract(case: dict,
                            policy: ExecutionPolicy) -> LaunchContract:
    sizes, k, n = case["group_sizes"], case["k"], case["n"]
    bm, bn, bk = policy.bm, policy.bn, policy.bk
    t, g = sum(sizes), len(sizes)
    kp, np_ = ceil_div(k, bk) * bk, ceil_div(n, bn) * bn
    gids = np.asarray([gi for gi, size in enumerate(sizes)
                       for _ in range(size // bm)], np.int32)
    gk, gn = case.get("extents", ((kp,) * g, (np_,) * g))
    tm, kc, slices = grouped_plan(t, kp, np_, bm)
    grid = (t // tm, ceil_div(np_, TN), slices)

    def state(x, y, z):
        gi = int(gids[x * tm // bm])
        kg, ng = min(gk[gi], kp), min(gn[gi], np_)
        live = max(1, ceil_div(kg, kc))
        n0 = y * TN
        if n0 >= ng:
            return gi, None, live, z == 0        # zeros, from slice 0
        if z >= live:
            return None
        return gi, (z * kc, min(z * kc + kc, kg)), live, True

    def rows(x):
        return span(x * tm, x * tm + tm)

    def cols(y):
        return span(y * TN, min(y * TN + TN, np_))

    def gid_read(x, y, z, *_):
        return (x * tm // bm,)

    def x_tile(x, y, z, *_):
        s = state(x, y, z)
        if s is None or s[1] is None:
            return None
        return (rows(x), span(*s[1]))

    def w_tile(x, y, z, *_):
        s = state(x, y, z)
        if s is None or s[1] is None:
            return None
        ng = min(gn[s[0]], np_)
        return (s[0], span(*s[1]), span(y * TN, min(y * TN + TN, ng)))

    def out_tile(x, y, z, *_):
        s = state(x, y, z)
        return None if s is None or not s[3] else (rows(x), cols(y))

    def part(x, y, z, *_):
        s = state(x, y, z)
        if s is None or s[1] is None or s[2] == 1:
            return None
        return (z, rows(x), cols(y))

    def counter(x, y, z, *_):
        s = state(x, y, z)
        if s is None or s[1] is None or s[2] == 1:
            return None
        return (x * grid[1] + y,)

    rev = (2,) if slices > 1 else ()
    blocks = (
        BlockContract("group_ids", (len(gids),), (1,), gid_read,
                      index_bits=32),
        BlockContract("x", (t, kp), (1, 1), x_tile),
        BlockContract("w", (g, kp, np_), (1, 1, 1), w_tile),
        BlockContract("out", (t, np_), (1, 1), out_tile, is_output=True,
                      revisits=rev),
        BlockContract("work", (slices, t, np_), (1, 1, 1), part,
                      is_output=True),
        BlockContract("counters", (t // tm * ceil_div(np_, TN),), (1,),
                      counter, is_output=True, revisits=rev, index_bits=32),
    )
    launch = KernelLaunch("grouped_matmul_kernel", grid, blocks,
                          threads=THREADS, static_smem=static_smem(tm))

    def body():
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(t, k, generator=gen)
        w = torch.randn(g, k, n, generator=gen)
        ext = case.get("extents")
        if ext is not None:                  # zero outside each extent
            for gi in range(g):
                w[gi, ext[0][gi]:] = 0
                w[gi, :, ext[1][gi]:] = 0
        return card_and_plain(_grouped_cuda, x, w, tuple(sizes),
                              policy=policy, extents=ext)
    return LaunchContract((launch,), scalars=(gids,), num_scalars=1,
                          entry="grouped_matmul", body=body, tol=1e-4)
