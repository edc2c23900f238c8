"""Morphable MAC-array abstractions (paper §IV, Fig 8).

The physical array: 128x128 MAC units = 4 array blocks of 64x64, each block =
7 subarrays (9x64) + 1 LRMU (1x64). Global bridge logics fuse blocks into
bigger arrays; local bridges connect subarrays/LRMU inside a block.

These abstractions are shared by three consumers:
  * perfmodel/   — cycle model picks a FusionPlan per workload (Fig 8 e-h),
  * tenancy/     — the grid-level analogue fissions a device grid per tenant,
  * kernels/grouped_matmul — the CUDA grid is partitioned like array blocks.

Pure Python, a copy of `repro.core.morphable` (the reference package's
`core/__init__` imports its JAX formats, so the port keeps its own copy);
`tests/test_torch_hwmodel.py` holds every plan equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BLOCK", "ARRAY_BLOCKS", "SUBARRAY_ROWS", "SUBARRAYS_PER_BLOCK",
    "FusedArray", "FusionPlan", "enumerate_fusion_plans", "plan_for_tenants",
    "precision_morph",
]

BLOCK = 64                 # array block is 64x64 MACs
ARRAY_BLOCKS = 4           # blocks 0..3, arranged 2x2: [[0, 1], [2, 3]]
SUBARRAY_ROWS = 9          # subarray is 9x64
SUBARRAYS_PER_BLOCK = 7    # 7 subarrays + 1 LRMU row = 64 rows

# 2x2 placement of the blocks (row, col) — fusions must be contiguous rectangles.
_BLOCK_POS = {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}


@dataclasses.dataclass(frozen=True)
class FusedArray:
    """A rectangle of fused array blocks acting as one (rows x cols) MAC array."""
    blocks: Tuple[int, ...]
    rows: int
    cols: int

    @property
    def n_macs(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """A partition of the 4 array blocks into fused rectangles."""
    arrays: Tuple[FusedArray, ...]

    @property
    def n_partitions(self) -> int:
        return len(self.arrays)

    def describe(self) -> str:
        return " + ".join(f"{a.rows}x{a.cols}" for a in self.arrays)


def _rect_of(blocks: Sequence[int]) -> Optional[Tuple[int, int]]:
    """If `blocks` form a contiguous rectangle in the 2x2 grid, return
    (rows, cols) in units of BLOCK, else None."""
    pos = [_BLOCK_POS[b] for b in blocks]
    rs = {r for r, _ in pos}
    cs = {c for _, c in pos}
    if len(pos) != len(rs) * len(cs):
        return None
    want = {(r, c) for r in rs for c in cs}
    if set(pos) != want:
        return None
    return len(rs), len(cs)


def enumerate_fusion_plans() -> List[FusionPlan]:
    """All legal fuse/fission configurations of the 4 blocks (Fig 8 e-h +
    their symmetric variants)."""
    plans = []
    ids = list(range(ARRAY_BLOCKS))

    def partitions(rest: Tuple[int, ...]):
        if not rest:
            yield []
            return
        first = rest[0]
        others = rest[1:]
        for r in range(len(others) + 1):
            for combo in itertools.combinations(others, r):
                group = (first,) + combo
                remaining = tuple(x for x in others if x not in combo)
                for tail in partitions(remaining):
                    yield [group] + tail

    seen = set()
    for part in partitions(tuple(ids)):
        arrays = []
        ok = True
        for group in part:
            rect = _rect_of(group)
            if rect is None:
                ok = False
                break
            arrays.append(FusedArray(tuple(sorted(group)),
                                     rect[0] * BLOCK, rect[1] * BLOCK))
        if not ok:
            continue
        key = tuple(sorted((a.blocks for a in arrays)))
        if key in seen:
            continue
        seen.add(key)
        plans.append(FusionPlan(tuple(sorted(arrays, key=lambda a: a.blocks))))
    return plans


def precision_morph(rows: int, cols: int, fmt_name: str) -> Tuple[int, int]:
    """Throughput morphing: in FP8/INT4 modes each multiplier yields 4 results,
    so an RxC array acts as 2Rx2C (Table III: 128x128 -> 256x256)."""
    low = fmt_name in ("fp8a", "fp8b", "int4", "uint4")
    f = 2 if low else 1
    return rows * f, cols * f


def plan_for_tenants(tenant_shapes: Sequence[Tuple[int, int]],
                     fmt_name: str = "bf16") -> Tuple[FusionPlan, Dict[int, int]]:
    """Pick the fusion plan minimizing total tile count for the tenants.

    tenant_shapes: per-tenant (S_R, S_C) — the stationary (weight) matrix dims
    it needs. Returns (plan, assignment tenant_idx -> partition idx). Tenants
    share partitions round-robin if there are more tenants than partitions.
    """
    best = None
    for plan in enumerate_fusion_plans():
        if len(tenant_shapes) > 1 and plan.n_partitions < min(len(tenant_shapes), 2):
            continue
        cost, assign = _assign_cost(tenant_shapes, plan, fmt_name)
        if best is None or cost < best[0]:
            best = (cost, plan, assign)
    assert best is not None
    return best[1], best[2]


def _assign_cost(tenant_shapes, plan: FusionPlan, fmt_name: str):
    """Greedy: each tenant picks the partition minimizing its own tile count;
    cost = sum of per-tenant ceil-tile products (proxy for Eq. 1 latency)."""
    import math
    assign = {}
    loads = [0.0] * plan.n_partitions
    for t, (sr, sc) in enumerate(tenant_shapes):
        best_p, best_c = 0, None
        for p, arr in enumerate(plan.arrays):
            r, c = precision_morph(arr.rows, arr.cols, fmt_name)
            tiles = math.ceil(sr / r) * math.ceil(sc / c)
            # Eq. (1)-shaped proxy: pipeline fill + tiles, plus current load
            est = (2 * sr + sc - 2) * tiles + loads[p]
            if best_c is None or est < best_c:
                best_p, best_c = p, est
        assign[t] = best_p
        loads[best_p] += best_c
    return sum(loads), assign
