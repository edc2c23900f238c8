"""Kernel-contract checker: static lint of every CUDA launch geometry.

Every kernel impl in the KernelRegistry declares a LaunchContract (see
`repro_torch.api.registry`): the launches of its C entry point (grid,
threads, shared memory, cluster) and, for each operand, the tile every
thread block reads or writes, built in plain Python from the wrapper's
own plan. This checker sweeps each contract over its representative cases
crossed with an ExecutionPolicy tile sweep (`policy_sweep`) and evaluates
the index maps at EVERY grid point (the reference's checker, with the
card's limits in place of the TPU's VMEM budget):

  KC100  kernel impl with no declared contract             (warning)
  KC101  index-map arity / rank mismatch                   (error)
  KC102  tile out of bounds at some grid point, or an
         offset past the range of the kernel's index type  (error)
  KC103  non-dividing tile without masked_tail             (error)
  KC104  launch beyond the H100's limits (threads, shared
         memory, grid extents, cluster size)               (error)
  KC105  contract builder raised                           (error)

An index map returns, per grid point, None (the block touches nothing of
the operand), one tile, or a list of tiles (a paged walk through a block
table). A tile's entry along a dimension is a tile index (0 <= i <
ceil(dim / block)) or a `range` of elements (0 <= start < stop <= dim).

KC102 is the load-bearing one: the split-key walks, the per-row
workspace slots and split-K counters, and the block-table indirection
are hand-written offset arithmetic in C++ whose off-by-ones are
out-of-bounds accesses on the card; evaluating them over concrete
positions, lengths and tables proves them for the whole grid before any
kernel runs.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..api.policy import ExecutionPolicy, policy_sweep
from ..api.registry import (H100_LIMITS, KernelLaunch, KernelRegistry,
                            LaunchContract)
from ..api.registry import registry as default_registry
from .findings import Report

__all__ = ["check_kernel_contracts", "check_launch", "tiles_of", "CODES",
           "MAX_GRID_POINTS"]

CHECKER = "kernel-contracts"

CODES = {
    "KC100": ("warning", "kernel impl with no declared launch contract"),
    "KC101": ("error", "index-map arity / rank mismatch"),
    "KC102": ("error", "tile out of bounds at some grid point, or an offset "
                       "past the kernel's index type"),
    "KC103": ("error", "non-dividing tile without masked_tail"),
    "KC104": ("error", "launch beyond the H100's limits (threads, shared "
                       "memory, grid, cluster)"),
    "KC105": ("error", "contract builder raised (warning when the grid "
                       "sweep is stratified-sampled)"),
}

# Grid sweeps beyond this are stratified-sampled; the sample always keeps
# the first/last block along every grid dim, where the off-by-ones live.
MAX_GRID_POINTS = 65536


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tiles_of(result) -> list:
    """An index map's result as a list of tiles (tuples)."""
    if result is None:
        return []
    if isinstance(result, list):
        return [tuple(t) for t in result if t is not None]
    return [tuple(result)]


def _limits(launch: KernelLaunch, where: str, rep: Report):
    """KC104: the launch against what an H100 accepts."""
    problems = []
    if not 1 <= launch.threads <= H100_LIMITS["threads"]:
        problems.append(f"{launch.threads} threads a block (1 to "
                        f"{H100_LIMITS['threads']})")
    smem = launch.smem_bytes + launch.static_smem
    if smem > H100_LIMITS["smem_bytes"]:
        problems.append(f"{smem} B of shared memory a block "
                        f"({launch.smem_bytes} dynamic + "
                        f"{launch.static_smem} static; at most "
                        f"{H100_LIMITS['smem_bytes']})")
    if not 1 <= len(launch.grid) <= 3:
        problems.append(f"a grid of {len(launch.grid)} dimensions")
    for d, (g, cap) in enumerate(zip(launch.grid, H100_LIMITS["grid"])):
        if not 1 <= g <= cap:
            problems.append(f"gridDim.{'xyz'[d]} = {g} (1 to {cap})")
    c = launch.cluster
    if not 1 <= c <= H100_LIMITS["cluster"]:
        problems.append(f"a cluster of {c} blocks (1 to "
                        f"{H100_LIMITS['cluster']}, the portable sizes)")
    elif launch.grid and launch.grid[0] % c:
        problems.append(f"gridDim.x = {launch.grid[0]} is not a multiple "
                        f"of the cluster size {c}")
    for p in problems:
        rep.add("KC104", "error", CHECKER, where, f"launch {p}")


def _out_of_bounds(tile, b) -> Optional[str]:
    """Why `tile` is not inside operand `b`, or None."""
    for d, (i, dim, blk) in enumerate(zip(tile, b.array_shape,
                                          b.block_shape)):
        if isinstance(i, range):
            if not (0 <= i.start < i.stop <= dim):
                return (f"dim {d}: elements [{i.start}, {i.stop}) outside "
                        f"[0, {dim})")
        elif not 0 <= int(i) < _ceil_div(dim, blk):
            return (f"dim {d}: tile {int(i)} but only tiles [0, "
                    f"{_ceil_div(dim, blk)}) exist (array {dim}, tile {blk})")
    if b.index_bits < 64:
        last, stride = 0, 1
        for i, dim, blk in reversed(list(zip(tile, b.array_shape,
                                             b.block_shape))):
            end = i.stop - 1 if isinstance(i, range) else min(
                (int(i) + 1) * blk, dim) - 1
            last += end * stride
            stride *= dim
        if last >= 2 ** (b.index_bits - 1):
            return (f"element offset {last} past the {b.index_bits}-bit "
                    f"index the kernel computes it in")
    return None


def _sweep(launch: KernelLaunch, lc: LaunchContract, where: str,
           rep: Report):
    from .kernel_body import stratified_grid_points
    total = 1
    for g in launch.grid:
        total *= g
    points, truncated = stratified_grid_points(launch.grid, MAX_GRID_POINTS)
    if truncated:
        rep.add("KC105", "warning", CHECKER, where,
                f"grid has {total} points; sweep stratified-sampled to "
                f"<= {MAX_GRID_POINTS} (first/last block kept along every "
                f"dim) — shrink the contract case for a full sweep")
    # dedup keys are (operand, finding kind): one finding per distinct
    # defect per operand, without one kind suppressing another
    bad = set()
    for point in points:
        evaluated = {}
        for b in launch.blocks:
            key = id(b.index_map)
            if key not in evaluated:
                try:
                    evaluated[key] = tiles_of(
                        b.index_map(*point, *lc.scalars))
                except TypeError as e:
                    evaluated[key] = []
                    if (b.name, "KC101-arity") not in bad:
                        bad.add((b.name, "KC101-arity"))
                        rep.add("KC101", "error", CHECKER, where,
                                f"operand {b.name!r}: index map rejected "
                                f"{len(point)} grid + {len(lc.scalars)} "
                                f"scalar argument(s): {e}")
            for tile in evaluated[key]:
                if len(tile) != len(b.block_shape):
                    if (b.name, "KC101-rank") not in bad:
                        bad.add((b.name, "KC101-rank"))
                        rep.add("KC101", "error", CHECKER, where,
                                f"operand {b.name!r}: index map returned "
                                f"{len(tile)} indices for a "
                                f"rank-{len(b.block_shape)} tile")
                    continue
                if (b.name, "KC102") in bad or any(i is None for i in tile):
                    continue
                why = _out_of_bounds(tile, b)
                if why is not None:
                    bad.add((b.name, "KC102"))
                    rep.add("KC102", "error", CHECKER, where,
                            f"operand {b.name!r} at block {point}: {why}")


def check_launch(lc: LaunchContract, where: str,
                 report: Optional[Report] = None) -> Report:
    """Lint one concrete LaunchContract (all KC1xx checks except KC100)."""
    rep = report if report is not None else Report()
    if len(lc.scalars) != lc.num_scalars:
        rep.add("KC101", "error", CHECKER, where,
                f"{len(lc.scalars)} scalar operand(s) provided but "
                f"num_scalars={lc.num_scalars}")
        return rep
    for launch in lc.launches:
        at = f"{where} {launch.kernel}" if len(lc.launches) > 1 else where
        _limits(launch, at, rep)
        shapes_ok = True
        for b in launch.blocks:
            if len(b.array_shape) != len(b.block_shape):
                rep.add("KC101", "error", CHECKER, at,
                        f"operand {b.name!r}: array rank "
                        f"{len(b.array_shape)} != tile rank "
                        f"{len(b.block_shape)}")
                shapes_ok = False
                continue
            for d, (dim, blk) in enumerate(zip(b.array_shape,
                                               b.block_shape)):
                if blk < 1 or (dim % blk and not b.masked_tail):
                    rep.add("KC103", "error", CHECKER, at,
                            f"operand {b.name!r} dim {d}: tile length {blk} "
                            f"does not divide array length {dim} and the "
                            f"kernel does not declare a masked tail")
        if shapes_ok:
            _sweep(launch, lc, at, rep)
    return rep


def check_kernel_contracts(reg: Optional[KernelRegistry] = None,
                           sweep_values: Optional[dict] = None,
                           report: Optional[Report] = None) -> Report:
    """Sweep every registered kernel impl's contract; KC100 the missing
    ones."""
    reg = reg if reg is not None else default_registry
    rep = report if report is not None else Report()
    for op, impl in reg.kernel_impls():
        fn = reg.contract(op, impl)
        where = f"{op}/{impl}"
        if fn is None:
            rep.add("KC100", "warning", CHECKER, where,
                    "kernel implementation declares no launch contract "
                    "(register one with api.registry.register_contract)")
            continue
        policies: Sequence[ExecutionPolicy] = policy_sweep(
            fn.sweep_fields, values=sweep_values)
        for ci, case in enumerate(fn.cases):
            for policy in policies:
                tiles = {f: getattr(policy, f) for f in fn.sweep_fields}
                at = f"{where} case[{ci}] {tiles}" if tiles \
                    else f"{where} case[{ci}]"
                try:
                    lc = fn(case, policy)
                except Exception as e:  # noqa: BLE001 — surfaced as finding
                    rep.add("KC105", "error", CHECKER, at,
                            f"contract builder raised {type(e).__name__}: {e}")
                    continue
                check_launch(lc, at, rep)
    return rep
