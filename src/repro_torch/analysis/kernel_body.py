"""Kernel-body checker: what each kernel body does with its tiles.

The reference proves properties of its kernel bodies by abstract
interpretation of their jaxprs. A CUDA body cannot be interpreted on the
CPU, so the port's checker has two parts.

On the CPU, from the contracts alone:

  KB410  two blocks write overlapping output elements, differing along
         a grid dim not declared in ``revisits=``          (error)
  KB411  declared revisit dim with grid > 1 never revisits  (warning)
  KB421  quant/scale declaration inconsistent (unknown
         format, dangling scale_for, scale plane not
         broadcastable onto its codes tile)                (error)
  KB430  contract declares no body                         (warning)

On a card (`repro_torch.analysis.card`), each contract's `body` launches
the real entry point:

  KB400  an access outside an operand: a redzone around an operand
         changed, a NaN from an input's redzone reached the output, or
         compute-sanitizer's memcheck / synccheck / initcheck
         reported the launch (racecheck reports are KB410)   (error)
  KB402  the kernel's output differs from its plain version  (error)
  KB431  the body raised, or a launch's profiled grid, block or shared
         memory drifted from its contract                   (error)
  KB432  the card part was not run (no card here)          (info)
  KB433  compute-sanitizer could not check the launches
         (the tool's own words)                             (warning)

The race detector replays the contracts' output index maps over the
(stratified-sampled) grid. Points that agree on every dimension outside
``revisits`` form a group that may write the same elements (a split-K or
split-key merge); elements written by two groups are a race. Each output
is marked element by element in an owner array where it is small enough,
else compared tile for tile (the reference's equality test).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.policy import ExecutionPolicy, policy_sweep
from ..api.registry import KernelLaunch, KernelRegistry, LaunchContract
from ..api.registry import registry as default_registry
from .findings import Report
from .format_matrix import FORMAT_MATRIX
from .kernel_contracts import tiles_of

__all__ = ["check_body", "check_kernel_bodies", "stratified_grid_points",
           "CODES"]

CHECKER = "kernel-body"

CODES = {
    "KB400": ("error", "access outside an operand on the card (redzone, "
                       "NaN from a guard, compute-sanitizer)"),
    "KB402": ("error", "kernel output differs from its plain version"),
    "KB410": ("error", "two blocks write the same output elements along "
                       "an undeclared (non-revisits) grid dim"),
    "KB411": ("warning", "declared revisits= dim with grid > 1 never "
                         "revisits an output tile"),
    "KB421": ("error", "quant/scale declaration inconsistent (unknown "
                       "format, dangling scale_for, bad scale plane)"),
    "KB430": ("warning", "launch contract declares no body"),
    "KB431": ("error", "body raised, or the profiled launch drifted from "
                       "its contract"),
    "KB432": ("info", "card part of the kernel-body check not run (no "
                      "card)"),
    "KB433": ("warning", "compute-sanitizer could not check the launches"),
}

MAX_RACE_POINTS = 65536
# outputs up to this many elements are checked element by element
MAX_OWNER_ELEMENTS = 1 << 25


def stratified_grid_points(grid: Sequence[int], max_points: int):
    """All grid points, or a stratified sample that ALWAYS includes the
    first and last block along every grid dim (where the clamp bugs live).

    Returns (iterator of points, truncated: bool).
    """
    import itertools
    total = 1
    for g in grid:
        total *= g
    if total <= max_points:
        return itertools.product(*(range(g) for g in grid)), False
    counts = [max(1, g) for g in grid]
    while True:
        prod = 1
        for c in counts:
            prod *= c
        if prod <= max_points:
            break
        d = counts.index(max(counts))
        if counts[d] <= 2:
            break
        counts[d] = max(2, counts[d] // 2)
    axes = []
    for g, c in zip(grid, counts):
        if g <= c:
            axes.append(range(g))
        else:
            vals = np.unique(np.linspace(0, g - 1, c).round().astype(int))
            axes.append([int(v) for v in vals])
    return itertools.product(*axes), True


# ---------------------------------------------------------------------------
# KB410/411 — the grid write-race detector (contract-level)
# ---------------------------------------------------------------------------

def _slices(tile, b) -> Tuple[slice, ...]:
    out = []
    for i, dim, blk in zip(tile, b.array_shape, b.block_shape):
        if isinstance(i, range):
            out.append(slice(i.start, i.stop))
        else:
            out.append(slice(int(i) * blk, min((int(i) + 1) * blk, dim)))
    return tuple(out)


def _key(tile) -> tuple:
    return tuple((i.start, i.stop) if isinstance(i, range) else int(i)
                 for i in tile)


def _check_races(launch: KernelLaunch, lc: LaunchContract, where: str,
                 rep: Report):
    outputs = [b for b in launch.blocks if b.is_output]
    points, truncated = stratified_grid_points(launch.grid, MAX_RACE_POINTS)
    points = list(points)
    for b in outputs:
        size = int(np.prod(b.array_shape)) if b.array_shape else 1
        owner = (np.full(b.array_shape, -1, np.int32)
                 if size <= MAX_OWNER_ELEMENTS else None)
        groups: Dict[tuple, int] = {}
        first_of: List[tuple] = []
        first_hit: Dict[tuple, tuple] = {}
        observed: set = set()
        raced = False
        for point in points:
            try:
                tiles = tiles_of(b.index_map(*point, *lc.scalars))
            except Exception:  # noqa: BLE001 — KC101/KC105 territory
                raced = True
                break
            tiles = [t for t in tiles if len(t) == len(b.array_shape)
                     and not any(i is None for i in t)]
            gkey = tuple(0 if d in b.revisits else v
                         for d, v in enumerate(point))
            g = groups.setdefault(gkey, len(groups))
            if g == len(first_of):
                first_of.append(point)
            for tile in tiles:
                if owner is not None:
                    region = owner[_slices(tile, b)]
                    others = np.unique(region[(region >= 0) & (region != g)])
                    if (region == g).any():
                        observed.update(d for d in range(len(point))
                                        if point[d] != first_of[g][d])
                    region[region < 0] = g
                    if others.size:
                        prev = first_of[int(others[0])]
                        bad = [d for d in range(len(point))
                               if prev[d] != point[d]
                               and d not in b.revisits]
                        rep.add("KB410", "error", CHECKER, where,
                                f"output {b.name!r}: blocks {prev} and "
                                f"{point} write overlapping elements, "
                                f"differing along grid dim(s) {bad} which "
                                f"are not declared in revisits="
                                f"{tuple(b.revisits)} — a write race "
                                f"(declare the reduction dim, or fix the "
                                f"index map)")
                        raced = True
                        break
                    continue
                prev = first_hit.setdefault(_key(tile), point)
                if prev == point:
                    continue
                diff = [d for d in range(len(point)) if prev[d] != point[d]]
                bad = [d for d in diff if d not in b.revisits]
                if bad:
                    rep.add("KB410", "error", CHECKER, where,
                            f"output {b.name!r}: blocks {prev} and {point} "
                            f"both write tile {_key(tile)}, differing along "
                            f"grid dim(s) {bad} which are not declared in "
                            f"revisits={tuple(b.revisits)} — a write race "
                            f"(declare the reduction dim, or fix the index "
                            f"map)")
                    raced = True
                    break
                observed.update(diff)
            if raced:
                break
        if raced or truncated:
            continue
        stale = [d for d in b.revisits
                 if d < len(launch.grid) and launch.grid[d] > 1
                 and d not in observed]
        if stale:
            rep.add("KB411", "warning", CHECKER, where,
                    f"output {b.name!r} declares revisits="
                    f"{tuple(b.revisits)} but no two blocks revisit a tile "
                    f"along dim(s) {stale} (grid {tuple(launch.grid)}) — "
                    f"stale declaration")


# ---------------------------------------------------------------------------
# KB421 — static quant/scale declaration audit vs FORMAT_MATRIX
# ---------------------------------------------------------------------------

def _check_quant_decls(launch: KernelLaunch, where: str, rep: Report):
    known = {c.name for c in FORMAT_MATRIX}
    by_name = {b.name: b for b in launch.blocks}
    scaled = {b.scale_for for b in launch.blocks if b.scale_for}
    for b in launch.blocks:
        if b.quant is not None and b.quant not in known:
            rep.add("KB421", "error", CHECKER, where,
                    f"operand {b.name!r} declares quant={b.quant!r} which "
                    f"is not a FORMAT_MATRIX format "
                    f"({', '.join(sorted(known))})")
        if b.quant is not None and b.name not in scaled:
            rep.add("KB421", "error", CHECKER, where,
                    f"quantized operand {b.name!r} has no scale operand: no "
                    f"operand declares scale_for={b.name!r}")
        if b.scale_for is not None:
            codes = by_name.get(b.scale_for)
            if codes is None:
                rep.add("KB421", "error", CHECKER, where,
                        f"operand {b.name!r} declares scale_for="
                        f"{b.scale_for!r} but no such operand exists")
            elif codes.quant is None:
                rep.add("KB421", "error", CHECKER, where,
                        f"operand {b.name!r} scales {b.scale_for!r} which "
                        f"declares no quant= format")
            elif len(b.block_shape) == len(codes.block_shape):
                for d, (s, c) in enumerate(zip(b.block_shape,
                                               codes.block_shape)):
                    if s != c and s != 1:
                        rep.add("KB421", "error", CHECKER, where,
                                f"scale {b.name!r} dim {d}: plane length "
                                f"{s} is neither 1 nor the codes tile "
                                f"length {c} — scale axis mismatch vs "
                                f"{b.scale_for!r}")
                        break


# ---------------------------------------------------------------------------
# one LaunchContract, and the sweep
# ---------------------------------------------------------------------------

def check_body(lc: LaunchContract, where: str,
               report: Optional[Report] = None) -> Report:
    """The CPU's KB4xx checks of one concrete LaunchContract."""
    rep = report if report is not None else Report()
    for launch in lc.launches:
        at = f"{where} {launch.kernel}" if len(lc.launches) > 1 else where
        _check_quant_decls(launch, at, rep)
        outputs = [b for b in launch.blocks if b.is_output]
        if outputs and any(b.is_output for b in
                           launch.blocks[:len(launch.blocks) - len(outputs)]):
            rep.add("KB431", "error", CHECKER, at,
                    "is_output operands must be a contiguous suffix of the "
                    "launch's operands (inputs first, then outputs)")
            continue
        _check_races(launch, lc, at, rep)
    return rep


def contract_cases(reg: Optional[KernelRegistry] = None,
                   sweep_values: Optional[dict] = None):
    """Every (op, impl, where, LaunchContract) of the registry's contracts
    over their cases and policy sweeps (builders that raise are skipped:
    KC105 reports them)."""
    reg = reg if reg is not None else default_registry
    for op, impl in reg.kernel_impls():
        fn = reg.contract(op, impl)
        if fn is None:
            continue                        # KC100 already covers this
        policies: Sequence[ExecutionPolicy] = policy_sweep(
            fn.sweep_fields, values=sweep_values)
        for ci, case in enumerate(fn.cases):
            for policy in policies:
                tiles = {f: getattr(policy, f) for f in fn.sweep_fields}
                where = f"{op}/{impl} case[{ci}]"
                where = f"{where} {tiles}" if tiles else where
                try:
                    lc = fn(case, policy)
                except Exception:  # noqa: BLE001 — KC105 reports it
                    continue
                yield op, impl, where, lc


def check_kernel_bodies(reg: Optional[KernelRegistry] = None,
                        sweep_values: Optional[dict] = None,
                        report: Optional[Report] = None, *,
                        card: Optional[bool] = None) -> Report:
    """Sweep every registered contract over case x policy tiles: the CPU
    checks always; the card checks (`card.check_on_card`) when `card` is
    True, or by default when a card is present, and otherwise one KB432
    info saying they were not run.

    KB430 warns once per (op, impl) whose contracts never declare a body."""
    reg = reg if reg is not None else default_registry
    rep = report if report is not None else Report()
    seen: Dict[Tuple[str, str], bool] = {}
    for op, impl, where, lc in contract_cases(reg, sweep_values):
        seen[(op, impl)] = seen.get((op, impl), False) or lc.body is not None
        check_body(lc, where, rep)
    for (op, impl), has_body in seen.items():
        if not has_body:
            rep.add("KB430", "warning", CHECKER, f"{op}/{impl}",
                    "no contract case declares a body= thunk — the kernel "
                    "body is never launched by the card checks (declare one "
                    "on the LaunchContract)")
    if card is None:
        import torch
        card = torch.cuda.is_available()
    if card:
        from .card import check_on_card
        check_on_card(reg, sweep_values, rep)
    else:
        rep.add("KB432", "info", CHECKER, "kernel-body",
                "no card here: the redzone, profiler-geometry and "
                "compute-sanitizer runs of the contracts' bodies were not "
                "made (run on a machine with a card, e.g. chip_smoke.py "
                "phase 3f)")
    return rep
