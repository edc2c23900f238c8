"""Cycle/utilization model: ops (workloads.py) x accelerators (accelerators.py).

Mapping rules (faithful to §II-B/§IV-B):

ACCUMULABLE (conv FW/BW, fc, gemm, gemm-WG): weight tile (T x S_R) maps onto
the (R x C) array, inputs stream: per-tile latency = S_C + R + C - 2 (fill +
stream + drain), tiles = ceil(T/R) * ceil(S_R/C).

UNACCUMULABLE:
  * 'bus' arrays (rigid SA, SARA, mirroring — Fig 2-b): one output channel
    per column (psums of different channels must not merge), taps down the
    rows -> only `taps` of R rows active; tiles walk the channel dimension.
    Morphable bus arrays (SARA) fission into row-bands of 64 and run
    `bands = R/64` channel tiles concurrently.
  * 'allrounder' (Fig 9): subarray groups of 9 rows hold the taps, the LRMU
    packs floor(64/taps) groups -> ~99% of the block does useful work;
    cycles = MACs / effective-MACs + fill.

Two latency modes:
  * mode='ws'  (default): the self-consistent weight-stationary model above —
    used for cross-accelerator ratios (Fig 14/15 reproductions).
  * mode='eq1': the paper's Eq. (1) *verbatim* —
    (2*S_R + S_C - 2) * ceil(S_R/R) * ceil(S_C/C), with R constrained to the
    tap count for unaccumulable ops on bus arrays (footnote 5's "output bus
    bandwidth constraint"). This reproduces the paper's absolute magnitudes
    (e.g. the 1.05 s TPU-like-SA multi-tenant runtime in §VI-C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from ..core.mapping import unaccumulable_util_allrounder
from .accelerators import Accelerator, precision_double
from .workloads import Op

__all__ = ["OpResult", "op_latency", "model_latency", "eq1_paper"]


@dataclasses.dataclass
class OpResult:
    name: str
    cycles: float
    utilization: float        # useful MACs / (active cycles * array MACs)
    macs: int


def eq1_paper(s_c: int, s_r: int, r: int, c: int) -> float:
    """Paper Eq. (1), verbatim."""
    return (2 * s_r + s_c - 2) * math.ceil(s_r / r) * math.ceil(s_c / c)


# ---------------------------------------------------------------- ws mode
def _acc_cycles(s_c, t, s_r, r, c) -> Tuple[float, float]:
    tiles = math.ceil(t / r) * math.ceil(s_r / c)
    cycles = tiles * (s_c + r + c - 2)
    util = (t * s_r * s_c) / (tiles * r * c * (s_c + r + c - 2))
    return cycles, util


def _bus_unacc_cycles(op: Op, r, c, bands: int = 1) -> Tuple[float, float]:
    """Rigid mapping for unaccumulable ops: `taps` rows active, one channel
    per column; `bands` row-bands process channel tiles concurrently."""
    taps = max(op.taps, 1)
    if op.kind == "conv_wg":
        channels = op.channels            # (C_in*K^2/K^2) * C_out pairs
        stream = op.s_c
    else:                                 # depthwise family
        channels = op.channels
        stream = op.s_c
    tiles = math.ceil(channels / (c * bands))
    cycles = tiles * (stream + taps + c - 2)
    util = op.macs / (tiles * r * c * (stream + taps + c - 2))
    return cycles, min(util, 1.0)


def _allrounder_unacc_cycles(op: Op, r, c) -> Tuple[float, float]:
    taps = max(op.taps, 1)
    u = unaccumulable_util_allrounder(taps)
    eff = u * r * c
    cycles = math.ceil(op.macs / eff) + r + c - 2
    util = op.macs / (cycles * r * c)
    return cycles, util


# ---------------------------------------------------------------- eq1 mode
def _eq1_cycles(op: Op, acc: Accelerator, r, c) -> Tuple[float, float]:
    if op.kind in ("conv", "fc", "gemm"):
        cycles = eq1_paper(op.s_c, op.s_r, r, c)
        util = op.macs / (cycles * r * c)
        return cycles, min(util, 1.0)
    taps = max(op.taps, 1)
    if acc.unacc_mapping == "allrounder":
        return _allrounder_unacc_cycles(op, r, c)
    # bus arrays: R constrained to the tap count (footnote 5)
    cycles = eq1_paper(op.s_c, op.channels, taps, c)
    util = op.macs / (cycles * r * c)
    return cycles, min(util, 1.0)


def op_latency(op: Op, acc: Accelerator, fmt: str,
               allowed_configs=None, mode: str = "ws") -> OpResult:
    """Best config (morphable arrays minimize over their fusion plans)."""
    d = precision_double(fmt)
    best = None
    for (r0, c0) in (allowed_configs or acc.configs):
        r, c = r0 * d, c0 * d
        if mode == "eq1":
            cycles, util = _eq1_cycles(op, acc, r, c)
        elif op.kind in ("conv", "fc", "gemm"):
            cycles, util = _acc_cycles(op.s_c, op.t, op.s_r, r, c)
        elif op.kind in ("depthwise", "depthwise_wg", "conv_wg"):
            if acc.unacc_mapping == "allrounder":
                cycles, util = _allrounder_unacc_cycles(op, r, c)
            else:
                bands = max(r // 64, 1) if acc.morphable else 1
                cycles, util = _bus_unacc_cycles(op, r, c, bands)
        else:
            raise ValueError(op.kind)
        cycles *= op.repeat
        if best is None or cycles < best[0]:
            best = (cycles, util)
    return OpResult(op.name, best[0], best[1], op.macs)


def model_latency(ops: List[Op], acc: Accelerator, fmt: str,
                  allowed_configs=None, mode: str = "ws") -> Dict:
    """Aggregate a layer list: cycles sum; utilization is the MAC-weighted
    fraction of array capacity over active cycles (the Fig 14 metric)."""
    results = [op_latency(op, acc, fmt, allowed_configs, mode) for op in ops]
    cycles = sum(r.cycles for r in results)
    macs = sum(r.macs for r in results)
    d = precision_double(fmt)
    cap = acc.configs[0][0] * acc.configs[0][1] * d * d
    util = macs / (cycles * cap)
    return {"cycles": cycles, "macs": macs, "utilization": util,
            "per_op": results}
