"""Data-mapping schemes and MAC-utilization math (paper §II-B, §IV-B, Fig 9).

Two operation classes (Table I):
  ACCUMULABLE   — MAC results accumulate along C_in (conv, FC, GEMM/GEMV).
  UNACCUMULABLE — no C_in accumulation (depthwise/dilated conv, conv weight
                  gradients dL/dW).

On a rigid systolic array the unaccumulable class is output-bus bound: a column
may only hold one channel's taps (else partial sums of different outputs would
merge), so only K*K of R rows do work. The All-rounder's unaccumulable mapping
instead tiles taps into 9-row subarrays and groups the LRMU 9-at-a-time,
reaching 63/64 + 7*9/63... = >99% of the block (Fig 9).

A copy of `repro.core.mapping`.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from .morphable import BLOCK, SUBARRAY_ROWS, SUBARRAYS_PER_BLOCK

__all__ = ["OpKind", "GemmShape", "classify", "systolic_latency",
           "accumulable_utilization", "unaccumulable_util_allrounder",
           "unaccumulable_util_rigid", "lrmu_groups"]


class OpKind(enum.Enum):
    ACCUMULABLE = "accumulable"
    UNACCUMULABLE = "unaccumulable"


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """Input {S_C, T} x weight {T, S_R} on an R x C array (paper Eq. 1)."""
    s_c: int    # input rows streamed
    t: int      # contraction
    s_r: int    # output columns / weight columns


def classify(op_type: str) -> OpKind:
    """Classify an op per Table I."""
    unacc = {"depthwise_conv", "dilated_conv", "weight_gradient"}
    acc = {"conv", "fc", "gemm", "gemv", "attention_gemm"}
    if op_type in unacc:
        return OpKind.UNACCUMULABLE
    if op_type in acc:
        return OpKind.ACCUMULABLE
    raise ValueError(f"unknown op type {op_type!r}")


def systolic_latency(shape: GemmShape, rows: int, cols: int) -> int:
    """Paper Eq. (1): (2*S_R + S_C - 2) * ceil(S_R/R) * ceil(S_C/C).

    NOTE: we keep the paper's formula verbatim, including its tile terms; the
    contraction dim T is folded by the caller into S_C when layers are
    im2col'ed (the paper follows SCALE-sim's convention).
    """
    return (2 * shape.s_r + shape.s_c - 2) * (
        math.ceil(shape.s_r / rows) * math.ceil(shape.s_c / cols))


def accumulable_utilization(shape: GemmShape, rows: int, cols: int) -> float:
    """Average fraction of MACs doing useful work for an accumulable GEMM:
    last tile in each dimension may be ragged."""
    tr, tc = math.ceil(shape.t / rows), math.ceil(shape.s_r / cols)
    used = shape.t * shape.s_r
    return used / (tr * tc * rows * cols)


def lrmu_groups(taps: int, lrmu_width: int = BLOCK) -> int:
    """LRMU groups `taps` MACs together: floor(width / taps) groups (Fig 9-b).
    For 3x3 (9 taps): 7 groups -> 63 of 64 MACs active."""
    return lrmu_width // taps


def unaccumulable_util_allrounder(taps: int, c_out: Optional[int] = None) -> float:
    """Block utilization for the All-rounder's unaccumulable mapping.

    Each subarray column-group holds one filter's taps across its 9 rows
    (ceil(taps/9) groups chained when taps > 9); the LRMU packs floor(64/taps)
    groups. For 3x3: (7*9*64 + 63) / 64^2 = 99.97%.
    """
    sub_groups = math.ceil(taps / SUBARRAY_ROWS)
    sub_used_rows = taps / sub_groups                    # of SUBARRAY_ROWS
    sub_util = sub_used_rows / SUBARRAY_ROWS
    sub_macs = SUBARRAYS_PER_BLOCK * SUBARRAY_ROWS * BLOCK * sub_util
    lrmu_macs = lrmu_groups(taps) * taps
    util = (sub_macs + lrmu_macs) / (BLOCK * BLOCK)
    if c_out is not None and c_out < BLOCK:              # ragged channel tile
        util *= c_out / BLOCK
    return util


def unaccumulable_util_rigid(taps: int, rows: int,
                             c_out: Optional[int] = None) -> float:
    """Rigid-SA utilization for unaccumulable ops (Fig 2-b).

    One output channel per column; only `taps` of `rows` rows contribute
    (mapping more would overflow the output bus), so util = taps/rows.
    """
    util = min(taps / rows, 1.0)
    if c_out is not None:
        util *= min(c_out, BLOCK * 2) / (BLOCK * 2) if False else 1.0
    return util
