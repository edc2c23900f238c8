"""The four accelerator designs the paper evaluates (§VI-B baselines).

Constants are the paper's own synthesized numbers (Table II/III) — gate-level
area/power cannot be measured in software; everything DERIVED (latency,
utilization, efficiency ratios) is computed by the model. None of these
numbers was measured on any card the port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["Accelerator", "ACCELERATORS", "ALLROUNDER", "TPU_SA", "SARA",
           "MIRRORING", "MULT_ENERGY_PJ", "array_power_w", "FREQ_HZ"]

FREQ_HZ = 400e6                    # all designs close timing at 400 MHz


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    # allowed (R, C) array configs in bf16/int8 mode; fp8/int4 double both
    configs: Tuple[Tuple[int, int], ...]
    morphable: bool
    # unaccumulable-op mapping: 'allrounder' (Fig 9 subarray/LRMU grouping)
    # or 'bus' (one channel per column, taps down the rows — Fig 2-b)
    unacc_mapping: str
    max_tenants: int
    area_mm2: float                # Table III
    power_w: dict                  # Table III, keyed by format


ALLROUNDER = Accelerator(
    name="allrounder",
    configs=((128, 128), (64, 128), (128, 64), (64, 64)),
    morphable=True,
    unacc_mapping="allrounder",
    max_tenants=4,
    area_mm2=108.03,
    power_w={"bf16": 5.31, "fp8a": 10.14, "fp8b": 9.19, "int8": 1.73,
             "int4": 1.70},
)

TPU_SA = Accelerator(
    name="tpu_sa",
    configs=((128, 128),),
    morphable=False,
    unacc_mapping="bus",
    max_tenants=1,
    area_mm2=103.55,
    power_w={"bf16": 4.73, "fp8a": 9.57, "fp8b": 8.62, "int8": 1.16,
             "int4": 1.14},
)

SARA = Accelerator(                 # [46]-based: bypassable 4x4 systolic cells
    name="sara",
    configs=((128, 128), (64, 128), (128, 64), (64, 64)),
    morphable=True,
    unacc_mapping="bus",            # morphable but no distinct unacc mapping
    max_tenants=4,
    area_mm2=118.45,
    power_w={"bf16": 6.32, "fp8a": 11.16, "fp8b": 10.21, "int8": 2.75,
             "int4": 2.73},
)

MIRRORING = Accelerator(            # [29]-based: bidirectional dataflow
    name="mirroring",
    configs=((128, 128),),
    morphable=False,
    unacc_mapping="bus",
    max_tenants=2,                  # fine-grained spatial multitasking (2-way)
    area_mm2=105.84,
    power_w={"bf16": 4.92, "fp8a": 9.74, "fp8b": 8.77, "int8": 1.30,
             "int4": 1.28},
)

ACCELERATORS = {a.name: a for a in (ALLROUNDER, TPU_SA, SARA, MIRRORING)}

# Table II: energy per multiply op [pJ] for the all-in-one multiplier.
MULT_ENERGY_PJ = {"bf16": 3.26, "fp8a": 2.83, "fp8b": 2.72, "int8": 3.03,
                  "int4": 2.74}

# memory-system energy constants (CACTI-P-class SPM + HBM2 per JEDEC [23])
SPM_PJ_PER_BYTE = 6.0
HBM_PJ_PER_BYTE = 31.2


def array_power_w(acc: Accelerator, fmt: str) -> float:
    return acc.power_w.get(fmt, acc.power_w["bf16"])


def precision_double(fmt: str) -> int:
    """FP8/INT4 modes yield 4 products per multiplier -> both dims x2
    (Table III: 128x128 acts as 256x256)."""
    return 2 if fmt in ("fp8a", "fp8b", "int4", "uint4") else 1
