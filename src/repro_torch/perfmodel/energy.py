"""Energy model: multiplier energy/op (Table II) + SPM/HBM traffic +
array-power x time (Table III), at 400 MHz.

Two views are reported:
  * bottom-up: MACs x energy/op + bytes x pJ/byte (traffic from a
    weight/input/output tile-reload model),
  * top-down: Table III array power x modeled runtime (the paper's Fig 15
    energy-efficiency view).
"""
from __future__ import annotations

from typing import Dict, List

from .accelerators import (Accelerator, FREQ_HZ, HBM_PJ_PER_BYTE,
                           MULT_ENERGY_PJ, SPM_PJ_PER_BYTE, array_power_w,
                           precision_double)
from .workloads import Op

__all__ = ["op_traffic_bytes", "model_energy_j", "runtime_s",
           "energy_topdown_j"]

_FMT_BYTES = {"bf16": 2, "fp8a": 1, "fp8b": 1, "int8": 1, "int4": 0.5}


def op_traffic_bytes(op: Op, acc: Accelerator, fmt: str) -> Dict[str, float]:
    """SPM traffic for one op under weight-stationary tiling: weights loaded
    once per tile pass, inputs streamed per weight-column tile, outputs
    written once. HBM traffic: one pass of weights + inputs + outputs
    (double-buffered SPM hides reloads when the working set fits 8 MB)."""
    b = _FMT_BYTES[fmt]
    r, c = acc.configs[0]
    d = precision_double(fmt)
    r, c = r * d, c * d
    import math
    if op.kind.startswith("depthwise"):
        w_bytes = op.taps * op.channels * b
        in_bytes = op.s_c * op.channels * b
        out_bytes = op.s_c * op.channels * b
        reloads = 1
    else:
        w_bytes = op.t * op.s_r * b
        in_bytes = op.s_c * op.t * b
        out_bytes = op.s_c * op.s_r * b
        reloads = math.ceil(op.s_r / c)      # inputs re-streamed per col tile
    spm = (w_bytes + in_bytes * reloads + out_bytes) * op.repeat
    working = w_bytes + in_bytes + out_bytes
    hbm = working * op.repeat if working > 8 * 2 ** 20 else \
        (w_bytes + in_bytes + out_bytes) * op.repeat
    return {"spm": spm, "hbm": hbm}


def model_energy_j(ops: List[Op], acc: Accelerator, fmt: str) -> float:
    """Bottom-up: multiplier ops + memory traffic."""
    pj = 0.0
    for op in ops:
        pj += op.macs * MULT_ENERGY_PJ[fmt]
        tr = op_traffic_bytes(op, acc, fmt)
        pj += tr["spm"] * SPM_PJ_PER_BYTE + tr["hbm"] * HBM_PJ_PER_BYTE
    return pj * 1e-12


def runtime_s(cycles: float) -> float:
    return cycles / FREQ_HZ


def energy_topdown_j(cycles: float, acc: Accelerator, fmt: str) -> float:
    """Table III array power x modeled runtime (the paper's ratio basis)."""
    return array_power_w(acc, fmt) * runtime_s(cycles)
