"""Format-matrix checker: one table of truth for the AIO format grid.

A port of the reference's `repro.analysis.format_matrix`: the same table,
codes and severities, read against the port's planes
(`core.formats.REGISTRY`, `api.policy._FORMATS`, `kernels.aio_matmul.MODES`,
`core.formats.RESIDENT_FORMATS`, `perfmodel.accelerators`).

The paper's premise is one multiplier serving many number formats; the
software mirror scatters that claim across four places — the format
registry (`core.formats.REGISTRY`), the policy plane
(`api.policy` routable formats), the MAC-array kernel modes
(`kernels.aio_matmul.MODES` + `formats.RESIDENT_FORMATS`), and the
perf model's energy/power tables (`perfmodel.accelerators`). FORMAT_MATRIX
below states, per format, which planes are SUPPOSED to support it; the
checker cross-references every plane against the table:

  FM301  format registry and matrix disagree on the format set   (error)
  FM302  policy routability disagrees with the matrix            (error)
  FM303  MAC-array mode set disagrees with the matrix            (error)
  FM304  weight-residency set disagrees with the matrix          (error)
  FM305  perf-model coverage disagrees with the matrix           (error)
  FM306  paper-claimed format with no MAC-array mode             (info)
  FM307  MAC-array mode with no perf-model entry                 (warning)
  FM308  residency format without a MAC-array mode               (error)

FM306/FM307 record the DOCUMENTED gaps (uint4/uint8 codes exist but have
no integer-MAC mode yet; fp16 is a software container, not an AIO mode)
without failing --strict; adding a format to formats.py without updating
this table is an FM301 error by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .findings import Report

__all__ = ["FormatClaim", "FORMAT_MATRIX", "check_format_matrix", "CODES"]

CODES = {
    "FM301": ("error", "FORMAT_MATRIX and core.formats.REGISTRY disagree"),
    "FM302": ("error", "policy-routing plane disagrees with the matrix"),
    "FM303": ("error", "MAC-array mode plane disagrees with the matrix"),
    "FM304": ("error", "weight-residency plane disagrees with the matrix"),
    "FM305": ("error", "perf-model plane disagrees with the matrix"),
    "FM306": ("info", "paper-claimed format with no MAC-array mode yet"),
    "FM307": ("warning", "MAC-array mode with no perf-model entry"),
    "FM308": ("error", "residency format without a MAC-array mode"),
}

CHECKER = "format-matrix"


@dataclasses.dataclass(frozen=True)
class FormatClaim:
    """What each plane is supposed to say about one format."""
    name: str
    paper: bool          # claimed for the paper's AIO multiplier (Table II)
    matmul_mode: bool    # an aio_matmul MAC-array operating mode
    residency: bool      # legal resident-weight format
    perf_model: bool     # has energy/power entries in perfmodel
    routable: bool       # ExecutionPolicy(format=...) accepts it


FORMAT_MATRIX = (
    FormatClaim("bf16", paper=True, matmul_mode=True, residency=False,
                perf_model=True, routable=True),
    FormatClaim("fp16", paper=False, matmul_mode=False, residency=False,
                perf_model=False, routable=True),
    FormatClaim("fp8a", paper=True, matmul_mode=True, residency=True,
                perf_model=True, routable=True),
    FormatClaim("fp8b", paper=True, matmul_mode=True, residency=True,
                perf_model=True, routable=True),
    FormatClaim("int8", paper=True, matmul_mode=True, residency=True,
                perf_model=True, routable=True),
    FormatClaim("int4", paper=True, matmul_mode=True, residency=True,
                perf_model=True, routable=True),
    FormatClaim("uint8", paper=True, matmul_mode=False, residency=False,
                perf_model=False, routable=True),
    FormatClaim("uint4", paper=True, matmul_mode=False, residency=False,
                perf_model=False, routable=True),
)


def _cross(rep: Report, code: str, plane: str, claimed: set, actual: set):
    """Two-sided set comparison, one finding per direction."""
    for name in sorted(claimed - actual):
        rep.add(code, "error", CHECKER, f"format {name}",
                f"matrix claims {plane} support but the code does not "
                f"provide it")
    for name in sorted(actual - claimed):
        rep.add(code, "error", CHECKER, f"format {name}",
                f"code provides {plane} support the matrix does not claim — "
                f"update FORMAT_MATRIX")


def check_format_matrix(matrix: Sequence[FormatClaim] = FORMAT_MATRIX, *,
                        registry_names: Optional[set] = None,
                        routable_names: Optional[set] = None,
                        matmul_modes: Optional[set] = None,
                        resident_names: Optional[set] = None,
                        perf_names: Optional[set] = None,
                        report: Optional[Report] = None) -> Report:
    """Cross-check every plane against the matrix. The keyword overrides
    exist for tests; by default each plane is read from the live code."""
    rep = report if report is not None else Report()

    if registry_names is None:
        from ..core import formats
        registry_names = set(formats.REGISTRY)
    if routable_names is None:
        from ..api.policy import _FORMATS
        routable_names = set(_FORMATS)
    if matmul_modes is None:
        from ..kernels.aio_matmul import MODES
        matmul_modes = set(MODES)
    if resident_names is None:
        from ..core import formats
        resident_names = set(formats.RESIDENT_FORMATS)
    if perf_names is None:
        from ..perfmodel import accelerators as acc
        perf_names = set(acc.MULT_ENERGY_PJ)
        for a in acc.ACCELERATORS.values():
            perf_names &= set(a.power_w)

    names = {c.name for c in matrix}

    # FM301: the matrix must cover exactly the format registry
    for name in sorted(registry_names - names):
        rep.add("FM301", "error", CHECKER, f"format {name}",
                "registered in core.formats.REGISTRY but missing from "
                "FORMAT_MATRIX — state its support row")
    for name in sorted(names - registry_names):
        rep.add("FM301", "error", CHECKER, f"format {name}",
                "listed in FORMAT_MATRIX but not registered in "
                "core.formats.REGISTRY")

    # FM302..FM305: per-plane cross-references
    _cross(rep, "FM302", "policy-routing",
           {c.name for c in matrix if c.routable}, routable_names)
    _cross(rep, "FM303", "MAC-array mode",
           {c.name for c in matrix if c.matmul_mode}, matmul_modes)
    _cross(rep, "FM304", "weight-residency",
           {c.name for c in matrix if c.residency}, resident_names)
    _cross(rep, "FM305", "perf-model",
           {c.name for c in matrix if c.perf_model}, perf_names)

    # FM306..FM308: internal consistency of the claims themselves
    for c in matrix:
        if c.paper and not c.matmul_mode:
            rep.add("FM306", "info", CHECKER, f"format {c.name}",
                    "paper-claimed format with no MAC-array mode yet "
                    "(documented gap)")
        if c.matmul_mode and not c.perf_model:
            rep.add("FM307", "warning", CHECKER, f"format {c.name}",
                    "MAC-array mode with no perf-model energy/power entry — "
                    "Fig 14-style sweeps will not cover it")
        if c.residency and not c.matmul_mode:
            rep.add("FM308", "error", CHECKER, f"format {c.name}",
                    "weight-residency format without a MAC-array mode: "
                    "resident codes would be unroutable at dispatch")
    return rep
