"""Finding / Report primitives shared by the `repro_torch.analysis` checkers
(a copy of the reference's `repro.analysis.findings`: the same rendering
and JSON).

A Finding is one detected violation: a stable code (KCxxx kernel-contract,
KBxxx kernel-body, HLxxx hot-loop, FMxxx format-matrix), a severity, the
checker that raised it, a `where` locator, and a human message. A Report
is an ordered list of findings with severity rollups, a JSON serialization
(the CI artifact), and a terminal rendering. `--strict` gates on errors
only: warnings and infos record known, documented gaps without failing the
build.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

__all__ = ["Finding", "Report", "SEVERITIES"]

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    severity: str
    checker: str
    where: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"[{self.code}] {self.severity.upper():7s} "
                f"{self.checker} :: {self.where}\n    {self.message}")


class Report:
    """An ordered collection of findings from one or more checkers."""

    def __init__(self, findings: Iterable[Finding] = ()):
        self.findings: List[Finding] = list(findings)

    # ------------------------------------------------------------ building
    def add(self, code: str, severity: str, checker: str, where: str,
            message: str) -> Finding:
        f = Finding(code, severity, checker, where, message)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        return self

    # ------------------------------------------------------------- queries
    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    @property
    def infos(self) -> List[Finding]:
        return self.by_severity("info")

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def ok(self) -> bool:
        """True when nothing error-severity was found (the --strict gate)."""
        return not self.errors

    # ----------------------------------------------------------- rendering
    def counts(self) -> dict:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def to_json(self) -> str:
        return json.dumps({
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
        }, indent=2)

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        c = self.counts()
        lines.append(f"{len(self.findings)} finding(s): "
                     f"{c['error']} error, {c['warning']} warning, "
                     f"{c['info']} info")
        return "\n".join(lines)
