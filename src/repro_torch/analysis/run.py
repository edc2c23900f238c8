"""`python -m repro_torch.analysis` — run every static checker, render a
report (the reference's `repro.analysis.run`, with a baseline section per
platform).

Exit status: 0 always, unless --strict is given (any error-severity finding
exits 1 — the CI gate) or --baseline is given (any per-code findings-count
drift from the committed baseline exits 1 — the warnings ratchet). --json
writes the full findings report (the CI artifact) regardless of outcome.

The card adds checks (the kernel bodies' launches; the hot loop's sync
points), so a baseline file holds one section per platform, "cpu" and
"cuda", each {"counts_by_code": {...}}; --baseline compares the section of
the platform it runs on and --write-baseline rewrites that section alone.
A file with a top-level "counts_by_code" (the reference's layout) is one
section for every platform. `--check kernel-body` on a machine without a
card raises: its card part would be left out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from typing import Optional, Sequence

import torch

from . import format_matrix, hotloop, kernel_body, kernel_contracts
from .findings import Report
from .format_matrix import check_format_matrix
from .hotloop import check_hot_loop
from .kernel_body import check_kernel_bodies
from .kernel_contracts import check_kernel_contracts

__all__ = ["run_all", "main", "counts_by_code", "compare_baseline",
           "platform", "baseline_section"]

CHECKERS = {
    "kernel-contracts": check_kernel_contracts,
    "kernel-body": check_kernel_bodies,
    "hot-loop": check_hot_loop,
    "format-matrix": check_format_matrix,
}

# checker-module CODES tables, in family order, for --list-codes
CODE_TABLES = (
    ("kernel-contracts", kernel_contracts.CODES),
    ("kernel-body", kernel_body.CODES),
    ("hot-loop", hotloop.CODES),
    ("format-matrix", format_matrix.CODES),
)


def platform() -> str:
    """The baseline section this machine reads and writes."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_all(names: Optional[Sequence[str]] = None) -> Report:
    """Run the named checkers (all by default) into one Report."""
    rep = Report()
    for name in (names or CHECKERS):
        CHECKERS[name](report=rep)
    return rep


def list_codes() -> str:
    lines = []
    for checker, table in CODE_TABLES:
        for code, (severity, desc) in table.items():
            lines.append(f"{code}  {severity:7s} {checker:17s} {desc}")
    return "\n".join(lines)


def counts_by_code(rep: Report) -> dict:
    return dict(sorted(Counter(f.code for f in rep.findings).items()))


def compare_baseline(rep: Report, baseline: dict) -> list:
    """Findings-count ratchet: ANY per-code drift from the committed
    baseline is a failure — new findings obviously, but also fixed ones
    (fixing a warning requires regenerating the baseline, so the committed
    expectation never goes stale)."""
    expected = dict(baseline.get("counts_by_code", {}))
    actual = counts_by_code(rep)
    problems = []
    for code in sorted(set(expected) | set(actual)):
        want, got = expected.get(code, 0), actual.get(code, 0)
        if got > want:
            problems.append(
                f"{code}: {got} finding(s), baseline allows {want} — fix "
                f"the new finding(s) or regenerate with --write-baseline")
        elif got < want:
            problems.append(
                f"{code}: {got} finding(s), baseline expects {want} — a "
                f"finding was fixed; ratchet down by regenerating with "
                f"--write-baseline")
    return problems


def baseline_section(data: dict, section: Optional[str] = None) -> dict:
    """The section of a baseline file for `section` (this machine's
    platform by default); a flat file is its own section."""
    if "counts_by_code" in data:
        return data
    return data.get(section or platform(), {})


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the port: CUDA launch contracts, "
                    "kernel-body checks (redzones, profiled geometry and "
                    "compute-sanitizer on a card), the serving hot loop, "
                    "and the AIO data-format matrix.")
    p.add_argument("--check", action="append", choices=sorted(CHECKERS),
                   help="run only this checker (repeatable; default: all)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 if any error-severity finding is raised")
    p.add_argument("--json", metavar="PATH",
                   help="also write the findings report as JSON")
    p.add_argument("--list-codes", action="store_true",
                   help="print every finding code with its severity and "
                        "exit")
    p.add_argument("--baseline", metavar="PATH",
                   help="findings-count ratchet: fail on any per-code "
                        "count drift from this platform's section of this "
                        "committed baseline JSON")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write the current per-code findings counts into "
                        "this platform's section of a baseline JSON (its "
                        "other keys kept) and exit 0")
    args = p.parse_args(argv)

    if args.list_codes:
        print(list_codes())
        return 0
    if args.check and "kernel-body" in args.check \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "--check kernel-body needs a CUDA card: its redzone, profiler "
            "and compute-sanitizer runs launch the kernels (the default run "
            "leaves them out with a KB432 info)")

    rep = run_all(args.check)
    print(rep.render())
    if args.json:
        with open(args.json, "w") as f:
            f.write(rep.to_json() + "\n")
        print(f"wrote {args.json}")

    rc = 0
    if args.write_baseline:
        data = {}
        if os.path.exists(args.write_baseline):
            with open(args.write_baseline) as f:
                data = json.load(f)
            if "counts_by_code" in data:
                data = {}
        data["comment"] = ("python -m repro_torch.analysis --write-baseline: "
                           "per-code findings-count ratchet, one section "
                           "per platform")
        data.setdefault(platform(), {})["counts_by_code"] = \
            counts_by_code(rep)
        with open(args.write_baseline, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote the {platform()} section of {args.write_baseline}")
    elif args.baseline:
        with open(args.baseline) as f:
            baseline = baseline_section(json.load(f))
        problems = compare_baseline(rep, baseline)
        for msg in problems:
            print(f"baseline ratchet: {msg}")
        if problems:
            rc = 1
    if args.strict and not rep.ok():
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
