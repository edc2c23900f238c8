#!/usr/bin/env python3
"""How often a `torch.profiler` session loses the records of the work it
profiled: every card case of the kernel-body check (`analysis.card.
card_cases()`, 88 contract bodies) run `--rounds` times, each body under
a session of its own inside redzones, as `card.run_body` runs it.

    python3 scripts/profiler_sessions.py [--rounds 10] [--no-warm-up]

First (unless `--no-warm-up`) it runs `analysis.run_all()` once, as
`chip_smoke.py` phase 3f does. For each session it counts the trace's
device records (kernels, copies, fills) and the records of the case's own
kernels, and takes the margins between the session's window (the trace's
"Trace" span) and its first and last device records. It prints every
session that does not hold exactly the contract's launches, with its
device record count and its events by category, then the totals, the
smallest margins and the card's name and power limit, and then runs
`card.run_body` once over every case and prints its findings (exit 1 if
there is one). Needs a CUDA card; builds the kernels first.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import card, run  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def margins_us(events, device):
    """(first device record - window start, window end - last device
    record's end) in microseconds, or None without a window or a record."""
    span = [e for e in events if e.get("cat") == "Trace"]
    if not span or not device:
        return None
    start, end = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    return (min(e["ts"] for e in device) - start,
            end - max(e["ts"] + e.get("dur", 0) for e in device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--no-warm-up", dest="warm_up", action="store_false",
                    help="profile the bodies in a fresh process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script profiles the kernel bodies on one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    common.build_kernels()
    if args.warm_up:
        print("warm-up: analysis.run_all() "
              f"{run.counts_by_code(analysis.run_all())}", flush=True)
    cases = list(card.card_cases())
    sessions = lost = partial = 0
    heads, tails = [], []
    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        for where, lc in cases:
            torch.cuda.synchronize()
            _, _, _, events = card.profiled_body(lc)
            sessions += 1
            device = [e for e in events if e.get("cat") in DEVICE_CATS]
            margins = margins_us(events, device)
            if margins is not None:
                heads.append(margins[0])
                tails.append(margins[1])
            recs = card.profiled_launches(
                events, {lch.kernel for lch in lc.launches})
            if len(recs) == len(lc.launches) and device:
                continue
            if device:
                partial += 1
            else:
                lost += 1
            cats = collections.Counter(e.get("cat") for e in events)
            print(f"round {rnd} {where}: {len(recs)} of {len(lc.launches)} "
                  f"kernel record(s), {len(device)} device record(s) in the "
                  f"trace, margins {margins}; its events by category "
                  f"{dict(cats)}", flush=True)
    heads.sort()
    tails.sort()
    print(f"{sessions} sessions over {len(cases)} cases x {args.rounds} "
          f"rounds in {time.perf_counter() - t0:.1f} s, warm-up "
          f"{'on' if args.warm_up else 'off'}: {lost} with no device "
          f"record, {partial} with device records but not the contract's "
          f"launches; smallest margins (us) head {heads[:3]}, tail "
          f"{tails[:3]}; {smi}", flush=True)
    found = [(where, code, msg) for where, lc in cases
             for code, msg in card.run_body(lc)]
    print(f"run_body over the {len(cases)} cases: {found or 'no finding'}",
          flush=True)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
