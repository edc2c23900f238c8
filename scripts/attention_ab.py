#!/usr/bin/env python3
"""Time the flat attention kernels (flash_decode and flash_prefill, dense
and int8-KV) of this tree against the same C entry points built from other
kernel source trees, on the same inputs, in one process.

    python3 scripts/attention_ab.py --tree parent=OTHER/src/repro_torch/csrc \
        [--tree NAME=DIR ...] [--rounds 3] [--out-dir build/ab_out]

Needs one CUDA card. Every tree's `flash_decode.cu` and `flash_prefill.cu`
are built with the flags of `repro_torch.kernels.common` (all nvcc
processes at once); this tree is named "this" and comes last, and every
median is also given relative to the first tree's. Each round times the trees
in order, then in reverse order (A B ... B A), every kernel at the serving
shapes and on the inputs of `chip_smoke.py` phase 4 (six copies of the
cache, past the 50 MB L2), by CUDA events behind a device spin. The flat C
entry points must have the same signature in every tree: the script loads
each tree's library in place of this tree's for its timed calls.

Prints the card's name and power limit, each build's ptxas register
report, every timing and each tree's median ms per kernel (also as a JSON
line); with --out-dir, writes the JSON and `cuobjdump -sass` of every
build there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

SOURCES = ("flash_decode", "flash_prefill")
NAMES = ("flash_decode", "flash_decode_quant", "flash_prefill",
         "flash_prefill_quant")


def build_tree(name: str, csrc: Path, out: Path) -> dict:
    """Start nvcc on the tree's two attention sources, into out/name;
    returns {source: (library path, running nvcc process)}."""
    out = out / name
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        lib = out / f"lib{src}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{src}.cu")]
        procs[src] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: another tree's csrc directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out-dir", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison needs one card")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    trees = {}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    trees["this"] = common.CSRC     # last: percentages are to the first
    work = common.BUILD_ROOT.parent / "ab"
    builds = {n: build_tree(n, d, work) for n, d in trees.items()}
    libs = {}
    for n, per_src in builds.items():
        libs[n] = {}
        for src, (lib, proc) in per_src.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"FAILED: nvcc {n}/{src}:\n{log}")
            for line in log.splitlines():
                if "ptxas info" in line and "registers" in line:
                    print(f"  [{n}/{src}] {line.strip()}")
            libs[n][src] = load(lib)
            if args.out_dir is not None and shutil.which("cuobjdump"):
                args.out_dir.mkdir(parents=True, exist_ok=True)
                sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                                      capture_output=True, text=True)
                (args.out_dir / f"{n}_{src}.sass").write_text(sass.stdout)

    dev = torch.device("cuda")
    copies = {"decode": [], "prefill": []}
    for i in range(6):
        copies["decode"].append(cs.make_case(
            dev, 10 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=1, lk=cs.LK,
            pos=cs.DECODE_POS))
        copies["prefill"].append(cs.make_case(
            dev, 20 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=cs.W, lk=cs.LK,
            pos=cs.PREFILL_POS, lens=cs.PREFILL_LEN))
    fns = {name: [cs.calls(name, c, {})[0]
                  for c in copies["prefill" if "prefill" in name
                                  else "decode"]] for name in NAMES}
    # the same outputs from every tree: the kernels compute one function
    ref = {}
    times = {n: {k: [] for k in NAMES} for n in trees}
    order = list(trees)
    for r in range(args.rounds):
        for n in order + order[::-1]:
            common._LIBS.update(libs[n])
            for name in NAMES:
                out = fns[name][0]()
                torch.cuda.synchronize()
                if name not in ref:
                    ref[name] = out
                elif not torch.equal(out, ref[name]):
                    raise SystemExit(f"FAILED: {n} {name} differs from "
                                     f"{order[0]}'s output")
                ms = cs.cuda_ms(fns[name], 60)
                times[n][name].append(ms)
                print(f"  round {r} {n:12s} {name:20s} {ms:.4f} ms",
                      flush=True)
    summary = {n: {k: statistics.median(v) for k, v in t.items()}
               for n, t in times.items()}
    for name in NAMES:
        base = summary[order[0]][name]
        cols = "  ".join(f"{n} {summary[n][name]:.4f} "
                         f"({100 * (summary[n][name] / base - 1):+.1f}%)"
                         for n in order)
        print(f"  median {name:20s} {cols}")
    result = {"card": smi, "median_ms": summary, "ms": times}
    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        (args.out_dir / "attention_ab.json").write_text(json.dumps(result))
    print(json.dumps({"median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
