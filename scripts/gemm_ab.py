#!/usr/bin/env python3
"""Time the AIO multi-format GEMM (B5), the grouped GEMM (B9), the AIO
quantizer (B10) and the depthwise conv (B11) of this tree against the same
kernels built from another source tree, on the same inputs, in one
process.

    python3 scripts/gemm_ab.py --tree parent=OTHER/src/repro_torch/csrc \
        [--rounds 3] [--kernels B5,B9,B10,B11] [--out-dir build/ab_out]

Needs one CUDA card. Both trees' `aio_matmul.cu`, `grouped_matmul.cu`,
`aio_quant.cu` and `depthwise.cu` are built with the flags of
`repro_torch.kernels.common` (all nvcc processes at once). B5, B9 and B11
go through this tree's wrappers, as the main path calls them
(`aio_matmul`; `grouped_matmul` with each tenant's (K, N) as
`morphable_multi_gemm` passes them, and without them: "packed";
`depthwise_conv`), with the other tree's library loaded in place of this
tree's, so their C entry points must have the same signature in both
trees. B10 goes through each tree's own `aio_quant` wrapper (the other
tree's `repro_torch` package, OTHER/src/repro_torch, imported under a name
of its own), so its C entry point may differ: this tree's takes the
launch plan of `quant_plan`.

Cases: B5 in every mode on the four Linear shapes of qwen2-1.5B, (K, N) in
{(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)}, at M = 8 and 256,
on `chip_smoke.py`'s timing inputs (copies past the 50 MB L2); B9 on
`chip_smoke.MIXES`; B10 in the four resident formats (fp8a, fp8b, int8,
int4) at M = 8 and 256, N = 1536 and 8960 (the Linear inputs of
qwen2-1.5B), floor FLT_MIN, on `chip_smoke.quant_timing_copies`; B11 on
`chip_smoke.DW_SHAPES` (MobileNetV2 (8,56,56,144) and (8,14,14,576) 3x3,
ConvNeXt-S (8,56,56,96) and (8,14,14,384) 7x7), f32. Each round times the
other tree, then this tree twice, then the other tree again (A B B A),
every call by CUDA events behind a device spin. Outputs are checked first:
B5 integer modes, B10 (codes and scales) and B11 bitwise, B5 float modes
within rtol 2e-5 and atol 2e-5 * max|other|; B9 within 1e-5 * max|other|.

Before B10's A/B, a sweep of this tree's B10 plans at the same points:
every cluster size (1, 2, 4, 8) with every count of 16-byte vectors a
thread holds (1, 2, 4, 8; the threads are the fewest whole warps that
cover a block's part, at most 512) and the re-read path, with
`quant_plan` patched for the sweep only; it prints each plan's ms, the
plan `quant_plan` takes, and the launch floor (back-to-back
`torch.cuda._sleep(0)`).

Prints the card's name and power limit, both builds' ptxas register
reports, every timing, each case's median ms and this tree's change
against the other tree (also as a JSON line); with --out-dir, writes the
JSON and `cuobjdump -sass` of the other tree's builds there.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
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
from attention_ab import import_tree  # noqa: E402
from repro_torch.core.formats import FLT_MIN  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.aio_matmul import MODES, aio_matmul  # noqa: E402
from repro_torch.kernels.aio_quant import aio_quant  # noqa: E402
from repro_torch.kernels.aio_quant.ops import (  # noqa: E402
    CLUSTER_SIZES, MAX_THREADS, MAX_UNITS, plan_with, quant_plan)
from repro_torch.kernels.depthwise import depthwise_conv  # noqa: E402
from repro_torch.kernels.grouped_matmul import grouped_matmul  # noqa: E402

SOURCES = ("aio_matmul", "grouped_matmul", "aio_quant", "depthwise")
KERNELS = ("B5", "B9", "B10", "B11")
GEMM_M = (8, 256)
QUANT_N = (1536, 8960)


def build(name: str, csrc: Path, out: Path) -> dict:
    """nvcc the sources of a tree into out/name, all processes at
    once; returns {source: loaded library}, printing the ptxas register
    lines."""
    out = out / name
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        lib = out / f"lib{src}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{src}.cu")]
        procs[src] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"FAILED: nvcc {name}/{src}:\n{log}")
        for line in log.splitlines():
            if "ptxas info" in line and "registers" in line:
                print(f"  [{name}/{src}] {line.strip()}")
        dll = ctypes.CDLL(str(lib))
        dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
        dll.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[src] = dll
    return libs


def on(libs, fn, *args, **kw):
    """fn(*args, **kw) with the tree's libraries in place of this tree's."""
    saved = {k: common._LIBS.get(k) for k in libs}
    common._LIBS.update(libs)
    try:
        return fn(*args, **kw)
    finally:
        common._LIBS.update(saved)


def ab(label, fns, iters, rounds, times):
    """Time fns = {tree: (libraries, [call per input copy])} A B B A for
    `rounds`."""
    order = list(fns)
    for r in range(rounds):
        for tree in order + order[::-1]:
            libs, calls = fns[tree]
            ms = on(libs, cs.cuda_ms, calls, iters)
            times.setdefault(label, {}).setdefault(tree, []).append(ms)
            print(f"  round {r} {tree:14s} {label:40s} {ms:.4f} ms",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="NAME=DIR: the other tree's csrc directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="which of B5,B9,B10,B11 to time (default: all)")
    ap.add_argument("--out-dir", type=Path, default=None)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: each of {KERNELS}")
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison needs one card")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other, _, path = args.tree.partition("=")
    work = common.BUILD_ROOT.parent / "ab"
    olibs = build(other, Path(path).resolve(), work)
    tlibs = build("this", common.CSRC, work)
    if args.out_dir is not None and shutil.which("cuobjdump"):
        args.out_dir.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            sass = subprocess.run(["cuobjdump", "-sass",
                                   str(work / other / f"lib{src}.so")],
                                  capture_output=True, text=True)
            (args.out_dir / f"{other}_{src}.sass").write_text(sass.stdout)

    dev = torch.device("cuda")
    times = {}
    if "B5" in kernels:
        time_b5(dev, other, olibs, tlibs, args.rounds, times)
    if "B9" in kernels:
        time_b9(dev, other, olibs, tlibs, args.rounds, times)
    if "B10" in kernels:
        pkg = import_tree(other, Path(path).resolve().parent)
        importlib.import_module(f"{pkg.__name__}.kernels.common")._LIBS[
            "aio_quant"] = olibs["aio_quant"]
        oquant = importlib.import_module(
            f"{pkg.__name__}.kernels.aio_quant").aio_quant
        sweep_b10(dev, tlibs)
        time_b10(dev, other, (olibs, oquant), (tlibs, aio_quant),
                 args.rounds, times)
    if "B11" in kernels:
        time_b11(dev, other, olibs, tlibs, args.rounds, times)

    summary = {label: {tree: statistics.median(v) for tree, v in t.items()}
               for label, t in times.items()}
    for label, med in summary.items():
        base = med[other]
        cols = "  ".join(f"{tree} {ms:.4f} ({100 * (ms / base - 1):+.1f}%)"
                         for tree, ms in med.items())
        print(f"  median {label:40s} {cols}")
    result = {"card": smi, "median_ms": summary, "ms": times}
    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        (args.out_dir / "gemm_ab.json").write_text(json.dumps(result))
    print(json.dumps({"card": smi, "median_ms": summary}))
    return 0


def time_b5(dev, other, olibs, tlibs, rounds, times):
    for k, n in cs.GEMM_SHAPES:
        for m in GEMM_M:
            for mode in MODES:
                copies = cs.gemm_timing_copies(dev, mode, m, k, n)
                a = on(olibs, aio_matmul, *copies[0], mode=mode)
                b = on(tlibs, aio_matmul, *copies[0], mode=mode)
                torch.cuda.synchronize()
                if mode in ("int8", "int4"):
                    ok = torch.equal(a, b)
                else:
                    ok = torch.allclose(b, a, rtol=cs.GEMM_TOL,
                                        atol=cs.GEMM_TOL
                                        * a.abs().max().item())
                if not ok:
                    raise SystemExit(f"FAILED: aio_matmul {mode} M={m} K={k}"
                                     f" N={n}: the trees disagree")
                calls = [functools.partial(aio_matmul, *c, mode=mode)
                         for c in copies]
                ab(f"B5 {mode} M={m} K={k} N={n}",
                   {other: (olibs, calls), "this": (tlibs, calls)}, 50,
                   rounds, times)
                del copies, calls


def time_b9(dev, other, olibs, tlibs, rounds, times):
    for name, shapes in cs.MIXES.items():
        mix_bytes = 4 * sum(mm * kk + kk * nn for mm, kk, nn in shapes)
        copies = [cs.tenant_data(dev, shapes, 80 + i)
                  for i in range(max(2, -(-100_000_000 // mix_bytes)))]
        launches = [cs.packed(t) for t in copies]
        ext = cs.extents(shapes)
        a = on(olibs, grouped_matmul, *launches[0], **ext)
        for b in (on(tlibs, grouped_matmul, *launches[0]),
                  on(tlibs, grouped_matmul, *launches[0], **ext)):
            torch.cuda.synchronize()
            rel = ((a - b).abs().max() / a.abs().max()).item()
            if rel > 1e-5:
                raise SystemExit(f"FAILED: grouped_matmul {name}: the trees "
                                 f"differ by {rel} of max|other|")
        calls = [functools.partial(grouped_matmul, *la, **ext)
                 for la in launches]
        packed = [functools.partial(grouped_matmul, *la) for la in launches]
        ab(f"B9 {name}", {other: (olibs, calls), "this": (tlibs, calls),
                          "this packed": (tlibs, packed)}, 20, rounds, times)
        del copies, launches, calls, packed


def sweep_b10(dev, tlibs):
    """Every plan this tree's quantizer can take at each timed point."""
    floor_ms = cs.launch_floor_ms()
    print(f"  B10 plan sweep; launch floor {floor_ms:.4f} ms", flush=True)
    for n in QUANT_N:
        for m in GEMM_M:
            xs = cs.quant_timing_copies(dev, m, n)
            plans = [plan_with(n, c, u) for c in CLUSTER_SIZES
                     for u in (0, 1, 2, 4, MAX_UNITS)]
            plans = [p for p in plans if p.threads <= MAX_THREADS]
            for fmt in cs.QUANT_FORMATS:
                calls = [functools.partial(aio_quant, x, fmt_name=fmt,
                                           floor=FLT_MIN) for x in xs]
                for plan in plans:
                    with cs.forced_quant_plan(plan):
                        ms = on(tlibs, cs.cuda_ms, calls, 50)
                    mark = " <- quant_plan" if plan == quant_plan(m, n) \
                        else ""
                    print(f"  sweep B10 {fmt:5s} M={m:3d} N={n} cluster "
                          f"{plan.cluster} threads {plan.threads:3d} values "
                          f"{plan.vals:2d}: {ms:.4f} ms{mark}", flush=True)
            del xs


def time_b10(dev, other, otree, ttree, rounds, times):
    """B10 through each tree's own wrapper: (libraries, aio_quant)."""
    for n in QUANT_N:
        for m in GEMM_M:
            xs = cs.quant_timing_copies(dev, m, n)
            for fmt in cs.QUANT_FORMATS:
                fns = {}
                for tree, (libs, quant) in ((other, otree), ("this", ttree)):
                    a = on(libs, quant, xs[0], fmt_name=fmt, floor=FLT_MIN)
                    fns[tree] = (libs, [functools.partial(
                        quant, x, fmt_name=fmt, floor=FLT_MIN) for x in xs])
                    if tree == other:
                        want = a
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(a, want)):
                    raise SystemExit(f"FAILED: aio_quant {fmt} M={m} N={n}: "
                                     "the trees disagree")
                ab(f"B10 {fmt} M={m} N={n}", fns, 50, rounds, times)
            del xs


def time_b11(dev, other, olibs, tlibs, rounds, times):
    for n, h, w, c, kk in cs.DW_SHAPES:
        nbytes = 4 * (2 * n * h * w * c + kk * kk * c)
        g = torch.Generator(device=dev).manual_seed(kk * c)
        copies = [(torch.randn(n, h, w, c, generator=g, device=dev),
                   torch.randn(kk, kk, c, generator=g, device=dev))
                  for _ in range(max(2, -(-100_000_000 // nbytes)))]
        a = on(olibs, depthwise_conv, *copies[0])
        b = on(tlibs, depthwise_conv, *copies[0])
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise SystemExit(f"FAILED: depthwise_conv {(n, h, w, c, kk)}: "
                             "the trees disagree")
        calls = [functools.partial(depthwise_conv, *x) for x in copies]
        ab(f"B11 {(n, h, w, c)} {kk}x{kk}",
           {other: (olibs, calls), "this": (tlibs, calls)}, 50, rounds,
           times)
        del copies, calls


if __name__ == "__main__":
    sys.exit(main())
