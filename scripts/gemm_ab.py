#!/usr/bin/env python3
"""Time the AIO multi-format GEMM (B5), the grouped GEMM (B9) and the
depthwise conv (B11) of this tree against the same C entry points built
from another source tree, on the same inputs, in one process.

    python3 scripts/gemm_ab.py --tree parent=OTHER/src/repro_torch/csrc \
        [--rounds 3] [--out-dir build/ab_out]

Needs one CUDA card. Both trees' `aio_matmul.cu`, `grouped_matmul.cu` and
`depthwise.cu` are built with the flags of `repro_torch.kernels.common`
(all nvcc processes at once). The entry points must have the same
signature in both trees: every call goes through this tree's wrappers, as
the main path calls them (`aio_matmul`; `grouped_matmul` with each
tenant's (K, N) as `morphable_multi_gemm` passes them, and without them:
"packed"; `depthwise_conv`), with the tree's library loaded in place of
this tree's.

Cases: B5 in every mode on the four Linear shapes of qwen2-1.5B, (K, N) in
{(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)}, at M = 8 and 256,
on `chip_smoke.py`'s timing inputs (copies past the 50 MB L2); B9 on
`chip_smoke.MIXES`; B11 on `chip_smoke.DW_SHAPES` (MobileNetV2
(8,56,56,144) and (8,14,14,576) 3x3, ConvNeXt-S (8,56,56,96) and
(8,14,14,384) 7x7), f32. Each round times the other tree, then this tree
twice, then the other tree again (A B B A), every call by CUDA events
behind a device spin. Outputs are checked first: B5 integer modes and B11
bitwise, B5 float modes within rtol 2e-5 and atol 2e-5 * max|other|; B9
within 1e-5 * max|other|.

Prints the card's name and power limit, both builds' ptxas register
reports, every timing, each case's median ms and this tree's change
against the other tree (also as a JSON line); with --out-dir, writes the
JSON and `cuobjdump -sass` of the other tree's builds there.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
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
from repro_torch.kernels.aio_matmul import MODES, aio_matmul  # noqa: E402
from repro_torch.kernels.depthwise import depthwise_conv  # noqa: E402
from repro_torch.kernels.grouped_matmul import grouped_matmul  # noqa: E402

SOURCES = ("aio_matmul", "grouped_matmul", "depthwise")
GEMM_M = (8, 256)


def build(name: str, csrc: Path, out: Path) -> dict:
    """nvcc the three sources of a tree into out/name, all processes at
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
                   args.rounds, times)
                del copies, calls
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
                          "this packed": (tlibs, packed)}, 20, args.rounds,
           times)
        del copies, launches, calls, packed
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
           {other: (olibs, calls), "this": (tlibs, calls)}, 50, args.rounds,
           times)
        del copies, calls

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


if __name__ == "__main__":
    sys.exit(main())
