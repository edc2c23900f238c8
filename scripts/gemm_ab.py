#!/usr/bin/env python3
"""Time the AIO multi-format GEMM (B5) and the grouped GEMM (B9) of this
tree against the same C entry points built from another source tree, on
the same inputs, in one process.

    python3 scripts/gemm_ab.py --tree parent=OTHER/src/repro_torch/csrc \
        [--rounds 3] [--out-dir build/ab_out]

Needs one CUDA card. The other tree's `aio_matmul.cu` and
`grouped_matmul.cu` are built with the flags of `repro_torch.kernels.common`
(both nvcc processes at once) and called through their own signature: the
entry points of the first port of these kernels (a fp8 decode table, no
launch plan; no group extents, so the grouped GEMM is timed on the padded
launch). This tree is called through its wrappers, as the main path calls
them: `aio_matmul`, and `grouped_matmul` with each tenant's (K, N) as
`morphable_multi_gemm` passes them (also timed without them: "packed").

Cases: B5 in every mode on the four Linear shapes of qwen2-1.5B, (K, N) in
{(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)}, at M = 8 and 256,
on `chip_smoke.py`'s timing inputs (copies past the 50 MB L2); B9 on
`chip_smoke.MIXES`. Each round times the other tree, then this tree twice,
then the other tree again (A B B A), every call by CUDA events behind a
device spin. Outputs are checked first: B5 integer modes bitwise, float
modes within rtol 2e-5 and atol 2e-5 * max|other|; B9 within 1e-5 *
max|other|.

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
from repro_torch.core import formats as FM  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.aio_matmul import MODES, aio_matmul  # noqa: E402
from repro_torch.kernels.grouped_matmul import grouped_matmul  # noqa: E402

SOURCES = ("aio_matmul", "grouped_matmul")
GEMM_M = (8, 256)
# the first port's entry points: aio_matmul(mode, x, w, xs, ws, table, out,
# M, N, K, x_vec, w_vec, stream); grouped_matmul(in_bf16, out_bf16, x, w,
# gid, out, T, K, N, bm, stream)
OLD_AIO_MODES = {"bf16": 0, "fp8a": 1, "fp8b": 1, "int8": 2, "int4": 3}
OLD_AIO_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
OLD_GROUPED_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 4


def build(name: str, csrc: Path, out: Path) -> dict:
    """nvcc both sources of a tree into out/name, all processes at once;
    returns {source: loaded library}, printing the ptxas register lines."""
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


def old_table(mode: str, dev) -> torch.Tensor:
    """The first port's fp8 decode table: 256 bf16 bit patterns."""
    vals = FM.decode(torch.arange(256, dtype=torch.int32), FM.REGISTRY[mode])
    return vals.to(torch.bfloat16).view(torch.int16).to(dev)


def old_aio(lib, mode, x, w, xs, ws, table):
    """One launch of the first port's aio_matmul entry."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = lib.aio_matmul
    fn.argtypes = [*OLD_AIO_ARGS, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    code = fn(OLD_AIO_MODES[mode], x.data_ptr(), w.data_ptr(), ptr(xs),
              ptr(ws), ptr(table), out.data_ptr(), m, n, k,
              int(k * x.element_size() % 16 == 0),
              int(n * w.element_size() % 16 == 0),
              torch.cuda.current_stream().cuda_stream)
    common.check_launch(lib, "aio_matmul", code)
    return out


def old_grouped(lib, gids, x, w, bm=128):
    """One launch of the first port's grouped_matmul entry (f32 out)."""
    t, k = x.shape
    n = w.shape[2]
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    fn = lib.grouped_matmul
    fn.argtypes = [*OLD_GROUPED_ARGS, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(int(x.dtype == torch.bfloat16), 0, x.data_ptr(), w.data_ptr(),
              gids.data_ptr(), out.data_ptr(), t, k, n, bm,
              torch.cuda.current_stream().cuda_stream)
    common.check_launch(lib, "grouped_matmul", code)
    return out


def ab(label, fns, iters, rounds, times):
    """Time fns = {tree: [call per input copy]} A B B A for `rounds`."""
    order = list(fns)
    for r in range(rounds):
        for tree in order + order[::-1]:
            ms = cs.cuda_ms(fns[tree], iters)
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
    libs = build(other, Path(path).resolve(), common.BUILD_ROOT.parent / "ab")
    common.build_kernels()
    if args.out_dir is not None and shutil.which("cuobjdump"):
        args.out_dir.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            lib = common.BUILD_ROOT.parent / "ab" / other / f"lib{src}.so"
            sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                                  capture_output=True, text=True)
            (args.out_dir / f"{other}_{src}.sass").write_text(sass.stdout)

    dev = torch.device("cuda")
    times = {}
    for k, n in cs.GEMM_SHAPES:
        for m in GEMM_M:
            for mode in MODES:
                copies = cs.gemm_timing_copies(dev, mode, m, k, n)
                table = old_table(mode, dev) if mode.startswith("fp8") \
                    else None
                a = old_aio(libs["aio_matmul"], mode, *copies[0], table)
                b = aio_matmul(*copies[0], mode=mode)
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
                fns = {other: [functools.partial(
                    old_aio, libs["aio_matmul"], mode, *c, table)
                    for c in copies],
                    "this": [functools.partial(aio_matmul, *c, mode=mode)
                             for c in copies]}
                ab(f"B5 {mode} M={m} K={k} N={n}", fns, 50, args.rounds,
                   times)
                del copies, fns
    for name, shapes in cs.MIXES.items():
        mix_bytes = 4 * sum(mm * kk + kk * nn for mm, kk, nn in shapes)
        copies = [cs.tenant_data(dev, shapes, 80 + i)
                  for i in range(max(2, -(-100_000_000 // mix_bytes)))]
        launches = [cs.packed(t) for t in copies]
        ext = cs.extents(shapes)
        a = old_grouped(libs["grouped_matmul"], *launches[0])
        for b in (grouped_matmul(*launches[0]),
                  grouped_matmul(*launches[0], **ext)):
            torch.cuda.synchronize()
            rel = ((a - b).abs().max() / a.abs().max()).item()
            if rel > 1e-5:
                raise SystemExit(f"FAILED: grouped_matmul {name}: the trees "
                                 f"differ by {rel} of max|other|")
        fns = {other: [functools.partial(old_grouped, libs["grouped_matmul"],
                                         *la) for la in launches],
               "this": [functools.partial(grouped_matmul, *la, **ext)
                        for la in launches],
               "this packed": [functools.partial(grouped_matmul, *la)
                               for la in launches]}
        ab(f"B9 {name}", fns, 20, args.rounds, times)
        del copies, launches, fns

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
