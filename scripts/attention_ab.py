#!/usr/bin/env python3
"""Time the attention kernels (flash_decode and flash_prefill, dense and
int8-KV, the paged flash_prefill_paged, dense and int8-KV, and the
full-sequence flash_attention) of this tree against the same kernels of
other source trees, on the same inputs, in one process.

    python3 scripts/attention_ab.py --tree parent=OTHER/src/repro_torch \
        [--tree NAME=DIR ...] [--rounds 3] [--out-dir build/ab_out] \
        [--split-keys 64,128,256] [--decode-split-keys 64,128,256]

Needs one CUDA card. DIR is another tree's `repro_torch` package: it is
imported under a name of its own, and every kernel of a tree is called
through that tree's own wrappers, as its serving path calls them, so the
trees' C entry points may differ. Every tree's `flash_decode.cu`,
`flash_prefill.cu` and `flash_full.cu` are built with the flags of
`repro_torch.kernels.common` (all nvcc processes at once) and handed to
the tree's own loader. This tree is named "this" and comes last, and every
median is also given relative to the first tree's. Each round times the
trees in order, then in reverse order (A B ... B A), every kernel at the
serving shapes and on the inputs of `chip_smoke.py` phases 4 and 4c (six
copies of the cache, past the 50 MB L2; paged at block size 16), and the
full-sequence kernel at phase 4d's (B 4, Hq 12, Hkv 2, D 128, L 2048,
causal, f32; two copies), by CUDA events behind a device spin. Every
output must be within 1e-4 of the first tree's (the kernels' gate against
their plain version): the trees may sum in other orders (the decode
kernel's split plan changed its order).

Then a key-walk sweep of flash_prefill and flash_decode in each tree: one
row at positions 0, 480, 992 and 2016 (a 32-token chunk for the prefill,
one query for decode; the other rows idle or at position 0), whose times
give the cost of a 32-key tile on a row's walk and the fixed cost of a
launch. And, once, this tree's decode step through the prefill kernel (a
1-token chunk: 58 of each block's 64 rows idle), the baseline a decode
kernel of its own must beat.

With --split-keys 64,128,...: a sweep of this tree's prefill split span,
timing flash_prefill and flash_prefill_quant at each (`prefill.SPLIT_KEYS`
patched for the sweep only, the default restored after it); with
--decode-split-keys, the same for flash_decode and flash_decode_quant
(`decode.SPLIT_KEYS`).

Prints the card's name and power limit, each build's ptxas register
report, every timing and each tree's median ms per kernel (also as a JSON
line); with --out-dir, writes the JSON and `cuobjdump -sass` of every
build there.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
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
import repro_torch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

SOURCES = ("flash_decode", "flash_prefill", "flash_full")
DECODE = ("flash_decode", "flash_decode_quant")
PREFILL = ("flash_prefill", "flash_prefill_quant", "flash_prefill_paged",
           "flash_prefill_paged_quant")
FULL = ("flash_attention",)
WALK_POS = (0, 480, 992, 2016)   # key-walk sweep: positions of the one row


def import_tree(name: str, pkg: Path):
    """Another tree's `repro_torch` package at pkg, imported as `ab_<name>`
    (its modules import each other relatively, so they stay its own)."""
    alias = f"ab_{name}"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def build_tree(name: str, csrc: Path, out: Path) -> dict:
    """Start nvcc on the tree's attention sources, into out/name;
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


def call(fa, name, c):
    """One launch of wrapper `name` of the attention package fa on case c:
    flat on its cache, paged on its block-size-16 pools; the full-sequence
    kernel on its (q, k, v)."""
    if name in FULL:
        return lambda: getattr(fa, name)(*c)
    pre, kw = ("p", {"table": c["table"]}) if "paged" in name else ("", {})
    if name.startswith("flash_prefill"):
        kw["lengths"] = c["lens"]
    kv = ("kc", "ks", "vc", "vs") if name.endswith("_quant") else ("k", "v")
    fn = getattr(fa, name)
    args = [c[pre + n] for n in kv]
    return lambda: fn(c["q"], *args, pos=c["pos"], **kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: another tree's repro_torch package")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out-dir", type=Path, default=None)
    ap.add_argument("--split-keys", default="",
                    help="comma-separated prefill split spans to sweep")
    ap.add_argument("--decode-split-keys", default="",
                    help="comma-separated decode split spans to sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison needs one card")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    trees = {}                      # name: (package module, package dir)
    for spec in args.tree:
        name, _, path = spec.partition("=")
        pkg = Path(path).resolve()
        trees[name] = (import_tree(name, pkg), pkg)
    # last: percentages are to the first
    trees["this"] = (repro_torch, Path(repro_torch.__file__).parent)
    work = common.BUILD_ROOT.parent / "ab"
    builds = {n: build_tree(n, pkg / "csrc", work)
              for n, (_, pkg) in trees.items()}
    attn = {}
    for n, per_src in builds.items():
        mod = trees[n][0].__name__
        loaded = importlib.import_module(f"{mod}.kernels.common")._LIBS
        attn[n] = importlib.import_module(f"{mod}.kernels.flash_attention")
        for src, (lib, proc) in per_src.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"FAILED: nvcc {n}/{src}:\n{log}")
            for line in log.splitlines():
                if "ptxas info" in line and "registers" in line:
                    print(f"  [{n}/{src}] {line.strip()}")
            loaded[src] = load(lib)      # the tree's own loader takes it
            if args.out_dir is not None and shutil.which("cuobjdump"):
                args.out_dir.mkdir(parents=True, exist_ok=True)
                sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                                      capture_output=True, text=True)
                (args.out_dir / f"{n}_{src}.sass").write_text(sass.stdout)

    dev = torch.device("cuda")
    cases = {"decode": [], "prefill": [], "paged": [],
             "full": [cs.full_case(dev, 70 + i, b=cs.FULL_B, hq=cs.HQ,
                                   hkv=cs.HKV, lq=cs.FULL_L, lk=cs.FULL_L,
                                   d=cs.D) for i in range(2)]}
    for i in range(6):
        cases["decode"].append(cs.make_case(
            dev, 10 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=1, lk=cs.LK,
            pos=cs.DECODE_POS))
        cases["prefill"].append(cs.make_case(
            dev, 20 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=cs.W, lk=cs.LK,
            pos=cs.PREFILL_POS, lens=cs.PREFILL_LEN))
        cases["paged"].append(cs.paged_case(dev, cs.make_case(
            dev, 40 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=cs.W, lk=cs.LK,
            pos=cs.PAGED_PREFILL_POS, lens=cs.PAGED_PREFILL_LEN),
            cs.PAGED_TIMED_BS, seed=i))
    names = DECODE + PREFILL + FULL
    fns = {n: {name: [call(attn[n], name, c) for c in cases[
        "full" if name in FULL else "paged" if "paged" in name else
        "prefill" if "prefill" in name else "decode"]]
        for name in names} for n in trees}
    ref = {}
    times = {n: {k: [] for k in names} for n in trees}
    order = list(trees)
    for r in range(args.rounds):
        for n in order + order[::-1]:
            for name in names:
                out = fns[n][name][0]()
                torch.cuda.synchronize()
                if name not in ref:
                    ref[name] = out
                elif (out - ref[name]).abs().max().item() > cs.TOL:
                    raise SystemExit(f"FAILED: {n} {name} is more than "
                                     f"{cs.TOL} from {order[0]}'s output")
                del out
                ms = cs.cuda_ms(fns[n][name], 10 if name in FULL else 60)
                times[n][name].append(ms)
                print(f"  round {r} {n:12s} {name:26s} {ms:.4f} ms",
                      flush=True)
    # where the time goes: one row at growing positions (the others idle
    # or at position 0), so the time over the row's 32-key tiles gives
    # each tree's cost of a tile on a row's key walk and its fixed cost
    walk = {}
    for n in order:
        for name, lq in (("flash_prefill", cs.W), ("flash_decode", 1)):
            ms = []
            for p in WALK_POS:
                lens = [cs.W] + [0] * (cs.B - 1) if lq > 1 else None
                ms.append(cs.cuda_ms([call(attn[n], name, cs.make_case(
                    dev, 60 + i, b=cs.B, hq=cs.HQ, hkv=cs.HKV, lq=lq,
                    lk=cs.LK, pos=[p] + [0] * (cs.B - 1), lens=lens))
                    for i in range(6)], 60))
            walk.setdefault(n, {})[name] = ms
            tiles = [-(-(p + lq) // 32) for p in WALK_POS]
            per_tile = (ms[-1] - ms[0]) / (tiles[-1] - tiles[0])
            print(f"  key walk {n:12s} {name:14s} one row at "
                  f"{list(WALK_POS)} ({tiles} tiles of 32 keys): "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f" ms; {1e3 * per_tile:.2f} us a tile, "
                  f"{ms[0] - tiles[0] * per_tile:.4f} ms fixed", flush=True)
    # the decode step through the prefill kernel (a 1-token chunk a row),
    # this tree's, on the decode cases
    via_prefill = cs.cuda_ms([
        (lambda c: lambda: attn["this"].flash_prefill(
            c["q"], c["k"], c["v"], pos=c["pos"]))(c)
        for c in cases["decode"]], 60)
    print(f"  flash_decode's step through this tree's flash_prefill (W = 1)"
          f": {via_prefill:.4f} ms", flush=True)
    # this tree's split spans: each is a whole number of 32-key tiles
    sweep = {}
    for mod_name, arg, kernels in (
            ("prefill", args.split_keys, PREFILL[:2]),
            ("decode", args.decode_split_keys, DECODE)):
        mod = importlib.import_module(
            f"repro_torch.kernels.flash_attention.{mod_name}")
        default = mod.SPLIT_KEYS
        for span in (int(x) for x in arg.split(",") if x):
            mod.SPLIT_KEYS = span
            try:
                sweep.setdefault(mod_name, {})[span] = {
                    name: cs.cuda_ms(fns["this"][name], 60)
                    for name in kernels}
            finally:
                mod.SPLIT_KEYS = default
            print(f"  {mod_name} split span {span:4d}: " + "  ".join(
                f"{k} {v:.4f} ms"
                for k, v in sweep[mod_name][span].items()), flush=True)
    summary = {n: {k: statistics.median(v) for k, v in t.items()}
               for n, t in times.items()}
    for name in names:
        base = summary[order[0]][name]
        cols = "  ".join(f"{n} {summary[n][name]:.4f} "
                         f"({100 * (summary[n][name] / base - 1):+.1f}%)"
                         for n in order)
        print(f"  median {name:26s} {cols}")
    result = {"card": smi, "median_ms": summary, "ms": times,
              "key_walk_ms": walk, "decode_via_prefill_ms": via_prefill,
              "split_sweep_ms": sweep}
    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        (args.out_dir / "attention_ab.json").write_text(json.dumps(result))
    print(json.dumps({"median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
