#!/usr/bin/env python3
"""Serve `chip_smoke.py` phase 5's and 5b's mixes through this tree's
engine and through another tree's, in one process, and compare their
tokens/s and step times.

    python3 scripts/engine_ab.py --tree parent=OTHER/src/repro_torch \
        [--rounds 1] [--variants dense,int8-KV,...] [--probe-off]

Needs one CUDA card. DIR is another tree's `repro_torch` package, imported
under a name of its own (`ab_<name>`), so each tree serves through its own
engine, models and kernel wrappers (it builds its kernels under its own
root). Each variant runs the trees in order, then in reverse (A B B A) per
round, a fresh engine a pass on the tree's own model (qwen2_1p5b CONFIG,
random weights from seed 0, the same in both trees): phase 5's flat engine
(8 slots, max_len 2048, chunk 32) on its 8-request mix, dense bf16 KV,
int8 KV, and the Linears resident in int4 and fp8a (`quantize_params` in
place); phase 5b's paged engine (block size 16) on its 16-request
shared-head mix, bf16 and int8 KV. A pass is `chip_smoke.serve_timed`'s:
warm the engine, submit every request, step until drained, synchronize.
With `--probe-off` this tree also serves as a last tree, "noprobe", with
the resident engines' health probe off (on the same model), to time the
probe alone. Every tree must emit the first tree's tokens. Prints the card's name and
power limit, every pass, and each tree's median tokens/s and step medians
per variant with its change against the first tree (also as a JSON line).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from attention_ab import import_tree  # noqa: E402

# (label, kv_quant, resident format, paged)
VARIANTS = [("dense", False, None, False), ("int8-KV", True, None, False),
            ("int4-resident", False, "int4", False),
            ("fp8a-resident", False, "fp8a", False),
            ("paged bf16-KV", False, None, True),
            ("paged int8-KV", True, None, True)]


def sub(pkg, name: str):
    """Submodule `name` of a tree's package (its own copy)."""
    return importlib.import_module(f"{pkg.__name__}.{name}")


def register_kernels(pkg):
    """Fill the tree's own op registry from its own kernel packages: the
    registry names them as `repro_torch.kernels.*`, which under another
    package name would fill this tree's registry instead."""
    reg = sub(pkg, "api.registry")
    for name in reg._KERNEL_PACKAGES:
        sub(pkg, name.split(".", 1)[1])
    reg.registry._loaded = True


def serve_pass(pkg, cfg, model, prompts, paged, probing=True):
    """One free pass of a fresh, warmed engine of tree `pkg`, timed by
    `chip_smoke.serve_timed`: (tokens/s, median chunk-step ms, median
    decode-only-step ms, tokens). With `probing` False a resident engine
    of this tree serves without its health probe (`_InputProbe`)."""
    eng = sub(pkg, "serving").ServingEngine(
        cfg, model, slots=8, max_len=cs.LK, prefill_chunk=cs.W, paged=paged,
        block_size=16)
    if not probing:
        eng._probing = False
    eng.warmup()
    torch.cuda.synchronize()
    wall, chunk_ms, decode_ms = cs.serve_timed(eng, prompts, cs.MAX_NEW)
    toks = cs.tokens(eng)
    n = sum(map(len, toks.values()))
    return n / wall, float(np.median(chunk_ms)), float(np.median(decode_ms)), \
        toks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of another tree's repro_torch package")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", default=",".join(v[0] for v in VARIANTS))
    ap.add_argument("--probe-off", action="store_true",
                    help="also serve this tree with its resident engines' "
                    "health probe off, as the tree 'noprobe'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_ab: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = [(n, import_tree(n, Path(d).resolve()))
             for n, d in (t.split("=", 1) for t in args.tree)]
    trees.append(("this", repro_torch))
    if args.probe_off:
        trees.append(("noprobe", repro_torch))
    for _, pkg in trees[:len(trees) - args.probe_off]:
        register_kernels(pkg)
        sub(pkg, "kernels.common").build_kernels()
    wanted = args.variants.split(",")
    summary = {}
    for label, kv_quant, resident, paged in VARIANTS:
        if label not in wanted:
            continue
        models = {}
        for name, pkg in trees:
            if name == "noprobe":
                models[name] = models["this"]
                continue
            base = sub(pkg, "configs").get_config("qwen2_1p5b")
            cfg = dataclasses.replace(base, kv_quant=kv_quant)
            models_mod = sub(pkg, "models")
            model = models_mod.init_params(cfg, seed=0, device="cuda")
            if resident:
                models_mod.quantize_params(model, resident)
            models[name] = (pkg, cfg, model)
        vocab = cfg.vocab
        prompts = cs.paged_prompts(vocab) if paged else \
            cs.engine_prompts(vocab)
        runs = {name: [] for name, _ in trees}
        first_tokens = None
        order = [n for n, _ in trees]
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                pkg, cfg, model = models[name]
                tps, chunk, dec, toks = serve_pass(
                    pkg, cfg, model, prompts, paged, name != "noprobe")
                if first_tokens is None:
                    first_tokens = toks
                cs.check(toks == first_tokens, f"{label}: tree {name}'s "
                         "tokens differ from the first pass's")
                runs[name].append((tps, chunk, dec))
                print(f"  [{label}] {name}: {tps:.2f} tok/s, chunk step "
                      f"median {chunk:.2f} ms, decode-only {dec:.2f} ms",
                      flush=True)
        ref = statistics.median(r[0] for r in runs[order[0]])
        summary[label] = {}
        for name in order:
            med = [statistics.median(r[i] for r in runs[name])
                   for i in range(3)]
            summary[label][name] = dict(tok_s=med[0], chunk_ms=med[1],
                                        decode_ms=med[2],
                                        passes=[r[0] for r in runs[name]])
            print(f"  [{label}] {name}: median {med[0]:.2f} tok/s "
                  f"({100 * (med[0] / ref - 1):+.1f}% against "
                  f"{order[0]}), chunk {med[1]:.2f} ms, decode-only "
                  f"{med[2]:.2f} ms; tokens equal", flush=True)
        del models
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
