"""Production-mesh dry-run: build one rank's step for every (arch x shape x
mesh) cell on `meta` tensors, and count what it would do.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1p5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 / 512 placeholder
devices and reads XLA's cost and memory analyses. Here the mesh is a
`ShapeMesh` of the production shape ((16, 16) or (2, 16, 16); no process
group, nothing allocated): the model is built on `meta` in bf16, cut to
rank (0, 0)'s shards by the specs, and its step (train, prefill or decode)
runs on `meta` tensors under the mesh, so the collectives return the right
shapes and record their calls. Per cell this records success or the
error; per-rank bytes of params, optimizer state, caches and batch from
the specs; FLOPs from `torch.utils.flop_counter.FlopCounterMode` (the full
model, and `probe_pair`'s extrapolation from two shallow configs, which
equals it by linearity); `model_flops`; and the collectives' counts and
wire bytes per kind by the reference's ring model (`collective_bytes`)
applied to the recorded calls. These are torch's counts of the port's
step, not XLA's of the reference's. Attention takes the plain `ref` route
(no kernel runs on `meta`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import api
from ..configs import ARCH_IDS, SHAPES, get_config, shape_support
from ..dist.collectives import record_collectives
from ..dist.sharding import dp_size, set_mesh
from ..dist.specs import (batch_specs, cache_specs, local_bytes,
                          opt_state_specs, param_specs, param_tree,
                          shard_params)
from ..optim import adamw_init
from .mesh import make_production_mesh
from . import steps as S

__all__ = ["DRYRUN_ARCHS", "collective_bytes", "model_flops", "probe_pair",
           "run_step", "lower_cell", "main"]

# Assigned archs only (the paper's own gpt2/llama ride through benchmarks/)
DRYRUN_ARCHS = [a for a in ARCH_IDS if a not in ("gpt2_small", "llama2_7b")]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
COUNTS_FROM = ("torch FlopCounterMode and the port's recorded collectives "
               "on meta tensors (not XLA's cost analysis)")


def collective_bytes(records: List[Dict]) -> Dict:
    """Per-rank *wire* bytes of the recorded collectives (each record's
    kind, result shape, dtype and group size G), by the reference's ring
    model:
        all-reduce        2*(G-1)/G * result   (reduce-scatter + all-gather)
        all-gather        (G-1)/G * result     (receives all but own shard)
        reduce-scatter    (G-1)/G * result*G   (operand is G x result)
        all-to-all        (G-1)/G * result
        collective-permute result               (one hop)
    """
    per_op = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for r in records:
        kind, g = r["kind"], r["group"]
        rbytes = math.prod(r["shape"]) * torch.empty(
            (), dtype=r["dtype"]).element_size()
        if g <= 1:
            wire = 0.0
        elif kind == "all-reduce":
            wire = 2.0 * (g - 1) / g * rbytes
        elif kind == "reduce-scatter":
            wire = (g - 1) / g * rbytes * g
        elif kind == "collective-permute":
            wire = float(rbytes)
        else:                           # all-gather / all-to-all
            wire = (g - 1) / g * rbytes
        per_op[kind] += wire
        counts[kind] += 1
    per_op["total"] = sum(per_op[k] for k in _COLLECTIVES)
    per_op["counts"] = counts
    return per_op


def model_flops(cfg, n_params: int, n_active: int, cell) -> float:
    """6*N*D for training, 2*N*D forward-only (N_active for MoE)."""
    n = n_active if cfg.n_experts else n_params
    if cell.kind == "train":
        return 6.0 * n * cell.batch * cell.seq
    if cell.kind == "prefill":
        return 2.0 * n * cell.batch * cell.seq
    return 2.0 * n * cell.batch          # decode: one token per sequence


def probe_pair(cfg):
    """Two shallow configs (all segment types present; the repeating unit
    appears once vs twice) + the extrapolation multiplier:
    total(metric) = F(base) + mult * (F(base+1unit) - F(base))."""
    r = dataclasses.replace
    if cfg.family == "audio":           # encoder fixed, decoder unit scales
        return r(cfg, n_layers=1), r(cfg, n_layers=2), cfg.n_layers - 1
    if cfg.attn_every:
        u = cfg.attn_every
        return (r(cfg, n_layers=u), r(cfg, n_layers=2 * u),
                cfg.n_layers // u - 1)
    if cfg.slstm_every:
        u = cfg.slstm_every
        return (r(cfg, n_layers=u), r(cfg, n_layers=2 * u),
                cfg.n_layers // u - 1)
    if cfg.local_global:
        return r(cfg, n_layers=2), r(cfg, n_layers=4), cfg.n_layers // 2 - 1
    if cfg.n_experts and cfg.n_dense_layers:
        nd = cfg.n_dense_layers
        return (r(cfg, n_layers=nd + 1), r(cfg, n_layers=nd + 2),
                cfg.n_layers - nd - 1)
    return r(cfg, n_layers=1), r(cfg, n_layers=2), cfg.n_layers - 1


def _numel(tree) -> int:
    from ..dist.specs import _leaves
    return sum(math.prod(x.shape) for x in _leaves(tree))


def _active_params(tree, cfg) -> int:
    total = _numel(tree)
    if not cfg.n_experts:
        return total
    expert = 0
    for seg in tree["segments"]:
        for key, blk in seg.items():
            if "moe" in key and isinstance(blk, dict) and "moe" in blk:
                for nm in ("gate", "up", "down"):
                    expert += math.prod(blk["moe"][nm].shape)
    return int(total - expert * (1 - cfg.top_k / cfg.n_experts))


def run_step(cfg, cell, mesh) -> Dict:
    """One rank's step of `cell` on `meta` under `mesh`: {"flops", "coll"
    (collective_bytes), "records"}."""
    model = S.params_shapes(cfg)
    shard_params(model, mesh)
    batch = S.input_specs(cfg, cell)
    with set_mesh(mesh), api.policy(backend="ref"), \
            record_collectives() as rec, \
            FlopCounterMode(display=False) as fc:
        if cell.kind == "train":
            model.trainable_(True)
            opt = adamw_init(list(model.parameters()))
            S.make_train_step(cfg, mesh=mesh)(model, opt, batch)
        elif cell.kind == "prefill":
            S.make_prefill_step(cfg)(model, S.dp_slice(batch, mesh,
                                                       replicate=True))
        else:
            local = S.dp_slice(batch, mesh, replicate=True)
            caches = S.cache_shapes(cfg, local["token"].shape[0], cell.seq,
                                    model=model)
            S.make_serve_step(cfg)(model, caches, local["token"],
                                   memory=local.get("memory"))
    return {"flops": float(fc.get_total_flops()),
            "coll": collective_bytes(rec), "records": rec}


def _bytes(cfg, cell, mesh) -> Dict[str, int]:
    """Per-rank bytes of params (bf16), optimizer state, caches and batch
    under the specs."""
    tree = param_tree(S.params_shapes(cfg))
    out = {"params": local_bytes(tree, param_specs(tree, mesh), mesh)}
    batch = S.input_specs(cfg, cell)
    out["batch"] = local_bytes(batch, batch_specs(batch, mesh), mesh)
    if cell.kind == "train":
        opt = S.opt_shapes(cfg)
        out["opt_state"] = local_bytes(opt, opt_state_specs(opt, mesh), mesh)
    if cell.kind == "decode":
        caches = S.cache_shapes(cfg, cell.batch, cell.seq)
        out["caches"] = local_bytes(
            caches, cache_specs(caches, mesh, stacked=False), mesh)
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None, tag: str = "", probes: bool = True,
               mesh=None, cell=None) -> Dict:
    """Build and count one cell; returns its record (raises on failure).
    mesh / cell override the production mesh and the shape cell (a test
    cuts them to size)."""
    cell = cell or SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    support = shape_support(arch)
    if support[shape_name] is not None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": support[shape_name]}
    cfg = cfg_override or get_config(arch)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape)
    tree = param_tree(S.params_shapes(cfg))
    n_params = _numel(tree)
    n_active = _active_params(tree, cfg)

    t0 = time.time()
    full = run_step(cfg, cell, mesh)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "chips": int(mesh.size()), "dp": dp_size(mesh),
        "n_params": int(n_params), "n_params_active": int(n_active),
        "model_flops": model_flops(cfg, n_params, n_active, cell),
        "bytes_per_rank": _bytes(cfg, cell, mesh),
        "flops": full["flops"],
        "collective_bytes": full["coll"],
        "collective_sites": _sites(full["records"]),
        "build_s": round(time.time() - t0, 2),
        "counts_from": COUNTS_FROM,
    }
    if probes:
        base_cfg, big_cfg, mult = probe_pair(cfg)
        f_base = run_step(base_cfg, cell, mesh)
        f_big = run_step(big_cfg, cell, mesh)
        rec["flops_probe"] = f_base["flops"] + mult * (
            f_big["flops"] - f_base["flops"])
        rec["collective_bytes_probe"] = {
            k: max(f_base["coll"][k] + mult * (f_big["coll"][k]
                                               - f_base["coll"][k]), 0.0)
            for k in f_base["coll"] if k != "counts"}
        rec["probe"] = {"base_layers": base_cfg.n_layers,
                        "big_layers": big_cfg.n_layers, "mult": mult}
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
          f"(build {rec['build_s']:.1f}s, flops/rank {rec['flops']:.3e}, "
          f"params {rec['bytes_per_rank']['params'] / 2**30:.2f} GiB/rank, "
          f"coll {full['coll']['total'] / 2**20:.1f} MiB/rank)", flush=True)
    return rec


def _sites(records: List[Dict]) -> Dict[str, Dict[str, int]]:
    """{site: {"<kind> <phase>": count}} of the recorded calls."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        key = f"{r['kind']} {r['phase']}"
        site = out.setdefault(str(r["site"]), {})
        site[key] = site.get(key, 0) + 1
    return out


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the names of the failed cells (exit 1 when
    there are any)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=DRYRUN_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = DRYRUN_ARCHS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else ([args.shape] if args.shape
                                            else list(SHAPES))
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}.json"
                path = out / name
                if path.exists() and not args.force:
                    print(f"[dryrun] skip existing {name}")
                    continue
                try:
                    # probes only on the single-pod mesh; the multi-pod pass
                    # proves the "pod" axis shards
                    rec = lower_cell(arch, shape, mp, probes=not mp)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(name)
                path.write_text(json.dumps(rec, indent=2, default=str))
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all requested cells OK")
    return failures


if __name__ == "__main__":
    main()
