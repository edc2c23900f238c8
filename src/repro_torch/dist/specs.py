"""Placement rules for params / optimizer state / batches / caches.

Each leaf gets one placement per mesh dim, `Shard(d)` or `Replicate()`:
the layouts the trainer places its tensors in and the dry-run counts
per-rank bytes from. The rules are the reference's (`repro.dist.specs`),
Megatron-style TP + plain DP:

  * params replicate over the DP axes; over "model" they shard
    column-parallel (q/k/v/gate/up/fc1/lm_head/router: last axis),
    row-parallel (o/down/fc2: second-to-last), vocab-parallel (the
    embedding table), and expert-parallel (stacked MoE expert weights
    shard their expert axis);
  * batches shard their leading axis over the composed DP axes;
  * KV/SSM caches shard their batch axis (axis 1 behind the reference's
    layer-stack axis; axis 0 of the port's per-layer caches with
    `stacked=False`).

Every rule is divisibility-gated: a leaf that does not divide evenly is
replicated, so any mesh is valid. A tree is nested dicts, lists, tuples and
dataclasses; a leaf is anything with a `.shape` (a tensor, a `meta`
tensor, a numpy array); its path names are the dict keys and dataclass
field names on the way to it (list positions are not names), as the
reference reads a pytree path. `param_tree(model)` gives a port model's
parameters in the reference's layout, and `shard_params` cuts each
parameter to this rank's shard by those placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Sequence

import torch

from .sharding import (DP_AXES, Placements, axis_rank, axis_size,
                       spec_placements)

__all__ = ["param_specs", "opt_state_specs", "batch_specs", "cache_specs",
           "param_tree", "shard_params", "init_sharded", "local_shape",
           "local_bytes",
           "ParamRef", "Placements"]

# Leaf-name classes for the Megatron placement of 2D weights.
_COL_PARALLEL = {"q", "k", "v", "gate", "up", "fc1", "lm_head", "router"}
_ROW_PARALLEL = {"o", "down", "fc2"}
_EXPERT_STACKED = {"gate", "up", "down"}          # raw arrays under a "moe"


def _map(fn: Callable, tree, names=()):
    """tree's structure with each leaf x replaced by fn(names, x); None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Placements):
        return type(tree)(_map(fn, v, names) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and not isinstance(tree, ParamRef):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), names + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(names, tree)


def _leaves(tree) -> list:
    out = []
    _map(lambda _n, x: out.append(x), tree)
    return out


def _placements(entries: Sequence, mesh) -> Placements:
    return spec_placements(entries, mesh.mesh_dim_names)


def _dp(mesh):
    axes = tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)
    return axes, math.prod(axis_size(a, mesh) for a in axes)


def param_specs(tree: Any, mesh) -> Any:
    """Param layout: DP-replicated, model-axis TP/EP where divisible."""
    msize = axis_size("model", mesh)

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        entries = [None] * ndim
        if msize > 1 and ndim >= 2 and (not names or names[-1] != "b"):
            if ("moe" in names and names[-1] in _EXPERT_STACKED
                    and ndim >= 3 and shape[-3] % msize == 0):
                entries[-3] = "model"             # expert axis of (E, din, dout)
            elif any(n in _COL_PARALLEL for n in names) \
                    and shape[-1] % msize == 0:
                entries[-1] = "model"
            elif any(n in _ROW_PARALLEL for n in names) \
                    and shape[-2] % msize == 0:
                entries[-2] = "model"
            elif ("embed" in names or "table" in names) \
                    and shape[-2] % msize == 0:
                entries[-2] = "model"             # vocab-parallel embedding
        return _placements(entries, mesh)

    return _map(spec, tree)


def opt_state_specs(opt: Any, mesh) -> Any:
    """Optimizer-state layout: moments and master mirror the param layout
    (`opt.mu` etc. trees keyed like the params); everything else, and an
    optimizer state of another kind, replicated."""
    fields = {f.name for f in dataclasses.fields(opt)} \
        if dataclasses.is_dataclass(opt) else set(getattr(opt, "_fields", ()))
    rep = _placements((), mesh)
    if {"mu", "nu", "master", "step"} <= fields:
        return dataclasses.replace(
            opt, step=rep, mu=param_specs(opt.mu, mesh),
            nu=param_specs(opt.nu, mesh),
            master=param_specs(opt.master, mesh))
    return _map(lambda _n, _x: rep, opt)


def batch_specs(tree: Any, mesh) -> Any:
    """Batch layout: leading axis over the composed DP axes where
    divisible."""
    dp_axes, dp_size = _dp(mesh)

    def spec(_names, leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and dp_size > 1 and shape[0] % dp_size == 0:
            return _placements((dp_axes,) + (None,) * (len(shape) - 1),
                               mesh)
        return _placements((), mesh)

    return _map(spec, tree)


def cache_specs(tree: Any, mesh, *, stacked: bool = True) -> Any:
    """Decode-cache layout: the batch axis over the DP axes, per-layer
    scalars (pos) replicated. stacked=True reads the reference's layout
    (every leaf stacked over the layers: batch on axis 1 of a leaf of 3
    dims or more); stacked=False the port's per-layer caches (batch on
    axis 0 of a leaf of 2 dims or more)."""
    dp_axes, dp_size = _dp(mesh)
    axis, min_ndim = (1, 3) if stacked else (0, 2)

    def spec(_names, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if len(shape) >= min_ndim and dp_size > 1 \
                and shape[axis] % dp_size == 0:
            entries[axis] = dp_axes
        return _placements(entries, mesh)

    return _map(spec, tree)


def local_shape(shape: Sequence[int], placements, mesh) -> tuple:
    """The per-rank shape of a leaf of `shape` under `placements`."""
    out = list(shape)
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if hasattr(pl, "dim"):
            out[pl.dim] //= axis_size(name, mesh)
    return tuple(out)


def local_bytes(tree: Any, specs: Any, mesh, dtype=None) -> int:
    """Per-rank bytes of a tree under its placements (each leaf's own
    dtype, or `dtype` for leaves without one)."""
    total = 0
    for leaf, pl in zip(_leaves(tree), _leaves(specs)):
        dt = getattr(leaf, "dtype", dtype)
        size = torch.empty((), dtype=dt).element_size()
        total += math.prod(local_shape(leaf.shape, pl, mesh)) * size
    return total


@dataclasses.dataclass
class ParamRef:
    """A leaf of `param_tree`: the port parameters the reference stacks
    into one leaf (one per layer of a segment's unit kind, or one), each
    with its module and attribute name, and the stacked shape."""
    params: List[tuple]          # (module, attribute name, parameter)
    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def param_tree(model) -> dict:
    """The model's parameters in the reference's param pytree layout (the
    bridge's), each leaf a `ParamRef` of the stacked shape."""
    from ..bridge import _to_jax_layout

    def leaf(mod, name, p):
        return ParamRef([(mod, name, p)], tuple(p.shape))

    def stack(refs):
        return ParamRef([x for r in refs for x in r.params],
                        (len(refs),) + refs[0].shape)

    return _to_jax_layout(model, leaf, stack=stack)


def _shard_plan(model, mesh) -> tuple:
    """(specs, cuts) of `param_specs` over the model's reference layout:
    cuts lists (module, attribute, parameter, dim, axis, ranks, rank) for
    every parameter that has a shard on some mesh axis (the first such
    axis; a module's attribute once: zamba2's shared block sits at several
    positions), dim negative, counted from the last axis, as the stacked
    leaf's placement reads it."""
    tree = param_tree(model)
    specs = param_specs(tree, mesh)
    cuts, seen = [], set()
    for ref, pl in zip(_leaves(tree), _leaves(specs)):
        for name, placement in zip(mesh.mesh_dim_names, pl):
            if not hasattr(placement, "dim"):
                continue
            n = axis_size(name, mesh)
            r = axis_rank(name, mesh)
            dim = placement.dim - ref.ndim            # negative
            for mod, attr, p in ref.params:
                if (id(mod), attr) not in seen:
                    seen.add((id(mod), attr))
                    cuts.append((mod, attr, p, dim, name, n, r))
    return specs, cuts


def _mark(mod, attr: str, dim: int, axis: str, n: int) -> None:
    if getattr(mod, "shards", None) is None:
        mod.shards = {}
    mod.shards[attr] = (dim, axis, n)


@torch.no_grad()
def shard_params(model, mesh) -> Any:
    """Cut each parameter of a full port model to this rank's shard, in
    place (`p.data` becomes the rank's slice; the Parameter objects stay),
    by `param_specs` of the reference layout. Each module that holds a
    sharded parameter records it in `module.shards[name] = (dim, axis,
    ranks)` (dim negative, counted from the last axis, as the stacked
    leaf's placement reads it), which its forward reads. Returns the specs
    tree. A model with resident codes is refused."""
    from ..models.transformer import resident_format
    if resident_format(model) is not None:
        raise ValueError(f"{model.cfg.name}: resident codes cannot be "
                         "sharded; shard the dense model")
    specs, cuts = _shard_plan(model, mesh)
    for mod, attr, p, dim, axis, n, r in cuts:
        if attr in (getattr(mod, "shards", None) or {}):
            continue                                  # already cut
        p.data = p.data.chunk(n, dim=dim)[r].clone()
        _mark(mod, attr, dim, axis, n)
    return specs


@torch.no_grad()
def init_sharded(cfg, mesh, *, seed: int = 0, device="cuda",
                 dtype=torch.float32):
    """`shard_params(init_params(cfg, seed=, device=, dtype=), mesh)`,
    bitwise, without ever holding the whole model: the model is laid out
    on `meta` first (its cuts), then built from the seeded generator with
    each weight cut to this rank's shard as soon as it is drawn, so the
    device holds at most one whole weight beside the shards (olmoe-1b-7b
    is 27.6 GB in f32; one rank of a (1, 2) mesh keeps about half). A
    sharded parameter that `layers._normal` does not draw raises
    ValueError before the build."""
    from .. import resolve_device
    from ..models import layers
    from ..models.transformer import Transformer
    drawn = []

    def record(p):
        drawn.append(p)
        return p
    layers._DRAW_HOOKS.append(record)
    try:
        meta = Transformer(cfg, device="meta", dtype=dtype)
    finally:
        layers._DRAW_HOOKS.pop()
    _, cuts = _shard_plan(meta, mesh)
    drawn_ids = {id(p) for p in drawn}
    for mod, attr, p, *_ in cuts:
        if id(p) not in drawn_ids:
            raise ValueError(f"{cfg.name}: {type(mod).__name__}.{attr} is "
                             "sharded but not drawn by layers._normal")
    by_param = {id(p): (dim, n, r) for _, _, p, dim, _, n, r in cuts}
    plan = iter([by_param.get(id(p)) for p in drawn])

    def cut(p):
        c = next(plan)
        if c is None:
            return p
        dim, n, r = c
        return torch.nn.Parameter(p.data.chunk(n, dim=dim)[r].clone(),
                                  requires_grad=False)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers._DRAW_HOOKS.append(cut)
    try:
        model = Transformer(cfg, gen=gen, device=dev, dtype=dtype)
    finally:
        layers._DRAW_HOOKS.pop()
    real = dict(model.named_modules())
    twin = {id(m): real[name] for name, m in meta.named_modules()}
    for mod, attr, _, dim, axis, n, _ in cuts:
        _mark(twin[id(mod)], attr, dim, axis, n)
    return model
