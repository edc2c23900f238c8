"""Build the port's model and caches from the JAX package's pytrees.

The JAX package stacks each segment's layer params along a leading axis
for `lax.scan`: segment s repeats a unit of block kinds n times, and
``params["segments"][s][f"{j}_{kind}"]`` holds the (n, ...) leaves of the
unit's j-th kind (gemma2: ``0_dense_local`` and ``1_dense_global``, layers
2i and 2i + 1; kimi-k2: ``0_dense`` x 1, then ``0_moe``). The port keeps
one `DenseBlock` per layer, in layer order (`ModelConfig.segments`). These
functions take the JAX pytrees with every leaf already converted to numpy
(``jax.tree.map(np.asarray, tree)``) — so this module imports no JAX — and
unstack them into the port's layout, keeping the tied embedding tied. A
resident weight (the reference's `QuantWeight`, stacked (n_layers, K', N)
codes and (n_layers, 1, N) scales) becomes the port's resident Linear with
the same codes, so both packages compute with identical codes. A paged
cache (stacked (n_layers, P, ...) pools and (n_layers, B, nblk) tables)
becomes the port's per-layer paged caches over one shared table.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import resolve_device
from .core.formats import QuantWeight
from .models.attention import KVCache, QuantKVCache, paged_kv_cache
from .models.transformer import ModelConfig, Transformer

__all__ = ["params_from_jax", "caches_from_jax", "to_torch"]


def to_torch(a, device="cuda") -> torch.Tensor:
    """A numpy array as a torch tensor on `device` (bfloat16 arrays bit
    for bit)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _layer_leaves(np_segments, cfg: ModelConfig) -> list:
    """[(stacked leaves, index)] of each layer, in layer order: the JAX
    package's segment list (params or caches) walked by `cfg.segments()`."""
    segs = cfg.segments()
    if len(np_segments) != len(segs):
        raise ValueError(f"{cfg.name}: {len(np_segments)} segments, the "
                         f"config has {len(segs)}")
    out = []
    for (unit, n), seg in zip(segs, np_segments):
        keys = [f"{j}_{kind}" for j, kind in enumerate(unit)]
        if sorted(seg) != sorted(keys):
            raise ValueError(f"{cfg.name}: segment keys {sorted(seg)}, the "
                             f"config's unit gives {keys}")
        out += [(seg[key], i) for i in range(n) for key in keys]
    return out


@torch.no_grad()
def params_from_jax(np_params, cfg: ModelConfig,
                    device="cuda") -> Transformer:
    """A Transformer on `device` holding exactly the weights of a JAX
    param pytree (dense or resident Linear weights)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    layers = _layer_leaves(np_params["segments"], cfg)

    def put(param: torch.Tensor, value):
        t = to_torch(value, device)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"{tuple(param.shape)}")
        param.copy_(t)

    def linear(mod, p, i):
        w = p["w"]
        if hasattr(w, "codes"):           # a resident QuantWeight leaf
            mod.set_resident(QuantWeight(to_torch(w.codes[i], device),
                                         to_torch(w.scale[i], device),
                                         w.fmt, w.k))
        else:
            put(mod.w, w[i])
        if mod.b is not None:
            put(mod.b, p["b"][i])

    def norm(mod, p, i=None):
        for name in ("g", "b"):           # none for the non-parametric LN
            if hasattr(mod, name):
                put(getattr(mod, name), p[name] if i is None else p[name][i])

    def mlp(mod, p, i):
        for name in ("gate", "up", "down", "fc1", "fc2"):
            if hasattr(mod, name):
                linear(getattr(mod, name), p[name], i)

    put(model.embed.table, np_params["embed"]["table"])
    norm(model.final_norm, np_params["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head.w, np_params["lm_head"]["w"])
    if model.pos is not None:
        put(model.pos, np_params["pos"])
    for block, (p, i) in zip(model.layers, layers):
        for name in ("ln1", "ln2", "pn1", "pn2"):
            if getattr(block, name) is not None:
                norm(getattr(block, name), p[name], i)
        for name in ("q", "k", "v", "o"):
            linear(getattr(block.attn, name), p["attn"][name], i)
        if block.moe is not None:
            moe = block.moe
            linear(moe.router, p["moe"]["router"], i)
            for name in ("gate", "up", "down"):
                put(getattr(moe, name), p["moe"][name][i])
            if moe.shared is not None:
                mlp(moe.shared, p["moe"]["shared"], i)
        else:
            mlp(block.mlp, p["mlp"], i)
    return model


def caches_from_jax(np_caches, cfg: ModelConfig, device="cuda") -> List:
    """Per-layer KVCache / QuantKVCache / PagedKVCache / PagedQuantKVCache
    copies of the JAX engine's stacked cache pytree (a segment list of
    {f"{j}_{kind}": stacked cache}, walked in layer order), on `device`.
    The layers of a paged cache share one table tensor, as `init_caches`
    builds them (the JAX layers' tables are equal)."""
    device = resolve_device(device)
    layers = [(c._asdict(), i) for c, i in _layer_leaves(np_caches, cfg)]
    if "table" not in layers[0][0]:
        kind = QuantKVCache if "k_codes" in layers[0][0] else KVCache
        return [kind(**{f: to_torch(a[i], device) for f, a in c.items()})
                for c, i in layers]
    tables = [np.asarray(c["table"][i]) for c, i in layers]
    if any(not np.array_equal(t, tables[0]) for t in tables):
        raise ValueError("the JAX paged layers' block tables differ")
    table = to_torch(tables[0], device)
    return [paged_kv_cache(table, to_torch(c["pos"][i], device),
                           **{f: to_torch(a[i], device) for f, a in c.items()
                              if f not in ("table", "pos")})
            for c, i in layers]
