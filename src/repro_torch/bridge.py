"""Build the port's model and caches from the JAX package's pytrees.

The JAX package stacks each segment's layer params along a leading
`n_layers` axis for `lax.scan` (``params["segments"][0]["0_dense"]`` holds
(n_layers, ...) leaves); the port keeps one `DenseBlock` per layer. These
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


def _dense_stack(np_params, cfg: ModelConfig) -> dict:
    segs = np_params["segments"]
    if len(segs) != 1 or list(segs[0]) != ["0_dense"]:
        raise NotImplementedError(
            f"{cfg.name}: only the single dense segment is ported "
            f"(got {[list(s) for s in segs]})")
    return segs[0]["0_dense"]


@torch.no_grad()
def params_from_jax(np_params, cfg: ModelConfig,
                    device="cuda") -> Transformer:
    """A Transformer on `device` holding exactly the weights of a JAX
    param pytree (dense or resident Linear weights)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    stack = _dense_stack(np_params, cfg)

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

    put(model.embed.table, np_params["embed"]["table"])
    put(model.final_norm.g, np_params["final_norm"]["g"])
    if model.lm_head is not None:
        put(model.lm_head.w, np_params["lm_head"]["w"])
    for i, block in enumerate(model.layers):
        put(block.ln1.g, stack["ln1"]["g"][i])
        put(block.ln2.g, stack["ln2"]["g"][i])
        if block.pn1 is not None:
            put(block.pn1.g, stack["pn1"]["g"][i])
            put(block.pn2.g, stack["pn2"]["g"][i])
        for name in ("q", "k", "v", "o"):
            linear(getattr(block.attn, name), stack["attn"][name], i)
        for name in ("gate", "up", "down"):
            linear(getattr(block.mlp, name), stack["mlp"][name], i)
    return model


def caches_from_jax(np_caches, cfg: ModelConfig, device="cuda") -> List:
    """Per-layer KVCache / QuantKVCache / PagedKVCache / PagedQuantKVCache
    copies of the JAX engine's stacked cache pytree (segment list of
    {"0_dense": stacked cache}), on `device`. The layers of a paged cache
    share one table tensor, as `init_caches` builds them (the JAX layers'
    tables are equal)."""
    device = resolve_device(device)
    if len(np_caches) != 1 or list(np_caches[0]) != ["0_dense"]:
        raise NotImplementedError("only the single dense segment is ported")
    c = np_caches[0]["0_dense"]
    fields = c._asdict()
    if "table" not in fields:
        kind = QuantKVCache if "k_codes" in fields else KVCache
        return [kind(**{f: to_torch(a[i], device) for f, a in fields.items()})
                for i in range(cfg.n_layers)]
    tables = np.asarray(fields.pop("table"))
    if any(not np.array_equal(t, tables[0]) for t in tables):
        raise ValueError("the JAX paged layers' block tables differ")
    table = to_torch(tables[0], device)
    pos = fields.pop("pos")
    return [paged_kv_cache(table, to_torch(pos[i], device),
                           **{f: to_torch(a[i], device)
                              for f, a in fields.items()})
            for i in range(cfg.n_layers)]
