"""Build the port's model and caches from the JAX package's pytrees.

The JAX package stacks each segment's layer params along a leading axis
for `lax.scan`: segment s repeats a unit of block kinds n times, and
``params["segments"][s][f"{j}_{kind}"]`` holds the (n, ...) leaves of the
unit's j-th kind (gemma2: ``0_dense_local`` and ``1_dense_global``, layers
2i and 2i + 1; kimi-k2: ``0_dense`` x 1, then ``0_moe``; zamba2: ``0_mamba``
.. ``4_mamba`` and ``5_shared_attn``, whose params are NOT stacked — one
weight copy for every invocation — while its caches are, one KV cache an
invocation). The port keeps one block per layer, in layer order
(`ModelConfig.segments`; zamba2's shared block is one module at each of
its positions). The audio family's encoder params (``params["encoder"]``,
stacked (encoder_layers, ...)) become the `encoder` ModuleList, each
decoder layer's ``xattn`` and ``lnx`` its CrossAttention and norm. These
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
from .models import ssm
from .models.attention import KVCache, QuantKVCache, paged_kv_cache
from .models.transformer import (RECURRENT_KINDS, ModelConfig, Transformer,
                                 resident_format)

__all__ = ["params_from_jax", "params_to_jax", "grads_to_jax",
           "caches_from_jax", "mixer_from_jax", "to_torch", "to_numpy"]


def to_torch(a, device="cuda") -> torch.Tensor:
    """A numpy array as a torch tensor on `device` (bfloat16 arrays bit
    for bit)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _layer_leaves(np_segments, cfg: ModelConfig, *,
                  shared_stacked: bool) -> list:
    """[(stacked leaves, index)] of each layer, in layer order: the JAX
    package's segment list (params or caches) walked by `cfg.segments()`.
    A shared_attn entry's index is None when its leaves are not stacked
    (the params)."""
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
        out += [(seg[key], None if key.endswith("_shared_attn")
                 and not shared_stacked else i)
                for i in range(n) for key in keys]
    return out


def _at(a, i):
    return a if i is None else a[i]


def _put(param: torch.Tensor, value) -> None:
    t = to_torch(value, param.device)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(t)


def _linear(mod, p, i, device) -> None:
    w = p["w"]
    if hasattr(w, "codes"):               # a resident QuantWeight leaf
        mod.set_resident(QuantWeight(to_torch(_at(w.codes, i), device),
                                     to_torch(_at(w.scale, i), device),
                                     w.fmt, w.k))
    else:
        _put(mod.w, _at(w, i))
    if mod.b is not None:
        _put(mod.b, _at(p["b"], i))


def _norm(mod, p, i=None) -> None:
    for name in ("g", "b"):               # none for the non-parametric LN
        if hasattr(mod, name):
            _put(getattr(mod, name), _at(p[name], i))


@torch.no_grad()
def mixer_from_jax(mod, np_p, i=None, device="cuda") -> None:
    """Copy a recurrent mixer's JAX params (`ssm.mamba_init`, `mlstm_init`
    or `slstm_init`'s dict; with `i`, layer i of their stacked leaves) into
    the port's `ssm.Mamba2` / `MLSTM` / `SLSTM` `mod`, leaf by attribute
    name: Linears, norms and plain tensors."""
    for name, leaf in np_p.items():
        sub = getattr(mod, name)
        if isinstance(sub, torch.nn.Parameter):
            _put(sub, _at(leaf, i))
        elif "w" in leaf:
            _linear(sub, leaf, i, device)
        else:
            _norm(sub, leaf, i)


@torch.no_grad()
def params_from_jax(np_params, cfg: ModelConfig,
                    device="cuda") -> Transformer:
    """A Transformer on `device` holding exactly the weights of a JAX
    param pytree (dense or resident Linear weights)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    layers = _layer_leaves(np_params["segments"], cfg, shared_stacked=False)

    def linear(mod, p, i):
        _linear(mod, p, i, device)

    def mlp(mod, p, i):
        for name in ("gate", "up", "down", "fc1", "fc2"):
            if hasattr(mod, name):
                linear(getattr(mod, name), p[name], i)

    def attention_block(block, p, i):
        """A DenseBlock (the encoder's too) or an EncDecBlock."""
        for name in ("ln1", "lnx", "ln2", "pn1", "pn2"):
            if getattr(block, name, None) is not None:
                _norm(getattr(block, name), p[name], i)
        for att in ("attn", "xattn"):
            if hasattr(block, att):
                for name in ("q", "k", "v", "o"):
                    linear(getattr(getattr(block, att), name),
                           p[att][name], i)
        moe = getattr(block, "moe", None)
        if moe is not None:
            linear(moe.router, p["moe"]["router"], i)
            for name in ("gate", "up", "down"):
                _put(getattr(moe, name), p["moe"][name][i])
            if moe.shared is not None:
                mlp(moe.shared, p["moe"]["shared"], i)
        else:
            mlp(block.mlp, p["mlp"], i)

    _put(model.embed.table, np_params["embed"]["table"])
    _norm(model.final_norm, np_params["final_norm"])
    if model.lm_head is not None:
        _put(model.lm_head.w, np_params["lm_head"]["w"])
    if model.pos is not None:
        _put(model.pos, np_params["pos"])
    if model.encoder is not None:
        for i, block in enumerate(model.encoder):
            attention_block(block, np_params["encoder"], i)
        _norm(model.enc_norm, np_params["enc_norm"])
    done = set()
    for block, (p, i) in zip(model.layers, layers):
        if id(block) in done:             # the shared block, set once
            continue
        done.add(id(block))
        if block.kind in RECURRENT_KINDS:
            _norm(block.ln, p["ln"], i)
            mixer_from_jax(block.mixer, p[block.kind], i, device)
        else:
            attention_block(block, p, i)
    return model


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (float32 for bfloat16, which
    numpy lacks)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _module_tree(mod: torch.nn.Module, leaf) -> dict:
    """{name: leaf(module, name, parameter)} of a module's own parameters
    and {name: subtree} of its submodules (None entries skipped): a Linear
    gives {"w"} (+ "b"), a norm {"g"} (+ "b") or, non-parametric, {}, as
    the reference's param dicts."""
    out = {name: leaf(mod, name, p) for name, p in mod._parameters.items()
           if p is not None}
    for name, child in mod._modules.items():
        if child is not None:
            out[name] = _module_tree(child, leaf)
    return out


def _stack(trees: list, join=np.stack):
    """Stack equal-structured nested dicts leafwise on a new leading axis
    (each leaf's list through `join`)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], join) for k in trees[0]}
    return join(trees)


def _to_jax_layout(model: Transformer, leaf, stack=np.stack) -> dict:
    """The reference's param pytree layout of `model`, each leaf
    leaf(module, name, parameter): the top-level entries, the encoder
    stacked over its layers, and each segment's unit kinds stacked over the
    unit's repeats by `stack` (the shared block once, unstacked) -- the
    inverse of `_layer_leaves`."""
    cfg = model.cfg
    if resident_format(model) is not None:
        raise ValueError(f"{cfg.name}: resident codes are not a dense "
                         "param pytree")
    out = {"embed": _module_tree(model.embed, leaf),
           "final_norm": _module_tree(model.final_norm, leaf)}
    if model.lm_head is not None:
        out["lm_head"] = _module_tree(model.lm_head, leaf)
    if model.pos is not None:
        out["pos"] = leaf(model, "pos", model.pos)
    if model.encoder is not None:
        out["encoder"] = _stack([_module_tree(b, leaf)
                                 for b in model.encoder], stack)
        out["enc_norm"] = _module_tree(model.enc_norm, leaf)
    segments, first = [], 0
    for unit, n in cfg.segments():
        seg = {}
        for j, kind in enumerate(unit):
            blocks = [model.layers[first + i * len(unit) + j]
                      for i in range(n)]
            trees = [_module_tree(b, leaf) for b in blocks]
            if kind == "shared_attn":
                seg[f"{j}_{kind}"] = trees[0]
            else:
                seg[f"{j}_{kind}"] = _stack(trees, stack)
        segments.append(seg)
        first += n * len(unit)
    out["segments"] = segments
    return out


def params_to_jax(model: Transformer) -> dict:
    """The model's weights as the reference's param pytree of numpy
    arrays (nested dicts and the segment list): the exact inverse of
    `params_from_jax`, so params_to_jax(params_from_jax(p, cfg)) equals p
    leaf for leaf, bitwise. Every parameter of the model is a leaf of it.
    Dense models only (ValueError on resident weights)."""
    return _to_jax_layout(model, lambda _m, _n, p: to_numpy(p))


def grads_to_jax(model: Transformer) -> dict:
    """Each parameter's `.grad` in `params_to_jax`'s layout (zeros where a
    parameter has none), to compare with `jax.grad` of the reference's
    loss leaf by leaf. The shared block's gradient is the sum over its
    positions, as the reference's closed-over params give it."""
    def grad(_m, _n, p):
        return to_numpy(p.grad if p.grad is not None
                        else torch.zeros_like(p))
    return _to_jax_layout(model, grad)


# a JAX recurrent cache's type, told by its first field
_RECURRENT = {"ssm": ssm.MambaCache, "state": ssm.MLSTMCache,
              "c": ssm.SLSTMCache}


def caches_from_jax(np_caches, cfg: ModelConfig, device="cuda") -> List:
    """Per-layer KVCache / QuantKVCache / PagedKVCache / PagedQuantKVCache
    and MambaCache / MLSTMCache / SLSTMCache copies of the JAX engine's
    stacked cache pytree (a segment list of {f"{j}_{kind}": stacked
    cache}, walked in layer order; zamba2's shared block has one KV cache
    an invocation), on `device`. Recurrent states come as float32 (the
    reference's conv caches start in the cache dtype and turn float32 at
    their first step; the port keeps them float32 throughout). The layers
    of a paged cache share one table tensor, as `init_caches` builds them
    (the JAX layers' tables are equal)."""
    device = resolve_device(device)
    layers = [(c._asdict(), i) for c, i in
              _layer_leaves(np_caches, cfg, shared_stacked=True)]

    def arrays(c, i, skip=()):
        return {f: to_torch(a[i], device) for f, a in c.items()
                if f not in skip}

    kv = [(c, i) for c, i in layers if next(iter(c)) not in _RECURRENT]
    table = None
    if kv and "table" in kv[0][0]:
        tables = [np.asarray(c["table"][i]) for c, i in kv]
        if any(not np.array_equal(t, tables[0]) for t in tables):
            raise ValueError("the JAX paged layers' block tables differ")
        table = to_torch(tables[0], device)
    out = []
    for c, i in layers:
        first = next(iter(c))
        if first in _RECURRENT:
            out.append(_RECURRENT[first](**{
                f: t.to(torch.float32) for f, t in arrays(c, i).items()}))
        elif table is not None:
            out.append(paged_kv_cache(table, to_torch(c["pos"][i], device),
                                      **arrays(c, i, ("table", "pos"))))
        else:
            kind = QuantKVCache if "k_codes" in c else KVCache
            out.append(kind(**arrays(c, i)))
    return out
