"""Gradients of a model-parallel model: which weights are shards, the sum
that completes a replicated weight's gradient, and the global norm.

The collectives' backward passes are exact adjoints (`dist.collectives`),
so with every rank's loss seeded by 1 / (the mesh's size), a sharded
weight's gradient is complete on its rank once summed over the DP axes,
and a replicated weight's once summed over the DP axes and "model": the
sum is the reference's implicit GSPMD psum, and with the seed it is the
mean over the DP shards.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .collectives import all_reduce
from .sharding import ctx_dp_axes

__all__ = ["param_shards", "sum_grads", "global_grad_norm"]


def param_shards(model: torch.nn.Module) -> Dict[int, Tuple[int, str, int]]:
    """{id(parameter): (dim, axis, ranks)} of the parameters
    `dist.shard_params` cut to a shard (from each module's `shards`)."""
    out = {}
    for mod in model.modules():
        for name, s in (getattr(mod, "shards", None) or {}).items():
            p = getattr(mod, name)
            out[id(p)] = s
    return out


@torch.no_grad()
def sum_grads(model: torch.nn.Module, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], *, dp: bool = True
              ) -> List[torch.Tensor]:
    """Each gradient summed over the axes its parameter is replicated on:
    "model" unless the parameter is a shard of it, and (dp=True) the DP
    axes of the ambient mesh."""
    shards = param_shards(model)
    dp_axes = ctx_dp_axes() if dp else ()
    out = []
    for p, g in zip(params, grads):
        axes = dp_axes if id(p) in shards else dp_axes + ("model",)
        out.append(all_reduce(g, axes, site="grad") if axes else g)
    return out


@torch.no_grad()
def global_grad_norm(model: torch.nn.Module, params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of the whole gradient: a shard's squares
    summed over its axis, a replicated gradient's counted once."""
    shards = param_shards(model)
    dev = grads[0].device
    rep = torch.zeros((), dtype=torch.float32, device=dev)
    part = torch.zeros((), dtype=torch.float32, device=dev)
    for p, g in zip(params, grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        if id(p) in shards:
            part = part + sq
        else:
            rep = rep + sq
    return torch.sqrt(rep + all_reduce(part, "model", site="grad_norm"))
