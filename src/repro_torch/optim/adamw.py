"""AdamW with an f32 master copy of the (possibly bf16) params: the
reference's `repro.optim.adamw` on lists of tensors.

The state mirrors the param list: f32 first and second moments and the
f32 master weights, one tensor per parameter, and the step count as a 0-d
int32 tensor on the params' device. `adamw_update` updates params and state
IN PLACE, under `torch.no_grad()`, with the reference's arithmetic: the
global norm taken before the clip, the clip factor cast to each gradient's
dtype, f32 moments, bias corrections 1 - b^step in f32, weight decay on
every parameter (of the master), and the params set to the master cast to
their dtype. Nothing reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor           # 0-d int32: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    master: List[torch.Tensor]   # f32 master copy of the params


@torch.no_grad()
def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    """Zero moments, step 0 and an f32 master copy (a new tensor even for
    f32 params) of `params`, on their device."""
    params = list(params)
    if not params:
        raise ValueError("adamw_init needs at least one parameter")
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params],
        nu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params],
        master=[p.detach().to(torch.float32, copy=True) for p in params])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32 (0-d)."""
    total = 0
    for x in tensors:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(tensors scaled by min(1, max_norm / norm), the norm before)."""
    norm = global_norm(tensors)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [x * factor.to(x.dtype) for x in tensors], norm


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: AdamWState,
                 params: Sequence[torch.Tensor], *,
                 lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1,
                 clip: Optional[float] = 1.0,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step on `params` and `state`, in place. Returns (params,
    state, the gradients' global norm before clipping). lr: a scalar or a
    0-d tensor (a schedule value computed outside). grad_norm: the global
    norm when the gradients are shards of it (`dist.grads.global_grad_norm`
    over a model-parallel mesh); by default the norm of `grads`."""
    grads, params = list(grads), list(params)
    if not len(grads) == len(params) == len(state.master):
        raise ValueError(f"{len(grads)} gradients, {len(params)} params, "
                         f"{len(state.master)} state entries")
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    if clip is not None:
        factor = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [g * factor.to(g.dtype) for g in grads]
    state.step.add_(1)
    step = state.step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=step.device), step)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=step.device), step)
    for g, mu, nu, m, p in zip(grads, state.mu, state.nu, state.master,
                               params):
        g = g.to(torch.float32)
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * m
        m.sub_(lr * upd)
        p.copy_(m)                     # the master cast to p's dtype
    return params, state, gnorm


def cosine_schedule(step: Union[int, torch.Tensor], *, base_lr: float,
                    warmup: int, total: int, min_frac: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup from 0 over `warmup` steps, then a cosine from base_lr
    down to min_frac * base_lr at `total` (f32, on step's device). Step 0
    gives 0: a first update at the pre-increment step changes nothing."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
