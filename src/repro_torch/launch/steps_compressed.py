"""Train step with AIO-compressed data-parallel gradient all-reduce.

The paper's format plane applied to communication: the DP gradient sync
runs in int8 (or fp8) with a shared power-of-two scale (bias-foldable on
the paper's hardware) and local error feedback. The reference's
`make_compressed_train_step`, on the port's in-place step.

Mechanics: each DP rank takes loss and gradients on its slice of the
global batch inside the compressed step's DP region (`dist.dp_region`:
the manual TP block and the expert-parallel MoE stand aside there, as the
reference's do inside its manual shard_map region; a "model" axis still
shards the weights, and a replicated weight's gradient is summed over it),
the metrics averaged over DP. The explicit compressed all-reduce then
syncs the gradients at 1/4 the wire bytes of f32, the residual kept for
the next step (EF-SGD), and AdamW updates with the cosine schedule.

The reference compresses each leaf of its param pytree with one shared
scale, and a leaf stacks a segment's layers; so the sync here takes the
port's parameters in the same groups (`dist.specs.param_tree`: each
group's gradients flattened into one tensor, one scale, one exchange,
through `optim.grad_compress.compressed_grad_allreduce`), which makes it
the reference's sync value for value.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..core import formats as F
from ..dist.collectives import all_reduce
from ..dist.grads import global_grad_norm, sum_grads
from ..dist.sharding import ctx_dp_axes, dp_region, dp_size, set_mesh
from ..dist.specs import _leaves, param_tree
from ..models import transformer as T
from ..optim import AdamWState, adamw_update, cosine_schedule
from ..optim.grad_compress import compressed_grad_allreduce
from .steps import _check_model, dp_slice

__all__ = ["make_compressed_train_step"]


def make_compressed_train_step(cfg: T.ModelConfig, mesh, *,
                               fmt_name: str = "int8", base_lr: float = 3e-4,
                               warmup: int = 100, total: int = 10_000
                               ) -> Callable:
    """A step (model, opt_state, err, batch) -> metrics that trains
    `model` in place on the GLOBAL batch; err (one f32 residual per
    parameter, `optim.grad_compress.init_error_state`) is updated in place.
    metrics: "loss" and "aux" (DP means), "grad_norm", "lr"."""
    if fmt_name not in F.REGISTRY:
        raise KeyError(f"unknown format {fmt_name!r}")

    def groups(model) -> List[List[int]]:
        """Indices into model.parameters() of each reference leaf's
        parameters."""
        index = {id(p): i for i, p in enumerate(model.parameters())}
        return [[index[id(p)] for _, _, p in ref.params]
                for ref in _leaves(param_tree(model))]

    def train_step(model: T.Transformer, opt_state: AdamWState,
                   err: List[torch.Tensor],
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _check_model(cfg, model)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        with set_mesh(mesh):
            dp = ctx_dp_axes()
            world = dp_size()
            model_ranks = mesh.size() // world
            local = dp_slice(batch, mesh)
            with dp_region(), torch.enable_grad():
                total_loss, metrics = T.loss_fn(model, local)
                (total_loss / model_ranks if model_ranks > 1
                 else total_loss).backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            # complete a model-replicated weight's gradient; DP stays local
            grads = sum_grads(model, params, grads, dp=False)
            loss = all_reduce(metrics["loss"].detach(), dp,
                              site="metrics") / world
            aux = all_reduce(metrics["aux"].detach(), dp,
                             site="metrics") / world
            synced = [None] * len(grads)
            with torch.no_grad():
                for idx in groups(model):   # one group in memory at a time
                    (mean,), (resid,) = compressed_grad_allreduce(
                        [torch.cat([grads[i].to(torch.float32).reshape(-1)
                                    for i in idx])],
                        [torch.cat([err[i].reshape(-1) for i in idx])],
                        mesh, fmt_name=fmt_name, dp_axis=dp)
                    at = 0
                    for i in idx:
                        n = grads[i].numel()
                        synced[i] = mean[at:at + n].view_as(grads[i]).to(
                            grads[i].dtype)
                        err[i].copy_(resid[at:at + n].view_as(err[i]))
                        at += n
            lr = cosine_schedule(opt_state.step, base_lr=base_lr,
                                 warmup=warmup, total=total)
            gnorm = global_grad_norm(model, params, synced) \
                if model_ranks > 1 else None
            _, _, gnorm = adamw_update(synced, opt_state, params, lr=lr,
                                       grad_norm=gnorm)
        return {"loss": loss, "aux": aux, "grad_norm": gnorm, "lr": lr}

    return train_step
