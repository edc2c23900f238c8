"""Step functions: train, prefill and serve (decode).

`make_train_step(cfg, ...)` is the reference's train step: `loss_fn` with
its aux, the backward, the cosine learning rate at the step count BEFORE
the update, and `adamw_update` in place. Its forward runs under autograd,
so its attention takes the differentiable `ref` route
(`api.ops.attention_route(grad=True)`): the CUDA kernels are forward-only
and refuse inputs that require grad. `make_prefill_step(cfg)` is the
batched greedy prefill: one full-sequence forward under `torch.no_grad()`,
whose 128-aligned attention runs the full-sequence flash kernel.
`make_serve_step(cfg)` is one greedy `decode_step` for the whole batch,
on the flash-decode kernel.

`make_train_step(cfg, mesh=)` trains model-parallel and data-parallel: it
takes the GLOBAL batch, runs the model on this rank's DP rows under the
mesh, seeds the backward with 1 / (the mesh's size), sums each gradient
over the axes its parameter is replicated on (`dist.grads.sum_grads`: the
mean over the DP shards) and clips by the global norm of the whole
gradient.

The shape stand-ins `params_shapes`, `opt_shapes`, `cache_shapes` and
`input_specs` are the reference's `jax.eval_shape` products as `meta`
tensors: the trees the dry-run places and counts, with nothing allocated.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..dist.collectives import all_reduce
from ..dist.grads import global_grad_norm, sum_grads
from ..dist.sharding import ctx_dp_axes, dp_rank, dp_size, set_mesh
from ..models import transformer as T
from ..optim import AdamWState, adamw_update, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "dp_slice", "input_specs", "params_shapes", "opt_shapes",
           "cache_shapes"]


def _check_model(cfg: T.ModelConfig, model: T.Transformer) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was made for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def dp_slice(batch: Dict[str, torch.Tensor], mesh, *,
             replicate: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the leading axis cut into the
    mesh's DP size, in DP-rank order. A batch that does not divide is
    refused (the reference's B % dp), or with replicate=True kept whole on
    every rank (the reference's `batch_specs` replicate it)."""
    n, r = dp_size(mesh), dp_rank(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            if replicate:
                out[k] = v
                continue
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of the {n} data-parallel ranks")
        out[k] = v.chunk(n, dim=0)[r] if n > 1 else v
    return out


def _dp_mean(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the ambient mesh's DP axes."""
    axes = ctx_dp_axes()
    return all_reduce(x.detach(), axes, site="metrics") / dp_size()


def make_train_step(cfg: T.ModelConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000,
                    mesh=None) -> Callable:
    """A step (model, opt_state, batch) -> metrics that trains `model` in
    place. The model's parameters must require grad
    (`Transformer.trainable_`), in the order of `model.parameters()` that
    `optim.adamw_init` was given; batch holds tensors on the model's
    device ("tokens", "labels", and "frames" / "patch_embeds" for the
    frontend families). metrics: "loss", "aux", "grad_norm" and "lr", 0-d
    tensors on the device (the step reads nothing back to the host). Each
    parameter's `.grad` holds this step's gradient afterwards (this rank's
    part of it, before the sum, under a mesh).

    mesh: the model's parameters are this rank's shards
    (`dist.shard_params` over the same mesh) and the batch is the global
    one; "loss" and "aux" are averaged over the DP shards."""
    def train_step(model: T.Transformer, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _check_model(cfg, model)
        params: List[torch.Tensor] = list(model.parameters())
        if not all(p.requires_grad for p in params):
            raise ValueError(f"{cfg.name}: parameters without grad; call "
                             "model.trainable_() before training")
        for p in params:
            p.grad = None
        with set_mesh(mesh) if mesh is not None else nullcontext():
            if mesh is not None:
                batch = dp_slice(batch, mesh)
            with torch.enable_grad():
                total_loss, metrics = T.loss_fn(model, batch)
                seed = 1.0 if mesh is None else 1.0 / mesh.size()
                (total_loss * seed if mesh is not None
                 else total_loss).backward()
            lr = cosine_schedule(opt_state.step, base_lr=base_lr,
                                 warmup=warmup, total=total)
            # a parameter the loss does not reach has a zero gradient
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            gnorm = None
            loss, aux = metrics["loss"].detach(), metrics["aux"].detach()
            if mesh is not None:
                grads = sum_grads(model, params, grads)
                gnorm = global_grad_norm(model, params, grads)
                loss, aux = _dp_mean(loss), _dp_mean(aux)
            _, _, gnorm = adamw_update(grads, opt_state, params, lr=lr,
                                       grad_norm=gnorm)
        return {"loss": loss, "aux": aux, "grad_norm": gnorm, "lr": lr}
    return train_step


def make_prefill_step(cfg: T.ModelConfig) -> Callable:
    """A step (model, batch) -> next-token ids (B,) (greedy: the argmax of
    the last position's logits); batch["tokens"] is (B, L), and the
    optional batch["patch_embeds"] and batch["frames"] go to `forward` as
    its prefix_embeds and frames."""
    @torch.no_grad()
    def prefill_step(model: T.Transformer,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _check_model(cfg, model)
        logits, _ = T.forward(model, batch["tokens"],
                              prefix_embeds=batch.get("patch_embeds"),
                              frames=batch.get("frames"))
        return torch.argmax(logits[:, -1], dim=-1)
    return prefill_step


def make_serve_step(cfg: T.ModelConfig) -> Callable:
    """A step (model, caches, token (B, 1), memory=None) -> (next tokens
    (B, 1), caches): one greedy `decode_step` for the whole batch against
    its caches (updated in place); memory is the audio family's encoder
    output."""
    def serve_step(model: T.Transformer, caches: List,
                   token: torch.Tensor, memory: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, List]:
        _check_model(cfg, model)
        logits, caches = T.decode_step(model, caches, token, memory=memory)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], caches
    return serve_step


# =============================================================================
# Shape stand-ins (no allocation)
# =============================================================================

def params_shapes(cfg: T.ModelConfig, dtype=torch.bfloat16) -> T.Transformer:
    """The model on the `meta` device in `dtype`: every parameter's shape
    and dtype, nothing allocated (`dist.specs.param_tree` gives it in the
    reference's layout)."""
    return T.Transformer(cfg, device="meta", dtype=dtype)


def opt_shapes(cfg: T.ModelConfig, dtype=torch.bfloat16) -> AdamWState:
    """The AdamW state of `params_shapes` on `meta`: step, and f32
    moments and master trees in the reference's param layout."""
    from ..dist.specs import param_tree
    tree = param_tree(params_shapes(cfg, dtype))

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [f32(v) for v in t]
        return torch.empty(t.shape, dtype=torch.float32, device="meta")

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=f32(tree), nu=f32(tree), master=f32(tree))


def cache_shapes(cfg: T.ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, model=None) -> List:
    """The per-layer decode caches (`init_caches`) on `meta`; with
    `model=` each layer holds the KV heads the model computes on this
    rank."""
    return T.init_caches(cfg, batch, max_len, device="meta", dtype=dtype,
                         model=model)


def input_specs(cfg: T.ModelConfig, cell) -> Dict[str, Any]:
    """Model inputs for one shape cell (`kind`, `batch`, `seq`) as `meta`
    tensors, the reference's rule: train/prefill {tokens, labels (train),
    patch_embeds (vlm: the text shrinks by frontend_len so the stream is
    seq long) / frames (audio)}; decode {token, memory (audio)}."""
    b, l = cell.batch, cell.seq

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        l_text = l
        specs: Dict[str, Any] = {}
        if cfg.family == "vlm":
            l_text = l - cfg.frontend_len
            specs["patch_embeds"] = meta((b, cfg.frontend_len, cfg.d_model),
                                         torch.float32)
        if cfg.family == "audio":
            specs["frames"] = meta((b, cfg.frontend_len, cfg.d_model),
                                   torch.float32)
        specs["tokens"] = meta((b, l_text), torch.int32)
        if cell.kind == "train":
            specs["labels"] = meta((b, l_text), torch.int32)
        return specs
    specs = {"token": meta((b, 1), torch.int32)}
    if cfg.family == "audio":
        specs["memory"] = meta((b, cfg.frontend_len, cfg.d_model),
                               torch.float32)
    return specs
