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
on the flash-decode kernel. (The reference's shape stand-ins,
`input_specs`, `params_shapes`, `opt_shapes` and `cache_shapes`, belong
to the distribution layer.)
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models import transformer as T
from ..optim import AdamWState, adamw_update, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def _check_model(cfg: T.ModelConfig, model: T.Transformer) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was made for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def make_train_step(cfg: T.ModelConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000) -> Callable:
    """A step (model, opt_state, batch) -> metrics that trains `model` in
    place. The model's parameters must require grad
    (`Transformer.trainable_`), in the order of `model.parameters()` that
    `optim.adamw_init` was given; batch holds tensors on the model's
    device ("tokens", "labels", and "frames" / "patch_embeds" for the
    frontend families). metrics: "loss", "aux", "grad_norm" and "lr", 0-d
    tensors on the device (the step reads nothing back to the host). Each
    parameter's `.grad` holds this step's gradient afterwards."""
    def train_step(model: T.Transformer, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _check_model(cfg, model)
        params: List[torch.Tensor] = list(model.parameters())
        if not all(p.requires_grad for p in params):
            raise ValueError(f"{cfg.name}: parameters without grad; call "
                             "model.trainable_() before training")
        for p in params:
            p.grad = None
        with torch.enable_grad():
            total_loss, metrics = T.loss_fn(model, batch)
            total_loss.backward()
        lr = cosine_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                             total=total)
        # a parameter the loss does not reach has a zero gradient
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        _, _, gnorm = adamw_update(grads, opt_state, params, lr=lr)
        return {"loss": metrics["loss"].detach(),
                "aux": metrics["aux"].detach(), "grad_norm": gnorm, "lr": lr}
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
