"""Step functions of the full-sequence path.

`make_prefill_step(cfg)` is the batched greedy prefill: one full-sequence
forward over a (B, L) request batch, returning each row's next token. Its
attention goes through `api.ops.attention`, whose 128-aligned
scalar-offset calls run the full-sequence flash kernel. (The reference's
train and serve steps wait for the training stack and the distribution
layer.)
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import transformer as T

__all__ = ["make_prefill_step"]


def make_prefill_step(cfg: T.ModelConfig) -> Callable:
    """A step (model, batch) -> next-token ids (B,) (greedy: the argmax of
    the last position's logits); batch["tokens"] is (B, L), and the
    optional batch["patch_embeds"] and batch["frames"] go to `forward` as
    its prefix_embeds and frames."""
    def prefill_step(model: T.Transformer,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, the model "
                             f"is {model.cfg.name}")
        logits, _ = T.forward(model, batch["tokens"],
                              prefix_embeds=batch.get("patch_embeds"),
                              frames=batch.get("frames"))
        return torch.argmax(logits[:, -1], dim=-1)
    return prefill_step
