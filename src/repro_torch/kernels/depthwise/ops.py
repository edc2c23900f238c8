"""Depthwise conv (stride 1, SAME): the registry impls of
`depthwise_conv`. "cuda" is the depthwise kernel (its plain version on CPU
tensors); "ref" the plain eager oracle."""
from __future__ import annotations

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register
from .kernel import depthwise_conv
from .ref import depthwise_ref

__all__ = []


@register("depthwise_conv", "cuda")
def _depthwise_cuda(x: torch.Tensor, filt: torch.Tensor, *,
                    policy: ExecutionPolicy) -> torch.Tensor:
    return depthwise_conv(x.contiguous(), filt.contiguous())


@register("depthwise_conv", "ref")
def _depthwise_ref(x: torch.Tensor, filt: torch.Tensor, *,
                   policy: ExecutionPolicy) -> torch.Tensor:
    return depthwise_ref(x, filt, stride=1, padding="SAME")
