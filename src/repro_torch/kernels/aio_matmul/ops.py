"""The multi-format matmul ops: the code-level entries and the registry
impls of `matmul` and `matmul_codes`.

"cuda" is the kernel route (`aio_quant` then `aio_matmul`, each the CUDA
kernel on CUDA tensors and its plain version on CPU tensors); "ref" the
plain eager oracle. The two routes of `matmul_codes` are different
functions, as in the reference: "cuda" also quantizes the activations per
row to the weight's format (W4A4 for int4), "ref" multiplies float32
activations by the dequantized weight.
"""
from __future__ import annotations

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register
from ...core import formats as F
from ..aio_quant import aio_quant
from .kernel import aio_matmul
from .ref import aio_matmul_ref, quantize_operands_ref

__all__ = ["aio_matmul_codes", "aio_matmul_resident"]


def aio_matmul_codes(xq: torch.Tensor, wq: torch.Tensor, xs, ws, *,
                     mode: str) -> torch.Tensor:
    """The kernel on unpacked codes (any integer container; bf16 operands
    in bf16 mode): casts them to the kernel's int8 and packs int4 weights
    along K."""
    if mode == "bf16":
        x, w = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    elif mode == "int4":
        x, w = xq.to(torch.int8), F.pack_int4(wq.t()).t()
    else:
        x, w = xq.to(torch.int8), wq.to(torch.int8)
    if xs is not None:
        xs, ws = xs.to(torch.float32), ws.to(torch.float32)
    return aio_matmul(x.contiguous(), w.contiguous(), xs, ws, mode=mode)


def aio_matmul_resident(xq: torch.Tensor, wq: F.QuantWeight,
                        xs: torch.Tensor) -> torch.Tensor:
    """The kernel where the weight is already resident codes: xq (M, K)
    int8 activation codes (int4: one per byte) with per-row scales xs
    (M, 1); the weight's stored codes go to the kernel as they are."""
    if wq.codes.dim() != 2:
        raise ValueError("the kernel takes an unstacked (K[/2], N) weight; "
                         f"got codes of shape {tuple(wq.codes.shape)}")
    if xq.shape[1] != wq.k:
        raise ValueError(f"activation K {xq.shape[1]} != weight K {wq.k}")
    return aio_matmul(xq, wq.codes, xs, wq.scale, mode=wq.fmt)


@register("matmul", "cuda")
def _matmul_cuda(x: torch.Tensor, w: torch.Tensor, *,
                 policy: ExecutionPolicy) -> torch.Tensor:
    xq, wq, xs, ws = quantize_operands_ref(x, w, policy.format)
    return aio_matmul_codes(xq, wq, xs, ws, mode=policy.format)


@register("matmul", "ref")
def _matmul_ref(x: torch.Tensor, w: torch.Tensor, *,
                policy: ExecutionPolicy) -> torch.Tensor:
    xq, wq, xs, ws = quantize_operands_ref(x, w, policy.format)
    return aio_matmul_ref(xq, wq, xs, ws, mode=policy.format)


@register("matmul_codes", "cuda")
def _matmul_codes_cuda(x: torch.Tensor, wq: F.QuantWeight, *,
                       policy: ExecutionPolicy) -> torch.Tensor:
    """Per-row activation codes and pow2 scales (the quantizer kernel with
    `quantize_scaled`'s FLT_MIN floor), then the GEMM on the resident
    codes."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, wq.k).to(torch.float32).contiguous()
    xq, xs = aio_quant(x2, fmt_name=wq.fmt, floor=F.FLT_MIN)
    out = aio_matmul_resident(xq, wq, xs)
    return out.reshape(*lead, out.shape[-1])


@register("matmul_codes", "ref")
def _matmul_codes_ref(x: torch.Tensor, wq: F.QuantWeight, *,
                      policy: ExecutionPolicy) -> torch.Tensor:
    """Dequantize, then a float32 product."""
    return torch.matmul(x.to(torch.float32), F.dequantize_weight(wq))
