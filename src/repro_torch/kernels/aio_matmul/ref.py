"""Plain oracle of the multi-format matmul (the reference's `ref.py`):
decode -> float32 product -> rescale, and the operand quantization."""
from __future__ import annotations

from typing import Optional

import torch

from ...core import formats as F

__all__ = ["aio_matmul_ref", "quantize_operands_ref"]


def quantize_operands_ref(x: torch.Tensor, w: torch.Tensor, mode: str):
    """Quantize float32 operands: per-row pow2 scales for x, per-column for
    w. Returns (x_codes, w_codes, x_scale (M, 1), w_scale (1, N)); int4
    codes stay unpacked (int32 containers), bf16 operands are cast."""
    if mode == "bf16":
        return x.to(torch.bfloat16), w.to(torch.bfloat16), None, None
    fmt = F.REGISTRY[mode]
    x_codes, x_scale = F.quantize_scaled(x, fmt, axis=1)
    w_codes, w_scale = F.quantize_scaled(w, fmt, axis=0)
    return x_codes, w_codes, x_scale, w_scale


def aio_matmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                   x_scale: Optional[torch.Tensor],
                   w_scale: Optional[torch.Tensor], *,
                   mode: str) -> torch.Tensor:
    """Decode -> float32 matmul -> rescale. Codes are unpacked."""
    if mode == "bf16":
        return torch.matmul(x_codes.to(torch.float32),
                            w_codes.to(torch.float32))
    fmt = F.REGISTRY[mode]
    out = torch.matmul(F.decode(x_codes, fmt), F.decode(w_codes, fmt))
    if x_scale is not None:
        out = out * x_scale * w_scale
    return out
