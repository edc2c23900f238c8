"""Power-of-two scales (the bias-foldable kind the int8 KV cache uses).

Only `pow2_ceil` is ported so far; the AIO format registry, codes and
resident weights come with the multi-format GEMM (ROADMAP A1/B5).
"""
from __future__ import annotations

import torch

__all__ = ["pow2_ceil"]


def pow2_ceil(r: torch.Tensor) -> torch.Tensor:
    """Exact 2^ceil(log2(r)) for positive float32 r.

    frexp gives r = frac * 2^e2 with frac in [0.5, 1), so 2^e2 >= r — but at
    r exactly 2^k, frac == 0.5 and e2 == k+1: step the exponent back down so
    an exact power of two is its own scale.

    The power of two is assembled from its IEEE-754 bits, never through
    exp2/pow (approximations that drift off the exact power for large
    |exponent|): normal exponents as a biased exponent field, exponents
    below -126 as a subnormal with a single mantissa bit, down to 2^-149.
    """
    frac, e2 = torch.frexp(r.to(torch.float32))
    e = torch.where(frac == 0.5, e2 - 1, e2).to(torch.int32)
    one = torch.ones_like(e)
    normal = torch.bitwise_left_shift((e + 127).clamp(1, 255), 23)
    subnormal = torch.bitwise_left_shift(one, (e + 149).clamp(0, 22))
    return torch.where(e >= -126, normal, subnormal).view(torch.float32)
