"""NN layers of the dense decoder: Linear, embedding, RMSNorm, RoPE and the
SwiGLU MLP, as `nn.Module`s whose weights keep the JAX package's layout
(a Linear's weight is (d_in, d_out), applied as ``x @ w``).

Initialization follows the JAX init scales (normal * d_in^-0.5 for a
Linear, normal * 0.02 for the embedding, ones for a norm gain) from an
explicit `torch.Generator`; the values differ from `jax.random`'s, so a
test that compares the two packages copies one set of weights into both
(see `repro_torch.bridge`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device

__all__ = ["Linear", "Embedding", "RMSNorm", "MLP", "linear", "rmsnorm",
           "rope"]


def _normal(shape, scale: float, gen: Optional[torch.Generator], device,
            dtype) -> nn.Parameter:
    if gen is None:                       # filled later (e.g. by the bridge)
        w = torch.zeros(shape, dtype=dtype, device=device)
    else:
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        w.mul_(scale)
    return nn.Parameter(w, requires_grad=False)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w accumulated in f32, cast to x's dtype, then the bias."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.w = _normal((d_in, d_out), d_in ** -0.5, gen, device, dtype)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                              requires_grad=False) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.table = _normal((vocab, d_model), 0.02, gen, device, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * g).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.g)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved). x: (..., L, D) with D
    even; positions: (L,) or per-row (B, L)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over the head dim: x (..., H, L, D) vs ang (..., L, half)
    while cos.dim() < x.dim():
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, d_model: int, d_ff: int, *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=resolve_device(device), dtype=dtype)
        self.gate = Linear(d_model, d_ff, **kw)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))
