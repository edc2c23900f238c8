"""Compressed data-parallel gradient all-reduce over the AIO formats.

The paper's format plane applied to *communication*: gradients are
quantized to int8/fp8 with a power-of-two shared scale (the
programmable-bias trick — dequantization is an exponent shift) and summed
in the narrow domain, cutting DP all-reduce bytes 4x (int8) vs fp32. Error
feedback accumulates the quantization residual locally and re-injects it
next step, which keeps SGD convergence (Karimireddy et al.'s EF-SGD
argument). The reference's `repro.optim.grad_compress` on lists of
tensors, its psum/pmax the collectives of `dist.collectives` over the
ambient mesh.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from ..core import formats as F
from ..dist.collectives import all_reduce
from ..dist.sharding import axis_size, set_mesh

__all__ = ["compressed_psum", "compressed_grad_allreduce",
           "init_error_state", "shared_scale"]


def shared_scale(amax: torch.Tensor, fmt: F.AIOFormat) -> torch.Tensor:
    """pow2_ceil(max(amax, 1e-30) / max_finite): the power of two that
    fits amax into fmt."""
    return F.pow2_ceil(amax.clamp_min(1e-30) / fmt.max_finite)


def _codes(x: torch.Tensor, scale: torch.Tensor, fmt: F.AIOFormat
           ) -> torch.Tensor:
    """x / scale on fmt's grid: clipped and rounded (RNE) for an int
    format, `quantize`d for a float one (float32 values)."""
    if fmt.kind == "int":
        return torch.round(x / scale).clamp(fmt.int_min, fmt.int_max)
    return F.quantize(x / scale, fmt)


@torch.no_grad()
def compressed_psum(x: torch.Tensor, axes: Union[str, Sequence[str]],
                    fmt: F.AIOFormat) -> torch.Tensor:
    """The sum of x over the mesh axes at fmt precision.

    The scale is the max over the axes of |x|, mapped to a power of two and
    shared, so an int format's codes sum exactly in int32 (members <= 127
    x world fits); a float format's codes are summed in float32. The sum is
    multiplied back by the scale."""
    amax = all_reduce(x.abs().amax().to(torch.float32), axes, "max",
                      site="grad_compress.amax")
    scale = shared_scale(amax, fmt)
    q = _codes(x.to(torch.float32), scale, fmt)
    if fmt.kind == "int":
        s = all_reduce(q.to(torch.int32), axes, site="grad_compress.sum")
        return s.to(torch.float32) * scale
    return all_reduce(q, axes, site="grad_compress.sum") * scale


def _roundtrip(x: torch.Tensor, fmt: F.AIOFormat) -> torch.Tensor:
    """x through this rank's own pow2 scale and fmt and back: what of x the
    compression lets through, without the exchange."""
    scale = shared_scale(x.abs().amax().to(torch.float32), fmt)
    return _codes(x.to(torch.float32), scale, fmt) * scale


def init_error_state(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero float32 residuals, one per parameter."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


@torch.no_grad()
def compressed_grad_allreduce(grads: Sequence[torch.Tensor],
                              err: Sequence[torch.Tensor], mesh, *,
                              fmt_name: str = "int8",
                              dp_axis: Union[str, Sequence[str]] = "data"
                              ) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
    """Mean-reduce this rank's (unreduced) gradients over the DP axis with
    error feedback: x = g + e is summed compressed and divided by the
    world; the new residual is x minus its own round trip. Returns
    (reduced gradients in each gradient's dtype, new residuals)."""
    fmt = F.REGISTRY[fmt_name]
    axes = (dp_axis,) if isinstance(dp_axis, str) else tuple(dp_axis)
    world = 1
    for a in axes:
        world *= axis_size(a, mesh)
    out_g, out_e = [], []
    with set_mesh(mesh):
        for g, e in zip(grads, err):
            x = g.to(torch.float32) + e
            out_g.append((compressed_psum(x, axes, fmt) / world).to(g.dtype))
            out_e.append(x - _roundtrip(x, fmt))
    return out_g, out_e
