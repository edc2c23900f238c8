"""Plain oracle of the quantize op: `formats.quantize_scaled` per row (the
reference's `aio_quant_ref`), and the edge rows a quantizer is checked on."""
from __future__ import annotations

import torch

from ...core import formats as F

__all__ = ["aio_quant_ref", "quant_edge_rows"]


def aio_quant_ref(x: torch.Tensor, *, fmt_name: str):
    """Returns (codes int32, per-row pow2 scale float32 (M, 1))."""
    return F.quantize_scaled(x, F.REGISTRY[fmt_name], axis=1, pow2=True)


def quant_edge_rows(fmt_name: str, n: int) -> torch.Tensor:
    """(7, n) float32 rows on which a quantizer's rounding, saturation and
    floors decide its codes; each row cycles through its values.

    0: all zero. 1: max |x| 1e-31, between the two floors (FLT_MIN and
    1e-30). 2: +-max_finite (so the row's scale is exactly 1), then the
    midpoints of every pair of adjacent grid values (int: k + 0.5; fp:
    between neighbouring codes, subnormals included) — RNE ties, where
    round-half-away-from-zero differs — then the grid values themselves.
    3 and 4: row 2 at scale 2^-20 (smallest ties first) and 2^12.
    5: +-inf (scale 1), values past +-max_finite (saturation), then row
    2's ties. 6: a NaN (scale 1), then row 2's ties."""
    fmt = F.REGISTRY[fmt_name]
    top = fmt.max_finite
    if fmt.kind == "int":
        grid = torch.arange(-int(top), int(top) + 1, dtype=torch.float64)
    else:
        codes = torch.arange(1 << (1 + fmt.ebits + fmt.mbits),
                             dtype=torch.int32)
        vals = F.decode(codes, fmt).to(torch.float64)
        grid = vals[vals.abs() <= top].unique()          # sorted, +-0 once
    pos = grid[grid >= 0]
    mids = (pos[1:] + pos[:-1]) / 2                      # exact in float32
    ends = torch.tensor([top, -top], dtype=torch.float64)
    # +-tie pairs, largest first (and, for row 3, smallest first): a short
    # row holds both ends of the grid
    ties = torch.stack([mids.flip(0), -mids.flip(0)], 1).flatten()
    ties_low = torch.stack([mids, -mids], 1).flatten()
    scale1 = torch.cat([ends, ties, grid]).to(torch.float32)
    scale1_low = torch.cat([ends, ties_low, grid]).to(torch.float32)
    inf = float("inf")
    beyond = torch.tensor([inf, -inf, 1.5 * top, -1.5 * top, 2 * top,
                           -1e30, 1e30], dtype=torch.float32)

    def cycle(v: torch.Tensor) -> torch.Tensor:
        return v[torch.arange(n) % v.numel()]

    return torch.stack([
        torch.zeros(n),
        torch.linspace(1.0, -1.0, n) * 1e-31,
        cycle(scale1),
        cycle(scale1_low) * 2.0 ** -20,
        cycle(scale1) * 2.0 ** 12,
        cycle(torch.cat([beyond, ties.to(torch.float32)])),
        cycle(torch.cat([torch.tensor([float("nan")]),
                         ties.to(torch.float32)])),
    ]).to(torch.float32)
