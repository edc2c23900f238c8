"""Plain eager oracle of the grouped GEMM: the `ref` route."""
from __future__ import annotations

import torch

__all__ = ["grouped_matmul_ref"]


def grouped_matmul_ref(group_ids: torch.Tensor, x: torch.Tensor,
                       w: torch.Tensor, *, bm: int = 128,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Gather each row tile's weight and batch-matmul in float32."""
    t, k = x.shape
    tiles = t // bm
    xt = x.reshape(tiles, bm, k).to(torch.float32)
    wt = w[group_ids.long()].to(torch.float32)        # (tiles, K, N)
    out = torch.bmm(xt, wt)
    return out.reshape(t, w.shape[-1]).to(out_dtype)
