"""Grouped GEMM: the registry impls of `grouped_matmul` and the morphable
multi-tenant entry behind `api.ops.morphable_multi_gemm`: several
unrelated GEMMs packed onto one grid and run in ONE grouped launch, the
software analogue of the paper's fissioned array blocks running several
models at once.

"cuda" is the grouped GEMM kernel (its plain version on CPU tensors);
"ref" the plain eager oracle (`grouped_matmul_ref`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import register, registry
from ..common import ceil_div, pad_to
from .kernel import grouped_matmul
from .ref import grouped_matmul_ref

__all__ = ["make_group_ids", "pack_tenants", "multi_gemm_with_policy"]


def make_group_ids(group_sizes: Sequence[int], bm: int,
                   device=None) -> torch.Tensor:
    """Row-tile group ids (int32) from per-group row counts (must be bm
    multiples)."""
    ids = []
    for g, size in enumerate(group_sizes):
        if size % bm:
            raise ValueError(f"group {g} size {size} not a multiple of "
                             f"bm={bm}")
        ids.extend([g] * (size // bm))
    return torch.tensor(ids, dtype=torch.int32, device=device)


def _prepare(x, w, group_sizes, policy: ExecutionPolicy):
    gids = make_group_ids(group_sizes, policy.bm, device=x.device)
    xk = pad_to(x, policy.bk, axis=1)
    wk = pad_to(pad_to(w, policy.bk, axis=1), policy.bn, axis=2)
    return gids, xk, wk, w.shape[-1]


@register("grouped_matmul", "cuda")
def _grouped_cuda(x: torch.Tensor, w: torch.Tensor,
                  group_sizes: Sequence[int], *, policy: ExecutionPolicy,
                  extents: Optional[Tuple[Sequence[int],
                                          Sequence[int]]] = None
                  ) -> torch.Tensor:
    """`extents` = (group_k, group_n): each group's own K and N inside the
    zero-padded operands, so the kernel skips the padding."""
    gids, xk, wk, n = _prepare(x, w, group_sizes, policy)
    group_k, group_n = extents if extents is not None else (None, None)
    out = grouped_matmul(gids, xk.contiguous(), wk.contiguous(),
                         bm=policy.bm, out_dtype=policy.out_dtype,
                         group_k=group_k, group_n=group_n)
    return out[:, :n]


@register("grouped_matmul", "ref")
def _grouped_ref(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: Sequence[int], *, policy: ExecutionPolicy,
                 extents=None) -> torch.Tensor:
    """The oracle multiplies the padding, which `extents` marks."""
    gids, xk, wk, n = _prepare(x, w, group_sizes, policy)
    out = grouped_matmul_ref(gids, xk, wk, bm=policy.bm,
                             out_dtype=policy.out_dtype)
    return out[:, :n]


def pack_tenants(tenants: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 bm: int, bk: int, bn: int):
    """Pad heterogeneous tenant GEMMs onto a common (K, N) grid and stack.

    Returns (x_packed (T, Kmax), w_packed (G, Kmax, Nmax), group_sizes,
    metas) where metas[i] = (row_slice, n_i) slices tenant i's result back
    out. The padding is the utilization a rigid array would lose to idle
    MACs; `multi_gemm_with_policy` reports it."""
    kmax = ceil_div(max(x.shape[1] for x, _ in tenants), bk) * bk
    nmax = ceil_div(max(w.shape[1] for _, w in tenants), bn) * bn
    xs, ws, sizes, metas = [], [], [], []
    row = 0
    for x, w in tenants:
        m, k = x.shape
        n = w.shape[1]
        mpad = ceil_div(m, bm) * bm
        xp = x.new_zeros((mpad, kmax))
        xp[:m, :k] = x
        wp = w.new_zeros((kmax, nmax))
        wp[:k, :n] = w
        xs.append(xp)
        ws.append(wp)
        sizes.append(mpad)
        metas.append((slice(row, row + m), n))
        row += mpad
    return torch.cat(xs, 0), torch.stack(ws, 0), sizes, metas


def multi_gemm_with_policy(tenants: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]],
                           policy: ExecutionPolicy):
    """Resolved-policy body of `api.ops.morphable_multi_gemm`: returns
    (results, mac_utilization), the utilization being useful MACs over
    the MACs of the packed launch (the paper's Fig 14 metric). The grouped
    launch is handed each tenant's own (K, N), so the kernel skips the
    zero padding it would otherwise multiply."""
    x, w, sizes, metas = pack_tenants(tenants, policy.bm, policy.bk,
                                      policy.bn)
    extents = ([xi.shape[1] for xi, _ in tenants],
               [wi.shape[1] for _, wi in tenants])
    out = registry.lookup("grouped_matmul", policy.impl())(
        x, w, tuple(sizes), policy=policy, extents=extents)
    results = [out[sl, :n] for sl, n in metas]
    useful = sum(xi.shape[0] * xi.shape[1] * wi.shape[1]
                 for xi, wi in tenants)
    launched = x.shape[0] * x.shape[1] * w.shape[-1]
    return results, useful / launched
