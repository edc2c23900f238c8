"""Mixture-of-Experts layer (olmoe, kimi-k2) with sort-based capacity
dispatch: the reference's single-device path.

Each token's router picks `top_k` experts (softmax in f32, the chosen
gates renormalized); the (token, expert) assignments are sorted by expert,
stably, so within an expert they keep token order (tokens flattened
row-major over (B, L), top-k innermost), and each expert keeps the first
`capacity` of them, capacity = int(max(top_k * T / E * capacity_factor,
4)) with T = B * L of the whole launch. The rest are dropped: their gate
mass is lost (GShard/Switch). Every position of the launch counts toward
T and competes for capacity, pad positions and idle rows included, as in
the reference: which assignments a token keeps depends on its launch.

Under a mesh with a "model" axis (`dist.set_mesh`) the layer runs the
reference's expert-parallel path (`_ep_context`, `_moe_apply_ep`): each
rank holds E / R experts (`dist.shard_params` cuts the stacked weights on
their expert axis), routes the tokens of its DP shard (capacity from that
shard's token count), keeps the assignments of its own experts, and the
ranks' outputs are summed over "model" (an all-reduce, or a reduce-scatter
onto the sequence-sharded residual of the manual TP block).

The expert products run batched over the expert axis (`torch.bmm`),
outside any kernel, as the reference computes them (a batched einsum). The
router is a plain product with no QuantPolicy; the shared expert (kimi's
`n_shared_experts`) is a SwiGLU `MLP` that takes the model's policy. The
module is named `moe` in its block and its router `router`, so
`transformer.quantize_params` leaves the whole layer dense, as the
reference's residency does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..dist.collectives import (all_gather, all_reduce, reduce_scatter,
                                seq_split)
from ..dist.sharding import (axis_rank, axis_size, ctx_dp_axes, ctx_mesh,
                             dp_size, in_dp_region)
from .layers import MLP, Linear, QuantPolicy, _normal, linear

__all__ = ["MoE", "Dispatch", "router_topk", "expert_capacity"]


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """The assignments an expert keeps in a launch of `tokens` tokens."""
    return int(max(top_k * tokens / n_experts * capacity_factor, 4))


def router_topk(probs: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k), expert ids (T, k)) of the router's f32 softmax
    `probs` (T, E): the top k, the gates renormalized to sum to 1 (floor
    1e-9)."""
    gates, ids = torch.topk(probs, top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids


@dataclasses.dataclass
class Dispatch:
    """One launch's routing. Assignments are in expert-sorted order:
    expert `se`, token `st`, gate `sg`, slot `pos` within its expert,
    `keep` where pos < capacity; `order` maps them back to the row-major
    (token, k) order. `probs` are the router's softmax (T, E), for the
    aux loss."""
    capacity: int
    probs: torch.Tensor
    ids: torch.Tensor
    order: torch.Tensor
    se: torch.Tensor
    st: torch.Tensor
    sg: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor

    @property
    def dropped(self) -> torch.Tensor:
        """The count of dropped assignments (a 0-d tensor, no host sync)."""
        return (~self.keep).sum()


class MoE(nn.Module):
    """Top-k routed experts, each a SwiGLU of width d_ff, stacked on the
    leading axis: gate/up (E, d_model, d_ff), down (E, d_ff, d_model);
    plus `n_shared` always-on experts as one SwiGLU MLP of width
    d_ff * n_shared."""

    shards = None

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 *, n_shared: int = 0, capacity_factor: float = 1.25,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32, policy: QuantPolicy = QuantPolicy()):
        super().__init__()
        device = resolve_device(device)
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.router = Linear(d_model, n_experts, gen=gen, device=device,
                             dtype=dtype)
        self.gate = _normal((n_experts, d_model, d_ff), d_model ** -0.5, gen,
                            device, dtype)
        self.up = _normal((n_experts, d_model, d_ff), d_model ** -0.5, gen,
                          device, dtype)
        self.down = _normal((n_experts, d_ff, d_model), d_ff ** -0.5, gen,
                            device, dtype)
        self.shared = None
        if n_shared:
            self.shared = MLP(d_model, d_ff * n_shared, "swiglu", gen=gen,
                              device=device, dtype=dtype, policy=policy)

    def dispatch(self, xt: torch.Tensor) -> Dispatch:
        """Route the (T, d_model) tokens of one launch."""
        t, k, e = xt.shape[0], self.top_k, self.n_experts
        logits = torch.matmul(xt.to(torch.float32),
                              self.router.weight_full().to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        gates, ids = router_topk(probs, k)
        flat_e = ids.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        st = torch.div(order, k, rounding_mode="floor")
        sg = gates.reshape(-1)[order]
        seg_start = torch.searchsorted(
            se, torch.arange(e, device=xt.device, dtype=se.dtype))
        pos = torch.arange(t * k, device=xt.device) - seg_start[se]
        capacity = expert_capacity(t, e, k, self.capacity_factor)
        return Dispatch(capacity, probs, ids, order, se, st, sg, pos,
                        pos < capacity)

    def aux_loss(self, d: Dispatch) -> torch.Tensor:
        """Switch-style load balance: E * sum(mean router prob x the
        fraction of assignments routed to each expert)."""
        n = d.ids.numel()
        routed = torch.bincount(d.ids.reshape(-1),
                                minlength=self.n_experts).to(torch.float32)
        return self.n_experts * torch.sum(d.probs.mean(0) * (routed / n))

    def experts(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The stacked expert weights (gate, up, down), all-gathered over
        their expert axis when sharded."""
        out = []
        for name in ("gate", "up", "down"):
            w = getattr(self, name)
            s = (self.shards or {}).get(name)
            out.append(w if s is None
                       else all_gather(w, s[0], s[1], site="weight"))
        return tuple(out)

    def forward(self, x: torch.Tensor, *, seq_sharded: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, L, d_model) -> (out (B, L, d_model), aux loss).
        seq_sharded: x is this rank's sequence slice over "model" (the
        manual TP block's residual), and so is the output."""
        ep = _ep_context(x, self.n_experts,
                         "gate" in (self.shards or {}))
        if ep is not None:
            return _moe_apply_ep(self, x, ep, seq_sharded=seq_sharded)
        if seq_sharded:
            out, aux = self(all_gather(x, 1, "model", site="moe.seq"))
            return seq_split(out, 1, "model"), aux
        b, l, dm = x.shape
        xt = x.reshape(b * l, dm)
        d = self.dispatch(xt)
        e, c = self.n_experts, d.capacity
        posc = d.pos.clamp(max=c - 1)
        # each kept assignment fills its own (expert, slot) row; dropped
        # ones go to one trash row past the E * C buffer rows (a mask
        # select would sync with the host)
        dst = torch.where(d.keep, d.se * c + posc,
                          torch.full_like(posc, e * c))
        rows = torch.zeros((e * c + 1, dm), dtype=x.dtype, device=x.device)
        rows[dst] = xt[d.st]
        buf = rows[:e * c].view(e, c, dm)
        gate, up, down = self.experts()
        h = torch.nn.functional.silu(torch.bmm(buf, gate)) \
            * torch.bmm(buf, up)
        y = torch.bmm(h, down)
        gathered = y[d.se, posc] * torch.where(
            d.keep, d.sg, torch.zeros_like(d.sg))[:, None].to(y.dtype)
        # the combine: back to (token, k) order, summed over k in a fixed
        # order (no atomics), so a launch's output does not vary run to run
        combined = torch.empty_like(gathered)
        combined[d.order] = gathered
        out = combined.view(b * l, self.top_k, dm).sum(1)
        if self.shared is not None:
            out = out + self.shared(xt)
        return out.reshape(b, l, dm).to(x.dtype), self.aux_loss(d)


# =============================================================================
# Expert-parallel path
# =============================================================================

def _ep_context(x: torch.Tensor, n_experts: int, sharded: bool = True):
    """(dp axes, dp size, model size) when the ambient mesh supports EP
    here: a "model" axis whose size divides the experts, outside the
    compressed step's DP region (the reference's manual region). A DP-only
    mesh with a "model" axis of 1 takes it too, as the reference's does:
    capacity then comes from the DP shard's tokens. (The reference's
    B*L % dp holds by construction: x is this rank's DP shard.) Experts
    left whole on every rank (`sharded` False: a model served replicated
    on a partition) take the one-rank path over R > 1."""
    mesh = ctx_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names or in_dp_region():
        return None
    ms = axis_size("model")
    if n_experts % ms or (ms > 1 and not sharded):
        return None
    return ctx_dp_axes(), dp_size(), ms


def _moe_apply_ep(moe: MoE, x: torch.Tensor, ep, *, seq_sharded: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_moe_apply_ep` on this rank: x is its DP shard's
    tokens (or, seq_sharded, its sequence slice of them, all-gathered in);
    every rank routes all of them, keeps the assignments of its E / R
    experts (the others go to a sentinel bin past them, sorted stably), and
    its outputs are summed over "model" (reduce-scattered back onto the
    sequence slice when seq_sharded). aux is averaged over the DP axes.
    kimi's shared expert runs column/row-parallel in the same sum."""
    dp, n_dp, ms = ep
    if seq_sharded:
        x = all_gather(x, 1, "model", site="moe.seq")
    b, l, dm = x.shape
    t, k, e = b * l, moe.top_k, moe.n_experts
    e_loc = e // ms
    e_lo = axis_rank("model") * e_loc
    capacity = expert_capacity(t, e, k, moe.capacity_factor)
    xt = x.reshape(t, dm)
    if moe.router.tp == "col":
        # this rank's experts' logits, gathered: no router weight moves
        logits = all_gather(linear(xt.to(torch.float32), moe.router.w),
                            -1, moe.router.shards["w"][1], site="moe.router")
    else:
        logits = torch.matmul(xt.to(torch.float32),
                              moe.router.weight_full().to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = router_topk(probs, k)
    flat_e = ids.reshape(-1)
    routed = torch.zeros(e, dtype=torch.float32, device=x.device
                         ).scatter_add_(0, flat_e, torch.ones(
                             t * k, dtype=torch.float32, device=x.device))
    aux = e * torch.sum(probs.mean(0) * (routed / (t * k)))
    if n_dp > 1:
        aux = all_reduce(aux, dp, site="moe.aux") / n_dp

    local = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    le = torch.where(local, flat_e - e_lo, torch.full_like(flat_e, e_loc))
    order = torch.argsort(le, stable=True)
    se = le[order]
    st = torch.div(order, k, rounding_mode="floor")
    sg = gates.reshape(-1)[order]
    seg_start = torch.searchsorted(
        se, torch.arange(e_loc, device=x.device, dtype=se.dtype))
    sec = se.clamp(max=e_loc - 1)
    pos = torch.arange(t * k, device=x.device) - seg_start[sec]
    keep = local[order] & (pos < capacity) & (se < e_loc)
    posc = pos.clamp(0, capacity - 1)
    dst = torch.where(keep, sec * capacity + posc,
                      torch.full_like(posc, e_loc * capacity))
    rows = torch.zeros((e_loc * capacity + 1, dm), dtype=x.dtype,
                       device=x.device)
    rows = rows.index_put((dst,), xt[st])
    buf = rows[:e_loc * capacity].view(e_loc, capacity, dm)
    h = torch.nn.functional.silu(torch.bmm(buf, moe.gate)) \
        * torch.bmm(buf, moe.up)
    y = torch.bmm(h, moe.down)
    gathered = y[sec, posc] * torch.where(
        keep, sg, torch.zeros_like(sg))[:, None].to(y.dtype)
    # back to (token, k) order, summed over k in a fixed order
    combined = torch.empty_like(gathered).index_put((order,), gathered)
    out = combined.view(t, k, dm).sum(1)
    shared = moe.shared
    if shared is not None and shared._tp_local():
        # column/row-parallel: its partial sums ride the combine below
        hs = torch.nn.functional.silu(shared.gate.local(xt)) \
            * shared.up.local(xt)
        out = out + linear(hs, shared.down.w).to(out.dtype)
        shared = None
    out = out.reshape(b, l, dm)
    if seq_sharded:
        out = reduce_scatter(out, 1, "model", site="moe.seq")
    else:
        out = all_reduce(out, "model", site="moe.combine")
    if shared is not None:                      # replicated shared expert
        xs = seq_split(x, 1, "model") if seq_sharded else x
        out = out + shared(xs)
    return out.to(x.dtype), aux
