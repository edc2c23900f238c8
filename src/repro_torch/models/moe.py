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
from .layers import MLP, Linear, QuantPolicy, _normal

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
                              self.router.w.to(torch.float32))
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

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, L, d_model) -> (out (B, L, d_model), aux loss)."""
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
        h = torch.nn.functional.silu(torch.bmm(buf, self.gate)) \
            * torch.bmm(buf, self.up)
        y = torch.bmm(h, self.down)
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
