"""Manual tensor+sequence-parallel dense block (the reference's
`repro.models.tp_block`, explicit collectives over "model").

The residual stream stays SEQUENCE-SHARDED over "model" (sequence
parallelism) and each sub-block does exactly

    all-gather(seq) -> column-parallel q / gate-up
    -> local attention / pointwise -> row-parallel o / down
    -> reduce-scatter(seq)

i.e. 2 all-gathers + 2 reduce-scatters of the activation per layer — the
Megatron-SP optimum. GQA maps cleanly when n_heads % R == 0 and
R % n_kv == 0: each rank owns n_heads/R query heads and exactly one kv
head, whose projection it computes from the whole k/v weights (all-gathered
when `dist.shard_params` sharded them).

The local attention goes through `api.ops.attention` on the ambient route:
the full-sequence kernel on the card, its plain version on the CPU. (The
reference pins its `ref` backend there only because a Pallas call cannot
run inside its shard_map.)

Eligibility is `manual_tp_ok`; an ineligible block (whisper's 6 heads,
qwen2's 12 at R = 8, qwen2's QKV bias at any R) takes the automatic
model-parallel path of `layers.Linear` / `attention.Attention` /
`layers.MLP` instead. `transformer._run_layers` calls these at the
reference's place: every eligible "dense"/"dense_local"/"dense_global"
block, and a "moe" block's attention (with_mlp=False) beside its
expert-parallel MoE.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..api import ops as aio_ops
from ..dist.collectives import all_gather, reduce_scatter
from ..dist.sharding import axis_rank, axis_size, ctx_mesh, in_dp_region
from .layers import Linear, QuantPolicy, _rank_slice, linear, rope

__all__ = ["MANUAL_KINDS", "manual_tp_ok", "manual_dense_block",
           "manual_layer"]

MANUAL_KINDS = ("dense", "dense_local", "dense_global", "moe")
SITE = "tp_block.seq"


def manual_tp_ok(cfg, x: torch.Tensor, cache, policy: QuantPolicy,
                 model=None) -> bool:
    """The reference's rule (`tp_block.py:47-75`): a "model" mesh axis of
    R > 1 ranks, no cache, no active quant policy, no resident codes in
    `model`, not inside the compressed step's DP region, and n_heads % R,
    R % n_kv, L % R and ff % R all zero. (B % dp holds by construction: x
    is this rank's DP shard.) On top of the reference it refuses a QKV
    bias, which the reference's block cannot carry (its shard_map gives
    q/k/v only a weight); such a config takes the automatic path."""
    mesh = ctx_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names \
            or cache is not None or policy.active or in_dp_region():
        return False
    if model is not None and any(getattr(m, "fmt", None) is not None
                                 for m in model.modules()):
        return False
    if cfg.qkv_bias:
        return False
    r = axis_size("model")
    _, l, _ = x.shape
    ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return (r > 1 and cfg.n_heads % r == 0 and r % cfg.n_kv_heads == 0
            and l % r == 0 and ff % r == 0)


def _cols(lin: Linear, r: int) -> torch.Tensor:
    """This rank's column block of a Linear's weight."""
    if lin.tp == "col":
        return lin.w
    return _rank_slice(lin.weight_full(), -1, "model", r)


def _rows(lin: Linear, r: int) -> torch.Tensor:
    """This rank's row block of a Linear's weight."""
    if lin.tp == "row":
        return lin.w
    return _rank_slice(lin.weight_full(), -2, "model", r)


def manual_dense_block(block, x: torch.Tensor, cfg, *,
                       with_mlp: bool = True) -> torch.Tensor:
    """x: this rank's sequence slice (B, L / R, D) of a `DenseBlock`'s
    input; returns the block's output, the same slice. with_mlp=False runs
    only the attention sub-block (an MoE block pairs it with the
    expert-parallel MoE)."""
    r = axis_size("model")
    rank = axis_rank("model")
    attn = block.attn
    n_heads, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h_loc = n_heads // r
    rpk = r // n_kv                      # ranks per kv head

    # ---- attention sub-block ---------------------------------------------
    h = block.ln1(x)                     # per-token: sharded ok
    hg = all_gather(h, 1, "model", site=SITE)                   # (B, L, D)
    b, l, _ = hg.shape
    q = linear(hg, _cols(attn.q, r)).view(b, l, h_loc, hd).transpose(1, 2)
    kv_head = rank // rpk
    cols = slice(kv_head * hd, (kv_head + 1) * hd)
    k = linear(hg, attn.k.weight_full()[:, cols]).view(b, l, 1, hd) \
        .transpose(1, 2)
    v = linear(hg, attn.v.weight_full()[:, cols]).view(b, l, 1, hd) \
        .transpose(1, 2)
    pos = torch.arange(l, device=x.device)
    q = rope(q, pos, attn.rope_theta)
    k = rope(k, pos, attn.rope_theta)
    att = aio_ops.attention(q, k, v, causal=True, window=attn.window,
                            softcap=attn.softcap)
    att = att.transpose(1, 2).reshape(b, l, h_loc * hd)
    rs = reduce_scatter(linear(att, _rows(attn.o, r)), 1, "model",
                        site=SITE)
    if block.pn1 is not None:
        rs = block.pn1(rs)
    x1 = x + rs
    if not with_mlp:
        return x1
    # ---- mlp sub-block ---------------------------------------------------
    mlp = block.mlp
    h2 = block.ln2(x1)
    hg2 = all_gather(h2, 1, "model", site=SITE)
    if mlp.kind in ("swiglu", "geglu"):
        g = linear(hg2, _cols(mlp.gate, r))
        act = (torch.nn.functional.silu(g) if mlp.kind == "swiglu"
               else torch.nn.functional.gelu(g, approximate="tanh"))
        part2 = linear(act * linear(hg2, _cols(mlp.up, r)),
                       _rows(mlp.down, r))
    else:
        b1 = _rank_slice(mlp.fc1.b, -1, "model", r)
        ff = torch.nn.functional.gelu(linear(hg2, _cols(mlp.fc1, r), b1),
                                      approximate="tanh")
        part2 = linear(ff, _rows(mlp.fc2, r))
        part2 = part2 + mlp.fc2.b.to(part2.dtype) / r   # bias once, not xR
    rs2 = reduce_scatter(part2, 1, "model", site=SITE)
    if block.pn2 is not None:
        rs2 = block.pn2(rs2)
    return x1 + rs2


def manual_layer(block, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One eligible layer on the sequence-sharded residual: the manual
    block, or for "moe" the manual attention, then ln2, the MoE on the
    sequence slice (expert-parallel: all-gather in, reduce-scatter out)
    and pn2. Returns (x, the MoE aux loss or None)."""
    if block.kind != "moe":
        return manual_dense_block(block, x, cfg), None
    x = manual_dense_block(block, x, cfg, with_mlp=False)
    h, aux = block.moe(block.ln2(x), seq_sharded=True)
    if block.pn2 is not None:
        h = block.pn2(h)
    return x + h, aux
