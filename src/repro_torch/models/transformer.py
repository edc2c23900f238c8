"""Dense decoder-only transformer (the llama family: RMSNorm, RoPE, GQA,
SwiGLU, optional QKV bias), its per-layer KV caches, and the full-sequence
and cached forward passes.

The JAX package scans stacked layer params with `lax.scan`; here the layers
are an `nn.ModuleList` run in a Python loop, and the caches a list with one
cache per layer, updated in place. Only the `dense` family is ported; the
other families raise NotImplementedError (ROADMAP A7).

`quantize_params` makes the Linear weights resident in an AIO format, in
place (the dense weights are freed, as the reference's donating launcher
frees them); `resident_view` does it on a shallow copy and leaves the
caller's model dense (what the serving engine does, as the reference's
engine leaves the caller's params dense); `resident_format` reports it.

`loss_fn` is the causal-LM cross entropy of the full-sequence forward, as
a value (no gradient: the training stack is not ported).

`init_caches(..., paged=(pool_blocks, block_size))` gives block-pool caches
instead (every layer a pool, all layers sharing one (B, nblk) block table);
`set_block_tables` and `copy_pool_blocks` are the device halves of the
serving engine's block allocator, `gather_pool_blocks` and
`write_pool_blocks` those of its host swap, and `scrub_slots` that of its
quarantine. All of them write into the cache tensors in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..core import formats as F
from .attention import (PAGED_TYPES, Attention, KVCache,
                        QuantKVCache, init_kv_cache, init_paged_kv_cache,
                        pool_block_values, pool_fields, store_pool_blocks,
                        striped_table)
from .layers import MLP, Embedding, Linear, QuantPolicy, RMSNorm, linear

__all__ = ["ModelConfig", "Transformer", "DenseBlock", "init_params",
           "forward", "loss_fn", "decode_step", "init_caches",
           "reset_slots", "scrub_slots",
           "set_block_tables", "copy_pool_blocks", "gather_pool_blocks",
           "write_pool_blocks", "quantize_params",
           "resident_view", "resident_format"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description: the fields of the JAX package's
    ModelConfig that describe the model, and its quantization policy (its
    JAX-only execution knobs — remat, scan unroll — are not carried)."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    mlp_kind: str = "swiglu"
    qkv_bias: bool = False
    post_norm: bool = False                  # gemma2 sandwich norms
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global: bool = False               # alternate local/global attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    attn_every: int = 0                      # zamba2 shared-attn period
    slstm_every: int = 0                     # xlstm slstm period
    # --- enc-dec / frontends ---
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: Optional[str] = None           # 'audio' | 'vision' (stub inputs)
    frontend_len: int = 0                    # frames / patches per sample
    max_seq: int = 8192                      # learned-pos table size (whisper)
    learned_pos: bool = False
    subquadratic: bool = False               # may run long_500k
    kv_quant: bool = False                   # int8 KV caches (format plane)
    quant: QuantPolicy = QuantPolicy()       # Linear format plane

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def _check_supported(cfg: ModelConfig) -> None:
    unported = []
    if cfg.family != "dense":
        unported.append(f"family {cfg.family!r}")
    if cfg.local_global:
        unported.append("local/global attention")
    if cfg.learned_pos or cfg.encoder_layers or cfg.cross_attention:
        unported.append("learned positions / encoder-decoder")
    if cfg.norm != "rmsnorm":
        unported.append(f"norm {cfg.norm!r}")
    if cfg.mlp_kind != "swiglu":
        unported.append(f"mlp {cfg.mlp_kind!r}")
    if cfg.name.startswith("gemma"):
        unported.append("gemma embedding scaling")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet; only the "
            "dense llama-family path is (see ROADMAP.md, A7)")


class DenseBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x)); optional
    post-norms (pn1/pn2) on each branch."""

    def __init__(self, cfg: ModelConfig, *, gen=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device=device, dtype=dtype)
        self.attn = Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            softcap=cfg.softcap_attn, gen=gen, device=device, dtype=dtype,
            policy=cfg.quant)
        self.ln2 = RMSNorm(d, device=device, dtype=dtype)
        self.mlp = MLP(d, cfg.d_ff if cfg.d_ff else 4 * d, gen=gen,
                       device=device, dtype=dtype, policy=cfg.quant)
        self.pn1 = self.pn2 = None
        if cfg.post_norm:
            self.pn1 = RMSNorm(d, device=device, dtype=dtype)
            self.pn2 = RMSNorm(d, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, *, cache=None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.attn(self.ln1(x), cache=cache, lengths=lengths)
        if self.pn1 is not None:
            h = self.pn1(h)
        x = x + h
        h = self.mlp(self.ln2(x))
        if self.pn2 is not None:
            h = self.pn2(h)
        return x + h


class Transformer(nn.Module):
    """Embedding -> n_layers DenseBlocks -> final RMSNorm -> unembedding
    (tied to the embedding table, or an lm_head Linear)."""

    def __init__(self, cfg: ModelConfig, *, gen=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab, **kw)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            logits = linear(x, self.embed.table.t()).to(torch.float32)
        else:
            logits = self.lm_head(x).to(torch.float32)
        cap = self.cfg.softcap_final
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits


# Module paths whose Linears stay dense: those that never receive the
# model's QuantPolicy in the reference (its `_RESIDENT_SKIP`; in the dense
# family only `lm_head`). Embeddings and norms are not Linears.
_RESIDENT_SKIP = ("router", "mamba", "mlstm", "slstm", "lm_head", "moe")


@torch.no_grad()
def quantize_params(model: Transformer, fmt: str, *,
                    skip=_RESIDENT_SKIP) -> Transformer:
    """Make each policy-covered Linear's weight resident in `fmt` (int4
    packed two per byte along K, int8/fp8 codes; per-output-channel pow2
    scales), IN PLACE: each dense weight is freed as its codes are built,
    so the device never holds both. Linears already resident are left as
    they are. Returns `model`."""
    if fmt not in F.RESIDENT_FORMATS:
        raise ValueError(f"resident weight format {fmt!r} not in "
                         f"{F.RESIDENT_FORMATS}")
    for name, mod in model.named_modules():
        if (isinstance(mod, Linear) and mod.fmt is None
                and not set(name.split(".")) & set(skip)):
            mod.quantize_(fmt)
    return model


def _shallow_copy(mod: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer
    tensor: each module is copied with its own parameter, buffer and child
    tables, so replacing an entry in the copy leaves the original alone."""
    new = copy.copy(mod)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    new._non_persistent_buffers_set = set(mod._non_persistent_buffers_set)
    new._modules = {name: None if child is None else _shallow_copy(child)
                    for name, child in mod._modules.items()}
    return new


def resident_view(model: Transformer, fmt: str, *,
                  skip=_RESIDENT_SKIP) -> Transformer:
    """`quantize_params` on a shallow copy of `model`: the copy shares
    every tensor of `model` but the covered Linears' weights, whose codes
    and scales are new tensors, and `model` keeps its dense weights. Linears
    already resident are shared as they are."""
    return quantize_params(_shallow_copy(model), fmt, skip=skip)


def resident_format(model: Transformer) -> Optional[str]:
    """The residency format of a model's Linears (None when dense)."""
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.fmt is not None:
            return mod.fmt
    return None


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Transformer:
    """Random f32 weights at the JAX init scales, from a seeded
    `torch.Generator` on `device` (the values are not `jax.random`'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, gen=gen, device=dev, dtype=dtype)


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor):
    """Full-sequence forward. tokens: (B, L) -> (logits (B, L, V), aux).
    aux is the MoE auxiliary loss — zero for the dense family."""
    x = model.embed(tokens)
    for layer in model.layers:
        x = layer(x)
    logits = model.unembed(model.final_norm(x))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Causal-LM cross entropy (+ aux_weight x the MoE aux loss), the
    reference's `loss_fn` as a value. batch: "tokens" (B, L) and "labels"
    (B, L); labels < 0 (-100) mask a position out. Returns (loss + aux_weight
    * aux, {"loss": loss, "aux": aux})."""
    logits, aux = forward(model, batch["tokens"])
    labels = batch["labels"]
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    del logits
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    del logp
    loss = (nll * mask).sum() / mask.sum().clamp_min(1)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


@torch.no_grad()
def decode_step(model: Transformer, caches: List, tokens: torch.Tensor, *,
                lengths: Optional[torch.Tensor] = None):
    """One cached step. tokens: (B, l) -> (logits (B, l, V), caches).

    l is 1 for a decode step; a chunked prefill passes a right-padded
    (B, l) block with `lengths` (B,) marking each row's valid-token count —
    rows with lengths[b] == 0 keep caches and positions untouched. The
    caches are updated in place and returned for convenience.
    """
    x = model.embed(tokens)
    for layer, cache in zip(model.layers, caches):
        x = layer(x, cache=cache, lengths=lengths)
    return model.unembed(model.final_norm(x)), caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda", dtype=torch.bfloat16,
                paged: Optional[Tuple[int, int]] = None) -> List:
    """One KV cache per layer: KVCache (bf16 by default) or, with
    cfg.kv_quant, QuantKVCache (int8 codes + pow2 scales).

    paged: (pool_blocks, block_size) — block-pool PagedKVCache /
    PagedQuantKVCache layers instead, each with its own pool of pool_blocks
    blocks of block_size positions and all sharing ONE (batch, nblk) block
    table tensor, nblk = ceil(max_len / block_size)."""
    dev = resolve_device(device)
    if paged is None:
        return [init_kv_cache(batch, cfg.n_kv_heads, max_len, cfg.hd,
                              device=dev, dtype=dtype,
                              quantized=cfg.kv_quant)
                for _ in range(cfg.n_layers)]
    pool_blocks, block_size = paged
    table = striped_table(batch, -(-max_len // block_size), pool_blocks,
                          device=dev)
    return [init_paged_kv_cache(cfg.n_kv_heads, pool_blocks, block_size,
                                cfg.hd, table, dtype=dtype,
                                quantized=cfg.kv_quant)
            for _ in range(cfg.n_layers)]


_CACHE_TYPES = (KVCache, QuantKVCache) + PAGED_TYPES


def reset_slots(caches: List, slot_mask: torch.Tensor,
                new_pos: Optional[torch.Tensor] = None) -> List:
    """Rewind cache rows (slots) where slot_mask (B,) is True to position 0
    (or new_pos), in place — the slot-refill primitive for continuous
    batching. Stale K/V sit beyond the new causal frontier, so attention
    never sees them, and each position is overwritten before the frontier
    reaches it. new_pos lets the paged engine start a row that shares a
    prompt prefix at the shared-token count."""
    for c in caches:
        if not isinstance(c, _CACHE_TYPES):
            raise TypeError(f"not a KV cache: {type(c).__name__}")
        to = torch.zeros_like(c.pos) if new_pos is None \
            else new_pos.to(c.pos.dtype)
        c.pos = torch.where(slot_mask, to, c.pos)
    return caches


@torch.no_grad()
def scrub_slots(caches: List, slot_mask: torch.Tensor) -> List:
    """`reset_slots` to position 0 plus VALUE scrubbing, in place: rows
    where slot_mask (B,) is True get their cache values re-initialized (KV
    values and int8 codes 0, scales 1), not only their positions rewound.

    `reset_slots` leans on the causal mask to hide stale rows, which is
    sound for finite stale values only: a masked key's weight is 0, but the
    product P V still reads its tile's V, and 0 * NaN is NaN, so a poisoned
    row could leak through the mask that hides ordinary stale data. The
    engine's quarantine scrubs a row before it is reused; everything else
    keeps the cheap `reset_slots`.

    A paged cache scrubs every physical block that a scrubbed row's table
    row names, blocks shared with other rows included (a NaN in a shared
    block must not survive into another row's attention; the engine
    quarantines the rows that share them). No host sync."""
    for c in caches:
        if not isinstance(c, _CACHE_TYPES):
            raise TypeError(f"not a KV cache: {type(c).__name__}")
        mask = slot_mask.to(device=c.pos.device, dtype=torch.bool)
        if isinstance(c, PAGED_TYPES):
            names = pool_fields(c)
            nblocks = getattr(c, names[0]).shape[0]
            hits = torch.zeros(nblocks, dtype=torch.int32,
                               device=mask.device)
            hits.index_add_(0, c.table.reshape(-1).long(),
                            mask[:, None].expand(c.table.shape)
                            .reshape(-1).to(torch.int32))
            rows = hits > 0
        else:
            names = tuple(f.name for f in dataclasses.fields(c)
                          if f.name != "pos")
            rows = mask
        for name in names:
            pool = getattr(c, name)
            pool.masked_fill_(rows.view((-1,) + (1,) * (pool.dim() - 1)),
                              1 if name.endswith("_scale") else 0)
        c.pos = torch.where(mask, torch.zeros_like(c.pos), c.pos)
    return caches


def _paged(caches: List) -> List:
    for c in caches:
        if not isinstance(c, PAGED_TYPES):
            raise TypeError(f"not a paged KV cache: {type(c).__name__}")
    return caches


def set_block_tables(caches: List, table: torch.Tensor) -> List:
    """Install a (B, nblk) block table, in place, into the one table tensor
    every paged cache layer shares (`init_caches` and
    `bridge.caches_from_jax` both build them so)."""
    shared = _paged(caches)[0].table
    if any(c.table is not shared for c in caches):
        raise ValueError("the paged cache layers do not share one table")
    shared.copy_(table)
    return caches


def _pools(c) -> Tuple[torch.Tensor, ...]:
    return tuple(getattr(c, name) for name in pool_fields(c))


@torch.no_grad()
def copy_pool_blocks(caches: List, src: Sequence[int],
                     dst: Sequence[int]) -> List:
    """Copy physical pool blocks src[i] -> dst[i] in every paged cache layer,
    in place: the device half of copy-on-write (a shared block is forked
    before a row writes into it). Only real pairs are passed: no dst is
    also a src."""
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} sources for {len(dst)} destinations")
    if not len(src):
        return caches
    dev = caches[0].pos.device
    s = torch.as_tensor(src, dtype=torch.long, device=dev)
    d = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for c in _paged(caches):
        for pool in _pools(c):
            pool[d] = pool[s]
    return caches


@torch.no_grad()
def gather_pool_blocks(caches: List, ids: torch.Tensor) -> dict:
    """Read physical pool blocks `ids` ((C,) int) out of every paged cache
    layer: {pool name: (n_layers, C, Hkv, bs, X)} new tensors on the
    caches' device (the reference's stacked-segment layout).
    `write_pool_blocks` is the exact inverse: the device half of KV
    swap-out, run at the scheduler boundary, never inside the step."""
    layers = _paged(caches)
    ids = torch.as_tensor(ids, dtype=torch.long, device=layers[0].pos.device)
    per = [pool_block_values(c, ids) for c in layers]
    return {name: torch.stack([p[name] for p in per])
            for name in pool_fields(layers[0])}


@torch.no_grad()
def write_pool_blocks(caches: List, values: dict, dst) -> List:
    """Write `gather_pool_blocks`-shaped block values into every paged
    layer's pools at physical blocks `dst` ((C,) int), in place. Entries
    equal to the pool size P are padding and land in the trash block, so a
    fixed-width sentinel-padded `dst` writes only the real blocks (the
    reference's `mode="drop"`). The device half of KV swap-in: the written
    bytes are exactly the gathered ones, so a preempted row resumes
    bitwise."""
    layers = _paged(caches)
    dst = torch.as_tensor(dst, dtype=torch.long, device=layers[0].pos.device)
    for i, c in enumerate(layers):
        store_pool_blocks(c, {name: v[i] for name, v in values.items()}, dst)
    return caches
