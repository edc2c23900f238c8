"""Decoder-only transformer, its per-layer KV caches, and the
full-sequence and cached forward passes.

Every ported layer is one attention block over its own KV cache, then a
feed-forward: the llama family (RMSNorm, RoPE, GQA, SwiGLU, optional QKV
bias), olmo (non-parametric LayerNorm), gpt2 (LayerNorm, GELU MLP, learned
positions on top of RoPE), gemma2 (alternating local/global layers,
softcaps, sandwich norms, GeGLU, embeddings scaled in `forward` only) and
the MoE family (olmoe, kimi-k2: `moe.MoE` in place of the MLP, after
`n_dense_layers` dense layers), the recurrent family (xlstm: mLSTM
layers with an sLSTM every `slstm_every`-th) and the hybrid one (zamba2:
Mamba2 layers with ONE shared attention+MLP block invoked every
`attn_every`-th layer: one weight copy, a KV cache per invocation), the
encoder-decoder one (whisper: an `encoder` stack of non-causal "enc"
blocks over the audio frames, whose output `memory` every "encdec"
decoder layer cross-attends after its causal self-attention) and the
vision-language one (internvl2: a dense decoder; `forward` prepends
patch embeddings to the token stream). The frontends themselves (the
audio conv stem, the vision tower) are stubs in the reference too: the
caller passes frame or patch embeddings of width d_model. The
JAX package scans stacked segment params with `lax.scan`; here the layers
are an `nn.ModuleList` in layer order (`ModelConfig.block_kinds`; the
shared block sits at each of its positions, one module object), run in a
Python loop, and the caches a list with one cache per layer: a KV cache,
updated in place, or a recurrent state (`ssm.MambaCache`, `MLSTMCache`,
`SLSTMCache`), whose fields each step rebinds to new tensors. A model
with recurrent blocks decodes one token a row per `decode_step`.

`quantize_params` makes the Linear weights resident in an AIO format, in
place (the dense weights are freed, as the reference's donating launcher
frees them); `resident_view` does it on a shallow copy and leaves the
caller's model dense (what the serving engine does, as the reference's
engine leaves the caller's params dense); `resident_format` reports it.

`encode`, `forward` and `loss_fn` record autograd: `loss_fn` is the
causal-LM cross entropy (+ the MoE aux loss) that the training stack
(`launch.steps.make_train_step`) differentiates. Parameters are made with
`requires_grad=False`, so serving records nothing; `Transformer.trainable_`
turns gradients on for training. Attention recorded by autograd takes the
differentiable `ref` route (`api.ops.attention_route(grad=True)`): the CUDA
kernels are forward-only. With `cfg.remat` (every CONFIG) such a forward
saves only each layer unit's input and recomputes the unit in the backward
pass, as the reference's `jax.checkpoint` of its scan body does.
`decode_step` and the cache functions never record.

`init_caches(..., paged=(pool_blocks, block_size))` gives block-pool caches
instead (every layer a pool, all layers sharing one (B, nblk) block table);
`set_block_tables` and `copy_pool_blocks` are the device halves of the
serving engine's block allocator, `gather_pool_blocks` and
`write_pool_blocks` those of its host swap, and `scrub_slots` that of its
quarantine. All of them write into the cache tensors in place. Under
head parallelism (a model cut by `dist.shard_params` or
`dist.init_sharded`, served under `dist.set_mesh`) `init_caches(...,
model=)` gives each rank the KV heads it computes, n_kv / R a layer; the
block functions then move each rank's own slice of the same blocks.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import formats as F
from .attention import (PAGED_TYPES, Attention, CrossAttention, KVCache,
                        QuantKVCache, init_kv_cache, init_paged_kv_cache,
                        pool_block_values, pool_fields, store_pool_blocks,
                        striped_table)
from .layers import (_NORMS, MLP, Embedding, Linear, QuantPolicy, _normal,
                     linear, norm)
from .moe import MoE
from . import ssm
from .tp_block import MANUAL_KINDS, manual_layer, manual_tp_ok
from ..dist.collectives import all_gather, seq_split
from ..dist.sharding import ctx_mesh

__all__ = ["ModelConfig", "Transformer", "DenseBlock", "RecurrentBlock",
           "EncDecBlock", "init_params",
           "forward", "encode", "loss_fn", "decode_step", "init_caches",
           "reset_slots", "scrub_slots",
           "set_block_tables", "copy_pool_blocks", "gather_pool_blocks",
           "write_pool_blocks", "kv_caches", "quantize_params",
           "resident_view", "resident_format"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description: the fields of the JAX package's
    ModelConfig that describe the model, its quantization policy and
    `remat` (the reference's scan unroll, a JAX-only knob, is not
    carried).

    remat: recompute each layer unit in the backward pass instead of
    saving its activations (`torch.utils.checkpoint`), when a forward
    without caches records a backward. CONFIGs keep the default, SMOKEs
    set False, as the reference's do; `dataclasses.replace(cfg,
    remat=False)` turns it off."""
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
    remat: bool = True                       # recompute layers in backward

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def segments(self) -> List[Tuple[Tuple[str, ...], int]]:
        """The reference's layer layout of the decoder: (unit of block
        kinds, repeats) pairs — dense, gemma2's alternating local/global
        layers, MoE after `n_dense_layers` dense ones, zamba2's Mamba2
        layers with the shared attention block every `attn_every`-th,
        xlstm's mLSTM layers with an sLSTM every `slstm_every`-th, and the
        audio family's "encdec" layers (its `encoder_layers` "enc" blocks
        are the `encoder` stack, outside this layout)."""
        if self.family == "audio":
            return [(("encdec",), self.n_layers)]
        for every, kinds in ((self.attn_every, ("mamba", "shared_attn")),
                             (self.slstm_every, ("mlstm", "slstm"))):
            if every:
                if self.n_layers % every:
                    raise ValueError(f"{self.name}: {self.n_layers} layers "
                                     f"is not a multiple of {every}")
                unit = (kinds[0],) * (every - 1) + (kinds[1],)
                return [(unit, self.n_layers // every)]
        if self.local_global:
            if self.n_layers % 2:
                raise ValueError(f"{self.name}: local/global attention "
                                 f"needs an even layer count, not "
                                 f"{self.n_layers}")
            return [(("dense_local", "dense_global"), self.n_layers // 2)]
        if self.n_experts:
            segs = []
            if self.n_dense_layers:
                segs.append((("dense",), self.n_dense_layers))
            segs.append((("moe",), self.n_layers - self.n_dense_layers))
            return segs
        return [(("dense",), self.n_layers)]

    def block_kinds(self) -> List[str]:
        """Each layer's block kind, in layer order."""
        return [kind for unit, n in self.segments() for _ in range(n)
                for kind in unit]


_MLP_KINDS = ("swiglu", "geglu", "gelu")
_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def has_recurrent(cfg: ModelConfig) -> bool:
    """True when some layer keeps a recurrent state (mamba, mlstm or
    slstm): its cached path advances one token a row per launch."""
    return any(k in RECURRENT_KINDS for k in cfg.block_kinds())


def has_cross_attention(cfg: ModelConfig) -> bool:
    """True for the encoder-decoder family: its decoder layers read the
    encoder's memory, which belongs to a batch row (a serving slot)."""
    return "encdec" in cfg.block_kinds()


def _check_supported(cfg: ModelConfig) -> None:
    unported = []
    if cfg.family not in _FAMILIES:
        unported.append(f"family {cfg.family!r}")
    if cfg.norm not in _NORMS:
        unported.append(f"norm {cfg.norm!r}")
    if cfg.mlp_kind not in _MLP_KINDS:
        unported.append(f"mlp {cfg.mlp_kind!r}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported; the port runs "
            f"the reference's families {_FAMILIES} (ROADMAP.md, A)")
    if cfg.family == "audio" and cfg.encoder_layers < 1:
        raise ValueError(f"{cfg.name}: an audio config needs an encoder "
                         f"(encoder_layers {cfg.encoder_layers})")


def _layer_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    """The attention window of a layer of `kind` (the reference's rule): a
    local layer, or a dense layer of a config without local/global
    alternation, attends within `sliding_window`; a global layer (and an
    MoE layer) over its whole causal prefix."""
    if kind == "dense_local" or (kind == "dense" and cfg.sliding_window
                                 and not cfg.local_global):
        return cfg.sliding_window
    return None


class DenseBlock(nn.Module):
    """Pre-norm block of one layer kind ("dense", "dense_local",
    "dense_global", "moe", zamba2's "shared_attn", a dense block whose
    one instance serves every shared position, or the audio encoder's
    "enc", whose attention is non-causal): x + attn(ln1(x)), then +
    ffn(ln2(x)), the
    ffn an `MLP` of `cfg.mlp_kind` or, for "moe", the `MoE` layer
    (attribute `moe`); optional post-norms (pn1/pn2) on each branch. The
    norms are `cfg.norm`'s."""

    def __init__(self, cfg: ModelConfig, kind: str = "dense", *, gen=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        nkw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.causal = kind != "enc"
        self.ln1 = norm(cfg.norm, d, **nkw)
        self.attn = Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
            rope_theta=cfg.rope_theta, window=_layer_window(cfg, kind),
            softcap=cfg.softcap_attn, gen=gen, device=device, dtype=dtype,
            policy=cfg.quant)
        self.ln2 = norm(cfg.norm, d, **nkw)
        self.mlp = self.moe = None
        if kind == "moe":
            self.moe = MoE(d, cfg.d_ff, cfg.n_experts, cfg.top_k,
                           n_shared=cfg.n_shared_experts,
                           capacity_factor=cfg.capacity_factor, gen=gen,
                           device=device, dtype=dtype, policy=cfg.quant)
        else:
            self.mlp = MLP(d, cfg.d_ff if cfg.d_ff else 4 * d, cfg.mlp_kind,
                           gen=gen, device=device, dtype=dtype,
                           policy=cfg.quant)
        self.pn1 = self.pn2 = None
        if cfg.post_norm:
            self.pn1 = norm(cfg.norm, d, **nkw)
            self.pn2 = norm(cfg.norm, d, **nkw)

    def forward(self, x: torch.Tensor, *, cache=None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (x, the MoE aux loss or None)."""
        h = self.attn(self.ln1(x), causal=self.causal, cache=cache,
                      lengths=lengths)
        if self.pn1 is not None:
            h = self.pn1(h)
        x = x + h
        aux = None
        if self.moe is not None:
            h, aux = self.moe(self.ln2(x))
        else:
            h = self.mlp(self.ln2(x))
        if self.pn2 is not None:
            h = self.pn2(h)
        return x + h, aux


class EncDecBlock(nn.Module):
    """The audio decoder's layer ("encdec"): x + attn(ln1(x)), causal
    self-attention over the layer's KV cache (RoPE, no bias, window or
    softcap, as the reference's), then + xattn(lnx(x), memory), the
    `CrossAttention` over the encoder's output, then + mlp(ln2(x))."""

    kind = "encdec"

    def __init__(self, cfg: ModelConfig, *, gen=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        nkw = dict(device=device, dtype=dtype)
        kw = dict(gen=gen, device=device, dtype=dtype, policy=cfg.quant)
        self.ln1 = norm(cfg.norm, d, **nkw)
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              rope_theta=cfg.rope_theta, **kw)
        self.lnx = norm(cfg.norm, d, **nkw)
        self.xattn = CrossAttention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                    **kw)
        self.ln2 = norm(cfg.norm, d, **nkw)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_kind, **kw)

    def forward(self, x: torch.Tensor, *, memory: torch.Tensor, cache=None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        x = x + self.attn(self.ln1(x), cache=cache, lengths=lengths)
        x = x + self.xattn(self.lnx(x), memory)
        return x + self.mlp(self.ln2(x)), None


class RecurrentBlock(nn.Module):
    """Pre-norm residual block of a recurrent kind: x + mixer(ln(x)), the
    mixer an `ssm.Mamba2` ("mamba"), `ssm.MLSTM` ("mlstm") or `ssm.SLSTM`
    ("slstm"), held under the kind's name. With a cache the mixer takes
    one step and the cache's fields are rebound to its new state, except
    on rows with lengths == 0, which keep theirs."""

    def __init__(self, cfg: ModelConfig, kind: str, *, gen=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(gen=gen, device=device, dtype=dtype)
        d = cfg.d_model
        self.kind = kind
        self.ln = norm(cfg.norm, d, device=device, dtype=dtype)
        if kind == "mamba":
            mixer = ssm.Mamba2(d, cfg.ssm_state, cfg.ssm_expand,
                               cfg.ssm_headdim, **kw)
        elif kind == "mlstm":
            mixer = ssm.MLSTM(d, cfg.n_heads, **kw)
        elif kind == "slstm":
            mixer = ssm.SLSTM(d, cfg.n_heads, **kw)
        else:
            raise ValueError(f"not a recurrent block kind: {kind!r}")
        setattr(self, kind, mixer)

    @property
    def mixer(self) -> nn.Module:
        return getattr(self, self.kind)

    def forward(self, x: torch.Tensor, *, cache=None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        h = self.ln(x)
        if cache is None:
            h, _ = self.mixer(h)
            return x + h, None
        h, new = self.mixer.step(h, cache)
        for f in dataclasses.fields(cache):
            value = getattr(new, f.name)
            if lengths is not None:
                value = ssm.where_rows(lengths > 0, value,
                                       getattr(cache, f.name))
            setattr(cache, f.name, value)
        return x + h, None


class Transformer(nn.Module):
    """Embedding (+ a learned position table `pos` (max_seq, d_model) with
    cfg.learned_pos) -> one block per layer, of the kinds
    `cfg.block_kinds()` (a DenseBlock, a RecurrentBlock or an EncDecBlock;
    zamba2's one shared DenseBlock at each "shared_attn" position) ->
    final norm -> unembedding (tied to the embedding table, or an lm_head
    Linear). The audio family also holds the `encoder`, a ModuleList of
    `encoder_layers` "enc" DenseBlocks, and its `enc_norm` (None
    elsewhere)."""

    def __init__(self, cfg: ModelConfig, *, gen=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.pos = None
        if cfg.learned_pos:
            self.pos = _normal((cfg.max_seq, cfg.d_model), 0.01, gen, device,
                               dtype)
        self.encoder = self.enc_norm = None
        if cfg.family == "audio":
            self.encoder = nn.ModuleList(
                DenseBlock(cfg, "enc", **kw)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = norm(cfg.norm, cfg.d_model, device=device,
                                 dtype=dtype)
        blocks, shared_attn = [], None
        for kind in cfg.block_kinds():
            if kind in RECURRENT_KINDS:
                blocks.append(RecurrentBlock(cfg, kind, **kw))
            elif kind == "encdec":
                blocks.append(EncDecBlock(cfg, **kw))
            elif kind == "shared_attn":
                if shared_attn is None:
                    shared_attn = DenseBlock(cfg, kind, **kw)
                blocks.append(shared_attn)
            else:
                blocks.append(DenseBlock(cfg, kind, **kw))
        self.layers = nn.ModuleList(blocks)
        self.final_norm = norm(cfg.norm, cfg.d_model, device=device,
                               dtype=dtype)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab, **kw)

    def trainable_(self, flag: bool = True) -> "Transformer":
        """Turn gradients on (or off) for every parameter, in place, and
        return the model. The parameters are the dense float weights, each a
        leaf of the reference's param pytree (`bridge.params_to_jax` maps
        them); rope tables, resident codes and caches are buffers or plain
        tensors and stay so. A model with resident weights is refused:
        codes are not trainable."""
        if flag and resident_format(self) is not None:
            raise ValueError(
                f"{self.cfg.name}: the Linears hold resident "
                f"{resident_format(self)} codes, which are not trainable; "
                "train the dense model and quantize it afterwards")
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (f32). Under a mesh a vocab-sharded table or a
        column-parallel lm_head gives this rank's vocab slice, all-gathered
        over "model"."""
        table = (self.embed.shards or {}).get("table")
        if self.lm_head is None and table is not None:
            logits = all_gather(linear(x, self.embed.table.t()), -1,
                                table[1], site="unembed")
        elif self.lm_head is None:
            logits = linear(x, self.embed.table.t())
        elif self.lm_head.tp == "col" and not self.lm_head.policy.active:
            logits = all_gather(self.lm_head.local(x), -1,
                                self.lm_head.shards["w"][1], site="unembed")
        else:
            logits = self.lm_head(x)
        logits = logits.to(torch.float32)
        cap = self.cfg.softcap_final
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits


# Module paths whose Linears stay dense: those that never receive the
# model's QuantPolicy in the reference (its `_RESIDENT_SKIP`: `lm_head`, and
# the MoE layer wholesale). Embeddings and norms are not Linears.
_RESIDENT_SKIP = ("router", "mamba", "mlstm", "slstm", "lm_head", "moe")
# Of those, the Linears that do take the model's QuantPolicy (the MoE
# shared expert): the reference's resident engine pins that policy to the
# residency format, so they fake-quantize their weights in it, the same
# math as resident codes.
_PINNED = ("shared",)


@torch.no_grad()
def quantize_params(model: Transformer, fmt: str, *,
                    skip=_RESIDENT_SKIP) -> Transformer:
    """Make each policy-covered Linear's weight resident in `fmt` (int4
    packed two per byte along K, int8/fp8 codes; per-output-channel pow2
    scales), IN PLACE: each dense weight is freed as its codes are built,
    so the device never holds both. Linears already resident are left as
    they are; skipped Linears under `_PINNED` paths fake-quantize their
    weights in `fmt` from then on. Returns `model`."""
    if fmt not in F.RESIDENT_FORMATS:
        raise ValueError(f"resident weight format {fmt!r} not in "
                         f"{F.RESIDENT_FORMATS}")
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear) or mod.fmt is not None:
            continue
        path = set(name.split("."))
        if not path & set(skip):
            mod.quantize_(fmt)
        elif path & set(_PINNED):
            mod.policy = dataclasses.replace(mod.policy, weights=fmt,
                                             resident=True)
    return model


def _shallow_copy(mod: nn.Module, memo: Optional[dict] = None
                  ) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer
    tensor: each module is copied with its own parameter, buffer and child
    tables, so replacing an entry in the copy leaves the original alone. A
    module the tree holds at several places (zamba2's shared block) is
    copied once, and the copy holds it at the same places."""
    memo = {} if memo is None else memo
    if id(mod) in memo:
        return memo[id(mod)]
    new = memo[id(mod)] = copy.copy(mod)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    new._non_persistent_buffers_set = set(mod._non_persistent_buffers_set)
    new._modules = {name: None if child is None
                    else _shallow_copy(child, memo)
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


def _sinusoid(length: int, d: int, *, device) -> torch.Tensor:
    """The encoder's fixed (length, d) float32 position table: sin then
    cos of pos / 10000^(i / (d/2)), i < d/2 (the reference's)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / (d // 2)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """The audio encoder over frame embeddings (B, T, d_model): frames +
    the sinusoid positions, the non-causal "enc" blocks (RoPE at arange(T)
    inside their attention, as the reference's uncached attention), then
    `enc_norm` -> the cross-attention memory (B, T, d_model). The serving
    engine runs it once, at construction."""
    if model.encoder is None:
        raise ValueError(f"{model.cfg.name} has no encoder")
    if frames is None:
        raise ValueError(f"{model.cfg.name}: the encoder needs frames "
                         "(B, T, d_model)")
    x = frames + _sinusoid(frames.shape[1], model.cfg.d_model,
                           device=frames.device).to(frames.dtype)
    for layer in model.encoder:
        x, _ = layer(x)
    return model.enc_norm(x)


def _units(cfg: ModelConfig):
    """(start, stop) layer indices of each unit of the reference's layer
    scan (`cfg.segments()`): the span one scan step, and so one
    rematerialized piece, covers."""
    start = 0
    for unit, n in cfg.segments():
        for _ in range(n):
            yield start, start + len(unit)
            start += len(unit)


def _remat(model: Transformer, x: torch.Tensor, caches) -> bool:
    """The reference's rule (`cfg.remat` and no caches), and a backward
    will happen: grad mode is on and the input or a parameter requires
    grad."""
    return (model.cfg.remat and caches is None and torch.is_grad_enabled()
            and (x.requires_grad
                 or any(p.requires_grad for p in model.parameters())))


def _run_unit(model: Transformer, x: torch.Tensor, sharded: bool,
              manual: bool, start: int, stop: int, caches, lengths, extra):
    """Layers start..stop-1; returns (x, sharded, their MoE aux or None)."""
    aux = None
    for i in range(start, stop):
        layer = model.layers[i]
        cache = None if caches is None else caches[i]
        if manual and getattr(layer, "kind", None) in MANUAL_KINDS \
                and layer.causal:
            if not sharded:
                x, sharded = seq_split(x, 1, "model"), True
            x, a = manual_layer(layer, x, model.cfg)
        else:
            if sharded:
                x, sharded = all_gather(x, 1, "model",
                                        site="tp_block.exit"), False
            x, a = layer(x, cache=cache, lengths=lengths, **extra)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, sharded, aux


def _run_layers(model: Transformer, x: torch.Tensor, caches=None,
                lengths=None, memory=None):
    """x through every decoder layer (with its cache, when given);
    returns (x, the summed MoE aux loss or None). Under `_remat` each unit
    of the layer scan is checkpointed; the backward's recompute runs its
    collectives again (all but the last, whose output no op saved), in the
    same order on every rank."""
    extra = {} if memory is None else {"memory": memory}
    if model.encoder is not None and memory is None:
        raise ValueError(f"{model.cfg.name}: the decoder needs the "
                         "encoder's memory (frames=, or memory=)")
    aux = None
    # the manual TP+SP block (tp_block.py): eligible layers run on this
    # rank's sequence slice; the residual is split before the first and
    # gathered back before any other layer and after the last
    manual = ctx_mesh() is not None and manual_tp_ok(
        model.cfg, x, None if caches is None else caches[0],
        model.cfg.quant, model)
    remat = _remat(model, x, caches)
    sharded = False
    for start, stop in _units(model.cfg):
        args = (model, x, sharded, manual, start, stop, caches, lengths,
                extra)
        if remat:
            x, sharded, a = checkpoint(_run_unit, *args, use_reentrant=False)
        else:
            x, sharded, a = _run_unit(*args)
        if a is not None:
            aux = a if aux is None else aux + a
    if sharded:
        x = all_gather(x, 1, "model", site="tp_block.exit")
    return x, aux


def forward(model: Transformer, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Full-sequence forward. tokens: (B, L) -> (logits (B, L, V), aux).
    aux is the MoE auxiliary loss summed over the layers (zero without
    MoE layers). prefix_embeds (B, P, d_model): the vision family's patch
    embeddings, prepended to the token embeddings (their positions are
    dropped before the unembedding); frames (B, T, d_model): the audio
    family's encoder input (`encode`). Learned positions add pos[:P + L]
    after the concatenation; gemma scales the embeddings by sqrt(d_model)
    here and not in `decode_step`, as the reference does."""
    cfg = model.cfg
    x = model.embed(tokens)
    memory = None if model.encoder is None else encode(model, frames)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
    if model.pos is not None:
        x = x + model.pos[:x.shape[1]]
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    x, aux = _run_layers(model, x, memory=memory)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    logits = model.unembed(model.final_norm(x))
    return logits, aux


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Causal-LM cross entropy (+ aux_weight x the MoE aux loss), the
    reference's `loss_fn`, differentiable (under `torch.no_grad()` a value
    whose attention may take the kernels). batch: "tokens" (B, L) and "labels"
    (B, L), optionally "frames" and "patch_embeds" (`forward`'s frames and
    prefix_embeds); labels < 0 (-100) mask a position out. Returns (loss +
    aux_weight * aux, {"loss": loss, "aux": aux})."""
    logits, aux = forward(model, batch["tokens"],
                          prefix_embeds=batch.get("patch_embeds"),
                          frames=batch.get("frames"))
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
                memory: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None):
    """One cached step. tokens: (B, l) -> (logits (B, l, V), caches).
    memory: the audio family's encoder output (B, T, d_model) (`encode`),
    which every decoder layer cross-attends; required there, unused
    elsewhere.

    l is 1 for a decode step; a chunked prefill passes a right-padded
    (B, l) block with `lengths` (B,) marking each row's valid-token count —
    rows with lengths[b] == 0 keep caches and positions untouched. The
    caches are updated in place (a recurrent cache's fields rebound) and
    returned for convenience. A model with recurrent blocks takes l == 1
    only (ValueError otherwise): its step recurrence reads one token a row.

    Learned positions add pos[clip(p_b + i, 0, max_seq - 1)] to token i of
    row b, p_b the first KV cache's position before the step (rows idling
    past the table clip; their logits are never read).
    """
    if tokens.shape[1] != 1 and has_recurrent(model.cfg):
        raise ValueError(
            f"{model.cfg.name}: a model with recurrent blocks decodes one "
            f"token a row per step, not {tokens.shape[1]}")
    x = model.embed(tokens)
    if model.pos is not None:
        idx = (kv_caches(caches)[0].pos[:, None].long()
               + torch.arange(tokens.shape[1], device=x.device)).clamp(
                   0, model.pos.shape[0] - 1)
        x = x + model.pos[idx]
    x, _ = _run_layers(model, x, caches, lengths, memory)
    return model.unembed(model.final_norm(x)), caches


def _recurrent_cache(kind: str, cfg: ModelConfig, batch: int, device):
    if kind == "mamba":
        return ssm.init_mamba_cache(batch, cfg.d_model, d_state=cfg.ssm_state,
                                    expand=cfg.ssm_expand,
                                    headdim=cfg.ssm_headdim, device=device)
    if kind == "mlstm":
        return ssm.init_mlstm_cache(batch, cfg.d_model, n_heads=cfg.n_heads,
                                    device=device)
    return ssm.init_slstm_cache(batch, cfg.d_model, device=device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda", dtype=torch.bfloat16,
                paged: Optional[Tuple[int, int]] = None,
                model: Optional[Transformer] = None) -> List:
    """One cache per layer: for an attention layer a KVCache (bf16 by
    default) or, with cfg.kv_quant, a QuantKVCache (int8 codes + pow2
    scales); for a recurrent layer its state (`ssm.MambaCache`,
    `MLSTMCache` or `SLSTMCache`, float32 whatever `dtype`: the reference's
    conv caches turn float32 at their first step, and its states are
    float32 from the start).

    paged: (pool_blocks, block_size) — block-pool PagedKVCache /
    PagedQuantKVCache attention layers instead, each with its own pool of
    pool_blocks blocks of block_size positions and all sharing ONE (batch,
    nblk) block table tensor, nblk = ceil(max_len / block_size); recurrent
    states keep their per-row layout.

    model: the model the caches serve. Each attention layer's cache then
    holds the KV heads that layer computes on this rank
    (`Attention.cache_heads`): n_kv / R under head parallelism (its
    q/k/v/o cut by `dist.shard_params` over R "model" ranks), all n_kv
    otherwise. Without it every layer holds all n_kv heads."""
    dev = resolve_device(device)
    kinds = cfg.block_kinds()
    heads = [cfg.n_kv_heads] * len(kinds) if model is None else [
        getattr(getattr(layer, "attn", None), "cache_heads",
                lambda: cfg.n_kv_heads)() for layer in model.layers]
    table = None
    if paged is not None:
        pool_blocks, block_size = paged
        table = striped_table(batch, -(-max_len // block_size), pool_blocks,
                              device=dev)
    caches = []
    for kind, n_kv in zip(kinds, heads):
        if kind in RECURRENT_KINDS:
            caches.append(_recurrent_cache(kind, cfg, batch, dev))
        elif table is None:
            caches.append(init_kv_cache(batch, n_kv, max_len, cfg.hd,
                                        device=dev, dtype=dtype,
                                        quantized=cfg.kv_quant))
        else:
            caches.append(init_paged_kv_cache(
                n_kv, pool_blocks, block_size, cfg.hd, table, dtype=dtype,
                quantized=cfg.kv_quant))
    return caches


_KV_TYPES = (KVCache, QuantKVCache) + PAGED_TYPES


def kv_caches(caches: List) -> List:
    """The attention layers' caches of a cache list, in layer order."""
    return [c for c in caches if isinstance(c, _KV_TYPES)]


def _check_cache(c) -> None:
    if not isinstance(c, _KV_TYPES + ssm.RECURRENT_TYPES):
        raise TypeError(f"not a KV cache or a recurrent state: "
                        f"{type(c).__name__}")


def _reinit_rows(c, mask: torch.Tensor) -> None:
    """Rebind a recurrent cache's fields with the rows under `mask` (B,)
    back at their initial values (`ssm.cache_init_values`)."""
    values = ssm.cache_init_values(c)
    mask = mask.to(device=getattr(c, next(iter(values))).device,
                   dtype=torch.bool)
    for name, value in values.items():
        old = getattr(c, name)
        setattr(c, name, ssm.where_rows(
            mask, torch.full((), value, dtype=old.dtype, device=old.device),
            old))


def reset_slots(caches: List, slot_mask: torch.Tensor,
                new_pos: Optional[torch.Tensor] = None) -> List:
    """Rewind cache rows (slots) where slot_mask (B,) is True to position 0
    (or new_pos), in place — the slot-refill primitive for continuous
    batching. Stale K/V sit beyond the new causal frontier, so attention
    never sees them, and each position is overwritten before the frontier
    reaches it. new_pos lets the paged engine start a row that shares a
    prompt prefix at the shared-token count. A recurrent state's rows go
    back to their initial values (zeros; the sLSTM stabilizer to
    `ssm.SLSTM_M_INIT`)."""
    for c in caches:
        _check_cache(c)
        if isinstance(c, ssm.RECURRENT_TYPES):
            _reinit_rows(c, slot_mask)
            continue
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
    quarantines the rows that share them). A recurrent state's rows go
    back to their initial values, as in `reset_slots`. No host sync."""
    for c in caches:
        _check_cache(c)
        if isinstance(c, ssm.RECURRENT_TYPES):
            _reinit_rows(c, slot_mask)
            continue
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
    """The attention layers' paged caches (recurrent states have no block
    pool); TypeError on a flat KV cache."""
    layers = kv_caches(caches)
    for c in layers:
        if not isinstance(c, PAGED_TYPES):
            raise TypeError(f"not a paged KV cache: {type(c).__name__}")
    return layers


def set_block_tables(caches: List, table: torch.Tensor) -> List:
    """Install a (B, nblk) block table, in place, into the one table tensor
    every paged cache layer shares (`init_caches` and
    `bridge.caches_from_jax` both build them so)."""
    layers = _paged(caches)
    shared = layers[0].table
    if any(c.table is not shared for c in layers):
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
    dev = kv_caches(caches)[0].pos.device
    s = torch.as_tensor(src, dtype=torch.long, device=dev)
    d = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for c in _paged(caches):
        for pool in _pools(c):
            pool[d] = pool[s]
    return caches


@torch.no_grad()
def gather_pool_blocks(caches: List, ids: torch.Tensor) -> dict:
    """Read physical pool blocks `ids` ((C,) int) out of every paged cache
    layer: {pool name: (n_kv_layers, C, Hkv, bs, X)} new tensors on the
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
