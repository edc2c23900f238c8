"""NN layers of the decoder: Linear, embedding, the norms (RMSNorm,
LayerNorm, OLMo's non-parametric LayerNorm), RoPE and the MLPs (SwiGLU,
GeGLU, GELU), as `nn.Module`s whose weights keep the JAX package's layout
(a Linear's weight is (d_in, d_out), applied as ``x @ w``).

Every Linear can route through the AIO quantized-matmul plane: under a
`QuantPolicy` it fake-quantizes its operands, and once made RESIDENT
(`Linear.quantize_`, which `transformer.quantize_params` calls) it holds a
`formats.QuantWeight` — int8 codes (int4 packed two per byte along K) and
per-output-channel pow2 scales, as registered buffers, the dense weight
freed — and dispatches through `api.ops.matmul_codes`.

Under a mesh (`dist.set_mesh`) a Linear, the embedding and the MLP run
model-parallel once `dist.shard_params` has cut their weights to this
rank's shards (`Linear.tp`): a column-parallel Linear keeps its local
output features for a consumer that takes them (`Linear.local`), a
row-parallel one all-reduces its partial sums over "model", the embedding
looks up its vocab slice and all-reduces. A consumer that needs the whole
output calls the Linear as usual: a column-parallel weight is all-gathered
and applied replicated, and a row-parallel Linear slices its input.

Initialization follows the JAX init scales (normal * d_in^-0.5 for a
Linear, normal * 0.02 for the embedding, ones for a norm gain, zeros for
a bias) from an
explicit `torch.Generator`; the values differ from `jax.random`'s, so a
test that compares the two packages copies one set of weights into both
(see `repro_torch.bridge`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import torch
from torch import nn

from .. import resolve_device
from ..api import ops as aio_ops
from ..core import formats as F
from ..dist.collectives import all_gather, all_reduce
from ..dist.sharding import axis_rank

__all__ = ["QuantPolicy", "Linear", "Embedding", "RMSNorm", "LayerNorm",
           "NonParamLayerNorm", "MLP", "linear", "norm", "rmsnorm",
           "layernorm", "rope"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which AIO format each tensor class runs in (paper Table II formats).

    resident: weights live as codes (`formats.QuantWeight`, built by
    `transformer.quantize_params`) instead of being fake-quantized from a
    dense float32 copy on every call. Linears the conversion leaves dense
    still fake-quantize under `weights`, the same math.
    """
    activations: str = "none"      # none | bf16 | fp8a | fp8b | int8 | int4
    weights: str = "none"
    resident: bool = False

    @property
    def active(self) -> bool:
        return (self.activations != "none" or self.weights != "none"
                or self.resident)


def _maybe_quant(x: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Per-tensor pow2-scaled fake-quant (the scale folds into the bias).
    The scale is taken from x detached (the reference's stop_gradient): the
    gradient passes through the STE only."""
    if fmt_name in ("none", "bf16"):
        return x
    scale = F.pow2_scale(x.detach(), F.REGISTRY[fmt_name])
    return F.fake_quant(x / scale, fmt_name) * scale


def _maybe_quant_weight(w: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Weight fake-quant with PER-OUTPUT-CHANNEL pow2 scales (axis=-2, the
    contraction axis of a (..., K, N) weight): the scale geometry of the
    resident codes, so `dequantize_weight(quantize_weight(w, f))` equals
    this bitwise. The scale is taken from w detached, as in
    `_maybe_quant`."""
    if fmt_name in ("none", "bf16"):
        return w
    scale = F.pow2_scale(w.detach(), F.REGISTRY[fmt_name], axis=-2)
    return F.fake_quant(w / scale, fmt_name) * scale


# Hooks every weight `_normal` makes passes through (the innermost, last
# one): `dist.specs.init_sharded` records the weights of a `meta` build,
# then cuts each weight of the real build to this rank's shard as soon as
# it is drawn.
_DRAW_HOOKS: List[Callable[[nn.Parameter], nn.Parameter]] = []


def _normal(shape, scale: float, gen: Optional[torch.Generator], device,
            dtype) -> nn.Parameter:
    if gen is None:                       # filled later (e.g. by the bridge)
        w = torch.zeros(shape, dtype=dtype, device=device)
    else:
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        w.mul_(scale)
    p = nn.Parameter(w, requires_grad=False)
    return _DRAW_HOOKS[-1](p) if _DRAW_HOOKS else p


def linear(x: torch.Tensor, w: Union[torch.Tensor, F.QuantWeight],
           b: Optional[torch.Tensor] = None,
           policy: QuantPolicy = QuantPolicy()) -> torch.Tensor:
    """x @ w, cast to x's dtype, then the bias. A resident `QuantWeight`
    goes through `api.ops.matmul_codes`; a dense weight is multiplied in
    float32 (fake-quantized first under an active policy)."""
    if isinstance(w, F.QuantWeight):
        x = _maybe_quant(x, policy.activations)
        y = aio_ops.matmul_codes(x, w).to(x.dtype)
    else:
        if policy.active:
            x = _maybe_quant(x, policy.activations)
            w = _maybe_quant_weight(w, policy.weights)
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(
            x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _rank_slice(t: torch.Tensor, dim: int, axis: str, n: int
                ) -> torch.Tensor:
    """This rank's slice of a tensor replicated over `axis` (n ranks)."""
    return t.chunk(n, dim=dim)[axis_rank(axis)]


class Linear(nn.Module):
    """A (d_in, d_out) Linear: a dense weight `w`, or — once `quantize_` or
    `set_resident` ran — resident codes in the buffers `w_codes` and
    `w_scale` (format `fmt`, contraction length `k`) with `w` freed.
    `dist.shard_params` may cut `w` to this rank's column (d_out) or row
    (d_in) shard and record it in `shards`; the bias stays whole."""

    shards = None

    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32, policy: QuantPolicy = QuantPolicy()):
        super().__init__()
        device = resolve_device(device)
        self.w = _normal((d_in, d_out), d_in ** -0.5, gen, device, dtype)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                              requires_grad=False) if bias else None
        self.policy = policy
        self.fmt: Optional[str] = None
        self.k = d_in

    @property
    def qweight(self) -> Optional[F.QuantWeight]:
        """The resident weight, or None while the weight is dense."""
        if self.fmt is None:
            return None
        return F.QuantWeight(self.w_codes, self.w_scale, self.fmt, self.k)

    def set_resident(self, qw: F.QuantWeight) -> None:
        """Hold `qw` as this Linear's weight and free the dense one."""
        if qw.codes.dim() != 2 or qw.k != self.k:
            raise ValueError(f"resident weight {tuple(qw.codes.shape)} (k "
                             f"{qw.k}) does not fit a Linear of d_in {self.k}")
        self.w = None
        self.register_buffer("w_codes", qw.codes)
        self.register_buffer("w_scale", qw.scale)
        self.fmt = qw.fmt

    @torch.no_grad()
    def quantize_(self, fmt: str) -> None:
        """Convert the dense weight into resident codes in `fmt`, in place."""
        self.set_resident(F.quantize_weight(self.w, fmt))

    @property
    def tp(self) -> Optional[str]:
        """"col" or "row" when `w` is this rank's shard, else None."""
        s = (self.shards or {}).get("w")
        return None if s is None else ("col" if s[0] == -1 else "row")

    def weight_full(self) -> torch.Tensor:
        """The whole dense weight (all-gathered when sharded)."""
        s = (self.shards or {}).get("w")
        if s is None:
            return self.w
        return all_gather(self.w, s[0], s[1], site="weight")

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The model-parallel product of a sharded Linear. Column-parallel:
        x (whole features) -> this rank's output features, plus its slice
        of the bias. Row-parallel: x (this rank's input features) -> the
        whole output, the partial sums all-reduced over the axis, then the
        bias."""
        dim, axis, n = self.shards["w"]
        if dim == -1:
            b = None if self.b is None else _rank_slice(self.b, -1, axis, n)
            return linear(x, self.w, b, self.policy)
        y = all_reduce(linear(x, self.w, None, self.policy), axis,
                       site="row")
        return y if self.b is None else y + self.b.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.qweight
        if w is None and self.tp is not None:
            if self.tp == "row" and not self.policy.active:
                _, axis, n = self.shards["w"]
                return self.local(_rank_slice(x, -1, axis, n))
            # a per-tensor quantization scale needs the whole operands
            return linear(x, self.weight_full(), self.b, self.policy)
        return linear(x, self.w if w is None else w, self.b, self.policy)


class Embedding(nn.Module):
    """The (vocab, d_model) table; vocab-parallel once `dist.shard_params`
    cut it to this rank's rows (`shards["table"]`): each rank looks up the
    tokens of its slice, zeros elsewhere, and the rows are all-reduced."""

    shards = None

    def __init__(self, vocab: int, d_model: int, *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.table = _normal((vocab, d_model), 0.02, gen, device, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = (self.shards or {}).get("table")
        if s is None:
            return self.table[tokens]
        _, axis, _ = s
        rows = self.table.shape[0]
        ids = tokens - axis_rank(axis) * rows
        inside = (ids >= 0) & (ids < rows)
        e = self.table[ids.clamp(0, rows - 1)]
        e = torch.where(inside[..., None], e, torch.zeros_like(e))
        return all_reduce(e, axis, site="embed")


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


def layernorm(x: torch.Tensor, g: Optional[torch.Tensor] = None,
              b: Optional[torch.Tensor] = None, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm computed in f32 over the population variance (as
    `jnp.var`), then the gain and bias when given, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if g is not None:
        y = y * g + b
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with a gain `g` (ones) and a bias `b` (zeros), eps 1e-5."""

    def __init__(self, d: int, *, device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.g, self.b)


class NonParamLayerNorm(nn.Module):
    """OLMo's non-parametric LayerNorm: no gain, no bias, eps 1e-5."""

    def __init__(self, d: int, *, device="cuda", dtype=torch.float32):
        super().__init__()
        resolve_device(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x)


_NORMS = {"rmsnorm": RMSNorm, "layernorm": LayerNorm,
          "nonparam_ln": NonParamLayerNorm}


def norm(kind: str, d: int, *, device="cuda",
         dtype=torch.float32) -> nn.Module:
    """The norm of a config's `norm` kind (the reference's `norm_init` /
    `apply_norm` pair)."""
    if kind not in _NORMS:
        raise ValueError(f"norm {kind!r} not in {sorted(_NORMS)}")
    return _NORMS[kind](d, device=device, dtype=dtype)


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
    """The feed-forward of `kind`: "swiglu" down(silu(gate(x)) * up(x)),
    "geglu" down(gelu(gate(x)) * up(x)), or "gelu" fc2(gelu(fc1(x))) with
    biases. GELU is the tanh approximation (`jax.nn.gelu`'s default)."""

    def __init__(self, d_model: int, d_ff: int, kind: str = "swiglu", *,
                 gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32, policy: QuantPolicy = QuantPolicy()):
        super().__init__()
        kw = dict(gen=gen, device=resolve_device(device), dtype=dtype,
                  policy=policy)
        self.kind = kind
        if kind in ("swiglu", "geglu"):
            self.gate = Linear(d_model, d_ff, **kw)
            self.up = Linear(d_model, d_ff, **kw)
            self.down = Linear(d_ff, d_model, **kw)
        elif kind == "gelu":
            self.fc1 = Linear(d_model, d_ff, True, **kw)
            self.fc2 = Linear(d_ff, d_model, True, **kw)
        else:
            raise ValueError(f"mlp {kind!r} not in ('swiglu', 'geglu', "
                             "'gelu')")

    @property
    def out_proj(self) -> Linear:
        """The projection back to d_model (down, or fc2)."""
        return self.fc2 if self.kind == "gelu" else self.down

    def _tp_local(self) -> bool:
        """Column-parallel in, row-parallel out, and no quantization: the
        hidden features stay local and one all-reduce closes the MLP."""
        ins = (self.fc1,) if self.kind == "gelu" else (self.gate, self.up)
        return (all(m.tp == "col" for m in ins)
                and self.out_proj.tp == "row"
                and not any(m.policy.active for m in ins + (self.out_proj,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._tp_local():
            if self.kind == "gelu":
                return self.fc2.local(torch.nn.functional.gelu(
                    self.fc1.local(x), approximate="tanh"))
            g = self.gate.local(x)
            act = (torch.nn.functional.silu(g) if self.kind == "swiglu"
                   else torch.nn.functional.gelu(g, approximate="tanh"))
            return self.down.local(act * self.up.local(x))
        if self.kind == "gelu":
            return self.fc2(torch.nn.functional.gelu(self.fc1(x),
                                                     approximate="tanh"))
        act = (torch.nn.functional.silu(self.gate(x)) if self.kind == "swiglu"
               else torch.nn.functional.gelu(self.gate(x), approximate="tanh"))
        return self.down(act * self.up(x))
