"""The public op surface: one call, one policy object.

Every op resolves the active ExecutionPolicy (innermost `policy` context,
overridden by per-call keywords), maps the call to a registry impl key and
dispatches.

    from repro_torch import api
    out = api.ops.attention(q, k, v, offset=pos)          # default policy
    with api.policy(backend="ref"):
        out = api.ops.attention(q, k, v, offset=pos)      # plain reference
    y = api.ops.matmul_codes(x, qweight)                  # resident weight
    outs, util = api.ops.morphable_multi_gemm([(x1, w1), (x2, w2)])
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .policy import ExecutionPolicy, current_policy
from .registry import registry

__all__ = ["attention", "attention_route", "matmul", "matmul_codes",
           "quantize", "grouped_matmul", "morphable_multi_gemm",
           "depthwise_conv", "DECODE_MAX_LQ"]

# Longest query the flash-decode kernel takes on the scalar-offset
# cache-shaped route; per-row-offset multi-token chunks go to the varlen
# prefill kernel instead (see attention_route).
DECODE_MAX_LQ = 8


def _resolve(policy: Optional[ExecutionPolicy],
             **overrides) -> ExecutionPolicy:
    base = policy if policy is not None else current_policy()
    return base.override(**overrides)


def _check_device(pol: ExecutionPolicy, x: torch.Tensor) -> None:
    if pol.backend == "cuda" and x.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {x.device}")


def _dispatch(op_name: str, pol: ExecutionPolicy, x: torch.Tensor, *args):
    _check_device(pol, x)
    return registry.lookup(op_name, pol.impl())(x, *args, policy=pol)


def matmul(x: torch.Tensor, w: torch.Tensor, *, format: Optional[str] = None,
           backend: Optional[str] = None,
           policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Quantize (M, K) x (K, N) float operands to the policy format
    (per-row / per-column pow2 scales) and multiply: the AIO GEMM on the
    kernel route, the plain oracle on "ref". The output is float32."""
    pol = _resolve(policy, format=format, backend=backend)
    return _dispatch("matmul", pol, x, w)


def matmul_codes(x: torch.Tensor, wq, *, backend: Optional[str] = None,
                 policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Matmul against a RESIDENT quantized weight (`formats.QuantWeight`,
    built once by `transformer.quantize_params`). x: (..., K).

    The kernel route quantizes the activations per row to the weight's
    format (the quantizer kernel) and runs the AIO GEMM on the stored
    codes; the "ref" route multiplies float32 activations by the
    dequantized weight. The two are different functions, as in the
    reference. The weight's format rides in `wq.fmt`; the policy's
    `format` is ignored here. The output is float32."""
    if x.shape[-1] != wq.k:
        raise ValueError(f"activation K {x.shape[-1]} != resident weight K "
                         f"{wq.k} (format {wq.fmt!r})")
    pol = _resolve(policy, backend=backend)
    return _dispatch("matmul_codes", pol, x, wq)


def quantize(x: torch.Tensor, *, format: Optional[str] = None,
             backend: Optional[str] = None,
             policy: Optional[ExecutionPolicy] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, N) -> (codes int8 (M, N), per-row pow2 scale (M, 1)): the
    quantizer kernel (floor 1e-30, as the reference's kernel) or
    `quantize_scaled` on "ref"."""
    pol = _resolve(policy, format=format, backend=backend)
    return _dispatch("quantize", pol, x)


def attention_route(*, lq: int, lk: Optional[int] = None, causal: bool = True,
                    offset_ndim: int = 0, quantized: bool = False,
                    grad: bool = False, backend: Optional[str] = None,
                    policy: Optional[ExecutionPolicy] = None) -> str:
    """Which attention impl a call with this shape dispatches to.

    grad: the call is recorded by autograd (`attention` sets it when grad
    mode is on and q, k or v requires grad). The kernels are forward-only,
    so such a call goes to the differentiable "ref" route whatever its
    shape: the reference's rule that a training forward stays on its ref
    path (its `jax.grad` cannot go through the full-sequence Pallas
    kernel), extended to the port's default kernel backend. With
    grad=False the table below holds.

    This IS the rule `attention` uses. Under a kernel backend, causal
    attention over a cache routes to the serving kernels: multi-token
    (Lq > 1) per-row-offset chunks (the engine's chunked admission prefill)
    to "cuda-prefill", short queries (Lq <= DECODE_MAX_LQ, the decode step)
    to "cuda-decode". Cache-shaped means lk > lq or a per-row offset vector.
    Unquantized 128-aligned scalar-offset calls that are not those (the
    full-sequence forward's attention, causal or not, and cache-shaped
    calls too long for decode) go to the full-sequence flash kernel,
    "cuda". Everything else goes to "ref" (the reference's rule, name for
    name: "pallas" -> "cuda", "pallas-decode" -> "cuda-decode",
    "pallas-prefill" -> "cuda-prefill").
    """
    pol = _resolve(policy, backend=backend)
    if pol.use_kernels() and not grad:
        cache_shaped = offset_ndim == 1 or (lk is not None and lk > lq)
        if causal and cache_shaped:
            if offset_ndim == 1 and lq > 1:
                return "cuda-prefill"
            if lq <= DECODE_MAX_LQ:
                return "cuda-decode"
        if not quantized and lq % 128 == 0 and offset_ndim == 0:
            return "cuda"
    return "ref"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              offset=0, lengths: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              bkv: Optional[int] = None, bq: Optional[int] = None,
              backend: Optional[str] = None,
              block_tables: Optional[torch.Tensor] = None,
              policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """GQA attention. q: (B,Hq,Lq,D); k,v: (B,Hkv,Lk,D).

    offset: scalar or per-row (B,) cache position. lengths: per-row (B,)
    valid query count of a right-padded chunk (None = all valid); the varlen
    prefill kernel returns exact zeros past it. k_scale/v_scale: when given,
    k/v are int8 codes with per-position pow2 scales (B,Hkv,Lk,1) f32 —
    dequantized inside the kernels, or at dispatch on the ref route.
    block_tables: when given, k/v (and the scales) are (P, Hkv, bs, .)
    block pools and block_tables the (B, nblk) int32 per-row block map: the
    kernels read through it, the ref route gathers `pool[table]`; the cache
    length is nblk * bs.
    """
    pol = _resolve(policy, backend=backend, bkv=bkv, bq=bq)
    if pol.backend == "cuda" and q.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {q.device}")
    offset_ndim = offset.dim() if isinstance(offset, torch.Tensor) else 0
    lk = k.shape[2] if block_tables is None \
        else block_tables.shape[1] * k.shape[2]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    impl = attention_route(lq=q.shape[2], lk=lk, causal=causal,
                           offset_ndim=offset_ndim,
                           quantized=k_scale is not None, grad=grad,
                           policy=pol)
    if block_tables is not None and impl == "cuda":
        impl = "ref"    # no paged route on the full-sequence kernel
    fn = registry.lookup("attention", impl)
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale, offset=offset, lengths=lengths, k_scale=k_scale,
              v_scale=v_scale, block_tables=block_tables, policy=pol)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: Sequence[int], *, bm: Optional[int] = None,
                   bn: Optional[int] = None, bk: Optional[int] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   backend: Optional[str] = None,
                   policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """x (T, K) rows sorted by group; w (G, K, N); group_sizes (each a
    multiple of bm) sums to T. out[t] = x[t] @ w[group of t], f32
    accumulation, out_dtype output (K and N are padded to bk and bn)."""
    pol = _resolve(policy, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                   backend=backend)
    return _dispatch("grouped_matmul", pol, x, w, tuple(group_sizes))


def morphable_multi_gemm(tenants, *, bm: Optional[int] = None,
                         bn: Optional[int] = None, bk: Optional[int] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         backend: Optional[str] = None,
                         policy: Optional[ExecutionPolicy] = None):
    """Run unrelated tenant GEMMs [(x_i (M_i, K_i), w_i (K_i, N_i)), ...]
    in ONE grouped launch; returns (results, mac_utilization): each
    tenant's (M_i, N_i) product, and useful MACs over the MACs of the
    packed launch (the paper's Fig 14 metric)."""
    pol = _resolve(policy, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                   backend=backend)
    for x, _ in tenants:
        _check_device(pol, x)
    from ..kernels.grouped_matmul.ops import multi_gemm_with_policy
    return multi_gemm_with_policy(tenants, pol)


def depthwise_conv(x: torch.Tensor, filt: torch.Tensor, *,
                   backend: Optional[str] = None,
                   policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """x: (N, H, W, C); filt: (kh, kw, C); stride-1 SAME depthwise conv."""
    pol = _resolve(policy, backend=backend)
    return _dispatch("depthwise_conv", pol, x, filt)
