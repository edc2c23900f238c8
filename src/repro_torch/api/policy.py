"""ExecutionPolicy: the one object that says how every op runs.

The backend plane picks between the hand-written CUDA kernels and the plain
PyTorch reference; the format plane names the AIO number format of the
quantized matmul and quantize ops; the tiling plane carries the attention
kernels' block lengths and the grouped GEMM's tile sizes. Policies are
frozen, so one engine pins one policy for its whole life.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Iterator, Optional

import torch

__all__ = ["ExecutionPolicy", "policy", "current_policy", "default_policy",
           "TILE_FIELDS", "REPRESENTATIVE_TILES", "policy_sweep"]

_BACKENDS = ("auto", "cuda", "ref")
# formats of the quantized-matmul / quantize plane (formats.REGISTRY names)
_FORMATS = ("bf16", "fp8a", "fp8b", "int8", "int4", "fp16", "uint8", "uint4")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How ops dispatched through repro_torch.api execute.

    backend: "auto" routes to the kernels; each kernel wrapper launches its
             CUDA kernel on CUDA tensors and runs its plain PyTorch version
             on CPU tensors. "cuda" routes to the kernels and refuses CPU
             tensors. "ref" runs the plain eager reference (`mha_ref`,
             `chunked_attention` past 4096 x 8192 scores) on whatever
             device the tensors are on.
    format:  AIO number format of the `matmul` and `quantize` ops
             (`matmul_codes` takes its weight's).
    bkv:     the reference's KV block length of flash-decode, checked by
             the decode wrappers (a multiple of 32); the kernel's key walk
             is fixed by its split plan (`decode.decode_plan`), so it no
             longer changes the launch.
    bq:      q-block length of the varlen flash-prefill kernel.
    chunk:   key-block length of the long `ref` attention
             (`chunked_attention`, which the ref route takes past
             4096 x 8192 scores).
    bm/bn/bk: tile sizes of the grouped GEMM: every group's row count must
             be a multiple of bm (`make_group_ids`), and K and N are padded
             to bk and bn (`pack_tenants`, so the MAC utilization that
             `morphable_multi_gemm` reports depends on them).
    out_dtype: output dtype of the grouped GEMM (f32 accumulation).
    """
    format: str = "bf16"
    backend: str = "auto"
    bm: int = 128
    bn: int = 128
    bk: int = 128
    bkv: int = 128
    bq: int = 32
    chunk: int = 1024
    out_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {_BACKENDS}")
        if self.format not in _FORMATS:
            raise ValueError(f"format {self.format!r} not in {_FORMATS}")
        tiles = dict(bm=self.bm, bn=self.bn, bk=self.bk, bkv=self.bkv,
                     bq=self.bq, chunk=self.chunk)
        if min(tiles.values()) < 1:
            raise ValueError(f"tile lengths must be >= 1 ({tiles})")
        if not (isinstance(self.out_dtype, torch.dtype)
                and self.out_dtype.is_floating_point):
            raise ValueError(f"out_dtype {self.out_dtype!r} is not a float "
                             "dtype")

    def use_kernels(self) -> bool:
        """True when shape-eligible calls route to the kernel impls."""
        return self.backend != "ref"

    def impl(self) -> str:
        """Registry impl key of the matmul and quantize ops."""
        return "cuda" if self.use_kernels() else "ref"

    def override(self, **overrides) -> "ExecutionPolicy":
        """A copy with the non-None overrides applied (per-call kwargs)."""
        effective = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **effective) if effective else self

    def demoted(self) -> "ExecutionPolicy":
        """The safe-route copy of this policy: backend re-pinned to "ref"
        (the plain eager reference every kernel is held to), every other
        plane untouched. The serving engine installs it when a launch
        raises the fault plans' `KernelLaunchError`, and retries the step
        down the reference route with the formats and tiling it pinned."""
        return dataclasses.replace(self, backend="ref")


default_policy = ExecutionPolicy()

# The tiling plane of the policy: the fields the kernel wrappers read.
# `repro_torch.analysis` sweeps the launch contracts over these;
# REPRESENTATIVE_TILES are the values a sweep takes (the default, then a
# smaller tile the tests and the serving configs use). bkv stays a multiple
# of 32, the only bkv the decode wrappers take.
TILE_FIELDS = ("bm", "bn", "bk", "bkv", "bq")
REPRESENTATIVE_TILES = {
    "bm": (128, 64), "bn": (128, 64), "bk": (128, 64),
    "bkv": (128, 32), "bq": (32, 8),
}


def policy_sweep(fields, base: Optional[ExecutionPolicy] = None,
                 values: Optional[dict] = None):
    """The ExecutionPolicies of a sweep over the named tile fields: the
    cartesian product of each field's values (from `values`, else
    REPRESENTATIVE_TILES) applied over `base` (the default policy when
    omitted), in the order of `fields` and of each field's values."""
    base = base if base is not None else default_policy
    table = values if values is not None else REPRESENTATIVE_TILES
    fields = tuple(fields)
    for f in fields:
        if f not in TILE_FIELDS:
            raise ValueError(f"{f!r} is not a tile field {TILE_FIELDS}")
    grids = [table[f] for f in fields]
    return tuple(base.override(**dict(zip(fields, combo)))
                 for combo in itertools.product(*grids))

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_policy() -> ExecutionPolicy:
    """The innermost installed policy (the default one outside any context)."""
    stack = _stack()
    return stack[-1] if stack else default_policy


@contextlib.contextmanager
def policy(base: Optional[ExecutionPolicy] = None,
           **overrides) -> Iterator[ExecutionPolicy]:
    """Install an ExecutionPolicy for every op inside the block.

        with repro_torch.api.policy(backend="ref"):
            out = repro_torch.api.ops.attention(q, k, v)

    Nests: unspecified fields inherit from the innermost enclosing policy.
    """
    installed = (base if base is not None else current_policy()).override(
        **overrides)
    stack = _stack()
    stack.append(installed)
    try:
        yield installed
    finally:
        stack.pop()
