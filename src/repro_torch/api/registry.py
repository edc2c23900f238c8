"""KernelRegistry: one dispatch table for every op implementation.

Implementations register under ``(op_name, impl)`` with ``impl`` one of
IMPLS; `repro_torch.api.ops` resolves the active ExecutionPolicy and the
call's shape to an impl key and dispatches here. Kernel packages register
themselves when imported; `lookup` imports them on first use.

`set_dispatch_hook` / `dispatch_intercepted` install a hook that every
`lookup` calls first: the seam the serving engine's fault plans use to make
an op dispatch fail.

Every non-ref impl also declares a LAUNCH CONTRACT (`register_contract`):
for a concrete case and policy, the CUDA launches its C entry point makes
(grid, threads, shared memory, cluster) and, for each operand, the tile a
thread block reads or writes, built in plain Python from the wrapper's own
launch plan without touching a card. `repro_torch.analysis` sweeps these
for out-of-bounds tiles, uncovered tails and H100 launch limits, and, on a
card, launches each contract's `body` inside redzones and under the
profiler and compute-sanitizer to hold the real launch to its contract.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["KernelRegistry", "registry", "register", "register_contract",
           "IMPLS", "BlockContract", "KernelLaunch", "LaunchContract",
           "H100_LIMITS", "set_dispatch_hook", "dispatch_intercepted"]

IMPLS = ("cuda", "cuda-decode", "cuda-prefill", "ref")

# What one launch may ask of an H100 (sm_90): dynamic plus static shared
# memory a block, threads a block, grid extents, and the portable cluster
# size. The contract checker holds every KernelLaunch to these.
H100_LIMITS = {
    "smem_bytes": 232448,          # 227 KB a block, opted in above 48 KB
    "threads": 1024,
    "grid": (2 ** 31 - 1, 65535, 65535),
    "cluster": 8,
}

# packages whose import populates the registry
_KERNEL_PACKAGES = ("repro_torch.kernels.flash_attention",
                    "repro_torch.kernels.aio_matmul",
                    "repro_torch.kernels.aio_quant",
                    "repro_torch.kernels.grouped_matmul",
                    "repro_torch.kernels.depthwise")


# The dispatch hook: ``hook(op_name, impl)``, called on every registry
# lookup before the impl is returned; it may raise. Unset, a lookup pays one
# `is not None` check. The reference calls its hook while the engine's step
# TRACES, so there a dispatch fault fires only on a step that has not been
# compiled; the port has no trace, so the hook runs at every op dispatch of
# every launch and a dispatch fault fires at the first dispatch of the
# launch it is armed for.
_dispatch_hook: Optional[Callable[[str, str], None]] = None


def set_dispatch_hook(hook: Optional[Callable[[str, str], None]]):
    """Install (or clear, with None) the dispatch hook; returns the one it
    replaces."""
    global _dispatch_hook
    prev = _dispatch_hook
    _dispatch_hook = hook
    return prev


@contextlib.contextmanager
def dispatch_intercepted(hook: Callable[[str, str], None]):
    """Install `hook` for the with-block, then restore the previous one."""
    prev = set_dispatch_hook(hook)
    try:
        yield hook
    finally:
        set_dispatch_hook(prev)


# ---------------------------------------------------------------------------
# Launch contracts: the static mirror of a CUDA entry point's launches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockContract:
    """One operand of a kernel launch (an input, an output, a workspace or
    a counter buffer), as the checker sees it.

    The operand is an array of `array_shape` cut into tiles of
    `block_shape`. `index_map(x, y, z, *scalars)` takes a thread block's
    grid indices (as many as the launch's grid has dimensions) and the
    contract's concrete scalar vectors (positions, lengths, block tables,
    group ids: what the kernel reads on the device) and returns the tile
    the block reads or writes (per dimension a tile index, or a `range` of
    elements where the kernel clips its walk), a list of tiles (a walk
    through a block table), or None where the block touches no part of
    this operand (a block that exits at once, a split whose partial is
    never stored).

    masked_tail: the kernel masks accesses past the array's extent, so a
    tile that does not divide it is legal. is_output: the block writes the
    tile (outputs, workspaces, counters). revisits: the grid dimensions
    along which two blocks may legally map to the SAME output tile: the
    split-K and split-key dimensions, whose last-arriving block merges the
    partials and writes the tile once. quant / scale_for: the AIO format
    of the codes this operand carries, and the codes operand a scale
    dequantizes. index_bits: the width of the kernel's offset into this
    operand (32 where the .cu computes it in `int`), so a tile whose last
    element lies past 2^(bits-1) - 1 is out of bounds however large the
    buffer."""
    name: str
    array_shape: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    index_map: Callable[..., Any]
    dtype_bytes: int = 4
    masked_tail: bool = False
    is_output: bool = False
    revisits: Tuple[int, ...] = ()
    quant: Optional[str] = None
    scale_for: Optional[str] = None
    index_bits: int = 64


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One CUDA kernel launch of an entry point: the `__global__` function
    (`kernel`, the name the profiler's kernel record carries), its grid
    (x[, y[, z]]), threads a block, dynamic shared memory, the static
    `__shared__` bytes of the function (the profiler reports the sum),
    the thread-block cluster size along x, and its operands (inputs, then
    outputs)."""
    kernel: str
    grid: Tuple[int, ...]
    blocks: Tuple[BlockContract, ...]
    threads: int = 128
    smem_bytes: int = 0
    static_smem: int = 0
    cluster: int = 1


@dataclasses.dataclass(frozen=True)
class LaunchContract:
    """Everything one call of a kernel entry point launches, for one
    concrete case: its KernelLaunches in launch order (the full-sequence
    attention makes two), the scalar vectors its index maps read
    (`num_scalars` of them), and the C entry point it reaches.

    body, when declared, is a ZERO-ARG callable that builds the case's
    tensors on the card, launches the real entry point through its wrapper
    and returns (got, want): the kernel's output and the plain version's
    on the same inputs, which must agree to within `tol` x max(1, max
    |want|) at every element, NaN where NaN (tol 0: bitwise). It runs only
    on a card; an impl whose contracts declare no body is a KB430
    warning."""
    launches: Tuple[KernelLaunch, ...]
    scalars: Tuple[Any, ...] = ()
    num_scalars: int = 0
    entry: str = ""
    body: Optional[Callable[[], Any]] = None
    tol: float = 0.0


class KernelRegistry:
    def __init__(self):
        self._impls: Dict[Tuple[str, str], Callable] = {}
        self._contracts: Dict[Tuple[str, str], Callable] = {}
        self._loaded = False

    def register(self, op_name: str, impl: str) -> Callable:
        """Decorator: ``@register("attention", "cuda-decode")`` on an impl.

        Impl callables take the op's tensor arguments plus a keyword-only
        ``policy`` (a resolved ExecutionPolicy) and op-specific kwargs."""
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")

        def deco(fn: Callable) -> Callable:
            self._impls[(op_name, impl)] = fn
            return fn
        return deco

    def register_contract(self, op_name: str, impl: str, *,
                          cases: Sequence[dict] = (),
                          sweep_fields: Sequence[str] = ()) -> Callable:
        """Decorator: declare the launch contract of a non-ref impl.

        The decorated callable maps ``(case: dict, policy)`` to the
        LaunchContract of the launches the impl makes for that case.
        ``cases`` is the impl's representative shape sweep; ``sweep_fields``
        names the ExecutionPolicy tile fields the impl reads (the checker
        crosses the cases with `policy_sweep` over them)."""
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")

        def deco(fn: Callable) -> Callable:
            fn.cases = tuple(cases)
            fn.sweep_fields = tuple(sweep_fields)
            self._contracts[(op_name, impl)] = fn
            return fn
        return deco

    def _ensure_kernels(self):
        if self._loaded:
            return
        for pkg in _KERNEL_PACKAGES:
            importlib.import_module(pkg)
        self._loaded = True

    def lookup(self, op_name: str, impl: str) -> Callable:
        if _dispatch_hook is not None:
            _dispatch_hook(op_name, impl)
        self._ensure_kernels()
        try:
            return self._impls[(op_name, impl)]
        except KeyError:
            impls = self.implementations(op_name)
            if not impls:
                raise KeyError(f"unknown op {op_name!r}; registered ops: "
                               f"{', '.join(self.ops())}") from None
            raise KeyError(
                f"op {op_name!r} has no {impl!r} implementation; registered "
                f"implementations: {', '.join(impls)}") from None

    def ops(self) -> List[str]:
        self._ensure_kernels()
        return sorted({op for op, _ in self._impls})

    def implementations(self, op_name: str) -> List[str]:
        self._ensure_kernels()
        return sorted(i for o, i in self._impls if o == op_name)

    def contract(self, op_name: str, impl: str) -> Optional[Callable]:
        self._ensure_kernels()
        return self._contracts.get((op_name, impl))

    def contracts(self) -> Dict[Tuple[str, str], Callable]:
        """Every declared launch contract, keyed by (op, impl)."""
        self._ensure_kernels()
        return dict(self._contracts)

    def kernel_impls(self) -> List[Tuple[str, str]]:
        """Every registered non-ref implementation key (the kernel routes;
        the reference's `pallas_impls`)."""
        self._ensure_kernels()
        return sorted(k for k in self._impls if k[1] != "ref")


registry = KernelRegistry()
register = registry.register
register_contract = registry.register_contract
