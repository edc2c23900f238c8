"""KernelRegistry: one dispatch table for every op implementation.

Implementations register under ``(op_name, impl)`` with ``impl`` one of
IMPLS; `repro_torch.api.ops` resolves the active ExecutionPolicy and the
call's shape to an impl key and dispatches here. Kernel packages register
themselves when imported; `lookup` imports them on first use.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

__all__ = ["KernelRegistry", "registry", "register", "IMPLS"]

IMPLS = ("cuda", "cuda-decode", "cuda-prefill", "ref")

# packages whose import populates the registry
_KERNEL_PACKAGES = ("repro_torch.kernels.flash_attention",
                    "repro_torch.kernels.aio_matmul",
                    "repro_torch.kernels.aio_quant",
                    "repro_torch.kernels.grouped_matmul",
                    "repro_torch.kernels.depthwise")


class KernelRegistry:
    def __init__(self):
        self._impls: Dict[Tuple[str, str], Callable] = {}
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

    def _ensure_kernels(self):
        if self._loaded:
            return
        for pkg in _KERNEL_PACKAGES:
            importlib.import_module(pkg)
        self._loaded = True

    def lookup(self, op_name: str, impl: str) -> Callable:
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


registry = KernelRegistry()
register = registry.register
