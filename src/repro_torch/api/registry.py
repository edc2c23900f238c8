"""KernelRegistry: one dispatch table for every op implementation.

Implementations register under ``(op_name, impl)`` with ``impl`` one of
IMPLS; `repro_torch.api.ops` resolves the active ExecutionPolicy and the
call's shape to an impl key and dispatches here. Kernel packages register
themselves when imported; `lookup` imports them on first use.

`set_dispatch_hook` / `dispatch_intercepted` install a hook that every
`lookup` calls first: the seam the serving engine's fault plans use to make
an op dispatch fail.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["KernelRegistry", "registry", "register", "IMPLS",
           "set_dispatch_hook", "dispatch_intercepted"]

IMPLS = ("cuda", "cuda-decode", "cuda-prefill", "ref")

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


registry = KernelRegistry()
register = registry.register
