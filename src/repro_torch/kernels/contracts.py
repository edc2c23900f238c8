"""Helpers the kernels' launch contracts share (`*/contract.py`).

A contract mirrors, in plain Python, what one call of a CUDA entry point
launches (`api.registry.LaunchContract`). These helpers keep the contracts
short: the static shared memory of the split-K arrival, the scattered
block tables of the paged cases, element ranges clipped to an operand, and
`card_and_plain`, the body of every contract: the wrapper on the card
(the kernel) beside the same wrapper on CPU copies of the inputs (its plain
version).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["SPLITK_STATIC", "paged_table", "span", "card_and_plain",
           "to_device"]

# csrc/splitk.cuh's `__shared__ int s_last`, which ptxas lays out in 16
# bytes (`-Xptxas -v`: "16 bytes smem" for every kernel that has only it)
SPLITK_STATIC = 16


def paged_table(b: int, nblk: int, pool: int) -> np.ndarray:
    """A deterministic scattered-but-valid block table (the reference
    contract's `_paged_table`): rows interleave the pool, so the contracts
    prove in-bounds through a map that is not the identity."""
    return np.asarray([[(i * nblk + j) * 7 % pool for j in range(nblk)]
                       for i in range(b)], np.int32)


def span(lo: int, hi: int):
    """The element range [lo, hi) of one dimension, or None when empty."""
    return range(lo, hi) if hi > lo else None


def to_device(obj: Any, device) -> Any:
    """`obj` with every tensor in it (through tuples, lists, dicts and
    dataclasses such as `formats.QuantWeight`) copied to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def card_and_plain(fn: Callable, *args, **kwargs):
    """(fn on the card, fn on the CPU) over the same inputs, given on the
    CPU: a kernel wrapper launches its CUDA kernel on CUDA tensors and runs
    its plain version on CPU tensors, so the pair is the kernel and its
    plain version. The card's result comes back to the CPU."""
    got = fn(*to_device(args, "cuda"), **to_device(kwargs, "cuda"))
    want = fn(*args, **kwargs)
    return to_device(got, "cpu"), want
