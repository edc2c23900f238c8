"""Host-side block store: where a preempted row's live KV goes.

Under pool pressure past the engine's high watermark, the paged engine
preempts a resident row: it gathers the row's PRIVATE physical blocks off
the card (`transformer.gather_pool_blocks`) and parks the bytes here as
numpy buffers under host block ids — codes AND scales for an int8 cache,
so such a row round-trips bit for bit. Swap-in hands the same bytes back
(`get`) for the engine's `write_pool_blocks`; nothing is recomputed, so a
preempted request's greedy output equals an uncontended run's.

A stored block is {pool name: (n_layers, 1, Hkv, bs, X) numpy array}.
numpy has no bfloat16, so a bf16 pool is kept as its 16-bit pattern (an
int16 array) beside a dtype tag, and `get` hands back torch tensors of the
tagged dtype. The engine owns the layout and checks a snapshot's blocks
against its own caches (`load_state`).
"""
from __future__ import annotations

import base64
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["HostBlockStore", "to_host", "from_host"]

# a block: {name: (dtype tag, numpy array)}
Block = Dict[str, Tuple[str, np.ndarray]]


def to_host(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(dtype tag, numpy array) of a tensor, bf16 as its int16 pattern."""
    tag = str(t.dtype).replace("torch.", "")
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return tag, t.numpy()


def from_host(tag: str, a: np.ndarray) -> torch.Tensor:
    """The inverse of `to_host`: a CPU tensor of dtype `tag`."""
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))
    return t.view(torch.bfloat16) if tag == "bfloat16" else t


def _nbytes(blk) -> int:
    return sum(int(a.nbytes) for _, a in blk.values())


def _encode(tag: str, a: np.ndarray) -> dict:
    return {"dtype": tag, "shape": list(a.shape),
            "data": base64.b64encode(
                np.ascontiguousarray(a).tobytes()).decode("ascii")}


def _decode(e: dict) -> Tuple[str, np.ndarray]:
    np_dtype = np.int16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
    a = np.frombuffer(base64.b64decode(e["data"]), dtype=np_dtype)
    return e["dtype"], a.reshape(e["shape"]).copy()


class HostBlockStore:
    """One entry per swapped-out physical block, owned by exactly one
    PREEMPTED request's swap entry (no refcounts)."""

    def __init__(self):
        self._blocks: Dict[int, Block] = {}
        self._next = 0
        self.bytes_out = 0      # device -> host (swap-out)
        self.bytes_in = 0       # host -> device (swap-in)

    def __len__(self) -> int:
        return len(self._blocks)

    def nbytes(self) -> int:
        """Bytes held in the store now."""
        return sum(_nbytes(b) for b in self._blocks.values())

    def put(self, slabs: Dict[str, torch.Tensor], count: int) -> List[int]:
        """Store `count` blocks of a gathered slab dict ({name: (n, count,
        ...)} tensors, moved to the host here); returns their host block
        ids, in slab order."""
        host = {name: to_host(t) for name, t in slabs.items()}
        hids = list(range(self._next, self._next + count))
        self._next += count
        for i, h in enumerate(hids):
            blk = {name: (tag, np.ascontiguousarray(a[:, i:i + 1]))
                   for name, (tag, a) in host.items()}
            self._blocks[h] = blk
            self.bytes_out += _nbytes(blk)
        return hids

    def get(self, hids: List[int]) -> Dict[str, torch.Tensor]:
        """The slab dict of blocks `hids` ({name: (n, len(hids), ...)} CPU
        tensors), in order. The blocks stay stored until `free`."""
        blks = [self._blocks[h] for h in hids]
        out = {}
        for name, (tag, _) in blks[0].items():
            a = np.concatenate([b[name][1] for b in blks], axis=1)
            self.bytes_in += int(a.nbytes)
            out[name] = from_host(tag, a)
        return out

    def free(self, hids: List[int]):
        for h in hids:
            self._blocks.pop(h, None)

    # ------------------------------------------------------- serialization
    def state_dict(self) -> dict:
        """A JSON-safe snapshot: each block's arrays (base64) in pool-name
        order. The layout is not stored: the restoring engine checks the
        blocks against its own caches."""
        return {
            "next": self._next,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "blocks": {str(h): {name: _encode(tag, a)
                                for name, (tag, a) in blk.items()}
                       for h, blk in self._blocks.items()},
        }

    def load_state(self, state: dict, layout=None):
        """The inverse of `state_dict`. `layout`, {name: (shape, dtype
        tag)} of one block in the restoring engine's caches: a stored block
        that does not match it raises ValueError, so a snapshot of another
        cache geometry is refused, never reinterpreted."""
        self._next = int(state["next"])
        self.bytes_out = int(state["bytes_out"])
        self.bytes_in = int(state["bytes_in"])
        self._blocks = {}
        for h, enc in state["blocks"].items():
            blk = {name: _decode(e) for name, e in enc.items()}
            if layout is not None:
                got = {name: (tuple(a.shape), tag)
                       for name, (tag, a) in blk.items()}
                want = {name: (tuple(s), tag)
                        for name, (s, tag) in layout.items()}
                if got != want:
                    raise ValueError(
                        f"snapshot swap-store block {h} layout {got} does "
                        f"not match the engine's cache layout {want}")
            self._blocks[int(h)] = blk
