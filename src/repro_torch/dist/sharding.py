"""The ambient mesh and the sharding-constraint helper.

Model code never builds a process group: it asks this module for the
ambient mesh (`ctx_mesh`), the data-parallel axes (`ctx_dp_axes`) and, for
a named mesh axis, its size and this rank's index on it. `set_mesh` binds
a mesh for a block of code, as the reference's `set_mesh` binds a jax mesh.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with dims ("data",
"model") or ("pod", "data", "model") over a live process group, or a
`ShapeMesh`: the same names and sizes with no process group behind them,
which the dry-run uses to build one rank's step on `meta` tensors (its
collectives return the right shapes and record their calls; see
`dist.collectives`).

`constrain(x, *spec)` is the reference's `with_sharding_constraint`
helper: the identity without a mesh or on a plain tensor (the port keeps
its activations as plain local tensors and places them by hand); on a
`DTensor` it redistributes to the placements the spec names, dropping the
axes the mesh lacks.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Sequence, Tuple

import torch

__all__ = ["DP_AXES", "ShapeMesh", "ctx_mesh", "ctx_dp_axes", "constrain",
           "set_mesh", "axis_names", "axis_size", "axis_rank", "dp_size",
           "dp_rank", "in_dp_region", "dp_region", "Placements",
           "spec_placements"]

# Axes that compose into the batch (data-parallel) dimension, in mesh order.
DP_AXES = ("pod", "data")

_STACK: List = []
_DP_REGION: List[bool] = []


class ShapeMesh:
    """A mesh of names and sizes only: no process group, no device. This
    rank sits at coordinate 0 on every axis. `dist.collectives` answers a
    call over it with a tensor of the result's shape (on the input's
    device, `meta` in the dry-run) and records the call."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, mesh_dim: str) -> int:
        return 0

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.mesh_dim_names,
                                                   self.shape))
        return f"ShapeMesh({dims})"


def ctx_mesh():
    """The ambient mesh, or None outside any `set_mesh`."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Bind `mesh` as the ambient mesh for the block (None unbinds)."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def axis_names(mesh=None) -> Tuple[str, ...]:
    mesh = ctx_mesh() if mesh is None else mesh
    return () if mesh is None else tuple(mesh.mesh_dim_names)


def axis_size(name: str, mesh=None) -> int:
    """The size of mesh axis `name` (1 when the mesh lacks it or there is
    no mesh)."""
    mesh = ctx_mesh() if mesh is None else mesh
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_rank(name: str, mesh=None) -> int:
    """This rank's index along mesh axis `name` (0 without it)."""
    mesh = ctx_mesh() if mesh is None else mesh
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(name))


def ctx_dp_axes(mesh=None) -> Tuple[str, ...]:
    """Data-parallel axes of the ambient mesh ( () without a mesh )."""
    return tuple(a for a in axis_names(mesh) if a in DP_AXES)


def dp_size(mesh=None) -> int:
    return math.prod(axis_size(a, mesh) for a in ctx_dp_axes(mesh))


def dp_rank(mesh=None) -> int:
    """This rank's index in the composed DP dimension (row-major over the
    DP axes in mesh order, as the batch axis is split)."""
    r = 0
    for a in ctx_dp_axes(mesh):
        r = r * axis_size(a, mesh) + axis_rank(a, mesh)
    return r


def in_dp_region() -> bool:
    """True inside the compressed train step's data-parallel region (the
    reference's manual shard_map over the DP axes): the manual TP block and
    the expert-parallel MoE path stand aside there, as the reference's do
    inside a manual region."""
    return bool(_DP_REGION)


@contextlib.contextmanager
def dp_region() -> Iterator[None]:
    _DP_REGION.append(True)
    try:
        yield
    finally:
        _DP_REGION.pop()


def _keep(entry, names):
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return entry if entry in names else None


class Placements(tuple):
    """One leaf's placements, one per mesh dim: a tuple, and a leaf (not
    a container) of the spec trees."""


def spec_placements(spec: Sequence, mesh_names: Sequence[str]
                    ) -> Placements:
    """A positional spec (one entry per tensor dim: an axis name, a tuple
    of names, or None) as one placement per mesh dim: Shard(d) where tensor
    dim d names that mesh dim, Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_names:
        dims = [d for d, e in enumerate(spec) if e is not None and
                name in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return Placements(out)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute a DTensor to the placements `spec` names against the
    ambient mesh; the identity without a mesh, on a plain tensor, or when
    every entry names an axis the mesh lacks.

    Spec entries are axis names, tuples of axis names, or None; entries
    naming axes the ambient mesh lacks are dropped (so "model" hints are
    safe on a data-only mesh)."""
    m = ctx_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = set(m.mesh_dim_names)
    entries = tuple(_keep(e, names) for e in spec)
    if all(e is None for e in entries):
        return x
    return x.redistribute(x.device_mesh,
                          spec_placements(entries, m.mesh_dim_names))
