"""The collectives of the distribution layer, each over one mesh axis.

    all_gather(x, dim, axis)       concatenate the axis' ranks' x along dim
    reduce_scatter(x, dim, axis)   sum over the axis, keep this rank's
                                   slice of dim
    all_reduce(x, axes, op)        sum (or max) over one axis or several

Every tensor- and sequence-parallel block, the expert-parallel MoE and
the compressed gradient sync call these and nothing else.

Transport: over an NCCL group the tensors go as they are (each rank has
its own card). Over a gloo group, which carries ranks that share a card or
run on the CPU, a device tensor goes through a host buffer on every call,
by design (gloo's CUDA support is partial and differs between versions).
A collective that fails raises.

Gradients: each op's backward is the exact adjoint of its forward over the
whole group: all-gather <-> reduce-scatter, and a sum all-reduce is its own
adjoint. So a loss that every rank of an axis computes alike, seeded with
1 / (the ranks that compute it), gives each sharded weight its full
gradient, and each replicated weight a partial one that a sum over the
ranks completes (`runtime.trainer` does that sum). A max all-reduce has no
gradient.

Over a `ShapeMesh` (the dry-run's world of names and sizes) nothing moves:
each call returns an empty tensor of the result's shape on the input's
device. Under `record_collectives()` every call, on any mesh, is recorded
with its kind, result shape, dtype, group size, call site and pass
(forward or backward), from which `launch.dryrun.collective_bytes` counts
wire bytes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .sharding import ShapeMesh, axis_size, ctx_mesh

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "seq_split",
           "record_collectives", "barrier"]

_RECORDERS: List[List[Dict]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Dict]]:
    """Record every collective call made inside the block (a list of
    dicts: kind, shape, dtype, group, site, phase)."""
    rec: List[Dict] = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(kind, out_shape, dtype, n, site, phase) -> None:
    for rec in _RECORDERS:
        rec.append({"kind": kind, "shape": tuple(out_shape), "dtype": dtype,
                    "group": n, "site": site, "phase": phase})


def _mesh(mesh):
    mesh = ctx_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("a collective needs a mesh: bind one with "
                           "dist.set_mesh")
    return mesh


def _host_buffers(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _send(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's transport takes it: contiguous, on the host for
    gloo."""
    x = x.detach()
    if _host_buffers(group) and x.device.type != "cpu":
        return x.to("cpu").contiguous()
    return x.contiguous()


def _gather(x, dim, axis, mesh, site, phase) -> torch.Tensor:
    n = axis_size(axis, mesh)
    shape = list(x.shape)
    shape[dim] *= n
    _record("all-gather", shape, x.dtype, n, site, phase)
    if isinstance(mesh, ShapeMesh):
        return x.new_empty(shape)
    group = mesh.get_group(axis)
    src = _send(x.movedim(dim, 0), group)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


def _scatter(x, dim, axis, mesh, site, phase) -> torch.Tensor:
    n = axis_size(axis, mesh)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter over {axis!r} ({n} ranks): dim "
                         f"{dim} of {tuple(x.shape)} does not divide")
    shape = list(x.shape)
    shape[dim] //= n
    _record("reduce-scatter", shape, x.dtype, n, site, phase)
    if isinstance(mesh, ShapeMesh):
        return x.new_empty(shape)
    group = mesh.get_group(axis)
    src = _send(x.movedim(dim, 0), group)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


def _reduce(x, axis, mesh, op, site, phase) -> torch.Tensor:
    n = axis_size(axis, mesh)
    _record("all-reduce", x.shape, x.dtype, n, site, phase)
    if isinstance(mesh, ShapeMesh):
        return x.new_empty(x.shape)
    group = mesh.get_group(axis)
    buf = _send(x, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, site):
        ctx.args = (dim, axis, mesh, site)
        return _gather(x, dim, axis, mesh, site, "forward")

    @staticmethod
    def backward(ctx, g):
        dim, axis, mesh, site = ctx.args
        return _scatter(g, dim, axis, mesh, site, "backward"), None, None, \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, site):
        ctx.args = (dim, axis, mesh, site)
        return _scatter(x, dim, axis, mesh, site, "forward")

    @staticmethod
    def backward(ctx, g):
        dim, axis, mesh, site = ctx.args
        return _gather(g, dim, axis, mesh, site, "backward"), None, None, \
            None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, site):
        ctx.args = (axis, mesh, site)
        return _reduce(x, axis, mesh, "sum", site, "forward")

    @staticmethod
    def backward(ctx, g):
        axis, mesh, site = ctx.args
        return _reduce(g, axis, mesh, "sum", site, "backward"), None, None, \
            None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def all_gather(x: torch.Tensor, dim: int, axis: str = "model", *,
               mesh=None, site: Optional[str] = None) -> torch.Tensor:
    """The axis' ranks' x concatenated along `dim`, in rank order (x
    itself when the axis has one rank or the mesh lacks it)."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _AllGather.apply(x, _dim(x, dim), axis, mesh, site)


def reduce_scatter(x: torch.Tensor, dim: int, axis: str = "model", *,
                   mesh=None, site: Optional[str] = None) -> torch.Tensor:
    """The sum of the axis' ranks' x, cut along `dim` into equal slices
    in rank order: this rank's slice."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _ReduceScatter.apply(x, _dim(x, dim), axis, mesh, site)


def all_reduce(x: torch.Tensor, axes: Union[str, Sequence[str]] = "model",
               op: str = "sum", *, mesh=None,
               site: Optional[str] = None) -> torch.Tensor:
    """The sum (op="sum") or the maximum (op="max", no gradient) of x over
    the ranks of one mesh axis or of several (reduced one axis after the
    other, in the order given; axes the mesh lacks are skipped)."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op {op!r} not in ('sum', 'max')")
    mesh = _mesh(mesh)
    for axis in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if axis_size(axis, mesh) == 1:
            continue
        if op == "max":
            x = _reduce(x.detach(), axis, mesh, "max", site, "forward")
        else:
            x = _AllReduceSum.apply(x, axis, mesh, site)
    return x


def seq_split(x: torch.Tensor, dim: int, axis: str = "model", *,
              mesh=None) -> torch.Tensor:
    """This rank's slice of a tensor replicated over the axis (no
    communication; the gradient flows into the slice only)."""
    mesh = _mesh(mesh)
    n = axis_size(axis, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"split over {axis!r} ({n} ranks): dim {dim} of "
                         f"{tuple(x.shape)} does not divide")
    return x.chunk(n, dim=dim)[int(mesh.get_local_rank(axis))]


def barrier(mesh=None) -> None:
    """Wait for every rank of the mesh (of the world without one; nothing
    over a ShapeMesh or without a process group): a barrier along each
    mesh dim in turn, which over a grid holds every rank of it."""
    mesh = ctx_mesh() if mesh is None else mesh
    if isinstance(mesh, ShapeMesh) or not dist.is_initialized():
        return
    if mesh is None:
        dist.barrier()
        return
    for name in mesh.mesh_dim_names:
        if axis_size(name, mesh) > 1:
            dist.barrier(group=mesh.get_group(name))
