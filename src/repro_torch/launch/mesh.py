"""Meshes: the live world as (data, model), and the production shapes.

`init_world()` starts the process group: from an explicit `init_method`
(`tcp://host:port`, `file://path`), or from the launcher environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`, as
`torchrun` sets them). The backend is NCCL when each rank of the host has a
card of its own, gloo otherwise (ranks that share a card, or the CPU; the
collectives then carry device tensors through host buffers).

`make_local_mesh(model)` lays the live world out as (world / model, model)
with dims ("data", "model"). `world_grid()` gives the world's ranks as the
squarest 2-D grid and `make_meshes(grids)` a mesh over each of several
rank grids (the morphable scheduler's partitions), made alike on every
rank. `make_production_mesh(multi_pod=)` gives the
reference's production shapes, (16, 16) or (2, 16, 16), as a `ShapeMesh`
of names and sizes only: it touches no device and needs no world (the
dry-run builds one rank's step against it).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dist.sharding import ShapeMesh

__all__ = ["init_world", "world_backend", "make_mesh", "make_meshes",
           "squarest", "world_grid", "make_local_mesh", "make_production_mesh",
           "rank_device"]


def world_backend(local_world: int, device: str = "cuda") -> str:
    """"nccl" when every one of the host's `local_world` ranks can have a
    card of its own, "gloo" otherwise."""
    if device != "cpu" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: its own card under NCCL (cuda:LOCAL_RANK), the
    given device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                            % torch.cuda.device_count())
    return dev


def init_world(*, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               device: str = "cuda", backend: Optional[str] = None) -> int:
    """Start the default process group unless one is running; returns the
    world size. Rank and world size come from the arguments or from RANK /
    WORLD_SIZE; without init_method, MASTER_ADDR / MASTER_PORT give the
    rendezvous (env://)."""
    if dist.is_initialized():
        return dist.get_world_size()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) \
        if world_size is None else world_size
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or world_backend(local_world, device)
    if init_method is None and world_size == 1 \
            and "MASTER_ADDR" not in os.environ:
        # a world of one: a private file rendezvous, no port
        import tempfile
        init_method = "file://" + tempfile.mktemp(prefix="repro_torch_pg_")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return world_size


def make_mesh(shape, names=("data", "model"), ranks=None):
    """A DeviceMesh of `shape` over `ranks` (default: the whole world, in
    rank order). Every rank of the world calls it, those outside `ranks`
    too (they sit outside the mesh). A NCCL world's mesh is a "cuda" mesh,
    a gloo world's a "cpu" one."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "launch.mesh.init_world() first")
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n) if ranks is None else torch.as_tensor(ranks)
    if ranks.numel() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, got "
                         f"{ranks.numel()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, ranks.view(*shape), mesh_dim_names=tuple(names))


def make_meshes(grids, names=("data", "model")) -> list:
    """One DeviceMesh for each 2-D grid of world ranks in `grids`, made in
    the order given: every rank of the world calls it with the same grids
    (making a mesh is collective over the world), and a rank keeps the
    meshes of grids it is not in as meshes it sits outside of."""
    return [make_mesh(tuple(g.shape), names,
                      ranks=torch.as_tensor(g.reshape(-1).tolist()))
            for g in grids]


def squarest(n: int) -> tuple:
    """(rows, cols) of the squarest grid of n, rows <= cols."""
    side = int(np.sqrt(n))
    while n % side:
        side -= 1
    return side, n // side


def world_grid():
    """The live world's ranks as the squarest 2-D grid, a numpy int
    array."""
    if not dist.is_initialized():
        raise RuntimeError("a grid of ranks needs a process group: call "
                           "launch.mesh.init_world() first")
    n = dist.get_world_size()
    return np.arange(n).reshape(squarest(n))


def make_local_mesh(model: int = 1):
    """The live world as a (world / model, model) mesh with dims ("data",
    "model")."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a process group: call "
                           "launch.mesh.init_world() first")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model-parallel size {model} does not divide the "
                         f"world of {n}")
    return make_mesh((n // model, model))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"): shape and names only."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))
