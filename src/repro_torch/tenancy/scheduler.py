"""Morphable multi-tenant scheduler — Fig 8 at device-grid scale.

The paper fissions a 128x128 MAC array into blocks so several AI models run
at once; at device scale the same morphing applies to a grid of cards: a
(data, model) grid is split into contiguous sub-grids ("array blocks"),
tenants are assigned by load, and blocks re-fuse when a single tenant needs
the whole grid. `plan_for_tenants` (core/morphable.py) supplies the fusion
geometry; this module maps it onto a grid of torch devices or of a
process group's ranks and runs per-tenant programs on their partition.

Within one partition, co-resident *small* tenants additionally share kernel
launches through `api.ops.morphable_multi_gemm` (the grouped GEMM) — the two
levels compose exactly like local vs global bridge logics.

Two kinds of grid:

* a grid of RANKS of a live process group (`launch.mesh.world_grid()`,
  the default when a world of several ranks is live): each partition is a
  DeviceMesh ("data", "model") over its block of ranks, and `run` binds it
  (`dist.set_mesh`) on the partition's ranks, so a tenant's engine built
  there serves tensor-parallel (the reference binds `set_mesh(part.mesh)`
  and its engine serves under GSPMD). Every rank of the world makes every
  partition's mesh, in one order (`reconfigure` is collective);
* a grid of DEVICES with no process group: a placement only, whose
  partition's programs run on its first device. On one card the grid is
  1x1 and every tenant time-shares the one fused partition, the Fig 8-(h)
  configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.morphable import FusedArray, FusionPlan, plan_for_tenants
from ..dist.sharding import set_mesh
from ..launch.mesh import make_meshes, squarest, world_grid

__all__ = ["Tenant", "DeviceGrid", "MeshPartition", "fission_mesh",
           "MorphableScheduler", "device_grid"]


@dataclasses.dataclass(frozen=True)
class Tenant:
    name: str
    # characteristic GEMM of the tenant (stationary dims) for planning
    weight_rows: int
    weight_cols: int
    fmt: str = "bf16"
    # relative request rate (plan_for_tenants load-balances on it)
    load: float = 1.0


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGrid:
    """A named 2-D grid of devices: `devices` is a numpy object array of
    `torch.device`, one axis name a dimension (the reference's mesh,
    without collectives)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D grid needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    def first(self) -> torch.device:
        return self.devices.flat[0]


@dataclasses.dataclass(frozen=True)
class MeshPartition:
    tenants: Tuple[str, ...]
    # a contiguous block of the grid: a DeviceGrid, or a DeviceMesh over a
    # block of ranks
    mesh: Any

    @property
    def ranks(self) -> Optional[List[int]]:
        """The world ranks of a partition of ranks, in mesh order (None on
        a device grid)."""
        if isinstance(self.mesh, DeviceGrid):
            return None
        return self.mesh.mesh.reshape(-1).tolist()


def device_grid(devices) -> np.ndarray:
    """`devices` (a nested sequence or array of devices or device names)
    as a numpy object array of `torch.device` of the same shape."""
    grid = np.asarray(devices, dtype=object)
    return np.vectorize(torch.device, otypes=[object])(grid)


def fission_mesh(devices: np.ndarray, plan: FusionPlan,
                 axis_names=("data", "model")) -> list:
    """Split a 2D grid into one mesh per partition following the plan's
    block rectangles (blocks laid out 2x2 like the paper's array blocks):
    a DeviceGrid each over a grid of devices, a DeviceMesh each over a
    grid of ranks (an integer array; collective: every rank of the world
    calls it alike)."""
    blocks = _blocks(devices, plan)
    if devices.dtype.kind in "iu":
        return make_meshes(blocks, tuple(axis_names))
    return [DeviceGrid(b, tuple(axis_names)) for b in blocks]


def _blocks(devices: np.ndarray, plan: FusionPlan) -> List[np.ndarray]:
    """The sub-grid of each of the plan's arrays."""
    rows, cols = devices.shape
    assert rows % 2 == 0 and cols % 2 == 0, "need a 2x2-divisible grid"
    hr, hc = rows // 2, cols // 2
    block_slices = {
        0: (slice(0, hr), slice(0, hc)),
        1: (slice(0, hr), slice(hc, cols)),
        2: (slice(hr, rows), slice(0, hc)),
        3: (slice(hr, rows), slice(hc, cols)),
    }

    def _unique_sorted(slices):
        # dedupe via (start, stop) keys — slice objects are unhashable < 3.12
        return sorted({(s.start, s.stop): s for s in slices}.values(),
                      key=lambda s: s.start)

    grids = []
    for arr in plan.arrays:
        rs = _unique_sorted(block_slices[b][0] for b in arr.blocks)
        cs = _unique_sorted(block_slices[b][1] for b in arr.blocks)
        rows_sel = np.concatenate([devices[r, :] for r in rs], axis=0) \
            if len(rs) > 1 else devices[rs[0], :]
        sel = np.concatenate([rows_sel[:, c] for c in cs], axis=1) \
            if len(cs) > 1 else rows_sel[:, cs[0]]
        grids.append(sel)
    return grids


class MorphableScheduler:
    """Assign tenants to grid partitions and run their programs.

    reconfigure() is the global-bridge moment: it re-plans when the tenant
    set changes (tenant arrival/departure = the paper's multi-tenant
    scenario transitions between Fig 8 (e)-(h)).
    """

    def __init__(self, devices: Optional[np.ndarray] = None, *,
                 ranks: Optional[np.ndarray] = None):
        """devices: a 2-D grid of devices (`device_grid`). ranks: a 2-D
        grid of the live process group's ranks (`launch.mesh.world_grid`);
        the scheduler then lives on every rank of the world alike. With
        neither: the world's ranks when a process group of more than one
        rank is live, else every CUDA card, reshaped to the squarest grid;
        with no card that raises — pass a grid of `torch.device("cpu")` to
        run on the CPU."""
        if devices is None and ranks is None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            ranks = world_grid()
        if ranks is not None:
            devices = np.asarray(ranks, dtype=np.int64)
        elif devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "no CUDA device is available; pass a grid of "
                    "torch.device('cpu') to schedule on the CPU")
            devices = device_grid([f"cuda:{i}" for i in range(n)]).reshape(
                squarest(n))
        else:
            devices = device_grid(devices)
        self.ranks = None
        if devices.ndim != 2:
            raise ValueError(f"a device grid is 2-D, got {devices.shape}")
        if devices.shape[0] % 2 or devices.shape[1] % 2:
            devices = devices[: devices.shape[0] - devices.shape[0] % 2 or None,
                              : devices.shape[1] - devices.shape[1] % 2 or None]
        if ranks is not None:
            # the grid holds ranks; `devices` stays the device-grid API's
            self.ranks, devices = devices, None
        self.devices = devices
        self.partitions: List[MeshPartition] = []
        self.plan: Optional[FusionPlan] = None
        self.engines: Dict[str, Any] = {}

    def reconfigure(self, tenants: Sequence[Tenant]) -> List[MeshPartition]:
        """Plan the tenants onto partitions of the grid (on a grid of
        ranks every rank of the world calls it with the same tenants: it
        makes each partition's mesh)."""
        shapes = [(t.weight_rows, t.weight_cols) for t in tenants]
        fmt = tenants[0].fmt if tenants else "bf16"
        plan, assign = plan_for_tenants(shapes, fmt)
        self.plan = plan
        grid = self.devices if self.ranks is None else self.ranks
        if grid.shape[0] < 2 or grid.shape[1] < 2:
            # degenerate host (one card, one CPU, a row of ranks): everyone
            # time-shares one fused partition — the Fig 8-(h) configuration
            self.plan = FusionPlan((FusedArray((0, 1, 2, 3), 128, 128),))
            mesh = DeviceGrid(grid, ("data", "model")) \
                if self.ranks is None else make_meshes([grid])[0]
            self.partitions = [MeshPartition(
                tuple(t.name for t in tenants), mesh)]
            return self.partitions
        grids = fission_mesh(grid, plan)
        part_tenants: Dict[int, List[str]] = {}
        for t_idx, p_idx in assign.items():
            part_tenants.setdefault(p_idx, []).append(tenants[t_idx].name)
        self.partitions = [
            MeshPartition(tuple(part_tenants.get(i, ())), grids[i])
            for i in range(plan.n_partitions)]
        return self.partitions

    def partition_of(self, tenant_name: str) -> MeshPartition:
        for p in self.partitions:
            if tenant_name in p.tenants:
                return p
        raise KeyError(tenant_name)

    def run(self, tenant_name: str, fn: Callable, *args, **kwargs):
        """Run `fn` on the tenant's partition. A partition of ranks: under
        its mesh (`dist.set_mesh`) on each of its ranks, while the world's
        other ranks skip the call and get None. A partition of devices:
        with its first device as the current CUDA device (so "cuda" means
        that card inside `fn`), or as is on a CPU partition."""
        part = self.partition_of(tenant_name)
        if part.ranks is not None:
            if dist.get_rank() not in part.ranks:
                return None
            with set_mesh(part.mesh):
                return fn(*args, **kwargs)
        dev = part.mesh.first()
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)

    # ------------------------------------------------------- slot occupancy
    def attach_engine(self, tenant_name: str, engine: Any):
        """Register a tenant's serving engine so the scheduler can read its
        per-slot occupancy (the continuous-batching utilization signal that
        drives re-planning: a tenant whose slots idle is a fission candidate)."""
        self.engines[tenant_name] = engine

    def occupancy(self) -> Dict[str, List[Optional[dict]]]:
        """tenant -> per-slot occupancy ({rid, generated, remaining} | None)."""
        return {name: eng.occupancy() for name, eng in self.engines.items()}

    def utilization(self) -> Dict[str, float]:
        """tenant -> fraction of engine slots currently busy."""
        return {name: eng.utilization() for name, eng in self.engines.items()}
