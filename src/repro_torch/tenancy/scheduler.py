"""Morphable multi-tenant scheduler — Fig 8 at device-grid scale.

The paper fissions a 128x128 MAC array into blocks so several AI models run
at once; at device scale the same morphing applies to a grid of cards: a
(data, model) grid is split into contiguous sub-grids ("array blocks"),
tenants are assigned by load, and blocks re-fuse when a single tenant needs
the whole grid. `plan_for_tenants` (core/morphable.py) supplies the fusion
geometry; this module maps it onto torch devices and runs per-tenant
programs on their partition's device.

Within one partition, co-resident *small* tenants additionally share kernel
launches through `api.ops.morphable_multi_gemm` (the grouped GEMM) — the two
levels compose exactly like local vs global bridge logics.

A grid is only a placement here: no collective joins its devices (sharding
a tenant over several cards is not part of the port yet), so a partition's
programs run on its first device. On one card the grid is 1x1 and every
tenant time-shares the one fused partition, the Fig 8-(h) configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.morphable import FusedArray, FusionPlan, plan_for_tenants

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
    mesh: DeviceGrid        # a contiguous device block


def device_grid(devices) -> np.ndarray:
    """`devices` (a nested sequence or array of devices or device names)
    as a numpy object array of `torch.device` of the same shape."""
    grid = np.asarray(devices, dtype=object)
    return np.vectorize(torch.device, otypes=[object])(grid)


def fission_mesh(devices: np.ndarray, plan: FusionPlan,
                 axis_names=("data", "model")) -> List[DeviceGrid]:
    """Split a 2D device grid into per-partition grids following the plan's
    block rectangles (blocks laid out 2x2 like the paper's array blocks)."""
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
        grids.append(DeviceGrid(sel, tuple(axis_names)))
    return grids


class MorphableScheduler:
    """Assign tenants to grid partitions and run their programs.

    reconfigure() is the global-bridge moment: it re-plans when the tenant
    set changes (tenant arrival/departure = the paper's multi-tenant
    scenario transitions between Fig 8 (e)-(h)).
    """

    def __init__(self, devices: Optional[np.ndarray] = None):
        """devices: a 2-D grid of devices (`device_grid`). None takes every
        CUDA card, reshaped to the squarest grid; with no card that raises
        — pass a grid of `torch.device("cpu")` to run on the CPU."""
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "no CUDA device is available; pass a grid of "
                    "torch.device('cpu') to schedule on the CPU")
            side = int(np.sqrt(n))
            while n % side:
                side -= 1
            devices = device_grid([f"cuda:{i}" for i in range(n)]).reshape(
                side, n // side)
        else:
            devices = device_grid(devices)
        if devices.ndim != 2:
            raise ValueError(f"a device grid is 2-D, got {devices.shape}")
        if devices.shape[0] % 2 or devices.shape[1] % 2:
            devices = devices[: devices.shape[0] - devices.shape[0] % 2 or None,
                              : devices.shape[1] - devices.shape[1] % 2 or None]
        self.devices = devices
        self.partitions: List[MeshPartition] = []
        self.plan: Optional[FusionPlan] = None
        self.engines: Dict[str, Any] = {}

    def reconfigure(self, tenants: Sequence[Tenant]) -> List[MeshPartition]:
        shapes = [(t.weight_rows, t.weight_cols) for t in tenants]
        fmt = tenants[0].fmt if tenants else "bf16"
        plan, assign = plan_for_tenants(shapes, fmt)
        self.plan = plan
        if self.devices.shape[0] < 2 or self.devices.shape[1] < 2:
            # degenerate host (one card, one CPU): everyone time-shares one
            # fused partition — the Fig 8-(h) configuration
            self.plan = FusionPlan((FusedArray((0, 1, 2, 3), 128, 128),))
            grid = DeviceGrid(self.devices, ("data", "model"))
            self.partitions = [MeshPartition(
                tuple(t.name for t in tenants), grid)]
            return self.partitions
        grids = fission_mesh(self.devices, plan)
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
        """Run `fn` on the tenant's partition: with its first device as the
        current CUDA device (so "cuda" means that card inside `fn`), or as
        is on a CPU partition."""
        dev = self.partition_of(tenant_name).mesh.first()
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
