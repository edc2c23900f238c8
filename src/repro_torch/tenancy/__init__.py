"""Multi-tenant serving: the morphable scheduler (`scheduler.py`)."""
from .scheduler import (DeviceGrid, MeshPartition,  # noqa: F401
                        MorphableScheduler, Tenant, device_grid,
                        fission_mesh)
