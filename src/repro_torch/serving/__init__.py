"""Per-slot continuous-batching serving engine, its fault plans and its
host block store."""
from .engine import (EngineStalledError, EngineStats,  # noqa: F401
                     Request, ServingEngine, TERMINAL_STATES)
from .faults import (Fault, FaultPlan, KernelLaunchError,  # noqa: F401
                     drive_with_plan, malformed_request)
from .swap import HostBlockStore  # noqa: F401
