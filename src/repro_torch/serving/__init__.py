"""Per-slot continuous-batching serving engine."""
from .engine import EngineStats, Request, ServingEngine  # noqa: F401
