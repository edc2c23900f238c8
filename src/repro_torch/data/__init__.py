"""Deterministic synthetic data pipeline (`pipeline`)."""
from .pipeline import (DataConfig, PipelineState, Prefetcher,  # noqa: F401
                       SyntheticLM)
