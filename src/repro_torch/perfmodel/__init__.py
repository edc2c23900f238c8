"""Cycle-level performance model of the All-rounder vs its baselines.

A copy of `repro.perfmodel` (pure Python). Its outputs are MODELED cycles
and milliseconds of the paper's 128x128 MAC array at 400 MHz, and
`simulate.GPU_TABLE4` holds the paper's RTX 3090 constants: none of them
is a measurement of the port on a card.
"""
from .accelerators import ACCELERATORS, Accelerator  # noqa: F401
from .latency import model_latency, op_latency  # noqa: F401
from .simulate import (gpu_comparison, multi_tenant_scenario,  # noqa: F401
                       speedup_table, utilization_table)
from .workloads import MODELS, inference_ops, training_ops  # noqa: F401
