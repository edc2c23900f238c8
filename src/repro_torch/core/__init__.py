"""Core of the All-rounder port: number formats, the bit-accurate
multiplier model, the morphable-array abstractions, the mapping math and
the custom ISA (the reference package's `repro.core`, with its own
torch formats)."""
from . import aio_mac, formats, isa, mapping, morphable  # noqa: F401
from .formats import (  # noqa: F401
    AIOFormat, BF16, FP8A, FP8B, INT4, INT8, REGISTRY, UINT4, UINT8,
    fake_quant, fp_format, int_format, pow2_ceil, quantize, quantize_scaled,
)
from .morphable import FusionPlan, enumerate_fusion_plans, plan_for_tenants  # noqa: F401
