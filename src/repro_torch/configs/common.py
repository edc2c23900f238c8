"""The architecture registry of the port: the reference's twelve configs
(the dense llama family, olmo, gpt2, internlm2, gemma2, the MoE family,
the hybrid zamba2, the recurrent xlstm, the encoder-decoder whisper and
the vision-language internvl2). Each arch module
exports CONFIG (full, paper-exact widths) and SMOKE (reduced, same family
and features, CPU-sized), as data against the port's own ModelConfig."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

__all__ = ["ARCH_IDS", "get_arch", "get_config", "get_smoke", "ShapeCell",
           "SHAPES", "shape_support", "FULL_ATTN_SKIP"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell of the dry-run grid (the reference's)."""
    name: str
    kind: str        # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

FULL_ATTN_SKIP = ("long_500k needs sub-quadratic sequence mixing; this arch "
                  "is (partially) full-attention — skipped per the brief "
                  "(DESIGN.md §4)")

ARCH_IDS = ["qwen2_1p5b", "llama2_7b", "internlm2_20b", "olmo_1b",
            "gpt2_small", "gemma2_27b", "olmoe_1b_7b", "kimi_k2",
            "zamba2_2p7b", "xlstm_1p3b", "whisper_tiny", "internvl2_76b"]


def get_arch(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str):
    return get_arch(arch_id).CONFIG


def get_smoke(arch_id: str):
    return get_arch(arch_id).SMOKE


def shape_support(arch_id: str) -> Dict[str, Optional[str]]:
    """shape name -> None (supported) or the skip reason: every cell, but
    long_500k only for the sub-quadratic configs (the reference's
    SHAPE_SUPPORT tables)."""
    sub = get_config(arch_id).subquadratic
    return {name: None if name != "long_500k" or sub else FULL_ATTN_SKIP
            for name in SHAPES}
