"""The architecture registry of the port: the reference's twelve configs
(the dense llama family, olmo, gpt2, internlm2, gemma2, the MoE family,
the hybrid zamba2, the recurrent xlstm, the encoder-decoder whisper and
the vision-language internvl2). Each arch module
exports CONFIG (full, paper-exact widths) and SMOKE (reduced, same family
and features, CPU-sized), as data against the port's own ModelConfig."""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "get_arch", "get_config", "get_smoke"]

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
