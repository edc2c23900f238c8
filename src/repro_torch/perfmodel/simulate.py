"""Top-level simulation runs reproducing the paper's evaluation sections.

  * utilization_table()   -> Fig 14 (a/b): MAC utilization per model x step
                             x accelerator, bf16 / hybrid-FP8 / INT8 / INT4.
  * speedup_table()       -> Fig 15 (a-f): speedup, area-eff, energy-eff
                             vs the TPU-like SA.
  * multi_tenant_scenario() -> §VI-C: captioning (MobileNetV2+Transformer)
                             + ResNet-18 classification, INT8.
  * gpu_comparison()      -> Table IV: All-rounder bf16 vs RTX 3090 constants.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .accelerators import ACCELERATORS, Accelerator, array_power_w
from .energy import energy_topdown_j, runtime_s
from .latency import model_latency
from .workloads import inference_ops, training_ops

__all__ = ["utilization_table", "speedup_table", "multi_tenant_scenario",
           "gpu_comparison", "TRAIN_MODELS", "CNN_B", "LLM_B"]

TRAIN_MODELS = ["vgg16", "resnet18", "mobilenetv2", "efficientnet_b0",
                "convnext_s", "gpt2", "llama2_7b"]
CNN_B = 128          # paper: batch 128 for CNNs
LLM_B = 8            # paper: batch 8 for LLMs


def _batch(model: str) -> int:
    return LLM_B if model in ("gpt2", "llama2_7b", "captioner") else CNN_B


def _morph_configs(acc: Accelerator, fmt: str):
    """Paper methodology: morphables use R,C in {64,128} (x2 in FP8/INT4);
    non-morphables fixed 128 (x2)."""
    return acc.configs


def utilization_table(fmt: str = "bf16",
                      models: Optional[List[str]] = None) -> Dict:
    """{model: {step: {accelerator: utilization}}} — Fig 14."""
    out: Dict = {}
    for model in models or TRAIN_MODELS:
        b = _batch(model)
        steps = training_ops(model, b)
        out[model] = {}
        for step_name, ops in steps.items():
            row = {}
            for name, acc in ACCELERATORS.items():
                res = model_latency(ops, acc, fmt, _morph_configs(acc, fmt))
                row[name] = res["utilization"]
            out[model][step_name] = row
    return out


def training_cycles(model: str, acc: Accelerator, fmt: str) -> float:
    steps = training_ops(model, _batch(model))
    return sum(model_latency(ops, acc, fmt)["cycles"]
               for ops in steps.values())


def speedup_table(fmt: str = "bf16",
                  models: Optional[List[str]] = None) -> Dict:
    """Fig 15: per model x accelerator — speedup over TPU-SA, area
    efficiency (throughput/mm^2) and energy efficiency (1/J) ratios."""
    out: Dict = {}
    for model in models or TRAIN_MODELS:
        base_cycles = training_cycles(model, ACCELERATORS["tpu_sa"], fmt)
        base_acc = ACCELERATORS["tpu_sa"]
        base_area_eff = 1.0 / (base_cycles * base_acc.area_mm2)
        base_energy = energy_topdown_j(base_cycles, base_acc, fmt)
        row: Dict = {}
        for name, acc in ACCELERATORS.items():
            cycles = training_cycles(model, acc, fmt)
            row[name] = {
                "speedup": base_cycles / cycles,
                "area_eff": (1.0 / (cycles * acc.area_mm2)) / base_area_eff,
                "energy_eff": base_energy / energy_topdown_j(cycles, acc, fmt),
            }
        out[model] = row
    return out


def multi_tenant_scenario(fmt: str = "int8", mode: str = "eq1"
                          ) -> Dict[str, float]:
    """§VI-C: MobileNetV2 + captioning Transformer (one app) and ResNet-18
    (another) run concurrently, batch-1 online inference.

    Partitions: morphables (All-rounder, SARA) fission into two 64x128
    blocks (the configuration the paper reports as fastest); Dataflow
    Mirroring splits COLUMN-wise into two 128x64 halves via its
    opposite-corner bidirectional streaming (rows stay 128, so the
    taps-rows penalty on depthwise is 2x SARA's — the paper's 93.65 vs
    33.33 ms gap); the rigid SA serializes the tenants.
    """
    tenants = {
        "captioning": (inference_ops("mobilenetv2", 1) +
                       inference_ops("captioner", 1)),
        "classification": inference_ops("resnet18", 1),
    }
    out = {}
    for name, acc in ACCELERATORS.items():
        if acc.morphable:
            part_cfg = [(64, 128)]
        elif acc.max_tenants >= 2:                     # mirroring
            part_cfg = [(128, 64)]
        else:
            part_cfg = None
        if part_cfg is not None:
            parts = {t: model_latency(ops, acc, fmt, part_cfg, mode)["cycles"]
                     for t, ops in tenants.items()}
            cycles = max(parts.values())               # run in parallel
        else:                                          # rigid SA: serialize
            cycles = sum(model_latency(ops, acc, fmt, None, mode)["cycles"]
                         for ops in tenants.values())
        out[name] = runtime_s(cycles) * 1e3
    return out


# Table IV constants (NVIDIA RTX 3090, paper's measurements)
GPU_TABLE4 = {
    "alexnet": {"runtime_ms": 46.0, "power_w": 207.7, "gflops_w": 41.1},
    "vgg16": {"runtime_ms": 296.4, "power_w": 326.7, "gflops_w": 61.0},
    "resnet18": {"runtime_ms": 71.4, "power_w": 321.4, "gflops_w": 36.3},
    "mobilenetv2": {"runtime_ms": 65.9, "power_w": 322.7, "gflops_w": 9.8},
    "densenet": {"runtime_ms": 214.0, "power_w": 336.2, "gflops_w": 15.5},
}


def gpu_comparison(models: Optional[List[str]] = None) -> Dict:
    """Table IV: All-rounder bf16 training runtime + GFLOPS/W vs the GPU
    constants (for the benchmarks we model in both)."""
    acc = ACCELERATORS["allrounder"]
    out = {}
    for model in models or ["vgg16", "resnet18", "mobilenetv2"]:
        cycles = training_cycles(model, acc, "bf16")
        t = runtime_s(cycles)
        steps = training_ops(model, _batch(model))
        flops = 2.0 * sum(sum(o.macs for o in ops) for ops in steps.values())
        power = array_power_w(acc, "bf16")
        out[model] = {
            "allrounder_ms": t * 1e3,
            "allrounder_gflops_w": flops / t / power / 1e9,
            "gpu": GPU_TABLE4.get(model),
        }
    return out
