"""Morphable execution at the kernel level on the PyTorch/CUDA port (the
port's `examples/morphable_inference.py`): sweep tenant mixes through the
grouped-GEMM op and report the utilization each fusion plan achieves,
plus the hardware model's view of the same scenario on the All-rounder.

Run:  python examples/pt_morphable_inference.py [--device cpu]

The mixes run on the card unless `--device cpu` is given (on the
reference route, as the reference's example runs them); with no card and
no `--device cpu` it stops with an error. The hardware figures are
MODELED by `repro_torch.perfmodel` (cycles at 400 MHz), not measured.
"""
import argparse

import numpy as np
import torch

from repro_torch import api, resolve_device
from repro_torch.core.morphable import enumerate_fusion_plans, plan_for_tenants
from repro_torch.perfmodel.accelerators import ACCELERATORS
from repro_torch.perfmodel.latency import model_latency
from repro_torch.perfmodel.workloads import inference_ops

MIXES = {
    "one big GEMM": [(1024, 1024, 1024)],
    "two wide GEMMs (Fig 3)": [(128, 512, 2048), (128, 512, 1536)],
    "four small tenants": [(100, 64, 96), (60, 128, 64),
                           (200, 96, 128), (50, 256, 80)],
}


def kernel_level(device="cuda", mixes=MIXES):
    """Each mix through `api.ops.morphable_multi_gemm` on the reference
    route, beside its fusion plan. Returns {mix: (pack utilization, plan,
    assignment)}."""
    print("=== kernel level: tenant mixes through one grouped launch ===")
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    out = {}
    for name, shapes in mixes.items():
        tenants = [(torch.tensor(rng.randn(m, k), dtype=torch.float32,
                                 device=dev),
                    torch.tensor(rng.randn(k, n), dtype=torch.float32,
                                 device=dev))
                   for m, k, n in shapes]
        _, util = api.ops.morphable_multi_gemm(tenants, backend="ref")
        plan, assign = plan_for_tenants([(k, n) for m, k, n in shapes])
        out[name] = (util, plan.describe(), assign)
        print(f"  {name:26s} pack util {util:5.3f}  "
              f"plan {plan.describe()}  assign {assign}")
    return out


def hardware_level():
    """MobileNetV2 int8 inference on the modeled All-rounder and TPU-like
    systolic array. Returns (legal fusion plans, {accelerator: (ms at 400
    MHz, utilization)}), all MODELED."""
    print("=== perfmodel (MODELED): the same morphing on the hardware ===")
    n_plans = len(enumerate_fusion_plans())
    print(f"  {n_plans} legal fusion plans (Fig 8 e-h + symmetries)")
    ops = inference_ops("mobilenetv2", 1)
    out = {}
    for name in ("allrounder", "tpu_sa"):
        r = model_latency(ops, ACCELERATORS[name], "int8")
        out[name] = (r["cycles"] / 4e5, r["utilization"])
        print(f"  mobilenetv2 int8 inference on {name:10s}: "
              f"{out[name][0]:8.2f} ms @400MHz MODELED, util "
              f"{out[name][1]:.3f}")
    return n_plans, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    kernel_level(resolve_device(args.device))
    hardware_level()
    print("morphable_inference OK")


if __name__ == "__main__":
    main()
