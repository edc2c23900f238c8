"""End-to-end driver on the PyTorch/CUDA port (the port's
`examples/fp8_training.py`): train a small LM with the hybrid-FP8 recipe
the paper evaluates (Fig 14-b/15-b), FP8-A forward activations and weights
through fake quantization with a straight-through gradient and float32
master weights, and compare its loss trajectory with the unquantized
float32 run.

Run:  python examples/pt_fp8_training.py [--steps 40] [--device cpu]

It trains on the card unless `--device cpu` is given; with no card and no
`--device cpu` it stops with an error. (Training runs no kernel: under
autograd attention takes the reference route.) The reference example
labels its unquantized run "bf16", but its QuantPolicy quantizes nothing,
so it trains in float32; the port says "f32".
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.layers import QuantPolicy
from repro_torch.runtime import Trainer, TrainerConfig


def train(cfg, steps, tag, *, model=None, device="cuda", batch=8, seq=64):
    """`steps` Trainer steps of `cfg` on the seeded synthetic stream, from
    `model` (default: the seed-0 init); returns the losses. `tag` names
    the run's (temporary) checkpoint directory."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix=f"fp8ex_{tag}_") as ckpt:
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt, ckpt_every=10 ** 9,
                                        total_steps=steps, base_lr=2e-3,
                                        warmup=5),
                     model, seed=0, device=dev)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq,
                                      seed=7))
        tr.run(iter(data), steps)
    return [m["loss"] for m in tr.metrics_log]


def configs():
    """qwen2 SMOKE unquantized, and with FP8-A activations and weights."""
    base = get_smoke("qwen2_1p5b")
    return base, dataclasses.replace(
        base, quant=QuantPolicy(activations="fp8a", weights="fp8a"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base, fp8 = configs()
    l_f32 = train(base, args.steps, "f32", device=dev)
    l_fp8 = train(fp8, args.steps, "fp8", device=dev)
    print(f"{'step':>5s} {'f32':>9s} {'fp8a':>9s}")
    for i in range(0, args.steps, max(args.steps // 10, 1)):
        print(f"{i:5d} {l_f32[i]:9.4f} {l_fp8[i]:9.4f}")
    final_gap = l_fp8[-1] - l_f32[-1]
    print(f"final-loss gap (fp8 - f32) = {final_gap:+.4f}")
    assert np.isfinite(l_fp8).all(), "fp8 training diverged"
    assert l_fp8[-1] < l_fp8[0], "fp8 training did not learn"
    print("fp8_training OK — FP8 trains (the premise of the paper's "
          "multi-format support)")
    return l_f32, l_fp8


if __name__ == "__main__":
    main()
