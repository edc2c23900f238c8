"""Quickstart on the PyTorch/CUDA port: the paper's two ideas in ten
minutes (the port's `examples/quickstart.py`).

1. The all-in-one format plane: quantize one tensor to every format the
   multiplier supports, and run a quantized matmul through the AIO GEMM
   kernel, the activations' codes through the quantizer kernel.
2. The morphable plane: run two unrelated "tenant" GEMMs through ONE
   grouped kernel launch (Fig 8 at kernel scale).
3. Train a small LM for a few steps with the production stack (the
   Trainer over the live world's mesh, AdamW master weights, checkpoints).

Run:  python examples/pt_quickstart.py [--device cpu] [--ckpt-dir DIR]

On the card (the default) the ops launch the hand-written kernels; with
`--device cpu` every kernel wrapper runs its plain PyTorch version. With
no card and no `--device cpu` it stops with an error. Each demo is a
function whose defaults are the sizes above, so a caller can run it
smaller.
"""
import argparse
import contextlib
import tempfile

import numpy as np
import torch

from repro_torch import api, resolve_device
from repro_torch.core import formats as F
from repro_torch.core.aio_mac import aio_fp_multiply

MODES = ("bf16", "int8", "fp8a")
TENANTS = ((100, 64, 96), (300, 120, 50))      # (M, K, N) of each tenant


def kernel_backend(device) -> str:
    """The backend that routes to the kernels: "cuda" on the card; "auto"
    on the CPU, where each kernel wrapper runs its plain version."""
    return "cuda" if torch.device(device).type == "cuda" else "auto"


def demo_formats(device="cuda"):
    """Quantize one vector to every format, fold a scale into fp8a's
    bias, and multiply two fp8a codes in the bit-accurate CSM model.
    Returns {format: values, "scaled": values, "csm": product}."""
    print("=== 1. all-in-one multiplier formats ===")
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.RandomState(0).randn(4)
                         .astype(np.float32) * 3).to(dev)
    out = {}
    for name in ("bf16", "fp8a", "fp8b", "int8", "int4"):
        out[name] = F.quantize(x, F.REGISTRY[name]).cpu().numpy()
        print(f"  {name:5s} {out[name]}")
    # programmable bias = free power-of-two scaling (paper §III)
    fmt = F.FP8A
    codes = F.encode(x, fmt)
    out["scaled"] = F.decode(codes, fmt.with_bias(fmt.bias - 3)).cpu() \
        .numpy()                                      # == x * 2^3
    print("  bias-folded x8 :", out["scaled"])

    # the bit-accurate hardware model multiplies codes directly
    a = F.encode(torch.tensor(1.5), fmt).numpy()
    b = F.encode(torch.tensor(-2.25), fmt).numpy()
    prod_code = aio_fp_multiply(a, b, fmt, fmt, F.BF16)
    out["csm"] = float(F.decode(torch.as_tensor(prod_code), F.BF16))
    print("  1.5 x -2.25 via CSM datapath =", out["csm"])
    return out


def demo_quant_matmul(device="cuda", n=256, backend=None):
    """An (n, n) x (n, n) product in each of MODES through `api.ops.matmul`
    (the AIO GEMM on the kernel route), and the activations' codes through
    `api.ops.quantize` (the quantizer). Returns {mode: (output, relative
    error against float32)} and {mode: (codes, scales)}."""
    print("=== 2. quantized matmul through the AIO GEMM kernel ===")
    dev = resolve_device(device)
    backend = backend or kernel_backend(dev)
    rng = np.random.RandomState(1)
    xn = rng.randn(n, n).astype(np.float32)
    wn = rng.randn(n, n).astype(np.float32)
    x, w = torch.from_numpy(xn).to(dev), torch.from_numpy(wn).to(dev)
    exact = xn @ wn
    # one policy object declares the backend once; the format plane sweeps
    outs, codes = {}, {}
    for mode in MODES:
        with api.policy(format=mode, backend=backend):
            out = api.ops.matmul(x, w).cpu().numpy()
            if mode != "bf16":
                q, s = api.ops.quantize(x)
                codes[mode] = (q.cpu().numpy(), s.cpu().numpy())
        rel = float(np.abs(out - exact).max() / np.abs(exact).max())
        outs[mode] = (out, rel)
        print(f"  {mode:5s} rel err vs f32 = {rel:.4f}")
    return outs, codes


def demo_morphable(device="cuda", shapes=TENANTS, backend=None):
    """The tenants' GEMMs in one grouped launch. Returns (results, pack
    utilization, each tenant's max |error| against float64)."""
    print("=== 3. morphable multi-tenant GEMM (Fig 8) ===")
    dev = resolve_device(device)
    rng = np.random.RandomState(2)
    host = [(rng.randn(m, k), rng.randn(k, n)) for m, k, n in shapes]
    tenants = [(torch.tensor(x, dtype=torch.float32, device=dev),
                torch.tensor(w, dtype=torch.float32, device=dev))
               for x, w in host]
    with api.policy(backend=backend or kernel_backend(dev)):
        results, util = api.ops.morphable_multi_gemm(tenants)
    results = [r.cpu().numpy() for r in results]
    errs = []
    for i, ((x, w), r) in enumerate(zip(tenants, results)):
        want = x.double().cpu().numpy() @ w.double().cpu().numpy()
        errs.append(float(np.abs(r - want).max()))
        print(f"  tenant {i}: shape {r.shape}, max err {errs[-1]:.2e}")
    print(f"  pack utilization = {util:.3f} (the Fig 14 metric)")
    return results, util, errs


@contextlib.contextmanager
def local_world():
    """The live world's process group, or a world of this one process
    (gloo: a (1, 1) mesh carries nothing) started here and ended after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    started = not dist.is_initialized()
    if started:
        init_world(backend="gloo", device="cpu")
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def demo_training(device="cuda", ckpt_dir=None, steps=6, batch=4, seq=32):
    """A few Trainer steps of the olmo-1b SMOKE config on the live world's
    mesh (`launch.mesh.make_local_mesh`). Returns the losses."""
    print("=== 4. few training steps on the production stack ===")
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import Trainer, TrainerConfig
    dev = resolve_device(device)
    cfg = get_smoke("olmo_1b")
    with local_world(), contextlib.ExitStack() as stack:
        if ckpt_dir is None:
            ckpt_dir = stack.enter_context(tempfile.TemporaryDirectory())
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir),
                                        ckpt_every=100, total_steps=10,
                                        base_lr=1e-3, warmup=2),
                     device=dev, mesh=make_local_mesh())
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=batch,
                                      seq=seq))
        tr.run(iter(data), steps, on_step=lambda s, m: print(
            f"  step {s}: loss {m['loss']:.4f}"))
    return [m["loss"] for m in tr.metrics_log]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                    "plain versions)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="the Trainer's checkpoint directory (default: a "
                    "temporary one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    demo_formats(dev)
    demo_quant_matmul(dev)
    demo_morphable(dev)
    demo_training(dev, args.ckpt_dir)
    print("quickstart OK")


if __name__ == "__main__":
    main()
