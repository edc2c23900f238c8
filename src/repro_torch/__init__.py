"""PyTorch/CUDA port of the `repro` serving main path.

The JAX/Pallas package `repro` is the reference; this package does the same
work in PyTorch, with every Pallas kernel on its path replaced by a kernel
written by hand in CUDA C++ for Hopper (`sm_90a`). It imports `torch`,
`numpy` and the standard library only — never `jax` and never `repro`.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead. Dense float32 products stay in full float32: TF32 is
switched off here, as JAX computes them on the CPU.
"""
from __future__ import annotations

import torch

# full-f32 matmuls, as the JAX reference computes them (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" (the default everywhere)
    needs a card: without one this raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
