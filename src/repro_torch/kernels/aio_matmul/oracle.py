"""The AIO GEMM held to the paper's multiplier model bit for bit.

`core.aio_mac` models the all-in-one multiplier bit-accurately (the
reconstructed CSM, the programmable exponent adder, the normalizer and the
RNE rounder). One GEMM launch a mode computes an outer product of single
products: x holds M operand codes at k = 0, w holds N codes at k = 0, and
every other k position is a zero code (int4: the high nibble of w's packed
first byte is zero), with scales of 1 (none in bf16 mode). Each output
element is then exactly one product of the multiplier, and:

* fp8a x fp8a and fp8b x fp8b, every code pair (256 x 256; these formats
  reserve no code): the GEMM's f32 equals `aio_fp_multiply(a, b, f, f,
  BF16)` decoded, bitwise. Products of 4-bit significands are exact in
  bf16, so nothing rounds; the subnormal codes reach the kernel as bf16
  subnormals (`csrc/aio_matmul.cu` `fp8x2_to_bf16`).
* int8, all 256 x 256 pairs, and int4, all 16 x 16: equal to
  `aio_int_multiply`.
* bf16, 256 x 256 = 65,536 random pairs (values randn x 2^[-20, 20), as the
  reference's multiplier test draws them): the f32 product rounded to bf16
  by RNE has the code `aio_fp_multiply(a, b, BF16, BF16, BF16)`.

A zero product is compared as +0: the GEMM returns a K-long sum, and the
other positions' +0 products make it +0 whatever the product's sign.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...core import aio_mac
from ...core import formats as F
from .kernel import aio_matmul

__all__ = ["ORACLE_K", "ORACLE_MODES", "oracle_codes", "oracle_operands",
           "oracle_want", "oracle_mismatches", "oracle_check"]

ORACLE_K = 64          # contraction length of a launch (one live position)
ORACLE_MODES = ("fp8a", "fp8b", "int8", "int4", "bf16")


def oracle_codes(mode: str, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(a, b): the operand codes of x's rows and of w's columns (int64;
    fp modes their bit codes, int modes their signed values)."""
    if mode in ("fp8a", "fp8b"):
        codes = np.arange(256, dtype=np.int64)
        return codes, codes
    if mode == "int8":
        codes = np.arange(-128, 128, dtype=np.int64)
        return codes, codes
    if mode == "int4":
        codes = np.arange(-8, 8, dtype=np.int64)
        return codes, codes
    if mode != "bf16":
        raise ValueError(f"mode {mode!r} not in {ORACLE_MODES}")
    rng = np.random.RandomState(seed)
    vals = (rng.randn(2, 256) * 2.0 ** rng.randint(-20, 20, (2, 256))
            ).astype(np.float32)
    codes = F.np_encode_fp(vals, F.BF16)
    return codes[0], codes[1]


def oracle_operands(mode: str, a: np.ndarray, b: np.ndarray, device):
    """(x, w, x_scale, w_scale) of the outer-product launch."""
    m, n, k = len(a), len(b), ORACLE_K
    if mode == "bf16":
        x = np.zeros((m, k), np.int16)
        w = np.zeros((k, n), np.int16)
        x[:, 0] = a.astype(np.uint16).view(np.int16)
        w[0, :] = b.astype(np.uint16).view(np.int16)
        return (torch.from_numpy(x).view(torch.bfloat16).to(device),
                torch.from_numpy(w).view(torch.bfloat16).to(device),
                None, None)
    x = np.zeros((m, k), np.int8)
    w = np.zeros(((k + 1) // 2 if mode == "int4" else k, n), np.int8)
    if mode == "int4":
        x[:, 0] = a                          # one code a byte, low nibble
        w[0, :] = b & 0xF                    # k = 0 low, k = 1 high (0)
    else:
        x[:, 0] = (a & 0xFF).astype(np.uint8).view(np.int8)
        w[0, :] = (b & 0xFF).astype(np.uint8).view(np.int8)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
            torch.ones((m, 1), dtype=torch.float32, device=device),
            torch.ones((1, n), dtype=torch.float32, device=device))


def oracle_want(mode: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The multiplier model's (M, N) products: f32 values (fp8 and int
    modes, zeros as +0) or bf16 codes (bf16 mode)."""
    aa = np.repeat(a, len(b))
    bb = np.tile(b, len(a))
    shape = (len(a), len(b))
    if mode in ("fp8a", "fp8b"):
        fmt = F.REGISTRY[mode]
        code = aio_mac.aio_fp_multiply(aa, bb, fmt, fmt, F.BF16)
        val = F.np_decode_fp(code, F.BF16).astype(np.float32) + \
            np.float32(0.0)
        return val.reshape(shape)
    if mode in ("int8", "int4"):
        fmt = F.REGISTRY[mode]
        return aio_mac.aio_int_multiply(aa, bb, fmt, fmt).astype(
            np.float32).reshape(shape)
    return aio_mac.aio_fp_multiply(aa, bb, F.BF16, F.BF16,
                                   F.BF16).reshape(shape)


def oracle_mismatches(mode: str, out: torch.Tensor,
                      want: np.ndarray) -> np.ndarray:
    """(M, N) bool: the GEMM's outputs that differ from the model's, bit
    for bit (bf16 mode: after RNE to bf16)."""
    if mode == "bf16":
        got = out.to(torch.bfloat16).view(torch.int16).cpu().numpy()
        return (got.astype(np.int64) & 0xFFFF) != want
    got = out.cpu().numpy().view(np.int32)
    return got != want.astype(np.float32).view(np.int32)


def _subnormal(mode: str, codes: np.ndarray) -> np.ndarray:
    """Codes of a subnormal (nonzero, exponent field 0) fp operand."""
    if mode in ("int8", "int4"):
        return np.zeros(codes.shape, bool)
    fmt = F.REGISTRY[mode]
    mag = codes & ((1 << (fmt.ebits + fmt.mbits)) - 1)
    return (mag != 0) & ((mag >> fmt.mbits) == 0)


def oracle_check(mode: str, device, matmul: Optional[Callable] = None,
                 seed: int = 0) -> Dict[str, int]:
    """One outer-product launch of `matmul` (the `aio_matmul` wrapper by
    default: its kernel on a CUDA device, its plain version on the CPU)
    against the multiplier model: the counts of pairs and of mismatches,
    in all and among the pairs with a subnormal operand."""
    matmul = matmul or aio_matmul
    a, b = oracle_codes(mode, seed)
    x, w, xs, ws = oracle_operands(mode, a, b, device)
    out = matmul(x, w, xs, ws, mode=mode)
    bad = oracle_mismatches(mode, out, oracle_want(mode, a, b))
    sub = _subnormal(mode, a)[:, None] | _subnormal(mode, b)[None, :]
    return {"pairs": bad.size, "mismatches": int(bad.sum()),
            "subnormal_pairs": int(sub.sum()),
            "subnormal_mismatches": int((bad & sub).sum())}
