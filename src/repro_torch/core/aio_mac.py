"""Bit-accurate functional model of the paper's all-in-one multiplier (§III).

Datapath modeled (Fig 7):
  1. XOR bundle            -> product sign
  2. programmable exponent adder bundle -> E_A + E_B - bias (bias is an input!)
  3. reconstructed carry-save multiplier: four 5b x 5b *signed* sub-multipliers
     combined by shift-add (8x8 -> 1 result, 4x8/8x4 -> 2, 4x4 -> 4 results)
  4. normalizer bundle     -> renormalize product into [1, 2)
  5. rounder bundle        -> RNE to the selected output precision

INT modes gate everything except the CSM: the CSM's shift-added output IS the
multiplier output (exact integer product), accumulated downstream in wide int.

Everything is vectorized numpy over int64 so the whole model is testable at
scale against the exact float reference. This module is the *oracle* for the
CUDA kernels: kernels emulate values; this model emulates the hardware
(`chip_smoke.py` holds the AIO GEMM's single products to it bit for bit).
A copy of `repro.core.aio_mac` over the port's `formats.AIOFormat`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .formats import AIOFormat

__all__ = [
    "submul_5x5", "csm_multiply_8x8", "csm_multiply_4x4x4", "csm_int",
    "aio_int_multiply", "aio_fp_multiply", "fp_decompose", "fp_compose",
]


# -----------------------------------------------------------------------------
# Reconstructed carry-save multiplier
# -----------------------------------------------------------------------------

def submul_5x5(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One 5b x 5b signed sub-multiplier (the CSM's atomic unit).

    Inputs must lie in [-16, 15]; output is the exact 10b product. The range
    assert is the hardware contract — violating it means the decomposition
    feeding this unit is wrong.
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if np.any((a < -16) | (a > 15)) or np.any((b < -16) | (b > 15)):
        raise ValueError("sub-multiplier operand outside signed 5-bit range")
    return a * b


def _split_nibbles_signed(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x (signed 8b) = hi*16 + lo with hi signed 4b (sign-extended to 5b), lo unsigned."""
    x = np.asarray(x, dtype=np.int64)
    lo = x & 0xF
    hi = (x - lo) >> 4
    return hi, lo


def _split_nibbles_unsigned(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.int64) & 0xFF
    return (x >> 4) & 0xF, x & 0xF


def csm_multiply_8x8(a: np.ndarray, b: np.ndarray, signed: bool = True) -> np.ndarray:
    """8x8 mode: one product from four sub-multipliers via shift-add fusion."""
    split = _split_nibbles_signed if signed else _split_nibbles_unsigned
    ah, al = split(a)
    bh, bl = split(b)
    # four 5b x 5b sub-multiplications (the "selective adder" sums them in INT/FP mode)
    hh = submul_5x5(ah, bh)
    hl = submul_5x5(ah, bl)
    lh = submul_5x5(al, bh)
    ll = submul_5x5(al, bl)
    return (hh << 8) + ((hl + lh) << 4) + ll


def csm_multiply_4x4x4(a4: np.ndarray, b4: np.ndarray, signed: bool = True) -> np.ndarray:
    """4x4 mode: four *independent* products per multiplier (throughput x4).

    a4, b4: (..., 4) arrays of 4-bit operands. Returns (..., 4) products.
    This is the mode that makes a 128x128 MAC array act as 256x256 (Table III).
    """
    a4 = np.asarray(a4, dtype=np.int64)
    b4 = np.asarray(b4, dtype=np.int64)
    if signed:
        lo_a, lo_b = ((a4 << 60) >> 60), ((b4 << 60) >> 60)   # sign-extend 4b
    else:
        lo_a, lo_b = a4 & 0xF, b4 & 0xF
    return submul_5x5(lo_a, lo_b)


def csm_multiply_4x8(a4: np.ndarray, b8: np.ndarray, signed: bool = True) -> np.ndarray:
    """4x8 / 8x4 mode: two products per multiplier (throughput x2).

    a4: (..., 2) of 4b operands, b8: (..., 2) of 8b operands -> (..., 2)."""
    a4 = np.asarray(a4, dtype=np.int64)
    if signed:
        a = (a4 << 60) >> 60
        bh, bl = _split_nibbles_signed(b8)
    else:
        a = a4 & 0xF
        bh, bl = _split_nibbles_unsigned(b8)
    return (submul_5x5(a, bh) << 4) + submul_5x5(a, bl)


def csm_int(a: np.ndarray, b: np.ndarray, bits_a: int, bits_b: int,
            signed: bool = True) -> np.ndarray:
    """Dispatch to the CSM mode for an INT multiply (paper Fig 5)."""
    if bits_a == 8 and bits_b == 8:
        return csm_multiply_8x8(a, b, signed)
    if bits_a == 4 and bits_b == 4:
        return csm_multiply_4x4x4(a, b, signed)
    if bits_a == 4 and bits_b == 8:
        return csm_multiply_4x8(a, b, signed)
    if bits_a == 8 and bits_b == 4:
        return csm_multiply_4x8(b, a, signed)
    raise ValueError(f"unsupported CSM mode {bits_a}x{bits_b}")


# -----------------------------------------------------------------------------
# INT mode (all bundles except the CSM are gated — Fig 7-(d))
# -----------------------------------------------------------------------------

def aio_int_multiply(a: np.ndarray, b: np.ndarray, fmt_a: AIOFormat,
                     fmt_b: AIOFormat) -> np.ndarray:
    """Exact integer product(s); accumulation happens downstream in wide int."""
    assert fmt_a.kind == fmt_b.kind == "int"
    assert fmt_a.signed == fmt_b.signed, "mixed-signedness not a hardware mode"
    return csm_int(a, b, fmt_a.bits, fmt_b.bits, signed=fmt_a.signed)


# -----------------------------------------------------------------------------
# FP mode
# -----------------------------------------------------------------------------

def fp_decompose(code: np.ndarray, fmt: AIOFormat):
    """code -> (sign, significand integer SA, exponent of SA's LSB).

    value = (-1)^sign * SA * 2^lsb_exp. Subnormals (e_code==0) have no hidden 1.
    """
    code = np.asarray(code, dtype=np.int64)
    m_mask = (1 << fmt.mbits) - 1
    m_code = code & m_mask
    e_code = (code >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    sign = (code >> (fmt.ebits + fmt.mbits)) & 1
    normal = e_code > 0
    sig = np.where(normal, (1 << fmt.mbits) + m_code, m_code)
    lsb_exp = np.where(normal, e_code - fmt.bias, fmt.emin) - fmt.mbits
    return sign, sig, lsb_exp


def _bit_length(p: np.ndarray) -> np.ndarray:
    """Exact bit length of non-negative int64 < 2^53 (0 -> 0)."""
    _, e2 = np.frexp(p.astype(np.float64))
    return e2.astype(np.int64)


def fp_compose(sign: np.ndarray, p: np.ndarray, lsb_exp: np.ndarray,
               out_fmt: AIOFormat) -> np.ndarray:
    """Normalizer + rounder bundles: value (-1)^sign * p * 2^lsb_exp -> out code.

    Integer-exact RNE with guard/round/sticky, subnormal handling, saturation.
    """
    sign = np.asarray(sign, dtype=np.int64)
    p = np.asarray(p, dtype=np.int64)
    lsb_exp = np.asarray(lsb_exp, dtype=np.int64)

    nbits = _bit_length(p)                       # p in [2^(nbits-1), 2^nbits)
    ebit = nbits - 1 + lsb_exp                   # floor(log2 value)
    eff = np.maximum(ebit, out_fmt.emin)
    step_exp = eff - out_fmt.mbits               # LSB weight of the target grid

    shift = step_exp - lsb_exp                   # >0: round; <=0: exact shift-up
    # Cap the right-shift at 62: for p < 2^54 any shift >= 62 already yields
    # q0=0, rem=p < half, i.e. a clean round-to-zero — and numpy's int64 shift
    # is UB beyond 63.
    sh_pos = np.minimum(np.maximum(shift, 0), 62)
    sh_neg = np.maximum(-shift, 0)
    q0 = p >> sh_pos
    rem = p - (q0 << sh_pos)
    half = np.where(sh_pos > 0, np.int64(1) << np.maximum(sh_pos - 1, 0), np.int64(0))
    round_up = (rem > half) | ((rem == half) & (sh_pos > 0) & ((q0 & 1) == 1))
    q = (q0 + round_up.astype(np.int64)) << sh_neg

    # rounding may carry into the next binade: q == 2^(mbits+1) * 2^k — fine,
    # re-derive exponent from q.
    qbits = _bit_length(q)
    out_ebit = qbits - 1 + step_exp

    # saturate (the hardware's FP modes have no inf except IEEE-style bf16)
    max_sig = (1 << (out_fmt.mbits + 1)) - 1     # 1.111..1
    overflow = out_ebit > out_fmt.emax
    q = np.where(overflow, max_sig, q)
    out_ebit = np.where(overflow, out_fmt.emax, out_ebit)
    step_out = np.where(overflow, out_fmt.emax - out_fmt.mbits, step_exp)

    # encode
    is_normal = out_ebit >= out_fmt.emin
    is_zero = q == 0
    # align q so its LSB sits at (out_ebit - mbits) for normals, (emin - mbits) subnormals
    target_lsb = np.where(is_normal, out_ebit - out_fmt.mbits,
                          out_fmt.emin - out_fmt.mbits)
    realign = target_lsb - step_out
    q_al = np.where(realign >= 0, q >> np.maximum(realign, 0),
                    q << np.maximum(-realign, 0))
    e_code = np.where(is_normal, out_ebit + out_fmt.bias, 0)
    m_code = np.where(is_normal, q_al - (1 << out_fmt.mbits), q_al)
    e_code = np.where(is_zero, 0, e_code)
    m_code = np.where(is_zero, 0, m_code)
    return (sign << (out_fmt.ebits + out_fmt.mbits)) | (e_code << out_fmt.mbits) | m_code


def _csm_for_fp(sig_a: np.ndarray, sig_b: np.ndarray, fmt_a: AIOFormat,
                fmt_b: AIOFormat) -> np.ndarray:
    """Route FP significand products through the CSM datapath.

    8b significands (m=7) use 8x8 fusion; 4b significands (m<=3) use the 4x4
    sub-multipliers directly (this is why FP8 gets 4 results/multiplier). FP8-B
    {1,5,2} is zero-padded into the 4b lane (pad at LSB = multiply by 2, which
    we compensate in the caller via lsb_exp).
    """
    wa, wb = fmt_a.sig_width, fmt_b.sig_width
    if wa == 8 and wb == 8:
        return csm_multiply_8x8(sig_a, sig_b, signed=False)
    if wa == 4 and wb == 4:
        return csm_multiply_4x4x4(sig_a, sig_b, signed=False)
    if wa == 4:
        return csm_multiply_4x8(sig_a, sig_b, signed=False)
    return csm_multiply_4x8(sig_b, sig_a, signed=False)


def aio_fp_multiply(code_a: np.ndarray, code_b: np.ndarray, fmt_a: AIOFormat,
                    fmt_b: AIOFormat, out_fmt: AIOFormat,
                    bias_adjust: int = 0) -> np.ndarray:
    """Full FP path: codes in fmt_a/fmt_b -> exact product -> RNE code in out_fmt.

    bias_adjust models the *programmable* bias input: the result is scaled by
    2^bias_adjust at zero hardware cost (paper: scaling factors fold into the
    exponent adder's bias port instead of needing extra multipliers).
    """
    assert fmt_a.kind == fmt_b.kind == "fp" and out_fmt.kind == "fp"
    sa, sig_a, ea = fp_decompose(code_a, fmt_a)
    sb, sig_b, eb = fp_decompose(code_b, fmt_b)

    # zero-pad narrow significands into the 4b/8b CSM lanes (LSB pad => <<1)
    pad_a = fmt_a.sig_width - (fmt_a.mbits + 1)
    pad_b = fmt_b.sig_width - (fmt_b.mbits + 1)
    p = _csm_for_fp(sig_a << pad_a, sig_b << pad_b, fmt_a, fmt_b)

    sign = sa ^ sb                                # XOR bundle
    lsb = ea + eb - pad_a - pad_b + bias_adjust   # programmable exponent adder
    return fp_compose(sign, p, lsb, out_fmt)
