"""AIO number formats: the format registry, exact round-to-nearest-even
quantization, bit codes, power-of-two scales, int4 packing and resident
quantized weights — the torch counterpart of `repro.core.formats`.

Every function here is bit-for-bit the reference's on the values the
reference computes exactly. Powers of two are never made by exp2/pow
(approximations that drift off the exact power for large |exponent|):
`pow2_ceil` assembles them from IEEE-754 bits, and `_ldexp` scales in
float64 (exact) and rounds once to float32. Subnormal float32 values are
kept, as IEEE arithmetic (and the CUDA kernels, built without -ftz) keeps
them; JAX's CPU backend flushes them to zero, so a result that passes
through a float32 subnormal (a bf16 subnormal, or the FLT_MIN floor of
`pow2_scale` over an all-zero slice) differs from JAX on the CPU there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "AIOFormat", "fp_format", "int_format",
    "BF16", "FP8A", "FP8B", "FP16", "INT8", "INT4", "UINT8", "UINT4",
    "REGISTRY", "FLT_MIN", "quantize", "fake_quant", "dequantize_code",
    "encode", "decode", "pow2_ceil", "pow2_scale", "quantize_scaled",
    "bias_for_scale", "pack_int4", "unpack_int4", "QuantWeight",
    "quantize_weight", "dequantize_weight", "RESIDENT_FORMATS",
    "np_quantize_fp", "np_encode_fp", "np_decode_fp",
]

# smallest normal float32 (jnp.finfo(jnp.float32).tiny): pow2_scale's floor
FLT_MIN = torch.finfo(torch.float32).tiny

# Mantissa widths the reconstructed CSM supports natively (4b / 8b
# significands).
_HW_MANTISSA_BITS = (2, 3, 7)
# Exponent widths the programmable exponent adder supports.
_HW_EXPONENT_BITS = tuple(range(1, 9))


@dataclasses.dataclass(frozen=True)
class AIOFormat:
    """A number format the all-in-one multiplier can process.

    kind='fp':  value = (-1)^s * 1.M * 2^(E - bias)   (E=0 -> subnormal)
    kind='int': two's-complement (signed) or plain binary (unsigned) integer.
    """
    name: str
    kind: str                      # 'fp' | 'int'
    ebits: int = 0                 # fp only: exponent field width (1..8)
    mbits: int = 0                 # fp only: mantissa field width
    bias: int = 0                  # fp only: exponent bias (programmable)
    reserve_specials: bool = False # fp only: top exponent code = inf/nan
    bits: int = 0                  # int only: total width (4 or 8)
    signed: bool = True            # int only

    @property
    def emin(self) -> int:
        """Minimum *normal* unbiased exponent."""
        return 1 - self.bias

    @property
    def emax(self) -> int:
        """Maximum unbiased exponent of a finite normal value."""
        top = (1 << self.ebits) - 1
        if self.reserve_specials:
            top -= 1
        return top - self.bias

    @property
    def max_finite(self) -> float:
        if self.kind == "int":
            return float(self.int_max)
        return float((2.0 - 2.0 ** (-self.mbits)) * 2.0 ** self.emax)

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.emin - self.mbits))

    @property
    def total_bits(self) -> int:
        if self.kind == "int":
            return self.bits
        return 1 + self.ebits + self.mbits

    @property
    def int_min(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def int_max(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed \
            else (1 << self.bits) - 1

    @property
    def hw_native(self) -> bool:
        """Does the datapath of the reconstructed CSM support this directly?"""
        if self.kind == "int":
            return self.bits in (4, 8)
        return (self.ebits in _HW_EXPONENT_BITS
                and self.mbits in _HW_MANTISSA_BITS)

    @property
    def sig_width(self) -> int:
        """Significand datapath width the CSM uses (4b or 8b lanes)."""
        assert self.kind == "fp"
        return 8 if self.mbits > 3 else 4

    def with_bias(self, bias: int) -> "AIOFormat":
        """Programmable-bias variant (scaling factors fold into the bias)."""
        assert self.kind == "fp"
        return dataclasses.replace(self, bias=bias, name=f"{self.name}b{bias}")


def fp_format(name: str, ebits: int, mbits: int, bias: Optional[int] = None,
              reserve_specials: bool = False) -> AIOFormat:
    if not (1 <= ebits <= 8):
        raise ValueError(f"exponent width {ebits} outside the hardware range "
                         "1..8")
    if bias is None:
        bias = (1 << (ebits - 1)) - 1   # default 2^(E.L-1)-1 (paper §III)
    return AIOFormat(name=name, kind="fp", ebits=ebits, mbits=mbits, bias=bias,
                     reserve_specials=reserve_specials)


def int_format(name: str, bits: int, signed: bool = True) -> AIOFormat:
    if bits not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported int width {bits}")
    return AIOFormat(name=name, kind="int", bits=bits, signed=signed)


# The formats the paper evaluates (Table II) + IEEE-ish anchors.
BF16 = fp_format("bf16", 8, 7, reserve_specials=True)
FP16 = fp_format("fp16", 5, 10, reserve_specials=True)
FP8A = fp_format("fp8a", 4, 3)      # FP8-A {s:1,e:4,m:3}, saturating
FP8B = fp_format("fp8b", 5, 2)      # FP8-B {s:1,e:5,m:2}
INT8 = int_format("int8", 8, signed=True)
INT4 = int_format("int4", 4, signed=True)
UINT8 = int_format("uint8", 8, signed=False)
UINT4 = int_format("uint4", 4, signed=False)

REGISTRY = {f.name: f for f in (BF16, FP16, FP8A, FP8B, INT8, INT4, UINT8,
                                UINT4)}


# =============================================================================
# Exact powers of two
# =============================================================================

def _ldexp(x: torch.Tensor, e) -> torch.Tensor:
    """Exact x * 2^e for float32 x and integer e (tensor or int): the product
    is formed in float64, where it is exact for |e| < 1000, and rounded once
    (to nearest even) to float32 — what an exact ldexp gives."""
    if isinstance(e, torch.Tensor):
        p = torch.bitwise_left_shift(e.to(torch.int64) + 1023, 52).view(
            torch.float64)
    else:
        p = math.ldexp(1.0, int(e))
    return (x.to(torch.float64) * p).to(torch.float32)


def pow2_ceil(r: torch.Tensor) -> torch.Tensor:
    """Exact 2^ceil(log2(r)) for positive float32 r.

    frexp gives r = frac * 2^e2 with frac in [0.5, 1), so 2^e2 >= r — but at
    r exactly 2^k, frac == 0.5 and e2 == k+1: step the exponent back down so
    an exact power of two is its own scale.

    The power of two is assembled from its IEEE-754 bits, never through
    exp2/pow: normal exponents as a biased exponent field, exponents below
    -126 as a subnormal with a single mantissa bit, down to 2^-149.
    """
    frac, e2 = torch.frexp(r.to(torch.float32))
    e = torch.where(frac == 0.5, e2 - 1, e2).to(torch.int32)
    one = torch.ones_like(e)
    normal = torch.bitwise_left_shift((e + 127).clamp(1, 255), 23)
    subnormal = torch.bitwise_left_shift(one, (e + 149).clamp(0, 22))
    return torch.where(e >= -126, normal, subnormal).view(torch.float32)


# =============================================================================
# Quantization (value domain): x -> nearest representable value, RNE.
# =============================================================================

def _quantize_fp(x: torch.Tensor, fmt: AIOFormat) -> torch.Tensor:
    """Round-to-nearest-even x onto fmt's representable grid (saturating)."""
    x = x.to(torch.float32)
    a = x.abs()
    sgn = torch.where(torch.signbit(x), -1.0, 1.0).to(torch.float32)
    _, e2 = torch.frexp(a)                         # exact: a = f * 2^e2
    ebit = e2 - 1                                  # floor(log2 a) for a > 0
    eff = ebit.clamp(min=fmt.emin)                 # subnormal clamp
    step = eff - fmt.mbits
    q = _ldexp(torch.round(_ldexp(a, -step)), step)   # torch.round is RNE
    q = torch.minimum(q, torch.tensor(fmt.max_finite, dtype=torch.float32,
                                      device=q.device))   # saturate
    out = sgn * q
    out = torch.where(a == 0, sgn * 0.0, out)
    if fmt.reserve_specials:
        out = torch.where(torch.isinf(x) | torch.isnan(x), x, out)
    return out


def _quantize_int(x: torch.Tensor, fmt: AIOFormat) -> torch.Tensor:
    x = torch.round(x.to(torch.float32))           # RNE
    # clip as the reference does: a bound equal to x wins, so -0.0 clips
    # to a lower bound of +0.0 (torch.clamp would keep -0.0)
    lo, hi = float(fmt.int_min), float(fmt.int_max)
    x = torch.where(x <= lo, lo, x)
    return torch.where(x >= hi, hi, x)


def quantize(x: torch.Tensor, fmt: AIOFormat) -> torch.Tensor:
    """Project x onto fmt's representable values (returned as float32)."""
    if fmt.kind == "fp":
        return _quantize_fp(x, fmt)
    return _quantize_int(x, fmt)


class _FakeQuant(torch.autograd.Function):
    """`quantize` forward, identity backward (the straight-through
    estimator)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, fmt_name: str) -> torch.Tensor:
        return quantize(x, REGISTRY[fmt_name])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def fake_quant(x: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """Straight-through-estimator quantization for QAT paths: the value of
    `quantize(x, REGISTRY[fmt_name])`, the incoming gradient passed through
    unchanged (the reference's `custom_vjp`)."""
    return _FakeQuant.apply(x, fmt_name)


# ---- exact numpy/float64 reference (the reference package's oracle of the
# ---- bit-accurate multiplier model in ``aio_mac.py``; float64 keeps every
# ---- float32 subnormal, so it is the ground truth of the bit-level tests).

def np_quantize_fp(x: np.ndarray, fmt: AIOFormat) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    a = np.abs(x)
    sgn = np.copysign(1.0, x)
    with np.errstate(divide="ignore", invalid="ignore"):
        _, e2 = np.frexp(a)
    ebit = e2 - 1
    eff = np.maximum(ebit, fmt.emin)
    step_exp = eff - fmt.mbits
    # np.round is RNE
    q = np.ldexp(np.round(np.ldexp(a, -step_exp)), step_exp)
    q = np.minimum(q, fmt.max_finite)
    out = sgn * q
    out = np.where(a == 0, np.copysign(0.0, x), out)
    if fmt.reserve_specials:
        out = np.where(np.isinf(x), x, out)
        out = np.where(np.isnan(x), x, out)
    return out


def np_encode_fp(x: np.ndarray, fmt: AIOFormat) -> np.ndarray:
    q = np_quantize_fp(x, fmt)
    a = np.abs(q)
    sgn = np.signbit(q).astype(np.int64)
    _, e2 = np.frexp(a)
    ebit = e2 - 1
    is_normal = a >= 2.0 ** fmt.emin
    e_code = np.where(is_normal, ebit + fmt.bias, 0).astype(np.int64)
    m_norm = np.round(np.ldexp(a, -ebit) * (1 << fmt.mbits)) - (1 << fmt.mbits)
    m_sub = np.round(np.ldexp(a, -(fmt.emin - fmt.mbits)))
    m_code = np.where(is_normal, m_norm, m_sub).astype(np.int64)
    code = (sgn << (fmt.ebits + fmt.mbits)) | (e_code << fmt.mbits) | m_code
    code = np.where(a == 0, sgn << (fmt.ebits + fmt.mbits), code)
    if fmt.reserve_specials:
        top = (1 << fmt.ebits) - 1
        inf_code = (sgn << (fmt.ebits + fmt.mbits)) | (top << fmt.mbits)
        code = np.where(np.isinf(q), inf_code, code)
        code = np.where(np.isnan(q), inf_code | 1, code)
    return code


def np_decode_fp(code: np.ndarray, fmt: AIOFormat) -> np.ndarray:
    code = np.asarray(code, dtype=np.int64)
    m_mask = (1 << fmt.mbits) - 1
    m_code = code & m_mask
    e_code = (code >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    sgn = np.where((code >> (fmt.ebits + fmt.mbits)) & 1 == 1, -1.0, 1.0)
    normal = e_code > 0
    sig = np.where(normal, (1 << fmt.mbits) + m_code, m_code).astype(np.float64)
    exp = np.where(normal, e_code - fmt.bias, fmt.emin) - fmt.mbits
    val = sgn * np.ldexp(sig, exp)
    if fmt.reserve_specials:
        top = (1 << fmt.ebits) - 1
        val = np.where((e_code == top) & (m_code == 0), sgn * np.inf, val)
        val = np.where((e_code == top) & (m_code != 0), np.nan, val)
    return val


# =============================================================================
# Encode / decode (code domain): float <-> bit patterns.
# =============================================================================

def encode(x: torch.Tensor, fmt: AIOFormat) -> torch.Tensor:
    """Quantize and encode to the integer bit pattern (int32 container).

    fp layout: [sign | e_code | m_code]; int: two's complement in `bits`.
    """
    if fmt.kind == "int":
        q = _quantize_int(x, fmt).to(torch.int32)
        return q & ((1 << fmt.bits) - 1)
    q = _quantize_fp(x, fmt)
    a = q.abs()
    sgn = torch.signbit(q).to(torch.int32)
    _, e2 = torch.frexp(a)
    ebit = e2 - 1
    is_normal = a >= 2.0 ** fmt.emin
    e_code = torch.where(is_normal, ebit + fmt.bias, 0).to(torch.int32)
    # mantissa code: normal -> (a/2^ebit - 1) * 2^m; subnormal ->
    # a / 2^(emin-m)
    m_norm = torch.round(_ldexp(a, -ebit) * (1 << fmt.mbits)) \
        - (1 << fmt.mbits)
    m_sub = torch.round(_ldexp(a, -(fmt.emin - fmt.mbits)))
    m_code = torch.where(is_normal, m_norm, m_sub).to(torch.int32)
    sign_bit = sgn << (fmt.ebits + fmt.mbits)
    code = sign_bit | (e_code << fmt.mbits) | m_code
    code = torch.where(a == 0, sign_bit, code)
    if fmt.reserve_specials:
        top = (1 << fmt.ebits) - 1
        inf_code = sign_bit | (top << fmt.mbits)
        code = torch.where(torch.isinf(q), inf_code, code)
        code = torch.where(torch.isnan(q), inf_code | 1, code)
    return code


def decode(code: torch.Tensor, fmt: AIOFormat) -> torch.Tensor:
    """Integer bit pattern -> float32 value."""
    code = code.to(torch.int32)
    if fmt.kind == "int":
        if fmt.signed:
            shift = 32 - fmt.bits
            return ((code << shift) >> shift).to(torch.float32)  # sign extend
        return (code & ((1 << fmt.bits) - 1)).to(torch.float32)
    m_code = code & ((1 << fmt.mbits) - 1)
    e_code = (code >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    neg = ((code >> (fmt.ebits + fmt.mbits)) & 1) == 1
    sgn = torch.where(neg, -1.0, 1.0).to(torch.float32)
    normal = e_code > 0
    sig = torch.where(normal, (1 << fmt.mbits) + m_code, m_code).to(
        torch.float32)
    exp = torch.where(normal, e_code - fmt.bias, fmt.emin) - fmt.mbits
    val = sgn * _ldexp(sig, exp)
    if fmt.reserve_specials:
        top = (1 << fmt.ebits) - 1
        val = torch.where((e_code == top) & (m_code == 0), sgn * math.inf, val)
        val = torch.where((e_code == top) & (m_code != 0), math.nan, val)
    return val


def dequantize_code(code: torch.Tensor, fmt: AIOFormat,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    v = decode(code, fmt)
    if scale is not None:
        v = v * scale
    return v


# =============================================================================
# Scale handling — the programmable-bias trick.
# =============================================================================

def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    a = x.to(torch.float32).abs()
    return a.amax() if axis is None else a.amax(axis, keepdim=True)


def pow2_scale(x: torch.Tensor, fmt: AIOFormat, axis=None) -> torch.Tensor:
    """Power-of-two scale 2^ceil(log2(max|x| / max_finite)) (max|x| floored
    at FLT_MIN), so that x/scale fits fmt; an exact power of two is its own
    scale. Powers of two fold into the programmable exponent bias."""
    return pow2_ceil(_amax(x, axis).clamp_min(FLT_MIN) / fmt.max_finite)


def quantize_scaled(x: torch.Tensor, fmt: AIOFormat, axis=None,
                    pow2: bool = True):
    """Returns (codes int32, scale) with x ≈ decode(codes) * scale.

    pow2=True uses the bias-foldable power-of-two scale; pow2=False an exact
    float32 scale."""
    if pow2:
        scale = pow2_scale(x, fmt, axis=axis)
    else:
        scale = _amax(x, axis).clamp_min(FLT_MIN) / fmt.max_finite
    return encode(x.to(torch.float32) / scale, fmt), scale


def bias_for_scale(fmt: AIOFormat, scale_log2: int) -> AIOFormat:
    """Fold a 2^k scale into the format's programmable bias:
    decode(code, bias_for_scale(fmt, k)) == decode(code, fmt) * 2^k."""
    return fmt.with_bias(fmt.bias - scale_log2)


# =============================================================================
# INT4 lane packing: two int4 values per int8 byte.
# =============================================================================

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (low nibble valid) pairwise along the last axis into
    int8: out[..., i] = codes[..., 2i] | codes[..., 2i+1] << 4.

    An odd last axis is zero-padded with one phantom nibble (code 0 == value
    0); `unpack_int4(..., k=K)` restores the original length exactly."""
    codes = codes.to(torch.int32)
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    lo = codes[..., 0::2] & 0xF
    hi = codes[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, signed: bool = True,
                k: Optional[int] = None) -> torch.Tensor:
    """Inverse of pack_int4 -> int32 values (sign-extended if signed).

    k: original (possibly odd) last-axis length; trims the phantom nibble."""
    p = packed.to(torch.int32) & 0xFF
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    if signed:
        lo = (lo << 28) >> 28
        hi = (hi << 28) >> 28
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                packed.shape[-1] * 2)
    return out if k is None else out[..., :k]


# =============================================================================
# Weight residency — quantized weights as a storage format.
# =============================================================================

# Formats a Linear weight can be resident in (bf16 residency is just dtype).
RESIDENT_FORMATS = ("int4", "int8", "fp8a", "fp8b")


@dataclasses.dataclass
class QuantWeight:
    """A Linear weight living as codes + per-output-channel pow2 scales.

    codes: int8. For int8/fp8a/fp8b the raw bit codes, shape (..., K, N);
           for int4 two codes packed per byte along K (low nibble = even K),
           shape (..., ceil(K/2), N).
    scale: float32 (..., 1, N) power-of-two per-output-channel scales.
    fmt:   format name.
    k:     unpacked contraction length (int4 packing pads an odd K).
    """
    codes: torch.Tensor
    scale: torch.Tensor
    fmt: str
    k: int

    @property
    def bytes_per_param(self) -> float:
        """Device bytes per weight element (codes only)."""
        return 0.5 if self.fmt == "int4" else 1.0


def quantize_weight(w: torch.Tensor, fmt_name: str) -> QuantWeight:
    """Convert a dense (..., K, N) weight into resident codes, once:
    per-output-channel pow2 scales over the K axis (axis=-2), int4 packed
    two per byte along K."""
    if fmt_name not in RESIDENT_FORMATS:
        raise ValueError(f"weight format {fmt_name!r} not in "
                         f"{RESIDENT_FORMATS}")
    k = w.shape[-2]
    codes, scale = quantize_scaled(w, REGISTRY[fmt_name], axis=-2)
    if fmt_name == "int4":
        codes = pack_int4(codes.transpose(-1, -2)).transpose(-1, -2)
    return QuantWeight(codes=codes.to(torch.int8).contiguous(),
                       scale=scale.to(torch.float32), fmt=fmt_name, k=k)


def dequantize_weight(qw: QuantWeight) -> torch.Tensor:
    """Resident codes -> dense float32 (..., K, N) weight."""
    if qw.fmt == "int4":
        vals = unpack_int4(qw.codes.transpose(-1, -2), signed=True,
                           k=qw.k).transpose(-1, -2).to(torch.float32)
    else:
        vals = decode(qw.codes, REGISTRY[qw.fmt])
    return vals * qw.scale
