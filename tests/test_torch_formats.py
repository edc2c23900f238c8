"""Port parity of the AIO format algebra (`repro_torch.core.formats`, and the
fp code helpers of `repro_torch.kernels.common`) with `repro.core.formats`:
codes, values, scales and packing bitwise equal, on every code of the
narrow formats, on random values and on the edge values (signed zeros,
max_finite and just above, format subnormals, RNE halfway points, inf/nan).

JAX's CPU backend flushes float32 subnormals to zero; the port keeps them
(IEEE, as the CUDA kernels do). Where a result passes through a float32
subnormal the port is held to the reference's exact float64 oracle
(`np_quantize_fp`) instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import common as jcommon
from repro_torch.core import formats as F
from repro_torch.kernels import common

import _xdist_threads  # noqa: F401  (one torch thread a worker)

NARROW = ["fp8a", "fp8b", "int8", "uint8", "int4", "uint4"]


class _J:
    """Reference functions under one jit each (eager JAX compiles every
    primitive anew for every shape, most of this file's time). Only those
    free of a division by a constant: under jit XLA turns x / c into
    x * (1 / c), one ulp off, so pow2_scale, quantize_scaled and
    quantize_weight run eagerly, as the reference's definition of them."""
    quantize = jax.jit(JF.quantize, static_argnums=1)
    encode = jax.jit(JF.encode, static_argnums=1)
    decode = jax.jit(JF.decode, static_argnums=1)
    fake_quant = jax.jit(JF.fake_quant, static_argnums=1)
    dequantize_weight = jax.jit(JF.dequantize_weight)
    pack_int4 = jax.jit(JF.pack_int4)
    unpack_int4 = jax.jit(JF.unpack_int4, static_argnames=("signed", "k"))
    encode_fp_code = jax.jit(jcommon.encode_fp_code, static_argnums=(1, 2, 3))
    decode_fp_code = jax.jit(jcommon.decode_fp_code, static_argnums=(1, 2, 3))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


def _edge_values(name: str) -> np.ndarray:
    """Normal-float32 edge values of format `name`: signed zeros, the
    largest finite value and just above it, the format's subnormals, RNE
    halfway points between neighbouring codes, and random values over the
    format's range."""
    fmt = JF.REGISTRY[name]
    rng = np.random.RandomState(7)
    mf = fmt.max_finite
    vals = [0.0, -0.0, mf, -mf, mf * 1.0001, -mf * 1.01, mf * 4, 1.0, -1.0]
    if fmt.kind == "fp":
        # format subnormals (k * min_subnormal) and their halfway points,
        # as long as they are normal float32
        ms = fmt.min_subnormal
        if ms >= np.finfo(np.float32).tiny:
            vals += [k * ms for k in range(-9, 10)]
            vals += [(k + 0.5) * ms for k in range(-6, 6)]
        # halfway points between neighbouring normal codes in a few binades
        for e in (fmt.emin, 0, 3, fmt.emax - 1):
            step = 2.0 ** (e - fmt.mbits)
            base = 2.0 ** e
            vals += [base + (j + 0.5) * step for j in range(4)]
            vals += [-(base + (j + 0.5) * step) for j in range(4)]
        low = max(fmt.min_subnormal * 4, float(np.finfo(np.float32).tiny))
        span = np.exp(rng.uniform(np.log(low), np.log(mf), 300))
        vals += list(span * rng.choice([-1, 1], 300))
    else:
        vals += [k + 0.5 for k in range(-10, 10)] + [fmt.int_min - 0.5,
                                                    fmt.int_max + 0.5]
        vals += list(rng.uniform(fmt.int_min - 3, fmt.int_max + 3, 300))
    return np.asarray(vals, np.float32)


@pytest.mark.parametrize("name", NARROW)
def test_encode_decode_every_code_bitwise(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    codes = np.arange(1 << jfmt.total_bits, dtype=np.int32)
    vals = F.decode(torch.from_numpy(codes), fmt)
    _same(vals, _J.decode(jnp.asarray(codes), jfmt))
    # and back: every decoded value encodes to the reference's code
    _same(F.encode(vals, fmt), _J.encode(jnp.asarray(vals.numpy()), jfmt))


@pytest.mark.parametrize("name", NARROW + ["bf16", "fp16"])
def test_quantize_and_encode_edge_values_bitwise(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    x = _edge_values(name)
    _same(F.quantize(torch.from_numpy(x), fmt), _J.quantize(jnp.asarray(x),
                                                             jfmt))
    _same(F.encode(torch.from_numpy(x), fmt), _J.encode(jnp.asarray(x), jfmt))
    _same(F.fake_quant(torch.from_numpy(x), name),
          _J.fake_quant(jnp.asarray(x), name))


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_specials_pass_through(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    x = np.asarray([np.inf, -np.inf, np.nan, 1.0], np.float32)
    np.testing.assert_array_equal(
        F.quantize(torch.from_numpy(x), fmt).numpy(),
        np.asarray(_J.quantize(jnp.asarray(x), jfmt)))
    _same(F.encode(torch.from_numpy(x), fmt), _J.encode(jnp.asarray(x), jfmt))


def test_float32_subnormals_match_the_exact_oracle():
    """bf16 subnormals are float32 subnormals: the port rounds them as the
    reference's float64 oracle does (JAX on the CPU flushes them)."""
    x = np.asarray([1e-40, -3e-39, 2.0 ** -130 * 1.5, 2.0 ** -133 * 2.5,
                    2.0 ** -127 * 1.75], np.float32)
    got = F.quantize(torch.from_numpy(x), F.BF16).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(JF.np_quantize_fp(x, JF.BF16).astype(np.float32)))
    codes = F.encode(torch.from_numpy(x), F.BF16)
    _same(codes, JF.np_encode_fp(x, JF.BF16).astype(np.int32))
    _same(F.decode(codes, F.BF16),
          JF.np_decode_fp(codes.numpy(), JF.BF16).astype(np.float32))


@pytest.mark.parametrize("name", ["fp8a", "fp8b", "int8", "int4"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_pow2_scale_and_quantize_scaled_bitwise(name, axis):
    rng = np.random.RandomState(3)
    x = (rng.randn(12, 40) * np.exp(rng.uniform(-8, 8, (12, 1)))).astype(
        np.float32)
    x[3] = 0.25            # an exact power of two is its own scale's max
    x[5, :] = 1e-32        # below the kernels' 1e-30 floor, above FLT_MIN's
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    _same(F.pow2_scale(torch.from_numpy(x), fmt, axis=axis),
          JF.pow2_scale(jnp.asarray(x), jfmt, axis=axis))
    for pow2 in (True, False):
        codes, scale = F.quantize_scaled(torch.from_numpy(x), fmt, axis=axis,
                                         pow2=pow2)
        jcodes, jscale = JF.quantize_scaled(jnp.asarray(x), jfmt, axis=axis,
                                            pow2=pow2)
        _same(codes, jcodes)
        _same(scale, jscale)


def test_bias_for_scale_folds_the_scale():
    codes = torch.arange(256, dtype=torch.int32)
    for k in (-3, 0, 2):
        folded = F.bias_for_scale(F.FP8A, k)
        jfolded = JF.bias_for_scale(JF.FP8A, k)
        assert (folded.name, folded.bias) == (jfolded.name, jfolded.bias)
        _same(F.decode(codes, folded),
              F.dequantize_code(codes, F.FP8A,
                                torch.tensor(2.0 ** k)))


@pytest.mark.parametrize("name", ["fp8a", "fp8b"])
def test_kernel_code_helpers_match_formats(name):
    """`encode_fp_code`/`decode_fp_code` (the kernels' plain helpers) equal
    the reference's `formats.encode`/`decode` everywhere, and the
    reference's in-kernel helpers wherever those agree with
    `formats.encode`/`decode`. They do not everywhere: they scale by exp2,
    which XLA's CPU backend computes inexactly (exp2(-16) < 2^-16), so a
    decoded value can be one ulp low and a value that rounds up onto a
    binade edge gets a wrong code (fp8b 7.5 * 2^-16 encodes to code 4,
    value 2^-14, not code 8, 2^-13)."""
    jfmt = JF.REGISTRY[name]
    args = (jfmt.ebits, jfmt.mbits, jfmt.bias)
    x = _edge_values(name)
    x = x[np.abs(x) <= jfmt.max_finite * 1.0001]
    got = common.encode_fp_code(torch.from_numpy(x), *args).numpy()
    exact = np.asarray(_J.encode(jnp.asarray(x), jfmt))
    np.testing.assert_array_equal(got, exact)
    jkernel = np.asarray(_J.encode_fp_code(jnp.asarray(x), *args))
    agree = jkernel == exact
    np.testing.assert_array_equal(got[agree], jkernel[agree])
    if name == "fp8b":
        assert not agree.all()          # the exp2 deviation shows here
    codes = np.arange(256, dtype=np.int32)
    got = _bits(common.decode_fp_code(torch.from_numpy(codes), *args).numpy())
    exact = _bits(_J.decode(jnp.asarray(codes), jfmt))
    np.testing.assert_array_equal(got, exact)
    jkernel = _bits(_J.decode_fp_code(jnp.asarray(codes), *args))
    agree = jkernel == exact
    np.testing.assert_array_equal(got[agree], jkernel[agree])


@pytest.mark.parametrize("k", [6, 7])
def test_pack_unpack_int4_odd_k_roundtrip(k):
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 16, (3, k)).astype(np.int32)
    packed = F.pack_int4(torch.from_numpy(codes))
    _same(packed, _J.pack_int4(jnp.asarray(codes)))
    assert packed.shape == (3, (k + 1) // 2) and packed.dtype == torch.int8
    for signed in (True, False):
        _same(F.unpack_int4(packed, signed=signed, k=k),
              _J.unpack_int4(jnp.asarray(packed.numpy()), signed=signed, k=k))


@pytest.mark.parametrize("fmt", F.RESIDENT_FORMATS)
@pytest.mark.parametrize("k", [16, 13])
def test_quantize_weight_stacked_bitwise(fmt, k):
    rng = np.random.RandomState(2)
    w = (rng.randn(3, k, 10) * 0.3).astype(np.float32)
    qw = F.quantize_weight(torch.from_numpy(w), fmt)
    jqw = JF.quantize_weight(jnp.asarray(w), fmt)
    assert (qw.fmt, qw.k, qw.bytes_per_param) == (jqw.fmt, jqw.k,
                                                  jqw.bytes_per_param)
    assert qw.codes.dtype == torch.int8
    _same(qw.codes, jqw.codes)
    _same(qw.scale, jqw.scale)
    _same(F.dequantize_weight(qw), _J.dequantize_weight(jqw))


def test_quantize_weight_rejects_non_resident_formats():
    for bad in ("bf16", "fp16", "uint8", "nope"):
        with pytest.raises(ValueError, match="not in"):
            F.quantize_weight(torch.zeros(4, 4), bad)


def test_registry_matches():
    assert list(F.REGISTRY) == list(JF.REGISTRY)
    for name, jfmt in JF.REGISTRY.items():
        fmt = F.REGISTRY[name]
        for attr in ("kind", "ebits", "mbits", "bias", "reserve_specials",
                     "bits", "signed", "emin", "emax", "max_finite",
                     "min_subnormal", "total_bits", "hw_native"):
            assert getattr(fmt, attr) == getattr(jfmt, attr), (name, attr)
