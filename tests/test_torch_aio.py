"""Port parity of the AIO GEMM (B5) and the AIO quantizer (B10): their plain
versions (what the kernel wrappers run on CPU tensors, and what the card's
kernels are held to) against the JAX package's Pallas kernels in interpret
mode and its oracles, and the `matmul` / `matmul_codes` / `quantize` ops'
routes against the reference's.

Tolerances: integer modes and the quantizer bitwise; float modes (bf16,
fp8a, fp8b) rtol 2e-5, atol 2e-5 * max|ref| — the reference's own
(`tests/test_kernels.py`), for float32 sums taken in another order.

JAX's CPU backend flushes float32 subnormals and computes exp2 inexactly;
the port does neither (see `test_torch_formats.py`). So an all-zero row
under the FLT_MIN floor is held to the exact scale, and the reference
quantizer kernel's fp codes are compared where they agree with the
reference's exact encoder."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import formats as JF
from repro.kernels.aio_matmul import aio_matmul_codes as jaio_matmul_codes
from repro.kernels.aio_matmul import aio_matmul_ref as jaio_matmul_ref
from repro.kernels.aio_matmul import \
    quantize_operands_ref as jquantize_operands_ref
from repro_torch import api
from repro_torch.core import formats as F
from repro_torch.kernels.aio_matmul import (aio_matmul, aio_matmul_codes,
                                            aio_matmul_plain, aio_matmul_ref,
                                            gemm_plan, quantize_operands_ref)
from repro_torch.kernels.aio_quant import (KERNEL_FLOOR, aio_quant,
                                           aio_quant_plain, quant_edge_rows)
from repro_torch.kernels.aio_quant.ops import (CLUSTER_SIZES, MAX_THREADS,
                                               MAX_UNITS, plan_with,
                                               quant_plan)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

MODES = ["bf16", "fp8a", "fp8b", "int8", "int4"]

INT_MODES = ("int8", "int4")

# the reference's functions under one jit each (eager JAX compiles every
# primitive anew for every shape, most of this file's time) — except the
# pow2 scale, which runs eagerly as defined: under jit XLA turns its
# amax / max_finite into amax * (1 / max_finite), one ulp off.
_jmatmul_codes = jax.jit(jaio_matmul_codes, static_argnames="mode")
_jmatmul_ref = jax.jit(jaio_matmul_ref, static_argnames="mode")
_jencode = jax.jit(JF.encode, static_argnums=1)


def _jquantize_scaled(x, fmt, axis):
    """The reference's `quantize_scaled` (pow2): its two steps, the scale
    eagerly and the encode under jit."""
    scale = JF.pow2_scale(x, fmt, axis=axis)
    return _jencode(x / scale, fmt), scale


def _jquantize_operands(x, w, mode):
    """The reference's `quantize_operands_ref`, through the above."""
    if mode == "bf16":
        return jquantize_operands_ref(x, w, mode)
    fmt = JF.REGISTRY[mode]
    (xq, xs), (wq, ws) = _jquantize_scaled(x, fmt, 1), _jquantize_scaled(
        w, fmt, 0)
    return xq, wq, xs, ws


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor (bfloat16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, mode: str):
    want = np.asarray(want)
    if mode in INT_MODES:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(want).max()))


# ================================================================ B5
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                   (160, 200, 130), (64, 512, 96)])
def test_gemm_plain_matches_pallas_kernel(mode, shape):
    """The plain version of B5 (through the port's `aio_matmul_codes`, which
    packs int4 and casts codes as the reference's does) against the
    reference's `aio_matmul_codes` (Pallas, interpret mode) on the same
    codes; the port's operand quantization equals the reference's."""
    m, k, n = shape
    rng = np.random.RandomState(m + k + n)
    x, w = _rand(rng, m, k), _rand(rng, k, n)
    jxq, jwq, jxs, jws = _jquantize_operands(jnp.asarray(x),
                                             jnp.asarray(w), mode)
    xq, wq, xs, ws = quantize_operands_ref(torch.from_numpy(x),
                                           torch.from_numpy(w), mode)
    for ours, theirs in ((xq, jxq), (wq, jwq), (xs, jxs), (ws, jws)):
        if theirs is None:
            assert ours is None
        else:
            np.testing.assert_array_equal(
                ours.view(torch.int16).numpy() if ours.dtype == torch.bfloat16
                else ours.numpy(), np.asarray(theirs).view(np.int16)
                if ours.dtype == torch.bfloat16 else np.asarray(theirs))
    want = _jmatmul_codes(jxq, jwq, jxs, jws, mode=mode)
    got = aio_matmul_codes(xq, wq, xs, ws, mode=mode)
    _close(got, want, mode)
    # the oracle (f32 products of the decoded codes) within tolerance
    ref = aio_matmul_ref(xq, wq, xs, ws, mode=mode)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(_jmatmul_ref(jxq, jwq, jxs, jws,
                                             mode=mode)),
        rtol=2e-5, atol=2e-5 * float(np.abs(np.asarray(want)).max()))


def test_gemm_wrapper_counts_no_launch_on_cpu_and_checks_operands():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-8, 8, (5, 7)).astype(np.int8))
    w = F.pack_int4(torch.from_numpy(
        rng.randint(-8, 8, (9, 7)).astype(np.int32))).t().contiguous()
    xs, ws = torch.ones(5, 1), torch.ones(1, 9)
    before = aio_matmul.launches
    got = aio_matmul(x, w, xs, ws, mode="int4")
    assert aio_matmul.launches == before
    assert torch.equal(got, aio_matmul_plain(x, w, xs, ws, mode="int4"))
    with pytest.raises(ValueError, match="rows"):
        aio_matmul(x, w[:3], xs, ws, mode="int4")
    with pytest.raises(ValueError, match="only bf16"):
        aio_matmul(x, w, None, None, mode="int4")
    with pytest.raises(ValueError, match="not in"):
        aio_matmul(x, w, xs, ws, mode="fp16")


def test_gemm_plan_reads_only_k_n_and_mode():
    """The kernel's launch plan (block tile width, K slices) is a function
    of (K, N, mode) alone, so a row's result cannot depend on M; every
    slice holds whole K tiles and none is empty."""
    assert list(inspect.signature(gemm_plan).parameters) == ["k", "n",
                                                             "mode"]
    for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
                 (131, 40), (1001, 130), (64, 16)):
        for mode in MODES:
            bn, slices = gemm_plan(k, n, mode)
            kt = -(-k // (128 if mode in INT_MODES else 64))
            per = -(-kt // slices)
            assert bn in (64, 128) and slices >= 1
            assert (slices - 1) * per < kt <= slices * per


def test_m_independence_shapes_take_every_kind_of_plan():
    """The shapes of `tests/test_torch_cuda.py::
    test_gemm_rows_do_not_depend_on_m` take each kind of plan (64 or 128
    columns, K split or not) in every mode, so the card test holds every
    plan's rows bitwise from M = 1 to 256."""
    shapes = [(1536, 8960), (8960, 1536), (1536, 1536), (1536, 256),
              (200, 1536)]
    for mode in MODES:
        kinds = {(bn, slices > 1) for bn, slices in
                 (gemm_plan(k, n, mode) for k, n in shapes)}
        assert kinds == {(64, False), (64, True), (128, False),
                         (128, True)}, mode


# ================================================================ B10
def _quant_input(m: int, n: int) -> np.ndarray:
    """Random rows over many binades, plus the edge rows: all zero; a max
    |x| between FLT_MIN-times-max_finite and the kernel floor 1e-30;
    an exact power of two; RNE halfway points of the int and fp grids;
    and values that saturate."""
    rng = np.random.RandomState(m * n)
    x = rng.randn(m, n) * np.exp(rng.uniform(-6, 6, (m, 1)))
    x[0] = 0.0
    x[1] = rng.uniform(-1, 1, n) * 1e-31
    x[1, 0] = 1e-31
    x[2] = 0.5
    x[3, :4] = [8.0, -3.5, 2.5, 0.5]           # int4: x/scale = 7, halfway
    x[4, : n // 2] = 1e4
    return x.astype(np.float32)


@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
def test_quantizer_plain_matches_pallas_kernel_and_quantize_scaled(fmt):
    """Floor 1e-30: the reference's quantizer kernel (Pallas, interpret
    mode); floor FLT_MIN: `quantize_scaled`. Codes and scales bitwise."""
    x = _quant_input(40, 136)
    codes, scale = aio_quant_plain(torch.from_numpy(x), fmt_name=fmt,
                                   floor=KERNEL_FLOOR)
    jcodes, jscale = japi.ops.quantize(jnp.asarray(x), format=fmt,
                                       backend="pallas", interpret=True)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    jfmt = JF.REGISTRY[fmt]
    exact = np.asarray(jax.jit(JF.encode, static_argnums=1)(
        jnp.asarray(x) / jscale, jfmt)).astype(np.int8)
    np.testing.assert_array_equal(codes.numpy(), exact)
    agree = np.asarray(jcodes) == exact
    np.testing.assert_array_equal(codes.numpy()[agree],
                                  np.asarray(jcodes)[agree])
    if fmt.startswith("int"):
        assert agree.all()

    codes, scale = aio_quant_plain(torch.from_numpy(x), fmt_name=fmt,
                                   floor=F.FLT_MIN)
    jcodes, jscale = JF.quantize_scaled(jnp.asarray(x), jfmt, axis=1)
    rows = slice(1, None)          # row 0 (all zero) is checked below
    np.testing.assert_array_equal(scale.numpy()[rows],
                                  np.asarray(jscale)[rows])
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jcodes).astype(np.int8))
    # the all-zero row's scale is the exact power of two at or above
    # FLT_MIN / max_finite (a float32 subnormal; JAX on the CPU flushes it)
    ratio = np.float32(np.finfo(np.float32).tiny) / np.float32(
        jfmt.max_finite)
    exact_scale = 2.0 ** np.ceil(np.log2(np.float64(ratio)))
    assert float(scale[0, 0]) == exact_scale


@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
def test_quantizer_plain_matches_reference_on_edge_rows(fmt):
    """`quant_edge_rows` (ties at known scales, saturation, +-inf, NaN):
    floor FLT_MIN against `quantize_scaled`, floor 1e-30 against the
    reference kernel's scales and its exact encoder at those scales (and
    the kernel's own codes in the int formats). Bitwise."""
    x = quant_edge_rows(fmt, 256).numpy()
    jfmt = JF.REGISTRY[fmt]
    codes, scale = aio_quant_plain(torch.from_numpy(x), fmt_name=fmt,
                                   floor=F.FLT_MIN)
    jcodes, jscale = JF.quantize_scaled(jnp.asarray(x), jfmt, axis=1)
    # row 0's scale is a float32 subnormal that JAX on the CPU flushes
    np.testing.assert_array_equal(scale.numpy()[1:], np.asarray(jscale)[1:])
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jcodes).astype(np.int8))
    codes, scale = aio_quant_plain(torch.from_numpy(x), fmt_name=fmt,
                                   floor=KERNEL_FLOOR)
    jcodes, jscale = japi.ops.quantize(jnp.asarray(x), format=fmt,
                                       backend="pallas", interpret=True)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    exact = np.asarray(_jencode(jnp.asarray(x) / jscale, jfmt))
    np.testing.assert_array_equal(codes.numpy(), exact.astype(np.int8))
    if fmt.startswith("int"):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
def test_quantizer_edge_rows_catch_round_half_away(fmt, monkeypatch):
    """The edge rows tell RNE from round-half-away-from-zero (C's
    roundf): a plain quantizer built on the latter gives other codes in
    every row that holds ties, at the same scales."""
    x = quant_edge_rows(fmt, 256)
    want, want_scale = aio_quant_plain(x, fmt_name=fmt, floor=F.FLT_MIN)
    monkeypatch.setattr(torch, "round",
                        lambda t: torch.sign(t) * torch.floor(t.abs() + 0.5))
    got, scale = aio_quant_plain(x, fmt_name=fmt, floor=F.FLT_MIN)
    assert torch.equal(scale, want_scale)
    assert (got != want).any(1).tolist() == [False, False] + [True] * 5


def test_quantizer_wrapper_counts_no_launch_on_cpu():
    x = torch.from_numpy(_quant_input(6, 24))
    before = aio_quant.launches
    got = aio_quant(x, fmt_name="int4", floor=KERNEL_FLOOR)
    assert aio_quant.launches == before
    want = aio_quant_plain(x, fmt_name="int4", floor=KERNEL_FLOOR)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="not in"):
        aio_quant(x, fmt_name="bf16", floor=KERNEL_FLOOR)


def test_quant_plan_takes_shapes_only():
    """The quantizer's launch plan is a function of (M, N) alone: no tensor
    and no device."""
    assert list(inspect.signature(quant_plan).parameters) == ["m", "n"]
    assert quant_plan(8, 1536) == quant_plan(8, 1536)


def _covered_units(n: int, plan) -> np.ndarray:
    """How often each unit of a row is read by the kernel's blocks under
    `plan`, by the kernel's own indexing (csrc/aio_quant.cu): block rank r
    takes units [r * part, (r + 1) * part), thread t units t + j * threads
    of its part, j < the units a thread holds (the re-read path: every
    such index)."""
    unit = 4 if n % 4 == 0 else 1
    units = n // unit
    part = -(-units // plan.cluster)
    upt = plan.vals // unit
    hits = np.zeros(units, np.int64)
    for rank in range(plan.cluster):
        count = max(0, min(part, units - rank * part))
        idx = np.arange(plan.threads * upt if upt else count)
        idx = idx[idx < count]
        np.add.at(hits, rank * part + idx, 1)
    return hits


@pytest.mark.parametrize("m", [1, 8, 37, 256, 4096])
@pytest.mark.parametrize("n", [1, 3, 130, 1536, 8960, 11008, 151936])
def test_quant_plan_covers_each_row_once(m, n):
    """Each row's values are read exactly once by its cluster's blocks;
    every block has values; the cluster is a portable size (so the grid,
    M x cluster, is a multiple of it); a block has whole warps, at most
    MAX_THREADS; a thread holds at most MAX_UNITS 16-byte vectors in
    registers, or the plan takes the re-read path."""
    plan = quant_plan(m, n)
    unit = 4 if n % 4 == 0 else 1
    assert plan.cluster in CLUSTER_SIZES
    assert (m * plan.cluster) % plan.cluster == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert plan.threads <= 1024
    assert plan.vals % unit == 0
    assert plan.vals // unit in (0, 1, 2, 4, MAX_UNITS)
    assert plan.vals <= 4 * MAX_UNITS
    assert (_covered_units(n, plan) == 1).all()
    part = -(-(n // unit) // plan.cluster)
    assert (plan.cluster - 1) * part < n // unit     # no block left idle
    if plan.vals:
        assert plan.threads * (plan.vals // unit) >= part
    if m == 8 and n in (1536, 8960):
        assert m * plan.cluster >= 64


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("units", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("n", [130, 1536, 8960])
def test_plans_of_a_sweep_cover_each_row_once(cluster, units, n):
    """Every plan a sweep or a card test forces (`plan_with`) reads each
    value of a row once."""
    plan = plan_with(n, cluster, units)
    assert (_covered_units(n, plan) == 1).all()


# ================================================================ ops
def _resident(w: np.ndarray, fmt: str):
    jqw = JF.quantize_weight(jnp.asarray(w), fmt)
    qw = F.QuantWeight(_t(jqw.codes), _t(jqw.scale), jqw.fmt, jqw.k)
    return qw, jqw


@pytest.mark.parametrize("fmt", F.RESIDENT_FORMATS)
@pytest.mark.parametrize("k", [256, 131])
def test_matmul_codes_routes_match_reference_routes(fmt, k):
    """The kernel route (quantizer then GEMM) against the reference's
    pallas route, and the ref route against the reference's ref route —
    two different functions (W4A4 vs W4A32 for int4)."""
    rng = np.random.RandomState(k)
    x = _rand(rng, 2, 5, k)
    qw, jqw = _resident(_rand(rng, k, 40, scale=0.3), fmt)
    got = api.ops.matmul_codes(torch.from_numpy(x), qw)
    want = japi.ops.matmul_codes(jnp.asarray(x), jqw, backend="pallas",
                                 interpret=True)
    assert got.shape == (2, 5, 40)
    _close(got, want, fmt)
    got_ref = api.ops.matmul_codes(torch.from_numpy(x), qw, backend="ref")
    want_ref = japi.ops.matmul_codes(jnp.asarray(x), jqw, backend="ref")
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref),
                               rtol=2e-5,
                               atol=2e-5 * float(np.abs(want_ref).max()))
    with pytest.raises(ValueError, match="K"):
        api.ops.matmul_codes(torch.zeros(3, k + 1), qw)


@pytest.mark.parametrize("mode", ["fp8a", "int8", "int4"])
def test_matmul_and_quantize_ops_match_reference(mode):
    rng = np.random.RandomState(5)
    x, w = _rand(rng, 30, 70), _rand(rng, 70, 20)
    got = api.ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                         format=mode)
    want = japi.ops.matmul(jnp.asarray(x), jnp.asarray(w), format=mode,
                           backend="pallas", interpret=True)
    _close(got, want, mode)
    with api.policy(backend="ref", format=mode):
        got_ref = api.ops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    want_ref = japi.ops.matmul(jnp.asarray(x), jnp.asarray(w), format=mode,
                               backend="ref")
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref),
                               rtol=2e-5,
                               atol=2e-5 * float(np.abs(want_ref).max()))
    for backend in ("auto", "ref"):
        codes, scale = api.ops.quantize(torch.from_numpy(x), format=mode,
                                        backend=backend)
        jcodes, jscale = japi.ops.quantize(
            jnp.asarray(x), format=mode,
            backend="ref" if backend == "ref" else "pallas", interpret=True)
        assert codes.dtype == torch.int8
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    with pytest.raises(ValueError, match="CUDA"):
        api.ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                       format=mode, backend="cuda")
