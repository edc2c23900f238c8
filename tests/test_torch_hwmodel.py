"""The port's hardware model — `core/{morphable,mapping,isa,aio_mac}.py`, the
numpy format helpers and `perfmodel/*` — held EXACTLY equal to the JAX
package's on the same inputs, plus the reference's own tests
(tests/test_{morphable,aio_mac,perfmodel}.py) run on the port's modules:

* every fusion plan; `plan_for_tenants` over a sweep of tenant shapes and
  formats; the encoded instruction stream of `build_gemm_stream` for every
  plan; every mapping function over a sweep;
* the multiplier: every fp8 pair (to bf16 and to its own format, with
  `bias_adjust`), every int8 / uint8 pair, every int4 / uint4 pair, 2^16
  random bf16 pairs, `fp_decompose` / `fp_compose`;
* `np_quantize_fp` / `np_encode_fp` / `np_decode_fp` on random and edge
  float32 values and every code;
* `utilization_table`, `speedup_table`, `multi_tenant_scenario` (both
  latency modes) and `gpu_comparison` in every format (modeled numbers of
  the paper's array, not measurements);
* the AIO GEMM's plain version as an outer product of single products,
  bit for bit against the multiplier model in every mode (the card runs
  the same table on the kernel: tests/test_torch_cuda.py, chip_smoke.py
  phase 3e), and a GEMM that flushes fp8 subnormals caught by it."""
import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import aio_mac as JM
from repro.core import formats as JF
from repro.core import isa as JI
from repro.core import mapping as JMap
from repro.core import morphable as JMorph
from repro.perfmodel import simulate as JS
from repro_torch import core
from repro_torch.core import aio_mac as M
from repro_torch.core import formats as F
from repro_torch.core import isa, mapping, morphable
from repro_torch.core.mapping import GemmShape
from repro_torch.kernels.aio_matmul import aio_matmul_plain
from repro_torch.kernels.aio_matmul.oracle import (ORACLE_MODES,
                                                   oracle_check)
from repro_torch.perfmodel.accelerators import (ACCELERATORS,
                                                precision_double)
from repro_torch.perfmodel.latency import eq1_paper, model_latency, op_latency
from repro_torch.perfmodel.simulate import (gpu_comparison,
                                            multi_tenant_scenario,
                                            speedup_table, utilization_table)
from repro_torch.perfmodel.workloads import MODELS, Op, training_ops

import _xdist_threads  # noqa: F401  (one torch thread a worker)

FORMATS = ["bf16", "fp8a", "fp8b", "int8", "int4"]
FP_FORMATS = ["bf16", "fp16", "fp8a", "fp8b"]


def _plan(plan):
    return tuple((a.blocks, a.rows, a.cols) for a in plan.arrays)


def _all_finite_codes(fmt):
    codes = np.arange(1 << fmt.total_bits)
    if fmt.reserve_specials:
        e_code = (codes >> fmt.mbits) & ((1 << fmt.ebits) - 1)
        codes = codes[e_code != (1 << fmt.ebits) - 1]
    return codes


def _pairs(ca, cb):
    return ca.repeat(len(cb)), np.tile(cb, len(ca))


# ====================================================== equal to the reference
def test_core_exports_match_the_reference():
    import repro.core as jcore
    names = {n for n in dir(jcore) if not n.startswith("_")}
    assert names <= set(dir(core))
    assert callable(core.pow2_ceil)


@pytest.mark.parametrize("name", sorted(F.REGISTRY))
def test_format_fields_match_the_reference(name):
    f, j = F.REGISTRY[name], JF.REGISTRY[name]
    for attr in ("name", "kind", "ebits", "mbits", "bias", "reserve_specials",
                 "bits", "signed", "total_bits", "hw_native"):
        assert getattr(f, attr) == getattr(j, attr), attr
    if f.kind == "fp":
        for attr in ("emin", "emax", "max_finite", "min_subnormal",
                     "sig_width"):
            assert getattr(f, attr) == getattr(j, attr), attr
    else:
        assert (f.int_min, f.int_max) == (j.int_min, j.int_max)


def test_every_fusion_plan_equals_the_reference():
    got = [_plan(p) for p in morphable.enumerate_fusion_plans()]
    want = [_plan(p) for p in JMorph.enumerate_fusion_plans()]
    assert got == want and len(got) == 8
    assert [p.describe() for p in morphable.enumerate_fusion_plans()] == \
        [p.describe() for p in JMorph.enumerate_fusion_plans()]


_SIDES = [1, 16, 63, 64, 65, 128, 200, 256, 512, 768, 4096]


@pytest.mark.parametrize("fmt", FORMATS + ["uint4"])
def test_plan_for_tenants_sweep_equals_the_reference(fmt):
    rng = np.random.RandomState(7)
    lists = [[(r, c)] for r in _SIDES for c in _SIDES[::2]]
    for n in (2, 3, 4, 5):
        lists += [[tuple(int(v) for v in rng.choice(_SIDES, 2))
                   for _ in range(n)] for _ in range(40)]
    for shapes in lists:
        got, got_assign = morphable.plan_for_tenants(shapes, fmt)
        want, want_assign = JMorph.plan_for_tenants(shapes, fmt)
        assert _plan(got) == _plan(want), shapes
        assert got_assign == want_assign, shapes
        assert morphable._assign_cost(shapes, got, fmt) == \
            JMorph._assign_cost(shapes, want, fmt)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 5000), st.integers(1, 5000)),
                min_size=1, max_size=5),
       st.sampled_from(FORMATS))
def test_property_plan_for_tenants_equals_the_reference(shapes, fmt):
    got, got_assign = morphable.plan_for_tenants(shapes, fmt)
    want, want_assign = JMorph.plan_for_tenants(shapes, fmt)
    assert (_plan(got), got_assign) == (_plan(want), want_assign)


@pytest.mark.parametrize("fmt", FORMATS)
def test_precision_morph_equals_the_reference(fmt):
    for r in (64, 128):
        for c in (64, 128):
            assert morphable.precision_morph(r, c, fmt) == \
                JMorph.precision_morph(r, c, fmt)


def test_gemm_streams_equal_the_reference():
    """The encoded 32-bit words of every plan's stream, for several tile
    loops, precisions, data types and op modes."""
    tiles = [[(1, 1)], [(2, 3), (1, 2)], [(3, 0), (1, 4), (2, 2), (1, 1)],
             [(4, 5)] * 4]
    plans = zip(morphable.enumerate_fusion_plans(),
                JMorph.enumerate_fusion_plans())
    n = 0
    for plan, jplan in plans:
        for t in tiles:
            for precision, dtype_fp, op_mode in ((7, True, 0), (3, True, 1),
                                                 (8, False, 2)):
                got = isa.build_gemm_stream(plan, t, precision, dtype_fp,
                                            op_mode)
                want = JI.build_gemm_stream(jplan, t, precision, dtype_fp,
                                            op_mode)
                assert [i.encode() for i in got] == \
                    [i.encode() for i in want]
                assert [(i.op.value, i.block_id) for i in got] == \
                    [(i.op.value, i.block_id) for i in want]
                n += len(got)
    assert n > 0


def test_stream_validation_equals_the_reference():
    cases = [[isa.matrix_multiply(0, 0, 16)],
             [isa.read_weights(0, 0, 16), isa.matrix_multiply(0, 0, 16)],
             [isa.read_weights(0, 0, 16), isa.start_compute(0, 0, 0, 7, 1)],
             [isa.read_weights(1, 0, 16), isa.read_weights(1, 4, 16)],
             [isa.end_compute(2, 0)]]
    jcases = [[JI.matrix_multiply(0, 0, 16)],
              [JI.read_weights(0, 0, 16), JI.matrix_multiply(0, 0, 16)],
              [JI.read_weights(0, 0, 16), JI.start_compute(0, 0, 0, 7, 1)],
              [JI.read_weights(1, 0, 16), JI.read_weights(1, 4, 16)],
              [JI.end_compute(2, 0)]]
    for case, jcase in zip(cases, jcases):
        with pytest.raises(isa.StreamError) as got:
            isa.validate_stream(case)
        with pytest.raises(JI.StreamError) as want:
            JI.validate_stream(jcase)
        assert str(got.value) == str(want.value)


def test_mapping_functions_equal_the_reference():
    dims = [1, 7, 9, 64, 100, 128, 129, 300, 1024, 4097]
    for s_c in dims:
        for t in dims[::3]:
            for s_r in dims[::2]:
                for r, c in ((64, 64), (64, 128), (128, 128), (256, 256)):
                    got = GemmShape(s_c, t, s_r)
                    want = JMap.GemmShape(s_c, t, s_r)
                    assert mapping.systolic_latency(got, r, c) == \
                        JMap.systolic_latency(want, r, c)
                    assert mapping.accumulable_utilization(got, r, c) == \
                        JMap.accumulable_utilization(want, r, c)
    for taps in (1, 4, 9, 16, 25, 49, 64, 81):
        assert mapping.lrmu_groups(taps) == JMap.lrmu_groups(taps)
        for c_out in (None, 3, 32, 64, 200):
            assert mapping.unaccumulable_util_allrounder(taps, c_out) == \
                JMap.unaccumulable_util_allrounder(taps, c_out)
            for rows in (64, 128, 256):
                assert mapping.unaccumulable_util_rigid(taps, rows, c_out) \
                    == JMap.unaccumulable_util_rigid(taps, rows, c_out)
    for op in ("depthwise_conv", "dilated_conv", "weight_gradient", "conv",
               "fc", "gemm", "gemv", "attention_gemm"):
        assert mapping.classify(op).value == JMap.classify(op).value


@pytest.mark.parametrize("fmt_name", ["fp8a", "fp8b"])
@pytest.mark.parametrize("out_name", ["bf16", "fp8a", "fp8b"])
@pytest.mark.parametrize("bias_adjust", [0, -3, 2])
def test_fp8_products_equal_the_reference(fmt_name, out_name, bias_adjust):
    fmt, jfmt = F.REGISTRY[fmt_name], JF.REGISTRY[fmt_name]
    a, b = _pairs(*[_all_finite_codes(fmt)] * 2)
    got = M.aio_fp_multiply(a, b, fmt, fmt, F.REGISTRY[out_name],
                            bias_adjust=bias_adjust)
    want = JM.aio_fp_multiply(a, b, jfmt, jfmt, JF.REGISTRY[out_name],
                              bias_adjust=bias_adjust)
    np.testing.assert_array_equal(got, want)


def test_mixed_fp8_products_equal_the_reference():
    a, b = _pairs(_all_finite_codes(F.FP8A), _all_finite_codes(F.FP8B))
    np.testing.assert_array_equal(
        M.aio_fp_multiply(a, b, F.FP8A, F.FP8B, F.BF16),
        JM.aio_fp_multiply(a, b, JF.FP8A, JF.FP8B, JF.BF16))


@pytest.mark.parametrize("name", ["int8", "uint8", "int4", "uint4"])
def test_int_products_equal_the_reference(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    vals = np.arange(fmt.int_min, fmt.int_max + 1)
    a, b = _pairs(vals, vals)
    got = M.aio_int_multiply(a, b, fmt, fmt)
    np.testing.assert_array_equal(got, JM.aio_int_multiply(a, b, jfmt, jfmt))
    np.testing.assert_array_equal(got, a * b)


def test_mixed_width_products_equal_the_reference():
    a4 = np.arange(-8, 8).repeat(256).reshape(-1, 2)
    b8 = np.tile(np.arange(-128, 128), 16).reshape(-1, 2)
    np.testing.assert_array_equal(M.csm_int(a4, b8, 4, 8),
                                  JM.csm_int(a4, b8, 4, 8))
    np.testing.assert_array_equal(M.csm_int(b8, a4, 8, 4),
                                  JM.csm_int(b8, a4, 8, 4))


def test_bf16_products_equal_the_reference():
    """2^16 random bf16 pairs, exponents over +-40 binades so products
    underflow to subnormals and saturate too."""
    rng = np.random.RandomState(11)
    vals = (rng.randn(2, 1 << 16)
            * 2.0 ** rng.randint(-70, 70, (2, 1 << 16))).astype(np.float32)
    ca, cb = F.np_encode_fp(vals, F.BF16)
    for out in ("bf16", "fp16", "fp8a"):
        got = M.aio_fp_multiply(ca, cb, F.BF16, F.BF16, F.REGISTRY[out])
        want = JM.aio_fp_multiply(ca, cb, JF.BF16, JF.BF16,
                                  JF.REGISTRY[out])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FP_FORMATS)
def test_decompose_and_compose_equal_the_reference(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    codes = np.arange(1 << min(fmt.total_bits, 16))
    for g, w in zip(M.fp_decompose(codes, fmt), JM.fp_decompose(codes, jfmt)):
        np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(3)
    sign = rng.randint(0, 2, 4096)
    p = rng.randint(0, 1 << 20, 4096)
    lsb = rng.randint(-160, 140, 4096)
    np.testing.assert_array_equal(M.fp_compose(sign, p, lsb, fmt),
                                  JM.fp_compose(sign, p, lsb, jfmt))


def _edge_values():
    f32 = np.finfo(np.float32)
    edges = [0.0, -0.0, 1.0, -1.0, 0.5, 1.5, 2.5, 3.5, 448.0, 480.0, 496.0,
             57344.0, 61440.0, 65504.0, 3.3895314e38, f32.max, -f32.max,
             f32.tiny, f32.tiny / 2, 1.4e-45, -1.4e-45, 2.0 ** -6,
             2.0 ** -9, 2.0 ** -10, 2.0 ** -14, 2.0 ** -16, 2.0 ** -17,
             2.0 ** -126, 2.0 ** -133, 2.0 ** -134, np.inf, -np.inf, np.nan]
    ties = [(1 + (2 * i + 1) / 16) * 2.0 ** e for i in range(8)
            for e in (-8, -6, 0, 3)]
    return np.array(edges + ties + [-t for t in ties], np.float32)


@pytest.mark.parametrize("name", FP_FORMATS)
def test_np_helpers_equal_the_reference(name):
    fmt, jfmt = F.REGISTRY[name], JF.REGISTRY[name]
    rng = np.random.RandomState(5)
    vals = np.concatenate([
        _edge_values(),
        (rng.randn(20000) * 2.0 ** rng.randint(-40, 40, 20000)).astype(
            np.float32),
        rng.randint(0, 1 << 32, 20000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)])
    with np.errstate(invalid="ignore", over="ignore"):
        np.testing.assert_array_equal(F.np_quantize_fp(vals, fmt),
                                      JF.np_quantize_fp(vals, jfmt))
        finite = vals[np.isfinite(vals) | fmt.reserve_specials]
        np.testing.assert_array_equal(F.np_encode_fp(finite, fmt),
                                      JF.np_encode_fp(finite, jfmt))
    codes = np.arange(1 << min(fmt.total_bits, 16))
    np.testing.assert_array_equal(F.np_decode_fp(codes, fmt),
                                  JF.np_decode_fp(codes, jfmt))


@pytest.mark.parametrize("fmt", FORMATS)
def test_perfmodel_tables_equal_the_reference(fmt):
    """Every modeled number equal (the same float operations in the same
    order): Fig 14, Fig 15, §VI-C in both latency modes."""
    assert utilization_table(fmt) == JS.utilization_table(fmt)
    assert speedup_table(fmt) == JS.speedup_table(fmt)
    for mode in ("eq1", "ws"):
        assert multi_tenant_scenario(fmt, mode) == \
            JS.multi_tenant_scenario(fmt, mode)


def test_gpu_comparison_equals_the_reference():
    models = ["vgg16", "resnet18", "mobilenetv2", "efficientnet_b0",
              "convnext_s"]
    assert gpu_comparison(models) == JS.gpu_comparison(models)
    assert gpu_comparison() == JS.gpu_comparison()


@pytest.mark.parametrize("fmt", FORMATS)
def test_model_latency_per_op_equals_the_reference(fmt):
    from repro.perfmodel import ACCELERATORS as JACC
    from repro.perfmodel import MODELS as JMODELS
    from repro.perfmodel import model_latency as jmodel_latency
    for name in MODELS:
        ops, jops = MODELS[name](2), JMODELS[name](2)
        for acc in ACCELERATORS:
            for mode in ("ws", "eq1"):
                got = model_latency(ops, ACCELERATORS[acc], fmt, None, mode)
                want = jmodel_latency(jops, JACC[acc], fmt, None, mode)
                per_op = [dataclasses.astuple(r) for r in got.pop("per_op")]
                assert per_op == [dataclasses.astuple(r)
                                  for r in want.pop("per_op")]
                assert got == want


# =================================== the AIO GEMM against the multiplier model
@pytest.mark.parametrize("mode", ORACLE_MODES)
def test_gemm_plain_version_equals_the_multiplier_model(mode):
    got = oracle_check(mode, "cpu")
    assert got["mismatches"] == 0
    assert got["pairs"] == (256 if mode == "int4" else 65536)
    # the fp8 pairs with a subnormal operand: fp8a has 14 nonzero codes
    # with a zero exponent field, fp8b 6
    assert got["subnormal_pairs"] == {"fp8a": 256 ** 2 - 242 ** 2,
                                      "fp8b": 256 ** 2 - 250 ** 2}.get(mode, 0)


def test_oracle_catches_flushed_fp8_subnormals():
    """A GEMM that decodes fp8 subnormal codes as zero (a flush-to-zero
    decode) disagrees with the model on every pair with a subnormal
    operand and a nonzero other one."""
    def flushing(x, w, xs, ws, *, mode):
        sub = lambda c: ((c.to(torch.int32) >> 3) & 0xF) == 0  # noqa: E731
        return aio_matmul_plain(torch.where(sub(x), 0, x).to(torch.int8), w,
                                xs, ws, mode=mode)
    got = oracle_check("fp8a", "cpu", matmul=flushing)
    # 14 nonzero subnormal codes (+-1..7) x 254 nonzero codes
    assert got["mismatches"] == got["subnormal_mismatches"] == 14 * 254


# ======================================== the reference's tests, on the port
def test_fig8_plans_present():
    plans = morphable.enumerate_fusion_plans()
    descs = {tuple(sorted((a.rows, a.cols) for a in p.arrays)) for p in plans}
    assert tuple(sorted([(64, 64)] * 4)) in descs
    assert tuple(sorted([(64, 128)] * 2)) in descs
    assert tuple(sorted([(128, 64), (64, 64), (64, 64)])) in descs
    assert ((128, 128),) in descs


def test_all_plans_are_partitions_without_l_shapes():
    for plan in morphable.enumerate_fusion_plans():
        blocks = [b for a in plan.arrays for b in a.blocks]
        assert sorted(blocks) == [0, 1, 2, 3]
        assert sum(a.n_macs for a in plan.arrays) == 128 * 128
        assert all(len(a.blocks) in (1, 2, 4) for a in plan.arrays)


def test_precision_morph():
    assert morphable.precision_morph(128, 128, "bf16") == (128, 128)
    assert morphable.precision_morph(128, 128, "int8") == (128, 128)
    assert morphable.precision_morph(128, 128, "fp8a") == (256, 256)
    assert morphable.precision_morph(64, 128, "int4") == (128, 256)


def test_plan_for_two_wide_tenants_fissions_and_square_fuses():
    plan, assign = morphable.plan_for_tenants([(64, 512), (64, 768)])
    assert plan.n_partitions >= 2 and assign[0] != assign[1]
    plan, _ = morphable.plan_for_tenants([(4096, 4096)])
    assert plan.n_partitions == 1
    assert plan.arrays[0].rows == plan.arrays[0].cols == 128


def test_mapping_math():
    s = GemmShape(s_c=300, t=128, s_r=256)
    assert mapping.systolic_latency(s, 128, 128) == \
        (2 * 256 + 300 - 2) * math.ceil(256 / 128) * math.ceil(300 / 128)
    u = mapping.unaccumulable_util_allrounder(taps=9)
    assert u > 0.99 and u == pytest.approx((7 * 9 * 64 + 63) / 4096)
    rigid = mapping.unaccumulable_util_rigid(taps=9, rows=128)
    assert rigid == pytest.approx(9 / 128) and u / rigid > 10
    assert mapping.lrmu_groups(9) == 7 and mapping.lrmu_groups(25) == 2
    assert mapping.accumulable_utilization(
        GemmShape(1024, 256, 512), 128, 128) == pytest.approx(1.0)
    assert mapping.accumulable_utilization(
        GemmShape(1024, 130, 514), 128, 128) == pytest.approx(
            (130 * 514) / (2 * 128 * 5 * 128))
    assert mapping.classify("depthwise_conv") is \
        mapping.OpKind.UNACCUMULABLE
    assert mapping.classify("gemm") is mapping.OpKind.ACCUMULABLE
    with pytest.raises(ValueError):
        mapping.classify("fft")


def test_instruction_stream_roundtrip_and_order():
    plan, _ = morphable.plan_for_tenants([(256, 256), (128, 128)])
    stream = isa.build_gemm_stream(plan, [(2, 3), (1, 2)])
    isa.validate_stream(stream)
    words = [i.encode() for i in stream]
    assert all(0 <= w < 2 ** 32 for w in words)
    assert {w & 0x7F for w in words} <= {isa.OPCODE_A, isa.OPCODE_B}
    with pytest.raises(isa.StreamError):
        isa.validate_stream([isa.read_weights(0, 0, 16),
                             isa.start_compute(0, 0, 0, 7, True)])


def test_csm_exhaustive():
    a = np.arange(-128, 128).repeat(256)
    b = np.tile(np.arange(-128, 128), 256)
    np.testing.assert_array_equal(M.csm_multiply_8x8(a, b, signed=True),
                                  a * b)
    ua, ub = a + 128, b + 128
    np.testing.assert_array_equal(M.csm_multiply_8x8(ua, ub, signed=False),
                                  ua * ub)
    rng = np.random.RandomState(0)
    a4, b4 = rng.randint(-8, 8, (2, 1000, 4))
    out = M.csm_multiply_4x4x4(a4, b4, signed=True)
    np.testing.assert_array_equal(out, a4 * b4)
    assert out.shape == (1000, 4)
    b8 = rng.randint(-128, 128, (1000, 4))
    np.testing.assert_array_equal(M.csm_multiply_4x8(a4, b8), a4 * b8)
    with pytest.raises(ValueError):
        M.submul_5x5(np.array([16]), np.array([1]))


@settings(max_examples=100, deadline=None)
@given(st.integers(-128, 127), st.integers(-128, 127))
def test_property_csm_signed(a, b):
    assert int(M.csm_multiply_8x8(np.array([a]), np.array([b]))[0]) == a * b


def _ref_fp_mult(code_a, code_b, fa, fb, out_fmt, bias_adjust=0):
    """decode -> exact f64 product -> quantize -> encode, all in f64."""
    prod = F.np_decode_fp(code_a, fa) * F.np_decode_fp(code_b, fb) \
        * 2.0 ** bias_adjust
    return F.np_encode_fp(prod, out_fmt)


@pytest.mark.parametrize("fmt,out", [(F.FP8A, F.BF16), (F.FP8B, F.BF16),
                                     (F.FP8A, F.FP8A), (F.FP8B, F.FP8B)])
def test_fp8_multiply_exhaustive(fmt, out):
    a, b = _pairs(*[_all_finite_codes(fmt)] * 2)
    np.testing.assert_array_equal(M.aio_fp_multiply(a, b, fmt, fmt, out),
                                  _ref_fp_mult(a, b, fmt, fmt, out))


def test_bf16_multiply_random_and_bias_adjust():
    rng = np.random.RandomState(3)
    vals = (rng.randn(2, 20000)
            * 2.0 ** rng.randint(-20, 20, (2, 20000))).astype(np.float32)
    ca, cb = (F.encode(torch.from_numpy(v), F.BF16).numpy() for v in vals)
    np.testing.assert_array_equal(
        M.aio_fp_multiply(ca, cb, F.BF16, F.BF16, F.BF16),
        _ref_fp_mult(ca, cb, F.BF16, F.BF16, F.BF16))
    a, b = _pairs(*[_all_finite_codes(F.FP8A)] * 2)
    for k in (-3, 2):
        np.testing.assert_array_equal(
            M.aio_fp_multiply(a, b, F.FP8A, F.FP8A, F.BF16, bias_adjust=k),
            _ref_fp_mult(a, b, F.FP8A, F.FP8A, F.BF16, bias_adjust=k))


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 8), st.integers(0, 255), st.integers(0, 255))
def test_property_narrow_exponent_formats(ebits, rawa, rawb):
    fmt = F.fp_format("t", ebits, 3)
    mask = (1 << fmt.total_bits) - 1
    a, b = np.array([rawa & mask]), np.array([rawb & mask])
    np.testing.assert_array_equal(M.aio_fp_multiply(a, b, fmt, fmt, F.BF16),
                                  _ref_fp_mult(a, b, fmt, fmt, F.BF16))


def test_perfmodel_claims():
    assert eq1_paper(s_c=300, s_r=256, r=128, c=128) == \
        (512 + 298) * 2 * math.ceil(300 / 128)
    assert [precision_double(f) for f in ("bf16", "int8", "fp8a", "int4")] \
        == [1, 1, 2, 2]
    op = Op("g", "gemm", 4096, 1024, 1024)
    assert op_latency(op, ACCELERATORS["tpu_sa"], "bf16").utilization > 0.9
    dw = Op("dw", "depthwise", 128 * 56 * 56, 9, 96, taps=9, channels=96)
    ar = op_latency(dw, ACCELERATORS["allrounder"], "bf16")
    sa = op_latency(dw, ACCELERATORS["tpu_sa"], "bf16")
    assert ar.cycles < sa.cycles and ar.utilization > 10 * sa.utilization
    u = utilization_table("bf16", ["vgg16", "llama2_7b"])
    assert u["vgg16"]["WG"]["allrounder"] > 0.95
    assert u["vgg16"]["WG"]["tpu_sa"] < u["vgg16"]["FW"]["tpu_sa"]
    t = speedup_table("bf16", ["vgg16", "mobilenetv2", "convnext_s"])
    for row in t.values():
        assert row["allrounder"]["speedup"] >= max(
            1.0, row["mirroring"]["speedup"])
    ms = multi_tenant_scenario("int8", mode="eq1")
    assert ms["allrounder"] < ms["sara"] <= ms["mirroring"]
    assert 15 < ms["allrounder"] < 60
    for row in gpu_comparison(["vgg16", "resnet18", "mobilenetv2"]).values():
        assert row["allrounder_gflops_w"] > 10 * row["gpu"]["gflops_w"] / 3


def test_training_ops_cover_three_steps():
    for model in MODELS:
        steps = training_ops(model, 8)
        assert set(steps) == {"FW", "BW", "WG"}
        fw = sum(o.macs for o in steps["FW"])
        bw = sum(o.macs for o in steps["BW"])
        assert 0.2 * fw < bw <= 1.5 * fw
