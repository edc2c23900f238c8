"""The port's four examples (`examples/pt_*.py`) on the CPU, against the
JAX package, at small sizes.

* pt_quickstart: the formats demo bitwise equal to `repro.core.formats`
  and the CSM product to `repro.core.aio_mac.aio_fp_multiply`; its
  quantized matmul at 64 x 64 against the reference's `api.ops.matmul` on
  its Pallas route (interpret mode): int8 bitwise, bf16 and fp8a within
  rtol 2e-5, the quantizer's codes and scales bitwise; its morphable GEMM
  within 1e-5 x max |reference| of the reference's, with the same pack
  utilization; its Trainer steps on the world-of-one mesh finite.
* pt_morphable_inference: plans, utilizations and the modeled latencies
  exactly equal to the reference functions'.
* pt_fp8_training: `train` over 3 steps from the reference Trainer's
  initial weights (carried over by `bridge.params_from_jax`): losses
  within 1e-4 relative of the reference's Trainer on the same synthetic
  batches, unquantized and fp8a.
* pt_multi_tenant_serving: the int8 round trip of the weights bitwise
  equal to the reference example's `quantize_params_int8`, and both
  tenants' tokens on the `ref` route equal to the reference engine's.
* Each example refuses to run without a card unless asked for the CPU."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.core import aio_mac as jmac
from repro.core import formats as JF
from repro.core import morphable as jmorph
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_local_mesh
from repro.models.layers import QuantPolicy as JQuantPolicy
from repro.perfmodel.accelerators import ACCELERATORS as JACC
from repro.perfmodel.latency import model_latency as jmodel_latency
from repro.perfmodel.workloads import inference_ops as jinference_ops
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.models import init_params

import _xdist_threads  # noqa: F401  (one torch thread a worker)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)

import multi_tenant_serving as ref_mts  # noqa: E402  the reference's
import pt_fp8_training  # noqa: E402
import pt_morphable_inference  # noqa: E402
import pt_multi_tenant_serving  # noqa: E402
import pt_quickstart  # noqa: E402

pytestmark = pytest.mark.timeout(240)

GEMM_RTOL = 2e-5
GROUPED_TOL = 1e-5
LOSS_RTOL = 1e-4


# ------------------------------------------------------------ quickstart
def test_quickstart_formats_equal_reference():
    got = pt_quickstart.demo_formats("cpu")
    x = jnp.asarray(np.random.RandomState(0).randn(4).astype(np.float32)
                    * 3)
    for name in ("bf16", "fp8a", "fp8b", "int8", "int4"):
        np.testing.assert_array_equal(
            got[name], np.asarray(JF.quantize(x, JF.REGISTRY[name])))
    fmt = JF.FP8A
    np.testing.assert_array_equal(got["scaled"], np.asarray(JF.decode(
        JF.encode(x, fmt), fmt.with_bias(fmt.bias - 3))))
    code = jmac.aio_fp_multiply(np.asarray(JF.encode(jnp.float32(1.5), fmt)),
                                np.asarray(JF.encode(jnp.float32(-2.25),
                                                     fmt)),
                                fmt, fmt, JF.BF16)
    assert got["csm"] == float(JF.decode(jnp.asarray(code), JF.BF16)) \
        == -3.375


def test_quickstart_matmul_equals_reference_pallas_route():
    """64 x 64: the port's kernel route (the plain versions on the CPU)
    against the reference's Pallas kernels in interpret mode."""
    outs, codes = pt_quickstart.demo_quant_matmul("cpu", n=64)
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(64, 64).astype(np.float32))
    w = jnp.asarray(rng.randn(64, 64).astype(np.float32))
    for mode in pt_quickstart.MODES:
        with japi.policy(format=mode, backend="pallas"):
            want = np.asarray(japi.ops.matmul(x, w))
            if mode != "bf16":
                q, s = japi.ops.quantize(x)
                np.testing.assert_array_equal(codes[mode][0], np.asarray(q))
                np.testing.assert_array_equal(codes[mode][1], np.asarray(s))
        got = outs[mode][0]
        if mode == "int8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=GEMM_RTOL,
                                       atol=GEMM_RTOL * np.abs(want).max())
        assert outs[mode][1] < 0.05


def test_quickstart_morphable_gemm_equals_reference():
    results, util, errs = pt_quickstart.demo_morphable("cpu")
    rng = np.random.RandomState(2)
    tenants = [(jnp.asarray(rng.randn(m, k), jnp.float32),
                jnp.asarray(rng.randn(k, n), jnp.float32))
               for m, k, n in pt_quickstart.TENANTS]
    with japi.policy(backend="pallas"):
        want, want_util = japi.ops.morphable_multi_gemm(tenants)
    assert util == want_util
    for got, w in zip(results, want):
        w = np.asarray(w)
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= GROUPED_TOL * np.abs(w).max()
    assert max(errs) < 1e-3


def test_quickstart_trains_on_a_world_of_one(tmp_path):
    """The Trainer over `make_local_mesh()` of a world of this process,
    which the demo starts and ends."""
    import torch.distributed as dist
    losses = pt_quickstart.demo_training("cpu", tmp_path, steps=2, batch=2,
                                         seq=16)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not dist.is_initialized()


# --------------------------------------------------- morphable inference
def test_morphable_inference_equals_reference():
    got = pt_morphable_inference.kernel_level("cpu")
    rng = np.random.RandomState(0)
    for name, shapes in pt_morphable_inference.MIXES.items():
        tenants = [(jnp.asarray(rng.randn(m, k), jnp.float32),
                    jnp.asarray(rng.randn(k, n), jnp.float32))
                   for m, k, n in shapes]
        _, util = japi.ops.morphable_multi_gemm(tenants, backend="ref")
        plan, assign = jmorph.plan_for_tenants([(k, n) for m, k, n in shapes])
        assert got[name] == (util, plan.describe(), assign), name
    n_plans, modeled = pt_morphable_inference.hardware_level()
    assert n_plans == len(jmorph.enumerate_fusion_plans())
    ops = jinference_ops("mobilenetv2", 1)
    for name, (ms, util) in modeled.items():
        r = jmodel_latency(ops, JACC[name], "int8")
        assert (ms, util) == (r["cycles"] / 4e5, r["utilization"])


# ------------------------------------------------------------- fp8 training
@pytest.mark.parametrize("quant", ["none", "fp8a"])
def test_fp8_training_matches_reference_trainer(tmp_path, quant):
    steps, batch, seq = 3, 2, 16
    base, fp8 = pt_fp8_training.configs()
    cfg = fp8 if quant == "fp8a" else base
    jcfg = jax_smoke("qwen2_1p5b")
    if quant == "fp8a":
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(
            activations="fp8a", weights="fp8a"))
    ref = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10
                                        ** 9, total_steps=steps,
                                        base_lr=2e-3, warmup=5),
                   make_local_mesh(), key=jax.random.key(0))
    model = params_from_jax(jax.tree.map(np.asarray, ref.params), cfg,
                            device="cpu")
    got = pt_fp8_training.train(cfg, steps, quant, model=model,
                                device="cpu", batch=batch, seq=seq)
    ref.run(iter(JSyntheticLM(JDataConfig(vocab=jcfg.vocab, batch=batch,
                                          seq=seq, seed=7))), steps)
    want = [m["loss"] for m in ref.metrics_log]
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)


# ------------------------------------------------------- multi-tenant
@pytest.mark.parametrize("name,arch,_", pt_multi_tenant_serving.TENANTS)
def test_multi_tenant_tenant_equals_reference_engine(name, arch, _):
    """The tenant's seeded weights, int8 round-tripped in both packages
    (bitwise alike), served on the `ref` route: the reference engine's
    tokens."""
    cfg = get_smoke(arch)
    model = init_params(cfg, seed=pt_multi_tenant_serving.tenant_seed(name),
                        device="cpu")
    params = ref_mts.quantize_params_int8(
        jax.tree.map(jnp.asarray, params_to_jax(model)))
    pt_multi_tenant_serving.quantize_params_int8(model)
    for g, w in zip(jax.tree.leaves(params_to_jax(model)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w))
    eng = JServingEngine(jax_smoke(arch), params, slots=2, max_len=96,
                         policy=japi.ExecutionPolicy(backend="ref"))
    rng = np.random.RandomState(0)
    for rid in range(3):
        eng.submit(JRequest(rid, rng.randint(1, cfg.vocab, 6)
                            .astype(np.int32), max_new_tokens=6))
    want = {r.rid: [int(t) for t in r.out_tokens]
            for r in eng.run_until_drained()}
    done, _ = pt_multi_tenant_serving.run_tenant(name, arch, device="cpu")
    assert {r.rid: list(r.out_tokens) for r in done} == want


def test_multi_tenant_main_serves_both_tenants_in_turn(capsys):
    served = pt_multi_tenant_serving.main(["--device", "cpu"])
    assert sorted(served) == ["assistant", "captioning"]
    assert all(len(d) == 3 and all(len(r.out_tokens) == 6 for r in d)
               for d, _ in served.values())
    out = capsys.readouterr().out
    assert "the tenants ran in turn in one process" in out
    assert "multi_tenant_serving OK" in out


# --------------------------------------------------------- no silent CPU
@pytest.mark.parametrize("example", [pt_quickstart, pt_morphable_inference,
                                     pt_multi_tenant_serving,
                                     pt_fp8_training])
def test_example_refuses_to_run_without_a_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
