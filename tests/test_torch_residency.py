"""Port parity of resident quantized weights: `quantize_params` builds the
reference's codes and scales bitwise; greedy serving with
`weight_format=` emits the JAX engine's tokens — the port's kernel route
(quantizer + AIO GEMM; their plain versions on the CPU) those of the JAX
engine's pallas route, the port's "ref" route those of the JAX default
(ref) engine. Inside the port: chunked admission equals one-shot with int4
weights, the ref route equals the fake-quant dense path bitwise, and the
engine's weight routes and format validation."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.models.layers import QuantPolicy as JQuantPolicy
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import api
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels.aio_matmul import aio_matmul
from repro_torch.kernels.aio_quant import aio_quant
from repro_torch.models import (QuantPolicy, init_params, quantize_params,
                                resident_format)
from repro_torch.models import transformer as T
from repro_torch.models.layers import Linear
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

PROMPT_LENS = [3, 20, 5, 18]
MAX_NEW = [6, 4, 8, 5]
MAX_LEN = 64
GEO = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine, request_cls, prompts):
    for rid, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        assert engine.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in engine.run_until_drained()}


@pytest.fixture(scope="module")
def jparams():
    return jinit_params(jax.random.key(0), jax_smoke("qwen2_1p5b"))


@pytest.fixture(scope="module", params=["int4", "fp8a"])
def served(request, jparams):
    """The JAX engine's tokens on both of its routes (built once per
    format), and the reference's resident params as numpy."""
    fmt = request.param
    jcfg = jax_smoke("qwen2_1p5b")
    prompts = _prompts(jcfg.vocab)
    want = {}
    for backend in ("pallas", "ref"):
        eng = JServingEngine(jcfg, jparams, weight_format=fmt,
                             policy=japi.ExecutionPolicy(backend=backend),
                             **GEO)
        assert eng.weight_route() == f"resident-{fmt}"
        want[backend] = _serve(eng, JRequest, prompts)
    qparams = jax.tree.map(np.asarray, JT.quantize_params(jparams, fmt))
    return fmt, qparams, prompts, want


def _resident_model(qparams):
    return params_from_jax(qparams, get_smoke("qwen2_1p5b"), device="cpu")


def test_kernel_route_tokens_match_jax_pallas_engine(served):
    fmt, qparams, prompts, want = served
    model = _resident_model(qparams)
    eng = ServingEngine(get_smoke("qwen2_1p5b"), model, **GEO)
    assert eng.weight_route() == f"resident-{fmt}"
    # every Linear but the (absent, tied) lm_head runs the resident codes
    assert {m.fmt for m in model.modules() if isinstance(m, Linear)} == {fmt}
    before = (aio_matmul.launches, aio_quant.launches)
    assert _serve(eng, Request, prompts) == want["pallas"]
    # CPU tensors: the wrappers ran their plain versions, no kernel
    assert (aio_matmul.launches, aio_quant.launches) == before


def test_ref_route_tokens_match_jax_ref_engine(served):
    fmt, qparams, prompts, want = served
    eng = ServingEngine(get_smoke("qwen2_1p5b"), _resident_model(qparams),
                        policy=api.ExecutionPolicy(backend="ref"), **GEO)
    assert _serve(eng, Request, prompts) == want["ref"]


@pytest.mark.parametrize("chunk", [1, 5])
def test_chunked_equals_one_shot_with_resident_int4(jparams, chunk):
    """Chunk widths 1 and 5 give the tokens of one-shot admission (a chunk
    wider than every prompt) on the kernel route with int4 weights."""
    cfg = get_smoke("qwen2_1p5b")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    quantize_params(model, "int4")
    prompts = _prompts(cfg.vocab)
    one_shot = _serve(ServingEngine(cfg, model,
                                    **dict(GEO, prefill_chunk=32)),
                      Request, prompts)
    eng = ServingEngine(cfg, model, **dict(GEO, prefill_chunk=chunk))
    assert _serve(eng, Request, prompts) == one_shot


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "llama2_7b"])
@pytest.mark.parametrize("fmt", ["int4", "int8", "fp8a", "fp8b"])
def test_quantize_params_matches_jax_codes_and_coverage(arch, fmt):
    """The port's in-place conversion of the bridged dense weights gives
    the reference's codes and scales per layer, bitwise; embeddings, norms
    and lm_head stay dense."""
    jcfg = jax_smoke(arch)
    jp = jinit_params(jax.random.key(1), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(arch),
                            device="cpu")
    assert resident_format(model) is None
    assert quantize_params(model, fmt) is model
    assert resident_format(model) == fmt
    stack = jax.tree.map(np.asarray, JT.quantize_params(jp, fmt))[
        "segments"][0]["0_dense"]
    for i, block in enumerate(model.layers):
        for group, names in (("attn", "qkvo"), ("mlp", ("gate", "up",
                                                       "down"))):
            for name in names:
                lin = getattr(getattr(block, group), name)
                jw = stack[group][name]["w"]
                assert lin.w is None and lin.fmt == fmt and lin.k == jw.k
                np.testing.assert_array_equal(lin.w_codes.numpy(),
                                              jw.codes[i])
                np.testing.assert_array_equal(lin.w_scale.numpy(),
                                              jw.scale[i])
    assert isinstance(model.embed.table, torch.nn.Parameter)
    assert model.final_norm.g is not None and block.ln1.g is not None
    if model.lm_head is not None:
        assert model.lm_head.fmt is None and model.lm_head.w is not None
    resident = [m for m in model.modules() if isinstance(m, Linear)
                and m.fmt is not None]
    assert len(resident) == 7 * len(model.layers)
    assert all(b.dtype == torch.int8 for m in resident
               for b in (m.w_codes,))


@pytest.mark.parametrize("fmt", ["int8", "fp8a"])
def test_ref_route_equals_fake_quant_dense_path(fmt):
    """The ref route of a resident weight (dequantize, then a float32
    product) computes what the dense per-channel fake-quant path computes,
    bitwise — the same invariant the reference holds."""
    cfg = get_smoke("qwen2_1p5b")
    fq_cfg = dataclasses.replace(cfg, quant=QuantPolicy(weights=fmt))
    fake = init_params(fq_cfg, seed=3, device="cpu")
    resident = init_params(cfg, seed=3, device="cpu")
    quantize_params(resident, fmt)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab, (2, 9)))
    want, _ = T.forward(fake, toks)
    with api.policy(backend="ref"):
        got, _ = T.forward(resident, toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("activations,weights", [("int8", "int8"),
                                                 ("fp8a", "none")])
def test_fake_quant_policy_forward_matches_jax(activations, weights):
    """A dense model under a fake-quant QuantPolicy (per-tensor activation
    and per-channel weight fake-quant in every covered Linear) gives the
    reference's logits, within 1e-5 (float32 sums in another order; a code
    flip at a rounding tie would show far above it)."""
    jcfg = dataclasses.replace(jax_smoke("qwen2_1p5b"), quant=JQuantPolicy(
        activations=activations, weights=weights))
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), quant=QuantPolicy(
        activations=activations, weights=weights))
    jp = jinit_params(jax.random.key(2), jcfg)
    toks = np.random.RandomState(1).randint(1, cfg.vocab, (2, 7))
    want, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, jax.numpy.asarray(toks))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got, _ = T.forward(model, torch.from_numpy(toks))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_weight_routes_and_format_validation():
    cfg = get_smoke("qwen2_1p5b")
    dense = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                          slots=1, max_len=16)
    assert dense.weight_route() == "dense"
    fq_cfg = dataclasses.replace(cfg, quant=QuantPolicy(weights="int8"))
    fq = ServingEngine(fq_cfg, init_params(fq_cfg, seed=0, device="cpu"),
                       slots=1, max_len=16)
    assert fq.weight_route() == "fake-quant-int8"
    model = init_params(cfg, seed=0, device="cpu")
    for bad in ("bf16", "fp16", "uint4"):
        with pytest.raises(ValueError, match="not in"):
            ServingEngine(cfg, model, slots=1, max_len=16, weight_format=bad)
    assert resident_format(model) is None
    eng = ServingEngine(cfg, model, slots=1, max_len=16, weight_format="fp8b")
    assert eng.weight_route() == "resident-fp8b"
    assert resident_format(model) is None        # the engine's own view
    # an already-resident model keeps its format
    quantize_params(model, "fp8b")
    again = ServingEngine(cfg, model, slots=1, max_len=16,
                          weight_format="int4")
    assert again.weight_route() == "resident-fp8b"


def test_weight_format_leaves_the_callers_model_dense(jparams):
    """An int4-resident engine built on a model leaves it dense: a dense
    engine built on the same model afterwards emits the JAX dense engine's
    tokens for the same params (the reference's engine does not convert
    the caller's params either)."""
    jcfg = jax_smoke("qwen2_1p5b")
    cfg = get_smoke("qwen2_1p5b")
    prompts = _prompts(cfg.vocab)
    want = _serve(JServingEngine(jcfg, jparams, **GEO), JRequest, prompts)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    dense_w = {n: m.w for n, m in model.named_modules()
               if isinstance(m, Linear)}
    resident = ServingEngine(cfg, model, weight_format="int4", **GEO)
    assert resident.weight_route() == "resident-int4"
    _serve(resident, Request, prompts)
    # the resident view shares every tensor but the Linears' weights
    shared = {id(t) for t in model.state_dict(keep_vars=True).values()}
    view = resident.model.state_dict(keep_vars=True)
    assert view["embed.table"] is model.embed.table
    assert all(id(t) in shared for n, t in view.items()
               if not n.endswith(("w_codes", "w_scale")))
    eng = ServingEngine(cfg, model, **GEO)
    assert eng.weight_route() == "dense"
    assert _serve(eng, Request, prompts) == want
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            assert mod.fmt is None and mod.w is dense_w[name], name
