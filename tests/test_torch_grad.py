"""Gradients of the port against the JAX package, and the rules that
keep autograd off the forward-only kernels.

* `loss_fn` value and gradient of the SMOKE configs of llama2, qwen2, olmo
  and gpt2 against `jax.value_and_grad(loss_fn, has_aux=True)` on the same
  weights (the port's init, mapped into the reference's pytree by
  `bridge.params_to_jax`): the loss within 1e-5 relative, each leaf within
  1e-4 x max |g_jax| of that leaf, compared in the reference's layout
  (`bridge.grads_to_jax`). `check_parity` is shared with the other
  gradient files (tests/test_torch_grad_{dense,moe,ssm,frontends}.py),
  which cover the other eight configs at the same bounds; no family
  needs a looser one;
* a 128-aligned length: under autograd every attention call takes the
  `ref` route, under `torch.no_grad()` the full-sequence kernel's route
  (its plain version on the CPU), both at the reference's loss;
* the STE's gradient is the identity; `attention_route(grad=True)` is
  "ref" for every shape, and grad=False keeps the route table;
  `attention` asks for it exactly when an input requires grad;
* the reference's own limit: `jax.grad` through its Pallas full-sequence
  attention raises."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.core import formats as JF
from repro.models import loss_fn as jloss_fn
from repro.models.layers import QuantPolicy as JQuantPolicy
from repro_torch import api
from repro_torch.api import ops as port_ops
from repro_torch.bridge import grads_to_jax, params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.core import formats as F
from repro_torch.models import init_params, loss_fn
from repro_torch.models.layers import QuantPolicy

import _xdist_threads  # noqa: F401  (one torch thread a worker)

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4            # of the leaf's max |g_jax|
DENSE = ["llama2_7b", "qwen2_1p5b", "olmo_1b", "gpt2_small"]


def make_batch(cfg, seed, b=2, l=32):
    """Random tokens and labels (a few masked), and frames / patch
    embeddings for the frontend families, as numpy arrays."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, (b, l)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab, (b, l)).astype(np.int32)}
    out["labels"][0, :3] = -100
    if cfg.family == "audio":
        out["frames"] = rng.randn(b, cfg.frontend_len,
                                  cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.randn(b, cfg.frontend_len,
                                        cfg.d_model).astype(np.float32)
    return out


def jax_value_and_grad(jcfg, np_params, batch, aux_weight=0.01):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg, aux_weight=aux_weight),
        has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, np_params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), metrics, grads


def port_value_and_grad(model, batch, aux_weight=0.01):
    model.trainable_()
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                            aux_weight=aux_weight)
    loss.backward()
    return loss.item(), metrics, grads_to_jax(model)


def assert_grads_match(jgrads, tgrads, tol=LEAF_TOL):
    """Leaf by leaf: |g_port - g_jax| <= tol x max |g_jax| of the leaf;
    the two trees have the same structure."""
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(jgrads)
    flat_t, tree_t = jax.tree_util.tree_flatten(tgrads)
    assert tree_j == tree_t
    for (path, gj), gt in zip(flat_j, flat_t):
        gj = np.asarray(gj)
        scale = max(float(np.abs(gj).max()), 1e-30)
        err = float(np.abs(gt - gj).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


def check_parity(arch, *, l=32, policy=None, aux_weight=0.01, seed=0,
                 **cfg_changes):
    """The port's loss_fn value and gradient against the reference's on
    the port's init of the SMOKE config; returns (port metrics, JAX
    metrics)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    if policy is not None:
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(*policy))
        tcfg = dataclasses.replace(tcfg, quant=QuantPolicy(*policy))
    if cfg_changes:
        jcfg = dataclasses.replace(jcfg, **cfg_changes)
        tcfg = dataclasses.replace(tcfg, **cfg_changes)
    model = init_params(tcfg, seed=seed, device="cpu")
    batch = make_batch(tcfg, seed + 3, l=l)
    jloss, jm, jgrads = jax_value_and_grad(jcfg, params_to_jax(model), batch,
                                           aux_weight)
    tloss, tm, tgrads = port_value_and_grad(model, batch, aux_weight)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    assert abs(tm["loss"].item() - float(jm["loss"])) \
        <= LOSS_RTOL * abs(float(jm["loss"]))
    assert_grads_match(jgrads, tgrads)
    return tm, jm


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradient_match_reference(arch):
    check_parity(arch)


def test_aligned_length_routes_and_gradient(monkeypatch):
    """At L = 128 every attention call is kernel-eligible: under autograd
    it must take "ref", under no_grad the full-sequence kernel's route
    ("cuda", its plain version on the CPU); the values agree with the
    reference either way."""
    routes = []
    real = port_ops.attention_route

    def spy(**kw):
        routes.append(real(**kw))
        return routes[-1]
    monkeypatch.setattr(port_ops, "attention_route", spy)
    tm, jm = check_parity("qwen2_1p5b", l=128)
    assert routes and set(routes) == {"ref"}
    routes.clear()
    cfg = get_smoke("qwen2_1p5b")
    model = init_params(cfg, seed=0, device="cpu").trainable_()
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, 3, l=128).items()}
    with torch.no_grad():
        loss, _ = loss_fn(model, batch)
    assert routes == ["cuda"] * cfg.n_layers
    assert abs(loss.item() - tm["loss"].item()) \
        <= LOSS_RTOL * abs(float(jm["loss"]))


# ------------------------------------------------------------------ STE
@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
def test_fake_quant_value_and_identity_gradient(fmt):
    rng = np.random.RandomState(1)
    x_np = (rng.randn(257) * 8).astype(np.float32)
    x = torch.from_numpy(x_np).requires_grad_()
    y = F.fake_quant(x, fmt)
    assert torch.equal(y.detach(), F.quantize(x.detach(), F.REGISTRY[fmt]))
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(JF.fake_quant(jnp.asarray(x_np), fmt)))
    g = torch.from_numpy(rng.randn(257).astype(np.float32))
    y.backward(g)
    assert torch.equal(x.grad, g)


def test_fake_quant_gradient_is_ste():
    """tests/test_formats.py's STE test, on the port."""
    x = torch.tensor([0.3, -2.7, 100.0], requires_grad=True)
    F.fake_quant(x, "fp8a").sum().backward()
    assert torch.equal(x.grad, torch.ones(3))


# ---------------------------------------------------------------- routes
SHAPES = [dict(lq=lq, lk=lk, causal=causal, offset_ndim=nd, quantized=qz)
          for lq in (1, 5, 8, 32, 128, 256)
          for lk in (None, 128, 2048)
          for causal in (True, False) for nd in (0, 1) for qz in (False, True)]


@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_route_under_grad_is_ref_for_every_shape(backend):
    for shape in SHAPES:
        assert api.ops.attention_route(grad=True, backend=backend,
                                       **shape) == "ref", shape
        assert api.ops.attention_route(grad=False, backend=backend,
                                       **shape) == \
            api.ops.attention_route(backend=backend, **shape), shape


def test_route_table_without_grad_is_unchanged():
    route = api.ops.attention_route
    assert route(lq=128, lk=128) == "cuda"
    assert route(lq=256, causal=False) == "cuda"
    assert route(lq=1, lk=2048) == "cuda-decode"
    assert route(lq=8, lk=2048) == "cuda-decode"
    assert route(lq=32, lk=2048, offset_ndim=1) == "cuda-prefill"
    assert route(lq=32, lk=32) == "ref"
    assert route(lq=128, lk=128, quantized=True) == "ref"
    assert route(lq=128, lk=128, backend="ref") == "ref"


def test_attention_sets_grad_from_its_inputs(monkeypatch):
    """`attention` asks for the grad route exactly when grad mode is on
    and q, k or v requires grad."""
    seen = []
    real = port_ops.attention_route

    def spy(**kw):
        seen.append(kw["grad"])
        return real(**kw)
    monkeypatch.setattr(port_ops, "attention_route", spy)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 128, 16, generator=g) for _ in range(3))
    want = api.ops.attention(q, k, v)
    for i, name in enumerate("qkv"):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        out = api.ops.attention(*args)
        out.sum().backward()
        assert args[i].grad is not None and torch.isfinite(
            args[i].grad).all(), name
        with torch.no_grad():
            api.ops.attention(*args)
        torch.testing.assert_close(out.detach(), want, rtol=1e-5, atol=1e-5)
    assert seen == [False] + [True, False] * 3


def test_reference_grad_through_pallas_attention_raises():
    """The reference behaviour the port does not mirror (ROADMAP C): its
    full-sequence Pallas kernel has no backward, so `jax.grad` through it
    raises; the port routes autograd-recorded attention to `ref`."""
    rng = np.random.RandomState(0)
    q, k, v = (jnp.asarray(rng.randn(1, 2, 128, 32).astype(np.float32))
               for _ in range(3))
    assert japi.ops.attention_route(lq=128, lk=128, backend="pallas") \
        == "pallas"
    with pytest.raises(AssertionError):
        jax.grad(lambda q: japi.ops.attention(
            q, k, v, causal=True, backend="pallas", interpret=True).sum())(q)
