"""Port parity of the full-sequence path: the plain version of the port's
full-sequence flash kernel against the JAX package's Pallas kernel in
interpret mode (the reference's own cases, plus non-causal ones), the
op surface's "cuda" route against JAX's "pallas" route, and the
full-sequence forward, `loss_fn` and `make_prefill_step` of the qwen2_1p5b
SMOKE config at L = 128 and 256 (every layer's attention on the
full-sequence route) against JAX under backend="pallas", from the same
weights (copied through `repro_torch.bridge`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import init_params as jinit_params
from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch import api
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain, full)
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import forward, loss_fn

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-5            # f32 attention, the same blocks, another einsum order
MODEL_TOL = 1e-4      # logits of two layers of f32 products
LOSS_TOL = 1e-5       # relative

# the reference's own flash-attention cases (tests/test_kernels.py), then
# non-causal ones, with and without a window
CASES = [
    dict(b=2, hq=4, hkv=2, lq=128, lk=128, d=64),
    dict(b=1, hq=8, hkv=2, lq=256, lk=300, d=64, causal=True),
    dict(b=1, hq=4, hkv=4, lq=128, lk=256, d=64, causal=True, window=100),
    dict(b=1, hq=4, hkv=2, lq=128, lk=256, d=64, causal=True, softcap=30.0),
    dict(b=1, hq=4, hkv=2, lq=128, lk=384, d=64, causal=True, offset=256),
    dict(b=1, hq=2, hkv=1, lq=128, lk=128, d=128, causal=True, window=64,
         softcap=50.0),
    dict(b=2, hq=6, hkv=2, lq=128, lk=200, d=32, causal=False),
    dict(b=1, hq=4, hkv=2, lq=128, lk=256, d=64, causal=False, window=90,
         softcap=20.0),
]


def _data(case, seed=0):
    rng = np.random.RandomState(seed)
    b, hq, hkv = case["b"], case["hq"], case["hkv"]
    lq, lk, d = case["lq"], case["lk"], case["d"]
    return (rng.randn(b, hq, lq, d).astype(np.float32) * 0.5,
            rng.randn(b, hkv, lk, d).astype(np.float32) * 0.5,
            rng.randn(b, hkv, lk, d).astype(np.float32))


def _kw(case):
    return {k: case[k] for k in ("causal", "window", "softcap", "offset")
            if k in case}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_plain_matches_pallas(case):
    q, k, v = _data(case)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True, **_kw(case))
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                **_kw(case))
    _close(got, want)
    # the wrapper takes the plain version for CPU tensors
    via_wrapper = flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  **_kw(case))
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("case", CASES[:2] + CASES[4:5] + CASES[6:7],
                         ids=str)
def test_api_attention_full_route_matches_jax(case):
    """The op surface end to end: the shapes route to the full-sequence
    kernel in both packages ("pallas" / "cuda") and give the same values."""
    q, k, v = _data(case, seed=1)
    kw = _kw(case)
    lq, lk = case["lq"], case["lk"]
    jroute = japi.ops.attention_route(lq=lq, lk=lk, backend="pallas",
                                      causal=kw.get("causal", True))
    route = api.ops.attention_route(lq=lq, lk=lk,
                                    causal=kw.get("causal", True))
    assert (jroute, route) == ("pallas", "cuda")
    want = japi.ops.attention(*map(jnp.asarray, (q, k, v)), backend="pallas",
                              interpret=True, **kw)
    got = api.ops.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want)


def test_paged_call_on_the_full_route_goes_to_ref(monkeypatch):
    """A paged call whose shape the rule sends to the full-sequence kernel
    runs the reference instead (the kernel has no paged route), as in the
    reference."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 4, 128, 16).astype(np.float32))
    pool = torch.from_numpy(rng.randn(4, 2, 64, 16).astype(np.float32))
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    assert api.ops.attention_route(lq=128, lk=128) == "cuda"

    def refuse(*args, **kw):
        raise AssertionError("the full-sequence kernel ran a paged call")
    monkeypatch.setattr(full, "flash_attention_plain", refuse)
    got = api.ops.attention(q, pool, pool, block_tables=table)
    gathered = pool[table[0].long()].transpose(0, 1).reshape(1, 2, 128, 16)
    want = api.ops.attention(q, gathered, gathered, backend="ref")
    assert torch.equal(got, want)


def test_no_valid_key_rows_are_finite():
    """A window that ends before the last key leaves rows with no valid
    key; the port's answer there is finite (ROADMAP C: the value is not the
    reference's, which depends on its 128-key blocks)."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((1, 2, 128, 16), (1, 2, 100, 16), (1, 2, 100, 16)))
    out = flash_attention(q, k, v, causal=True, window=8, offset=50)
    # query i sits at 50 + i: rows with 50 + i >= 100 + 8 - 1 keep no key
    assert torch.isfinite(out).all()
    want = api.ops.attention(q, k, v, causal=True, window=8, offset=50,
                             backend="ref")
    _close(out[:, :, :57], want[:, :, :57])


# ============================================================ the model
@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_smoke("qwen2_1p5b"), get_smoke("qwen2_1p5b")
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return jcfg, tcfg, jparams, model


def _tokens(jcfg, length, seed):
    return np.random.RandomState(seed).randint(1, jcfg.vocab, (2, length))


@pytest.fixture
def count_full(monkeypatch):
    """Counts the calls that reach the full-sequence kernel's plain
    version (what its wrapper runs on CPU tensors)."""
    calls = []
    real = full.flash_attention_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(full, "flash_attention_plain", counted)
    return calls


@pytest.mark.parametrize("length", [128, 256])
def test_forward_loss_and_prefill_step_match_jax(pair, count_full, length):
    jcfg, tcfg, jparams, model = pair
    toks = _tokens(jcfg, length, seed=length)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100)], axis=1)
    labels[1, :5] = -100
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
              "labels": torch.from_numpy(labels.astype(np.int64))}
    with japi.policy(backend="pallas", interpret=True):
        want_logits, _ = jforward(jparams, jbatch["tokens"], jcfg)
        want_loss, want_parts = jloss_fn(jparams, jbatch, jcfg)
        want_next = jmake_prefill_step(jcfg)(jparams, jbatch)
    got_logits, aux = forward(model, tbatch["tokens"])
    assert len(count_full) == tcfg.n_layers      # one kernel call per layer
    _close(got_logits, want_logits, MODEL_TOL)
    assert aux.item() == 0.0
    got_loss, parts = loss_fn(model, tbatch)
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(parts["loss"].item(),
                               float(want_parts["loss"]), rtol=LOSS_TOL)
    got_next = make_prefill_step(tcfg)(model, tbatch)
    assert got_next.tolist() == np.asarray(want_next).tolist()
    assert got_next.tolist() == got_logits[:, -1].argmax(-1).tolist()


def test_prefill_step_refuses_another_model(pair):
    _, tcfg, _, model = pair
    step = make_prefill_step(dataclasses.replace(tcfg, name="other"))
    with pytest.raises(ValueError, match="made for other"):
        step(model, {"tokens": torch.ones((1, 128), dtype=torch.int64)})


def test_loss_fn_masks_labels_and_adds_aux(pair):
    """labels < 0 drop out of the mean; with every label masked the loss is
    0 (the reference's max(count, 1))."""
    jcfg, _, _, model = pair
    toks = torch.from_numpy(_tokens(jcfg, 128, seed=9).astype(np.int64))
    full_loss, _ = loss_fn(model, {"tokens": toks, "labels": toks})
    half = toks.clone()
    half[:, 64:] = -100
    half_loss, _ = loss_fn(model, {"tokens": toks, "labels": half})
    logp = torch.log_softmax(forward(model, toks)[0], -1)
    nll = -logp.gather(-1, toks[..., None])[..., 0]
    torch.testing.assert_close(full_loss, nll.mean(), rtol=1e-6, atol=0)
    torch.testing.assert_close(half_loss, nll[:, :64].mean(), rtol=1e-6,
                               atol=0)
    none, parts = loss_fn(model, {"tokens": toks,
                                  "labels": torch.full_like(toks, -100)})
    assert none.item() == 0.0 and parts["aux"].item() == 0.0
