"""Port parity of the model: `forward` and `decode_step` logits of the
port against the JAX package on the qwen2_1p5b and llama2_7b SMOKE configs,
dense and int8-KV, from the same weights (copied through
`repro_torch.bridge`) and the same caches; the caches after a step agree
up to each row's frontier, and int8 codes and scales agree there exactly
when the projections agree. A variant of the qwen2 SMOKE config turns on
the dense block's other features (sliding window, attention and final
logit softcaps, post-norms with non-unit gains), which the two served
configs leave off."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro_torch.bridge import caches_from_jax, params_from_jax, to_torch
from repro_torch.configs import get_smoke
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params)
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (MLP, Embedding, LayerNorm, Linear,
                                       NonParamLayerNorm, RMSNorm)
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import DenseBlock, Transformer

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4        # f32 products and attention summed in another order
# the window (6) is shorter than the 10-token chunk below, so it masks keys
# inside the chunk as well as in the decode step after it
FEATURES = dict(sliding_window=6, softcap_attn=2.0, softcap_final=0.5,
                post_norm=True)
CASES = [("qwen2_1p5b", False, False), ("qwen2_1p5b", True, False),
         ("llama2_7b", False, False), ("llama2_7b", True, False),
         ("qwen2_1p5b", False, True), ("qwen2_1p5b", True, True)]


def _cfgs(arch, kv_quant, features=False):
    extra = FEATURES if features else {}
    return (dataclasses.replace(jax_smoke(arch), kv_quant=kv_quant, **extra),
            dataclasses.replace(get_smoke(arch), kv_quant=kv_quant, **extra))


def _case_id(case):
    arch, kv_quant, features = case
    return f"{arch}-{kv_quant}" + ("-window-softcap-postnorm" if features
                                   else "")


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def pair(request):
    arch, kv_quant, features = request.param
    jcfg, tcfg = _cfgs(arch, kv_quant, features)
    jparams = jinit_params(jax.random.key(0), jcfg)
    if features:
        # non-unit post-norm gains, so the bridge's mapping of them shows
        block = jparams["segments"][0]["0_dense"]
        rng = np.random.RandomState(4)
        for name in ("pn1", "pn2"):
            g = block[name]["g"]
            block[name]["g"] = jnp.asarray(
                1.0 + 0.5 * rng.randn(*g.shape).astype(np.float32))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return jcfg, tcfg, jparams, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_forward_logits_match(pair):
    jcfg, _, jparams, model = pair
    toks = np.random.RandomState(1).randint(1, jcfg.vocab, (2, 12))
    want, _ = jforward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = forward(model, torch.from_numpy(toks.astype(np.int64)))
    _close(got, want)
    assert aux.item() == 0.0


def test_decode_step_logits_and_caches_match(pair):
    """A right-padded chunk (with a zero-length row) then a decode step."""
    jcfg, tcfg, jparams, model = pair
    rng = np.random.RandomState(2)
    b, l, max_len = 3, 10, 32
    jc = jinit_caches(jcfg, batch=b, max_len=max_len)
    tc = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    toks = rng.randint(1, jcfg.vocab, (b, l)).astype(np.int32)
    lens = np.asarray([l, 4, 0], np.int32)
    jl, jc = jdecode_step(jparams, jc, jnp.asarray(toks), jcfg,
                          lengths=jnp.asarray(lens))
    tl, tc = decode_step(model, tc, torch.from_numpy(toks),
                         lengths=torch.from_numpy(lens))
    for r in range(b):
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])

    step = rng.randint(1, jcfg.vocab, (b, 1)).astype(np.int32)
    active = np.asarray([1, 1, 0], np.int32)
    jl, jc = jdecode_step(jparams, jc, jnp.asarray(step), jcfg,
                          lengths=jnp.asarray(active))
    tl, tc = decode_step(model, tc, torch.from_numpy(step),
                         lengths=torch.from_numpy(active))
    _close(tl[:2], np.asarray(jl)[:2])

    want = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                           device="cpu")
    for got_c, want_c in zip(tc, want):
        assert torch.equal(got_c.pos, want_c.pos)
        front = want_c.pos.tolist()
        for f in dataclasses.fields(got_c):
            if f.name == "pos":
                continue
            g, w = getattr(got_c, f.name), getattr(want_c, f.name)
            for r in range(b):
                gr, wr = g[r, :, :front[r]].float(), w[r, :, :front[r]].float()
                if f.name.endswith("codes"):
                    # a code may sit one step off where an f32 ulp of the
                    # projection crosses a rounding tie
                    assert (gr - wr).abs().max().item() <= 1 if gr.numel() \
                        else True
                else:
                    torch.testing.assert_close(gr, wr, rtol=TOL, atol=TOL)


def test_zero_length_rows_keep_cache_and_position():
    _, tcfg = _cfgs("qwen2_1p5b", True)
    model = init_params(tcfg, seed=3, device="cpu")
    caches = init_caches(tcfg, batch=2, max_len=16, device="cpu")
    toks = torch.randint(1, tcfg.vocab, (2, 4),
                         generator=torch.Generator().manual_seed(0))
    decode_step(model, caches, toks, lengths=torch.tensor([4, 2]))
    snap = [{f.name: getattr(c, f.name).clone()
             for f in dataclasses.fields(c)} for c in caches]
    decode_step(model, caches, toks, lengths=torch.tensor([0, 0]))
    for c, s in zip(caches, snap):
        for name, t in s.items():
            assert torch.equal(getattr(c, name), t), name
        assert c.pos.tolist() == [4, 2]


def test_default_device_needs_a_card():
    _, tcfg = _cfgs("llama2_7b", False)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(tcfg, batch=1, max_len=8)


# every constructor and bridge function that places tensors, called with
# its default device
_DEFAULT_DEVICE_CALLS = {
    "Linear": lambda cfg: Linear(4, 4),
    "Embedding": lambda cfg: Embedding(8, 4),
    "RMSNorm": lambda cfg: RMSNorm(4),
    "LayerNorm": lambda cfg: LayerNorm(4),
    "NonParamLayerNorm": lambda cfg: NonParamLayerNorm(4),
    "MLP": lambda cfg: MLP(4, 8),
    "MoE": lambda cfg: MoE(4, 8, 4, 2),
    "Attention": lambda cfg: Attention(8, 2, 1, 4),
    "DenseBlock": lambda cfg: DenseBlock(cfg),
    "Transformer": lambda cfg: Transformer(cfg),
    "to_torch": lambda cfg: to_torch(np.zeros(2, np.float32)),
    "params_from_jax": lambda cfg: params_from_jax({}, cfg),
    "caches_from_jax": lambda cfg: caches_from_jax([], cfg),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_module_default_device_needs_a_card(name):
    """The port's modules and the bridge run on the card unless the caller
    asks for the CPU: their default device raises without one, before any
    work is done."""
    _, tcfg = _cfgs("llama2_7b", False)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name](tcfg)


def test_unported_family_raises():
    """A family the reference does not have either (all six of its
    families are ported)."""
    cfg = dataclasses.replace(get_smoke("llama2_7b"), family="retrieval")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, device="cpu")
