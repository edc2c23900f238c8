"""The long-sequence memory paths of the port against the JAX package.

* `kernels.flash_attention.ref.chunked_attention` (the online-softmax
  walk over `chunk`-long key blocks) against the reference's
  `chunked_attention` within 1e-5: GQA, causal and not, a window, a
  softcap, scalar and per-row offsets, Lk not a multiple of the chunk,
  chunks of 16 and 32, and rows with no valid key at all;
* the `ref` route's rule (`ops._attention_ref`): one-shot scores up to
  4096 x 8192, the chunked walk past it, each side held to the
  reference's `_attention_ref` within 1e-5;
* `ModelConfig.remat`: `loss_fn`'s gradients with remat equal those
  without bitwise on the CPU (every layer layout), and are within 1e-4 x
  a leaf's max |g| of `jax.value_and_grad` on the reference's remat=True
  SMOKE config (a dense, an MoE and a recurrent family); remat saves fewer
  bytes for the backward (counted with `saved_tensors_hooks`); on two
  gloo ranks the manual TP+SP block and the automatic TP path give the
  same gradients with remat as without, the recompute running each
  layer's collectives but its last again, in the same order on both
  ranks."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.api.policy import ExecutionPolicy as JPolicy
from repro.configs import get_smoke as jax_smoke
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import \
    chunked_attention as jchunked_attention
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.bridge import params_to_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import chunked_attention
from repro_torch.launch.world import spawn_world
from repro_torch.models import init_params, loss_fn
from repro_torch.models import transformer as T

from _remat_ranks import TP_CASES
from test_torch_grad import (assert_grads_match, jax_value_and_grad,
                             make_batch, port_value_and_grad)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 1e-5


def _qkv(seed, b, hq, hkv, lq, lk, d):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# (case, shape (b, hq, hkv, lq, lk, d), chunk, kwargs); a list offset is
# per row. "none" rows: row 1 of "rows_without_keys" sits past every key
# of its window, and the first queries of row 0 before every key.
CHUNKED = [
    ("gqa_causal", (2, 4, 2, 24, 40, 8), 16, dict(causal=True, offset=16)),
    ("mha_noncausal", (2, 4, 4, 24, 40, 8), 32, dict(causal=False)),
    ("window_rows", (2, 4, 2, 24, 40, 8), 16,
     dict(causal=True, window=5, offset=[16, 3])),
    ("softcap", (1, 6, 2, 20, 37, 8), 16,
     dict(causal=True, softcap=2.0, offset=17)),
    ("lk_exact", (2, 2, 1, 16, 64, 8), 32, dict(causal=True, offset=48)),
    ("rows_without_keys", (2, 4, 2, 24, 40, 8), 16,
     dict(causal=True, window=4, offset=[-5, 50])),
    ("noncausal_window", (1, 4, 2, 12, 45, 8), 32,
     dict(causal=False, window=6, offset=60)),
]


@pytest.mark.parametrize("case,shape,chunk,kw", CHUNKED,
                         ids=[c[0] for c in CHUNKED])
def test_chunked_attention_matches_reference(case, shape, chunk, kw):
    q, k, v = _qkv(len(case), *shape)
    tkw, jkw = dict(kw), dict(kw)
    if isinstance(kw.get("offset"), list):
        tkw["offset"] = torch.tensor(kw["offset"])
        jkw["offset"] = jnp.asarray(kw["offset"])
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), chunk=chunk, **tkw)
    want = jchunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              chunk=chunk, **jkw)
    _close(got.numpy(), want)


def test_rows_without_keys_take_the_scans_mean():
    """A row with no valid key ends as the mean of every padded key's
    value (-1e30 scores weigh all keys alike, pad keys' values are 0):
    what the reference's scan gives, not zeros."""
    b, hq, hkv, lq, lk, d = 1, 2, 1, 4, 40, 8
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, b, hq, hkv, lq, lk, d))
    out = chunked_attention(q, k, v, causal=True, window=2, offset=100,
                            chunk=16)
    want = v.sum(2, keepdim=True) / 48          # 3 chunks of 16 keys
    torch.testing.assert_close(out, want.expand_as(out), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("lk,route", [(8192, "mha_ref"),
                                      (8193, "chunked_attention")])
def test_ref_route_rule_matches_reference(lk, route, monkeypatch):
    """H 1, D 4, Lq 4,096: Lk 8,192 is the last one-shot size, 8,193 the
    first chunked one; both against the reference's `_attention_ref`."""
    q, k, v = _qkv(lk, 1, 1, 1, 4096, lk, 4)
    called = []
    for name in ("mha_ref", "chunked_attention"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _n=name, _f=real, **kw:
                            called.append(_n) or _f(*a, **kw))
    kw = dict(causal=True, offset=lk - 4096)
    got = tops._attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              policy=ExecutionPolicy(backend="ref"), **kw)
    want = jops._attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               policy=JPolicy(backend="ref"), **kw)
    assert called == [route]
    _close(got.numpy(), want)


def test_chunk_is_a_validated_policy_field():
    assert ExecutionPolicy().chunk == JPolicy().chunk == 1024
    assert ExecutionPolicy(chunk=16).chunk == 16
    with pytest.raises(ValueError, match="tile lengths"):
        ExecutionPolicy(chunk=0)


def test_configs_carry_the_references_remat():
    """Every CONFIG rematerializes, every SMOKE does not, as in the
    reference."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        assert get_config(arch).remat is jax_config(arch).remat is True
        assert get_smoke(arch).remat is jax_smoke(arch).remat is False


# ------------------------------------------------------------- remat
def _grads(cfg, batch, monkeypatch):
    """loss_fn's value, gradients (the reference's layout) and the layer
    units it checkpointed, on the seeded SMOKE weights under `cfg`."""
    calls = []
    monkeypatch.setattr(T, "checkpoint", lambda fn, *a, **kw:
                        calls.append(a[4:6]) or checkpoint(fn, *a, **kw))
    model = init_params(cfg, seed=0, device="cpu")
    loss, _, grads = port_value_and_grad(model, batch)
    return loss, grads, calls


def _remat_equals_plain(arch, monkeypatch):
    """One checkpoint a unit of the reference's layer scan with remat, none
    without, and the same loss and gradients bit for bit; returns the
    remat config, the batch and the gradients."""
    cfg = dataclasses.replace(get_smoke(arch), remat=True)
    batch = make_batch(cfg, 3)
    loss, grads, calls = _grads(cfg, batch, monkeypatch)
    assert calls == list(T._units(cfg))
    assert len(calls) == sum(n for _, n in cfg.segments())
    plain_loss, plain_grads, plain_calls = _grads(
        dataclasses.replace(cfg, remat=False), batch, monkeypatch)
    assert plain_calls == [] and plain_loss == loss
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(plain_grads)):
        assert np.array_equal(a, b)
    return cfg, batch, grads


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "olmoe_1b_7b", "xlstm_1p3b"])
def test_remat_gradients_equal_plain_and_match_reference(arch,
                                                         monkeypatch):
    """A dense, an MoE and a recurrent family (xlstm: a unit is an mLSTM
    and an sLSTM): the gradients with remat bitwise those without, and
    within 1e-4 x a leaf's max |g| of the reference's on its remat=True
    config."""
    cfg, batch, grads = _remat_equals_plain(arch, monkeypatch)
    jcfg = dataclasses.replace(jax_smoke(arch), remat=True)
    _, _, jgrads = jax_value_and_grad(
        jcfg, params_to_jax(init_params(cfg, seed=0, device="cpu")), batch)
    assert_grads_match(jgrads, grads)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "gemma2_27b",
                                  "whisper_tiny"])
def test_remat_units_of_the_other_layouts(arch, monkeypatch):
    """zamba2's unit (two Mamba2 layers and the shared block, one module
    at every unit), gemma2's local/global pair and whisper's decoder
    layers over the encoder's memory: bitwise the gradients without
    remat."""
    _remat_equals_plain(arch, monkeypatch)


def test_remat_only_when_a_backward_follows():
    """No checkpoint under no_grad, with caches, or with nothing that
    requires grad."""
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), remat=True)
    model = init_params(cfg, device="cpu")
    x = torch.zeros(1, 8, cfg.d_model)
    assert not T._remat(model, x, None)
    model.trainable_()
    assert T._remat(model, x, None)
    assert not T._remat(model, x, [None] * cfg.n_layers)
    with torch.no_grad():
        assert not T._remat(model, x, None)
    assert not T._remat(init_params(get_smoke("qwen2_1p5b"),
                                    device="cpu").trainable_(), x, None)


# measured 6.1x: 7,681,288 bytes without remat, 1,250,568 with (988,424
# packed and 4 unit inputs of 2 x 128 x 64 f32)
REMAT_SAVED_RATIO = 6.0


def test_remat_saves_fewer_bytes():
    """Bytes the forward keeps for the backward (the tensors autograd
    packs, parameters aside, plus each checkpointed unit's input, which
    the checkpoint holds): without remat every layer's activations, with
    it the residual stream at each unit's entry and what lies outside the
    layers (embedding, final norm, logits)."""
    base = dataclasses.replace(get_smoke("qwen2_1p5b"), n_layers=4)
    batch = {k: torch.from_numpy(v).long()
             for k, v in make_batch(base, 5, l=128).items()}
    saved = {}
    for remat in (False, True):
        model = init_params(dataclasses.replace(base, remat=remat),
                            device="cpu").trainable_()
        params = {p.untyped_storage().data_ptr() for p in model.parameters()}
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in params:
                seen[st.data_ptr()] = st.nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(model, batch)
        held = (base.n_layers * batch["tokens"].numel() * base.d_model * 4
                if remat else 0)
        saved[remat] = sum(seen.values()) + held
        loss.backward()
    assert saved[False] >= REMAT_SAVED_RATIO * saved[True], saved


# --------------------------------------------- two gloo ranks, TP + remat
@pytest.fixture(scope="module")
def tp_ranks():
    return spawn_world(2, "_remat_ranks:rank_main", sys_path=[HERE, SRC],
                       timeout=300)


@pytest.mark.parametrize("case", [c for c, _ in TP_CASES])
def test_tensor_parallel_remat_gradients_equal_plain(tp_ranks, case):
    site = {"manual": ("tp_block.seq", 4), "automatic": ("row", 2)}[case]
    layers = get_smoke(dict(TP_CASES)[case]).n_layers
    for r in tp_ranks:
        plain, remat = r[(case, False)], r[(case, True)]
        assert remat["loss"] == plain["loss"]
        assert plain["grads"].keys() == remat["grads"].keys()
        for n, g in plain["grads"].items():
            assert torch.equal(remat["grads"][n], g), n
        fwd = [c for c in remat["calls"] if c[2] == "forward"]
        on_site = [c for c in fwd if c[1] == site[0]]
        n_plain = sum(1 for c in plain["calls"]
                      if c[2] == "forward" and c[1] == site[0])
        # the backward recomputes each layer's forward collectives but
        # its last: the non-reentrant checkpoint stops once it has
        # recomputed every tensor the backward saved, and no op of the
        # layer saves the last collective's output, the layer's output
        assert n_plain == site[1] * layers
        assert len(on_site) == n_plain + (site[1] - 1) * layers
        first_bwd = [c[2] for c in remat["calls"]].index("backward")
        assert remat["calls"][:first_bwd] == [
            c for c in plain["calls"] if c[2] == "forward"]
    # the same collectives in the same order on both ranks
    assert tp_ranks[0][(case, True)]["calls"] == \
        tp_ranks[1][(case, True)]["calls"]
