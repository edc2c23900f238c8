"""Port parity of the recurrent and hybrid families (xlstm: mLSTM and
sLSTM; zamba2: Mamba2 plus one shared attention block) against the JAX
package, on their SMOKE configs, from the same weights (copied through
`repro_torch.bridge`, norm gains, biases and Mamba2's per-head constants
drawn away from their init values so their mapping shows):

* `forward`, `loss_fn` and `make_prefill_step` within 1e-4 (L = 128:
  zamba2's attention through the full-sequence kernel's plain version);
* `decode_step` logits and every cache field within 1e-4, with an idle
  row at lengths == 0, on both attention routes; teacher-forced decode
  against `forward` within 2e-3 (the reference's own test); a wider
  cached launch refused;
* zamba2's shared block: one module object and one weight copy, also in
  the engine's `resident_view`;
* greedy tokens of the flat `ServingEngine` equal to the JAX engine's
  (zamba2 bf16 KV, int8 KV and resident int8; xlstm), with the merged
  mode's counters: no chunk launch, and prefill token steps plus decode
  steps equal to the model calls; the serve launcher on both."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import api
from repro_torch.bridge import caches_from_jax, params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (decode_step, forward, init_caches, loss_fn,
                                resident_view)
from repro_torch.models.layers import Linear
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4
ARCHS = ["zamba2_2p7b", "xlstm_1p3b"]
ROUTES = {"kernel": ("pallas", None), "ref": ("ref", "ref")}
# leaves drawn away from their init values (gains 1, biases and Mamba2's
# a_log / dt_bias 0, its d_skip 1)
_PERTURB = {"g": 1.0, "b": 0.0, "a_log": 0.0, "dt_bias": 0.0, "d_skip": 1.0}


def _perturbed(params, seed=7):
    rng = np.random.RandomState(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in _PERTURB:
            noise = rng.randn(*node.shape).astype(np.float32)
            return jnp.asarray(_PERTURB[key] + 0.3 * noise)
        return node
    return walk(params)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jparams = _perturbed(jinit_params(jax.random.key(0), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return arch, jcfg, tcfg, jparams, model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_forward_logits_match(pair):
    _, jcfg, _, jparams, model = pair
    toks = np.random.RandomState(1).randint(1, jcfg.vocab, (2, 12))
    want, _ = jforward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = forward(model, torch.from_numpy(toks))
    _close(got, want)
    assert float(aux) == 0.0


def test_full_sequence_entry_points_match(pair):
    """L = 128: one full chunk of the recurrences; zamba2's attention takes
    the full-sequence kernel's plain version. `loss_fn` and
    `make_prefill_step` on the same batch."""
    _, jcfg, tcfg, jparams, model = pair
    rng = np.random.RandomState(3)
    toks = rng.randint(1, jcfg.vocab, (2, 128))
    labels = np.where(rng.rand(2, 128) < 0.2, -100,
                      rng.randint(0, jcfg.vocab, (2, 128)))
    assert api.ops.attention_route(lq=128) == "cuda"
    want, _ = jforward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, _ = forward(model, torch.from_numpy(toks))
    _close(got, want)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    wtotal, _ = jloss_fn(jparams, jbatch, jcfg)
    total, _ = loss_fn(model, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    _close(total, wtotal)
    nxt = make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(toks)})
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_logits_and_caches_match(pair, route):
    """Five single-token steps over three rows, the last sitting out at
    lengths == 0 (its recurrent state and KV position must not move);
    every cache field after the last step: the recurrent states whole, the
    KV caches up to each row's position. f32 caches."""
    _, jcfg, tcfg, jparams, model = pair
    jpol, tpol = (japi.policy(backend=ROUTES[route][0]),
                  api.policy(backend=ROUTES[route][1]) if ROUTES[route][1]
                  else api.policy())
    rng = np.random.RandomState(2)
    b, max_len = 3, 16
    jc = jinit_caches(jcfg, batch=b, max_len=max_len, dtype=jnp.float32)
    tc = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    fresh = [{k: v.clone() for k, v in _fields(c).items()} for c in tc]
    active = np.asarray([1, 1, 0], np.int32)
    with jpol, tpol:
        for _ in range(5):
            step = rng.randint(1, jcfg.vocab, (b, 1)).astype(np.int32)
            jl, jc = jdecode_step(jparams, jc, jnp.asarray(step), jcfg,
                                  lengths=jnp.asarray(active))
            tl, tc = decode_step(model, tc, torch.from_numpy(step),
                                 lengths=torch.from_numpy(active))
            _close(tl[:2], np.asarray(jl)[:2])
    want = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for got_c, want_c, init_c in zip(tc, want, fresh):
        assert type(got_c) is type(want_c)
        got_f, want_f = _fields(got_c), _fields(want_c)
        if "pos" not in got_f:
            for name, t in got_f.items():
                assert t.dtype == torch.float32
                _close(t, want_f[name])
                assert torch.equal(t[2], init_c[name][2]), name
            continue
        assert torch.equal(got_c.pos, want_c.pos)
        assert got_c.pos.tolist() == [5, 5, 0]
        for name in ("k", "v"):
            _close(got_f[name][:2, :, :5], want_f[name][:2, :, :5])


def test_teacher_forced_decode_matches_forward(pair):
    """The reference's `test_prefill_decode_equivalence` on the port:
    the step recurrence token by token against the chunked full-sequence
    forward (f32 caches), within 2e-3."""
    _, jcfg, tcfg, _, model = pair
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(1, jcfg.vocab, (1, 20)))
    full, _ = forward(model, toks)
    caches = init_caches(tcfg, 1, 32, device="cpu", dtype=torch.float32)
    steps = [decode_step(model, caches, toks[:, t:t + 1])[0][:, 0]
             for t in range(toks.shape[1])]
    _close(torch.stack(steps, 1), full, tol=2e-3)


def test_decode_step_refuses_a_wider_launch(pair):
    """The reference's recurrent steps read token 0 of each row and
    broadcast it; the port refuses a wider cached launch before any layer
    runs."""
    _, _, tcfg, _, model = pair
    caches = init_caches(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        decode_step(model, caches, torch.ones(2, 3, dtype=torch.long))
    assert all(getattr(c, "pos", torch.zeros(1)).abs().sum() == 0
               for c in caches)


# ======================================================= the shared block
def test_shared_attention_is_shared():
    """The reference's `test_shared_attention_is_shared` on the port: one
    DenseBlock object at every shared position, one weight copy (the
    parameter count equals the JAX pytree's, which holds the shared block
    un-stacked); a resident view keeps one shared block with one set of
    codes, and leaves the caller's block dense."""
    jcfg, tcfg = jax_smoke("zamba2_2p7b"), get_smoke("zamba2_2p7b")
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    kinds = tcfg.block_kinds()
    at = [i for i, k in enumerate(kinds) if k == "shared_attn"]
    assert len(at) == 2 and model.layers[at[0]] is model.layers[at[1]]
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(jparams))
    view = resident_view(model, "int8")
    shared = view.layers[at[0]]
    assert all(view.layers[i] is shared for i in at)
    assert shared is not model.layers[at[0]]
    resident = [m for m in view.modules()
                if isinstance(m, Linear) and m.fmt is not None]
    assert len(resident) == 7                  # q, k, v, o, gate, up, down
    assert all(m.fmt is None for m in model.modules()
               if isinstance(m, Linear))
    # the Mamba2 mixers are shared with the caller's model, dense
    assert view.layers[0].mamba is not model.layers[0].mamba
    assert view.layers[0].mamba.in_proj.w is model.layers[0].mamba.in_proj.w


# ============================================================== the engine
def _mixed(vocab, lens, outs, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, n).astype(np.int32), m)
            for n, m in zip(lens, outs)]


def _serve(engine, request_cls, spec):
    for rid, (p, m) in enumerate(spec):
        assert engine.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in engine.run_until_drained()}


# test_serving.py's mixed batch, and test_prefill_kernel.py's
# test_zamba2_merged_prefill_matches_solo mix (its geometry: chunk 8)
MIXES = {"mixed": (([3, 9, 5, 14, 7], [4, 2, 6, 1, 3], 0), {}),
         "merged": (([3, 12, 6], [4, 3, 5], 24), {"prefill_chunk": 8})}
ENGINE_CASES = [("zamba2_2p7b", "mixed", False), ("zamba2_2p7b", "mixed",
                                                  True),
                ("zamba2_2p7b", "merged", False), ("zamba2_2p7b", "merged",
                                                   True),
                ("xlstm_1p3b", "mixed", False), ("xlstm_1p3b", "merged",
                                                 False)]


def _cfgs(arch, kv_quant):
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    return (dataclasses.replace(jcfg, kv_quant=kv_quant),
            dataclasses.replace(tcfg, kv_quant=kv_quant))


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-"
                                       f"{'int8kv' if c[2] else 'bf16kv'}")
def test_greedy_tokens_match_jax_engine(case):
    arch, mix, kv_quant = case
    jcfg, tcfg = _cfgs(arch, kv_quant)
    (lens, outs, seed), geo = MIXES[mix]
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    spec = _mixed(tcfg.vocab, lens, outs, seed)
    jeng = JServingEngine(jcfg, jparams, slots=2, max_len=64, **geo)
    want = _serve(jeng, JRequest, spec)
    eng = ServingEngine(tcfg, model, slots=2, max_len=64, **geo)
    assert eng.prefill_route() == eng.decode_route() == "cuda-decode"
    got = _serve(eng, Request, spec)
    assert got == want
    st = eng.stats
    assert st.prefill_chunk_calls == 0 and st.quarantines == 0
    assert st.prefill_token_steps + st.decode_steps == st.model_calls
    assert (st.prefill_token_steps, st.decode_steps) == (
        jeng.stats.prefill_token_steps, jeng.stats.decode_steps)


def test_merged_engine_matches_solo_serving():
    """Prefilling rows feed prompt tokens in the launches decoding rows
    generate through: each request's tokens equal its solo run's."""
    tcfg = get_smoke("zamba2_2p7b")
    model = params_from_jax(jax.tree.map(np.asarray, jinit_params(
        jax.random.key(24), jax_smoke("zamba2_2p7b"))), tcfg, device="cpu")
    spec = _mixed(tcfg.vocab, [3, 12, 6], [4, 3, 5], 24)
    solo = [_serve(ServingEngine(tcfg, model, slots=1, max_len=64), Request,
                   [s])[0] for s in spec]
    got = _serve(ServingEngine(tcfg, model, slots=2, max_len=64), Request,
                 spec)
    assert [got[i] for i in range(len(spec))] == solo


def test_zamba2_resident_int8_matches_jax_resident_engine():
    """`weight_format="int8"`: the shared block's seven Linears resident
    (the Mamba2 mixers and the lm_head stay dense in both packages); the
    port's kernel route (plain versions here) gives the JAX resident
    engine's tokens on its Pallas route. The health probe records at every
    invocation of the shared block."""
    jcfg, tcfg = _cfgs("zamba2_2p7b", False)
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    spec = _mixed(tcfg.vocab, [3, 9, 5, 14, 7], [4, 2, 6, 1, 3])
    jeng = JServingEngine(jcfg, jparams, weight_format="int8",
                          policy=japi.ExecutionPolicy(backend="pallas"),
                          slots=2, max_len=64)
    want = _serve(jeng, JRequest, spec)
    eng = ServingEngine(tcfg, model, weight_format="int8", slots=2,
                        max_len=64)
    assert eng.weight_route() == "resident-int8"
    assert _serve(eng, Request, spec) == want
    n_shared = tcfg.block_kinds().count("shared_attn")
    # two probed projections (o, down), each at every invocation
    assert len(eng._probe.mods) == 2
    assert eng._probe.points == eng._probe.n == 2 * n_shared


@pytest.mark.parametrize("arch,route", [("zamba2_2p7b", "resident-int4"),
                                        ("xlstm_1p3b", "dense")])
def test_serve_launcher_on_cpu(capsys, arch, route):
    """`launch.serve --arch ... --weight-format int4` serves the SMOKE
    config through merged launches: zamba2's shared block resident, xlstm
    with no covered Linear (its mixers and lm_head stay dense)."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--weight-format", "int4", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert f"weight route {route}" in out
    assert "prefill route cuda-decode" in out
    assert " 0 chunked prefills" in out
    assert int(re.search(r"(\d+) prefill token steps", out).group(1)) > 0


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_chunk_of_one_runs_merged_on_a_dense_model(paged):
    """`prefill_chunk=1` takes the merged path on any model, as in the
    reference: no chunk launch, one launch a step, the decode route for
    the prefill, and the tokens of a chunked engine (paged: the prompts
    share a head, so a row registers its prefix and another hits it)."""
    cfg = get_smoke("qwen2_1p5b")
    model = params_from_jax(jax.tree.map(np.asarray, jinit_params(
        jax.random.key(0), jax_smoke("qwen2_1p5b"))), cfg, device="cpu")
    head = _mixed(cfg.vocab, [10], [0], 9)[0][0]
    spec = [(np.concatenate([head, p]), m)
            for p, m in _mixed(cfg.vocab, [3, 9, 5], [4, 2, 6])]
    kw = dict(slots=2, max_len=64, paged=paged, block_size=8)
    want = _serve(ServingEngine(cfg, model, prefill_chunk=8, **kw), Request,
                  spec)
    eng = ServingEngine(cfg, model, prefill_chunk=1, **kw)
    assert eng.prefill_route() == "cuda-decode"
    assert _serve(eng, Request, spec) == want
    st = eng.stats
    assert st.prefill_chunk_calls == 0 and st.prefill_token_steps > 0
    assert st.prefill_token_steps + st.decode_steps == st.model_calls
    if paged:
        assert eng.pool_stats()["prefix_hits"] > 0
