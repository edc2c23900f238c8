"""Port parity of the families beside the llama family (internlm2, olmo,
gpt2, gemma2, olmoe, kimi-k2) against the JAX package, on their SMOKE
configs, from the same weights (copied through `repro_torch.bridge`, with
non-trivial norm gains and biases so their mapping shows):

* `forward` logits and MoE aux within 1e-4; the full-sequence entry points
  (`forward` at L = 128 through the full-sequence kernel's plain version,
  `loss_fn`, `make_prefill_step`);
* `decode_step` logits and caches within 1e-4, a right-padded chunk with
  an idle row and then single-token steps, on both attention routes (the
  port's kernel route against JAX's Pallas route, ref against ref);
* greedy tokens of the `ServingEngine` equal to the JAX engine's, flat
  and paged (MoE configs on both routes); paged equal to flat bitwise on
  the kernel route; resident int8 equal to the JAX resident engine;
* the reference behaviour the port mirrors on purpose: gemma2's `forward`
  scales the embeddings and `decode_step` does not, so the two disagree in
  both packages; on MoE configs the routes give different tokens, because
  a chunk's pad rows (0 on the kernel route, attention over stale cache
  on ref) compete for expert capacity;
* every config of the reference builds in the port, the frontend families
  (whisper, internvl2) too, with the reference's fields and layer kinds
  (their parity: tests/test_torch_frontends.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jax_config
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
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, loss_fn)
from repro_torch.models.transformer import ModelConfig, Transformer
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4
NEW_ARCHS = ["internlm2_20b", "olmo_1b", "gpt2_small", "gemma2_27b",
             "olmoe_1b_7b", "kimi_k2"]
MOE_ARCHS = ["olmoe_1b_7b", "kimi_k2"]
# the port's kernel route (plain versions on the CPU) is held to JAX's
# Pallas route, its ref route to JAX's ref route
ROUTES = {"kernel": ("pallas", None), "ref": ("ref", "ref")}


def _perturbed(params, seed=7):
    """The JAX params with every norm gain ("g") and bias ("b") drawn
    around its init value, so a wrong mapping of one shows."""
    rng = np.random.RandomState(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in ("g", "b"):
            base = 1.0 if key == "g" else 0.0
            noise = rng.randn(*node.shape).astype(np.float32)
            return jnp.asarray(base + 0.3 * noise)
        return node
    return walk(params)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jparams = _perturbed(jinit_params(jax.random.key(0), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return arch, jcfg, tcfg, jparams, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _route(name):
    jax_backend, port_backend = ROUTES[name]
    return (japi.policy(backend=jax_backend),
            api.policy(backend=port_backend) if port_backend
            else api.policy())


def test_forward_logits_and_aux_match(pair):
    _, jcfg, _, jparams, model = pair
    toks = np.random.RandomState(1).randint(1, jcfg.vocab, (2, 12))
    want, waux = jforward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = forward(model, torch.from_numpy(toks))
    _close(got, want)
    _close(aux, waux)
    assert (float(aux) > 0) == (jcfg.family == "moe")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_logits_and_caches_match(pair, route):
    """A right-padded chunk (a full row, a short row, an idle row), then
    three single-token steps (the idle row still sitting out). f32 caches:
    in a bf16 cache an f32 ulp between the packages' projections can
    round a key to the neighbouring bf16 value (the engine tests below
    serve from bf16 caches)."""
    _, jcfg, tcfg, jparams, model = pair
    jpol, tpol = _route(route)
    rng = np.random.RandomState(2)
    b, l, max_len = 3, 10, 32
    jc = jinit_caches(jcfg, batch=b, max_len=max_len, dtype=jnp.float32)
    tc = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    toks = rng.randint(1, jcfg.vocab, (b, l)).astype(np.int32)
    lens = np.asarray([l, 4, 0], np.int32)
    with jpol, tpol:
        jl, jc = jdecode_step(jparams, jc, jnp.asarray(toks), jcfg,
                              lengths=jnp.asarray(lens))
        tl, tc = decode_step(model, tc, torch.from_numpy(toks),
                             lengths=torch.from_numpy(lens))
        for r in range(b):
            _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])
        active = np.asarray([1, 1, 0], np.int32)
        for _ in range(3):
            step = rng.randint(1, jcfg.vocab, (b, 1)).astype(np.int32)
            jl, jc = jdecode_step(jparams, jc, jnp.asarray(step), jcfg,
                                  lengths=jnp.asarray(active))
            tl, tc = decode_step(model, tc, torch.from_numpy(step),
                                 lengths=torch.from_numpy(active))
            _close(tl[:2], np.asarray(jl)[:2])
    want = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for got_c, want_c in zip(tc, want):
        assert torch.equal(got_c.pos, want_c.pos)
        for r, front in enumerate(want_c.pos.tolist()):
            for name in ("k", "v"):
                torch.testing.assert_close(
                    getattr(got_c, name)[r, :, :front].float(),
                    getattr(want_c, name)[r, :, :front].float(), rtol=TOL,
                    atol=TOL)


@pytest.mark.parametrize("arch", ["gemma2_27b", "kimi_k2"])
def test_full_sequence_entry_points_match(arch):
    """L = 128: the port's attention takes the full-sequence kernel's plain
    version (gemma2: window 16 and softcap inside it); `loss_fn` (with the
    MoE aux term) and `make_prefill_step` on the same batch."""
    jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jparams = _perturbed(jinit_params(jax.random.key(1), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
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
    wtotal, wparts = jloss_fn(jparams, jbatch, jcfg)
    total, parts = loss_fn(model, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    _close(total, wtotal)
    _close(parts["aux"], wparts["aux"])
    nxt = make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(toks)})
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()


def test_gemma2_forward_and_decode_disagree_in_both_packages():
    """The reference scales gemma's embeddings by sqrt(d_model) in
    `forward` only (`src/repro/models/transformer.py` `forward` vs
    `decode_step`), so the full-sequence logits and the step-by-step
    decode chain disagree, in JAX and in the port alike; each port path
    matches its JAX counterpart."""
    jcfg, tcfg = jax_smoke("gemma2_27b"), get_smoke("gemma2_27b")
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    toks = np.random.RandomState(5).randint(1, jcfg.vocab, (1, 8))
    jfull = np.asarray(jforward(jparams, jnp.asarray(toks, jnp.int32),
                                jcfg)[0])
    tfull = forward(model, torch.from_numpy(toks))[0].numpy()
    jc = jinit_caches(jcfg, batch=1, max_len=16, dtype=jnp.float32)
    tc = init_caches(tcfg, batch=1, max_len=16, device="cpu",
                     dtype=torch.float32)
    jsteps, tsteps = [], []
    for i in range(toks.shape[1]):
        t = toks[:, i:i + 1].astype(np.int32)
        jl, jc = jdecode_step(jparams, jc, jnp.asarray(t), jcfg)
        jsteps.append(np.asarray(jl)[:, 0])
        tsteps.append(decode_step(model, tc, torch.from_numpy(t))[0][:, 0]
                      .numpy())
    jsteps, tsteps = np.stack(jsteps, 1), np.stack(tsteps, 1)
    _close(tfull, jfull)
    _close(tsteps, jsteps)
    assert np.abs(jfull - jsteps).max() > 0.05
    assert np.abs(tfull - tsteps).max() > 0.05


# =========================================================== the engine
def _mixed(vocab, lens, outs, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, n).astype(np.int32), m)
            for n, m in zip(lens, outs)]


def _engine_spec(arch, vocab):
    """`tests/test_serving.py`'s cases where it has one: gemma2's mixed
    batch (its window of 16 crossed) and olmo's padded pair; the mixed
    batch for the others."""
    if arch == "olmo_1b":
        return [(np.asarray([3, 5, 7, 11], np.int32), 5),
                (np.arange(2, 17, dtype=np.int32), 5)]
    return _mixed(vocab, [3, 9, 5, 14, 7], [4, 2, 6, 1, 3])


def _serve(engine, request_cls, spec):
    for rid, (p, m) in enumerate(spec):
        assert engine.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in engine.run_until_drained()}


GEO = dict(slots=2, max_len=64)
PAGED = dict(paged=True, block_size=8)
# (arch, paged, route): MoE configs on both routes, the others on the
# JAX engine's default (ref) route against the port's default (kernel)
ENGINE_CASES = [(a, paged, "kernel") for a in NEW_ARCHS
                for paged in (False, True)]
ENGINE_CASES += [(a, paged, "ref") for a in MOE_ARCHS
                 for paged in (False, True)]


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine's tokens per (arch, paged, route), each run once."""
    done = {}

    def run(arch, paged, route):
        if (arch, paged, route) not in done:
            jcfg = jax_smoke(arch)
            jparams = jinit_params(jax.random.key(0), jcfg)
            backend = ROUTES[route][0] if arch in MOE_ARCHS else "auto"
            eng = JServingEngine(jcfg, jparams,
                                 policy=japi.ExecutionPolicy(backend=backend),
                                 **GEO, **(PAGED if paged else {}))
            done[arch, paged, route] = _serve(
                eng, JRequest, _engine_spec(arch, jcfg.vocab))
        return done[arch, paged, route]
    return run


@pytest.fixture(scope="module")
def port_models():
    models = {}

    def get(arch):
        if arch not in models:
            jparams = jinit_params(jax.random.key(0), jax_smoke(arch))
            models[arch] = params_from_jax(
                jax.tree.map(np.asarray, jparams), get_smoke(arch),
                device="cpu")
        return models[arch]
    return get


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=lambda c: f"{c[0]}-{'paged' if c[1] else 'flat'}"
                                       f"-{c[2]}")
def test_greedy_tokens_match_jax_engine(case, jax_tokens, port_models):
    arch, paged, route = case
    cfg = get_smoke(arch)
    policy = api.ExecutionPolicy(backend="ref") if route == "ref" else None
    eng = ServingEngine(cfg, port_models(arch), policy=policy, **GEO,
                        **(PAGED if paged else {}))
    got = _serve(eng, Request, _engine_spec(arch, cfg.vocab))
    assert got == jax_tokens(arch, paged, route)
    assert eng.stats.quarantines == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routes_serve_different_tokens_in_both_packages(arch, jax_tokens):
    """A chunk's pad rows reach the MoE layer with the attention route's
    pad-row values (0 on the kernel route, attention over stale cache on
    ref) and compete for expert capacity, so the two routes serve other
    tokens on this mix, in the reference and (by the test above) in the
    port alike; the kernel route's paged engine equals its flat one."""
    assert jax_tokens(arch, False, "kernel") != jax_tokens(arch, False, "ref")
    assert jax_tokens(arch, True, "kernel") == jax_tokens(arch, False,
                                                          "kernel")


def test_moe_prefix_hits_change_the_tokens_in_both_packages(port_models):
    """A paged prefix hit starts a row at its shared-token count, so its
    prompt goes through other chunk launches than on the flat engine; on
    an MoE config those launches' positions compete for expert capacity,
    so the paged engine's tokens differ from the flat one's, in the
    reference (Pallas route) as in the port, which equals it."""
    jcfg, cfg = jax_smoke("olmoe_1b_7b"), get_smoke("olmoe_1b_7b")
    rng = np.random.RandomState(1)
    head = rng.randint(1, cfg.vocab, 20).astype(np.int32)
    spec = [(np.concatenate([head, rng.randint(1, cfg.vocab, n)])
             .astype(np.int32), 6) for n in (3, 40, 11, 25)]
    geo = dict(slots=2, max_len=128, prefill_chunk=16, block_size=16)
    jparams = jinit_params(jax.random.key(0), jcfg)
    pallas = japi.ExecutionPolicy(backend="pallas")
    got, want = {}, {}
    for paged in (False, True):
        jeng = JServingEngine(jcfg, jparams, policy=pallas, paged=paged,
                              **geo)
        want[paged] = _serve(jeng, JRequest, spec)
        eng = ServingEngine(cfg, port_models("olmoe_1b_7b"), paged=paged,
                            **geo)
        got[paged] = _serve(eng, Request, spec)
    assert eng.pool_stats()["prefix_hits"] > 0
    assert got == want
    assert got[True] != got[False]


class _LogitEngine(ServingEngine):
    """Records, per request, the logits row of every token it emits."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rows, self._now = {}, None

    def _greedy(self, rows, health):
        self._now = rows
        return super()._greedy(rows, health)

    def _emit(self, s, tok, newly):
        self.rows.setdefault(self._slot_req[s].rid, []).append(
            self._now[s].clone())
        super()._emit(s, tok, newly)


@pytest.mark.parametrize("arch", ["gemma2_27b", "olmoe_1b_7b"])
def test_paged_equals_flat_bitwise(arch, port_models):
    """On the kernel route the paged engine emits every token from the
    same logits as the per-slot engine, bit for bit."""
    cfg = get_smoke(arch)
    spec = _engine_spec(arch, cfg.vocab)
    flat = _LogitEngine(cfg, port_models(arch), **GEO)
    paged = _LogitEngine(cfg, port_models(arch), **GEO, **PAGED)
    assert _serve(flat, Request, spec) == _serve(paged, Request, spec)
    assert sorted(flat.rows) == sorted(paged.rows) == list(range(len(spec)))
    for rid, rows in flat.rows.items():
        assert len(rows) == len(paged.rows[rid]) == spec[rid][1]
        for a, b in zip(rows, paged.rows[rid]):
            assert torch.equal(a, b), rid


@pytest.mark.parametrize("arch", ["gpt2_small", "olmoe_1b_7b"])
def test_resident_int8_matches_jax_resident_engine(arch, port_models):
    """`weight_format="int8"`: the port's kernel route (quantizer then AIO
    GEMM, plain versions here) gives the JAX resident engine's tokens on
    its Pallas route; the MoE layer stays dense in both."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jparams = jinit_params(jax.random.key(0), jcfg)
    spec = _engine_spec(arch, cfg.vocab)
    jeng = JServingEngine(jcfg, jparams, weight_format="int8",
                          policy=japi.ExecutionPolicy(backend="pallas"),
                          **GEO)
    want = _serve(jeng, JRequest, spec)
    eng = ServingEngine(cfg, port_models(arch), weight_format="int8", **GEO)
    assert eng.weight_route() == "resident-int8"
    assert _serve(eng, Request, spec) == want
    for block in eng.model.layers:
        if block.moe is not None:
            assert block.moe.router.fmt is None
            assert block.moe.gate.dtype == torch.float32


# ====================================================== config coverage
def test_every_ported_arch_builds():
    """`get_config` / `get_smoke` for all twelve archs; `Transformer`
    builds each SMOKE config with the reference's layer kinds."""
    assert len(ARCH_IDS) == 12
    for arch in ARCH_IDS:
        full, smoke = get_config(arch), get_smoke(arch)
        assert full.family == smoke.family
        assert full.block_kinds() == jax_config(arch).block_kinds()
        model = Transformer(smoke, device="cpu")
        assert [b.kind for b in model.layers] == \
            jax_smoke(arch).block_kinds()


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "xlstm_1p3b"])
def test_recurrent_archs_now_build_with_the_reference_block_kinds(arch):
    """The hybrid and recurrent families (A7 step 4), refused before, now
    build from the reference's own SMOKE config (its fields copied over),
    with the reference's layer kinds, and are in the registry."""
    jcfg = jax_smoke(arch)
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"quant"}
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in fields})
    assert arch in ARCH_IDS and cfg == get_smoke(arch)
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.layers] == jcfg.block_kinds()
    assert cfg.segments() == jcfg.segments()


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_76b"])
def test_frontend_archs_now_build_with_the_reference_block_kinds(arch):
    """The frontend families (A7 step 5: audio, vlm), refused before, now
    build from the reference's own SMOKE config (its fields copied over),
    with the reference's decoder layer kinds (whisper's "encdec", and its
    encoder of `encoder_layers` "enc" blocks), and are in the registry."""
    jcfg = jax_smoke(arch)
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"quant"}
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in fields})
    assert arch in ARCH_IDS and cfg == get_smoke(arch)
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.layers] == jcfg.block_kinds()
    assert cfg.segments() == jcfg.segments()
    enc = [] if model.encoder is None else [b.kind for b in model.encoder]
    assert enc == ["enc"] * jcfg.encoder_layers
