"""Port parity of the frontend families against the JAX package, on their
SMOKE configs, from the same weights (copied through `repro_torch.bridge`,
with non-trivial norm gains and biases so their mapping shows): whisper
(the audio encoder and cross attention) and internvl2 (patch embeddings
prepended to the token stream).

* `CrossAttention` and an encoder ("enc") block within 1e-5; `encode`
  against the JAX engine's `_encode_memory`;
* `forward(frames=)` and `forward(prefix_embeds=)` logits within 1e-4 at
  128 positions (the full-sequence kernel's plain version, cross attention
  non-causal over the 16 frames), `loss_fn` within 1e-4 relative and
  `make_prefill_step`'s tokens;
* `decode_step(memory=)`: a right-padded chunk with an idle row, then
  single-token steps: logits and caches within 1e-4 (f32 caches);
* the flat engines' greedy tokens (`frames=`) equal to the JAX engine's,
  bf16 KV, int8 KV and resident int8 (f32 caches), at chunks 4 and 32
  (bf16 KV at 32 in tests/test_torch_frontend_faults.py; resident at 4 on
  the ref routes);
* both configs in the registry with the reference's fields and layer
  kinds."""
import dataclasses
import functools

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
from repro.models.attention import cross_attn_apply
from repro.models.transformer import _block_apply
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _encode_memory
from repro_torch import api
from repro_torch.bridge import caches_from_jax, params_from_jax
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, loss_fn)
from repro_torch.models.transformer import ModelConfig, encode
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4
MODULE_TOL = 1e-5
ARCHS = ["whisper_tiny", "internvl2_76b"]
GEO = dict(slots=2, max_len=32)


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


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = jax_smoke(arch), get_smoke(arch)
        jparams = _perturbed(jax.jit(jinit_params, static_argnums=1)(
            jax.random.key(0), jcfg))
        model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
        out[arch] = (jcfg, tcfg, jparams, model)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _frontend(jcfg, b, seed):
    """(B, frontend_len, d_model) random frame or patch embeddings."""
    rng = np.random.RandomState(seed)
    return rng.randn(b, jcfg.frontend_len, jcfg.d_model).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jencode(jcfg):
    """The JAX engine's encoder pass, jitted as the engine jits it."""
    return jax.jit(lambda p, f: _encode_memory(p, f, jcfg))


# ============================================================== modules
def test_cross_attention_and_encoder_block_match(pairs):
    """Decoder layer 0's cross attention (q from x, k/v from a 16-frame
    memory, non-causal, no RoPE) and encoder layer 1's non-causal block
    (RoPE at arange(T)) against the reference's `cross_attn_apply` and
    `_block_apply("enc")`; `encode` against the JAX engine's
    `_encode_memory`."""
    jcfg, _, jparams, model = pairs["whisper_tiny"]
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, jcfg.d_model).astype(np.float32)
    mem = rng.randn(2, jcfg.frontend_len, jcfg.d_model).astype(np.float32)
    xp = jax.tree.map(lambda a: a[0],
                      jparams["segments"][0]["0_encdec"]["xattn"])
    want = jax.jit(functools.partial(
        cross_attn_apply, n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads))(
            xp, jnp.asarray(x), jnp.asarray(mem))
    got = model.layers[0].xattn(torch.from_numpy(x), torch.from_numpy(mem))
    _close(got, want, MODULE_TOL)
    ep = jax.tree.map(lambda a: a[1], jparams["encoder"])
    want, _, _ = jax.jit(lambda p, m: _block_apply("enc", p, m, jcfg))(
        ep, jnp.asarray(mem))
    got, _ = model.encoder[1](torch.from_numpy(mem))
    _close(got, want, MODULE_TOL)
    assert not model.encoder[1].causal
    frames = _frontend(jcfg, 3, 5)
    _close(encode(model, torch.from_numpy(frames)),
           _jencode(jcfg)(jparams, jnp.asarray(frames)), MODULE_TOL)


# ==================================================== full-sequence path
def _inputs(arch, jcfg):
    """128 positions in all: whisper 128 tokens over 16 frames, internvl2
    8 patch embeddings and 120 tokens."""
    rng = np.random.RandomState(3)
    n_tok = 128 if arch == "whisper_tiny" else 128 - jcfg.frontend_len
    toks = rng.randint(1, jcfg.vocab, (2, n_tok))
    labels = np.where(rng.rand(2, n_tok) < 0.2, -100,
                      rng.randint(0, jcfg.vocab, (2, n_tok)))
    key = "frames" if arch == "whisper_tiny" else "patch_embeds"
    return toks, labels, key, _frontend(jcfg, 2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_entry_points_match(pairs, arch):
    """`forward` with frames (whisper) or prefix embeddings (internvl2)
    over 128 positions, through the full-sequence kernel's plain version;
    `loss_fn` reading batch["frames"] / batch["patch_embeds"], and
    `make_prefill_step` on the same batch."""
    jcfg, tcfg, jparams, model = pairs[arch]
    toks, labels, key, extra = _inputs(arch, jcfg)
    assert api.ops.attention_route(lq=128) == "cuda"
    kw = "frames" if key == "frames" else "prefix_embeds"
    want, _ = jax.jit(jforward, static_argnums=2)(
        jparams, jnp.asarray(toks, jnp.int32), jcfg,
        **{kw: jnp.asarray(extra)})
    got, _ = forward(model, torch.from_numpy(toks),
                     **{kw: torch.from_numpy(extra)})
    assert got.shape == (2, toks.shape[1], jcfg.vocab)
    _close(got, want)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32),
              key: jnp.asarray(extra)}
    wtotal, _ = jax.jit(jloss_fn, static_argnums=2)(jparams, jbatch, jcfg)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             key: torch.from_numpy(extra)}
    total, _ = loss_fn(model, batch)
    assert abs(float(total) - float(wtotal)) <= TOL * abs(float(wtotal))
    nxt = make_prefill_step(tcfg)(model, batch)
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()


def test_decode_step_with_memory_matches(pairs):
    """A right-padded chunk (a full row, a short row, an idle row), then
    three single-token steps with the idle row still out, every decoder
    layer cross-attending the encoded memory: logits of the valid
    positions and the caches within 1e-4 (f32 caches)."""
    jcfg, tcfg, jparams, model = pairs["whisper_tiny"]
    rng = np.random.RandomState(2)
    b, l, max_len = 3, 10, 32
    frames = _frontend(jcfg, b, 5)
    jmem = _jencode(jcfg)(jparams, jnp.asarray(frames))
    jstep = jax.jit(jdecode_step, static_argnums=3)
    mem = encode(model, torch.from_numpy(frames))
    jc = jinit_caches(jcfg, batch=b, max_len=max_len, dtype=jnp.float32)
    tc = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    toks = rng.randint(1, jcfg.vocab, (b, l)).astype(np.int32)
    lens = np.asarray([l, 4, 0], np.int32)
    jl, jc = jstep(jparams, jc, jnp.asarray(toks), jcfg, memory=jmem,
                   lengths=jnp.asarray(lens))
    tl, tc = decode_step(model, tc, torch.from_numpy(toks), memory=mem,
                         lengths=torch.from_numpy(lens))
    for r in range(b):
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])
    active = np.asarray([1, 1, 0], np.int32)
    for _ in range(3):
        step = rng.randint(1, jcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(step), jcfg, memory=jmem,
                       lengths=jnp.asarray(active))
        tl, tc = decode_step(model, tc, torch.from_numpy(step), memory=mem,
                             lengths=torch.from_numpy(active))
        _close(tl[:2], np.asarray(jl)[:2])
    want = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for got_c, want_c in zip(tc, want):
        assert torch.equal(got_c.pos, want_c.pos)
        for r, front in enumerate(want_c.pos.tolist()):
            for name in ("k", "v"):
                torch.testing.assert_close(
                    getattr(got_c, name)[r, :, :front],
                    getattr(want_c, name)[r, :, :front], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="memory"):
        decode_step(model, tc, torch.from_numpy(step))


# =========================================================== the engine
SPEC_LENS, SPEC_OUTS = [3, 6, 4], [3, 1, 3]
# (KV format, resident weights)
FORMATS = {"bf16-kv": (False, None), "int8-kv": (True, None),
           "resident-int8": (False, "int8")}
# (format, chunk, route): the port's kernel route (plain versions) against
# the JAX engine's default route, and, resident, against JAX's Pallas route
# (tests/test_torch_families.py's pairing); the resident engine at chunk 4
# on the ref routes of both (JAX's interpret-mode Pallas engine takes ~10 s
# there). Each chunk against a JAX engine of that chunk: on this mix the
# chunk changes a token (f32 products of other widths, rounded into bf16
# K/V), in both packages alike. bf16 KV at chunk 32 is
# tests/test_torch_frontend_faults.py's flat engine.
CASES = [("bf16-kv", 4, "kernel"), ("int8-kv", 4, "kernel"),
         ("int8-kv", 32, "kernel"), ("resident-int8", 32, "kernel"),
         ("resident-int8", 4, "ref")]


def _spec(vocab):
    rng = np.random.RandomState(0)
    return [(rng.randint(1, vocab, n).astype(np.int32), m)
            for n, m in zip(SPEC_LENS, SPEC_OUTS)]


def _serve(engine, request_cls, spec):
    for rid, (p, m) in enumerate(spec):
        assert engine.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in engine.run_until_drained()}


@pytest.mark.parametrize("fmt,chunk,route", CASES)
def test_flat_engine_tokens_match_jax_engine(pairs, fmt, chunk, route):
    """`ServingEngine(frames=)`: slot s cross-attends frames[s], encoded
    once at construction (resident: through the resident encoder); the
    port's tokens equal the JAX engine's on a mix of three requests over
    two slots (the third refills a slot). Resident int8 serves from f32
    caches in both packages: an f32 ulp between the packages' K
    projections can round to the neighbouring bf16 value, and the int8
    activation codes of the next Linears amplify it (0.056 on this mix's
    first logits, a flipped token)."""
    jcfg, tcfg, jparams, model = pairs["whisper_tiny"]
    kv_quant, wfmt = FORMATS[fmt]
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tcfg = dataclasses.replace(tcfg, kv_quant=kv_quant)
    frames = _frontend(jcfg, GEO["slots"], 6)
    spec = _spec(jcfg.vocab)
    backend = "ref" if route == "ref" else "pallas" if wfmt else "auto"
    jeng = JServingEngine(jcfg, jparams, frames=frames, prefill_chunk=chunk,
                          weight_format=wfmt,
                          policy=japi.ExecutionPolicy(backend=backend),
                          **GEO)
    if wfmt:
        jeng.caches = jinit_caches(jeng.cfg, batch=GEO["slots"],
                                   max_len=GEO["max_len"], dtype=jnp.float32)
    want = _serve(jeng, JRequest, spec)
    policy = api.ExecutionPolicy(backend="ref") if route == "ref" else None
    eng = ServingEngine(tcfg, model, frames=frames, prefill_chunk=chunk,
                        weight_format=wfmt, policy=policy, **GEO)
    if wfmt:
        eng.caches = init_caches(tcfg, GEO["slots"], GEO["max_len"],
                                 device="cpu", dtype=torch.float32)
    assert eng.memory.shape == (GEO["slots"], jcfg.frontend_len,
                                jcfg.d_model)
    assert eng.weight_route() == (f"resident-{wfmt}" if wfmt else "dense")
    assert _serve(eng, Request, spec) == want
    assert eng.stats.quarantines == 0
    if wfmt and route == "kernel":
        # the health probe reads every decoder layer's self and cross
        # attention output projections and its MLP's fc2
        assert eng._probe.points == 3 * tcfg.n_layers


def test_engine_needs_frames_of_its_slots(pairs):
    """An audio model without frames refuses (the reference asserts), as
    do frames for another slot count or width."""
    jcfg, tcfg, _, model = pairs["whisper_tiny"]
    with pytest.raises(ValueError, match="frames"):
        ServingEngine(tcfg, model, **GEO)
    with pytest.raises(ValueError, match="frames"):
        ServingEngine(tcfg, model, frames=_frontend(jcfg, 3, 0), **GEO)


# ====================================================== config coverage
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_configs_match_the_reference(arch):
    """CONFIG and SMOKE carry the reference's fields (its JAX-only knobs
    aside), and the model builds with its decoder layer kinds (and, for
    whisper, its encoder stack)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"quant"}
    for ours, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke(arch), jax_smoke(arch))):
        assert ours == ModelConfig(**{f: getattr(ref, f) for f in fields})
        assert ours.segments() == ref.segments()
    assert arch in ARCH_IDS
    cfg = get_smoke(arch)
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.layers] == cfg.block_kinds()
    if cfg.family == "audio":
        assert [b.kind for b in model.encoder] == ["enc"] \
            * cfg.encoder_layers
    else:
        assert model.encoder is None
