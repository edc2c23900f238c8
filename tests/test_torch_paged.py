"""Port parity of the paged (block-pool) KV path: the plain versions of the
paged attention kernels against the JAX package's paged Pallas kernels in
interpret mode, on shuffled pools at block sizes 8, 16 and 128 (dense and
int8-KV); the op surface with `block_tables`; `_paged_update` (dropped
writes, codes and scales equal to JAX's); a decode step on bridged paged
caches; the paged engine's greedy tokens against the JAX paged engine and
against the port's own per-slot engine (also with resident int4 weights);
and the allocator's behaviours (LRU eviction, deferral then REJECTED,
copy-on-write isolation, pool accounting) mirrored from the reference's
paged tests, plus the launcher.

Tolerance: 2e-5 (f32 attention summed in another order), as
tests/test_torch_attention.py; 1e-4 for model logits, as
tests/test_torch_model.py. Tokens, codes, scales and pool counters are
compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.kernels.flash_attention import (flash_decode_paged_pallas,
                                           flash_decode_paged_quant_pallas,
                                           flash_prefill_paged_pallas,
                                           flash_prefill_paged_quant_pallas)
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models.attention import _paged_update as jpaged_update
from repro.models.attention import _q8 as jq8
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import api
from repro_torch.bridge import caches_from_jax, params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import (
    PAGED_KERNELS, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_paged_quant, flash_decode_paged_quant_plain,
    flash_decode_plain, flash_prefill_paged, flash_prefill_paged_plain,
    flash_prefill_paged_quant, flash_prefill_paged_quant_plain,
    flash_prefill_plain)
from repro_torch.launch import serve
from repro_torch.models import (decode_step, init_caches, init_params,
                                 set_block_tables)
from repro_torch.models.attention import (PagedKVCache, PagedQuantKVCache,
                                          _paged_update, _q8)
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 2e-5
MODEL_TOL = 1e-4
MAX_LEN = 64
B, HQ, HKV, D, LK = 3, 4, 2, 64, 128
DECODE_POS = [0, 37, LK - 1]
W = 20
PREFILL_POS, PREFILL_LEN = [0, 37, LK - W], [W, 3, 0]


# ------------------------------------------------------------------ helpers
def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pool(kv, bs, seed):
    """Scatter (B, Hkv, L, X) into a shuffled (B * L / bs, Hkv, bs, X) pool
    and its (B, L / bs) table, so the indirection is not the identity."""
    b, _, lk, _ = kv.shape
    nblk = lk // bs
    table = np.random.RandomState(seed).permutation(b * nblk) \
        .reshape(b, nblk).astype(np.int32)
    pool = np.empty((b * nblk,) + kv.shape[1:2] + (bs,) + kv.shape[3:],
                    kv.dtype)
    for i in range(b):
        for j in range(nblk):
            pool[table[i, j]] = kv[i, :, j * bs:(j + 1) * bs]
    return pool, table


def _case(seed, lq, bs, quant):
    """q, and K/V (or codes + scales, JAX's _q8) both flat and pooled."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HQ, lq, D).astype(np.float32) * 0.5
    k = rng.randn(B, HKV, LK, D).astype(np.float32) * 0.5
    v = rng.randn(B, HKV, LK, D).astype(np.float32)
    flat = [k, v]
    if quant:
        kc, ks = (np.asarray(a) for a in jq8(jnp.asarray(k)))
        vc, vs = (np.asarray(a) for a in jq8(jnp.asarray(v)))
        flat = [kc, ks, vc, vs]
    pools = [_pool(a, bs, seed)[0] for a in flat]
    table = _pool(flat[0], bs, seed)[1]
    return q, flat, pools, table


def _assert_valid_close(got, want, lens):
    got, want = np.asarray(got), np.asarray(want)
    for b, ln in enumerate(lens):
        np.testing.assert_allclose(got[b, :, :ln], want[b, :, :ln],
                                   rtol=TOL, atol=TOL)
        assert not got[b, :, ln:].any(), f"row {b}: pad tail not zero"


# ========================================================= plain vs Pallas
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("bs,window,softcap", [(8, None, None),
                                               (16, 40, 30.0),
                                               (128, None, None)])
def test_decode_paged_plain_matches_pallas(bs, window, softcap, quant):
    q, _, pools, table = _case(1, 1, bs, quant)
    pos = np.asarray(DECODE_POS, np.int32)
    kw = dict(window=window, softcap=softcap)
    jfn = flash_decode_paged_quant_pallas if quant \
        else flash_decode_paged_pallas
    want = jfn(jnp.asarray(q), *(jnp.asarray(p) for p in pools),
               table=jnp.asarray(table), pos=jnp.asarray(pos),
               interpret=True, **kw)
    args = _t(q, *pools)
    tkw = dict(table=torch.from_numpy(table), pos=torch.from_numpy(pos), **kw)
    plain = flash_decode_paged_quant_plain if quant \
        else flash_decode_paged_plain
    got = plain(*args, **tkw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the wrapper takes the plain version for CPU tensors
    wrapper = flash_decode_paged_quant if quant else flash_decode_paged
    assert torch.equal(wrapper(*args, **tkw), got)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("bs,window,softcap", [(8, None, None),
                                               (16, 40, 30.0),
                                               (128, None, None)])
def test_prefill_paged_plain_matches_pallas(bs, window, softcap, quant):
    q, _, pools, table = _case(2, W, bs, quant)
    pos = np.asarray(PREFILL_POS, np.int32)
    lens = np.asarray(PREFILL_LEN, np.int32)
    kw = dict(window=window, softcap=softcap)
    jfn = flash_prefill_paged_quant_pallas if quant \
        else flash_prefill_paged_pallas
    want = jfn(jnp.asarray(q), *(jnp.asarray(p) for p in pools),
               table=jnp.asarray(table), pos=jnp.asarray(pos),
               lengths=jnp.asarray(lens), bq=8, interpret=True, **kw)
    args = _t(q, *pools)
    tkw = dict(table=torch.from_numpy(table), pos=torch.from_numpy(pos),
               lengths=torch.from_numpy(lens), **kw)
    plain = flash_prefill_paged_quant_plain if quant \
        else flash_prefill_paged_plain
    got = plain(*args, **tkw)
    _assert_valid_close(got, want, PREFILL_LEN)
    wrapper = flash_prefill_paged_quant if quant else flash_prefill_paged
    assert torch.equal(wrapper(*args, **tkw), got)


@pytest.mark.parametrize("bs", [8, 16, 32, 128])
def test_paged_plain_equals_flat_plain_bitwise(bs):
    """The page gather is exact: the paged plain versions equal the flat
    ones on the un-paged cache, bitwise."""
    q, flat, pools, table = _case(3, 1, bs, False)
    qw = _case(4, W, bs, False)[0]
    t = torch.from_numpy(table)
    pos, lens = torch.tensor(PREFILL_POS), torch.tensor(PREFILL_LEN)
    assert torch.equal(
        flash_decode_paged_plain(*_t(q, *pools), table=t, pos=pos),
        flash_decode_plain(*_t(q, *flat), pos=pos))
    assert torch.equal(
        flash_prefill_paged_plain(*_t(qw, *pools), table=t, pos=pos,
                                  lengths=lens),
        flash_prefill_plain(*_t(qw, *flat), pos=pos, lengths=lens))


@pytest.mark.parametrize("lq,backend", [(1, "auto"), (1, "ref"),
                                        (W, "auto"), (W, "ref")])
def test_api_attention_paged_matches_jax(lq, backend):
    """The op surface with block_tables: the same route and values as the
    JAX package's (its paged Pallas kernels in interpret mode under the
    kernel backend); int8 pools on the ref route."""
    q, _, pools, table = _case(5, lq, 16, backend == "ref")
    pos = np.asarray(PREFILL_POS, np.int32)
    jbackend = "pallas" if backend == "auto" else "ref"
    if backend == "ref":
        jk, jks, jv, jvs = (jnp.asarray(p) for p in pools)
        scales = dict(k_scale=jks, v_scale=jvs)
        tk, tks, tv, tvs = _t(*pools)
        tscales = dict(k_scale=tks, v_scale=tvs)
    else:
        (jk, jv), (tk, tv) = (jnp.asarray(p) for p in pools), _t(*pools)
        scales = tscales = {}
    want = japi.ops.attention(jnp.asarray(q), jk, jv,
                              offset=jnp.asarray(pos),
                              block_tables=jnp.asarray(table),
                              backend=jbackend, interpret=True, **scales)
    got = api.ops.attention(torch.from_numpy(q), tk, tv,
                            offset=torch.from_numpy(pos),
                            block_tables=torch.from_numpy(table),
                            backend=backend, **tscales)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ============================================================ the update
def _update_case(seed, quant):
    """A (P, H, bs, X) pool (+ trash block for the port), a (2, 3) table
    reaching 24 positions, and an 8-token update per row: row 0 at 5 with
    6 valid tokens (2 pad), row 1 at 20 with all 8 valid (4 past the
    table's reach), row 2 at 0 sitting the launch out."""
    rng = np.random.RandomState(seed)
    p, h, bs, x = 10, 2, 8, 16
    table = np.asarray([[4, 1, 7], [2, 9, 0], [3, 5, 6]], np.int32)
    start = np.asarray([5, 20, 0], np.int32)
    lens = np.asarray([6, 8, 0], np.int32)
    new = rng.randn(3, h, 8, x).astype(np.float32)
    pool = rng.randn(p, h, bs, x).astype(np.float32)
    return pool, new, table, start, lens


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_update_matches_jax_and_drops(quant):
    pool, new, table, start, lens = _update_case(6, quant)
    if quant:
        codes, scale = (np.asarray(a) for a in jq8(jnp.asarray(new)))
        tcodes, tscale = _q8(torch.from_numpy(new))
        assert np.array_equal(tcodes.numpy(), codes)
        assert np.array_equal(tscale.numpy(), scale)
        pools = [(np.zeros(pool.shape, np.int8), codes, tcodes),
                 (np.ones(pool.shape[:3] + (1,), np.float32), scale, tscale)]
    else:
        pools = [(pool, new, torch.from_numpy(new))]
    for base, jnew, tnew in pools:
        want = np.asarray(jpaged_update(
            jnp.asarray(base), jnp.asarray(jnew), jnp.asarray(start),
            jnp.asarray(table), jnp.asarray(lens)))
        trash = np.full((1,) + base.shape[1:], 7, base.dtype)
        got = torch.from_numpy(np.concatenate([base, trash]))
        _paged_update(((got, tnew),), torch.from_numpy(start),
                      torch.from_numpy(table), torch.from_numpy(lens))
        assert np.array_equal(got[:-1].numpy(), want)
        # exactly the valid tokens moved: row 0 positions 5..10 (blocks 4,
        # 1), row 1 positions 20..23 (block 0, offsets 4..7); no pad token
        # and no position past the table reached a live block
        changed = np.argwhere((got[:-1].numpy() != base).any((1, 3)))
        want_at = {(4, o) for o in range(5, 8)} | {(1, o) for o in range(3)}
        want_at |= {(0, o) for o in range(4, 8)}
        assert {tuple(a) for a in changed} <= want_at
        assert not np.array_equal(got[-1].numpy(), trash[0])   # drops


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_decode_step_on_bridged_paged_caches_matches_jax(kv_quant):
    """A right-padded chunk then a decode step over a JAX paged cache
    bridged into the port: the logits agree, and the pools after the steps
    agree where the rows wrote (codes within one step of a rounding tie,
    as in tests/test_torch_model.py)."""
    jcfg = dataclasses.replace(jax_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    tcfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    b, l, max_len, bs = 3, 10, 32, 8
    jc = jinit_caches(jcfg, batch=b, max_len=max_len, paged=(12, bs))
    tc = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    assert isinstance(tc[0], PagedQuantKVCache if kv_quant else PagedKVCache)
    pool = tc[0].k_codes if kv_quant else tc[0].k
    assert pool.shape[0] == 12 + 1                   # and the trash block
    assert all(c.table is tc[0].table for c in tc)   # one shared table
    rng = np.random.RandomState(7)
    toks = rng.randint(1, jcfg.vocab, (b, l)).astype(np.int32)
    lens = np.asarray([l, 4, 0], np.int32)
    jl, jc = jdecode_step(jparams, jc, jnp.asarray(toks), jcfg,
                          lengths=jnp.asarray(lens))
    tl, tc = decode_step(model, tc, torch.from_numpy(toks),
                         lengths=torch.from_numpy(lens))
    for r in range(2):
        np.testing.assert_allclose(tl[r, :lens[r]].numpy(),
                                   np.asarray(jl)[r, :lens[r]],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    step = rng.randint(1, jcfg.vocab, (b, 1)).astype(np.int32)
    active = np.asarray([1, 1, 0], np.int32)
    jl, jc = jdecode_step(jparams, jc, jnp.asarray(step), jcfg,
                          lengths=jnp.asarray(active))
    tl, tc = decode_step(model, tc, torch.from_numpy(step),
                         lengths=torch.from_numpy(active))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    want = caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for got_c, want_c in zip(tc, want):
        assert torch.equal(got_c.pos, want_c.pos)
        assert torch.equal(got_c.table, want_c.table)
        for f in dataclasses.fields(got_c):
            if f.name in ("pos", "table"):
                continue
            # the pools without their trash blocks
            g = getattr(got_c, f.name)[:-1].float()
            w = getattr(want_c, f.name)[:-1].float()
            if f.name.endswith("codes"):
                assert (g - w).abs().max().item() <= 1
            else:
                torch.testing.assert_close(g, w, rtol=MODEL_TOL,
                                           atol=MODEL_TOL)


# ================================================================ engines
def _prefix_spec(vocab, n=5, head=18, seed=0):
    """Prompts sharing an 18-token head (more than one 16-token block) and
    distinct tails: registry hits and boundary-block forks."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, head).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(1, vocab, 2 + i % 4).astype(np.int32)
        out.append((np.concatenate([shared, tail]), 3 + i % 3))
    return out


def _drain(eng, spec, request_cls=Request):
    for rid, (p, m) in enumerate(spec):
        assert eng.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in eng.run_until_drained()}


def _engine(cfg, model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(cfg, model, **kw)


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def jax_paged(request):
    """One JAX paged-engine drain per KV layout (module-scoped), and the
    port's model holding the same weights."""
    jcfg = dataclasses.replace(jax_smoke("qwen2_1p5b"),
                               kv_quant=request.param)
    tcfg = dataclasses.replace(get_smoke("qwen2_1p5b"),
                               kv_quant=request.param)
    jparams = jinit_params(jax.random.key(0), jcfg)
    spec = _prefix_spec(jcfg.vocab)
    eng = JServingEngine(jcfg, jparams, slots=2, max_len=MAX_LEN,
                         prefill_chunk=8, paged=True, block_size=16)
    want = _drain(eng, spec, JRequest)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return tcfg, model, spec, want, eng.pool_stats()


def test_paged_engine_matches_jax_paged_engine(jax_paged):
    cfg, model, spec, want, jstats = jax_paged
    eng = _engine(cfg, model, paged=True, block_size=16)
    assert _drain(eng, spec) == want
    st = eng.pool_stats()
    assert st == {k: jstats[k] for k in st}
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0


@pytest.mark.parametrize("bs,chunk", [(16, 8), (8, 5)])
def test_paged_engine_equals_flat_engine(jax_paged, bs, chunk):
    """Inside the port the paged engine gives the per-slot engine's tokens,
    at any block size and chunk width, while sharing blocks."""
    cfg, model, spec, _, _ = jax_paged
    flat = _drain(_engine(cfg, model, prefill_chunk=chunk), spec)
    eng = _engine(cfg, model, paged=True, block_size=bs, prefill_chunk=chunk)
    assert _drain(eng, spec) == flat
    st = eng.pool_stats()
    assert st["prefix_hits"] > 0 and st["shared_tokens"] > 0
    assert st["cow_copies"] > 0


def _model(seed):
    cfg = get_smoke("qwen2_1p5b")
    return cfg, init_params(cfg, seed=seed, device="cpu")


def test_paged_engine_with_resident_weights_equals_flat():
    """`weight_format` combines with `paged=True`: int4-resident Linears
    over the block pool give the flat engine's tokens."""
    cfg, model = _model(5)
    spec = _prefix_spec(cfg.vocab, n=4, seed=5)
    flat = _engine(cfg, model, weight_format="int4")   # model stays dense
    want = _drain(flat, spec)
    eng = _engine(cfg, model, weight_format="int4", paged=True, block_size=8)
    assert eng.weight_route() == "resident-int4"
    assert _drain(eng, spec) == want
    assert eng.pool_stats()["prefix_hits"] > 0


def test_pool_exhaustion_evicts_registry_blocks():
    """When a reservation exceeds the free list, cold registry-held blocks
    are LRU-evicted to make room; the request still completes in full."""
    cfg, model = _model(2)
    rng = np.random.RandomState(2)
    a = rng.randint(1, cfg.vocab, 9).astype(np.int32)
    b = rng.randint(1, cfg.vocab, 10).astype(np.int32)
    eng = _engine(cfg, model, slots=1, max_len=32, paged=True, block_size=8,
                  pool_blocks=5)
    eng.submit(Request(0, a, max_new_tokens=4))     # 2 blocks, registered
    eng.run_until_drained()
    assert eng.pool_stats()["registry_entries"] == 1
    eng.submit(Request(1, b, max_new_tokens=16))    # needs 4 of 3 free
    done = {r.rid: r for r in eng.run_until_drained()}
    assert eng.pool_stats()["evictions"] >= 1
    assert done[1].status == "done" and len(done[1].out_tokens) == 16


def test_eviction_skips_pinned_prefix():
    """A registry entry whose blocks a resident row still shares frees
    nothing: eviction skips it (and counts the skip) instead of dropping
    the sharing, the admission defers, and once the sharer is done a
    colder unpinned entry is evicted. Tokens as the per-slot engine's."""
    cfg, model = _model(9)
    rng = np.random.RandomState(9)
    head = rng.randint(1, cfg.vocab, 16).astype(np.int32)
    spec = [(head, 1),                                 # registers 2 blocks
            (np.concatenate([head, rng.randint(1, cfg.vocab, 1)])
             .astype(np.int32), 12),                   # shares both
            (rng.randint(1, cfg.vocab, 20).astype(np.int32), 12)]
    want = _drain(_engine(cfg, model, max_len=32), spec)
    eng = _engine(cfg, model, slots=2, max_len=32, paged=True, block_size=8,
                  pool_blocks=6)
    eng.submit(Request(0, spec[0][0], max_new_tokens=spec[0][1]))
    eng.run_until_drained()
    eng.submit(Request(1, spec[1][0], max_new_tokens=spec[1][1]))
    eng.step()         # rid 1 shares blocks 0, 1 and takes 2 fresh ones
    assert eng.pool_stats()["prefix_hits"] == 1
    # rid 2 needs 4 blocks of the 2 free; both registry entries are pinned
    eng.submit(Request(2, spec[2][0], max_new_tokens=spec[2][1]))
    eng.step()
    st = eng.pool_stats()
    assert st["deferred_admissions"] == 1 and st["eviction_skips"] == 2
    assert st["evictions"] == 0 and eng.occupancy()[1] is None
    got = {r.rid: list(r.out_tokens) for r in eng.run_until_drained()}
    assert got == want
    assert eng.pool_stats()["evictions"] >= 1


def test_pool_pressure_defers_then_rejects():
    """A reservation that cannot be met defers at the queue head (FIFO
    kept) and the backpressure surfaces through the bounded queue's
    REJECTED path; the deferred request completes once blocks free up."""
    cfg, model = _model(3)
    rng = np.random.RandomState(3)

    def mk(n):
        return rng.randint(1, cfg.vocab, n).astype(np.int32)

    # pool = exactly one row's worth: the second admission must wait
    eng = _engine(cfg, model, slots=2, max_len=32, paged=True, block_size=8,
                  pool_blocks=4, max_queue=2)
    assert eng.submit(Request(0, mk(9), max_new_tokens=20))   # 4 blocks
    assert eng.submit(Request(1, mk(9), max_new_tokens=4))    # queued
    eng.step()    # admits rid 0; rid 1's reservation defers at the head
    extra = [Request(2 + i, mk(5), max_new_tokens=2) for i in range(3)]
    assert [eng.submit(r) for r in extra] == [True, False, False]
    assert all(r.status == "REJECTED" for r in extra[1:])
    done = {r.rid: r for r in eng.run_until_drained()}
    assert eng.pool_stats()["deferred_admissions"] >= 1
    assert done[0].status == "done" and done[1].status == "done"
    assert len(done[1].out_tokens) == 4


def test_cow_fork_isolates_sharers():
    """Rows admitted off one registered prefix fork the partly covered
    boundary block before writing: no sharer's tail bleeds into the
    donor's blocks or another's output (slots=1 runs the sharers through
    the same pool blocks one after another)."""
    cfg, model = _model(4)
    spec = _prefix_spec(cfg.vocab, n=4, seed=4)
    want = _drain(_engine(cfg, model), spec)
    eng = _engine(cfg, model, slots=1, paged=True, block_size=16)
    assert _drain(eng, spec) == want
    st = eng.pool_stats()
    assert st["cow_copies"] >= 1 and st["prefix_hits"] >= 1


def test_pool_stats_accounting():
    """Occupancy counts live and registry-held blocks and frees on release;
    a per-slot engine reports paged=False."""
    cfg, model = _model(8)
    rng = np.random.RandomState(8)
    eng = _engine(cfg, model, slots=2, max_len=32, paged=True, block_size=8,
                  pool_blocks=8)
    assert eng.pool_stats()["used_blocks"] == 0
    eng.submit(Request(0, rng.randint(1, cfg.vocab, 9).astype(np.int32),
                       max_new_tokens=4))
    eng.step()
    mid = eng.pool_stats()
    assert mid["used_blocks"] == 2 and 0 < mid["occupancy"] <= 1
    eng.run_until_drained()
    end = eng.pool_stats()
    # the finished row's non-prompt block is free again; the prompt's
    # blocks stay pinned by the prefix registry until evicted
    assert end["used_blocks"] == 2 and end["registry_entries"] == 1
    assert _engine(cfg, model).pool_stats() == {"paged": False}


def test_paged_engine_validation_and_layout():
    cfg, model = _model(0)
    with pytest.raises(ValueError, match="divide max_len"):
        _engine(cfg, model, paged=True, block_size=12)
    with pytest.raises(ValueError, match="cannot hold even one full row"):
        _engine(cfg, model, paged=True, block_size=8, pool_blocks=7)
    eng = _engine(cfg, model, paged=True, block_size=8, pool_blocks=9)
    # every layer: 9 pool blocks + the trash block, one shared table
    assert all(c.k.shape[0] == 10 for c in eng.caches)
    assert all(c.table is eng.caches[0].table for c in eng.caches)
    caches = init_caches(cfg, 2, 20, device="cpu", paged=(6, 8))
    assert caches[0].table.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert (eng.decode_route(), eng.prefill_route()) == \
        ("cuda-decode", "cuda-prefill")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_paged_caches_share_one_table_and_trash_block(kv_quant):
    """init_caches and the bridge give every layer the same table tensor;
    set_block_tables writes it once and refuses layers that do not share
    it; every pool has one trash block past P, zero (scales one)."""
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    caches = init_caches(cfg, 2, 16, device="cpu", paged=(6, 8))
    new = torch.tensor([[5, 4], [3, 2]], dtype=torch.int32)
    set_block_tables(caches, new)
    assert all(torch.equal(c.table, new) for c in caches)
    for f in dataclasses.fields(caches[0]):
        if f.name in ("table", "pos"):
            continue
        pool = getattr(caches[0], f.name)
        assert pool.shape[0] == 6 + 1
        fill = 1 if f.name.endswith("_scale") else 0
        assert bool((pool[-1] == fill).all())
    caches[1] = dataclasses.replace(caches[1], table=new.clone())
    with pytest.raises(ValueError, match="share one table"):
        set_block_tables(caches, new)


def test_bridge_refuses_unequal_jax_tables():
    jcfg = jax_smoke("qwen2_1p5b")
    jc = jax.tree.map(np.asarray,
                      jinit_caches(jcfg, batch=2, max_len=16, paged=(6, 8)))
    seg = jc[0]["0_dense"]
    table = seg.table.copy()
    table[1] = table[1][:, ::-1]
    bad = [{"0_dense": seg._replace(table=table)}]
    with pytest.raises(ValueError, match="tables differ"):
        caches_from_jax(bad, get_smoke("qwen2_1p5b"), device="cpu")


def test_paged_wrappers_count_no_launch_on_cpu():
    cfg, model = _model(1)
    before = [k.launches for k in PAGED_KERNELS]
    _drain(_engine(cfg, model, paged=True, block_size=8),
           _prefix_spec(cfg.vocab, n=2, seed=1))
    assert [k.launches for k in PAGED_KERNELS] == before


def test_serve_launcher_paged_on_cpu(capsys):
    done = serve.main(["--smoke", "--device", "cpu", "--paged",
                       "--block-size", "8", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert "pool: 64 blocks (block_size=8)" in out
    assert "deferred=0" in out
