"""The port's preemption contract, case for case `tests/test_preemption.py`,
plus the paged snapshot and shared-block quarantine cases of
`tests/test_paged_kv.py`: when the block pool cannot hold a higher-priority
admission, the engine preempts strictly lower-priority rows — private
blocks spill to the HostBlockStore, registry-shared blocks stay resident
with the swap entry holding the row's reference — and the preempted request
resumes from its saved frontier with nothing recomputed, so its greedy
output equals an uncontended run's. On the CPU (the paged kernels' plain
versions). Plus a parity test: the port's engine under the same contended
priority mix gives the JAX engine's tokens, statuses, counters and
pool_stats(), swap bytes included."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import init_caches, init_params
from repro_torch.models.transformer import (gather_pool_blocks,
                                            write_pool_blocks)
from repro_torch.serving import (FaultPlan, HostBlockStore, Request,
                                 ServingEngine, drive_with_plan)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

MAX_LEN = 64
NAN = float("nan")


def _model(arch="qwen2_1p5b", seed=0, kv_quant=False):
    cfg = get_smoke(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg, init_params(cfg, seed=seed, device="cpu")


def _engine(cfg, model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("paged", True)
    kw.setdefault("block_size", 16)
    return ServingEngine(cfg, model, **kw)


def _contended_spec(vocab, n=6, seed=0, max_new=12):
    """Prompts of 18-30 tokens (2 blocks each at bs=16) whose full budget is
    3 blocks: two cannot coexist in a 4-block pool, so alternating
    priorities force preempt/swap/resume cycles as slots turn over."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, rng.randint(18, 30)).astype(np.int32),
             max_new) for _ in range(n)]


def _drain(eng, spec, prios=None, request_cls=Request):
    for rid, (p, m) in enumerate(spec):
        prio = prios[rid] if prios else 0
        assert eng.submit(request_cls(rid, p, max_new_tokens=m,
                                      priority=prio))
    return {r.rid: tuple(r.out_tokens or ()) for r in
            eng.run_until_drained(max_steps=4000)}


def _prefix_spec(vocab, n=5, head=18, seed=0):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, head).astype(np.int32)
    return [(np.concatenate([shared, rng.randint(1, vocab, 2 + i % 4)
                             .astype(np.int32)]), 3 + i % 3)
            for i in range(n)]


# =================================== preempt -> swap -> resume byte-identity
@pytest.mark.parametrize("arch,kv_quant", [("llama2_7b", False),
                                           ("qwen2_1p5b", False),
                                           ("qwen2_1p5b", True)],
                         ids=["dense", "gqa", "int8-kv"])
def test_preempted_rows_resume_byte_identical(arch, kv_quant):
    """A 4-block pool with alternating priorities forces real preemptions;
    every output, preempted or not, equals the uncontended 12-block run's
    bitwise, across dense / GQA / int8-KV paged layouts."""
    cfg, model = _model(arch, kv_quant=kv_quant)
    spec = _contended_spec(cfg.vocab)
    prios = [0, 1, 0, 1, 0, 1]
    want = _drain(_engine(cfg, model, pool_blocks=12), spec, prios)
    eng = _engine(cfg, model, pool_blocks=4)
    got = _drain(eng, spec, prios)
    assert got == want
    st = eng.pool_stats()
    assert st["preemptions"] >= 1 and st["swap_outs"] >= 1
    assert st["swap_ins"] >= 1
    assert st["swap_bytes_out"] > 0
    assert st["swap_bytes_in"] == st["swap_bytes_out"]
    assert st["host_blocks"] == 0 and st["host_bytes"] == 0
    assert all(len(t) == 12 for t in got.values())


def test_preempted_rows_equal_the_flat_engine():
    """Preempted and resumed rows of a paged engine give the per-slot
    (flat) engine's tokens, with a shared prompt head: the resume lands
    rows in other slots beside other neighbours."""
    cfg, model = _model(seed=16)
    rng = np.random.RandomState(16)
    head = rng.randint(1, cfg.vocab, 17).astype(np.int32)
    spec = [(np.concatenate([head, rng.randint(1, cfg.vocab, n)])
             .astype(np.int32), 12) for n in (3, 9, 5, 11, 2, 7)]
    prios = [0, 1, 0, 1, 0, 1]
    flat = _drain(_engine(cfg, model, paged=False), spec, prios)
    eng = _engine(cfg, model, pool_blocks=5)
    assert _drain(eng, spec, prios) == flat
    st = eng.pool_stats()
    assert st["preemptions"] >= 1 and st["prefix_hits"] >= 1


def test_equal_priority_never_preempts():
    """With uniform priorities the contended pool serializes through
    DEFERRAL only: equal never preempts equal."""
    cfg, model = _model()
    spec = _contended_spec(cfg.vocab)
    want = _drain(_engine(cfg, model, pool_blocks=12), spec)
    eng = _engine(cfg, model, pool_blocks=4)
    assert _drain(eng, spec) == want
    st = eng.pool_stats()
    assert st["preemptions"] == 0 and st["swap_outs"] == 0
    assert st["deferred_admissions"] >= 1


def test_watermark_keeps_headroom_by_preempting():
    """Below 1.0 the watermark reclaims before the pool is exhausted: an
    admission that would leave less than the headroom free preempts a
    lower-priority row although its own reservation fits; at 1.0 nothing
    is preempted. The outputs equal the uncontended run's either way."""
    cfg, model = _model(seed=17)
    spec = _contended_spec(cfg.vocab, n=2, seed=17, max_new=20)
    want = _drain(_engine(cfg, model, pool_blocks=12), spec, [0, 1])
    for watermark, preemptions in ((1.0, 0), (0.5, 1)):
        eng = _engine(cfg, model, pool_blocks=8, swap_watermark=watermark)
        for rid, (p, m) in enumerate(spec):
            eng.submit(Request(rid, p, max_new_tokens=m, priority=rid))
            eng.step()   # rid 1 fits the free blocks, not the headroom
        st = eng.pool_stats()
        assert st["preemptions"] == preemptions
        assert st["watermark_blocks"] == int(8 * watermark)
        got = {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}
        assert got == want
    with pytest.raises(ValueError, match="swap_watermark"):
        _engine(cfg, model, swap_watermark=0.0)


# ==================================== prefix sharing: kept blocks stay home
def test_preempting_prefix_sharer_keeps_registry_blocks_resident():
    """Preempt a row whose prefix blocks it shares with the registry and a
    live sibling: only its PRIVATE blocks spill to the host; the shared
    block stays resident with the swap entry holding the reference, and
    the pinned registry entry is SKIPPED by eviction. Resume is still
    byte-identical."""
    cfg, model = _model(seed=11)
    rng = np.random.RandomState(11)
    prompt = rng.randint(1, cfg.vocab, 22).astype(np.int32)   # blocks 0..1
    big = rng.randint(1, cfg.vocab, 30).astype(np.int32)
    spec = [(prompt, 10), (prompt, 20), (big, 32)]
    want = _drain(_engine(cfg, model, slots=3, pool_blocks=16), spec,
                  prios=[0, 0, 1])
    eng = _engine(cfg, model, slots=3, pool_blocks=6)
    eng.submit(Request(0, spec[0][0], max_new_tokens=spec[0][1], priority=0))
    while not eng.stats.generated_tokens:    # rid 0 prefills + registers
        eng.step()
    eng.submit(Request(1, spec[1][0], max_new_tokens=spec[1][1], priority=0))
    eng.step()
    assert eng.pool_stats()["prefix_hits"] >= 1
    reg_blocks = {b for ent in eng._pg_registry.values()
                  for b in ent["blocks"]}
    eng.submit(Request(2, spec[2][0], max_new_tokens=spec[2][1], priority=1))
    eng.step()
    st = eng.pool_stats()
    assert st["preemptions"] == 1 and st["eviction_skips"] >= 1
    assert st["evictions"] == 0 and st["registry_entries"] >= 1
    entry = eng._swap_entries[1]
    assert entry["kept"], "the shared prefix block must stay resident"
    assert all(b in reg_blocks for _, b in entry["kept"])
    assert len(entry["hids"]) == entry["total"] - len(entry["kept"])
    assert st["host_blocks"] == len(entry["hids"]) >= 1
    assert any(r is not None and r.rid == 0 for r in eng._slot_req)
    got = {r.rid: tuple(r.out_tokens or ()) for r in
           eng.run_until_drained(max_steps=4000)}
    assert got == want


# ======================================= preempt in the middle of a prefill
def test_preempt_during_chunked_prefill_resumes_mid_prompt():
    """A row preempted while still admitting (chunk 1 of 3 done) saves its
    prefill frontier, spills every private block, and resumes the
    REMAINING chunks after swap-in, byte-identically."""
    cfg, model = _model(seed=12)
    rng = np.random.RandomState(12)
    spec = [(rng.randint(1, cfg.vocab, 24).astype(np.int32), 8),
            (rng.randint(1, cfg.vocab, 24).astype(np.int32), 8)]
    kw = dict(max_len=32, block_size=8)      # 4-block rows
    want = _drain(_engine(cfg, model, pool_blocks=10, **kw), spec,
                  prios=[0, 1])
    eng = _engine(cfg, model, pool_blocks=5, **kw)
    eng.submit(Request(0, spec[0][0], max_new_tokens=8, priority=0))
    eng.step()                               # admit + first 8-token chunk
    assert eng._prefilling[0] and eng._prefill_off[0] == 8
    eng.submit(Request(1, spec[1][0], max_new_tokens=8, priority=1))
    eng.step()                               # rid 1's reservation preempts
    (req0,) = eng._preempted
    assert req0.rid == 0 and req0.status == "PREEMPTED"
    entry = eng._swap_entries[0]
    assert entry["prefilling"] and entry["prefill_off"] == 8
    assert entry["pos"] == 8
    assert not entry["kept"] and len(entry["hids"]) == entry["total"]
    got = {r.rid: tuple(r.out_tokens or ()) for r in
           eng.run_until_drained(max_steps=4000)}
    assert got == want
    assert eng.pool_stats()["swap_ins"] >= 1


# ======================================================= pool_pressure fault
def test_pool_pressure_fault_squeezes_then_releases():
    """At its step the fault holds the free list down to `blocks` for
    `duration` steps: admissions defer against the squeeze, the hold
    releases on schedule, and every request equals the unfaulted run."""
    cfg, model = _model(seed=13)
    spec = _contended_spec(cfg.vocab, n=4, seed=13, max_new=4)
    want = _drain(_engine(cfg, model, pool_blocks=8), spec)
    eng = _engine(cfg, model, pool_blocks=8)
    plan = FaultPlan.single("pool_pressure", step=2, blocks=0, duration=12)
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    finished, rejections = drive_with_plan(eng, plan)
    assert not rejections
    assert {r.rid: tuple(r.out_tokens or ()) for r in finished} == want
    assert plan.faults[0].tripped
    st = eng.pool_stats()
    assert st["evictions"] + st["deferred_admissions"] >= 1
    for _ in range(plan.faults[0].duration + 1):
        if not eng.pool_stats()["pressure_held"]:
            break
        eng.step()
    assert eng.pool_stats()["pressure_held"] == 0


def test_pool_pressure_fault_in_seeded_plans():
    plans = [FaultPlan.seeded(7, steps=20, slots=2,
                              kinds=("pool_pressure",)) for _ in range(2)]
    assert [f.describe() for f in plans[0].faults] == \
        [f.describe() for f in plans[1].faults]
    for f in plans[0].faults:
        assert f.kind == "pool_pressure"
        assert 0 <= f.blocks <= 2 and 2 <= f.duration <= 7


# ======================================== eviction skips pinned registry
def test_evict_skips_fully_pinned_registry_entry():
    """An entry whose blocks are ALL held by in-flight sharers is SKIPPED
    by eviction (and counted); with no other reclaim the admission defers
    instead."""
    cfg, model = _model(seed=14)
    rng = np.random.RandomState(14)
    prompt = rng.randint(1, cfg.vocab, 8).astype(np.int32)   # one block
    eng = _engine(cfg, model, slots=2, max_len=32, block_size=8,
                  pool_blocks=5)
    eng.submit(Request(0, prompt, max_new_tokens=4))
    eng.run_until_drained()
    assert eng.pool_stats()["registry_entries"] == 1
    longer = np.concatenate([prompt,
                             rng.randint(1, cfg.vocab, 4).astype(np.int32)])
    eng.submit(Request(1, longer, max_new_tokens=20))   # live sharer
    eng.step()
    assert eng.pool_stats()["prefix_hits"] >= 1
    eng.submit(Request(2, rng.randint(1, cfg.vocab, 17).astype(np.int32),
                       max_new_tokens=8))
    eng.step()
    st = eng.pool_stats()
    assert st["eviction_skips"] >= 1
    assert st["evictions"] == 0 and st["registry_entries"] >= 1
    done = {r.rid: r for r in eng.run_until_drained(max_steps=4000)}
    assert done[2].status == "done" and len(done[2].out_tokens) == 8


# ============================================== snapshot/restore mid-preempt
def test_snapshot_restore_with_preempted_rows(tmp_path):
    """Snapshot while a request sits PREEMPTED (its KV split between the
    pool and the host store), restore into a FRESH engine: the host store
    round-trips through the checkpoint and the row still resumes
    byte-identically."""
    cfg, model = _model(seed=15)
    spec = _contended_spec(cfg.vocab, seed=15)
    prios = [0, 1, 0, 1, 0, 1]
    want = _drain(_engine(cfg, model, pool_blocks=12), spec, prios)
    a = _engine(cfg, model, pool_blocks=4)
    for rid, (p, m) in enumerate(spec):
        a.submit(Request(rid, p, max_new_tokens=m, priority=prios[rid]))
    for _ in range(4000):
        a.step()
        if a._preempted and a._swap_store.nbytes() > 0:
            break
    assert a._preempted, "the scenario must catch a request preempted"
    a.snapshot(tmp_path)
    want_rest = {r.rid: tuple(r.out_tokens or ()) for r in
                 a.run_until_drained(max_steps=4000)}
    assert want_rest == want
    b = _engine(cfg, model, pool_blocks=4)
    b.restore(tmp_path)
    assert b._preempted and b._swap_store.nbytes() > 0
    got = {r.rid: tuple(r.out_tokens or ()) for r in
           b.run_until_drained(max_steps=4000)}
    for rid, toks in got.items():
        assert toks == want[rid]


def test_swap_store_rejects_layout_mismatch():
    """A snapshot's host-stored block must match the restoring engine's
    own block layout: another geometry is refused, never reinterpreted.
    bf16 blocks round-trip as their 16-bit patterns."""
    store = HostBlockStore()
    slabs = {"k": torch.randn(2, 1, 4, 16, 8).to(torch.bfloat16),
             "v": torch.randn(2, 1, 4, 16, 8).to(torch.bfloat16)}
    store.put(slabs, 1)
    assert store.nbytes() == 2 * 2 * 4 * 16 * 8 * 2
    state = store.state_dict()
    good = {"k": ((2, 1, 4, 16, 8), "bfloat16"),
            "v": ((2, 1, 4, 16, 8), "bfloat16")}
    other = HostBlockStore()
    other.load_state(state, good)
    assert len(other) == 1
    back = other.get([0])
    assert all(torch.equal(back[n].view(torch.int16),
                           slabs[n].view(torch.int16)) for n in slabs)
    bad = {n: ((2, 1, 4, 8, 8), "bfloat16") for n in good}   # block size
    with pytest.raises(ValueError, match="layout"):
        HostBlockStore().load_state(state, bad)


# ============================================ pool block gather / write
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_gather_write_round_trip_and_sentinel(kv_quant):
    """gather_pool_blocks -> write_pool_blocks moves blocks bitwise (codes
    and scales for int8), and destinations equal to the pool size land in
    the trash block only."""
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    caches = init_caches(cfg, 2, 32, device="cpu", paged=(6, 8))
    gen = torch.Generator().manual_seed(0)
    for c in caches:
        for f in dataclasses.fields(c):
            if f.name in ("table", "pos"):
                continue
            t = getattr(c, f.name)
            t.copy_(torch.randn(t.shape, generator=gen).mul(9).to(t.dtype))
    before = [{f.name: getattr(c, f.name).clone()
               for f in dataclasses.fields(c)} for c in caches]
    vals = gather_pool_blocks(caches, [4, 1])
    assert all(v.shape[:2] == (cfg.n_layers, 2) for v in vals.values())
    # blocks 4, 1, 4 to 2, the sentinel 6 (= P) and 0
    write_pool_blocks(caches, {n: torch.cat([v, v[:, :1]], 1)
                               for n, v in vals.items()}, [2, 6, 0])
    for c, old in zip(caches, before):
        for name in (("k_codes", "k_scale", "v_codes", "v_scale")
                     if kv_quant else ("k", "v")):
            new = getattr(c, name)
            assert torch.equal(new[2], old[name][4])
            assert torch.equal(new[0], old[name][4])
            for b in (1, 3, 4, 5):
                assert torch.equal(new[b], old[name][b])
            assert torch.equal(new[6], old[name][1])      # the trash block


# ================================== shared-block poison -> quarantine
def test_poisoned_shared_block_quarantines_all_sharers():
    """KV poison lands in the victim's FIRST mapped block, which is
    prefix-shared here: transitive quarantine scrubs and replays EVERY
    sharer, and the outputs equal the unfaulted run's."""
    cfg, model = _model(seed=5)
    rng = np.random.RandomState(5)
    shared = rng.randint(1, cfg.vocab, 18).astype(np.int32)
    spec = [(np.concatenate([shared, rng.randint(1, cfg.vocab, 3 + i)
                             .astype(np.int32)]), 6) for i in range(2)]
    want = {k: list(v) for k, v in _drain(_engine(cfg, model),
                                         spec).items()}
    eng = _engine(cfg, model)
    eng.submit(Request(0, spec[0][0], max_new_tokens=spec[0][1]))
    while not eng.stats.generated_tokens:
        eng.step()
    eng.submit(Request(1, spec[1][0], max_new_tokens=spec[1][1]))
    eng.step()
    assert eng.pool_stats()["prefix_hits"] >= 1
    eng.arm_fault_plan(FaultPlan.single("poison", step=eng.step_no, slot=1,
                                        target="kv", value=NAN))
    got = {r.rid: r.out_tokens for r in eng.run_until_drained()}
    assert got == want
    assert eng.stats.quarantines >= 2     # BOTH sharers
    assert eng.pool_stats()["registry_entries"] >= 1   # re-registered


# ======================================================= paged snapshots
def test_paged_snapshot_restore_midstream(tmp_path):
    cfg, model = _model(seed=6)
    spec = _prefix_spec(cfg.vocab, n=4, seed=6)
    a = _engine(cfg, model)
    for rid, (p, m) in enumerate(spec):
        a.submit(Request(rid, p, max_new_tokens=m))
    for _ in range(3):
        a.step()
    a.snapshot(tmp_path)
    want = {r.rid: r.out_tokens for r in a.run_until_drained()}
    b = _engine(cfg, model)
    b.restore(tmp_path)
    got = {r.rid: r.out_tokens for r in b.run_until_drained()}
    for rid in want:
        assert got.get(rid, want[rid]) == want[rid]
    assert b.pool_stats()["block_size"] == 16


def test_paged_snapshot_layout_mismatch_raises(tmp_path):
    cfg, model = _model(seed=7)
    rng = np.random.RandomState(7)
    eng = _engine(cfg, model)
    eng.submit(Request(0, rng.randint(1, cfg.vocab, 5).astype(np.int32),
                       max_new_tokens=2))
    eng.step()
    eng.snapshot(tmp_path)
    with pytest.raises(ValueError):
        _engine(cfg, model, paged=False).restore(tmp_path)
    with pytest.raises(ValueError):
        _engine(cfg, model, pool_blocks=5).restore(tmp_path)


# ================================================= parity with the JAX engine
@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def jax_contended(request):
    """One JAX paged-engine drain of the contended priority mix per KV
    layout (module-scoped), and the port's model holding the same
    weights."""
    jcfg = dataclasses.replace(jax_smoke("qwen2_1p5b"),
                               kv_quant=request.param)
    tcfg = dataclasses.replace(get_smoke("qwen2_1p5b"),
                               kv_quant=request.param)
    jparams = jinit_params(jax.random.key(0), jcfg)
    spec = _contended_spec(jcfg.vocab)
    prios = [0, 1, 0, 1, 0, 1]
    eng = JServingEngine(jcfg, jparams, slots=2, max_len=MAX_LEN,
                         prefill_chunk=8, paged=True, block_size=16,
                         pool_blocks=4)
    want = _drain(eng, spec, prios, JRequest)
    statuses = {r.rid: r.status for r in eng.finished}
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return (tcfg, model, spec, prios, want, statuses,
            dataclasses.asdict(eng.stats), eng.pool_stats())


def test_contended_mix_matches_jax_engine(jax_contended):
    cfg, model, spec, prios, want, statuses, jstats, jpool = jax_contended
    eng = _engine(cfg, model, pool_blocks=4)
    assert _drain(eng, spec, prios) == want
    assert {r.rid: r.status for r in eng.finished} == statuses
    stats = dataclasses.asdict(eng.stats)
    assert stats == {k: jstats[k] for k in stats}
    assert eng.pool_stats() == jpool
    assert jpool["preemptions"] >= 1 and jpool["swap_bytes_out"] > 0
