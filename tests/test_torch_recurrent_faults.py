"""The robustness layer on the recurrent and hybrid families (zamba2,
xlstm SMOKE configs, on the CPU), and what the port refuses for them:

* a NaN logits poison and a recurrent-state poison quarantine, scrub and
  replay to the unfaulted tokens;
* a launch fault at the dispatch boundary demotes to the reference route
  and gives the ref engine's tokens. On zamba2 it fires at the shared
  block's attention, after the first Mamba2 layers stepped their states:
  the retry must not apply the token twice;
* snapshot/restore mid-prefill and mid-decode gives byte-identical
  tokens, and a snapshot of another cache layout is refused, naming the
  cache kinds;
* `reset_slots` / `scrub_slots` put a recurrent row back at its initial
  state (the sLSTM stabilizer at -1e30);
* `ServingEngine(paged=True)` raises ValueError for a model with recurrent
  blocks, beside the reason: the reference's paged engine gives other
  tokens than its flat engine once a prefix hits (ROADMAP C);
* the paged engine's swap-out and swap-store layout read the first KV
  cache, not layer 0's (a recurrent state on zamba2)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.api import ExecutionPolicy
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import init_caches, init_params
from repro_torch.models.ssm import SLSTM_M_INIT, MambaCache
from repro_torch.models.transformer import (kv_caches, reset_slots,
                                            scrub_slots, set_block_tables)
from repro_torch.serving import FaultPlan, Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

ARCHS = ["zamba2_2p7b", "xlstm_1p3b"]
GEO = dict(slots=2, max_len=64)
NAN = float("nan")


@pytest.fixture(scope="module")
def models():
    return {arch: init_params(get_smoke(arch), seed=1, device="cpu")
            for arch in ARCHS}


def _spec(vocab, lens, outs, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, n).astype(np.int32), m)
            for n, m in zip(lens, outs)]


def _run(eng, spec, plan=None):
    eng.arm_fault_plan(plan)
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in eng.run_until_drained()}


def _setup(models, arch, **kw):
    cfg = get_smoke(arch)
    spec = _spec(cfg.vocab, [4, 9, 6], [6, 4, 5], seed=3)
    want = _run(ServingEngine(cfg, models[arch], **GEO, **kw), spec)
    return cfg, spec, want


# =================================================== poison -> quarantine
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("target", ["logits", "kv"])
def test_poison_quarantines_scrubs_and_replays(models, arch, target):
    """A NaN in a row's logits, or in every field of its recurrent states
    (and its K at position 0), trips the health flag at the row's next
    read launch: the row is quarantined, its states scrubbed, and the
    replay gives the unfaulted tokens; the other rows never notice."""
    cfg, spec, want = _setup(models, arch)
    plan = FaultPlan.single("poison", step=5, slot=0, target=target,
                            value=NAN)
    eng = ServingEngine(cfg, models[arch], **GEO)
    assert _run(eng, spec, plan) == want
    assert eng.stats.quarantines == 1 and eng.stats.demotions == 0
    assert plan.faults[0].tripped
    assert all(r.status == "done" for r in eng.finished)


# ================================================= launch fault -> demotion
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("boundary", ["launch", "dispatch"])
def test_launch_fault_demotes_to_the_ref_route(models, arch, boundary):
    """A launch fault at step 3 (rows mid-prefill) demotes the engine and
    the same step retries down the reference route: the tokens equal a
    ref engine's. At the dispatch boundary zamba2's fault fires at the
    first registry op of the launch, the shared block's attention, after
    its first Mamba2 layers stepped (xlstm dispatches no op: the launch
    runs through, nothing to demote)."""
    cfg, spec, want = _setup(models, arch,
                             policy=ExecutionPolicy(backend="ref"))
    plan = FaultPlan.single("launch", step=3, boundary=boundary)
    eng = ServingEngine(cfg, models[arch], **GEO)
    if boundary == "dispatch" and arch == "xlstm_1p3b":
        assert _run(eng, spec, plan) == want
        assert eng.stats.demotions == 0 and not plan.faults[0].tripped
        return
    with pytest.warns(RuntimeWarning, match="demoted"):
        got = _run(eng, spec, plan)
    assert got == want
    assert eng.stats.demotions == 1 and plan.faults[0].tripped
    assert eng.degraded_routes()[0]["to"] == {"decode": "ref",
                                              "prefill": "ref"}


# ==================================================== snapshot / restore
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("at", [3, 11], ids=["mid-prefill", "mid-decode"])
def test_snapshot_restore_byte_identical(models, arch, at, tmp_path):
    """A snapshot at step 3 (every row mid-prefill) or 11 (rows
    mid-decode, one mid-prefill) restored into a fresh engine finishes
    with the tokens the original engine gives."""
    cfg = get_smoke(arch)
    spec = _spec(cfg.vocab, [4, 9, 6], [6, 4, 5], seed=3)
    a = ServingEngine(cfg, models[arch], **GEO)
    for rid, (p, m) in enumerate(spec):
        a.submit(Request(rid, p, max_new_tokens=m))
    for _ in range(at):
        a.step()
    assert a._prefilling.any()
    pre = {r.rid for r in a.finished}
    a.snapshot(tmp_path)
    b = ServingEngine(cfg, models[arch], **GEO)
    assert b.restore(tmp_path) == at
    for cb, ca in zip(b.caches, a.caches):
        for f in dataclasses.fields(ca):
            assert torch.equal(getattr(cb, f.name), getattr(ca, f.name))
    got_b = {r.rid: r.out_tokens for r in b.run_until_drained()}
    a.run_until_drained()
    assert got_b == {r.rid: r.out_tokens for r in a.finished
                     if r.rid not in pre}


def test_restore_names_the_cache_kinds(models, tmp_path):
    """A snapshot of another cache layout is refused, naming both."""
    ServingEngine(get_smoke("xlstm_1p3b"), models["xlstm_1p3b"],
                  **GEO).snapshot(tmp_path)
    eng = ServingEngine(get_smoke("zamba2_2p7b"), models["zamba2_2p7b"],
                        **GEO)
    with pytest.raises(ValueError, match="MambaCache"):
        eng.restore(tmp_path)
    assert eng.step_no == 0 and not eng.pending()


# ==================================================== reset / scrub rows
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn", [reset_slots, scrub_slots])
def test_reset_and_scrub_put_recurrent_rows_back(arch, fn):
    """The row under the mask gets a fresh row's values (zeros, the sLSTM
    stabilizer SLSTM_M_INIT), each recurrent field rebound to a new tensor;
    the other rows keep theirs. A KV cache's row rewinds its position
    (`reset_slots`) or also loses its values (`scrub_slots`)."""
    cfg = get_smoke(arch)
    caches = init_caches(cfg, 3, 16, device="cpu")
    fresh = init_caches(cfg, 3, 16, device="cpu")
    for c in caches:
        for f in dataclasses.fields(c):
            setattr(c, f.name, torch.full_like(getattr(c, f.name), 3))
    before = [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
              for c in caches]
    fn(caches, torch.tensor([False, True, False]))
    for c, old, new in zip(caches, before, fresh):
        for name, t in old.items():
            got = getattr(c, name)
            assert torch.equal(got[[0, 2]], t[[0, 2]]), name
            if fn is reset_slots and name in ("k", "v"):
                assert torch.equal(got, t)
            else:
                assert torch.equal(got[1], getattr(new, name)[1]), name
            if not hasattr(c, "pos"):
                assert got is not t
    if arch == "xlstm_1p3b":
        assert all(c.m[1].eq(SLSTM_M_INIT).all() for c in caches
                   if hasattr(c, "m"))


# ===================================================== paged: refused
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refused_for_recurrent_models(models, arch):
    with pytest.raises(ValueError, match="ROADMAP C"):
        ServingEngine(get_smoke(arch), models[arch], paged=True,
                      block_size=8, **GEO)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_paged_engine_changes_tokens_on_a_prefix_hit(arch):
    """Why the port refuses: on three prompts sharing a 20-token head, the
    reference's paged engine starts the prefix-hit row at its shared-token
    count, so those tokens never pass through its recurrent states (xlstm
    has no KV cache at all): its tokens differ from the flat engine's,
    which the port's flat engine equals."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    rng = np.random.RandomState(5)
    head = rng.randint(1, cfg.vocab, 20)
    spec = [(np.concatenate([head, rng.randint(1, cfg.vocab, n)])
             .astype(np.int32), 4) for n in (3, 6, 5)]
    jparams = jinit_params(jax.random.key(0), jcfg)
    got = {}
    for paged in (False, True):
        eng = JServingEngine(jcfg, jparams, slots=2, max_len=64,
                             paged=paged, **({"block_size": 8} if paged
                                             else {}))
        for rid, (p, m) in enumerate(spec):
            eng.submit(JRequest(rid, p, max_new_tokens=m))
        got[paged] = {r.rid: list(r.out_tokens)
                      for r in eng.run_until_drained()}
    assert eng.pool_stats()["prefix_hits"] > 0
    assert got[True][0] == got[False][0]
    assert got[True][2] != got[False][2]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    assert _run(ServingEngine(cfg, model, slots=2, max_len=64),
                spec) == got[False]


def test_paged_helpers_read_the_first_kv_cache():
    """A zamba2 cache list with paged attention layers (what a paged
    recurrent engine would hold; `init_caches` builds it, the engine
    refuses it): the block table goes to the KV layers only, and a paged
    engine's swap-out and swap-store layout read the first KV cache, not
    layer 0's MambaCache."""
    zcfg = get_smoke("zamba2_2p7b")
    dcfg = get_smoke("qwen2_1p5b")
    eng = ServingEngine(dcfg, init_params(dcfg, device="cpu"), paged=True,
                        block_size=8, **GEO)
    caches = init_caches(zcfg, 2, 64, device="cpu",
                         paged=(eng._pg_pool, eng._pg_bs))
    assert isinstance(caches[0], MambaCache)
    set_block_tables(caches, torch.zeros(2, 8, dtype=torch.int32))
    kv = kv_caches(caches)
    assert len(kv) == 2 and all(c.table.eq(0).all() for c in kv)
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=8))
    eng.step()
    eng.caches = caches
    layout = eng._pg_block_layout()
    assert layout == {name: ((2, 1, zcfg.n_kv_heads, 8, zcfg.hd),
                             "bfloat16") for name in ("k", "v")}
    kv[0].pos[0] = 5
    eng._pg_swap_out(0)
    assert eng._swap_entries[0]["pos"] == 5
