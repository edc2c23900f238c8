"""The port's fault-tolerance matrix, case for case `tests/test_faults.py`:
every injected fault either recovers to byte-identical greedy output or
fails loudly with the right terminal state, on the CPU (the kernel routes'
plain versions). Quarantine replays equal an unfaulted run, a launch or
dispatch fault demotes to the reference route and equals a `ref` engine,
weight poison fails every request and a snapshot restore recovers, and a
mid-stream snapshot restores byte-identically. Plus a parity test: the
port's engine under the reference's seeded fault plan gives the JAX
engine's tokens, statuses, counters and rejections."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import drive_with_plan as jdrive_with_plan
from repro_torch import api
from repro_torch.api import ExecutionPolicy
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import init_params
from repro_torch.models.transformer import scrub_slots
from repro_torch.serving import (EngineStalledError, Fault, FaultPlan,
                                 KernelLaunchError, Request, ServingEngine,
                                 drive_with_plan)
from repro_torch.serving.faults import (MALFORMED_KINDS, malformed_request,
                                        poison_weights)

MAX_LEN = 64
NAN = float("nan")
INF = float("inf")


def _model(seed=0, kv_quant=False):
    cfg = get_smoke("qwen2_1p5b")
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg, init_params(cfg, seed=seed, device="cpu")


def _spec(vocab, lens, outs, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, l).astype(np.int32), m)
            for l, m in zip(lens, outs)]


def _engine(cfg, model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(cfg, model, **kw)


def _baseline(cfg, model, spec, **kw):
    eng = _engine(cfg, model, **kw)
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    return {r.rid: r.out_tokens for r in eng.run_until_drained()}


def _drain_with(cfg, model, spec, plan, **kw):
    eng = _engine(cfg, model, **kw)
    eng.arm_fault_plan(plan)
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    eng.run_until_drained()
    return eng


# ======================================================== poison -> quarantine
@pytest.mark.parametrize("value", [NAN, INF, -INF])
def test_logits_poison_quarantines_and_replays(value):
    """A slot whose logits go non-finite mid-decode is quarantined and its
    request replayed byte-identically from its prompt; the other slot never
    notices."""
    cfg, model = _model()
    spec = _spec(cfg.vocab, [4, 9], [6, 4])
    want = _baseline(cfg, model, spec)
    plan = FaultPlan.single("poison", step=3, slot=0, target="logits",
                            value=value)
    eng = _drain_with(cfg, model, spec, plan)
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert eng.stats.quarantines == 1
    assert all(r.status == "done" for r in eng.finished)
    assert plan.exhausted() and plan.faults[0].tripped
    assert eng.stats.demotions == 0


@pytest.mark.parametrize("kv_quant", [False, True],
                         ids=["dense-kv", "int8-kv"])
def test_kv_poison_recovers(kv_quant):
    """Cache corruption (bf16 K, or the f32 K scales of an int8 cache)
    shows as non-finite logits at the slot's next launch that reads them;
    quarantine scrubs the row and the replay equals the unfaulted run."""
    cfg, model = _model(seed=1, kv_quant=kv_quant)
    spec = _spec(cfg.vocab, [5, 11], [5, 3], seed=1)
    want = _baseline(cfg, model, spec)
    plan = FaultPlan.single("poison", step=2, slot=1, target="kv", value=NAN)
    eng = _drain_with(cfg, model, spec, plan)
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert eng.stats.quarantines >= 1
    assert all(r.status == "done" for r in eng.finished)


def test_replay_budget_exhaustion_fails_request():
    """With no replay budget the first quarantine is terminal: FAILED,
    counted, and the engine still drains the healthy slot."""
    cfg, model = _model()
    spec = _spec(cfg.vocab, [4, 6], [5, 5])
    plan = FaultPlan.single("poison", step=3, slot=0, target="logits")
    eng = _drain_with(cfg, model, spec, plan, max_replays=0)
    assert {r.status for r in eng.finished} == {"done", "FAILED"}
    assert eng.stats.failed_requests == 1
    assert len(eng.finished) == 2


# ==================================================== launch-fault -> demotion
def test_launch_fault_demotes_to_ref_byte_identically():
    """An injected launch failure on a kernel-route engine re-pins the
    policy to the reference route and retries the SAME step: tokens equal
    a `ref` engine's, the demotion is counted, recorded and warned."""
    cfg, model = _model(seed=2)
    spec = _spec(cfg.vocab, [3, 7], [4, 3], seed=2)
    want = _baseline(cfg, model, spec, policy=ExecutionPolicy(backend="ref"))
    plan = FaultPlan.single("launch", step=0)
    with pytest.warns(RuntimeWarning, match="demoted"):
        eng = _drain_with(cfg, model, spec, plan,
                          policy=ExecutionPolicy(backend="auto"))
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert eng.stats.demotions == 1
    assert eng.policy.backend == "ref"
    (event,) = eng.degraded_routes()
    assert "KernelLaunchError" in event["error"]
    assert event["from"] == {"decode": "cuda-decode",
                             "prefill": "cuda-prefill"}
    assert event["to"] == {"decode": "ref", "prefill": "ref"}


def test_dispatch_boundary_fault_demotes_unwarmed_engine():
    """A dispatch-boundary fault fires in the registry hook at the first op
    dispatch of the launch; the engine demotes and the retry runs the
    reference route. The positions the failed launch advanced are put back
    (the fault fires in layer 0, after its K/V write)."""
    cfg, model = _model(seed=2)
    spec = _spec(cfg.vocab, [3], [3], seed=2)
    want = _baseline(cfg, model, spec, policy=ExecutionPolicy(backend="ref"))
    plan = FaultPlan.single("launch", step=0, boundary="dispatch")
    with pytest.warns(RuntimeWarning, match="demoted"):
        eng = _drain_with(cfg, model, spec, plan)
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert eng.stats.demotions == 1
    assert plan.faults[0].tripped
    assert api.set_dispatch_hook(None) is None      # hook restored


def test_launch_fault_on_ref_engine_raises():
    """No route below ref: the failure propagates instead of demoting."""
    cfg, model = _model()
    eng = _engine(cfg, model, policy=ExecutionPolicy(backend="ref"))
    eng.arm_fault_plan(FaultPlan.single("launch", step=0))
    eng.submit(Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=2))
    with pytest.raises(KernelLaunchError):
        eng.run_until_drained()
    assert eng.stats.demotions == 0


def test_failure_on_the_retry_propagates(monkeypatch):
    """A launch that also fails after the demotion raises: the engine
    demotes once, it does not loop."""
    cfg, model = _model()
    eng = _engine(cfg, model)
    eng.submit(Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=2))

    def broken(tokens, lengths):
        raise KernelLaunchError("the launch fails on every route")
    monkeypatch.setattr(eng, "_step_program", broken)
    with pytest.warns(RuntimeWarning, match="demoted"), \
            pytest.raises(KernelLaunchError, match="every route"):
        eng.step()
    assert eng.stats.demotions == 1


def test_other_launch_errors_propagate_without_demotion(monkeypatch):
    """Only the fault plans' KernelLaunchError demotes. Any other error of
    a launch (a sticky CUDA error, a refused launch plan) propagates at
    once with the route unchanged and the rows' positions put back, so a
    broken kernel is never served through the plain route."""
    cfg, model = _model()
    eng = _engine(cfg, model)
    eng.submit(Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=2))
    routes = (eng.decode_route(), eng.prefill_route())
    pos = [c.pos.clone() for c in eng.caches]

    def broken(tokens, lengths):
        for c in eng.caches:
            c.pos = c.pos + 1
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(eng, "_step_program", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert eng.stats.demotions == 0 and not eng.degraded_routes()
    assert (eng.decode_route(), eng.prefill_route()) == routes
    assert all(torch.equal(c.pos, p) for c, p in zip(eng.caches, pos))


# ================================================================== latency
def test_latency_fault_delays_but_never_corrupts():
    cfg, model = _model()
    spec = _spec(cfg.vocab, [4, 6], [3, 3])
    want = _baseline(cfg, model, spec)
    plan = FaultPlan.single("latency", step=1, delay_s=0.2)
    t0 = time.monotonic()
    eng = _drain_with(cfg, model, spec, plan)
    assert time.monotonic() - t0 >= 0.2
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert plan.faults[0].tripped
    assert eng.stats.quarantines == eng.stats.demotions == 0


# ========================================================== malformed inputs
def test_malformed_matrix_rejected_cleanly():
    """Every hostile submission is turned away at submit() with a
    ValueError/TypeError; the well-formed request in flight is untouched."""
    cfg, model = _model()
    spec = _spec(cfg.vocab, [5], [4])
    want = _baseline(cfg, model, spec)
    plan = FaultPlan([Fault("malformed", step=i, target=d)
                      for i, d in enumerate(MALFORMED_KINDS)])
    eng = _engine(cfg, model)
    eng.submit(Request(0, spec[0][0], max_new_tokens=spec[0][1]))
    finished, rejections = drive_with_plan(eng, plan)
    assert len(rejections) == len(MALFORMED_KINDS)
    assert all(msg for _, _, msg in rejections)
    assert plan.exhausted()
    assert {r.rid: r.out_tokens for r in finished} == want


def test_max_new_tokens_zero_still_legal():
    cfg, model = _model()
    eng = _engine(cfg, model)
    assert eng.submit(Request(7, np.asarray([1, 2], np.int32),
                              max_new_tokens=0))
    (req,) = eng.run_until_drained()
    assert req.rid == 7 and req.out_tokens == [] and req.status == "done"


# ============================================================== seeded sweep
def test_seeded_plan_is_deterministic_and_recovers():
    """Same seed -> same plan, and the reference's plan for that seed; a
    seeded mix of recoverable faults converges to the unfaulted outputs."""
    kinds = ("poison", "latency")
    plan = FaultPlan.seeded(11, steps=10, slots=2, kinds=kinds)
    assert plan.describe() == FaultPlan.seeded(
        11, steps=10, slots=2, kinds=kinds).describe()
    assert plan.describe() == JFaultPlan.seeded(
        11, steps=10, slots=2, kinds=kinds).describe()
    cfg, model = _model(seed=3)
    spec = _spec(cfg.vocab, [4, 8, 5], [5, 3, 4], seed=3)
    want = _baseline(cfg, model, spec)
    plan = FaultPlan.seeded(11, steps=10, slots=2, kinds=kinds, n_faults=4)
    eng = _drain_with(cfg, model, spec, plan, max_replays=8)
    assert {r.rid: r.out_tokens for r in eng.finished} == want
    assert all(r.status == "done" for r in eng.finished)


# ===================================== weight poison -> snapshot/restore
def test_weight_poison_fails_over_to_snapshot_restore(tmp_path):
    """Weight corruption hits every slot at once, so requests spend their
    replay budget and FAIL; restoring the pre-fault snapshot (params
    included) replays the stream byte-identically."""
    cfg, model = _model(seed=4)
    spec = _spec(cfg.vocab, [4, 9], [6, 5], seed=4)
    want = _baseline(cfg, model, spec, weight_format="int8")
    eng = _engine(cfg, model, weight_format="int8", max_replays=1)
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    eng.step()
    eng.step()
    eng.snapshot(tmp_path, include_params=True)
    eng.arm_fault_plan(FaultPlan.single(
        "poison", step=eng.step_no, target="weight", value=NAN))
    eng.run_until_drained()
    assert all(r.status == "FAILED" for r in eng.finished)
    assert eng.stats.failed_requests == len(spec)
    assert eng.stats.quarantines >= len(spec)
    eng.arm_fault_plan(None)
    eng.restore(tmp_path)
    got = {r.rid: r.out_tokens for r in eng.run_until_drained()}
    assert got == want
    assert all(r.status == "done" for r in eng.finished)


def test_weight_poison_fails_over_on_a_gelu_mlp(tmp_path):
    """The weight-poison failover above on a resident gpt2 SMOKE engine
    (LayerNorm, GELU MLP, learned positions), whose health probe reads
    each attention's o input and each GELU MLP's fc2 input."""
    from repro_torch.serving.engine import _InputProbe
    cfg = get_smoke("gpt2_small")
    model = init_params(cfg, seed=4, device="cpu")
    spec = _spec(cfg.vocab, [4, 9], [6, 5], seed=4)
    want = _baseline(cfg, model, spec, weight_format="int8")
    eng = _engine(cfg, model, weight_format="int8", max_replays=1)
    probed = _InputProbe(eng.model).mods
    assert probed == [m for b in eng.model.layers
                      for m in (b.attn.o, b.mlp.fc2)]
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    eng.step()
    eng.step()
    eng.snapshot(tmp_path, include_params=True)
    eng.arm_fault_plan(FaultPlan.single(
        "poison", step=eng.step_no, target="weight", value=NAN))
    eng.run_until_drained()
    assert all(r.status == "FAILED" for r in eng.finished)
    assert eng.stats.failed_requests == len(spec)
    assert eng.stats.quarantines >= len(spec)
    eng.arm_fault_plan(None)
    eng.restore(tmp_path)
    got = {r.rid: r.out_tokens for r in eng.run_until_drained()}
    assert got == want
    assert all(r.status == "done" for r in eng.finished)


def test_poison_weights_leaves_the_callers_model_alone():
    """Weight poison makes a corrupted copy for the engine (the reference
    poisons a new param tree): the caller's tensors stay finite, and the
    copy shares every tensor but the poisoned one."""
    cfg, model = _model(seed=4)
    bad = poison_weights(model)
    assert torch.isnan(bad.final_norm.g[0])
    assert torch.isfinite(model.final_norm.g).all()
    assert bad.embed.table is model.embed.table
    resident = ServingEngine(cfg, model, slots=1, max_len=16,
                             weight_format="int4").model
    bad = poison_weights(resident)
    scales = [m.w_scale for m in bad.modules() if getattr(m, "fmt", None)]
    assert torch.isnan(scales[0].view(-1)[0])
    assert all(torch.isfinite(m.w_scale).all() for m in resident.modules()
               if getattr(m, "fmt", None))


# =============================================== snapshot/restore round trips
@pytest.mark.parametrize("variant", ["dense", "int8-kv", "resident-int8"])
def test_snapshot_restore_midstream_byte_identical(variant, tmp_path):
    """Snapshot a busy engine mid-stream (rows mid-prefill AND mid-decode),
    restore into a FRESH engine, finish: the tokens equal the original
    engine's continuing, across dense, int8-KV and resident layouts."""
    cfg, model = _model(seed=5, kv_quant=(variant == "int8-kv"))
    kw = {"weight_format": "int8"} if variant == "resident-int8" else {}
    spec = _spec(cfg.vocab, [4, 10, 6], [5, 4, 6], seed=5)
    a = _engine(cfg, model, **kw)
    for rid, (p, m) in enumerate(spec):
        a.submit(Request(rid, p, max_new_tokens=m))
    for _ in range(3):
        a.step()
    pre = {r.rid for r in a.finished}
    a.snapshot(tmp_path)
    b = _engine(cfg, model, **kw)
    tables = [c.k_codes if cfg.kv_quant else c.k for c in b.caches]
    assert b.restore(tmp_path) == 3
    # the cache tensors are written in place, never rebound
    assert all(t is (c.k_codes if cfg.kv_quant else c.k)
               for t, c in zip(tables, b.caches))
    got_b = {r.rid: r.out_tokens for r in b.run_until_drained()}
    a.run_until_drained()
    got_a = {r.rid: r.out_tokens for r in a.finished if r.rid not in pre}
    assert got_b == got_a
    assert set(got_b) | pre == set(range(len(spec)))


@pytest.mark.parametrize("other", ["max_len", "kv_quant", "slots"])
def test_restore_rejects_geometry_mismatch(other, tmp_path):
    """A snapshot restores only into a same-shaped engine: another max_len,
    KV layout or slot count raises ValueError, and the engine is left as it
    was."""
    cfg, model = _model()
    _engine(cfg, model, slots=2).snapshot(tmp_path)
    kw = {"max_len": MAX_LEN // 2} if other == "max_len" else \
        {"slots": 3} if other == "slots" else {}
    if other == "kv_quant":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    eng = _engine(cfg, model, **kw)
    with pytest.raises(ValueError):
        eng.restore(tmp_path)
    assert eng.step_no == 0 and not eng.pending()


# ===================================================== deadlines / timeouts
def test_deadline_steps_times_out_resident_request():
    cfg, model = _model()
    eng = _engine(cfg, model)
    eng.submit(Request(0, np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=40, deadline_steps=3))
    eng.submit(Request(1, np.asarray([4, 5], np.int32), max_new_tokens=2))
    by = {r.rid: r for r in eng.run_until_drained()}
    assert by[0].status == "TIMEOUT" and by[0].done
    assert len(by[0].out_tokens) < 40
    assert by[1].status == "done" and len(by[1].out_tokens) == 2
    assert eng.stats.timeouts == 1


def test_ttl_times_out_queued_request():
    cfg, model = _model()
    eng = _engine(cfg, model, slots=1)
    eng.submit(Request(0, np.asarray([1, 2], np.int32), max_new_tokens=3))
    eng.submit(Request(1, np.asarray([3, 4], np.int32), max_new_tokens=3,
                       ttl_s=0.0))
    time.sleep(0.01)
    by = {r.rid: r for r in eng.run_until_drained()}
    assert by[1].status == "TIMEOUT" and by[1].out_tokens == []
    assert by[0].status == "done"
    assert eng.stats.timeouts == 1


# ================================================= backpressure / stall
def test_bounded_queue_backpressure():
    cfg, model = _model()
    eng = _engine(cfg, model, slots=1, max_queue=1)
    a = Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=2)
    b = Request(1, np.asarray([4, 5], np.int32), max_new_tokens=2)
    c = Request(2, np.asarray([6, 7], np.int32), max_new_tokens=2)
    assert eng.submit(a) is True
    assert eng.submit(b) is False
    assert b.status == "REJECTED" and eng.stats.rejected_submits == 1
    eng.step()                      # a admitted; the queue has room again
    assert eng.submit(c) is True
    assert sorted(r.rid for r in eng.run_until_drained()) == [0, 2]


def test_stalled_drain_raises_diagnostic():
    cfg, model = _model()
    eng = _engine(cfg, model, slots=1)
    eng.submit(Request(0, np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=30))
    eng.submit(Request(1, np.asarray([4, 5], np.int32), max_new_tokens=5))
    with pytest.raises(EngineStalledError) as ei:
        eng.run_until_drained(max_steps=3)
    assert ei.value.stuck and ei.value.stuck[0]["rid"] == 0
    assert ei.value.queue_depth == 1
    assert "stuck slot" in str(ei.value)


# ============================================================ submit hygiene
@pytest.mark.parametrize("defect,exc", [
    ("empty-prompt", ValueError), ("float-prompt", TypeError),
    ("2d-prompt", ValueError), ("negative-max-new", ValueError),
    ("float-max-new", TypeError), ("absurd-max-new", ValueError)])
def test_submit_rejects_each_defect(defect, exc):
    cfg, model = _model()
    eng = _engine(cfg, model)
    with pytest.raises(exc):
        eng.submit(malformed_request(defect))
    assert not eng.pending()


# ============================================================ scrub values
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_scrub_zeroes_values_so_a_reused_slot_equals_a_fresh_one(kv_quant):
    """A NaN left in a slot's cache reaches a later row there through P V
    even past its causal frontier; scrub_slots resets the values (codes 0,
    scales 1) and the position, so the reused slot serves as a fresh
    engine does."""
    cfg, model = _model(seed=6, kv_quant=kv_quant)
    spec = _spec(cfg.vocab, [6], [4], seed=6)
    want = _baseline(cfg, model, spec, slots=1)
    eng = _engine(cfg, model, slots=1)
    for c in eng.caches:
        for name in ("k", "v", "k_scale", "v_scale"):
            if hasattr(c, name):
                getattr(c, name)[:, :, 40:] = NAN
    scrub_slots(eng.caches, torch.tensor([True]))
    for c in eng.caches:
        assert all(torch.isfinite(getattr(c, f.name).float()).all()
                   for f in dataclasses.fields(c))
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    assert {r.rid: r.out_tokens for r in eng.run_until_drained()} == want


# ================================================= parity with the JAX engine
@pytest.fixture(scope="module")
def jax_faulted():
    """One JAX engine run under a seeded plan of poison, latency and
    malformed faults (module-scoped: built once), and the port's model
    holding the same weights."""
    jcfg = jax_smoke("qwen2_1p5b")
    jparams = jinit_params(jax.random.key(7), jcfg)
    spec = _spec(jcfg.vocab, [4, 9, 6, 12], [6, 4, 5, 3], seed=7)
    kinds = ("poison", "latency", "malformed")
    plan = JFaultPlan.seeded(5, steps=12, slots=2, kinds=kinds, n_faults=6)
    eng = JServingEngine(jcfg, jparams, slots=2, max_len=MAX_LEN,
                         prefill_chunk=8, max_replays=4)
    for rid, (p, m) in enumerate(spec):
        eng.submit(JRequest(rid, p, max_new_tokens=m))
    finished, rejections = jdrive_with_plan(eng, plan)
    want = {r.rid: (r.status, list(r.out_tokens), r.replays)
            for r in finished}
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            get_smoke("qwen2_1p5b"), device="cpu")
    return (spec, kinds, want, dataclasses.asdict(eng.stats),
            [(s, d) for s, d, _ in rejections],
            [f.tripped for f in plan.faults], model)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_seeded_plan_matches_jax_engine(jax_faulted, backend):
    """The same seeded plan on the port's engine (its kernel routes' plain
    versions, and its reference route) gives the JAX engine's tokens,
    statuses, replays, counters, rejections and tripped faults."""
    spec, kinds, want, jstats, jrej, jtripped, model = jax_faulted
    plan = FaultPlan.seeded(5, steps=12, slots=2, kinds=kinds, n_faults=6)
    assert sum(f.kind == "poison" for f in plan.faults) >= 2
    eng = _engine(get_smoke("qwen2_1p5b"), model, max_replays=4,
                  policy=ExecutionPolicy(backend=backend))
    for rid, (p, m) in enumerate(spec):
        eng.submit(Request(rid, p, max_new_tokens=m))
    finished, rejections = drive_with_plan(eng, plan)
    got = {r.rid: (r.status, list(r.out_tokens), r.replays)
           for r in finished}
    assert got == want
    stats = dataclasses.asdict(eng.stats)
    assert stats == {k: jstats[k] for k in stats}
    assert stats["quarantines"] >= 1
    assert [(s, d) for s, d, _ in rejections] == jrej
    assert [f.tripped for f in plan.faults] == jtripped


# ============================================================ checkpoint store
def test_checkpoint_store_round_trip_gc_and_async(tmp_path):
    """`checkpoint.store` saves a tree of dataclasses and dicts of bf16,
    int8 and f32 tensors and numpy arrays atomically and restores it
    bitwise (bf16 through its 16-bit pattern); `latest_step`, `gc_old` and
    the async saver keep the newest steps; a missing leaf is a KeyError
    and a reshaped one a ValueError."""
    from repro_torch.checkpoint import store
    from repro_torch.models.attention import KVCache
    g = torch.Generator().manual_seed(0)
    tree = {"caches": [KVCache(k=torch.randn(2, 3, 4, generator=g)
                               .to(torch.bfloat16),
                               v=torch.randint(-128, 127, (2, 3, 4),
                                               generator=g).to(torch.int8),
                               pos=torch.tensor([1, 2], dtype=torch.int32))],
            "w": torch.randn(5, generator=g), "n": np.arange(3)}
    store.save(tmp_path, 7, tree, extra={"a": 1})
    back, extra, step = store.restore(tmp_path, tree)
    assert step == 7 and extra == {"a": 1}
    c, b = tree["caches"][0], back["caches"][0]
    assert isinstance(b, KVCache) and b.k.dtype == torch.bfloat16
    assert torch.equal(b.k.view(torch.int16), c.k.view(torch.int16))
    assert torch.equal(b.v, c.v) and torch.equal(b.pos, c.pos)
    assert torch.equal(back["w"], tree["w"])
    assert np.array_equal(np.asarray(back["n"]), tree["n"])
    with pytest.raises(KeyError):
        store.restore(tmp_path, {**tree, "extra_leaf": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        store.restore(tmp_path, {**tree, "w": torch.zeros(6)})
    saver = store.AsyncCheckpointer(tmp_path, keep=2)
    saved = {}
    for s in (8, 9, 10):
        saved[s] = tree["w"].clone()
        saver.save(s, tree)
        tree["w"].add_(1)         # the saver copied the tensors already
    saver.wait()
    assert store.latest_step(tmp_path) == 10
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000009", "step_00000010"]
    back, _, _ = store.restore(tmp_path, tree, step=9)
    assert torch.equal(back["w"], saved[9])
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())


def test_serve_launcher_robustness_flags_on_cpu(capsys):
    """The launcher's --priority, --swap-watermark, --max-queue,
    --deadline-steps and --ttl-s reach the engine, and it prints the fault
    counters and the swap line."""
    from repro_torch.launch import serve
    done = serve.main(["--smoke", "--device", "cpu", "--paged",
                       "--pool-blocks", "16", "--priority", "0,1",
                       "--swap-watermark", "0.75", "--max-queue", "2",
                       "--deadline-steps", "3", "--ttl-s", "60",
                       "--requests", "4", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "fault counters: quarantines=0 demotions=0 timeouts=" in out
    assert "rejected=2" in out and "swap: watermark 0.75" in out
    assert len(done) == 2 and {r.status for r in done} == {"TIMEOUT"}
    assert [r.priority for r in done] == [0, 1]
