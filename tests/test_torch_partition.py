"""Serving each tenant tensor-parallel on its morphable partition, on the
CPU, against the JAX package: a gloo world of 4 ranks laid out as a (2, 2)
grid of ranks beside one JAX subprocess with 4 host devices.

* `MorphableScheduler()` on the world: two (1, 2) partitions, the ranks of
  the reference's device blocks.
* qwen2 and llama2 SMOKE (2 layers) served through `ServingEngine` on a
  partition (`dist.init_sharded` weights, `MorphableScheduler.run`), flat
  and paged, dense and int8 KV: every rank's greedy tokens equal the
  one-rank engine's and the reference engine's under the same sub-mesh;
  each rank's caches hold n_kv / 2 heads, equal to the reference's shard
  of them within 1e-5 (f32 caches on both sides); a decode step records
  one row-parallel all-reduce per projection back to d_model, and no
  weight all-gather.
* zamba2, xlstm, whisper, gemma2, gpt2 and kimi SMOKE on a partition give
  the one-rank engine's tokens; only the layers with no head-parallel path
  (mLSTM, cross attention) all-gather weights. olmoe's expert capacity
  counts every position of a launch, as on one rank (data is 1).
* The robustness layer on a partition: preemption and a launch fault
  armed alike on both ranks give the one-rank engine's tokens; fault plans
  that differ between the ranks, demotion after a launch error no plan
  injected and resident weights on shards are refused; resident weights
  served whole on every rank give the one-rank resident engine's tokens.
* Snapshots on a partition: each case's engine snapshotted mid-stream
  (after chunk and decode steps) and restored into a fresh engine on the
  same partition finishes with the uninterrupted tokens; each rank's
  restored caches equal its head shard of the reference's snapshot of its
  engine at the same step; a snapshot is refused on every rank onto a
  mesh of another shape ((2, 1), one rank, and the reverse), with a rank
  shard missing, or with caches of other heads.
* Wall-clock TTLs on a partition: with the second rank's clock skewed in
  offset and rate, both ranks end the same requests TIMEOUT at the same
  step, as the one-rank engine does on the lead rank's clock (and not as
  it does on the skewed one).
* The dry-run's decode cell on a sharded model sizes its caches by the
  heads each rank computes, and all-gathers no weight.
* `launch.serve --multi-tenant --backend ref` on the world: each tenant on
  its own (1, 2) partition, tokens equal to the reference launcher's on 4
  host devices (its engines under `set_mesh(part.mesh)`), each tenant's
  lines printed by the first rank of its partition only.

The weights are the port's seeded init, carried to JAX by
`bridge.params_to_jax`."""
import contextlib
import dataclasses
import functools
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_jax
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.dist import init_sharded, shard_params
from repro_torch.dist.sharding import ShapeMesh
from repro_torch.launch.world import spawn_world
from repro_torch.models import transformer as T

import _xdist_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.timeout(240)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
EXAMPLES = os.path.join(os.path.dirname(HERE), "examples")
TOL = 1e-5
GEO = dict(slots=4, max_len=64, prefill_chunk=8)
BS = 8                                   # paged block size
MAX_NEW = 6
# one partition each (the launcher's tenant shapes)
TENANTS = [("qwen2_1p5b", 64, 512), ("llama2_7b", 64, 768)]
# (arch, paged, int8 KV)
CASES = [("qwen2_1p5b", False, False), ("qwen2_1p5b", True, True),
         ("llama2_7b", False, True), ("llama2_7b", True, False)]
# the other families, served on the qwen2 / llama2 partition
FAMILIES = {"qwen2_1p5b": ("zamba2_2p7b", "xlstm_1p3b", "whisper_tiny"),
            "llama2_7b": ("gemma2_27b", "gpt2_small", "kimi_k2")}
REPLICATED = ("xlstm_1p3b", "whisper_tiny")   # mLSTM q/k/v, cross attention
LAUNCH = ["--requests", "3", "--max-new", "5"]
LAUNCH_ARCHS = ("olmoe_1b_7b", "qwen2_1p5b")
SNAP_AT = 3                    # the engine step a case is snapshotted at
# TTLs of the five prompts (seconds on the lead rank's fake clock, which
# a read advances by 1 s; the other rank's starts 6,900 s later and a
# read advances it by 3.7 s)
TTLS = [None, 5.5, 1.5, 100.0, 3.5]
CLOCKS = {"lead": (100.0, 1.0), "skewed": (7000.0, 3.7)}


def contended(vocab, seed=0):
    """Six prompts of 18-29 tokens whose budgets (with 12 new tokens) are
    3 blocks of 16: two cannot share a 4-block pool, so alternating
    priorities preempt."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, rng.randint(18, 30)).astype(np.int32)
            for _ in range(6)]


PRIOS = [0, 1, 0, 1, 0, 1]
CONTENDED = dict(pool_blocks=4, slots=2, block_size=16)


def _key(case):
    arch, paged, int8 = case
    return f"{arch}/{'paged' if paged else 'flat'}/{'int8' if int8 else 'f32'}"


def prompts(vocab, seed=0):
    """Five prompts; the fourth shares the second's first 16 tokens (two
    whole blocks of 8: a prefix hit on a paged engine)."""
    rng = np.random.RandomState(seed)
    out = [rng.randint(1, vocab, n).astype(np.int32)
           for n in (5, 19, 12, 9, 3)]
    out[3] = np.concatenate([out[1][:16], out[3]])
    return out


JAX_CODE = r"""
import os, sys, pickle, dataclasses, functools
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, SRC)
import numpy as np, jax, jax.numpy as jnp
from repro import api
from repro.checkpoint import store
from repro.configs import get_smoke
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serving import Request, ServingEngine
from repro.tenancy import MorphableScheduler, Tenant

data = pickle.load(open(IN, "rb"))
tree = lambda t: jax.tree.map(jnp.asarray, t)
out = {}


def layers(caches):
    # per-layer {field: array} of the stacked single segment
    (seg,) = caches
    (c,) = seg.values()
    c = {f: np.asarray(a) for f, a in c._asdict().items()}
    n = next(iter(c.values())).shape[0]
    return [{f: a[i] for f, a in c.items()} for i in range(n)]


def serve_case(arch, paged, int8):
    cfg = dataclasses.replace(get_smoke(arch), kv_quant=int8)
    eng = ServingEngine(cfg, tree(data["params"][arch]), paged=paged,
                        block_size=BS, **GEO)
    for rid, p in enumerate(data["prompts"][arch]):
        eng.submit(Request(rid, p, max_new_tokens=MAX_NEW))
    snap = None
    while eng.pending():
        if eng.step_no == SNAP_AT:
            d = os.path.join(os.path.dirname(OUT), "snap_" + "_".join(
                map(str, (arch, paged, int8))))
            eng.snapshot(d)
            snap = layers(store.restore(d, {"caches": eng.caches})[0]
                          ["caches"])
        eng.step()
    leaf = jax.tree.leaves(eng.caches)[0]
    return ({r.rid: [int(t) for t in r.out_tokens] for r in eng.finished},
            layers(eng.caches), str(leaf.sharding.spec), snap)


sched = MorphableScheduler()
sched.reconfigure([Tenant(a, r, c) for a, r, c in TENANTS])
out["partitions"] = [(p.tenants, p.mesh.devices.shape,
                      [d.id for d in p.mesh.devices.flat])
                     for p in sched.partitions]
f32 = functools.partial(JT.init_caches, dtype=jnp.float32)
orig, JT.init_caches = JT.init_caches, f32
for case in MINE:
    out[case] = sched.run(case[0], serve_case, *case)
JT.init_caches = orig
if LAUNCHER:
    # the reference launcher's --multi-tenant branch, port weights
    jserve.init_params = lambda key, cfg: tree(data["params"][cfg.name])
    lsched = MorphableScheduler()
    lsched.reconfigure([
        Tenant("captioning", weight_rows=64, weight_cols=512, fmt="int8"),
        Tenant("classification", weight_rows=64, weight_cols=768,
               fmt="int8")])
    for tenant, arch in (("captioning", "olmoe_1b_7b"),
                         ("classification", "qwen2_1p5b")):
        done = lsched.run(tenant, jserve._run_engine, arch, True, REQUESTS,
                          MAX_NEW_L,
                          policy=api.ExecutionPolicy(backend="ref"),
                          sched=lsched, tenant=tenant)
        out["launch/" + tenant] = {r.rid: [int(t) for t in r.out_tokens]
                                   for r in done}
pickle.dump(out, open(OUT, "wb"))
"""


# --------------------------------------------------------------- the world
def _tokens(done):
    return {r.rid: [int(t) for t in r.out_tokens] for r in done}


def _caches(eng):
    return [{f.name: getattr(c, f.name).clone()
             for f in dataclasses.fields(c)} for c in eng.caches]


def _drive(eng, ps, prios=None, plan=None, max_new=MAX_NEW):
    from repro_torch.serving import Request
    if plan is not None:
        eng.arm_fault_plan(plan)
    for rid, p in enumerate(ps):
        assert eng.submit(Request(rid, p, max_new_tokens=max_new,
                                  priority=prios[rid] if prios else 0))
    return _tokens(eng.run_until_drained())


def _engine(arch, paged, int8, sharded, **kw):
    from repro_torch.dist.sharding import ctx_mesh
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_smoke(arch), kv_quant=int8)
    model = init_sharded(cfg, ctx_mesh(), device="cpu") if sharded \
        else T.init_params(cfg, device="cpu")
    geo = dict(GEO, paged=paged, block_size=BS)
    geo.update(kw)
    return cfg, ServingEngine(cfg, model, **geo)


def _snap_dir(*parts):
    """A directory both ranks of a partition name alike: under the
    world's private rendezvous directory."""
    return os.path.join(_WORLD["dir"], "snapshots", "_".join(map(str, parts)))


def _partition_case(arch, paged, int8):
    """On the partition's ranks: the engine on this rank's shards, its
    tokens and caches, and one decode step's collectives; the engine
    snapshotted at step SNAP_AT, and a fresh engine restored from it: its
    caches just after the restore and its tokens at the end."""
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.dist.sharding import axis_rank
    from repro_torch.serving import Request
    cfg, eng = _engine(arch, paged, int8, True)
    snap = _snap_dir(arch, paged, int8)
    for rid, p in enumerate(prompts(cfg.vocab)):
        assert eng.submit(Request(rid, p, max_new_tokens=MAX_NEW))
    while eng.pending():
        if eng.step_no == SNAP_AT:
            eng.snapshot(snap)
            steps = (eng.stats.prefill_chunk_calls, eng.stats.decode_steps)
        eng.step()
    tokens = _tokens(eng.finished)
    with record_collectives() as rec:
        eng.step_trace(1, contextlib.nullcontext())
    _, fresh = _engine(arch, paged, int8, True)
    got = fresh.restore(snap)
    restored = _caches(fresh)
    return {"model": axis_rank("model", eng.mesh), "tokens": tokens,
            "caches": _caches(eng),
            "decode": sorted((r["kind"], str(r["site"])) for r in rec),
            "snapshot": {"step": got, "steps": steps, "caches": restored,
                         "tokens": _tokens(fresh.run_until_drained())}}


def _robustness(arch):
    """Preemption (a 4-block pool, alternating priorities) and a launch
    fault armed alike on every rank; the refusals on a partition: fault
    plans that differ between the ranks, a launch error that no plan
    injected (raised on every rank at its first dispatch) and resident
    codes on shards."""
    from repro_torch import api
    from repro_torch.dist.sharding import axis_rank
    from repro_torch.serving import Request
    from repro_torch.serving.faults import FaultPlan, KernelLaunchError
    cfg, eng = _engine(arch, True, False, True, **CONTENDED)
    out = {"preempt": _drive(eng, contended(cfg.vocab), PRIOS, max_new=12),
           "preemptions": eng.pool_stats()["preemptions"]}
    _, eng = _engine(arch, False, False, True)
    out["fault"] = _drive(eng, prompts(cfg.vocab),
                          plan=FaultPlan.single("launch", step=3))
    out["demotions"] = eng.stats.demotions
    unplanned = []
    _, eng = _engine(arch, False, False, True)

    def fail(op_name, impl):
        raise KernelLaunchError(f"unplanned failure at {op_name}")
    try:
        with api.dispatch_intercepted(fail):
            _drive(eng, prompts(cfg.vocab)[:1])
    except RuntimeError as err:
        unplanned.append(f"{type(err).__name__}: {err}")
    out["unplanned"] = (unplanned, eng.stats.demotions)
    refused = []
    step = 3 + axis_rank("model", eng.mesh)
    for what in (lambda: eng.arm_fault_plan(
                     FaultPlan.single("launch", step=step)),
                 lambda: _engine(arch, False, False, True,
                                 weight_format="int8")):
        try:
            what()
        except ValueError as err:
            refused.append(str(err))
    out["refused"] = refused
    _, eng = _engine(arch, False, False, False, weight_format="int8")
    out["resident"] = _drive(eng, prompts(cfg.vocab))
    return out


def _refused_snapshots(arch):
    """A snapshot of the partition's flat engine restored where it does
    not fit, each on every rank: an engine on the (2, 1) mesh of the same ranks, an engine
    of one rank, the partition's engine given a one-rank snapshot, a copy
    of the snapshot without its second rank's shard, and a snapshot of an
    engine whose caches hold other heads. Returns each refusal's
    message, or the failure to refuse."""
    import shutil
    from repro_torch.dist.collectives import barrier
    from repro_torch.dist.sharding import ctx_mesh, set_mesh
    from repro_torch.serving import ServingEngine
    mesh = ctx_mesh()
    cfg, eng = _engine(arch, False, False, True)
    part = _snap_dir(arch, "refusals")
    _drive(eng, prompts(cfg.vocab)[:2], max_new=2)
    eng.snapshot(part)
    one = _snap_dir(arch, "one", axis_rank_of(mesh))
    with set_mesh(None):
        _, single = _engine(arch, False, False, False)
        single.snapshot(one)
    lacking = _snap_dir(arch, "lacking")
    if axis_rank_of(mesh) == 0:
        shutil.copytree(part, lacking)
        (step,) = os.listdir(lacking)
        shutil.rmtree(os.path.join(lacking, step, "rank-0001"))
    barrier(mesh)
    heads = _snap_dir(arch, "heads")
    wide = dataclasses.replace(cfg, n_heads=2 * cfg.n_heads,
                               n_kv_heads=2 * cfg.n_kv_heads)
    ServingEngine(wide, init_sharded(wide, mesh, device="cpu"),
                  **GEO).snapshot(heads)
    tall = next(m for m in _WORLD["tall"] if m.get_coordinate() is not None)
    with set_mesh(tall):
        _, on_tall = _engine(arch, False, False, False)
    with set_mesh(None):
        _, single = _engine(arch, False, False, False)
    out = []
    for target, src in ((on_tall, part), (single, part), (eng, one),
                        (eng, lacking), (eng, heads)):
        try:
            target.restore(src)
            out.append("restored")
        except ValueError as err:
            out.append(str(err))
    return out


class _Clock:
    """The engine module's `time`, whose monotonic clock starts at `start`
    and advances by `tick` at every read."""

    def __init__(self, start, tick):
        self.now, self.tick = start, tick

    def monotonic(self):
        self.now += self.tick
        return self.now

    def __getattr__(self, name):
        import time
        return getattr(time, name)


def _ttl_run(arch, clock):
    """Five requests with TTLS on an engine reading `clock`: {rid:
    (status, the step it ended in, tokens)}."""
    from repro_torch.serving import Request
    from repro_torch.serving import engine as engine_mod
    cfg, eng = _engine(arch, False, False, axis_rank_of(None) is not None)
    saved, engine_mod.time = engine_mod.time, _Clock(*clock)
    try:
        for rid, (p, ttl) in enumerate(zip(prompts(cfg.vocab), TTLS)):
            assert eng.submit(Request(rid, p, max_new_tokens=MAX_NEW,
                                      ttl_s=ttl))
        out = {}
        while eng.pending():
            for r in eng.step():
                out[r.rid] = (r.status, eng.step_no, list(r.out_tokens))
    finally:
        engine_mod.time = saved
    return out


def _ttl_case(arch):
    """The partition's engine with each rank on its own fake clock (the
    lead's, or the skewed one); on the lead also the one-rank engine on
    the lead's clock and on the skewed one."""
    from repro_torch.dist.sharding import ctx_mesh, set_mesh
    lead = axis_rank_of(ctx_mesh()) == 0
    out = {"partition": _ttl_run(arch, CLOCKS["lead" if lead
                                              else "skewed"])}
    if lead:
        with set_mesh(None):
            out["one"] = {k: _ttl_run(arch, c) for k, c in CLOCKS.items()}
    return out


def axis_rank_of(mesh):
    """This rank's index on "model" of `mesh` (the ambient one when None
    is given and a mesh is bound), or None without a mesh."""
    from repro_torch.dist.sharding import axis_rank, ctx_mesh
    mesh = ctx_mesh() if mesh is None else mesh
    return None if mesh is None else axis_rank("model", mesh)


def _families(tenant):
    """The other families' SMOKE engines on this partition and on one
    rank: their tokens and the partition's collective sites."""
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.dist.sharding import ctx_mesh, set_mesh
    from repro_torch.serving import ServingEngine
    out = {}
    for arch in FAMILIES[tenant]:
        cfg = get_smoke(arch)
        kw = dict(slots=2, max_len=32, prefill_chunk=8)
        if cfg.family == "audio":
            kw["frames"] = np.random.RandomState(0).standard_normal(
                (2, 8, cfg.d_model)).astype(np.float32)
        ps = prompts(cfg.vocab)[:3]
        eng = ServingEngine(cfg, init_sharded(cfg, ctx_mesh(), device="cpu"),
                            **kw)
        with record_collectives() as rec:
            got = _drive(eng, ps, max_new=4)
        with set_mesh(None):
            one = _drive(ServingEngine(cfg, T.init_params(cfg, device="cpu"),
                                       **kw), ps, max_new=4)
        out[arch] = (got, one, sorted({str(r["site"]) for r in rec}))
    return out


def _one_rank(arch):
    """The same cases on one rank, outside any mesh."""
    import warnings
    from repro_torch.serving.faults import FaultPlan
    cfg = get_smoke(arch)
    out = {}
    for case in CASES:
        if case[0] == arch:
            out[_key(case)] = _drive(_engine(*case, False)[1],
                                     prompts(cfg.vocab))
    _, eng = _engine(arch, True, False, False, **CONTENDED)
    out["preempt"] = _drive(eng, contended(cfg.vocab), PRIOS, max_new=12)
    _, eng = _engine(arch, False, False, False, weight_format="int8")
    out["resident"] = _drive(eng, prompts(cfg.vocab))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, eng = _engine(arch, False, False, False)
        out["fault"] = _drive(eng, prompts(cfg.vocab),
                              plan=FaultPlan.single("launch", step=3))
    return out


_WORLD = {}


def _rank_main(rank, world, init):
    import warnings
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_world, make_meshes
    from repro_torch.models import moe as moe_mod
    from repro_torch.tenancy import MorphableScheduler, Tenant
    init_world(init_method=init, rank=rank, world_size=world, device="cpu")
    _WORLD["dir"] = os.path.dirname(init[len("file://"):])
    # (2, 1) meshes of each partition's ranks: a mesh of another shape
    _WORLD["tall"] = make_meshes([np.array([[0], [1]]),
                                  np.array([[2], [3]])])
    sched = MorphableScheduler()
    parts = sched.reconfigure([Tenant(*t) for t in TENANTS])
    res = {"rank": rank, "grid": sched.ranks.tolist(),
           "partitions": [(p.tenants, tuple(p.mesh.shape), p.ranks)
                          for p in parts]}
    saved = T.init_caches
    T.init_caches = functools.partial(saved, dtype=torch.float32)
    try:
        for case in CASES:
            got = sched.run(case[0], _partition_case, *case)
            if got is not None:
                res[_key(case)] = got
    finally:
        T.init_caches = saved
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the demotion
        for arch, *_ in TENANTS:
            got = sched.run(arch, _robustness, arch)
            if got is not None:
                res["robust"] = got
                res["one"] = _one_rank(arch)
                res["families"] = sched.run(arch, _families, arch)
                res["refusals"] = sched.run(arch, _refused_snapshots, arch)
                res["ttl"] = sched.run(arch, _ttl_case, arch)
    text = io.StringIO()
    tokens = []

    def capacity(t, *args):
        tokens.append(t)
        return real(t, *args)
    real = moe_mod.expert_capacity
    moe_mod.expert_capacity = capacity
    try:
        with contextlib.redirect_stdout(text):
            done = serve.main(["--multi-tenant", "--device", "cpu",
                               "--backend", "ref"] + LAUNCH)
    finally:
        moe_mod.expert_capacity = real
    res["capacity_tokens"] = sorted(set(tokens))
    res["launch"] = {t: _tokens(d) for t, d in done.items()}
    res["stdout"] = text.getvalue()
    # the multi-tenant example on the world: each tenant on its partition
    sys.path.insert(0, EXAMPLES)
    import pt_multi_tenant_serving as example
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        served = example.main(["--device", "cpu"])
    res["example"] = ({t: _tokens(d) for t, (d, _) in served.items()},
                      text.getvalue())
    dist.barrier()
    dist.destroy_process_group()
    return res


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition")
    data = {"params": {}, "prompts": {}}
    for arch, *_ in TENANTS:
        cfg = get_smoke(arch)
        data["params"][arch] = params_to_jax(T.init_params(cfg,
                                                           device="cpu"))
        data["prompts"][arch] = prompts(cfg.vocab)
    for arch in LAUNCH_ARCHS:          # the launcher's, by config name
        cfg = get_smoke(arch)
        data["params"][cfg.name] = params_to_jax(T.init_params(cfg,
                                                               device="cpu"))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    procs = {}
    # two processes side by side: three cases; the last and the launcher
    for part, mine in (("a", CASES[:3]), ("b", CASES[3:])):
        code = (f"SRC = {SRC!r}; IN = {str(tmp / 'in.pkl')!r}; "
                f"OUT = {str(tmp / (part + '.pkl'))!r}; MINE = {mine!r}; "
                f"LAUNCHER = {part == 'b'}; TENANTS = {TENANTS!r}; "
                f"GEO = {GEO!r}; SNAP_AT = {SNAP_AT}; "
                f"BS = {BS}; MAX_NEW = {MAX_NEW}; "
                f"REQUESTS = {int(LAUNCH[1])}; "
                f"MAX_NEW_L = {int(LAUNCH[3])}\n" + JAX_CODE)
        procs[part] = subprocess.Popen(
            [sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_world(4, "test_torch_partition:_rank_main",
                            sys_path=[HERE, SRC], timeout=600)
        logs = {part: p.communicate(timeout=600)[0]
                for part, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ref = {}
    for part, p in procs.items():
        assert p.returncode == 0, logs[part][-3000:]
        with open(tmp / (part + ".pkl"), "rb") as f:
            ref.update(pickle.load(f))
    return ref, ranks


def _members(ranks, arch):
    """The ranks of `arch`'s partition, in mesh order."""
    return [r for r in ranks if _key(next(c for c in CASES
                                          if c[0] == arch)) in r]


class _RankMesh(ShapeMesh):
    """A (1, 2) mesh of sizes only, seen from one rank of "model"."""

    def __init__(self, rank):
        super().__init__((1, 2), ("data", "model"))
        self.rank = rank

    def get_local_rank(self, mesh_dim):
        return self.rank if mesh_dim == "model" else 0


def test_dryrun_decode_cell_gathers_no_weight():
    """One rank's decode step of the dry-run on a (2, 2) ShapeMesh: the
    caches hold n_kv / 2 heads a layer, and the only collectives are the
    embedding's and the row-parallel all-reduces and the logits' gather."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    cfg = get_smoke("qwen2_1p5b")
    cell = dataclasses.replace(SHAPES["decode_32k"], batch=4, seq=32)
    mesh = ShapeMesh((2, 2), ("data", "model"))
    run = D.run_step(cfg, cell, mesh)
    assert sorted({(r["kind"], str(r["site"])) for r in run["records"]}) \
        == [("all-gather", "unembed"), ("all-reduce", "embed"),
            ("all-reduce", "row")]
    model = S.params_shapes(cfg)
    shard_params(model, mesh)
    heads = {c.k.shape[1] for c in S.cache_shapes(cfg, 2, 32, model=model)}
    assert heads == {cfg.n_kv_heads // 2}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_sharded_equals_shard_params_of_init_params(arch):
    """Each rank's shards made as the weights are drawn equal the whole
    seeded model cut afterwards, bitwise, with the same `shards` records."""
    cfg = get_smoke(arch)
    for rank in (0, 1):
        mesh = _RankMesh(rank)
        want = T.init_params(cfg, seed=3, device="cpu")
        shard_params(want, mesh)
        got = init_sharded(cfg, mesh, seed=3, device="cpu")
        a, b = want.state_dict(), got.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert {n: getattr(m, "shards", None)
                for n, m in want.named_modules()} == \
            {n: getattr(m, "shards", None) for n, m in got.named_modules()}


def test_partitions_are_the_references(ran):
    """The world's (2, 2) grid of ranks splits as the reference splits 4
    host devices: one (1, 2) partition a tenant, ranks 0-1 and 2-3."""
    ref, ranks = ran
    want = [(tenants, tuple(shape), ids)
            for tenants, shape, ids in ref["partitions"]]
    assert want == [(("qwen2_1p5b",), (1, 2), [0, 1]),
                    (("llama2_7b",), (1, 2), [2, 3])]
    for r in ranks:
        assert r["grid"] == [[0, 1], [2, 3]]
        assert [(t, s, ids) for t, s, ids in r["partitions"]] == want


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_partition_tokens_equal_one_rank_and_reference(ran, case):
    ref, ranks = ran
    members = _members(ranks, case[0])
    assert [r["rank"] for r in members] == ([0, 1] if case[0] == "qwen2_1p5b"
                                            else [2, 3])
    want = ref[case][0]
    assert len(want) == 5 and all(len(t) == MAX_NEW for t in want.values())
    for r in members:
        assert r[_key(case)]["tokens"] == want
        assert r["one"][_key(case)] == want


def _held(layer, paged):
    """(rows or pool blocks, positions) mask of the cache entries some row
    holds below its frontier: the rest are pad keys past a frontier (the
    reference computes pad queries' attention, the port's kernels give
    them zeros, so from the second layer on they differ) or never
    written."""
    pos = layer["pos"]
    if not paged:
        return np.arange(layer["k" if "k" in layer else "k_codes"]
                         .shape[2])[None, :] < pos[:, None]
    pool = layer["k" if "k" in layer else "k_codes"]
    mask = np.zeros((pool.shape[0], pool.shape[2]), bool)
    bs = pool.shape[2]
    for b, n in enumerate(pos):
        p = np.arange(n)
        mask[layer["table"][b, p // bs], p % bs] = True
    return mask


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_rank_caches_equal_reference_head_shard(ran, case):
    """Each rank holds n_kv / 2 KV heads a layer (codes and scales of an
    int8 cache, block pools of a paged one), equal to the reference's
    cache's shard of them at every position a row holds; the reference's
    cache is sharded on its heads axis over "model"."""
    ref, ranks = ran
    _, want, spec, _ = ref[case]
    assert "'model'" in spec.split(",")[2], spec  # (layers, B, Hkv, ...)
    n_kv = get_smoke(case[0]).n_kv_heads
    h = n_kv // 2
    for r in ranks:
        if _key(case) not in r:
            continue
        got, m = r[_key(case)]["caches"], r[_key(case)]["model"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            held = _held(w, case[1])
            assert held.sum() >= 60
            for f, a in w.items():
                t = g[f].numpy()
                if f in ("pos", "table"):
                    np.testing.assert_array_equal(t, a)
                    continue
                if case[1]:
                    t = t[:-1]                       # the port's trash block
                assert t.shape[1] == h, (f, t.shape)
                np.testing.assert_allclose(
                    np.moveaxis(t, 1, 2)[held].astype(np.float32),
                    np.moveaxis(a[:, m * h:(m + 1) * h], 1, 2)[held]
                    .astype(np.float32), rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_decode_step_reduces_rows_and_gathers_no_weight(ran, case):
    """A decode step of the sharded engine: the vocab-parallel embedding's
    all-reduce, one row-parallel all-reduce after attention and one after
    the MLP a layer, the logits' all-gather; no weight is all-gathered."""
    _, ranks = ran
    layers = get_smoke(case[0]).n_layers
    for r in _members(ranks, case[0]):
        calls = r[_key(case)]["decode"]
        assert not [c for c in calls if c[1] == "weight"], calls
        assert calls == sorted([("all-reduce", "embed")]
                               + [("all-reduce", "row")] * 2 * layers
                               + [("all-gather", "unembed")]), calls


@pytest.mark.parametrize("arch", [a for a, *_ in TENANTS])
def test_robustness_layer_on_a_partition(ran, arch):
    """Preemption with swap, and a launch fault armed alike on both ranks
    (undone and demoted alike), give the one-rank engine's tokens; a
    partition refuses fault plans that differ between its ranks, demotion
    after a launch error that no plan injected and resident codes on
    shards; resident weights served whole on each rank give the one-rank
    resident engine's tokens."""
    _, ranks = ran
    for r in _members(ranks, arch):
        robust, one = r["robust"], r["one"]
        assert robust["preempt"] == one["preempt"]
        assert robust["preemptions"] >= 1
        assert robust["fault"] == one["fault"]
        assert robust["demotions"] == 1
        (err,), demotions = robust["unplanned"]
        assert err.startswith("RuntimeError") and "does not demote" in err
        assert demotions == 0
        assert len(robust["refused"]) == 2, robust["refused"]
        assert "different fault plans" in robust["refused"][0]
        assert "replicated" in robust["refused"][1]
        assert robust["resident"] == one["resident"]


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_partition_snapshot_restores_midstream(ran, case):
    """The case's engine snapshotted at step SNAP_AT (after chunk and
    decode steps), restored into a fresh engine on the same partition,
    finishes with the uninterrupted engine's tokens on both ranks."""
    _, ranks = ran
    for r in _members(ranks, case[0]):
        x = r[_key(case)]
        chunks, decodes = x["snapshot"]["steps"]
        assert x["snapshot"]["step"] == SNAP_AT and chunks >= 1 \
            and decodes >= 1
        assert len(x["tokens"]) == 5
        assert x["snapshot"]["tokens"] == x["tokens"]


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_restored_caches_equal_reference_snapshot_shard(ran, case):
    """Each rank's caches just after the restore equal its head shard of
    the reference's snapshot of its engine (under the same sub-mesh) at
    the same step, within 1e-5 at every position a row holds."""
    ref, ranks = ran
    want = ref[case][3]
    h = get_smoke(case[0]).n_kv_heads // 2
    for r in _members(ranks, case[0]):
        got, m = r[_key(case)]["snapshot"]["caches"], r[_key(case)]["model"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            held = _held(w, case[1])
            assert held.sum() >= 20
            for f, a in w.items():
                t = g[f].numpy()
                if f in ("pos", "table"):
                    np.testing.assert_array_equal(t, a)
                    continue
                if case[1]:
                    t = t[:-1]                       # the port's trash block
                np.testing.assert_allclose(
                    np.moveaxis(t, 1, 2)[held].astype(np.float32),
                    np.moveaxis(a[:, m * h:(m + 1) * h], 1, 2)[held]
                    .astype(np.float32), rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("arch", [a for a, *_ in TENANTS])
def test_snapshot_refused_on_another_mesh(ran, arch):
    """A partition's snapshot restores onto the same mesh shape only: onto
    the (2, 1) mesh of the same ranks and onto one rank it is refused on
    both ranks, as are a one-rank snapshot on the partition, a snapshot
    lacking a rank's shard and one whose caches hold other heads."""
    _, ranks = ran
    members = _members(ranks, arch)
    for r in members:
        tall, single, one, lacking, heads = r["refusals"]
        assert "mesh (data=1, model=2)" in tall and \
            "not onto mesh (data=2, model=1)" in tall, tall
        assert "not onto one rank" in single, single
        assert "saved on one rank" in one, one
        assert "lacks the shards of mesh index(es) [1]" in lacking, lacking
        assert "checkpoint shape" in heads or "another rank" in heads, heads
    assert any("checkpoint shape" in r["refusals"][4] for r in members)


@pytest.mark.parametrize("arch", [a for a, *_ in TENANTS])
def test_partition_ttl_on_the_lead_clock(ran, arch):
    """With the ranks' clocks apart in offset and rate, both ranks end the
    same requests TIMEOUT at the same steps, with the same tokens, as the
    one-rank engine on the lead rank's clock; the skewed clock alone would
    expire others."""
    _, ranks = ran
    members = _members(ranks, arch)
    lead = next(r for r in members if "one" in r["ttl"])
    want = lead["ttl"]["one"]["lead"]
    statuses = [s for s, _, _ in want.values()]
    assert sorted(want) == list(range(5))
    assert "TIMEOUT" in statuses and "done" in statuses, want
    assert lead["ttl"]["one"]["skewed"] != want
    for r in members:
        assert r["ttl"]["partition"] == want


@pytest.mark.parametrize("tenant,arch", [("captioning", "olmoe_1b_7b"),
                                         ("classification", "qwen2_1p5b")])
def test_multi_tenant_on_world_equals_reference_launcher(ran, tenant, arch):
    """`--multi-tenant` on 4 ranks: each tenant served on its own (1, 2)
    partition, with the reference launcher's tokens on 4 host devices;
    its ranks agree, the other partition's ranks do not serve it."""
    ref, ranks = ran
    lead = 0 if tenant == "captioning" else 2
    for r in ranks:
        if r["rank"] in (lead, lead + 1):
            assert r["launch"][tenant] == ref["launch/" + tenant]
        else:
            assert tenant not in r["launch"]


@pytest.mark.parametrize("arch", [a for fam in FAMILIES.values()
                                  for a in fam])
def test_other_families_serve_on_a_partition(ran, arch):
    """The other families on a (1, 2) partition give the one-rank engine's
    tokens: attention heads split wherever they divide, MoE experts
    split; the layers with no head-parallel path (xlstm's mLSTM, whisper's
    cross attention) compute whole on every rank, their sharded weights
    all-gathered a call."""
    _, ranks = ran
    tenant = next(t for t, fam in FAMILIES.items() if arch in fam)
    for r in _members(ranks, tenant):
        got, one, sites = r["families"][arch]
        assert got == one and len(got) == 3
        assert {"embed", "row", "unembed"} <= set(sites)
        assert ("weight" in sites) == (arch in REPLICATED), sites


def test_multi_tenant_example_on_the_world(ran):
    """`examples/pt_multi_tenant_serving.py` on the world of 4 ranks: each
    tenant served on its own (1, 2) partition, at once; each partition's
    ranks give the tokens of the tenant served in one process."""
    sys.path.insert(0, EXAMPLES)
    import pt_multi_tenant_serving as example
    _, ranks = ran
    for (name, arch, _), lead in zip(example.TENANTS, (0, 2)):
        done, _ = example.run_tenant(name, arch, device="cpu")
        want = _tokens(done)
        for r in ranks:
            got, out = r["example"]
            if r["rank"] in (lead, lead + 1):
                assert got == {name: want}
            if r["rank"] == 0:
                assert "ran at once on their partitions of ranks" in out
                assert "partition ('captioning',): ranks [0, 1]" in out


def test_moe_capacity_counts_the_whole_launch(ran):
    """On its (1, 2) partition (data 1) olmoe's expert capacity counts
    every position of a launch, as on one rank: 4 slots x the 32-token
    chunk, or x 1 in a decode launch."""
    _, ranks = ran
    for r in ranks:
        want = [4, 128] if r["rank"] in (0, 1) else []
        assert r["capacity_tokens"] == want, r["capacity_tokens"]


def test_partition_lead_prints_its_tenant(ran):
    """Rank 0 of each partition prints its tenant's lines (occupancy,
    tokens), the other ranks none of them; world rank 0 prints the plan."""
    _, ranks = ran
    out = {r["rank"]: r["stdout"] for r in ranks}
    assert ("[serve] fusion plan: 64x128 + 64x128; partitions: "
            "[('captioning',), ('classification',)]; ranks [[0, 1], [2, 3]]"
            ) in out[0]
    for rank, arch, tenant in ((0, "olmoe_1b_7b", "captioning"),
                               (2, "qwen2_1p5b", "classification")):
        assert f"[serve:{arch}] step 1: slots [r0+2 r1+2 r2+2 --]" \
            in out[rank]
        assert f"[serve:{arch}] tokens: r0 " in out[rank]
        assert f"[serve] tenant {tenant}: final 4 slots, 0 busy" in out[rank]
    assert "[serve" not in out[1] + out[3]
    assert "olmoe" not in out[2] and "qwen2" not in out[0]
