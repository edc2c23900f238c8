"""The port's data parallelism, compressed gradients, trainer over a mesh,
elastic re-mesh, launcher and dry-run against the JAX package's, on the
CPU.

* `optim.grad_compress.compressed_psum` and `_roundtrip` bitwise equal to
  the reference's (under shard_map over 2 or 4 host devices): int8 at
  worlds 2 and 4, fp8a and fp8b at world 2.
* `launch.steps_compressed.make_compressed_train_step` (int8, world 4)
  against the reference composed from its parts (its own
  `make_compressed_train_step` raises under jax 0.9.0: ROADMAP C): each
  step's per-shard gradients within 1e-4 of `jax.value_and_grad(loss_fn)`
  on the same shard (the port's gradient tolerance), and the step (the reference's `compressed_psum` under
  shard_map on the port's per-shard gradients, the error feedback, the
  cosine schedule, `adamw_update`) within 1e-5; the ranks' params bitwise
  equal after every step.
* The plain-DP `Trainer` on mesh (2, 1) against the reference's Trainer
  (its jitted `make_train_step`, the batch sharded over a (2, 1) host
  mesh): equal losses within 1e-5; on (2, 2) (DP x TP) too.
* `elastic_restart` from (2, 1) to (1, 2): the resumed losses equal an
  uninterrupted run's. A Trainer on a (1, 2) sub-mesh of ranks 2 and 3
  (no world rank 0): its first rank writes the checkpoint, and a new
  Trainer there resumes from it with the same losses.
* `launch.train --model-parallel 2` on a world of 4: 2 steps with the
  single-device launcher's losses.
* The dry-run of one small cell (internlm2 SMOKE, train_4k cut to batch 8
  x seq 64) on meshes (2, 4) and (4, 2): FLOPs > 0, exactly 2 all-gathers
  and 2 reduce-scatters a manual layer a pass, and `collective_bytes`,
  `model_flops` and `probe_pair` equal the reference's on the same
  inputs.

The port cases run in one gloo world of 4 ranks (the 2-rank meshes over
ranks 0 and 1); then one JAX subprocess with 4 host devices computes the
references, some from the port's per-shard gradients."""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_jax
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke
from repro_torch.dist.sharding import ShapeMesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as launcher
from repro_torch.launch.world import spawn_world
from repro_torch.models import transformer as T

import _xdist_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.timeout(240)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ARCH = "olmo_1b"
GB, L = 4, 16                    # global batch, sequence
STEPS = 3
SCHED = dict(warmup=2, total=10)
PSUM_CASES = [("int8", 4), ("int8", 2), ("fp8a", 2), ("fp8b", 2)]
TOL = 1e-5


def batches(n=4, seed=3):
    rng = np.random.RandomState(seed)
    vocab = get_smoke(ARCH).vocab
    return [{"tokens": rng.randint(0, vocab, (GB, L)).astype(np.int32),
             "labels": rng.randint(0, vocab, (GB, L)).astype(np.int32)}
            for _ in range(n)]


def psum_inputs(world, seed):
    """One (37, 29) f32 array a rank: normals at mixed magnitudes, a zero
    row, and ties at the scale's half steps."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(world):
        x = rng.standard_normal((37, 29)) * 10.0 ** rng.uniform(-3, 1,
                                                                (37, 1))
        x[5] = 0.0
        x[6, :8] = np.arange(8) - 3.5
        out.append(x.astype(np.float32))
    return out


# --------------------------------------------------------------- the world
def _rank_main(rank, world, init, ckpt):
    import torch.distributed as dist
    from repro_torch.bridge import grads_to_jax
    from repro_torch.core import formats as F
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.launch.steps_compressed import make_compressed_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.grad_compress import (_roundtrip,
                                                 compressed_grad_allreduce,
                                                 compressed_psum,
                                                 init_error_state)
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.trainer import elastic_restart
    init_world(init_method=init, rank=rank, world_size=world, device="cpu")
    cfg = get_smoke(ARCH)
    res = {}
    m41 = make_mesh((4, 1))
    m22 = make_mesh((2, 2))
    m21 = make_mesh((2, 1), ranks=[0, 1])
    m12 = make_mesh((1, 2), ranks=[0, 1])
    m12_far = make_mesh((1, 2), ranks=[2, 3])     # holds no world rank 0
    in_pair = rank < 2

    # ---- compressed_psum / _roundtrip
    for fmt_name, n in PSUM_CASES:
        if n == 2 and not in_pair:
            continue
        x = torch.from_numpy(psum_inputs(n, 11)[rank])
        with set_mesh(m41 if n == 4 else m21):
            s = compressed_psum(x, ("data",), F.REGISTRY[fmt_name])
        res[f"psum/{fmt_name}/{n}"] = (s, _roundtrip(x, F.REGISTRY[fmt_name]))
        if (fmt_name, n) == ("int8", 4):
            res["allreduce"] = compressed_grad_allreduce(
                [x], init_error_state([x]), m41, fmt_name="int8")

    # ---- the compressed step, world 4 (DP 4)
    model = T.init_params(cfg, device="cpu").trainable_()
    shard_params(model, m41)
    opt = adamw_init(list(model.parameters()))
    err = init_error_state(list(model.parameters()))
    step = make_compressed_train_step(cfg, m41, fmt_name="int8", **SCHED)
    res["compressed"] = []
    for b in batches()[:STEPS]:
        m = step(model, opt, err, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        params = [p.detach().clone() for p in model.parameters()]
        every = [[torch.empty_like(p) for _ in range(world)] for p in params]
        for p, e in zip(params, every):
            dist.all_gather(e, p)
        same = all(torch.equal(e[0], x) for e in every for x in e)
        res["compressed"].append({
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": grads_to_jax(model), "params": params_to_jax(model),
            "same": same})

    # ---- the plain-DP Trainer: (2, 1) and (2, 2); elastic (2, 1) -> (1, 2)
    tc = dict(warmup=SCHED["warmup"], total_steps=SCHED["total"],
              ckpt_every=10**9)
    if in_pair:
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/p21", **tc),
                     seed=0, device="cpu", mesh=m21)
        tr.run(iter(batches()), 4)
        res["trainer21"] = [x["loss"] for x in tr.metrics_log]
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/el", **tc),
                     seed=0, device="cpu", mesh=m21)
        tr.run(iter(batches()[:2]), 2)
        tr.checkpoint(2)
        tr.wait()
        tr2 = elastic_restart(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/el", **tc),
                              m12, device="cpu")
        res["elastic_step"] = int(tr2.opt_state.step)
        tr2.run(iter(batches()[2:]), 2)
        res["elastic"] = [x["loss"] for x in tr.metrics_log] + \
            [x["loss"] for x in tr2.metrics_log]
        res["elastic_shard"] = tuple(tr2.model.layers[0].attn.q.w.shape)
    else:
        # a Trainer on a sub-mesh without world rank 0: its first rank
        # writes the checkpoint, and a new Trainer there resumes from it
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/far", **tc),
                     seed=0, device="cpu", mesh=m12_far)
        tr.run(iter(batches()[:2]), 2)
        tr.checkpoint(2)
        tr.wait()
        tr2 = elastic_restart(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/far",
                                                 **tc), m12_far, device="cpu")
        resumed = int(tr2.opt_state.step)
        tr2.run(iter(batches()[2:]), 2)
        res["far"] = {"writer": tr.writer, "step": resumed,
                      "losses": [x["loss"] for x in tr.metrics_log]
                      + [x["loss"] for x in tr2.metrics_log]}
    dist.barrier()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=f"{ckpt}/p22", **tc), seed=0,
                 device="cpu", mesh=m22)
    tr.run(iter(batches()), 4)
    res["trainer22"] = [x["loss"] for x in tr.metrics_log]

    # ---- the launcher, --model-parallel 2 on the world of 4
    dist.barrier()
    tr = launcher.main(["--arch", ARCH, "--smoke", "--steps", "2",
                        "--batch", "4", "--seq", "16", "--device", "cpu",
                        "--model-parallel", "2", "--ckpt-dir",
                        f"{ckpt}/launch"])
    res["launcher"] = ([x["loss"] for x in tr.metrics_log],
                       tuple(tr.mesh.shape), int(tr.opt_state.step))
    dist.barrier()
    dist.destroy_process_group()
    return res


JAX_CODE = r"""
import os, sys, pickle, functools
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, SRC)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import ARCH_IDS, SHAPES, get_config, get_smoke
from repro.core import formats as F
from repro.launch import dryrun as D
from repro.launch.steps import params_shapes
from repro.models import transformer as T
from repro.optim import adamw_init, adamw_update, cosine_schedule
from repro.optim.grad_compress import _roundtrip, compressed_psum
from repro.runtime import Trainer, TrainerConfig

data = pickle.load(open(IN, "rb"))
out = {}
auto = (jax.sharding.AxisType.Auto,)
def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",), axis_types=auto)

def psum(stack, fmt):
    n = stack.shape[0]
    f = jax.shard_map(lambda x: compressed_psum(x[0], "data", fmt)[None],
                      mesh=mesh(n), in_specs=P("data"), out_specs=P("data"),
                      check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(stack)))

for (fmt_name, n), xs in data["psum"].items():
    fmt = F.REGISTRY[fmt_name]
    s = psum(np.stack(xs), fmt)
    out[("psum", fmt_name, n)] = (s, [np.asarray(_roundtrip(jnp.asarray(x), fmt))
                                      for x in xs])

# the compressed step composed from its parts, on the port's shard grads
cfg = get_smoke(ARCH)
fmt = F.REGISTRY["int8"]
params = jax.tree.map(jnp.asarray, data["params0"])
opt = adamw_init(params)
err = [jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
       for _ in range(4)]
vg = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                has_aux=True))
comp = []
for t, b in enumerate(data["batches"][:STEPS]):
    shard_grads, losses = [], []
    for r in range(4):
        sb = {k: jnp.asarray(v[r:r + 1]) for k, v in b.items()}
        (_, m), g = vg(params, sb)
        shard_grads.append(jax.tree.map(np.asarray, g))
        losses.append(float(m["loss"]))
    port_grads = data["grads"][t]          # [rank] -> tree
    xs = [jax.tree.map(lambda g, e: jnp.asarray(g, jnp.float32) + e, g, e)
          for g, e in zip(port_grads, err)]
    flat = [jax.tree.leaves(x) for x in xs]
    tdef = jax.tree.structure(xs[0])
    summed = [psum(np.stack([f[i] for f in flat]), fmt)[0]
              for i in range(len(flat[0]))]
    mean = jax.tree.unflatten(tdef, [jnp.asarray(s) / 4 for s in summed])
    err = [jax.tree.map(lambda x: x - _roundtrip(x, fmt), x) for x in xs]
    lr = cosine_schedule(opt.step, base_lr=3e-4, **SCHED)
    params, opt, gnorm = adamw_update(mean, opt, params, lr=lr)
    comp.append({"loss": float(np.mean(losses)), "shard_grads": shard_grads,
                 "grad_norm": float(gnorm),
                 "params": jax.tree.map(np.asarray, params)})
out["compressed"] = comp

# the plain-DP Trainer on a (2, 1) host mesh, 4 steps
m21 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"),
           axis_types=auto * 2)
tr = Trainer(cfg, TrainerConfig(ckpt_dir=CKPT, warmup=SCHED["warmup"],
                                total_steps=SCHED["total"], ckpt_every=10**9),
             m21, params=jax.tree.map(jnp.asarray, data["params0"]))
tr.run(iter([{k: np.asarray(v) for k, v in b.items()}
             for b in data["batches"]]), 4)
out["trainer21"] = [m["loss"] for m in tr.metrics_log]

# the dry-run's pure functions on the same inputs
dry = {}
for key, lines in data["hlo"].items():
    dry[key] = D.collective_bytes("\n".join(lines))
icfg = get_smoke("internlm2_20b")
p = params_shapes(icfg, jnp.float32)
n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(p))
cell = SHAPES["train_4k"].__class__("train_4k", "train", 64, 8)
dry["model_flops"] = D.model_flops(icfg, n, D._active_params(p, icfg), cell)
dry["n_params"] = n
dry["probe"] = {}
for arch in ARCH_IDS:
    for name, c in (("smoke", get_smoke(arch)), ("config", get_config(arch))):
        a, b, mult = D.probe_pair(c)
        dry["probe"][(arch, name)] = (a.n_layers, b.n_layers, mult)
ocfg = get_smoke("olmoe_1b_7b")
po = params_shapes(ocfg, jnp.float32)
dry["olmoe_active"] = D._active_params(po, ocfg)
out["dry"] = dry
pickle.dump(out, open(OUT, "wb"))
"""

_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int32: "s32", torch.float16: "f16"}


def hlo_lines(records):
    """The recorded calls as lines of a compiled SPMD module, the way the
    reference's `collective_bytes` parses them."""
    out = []
    for i, r in enumerate(records):
        dims = ",".join(str(d) for d in r["shape"])
        out.append(f"  %c{i} = {_HLO_DTYPE[r['dtype']]}[{dims}]{{0}} "
                   f"{r['kind']}(f32[1]{{0}} %p{i}), replica_groups="
                   f"[{8 // r['group']},{r['group']}]<=[8]")
    return out


CELL = dataclasses.replace(SHAPES["train_4k"], batch=8, seq=64)
DRY_MESHES = {"2x4": (2, 4), "4x2": (4, 2)}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg = get_smoke("internlm2_20b")
    dry = {name: (D.lower_cell("internlm2_20b", "train_4k", False,
                               cfg_override=cfg, cell=CELL,
                               mesh=ShapeMesh(shape, ("data", "model"))),
                  D.run_step(cfg, CELL, ShapeMesh(shape, ("data", "model"))))
           for name, shape in DRY_MESHES.items()}
    ranks = spawn_world(4, "test_torch_dp:_rank_main", args=(str(tmp),),
                        sys_path=[HERE, SRC], timeout=600)
    single = launcher.main(["--arch", ARCH, "--smoke", "--steps", "2",
                            "--batch", "4", "--seq", "16", "--device", "cpu",
                            "--ckpt-dir", str(tmp / "single")])
    data = {"psum": {(f, n): psum_inputs(n, 11) for f, n in PSUM_CASES},
            "params0": params_to_jax(T.init_params(get_smoke(ARCH),
                                                   device="cpu")),
            "batches": batches(),
            "grads": [[r["compressed"][t]["grads"] for r in ranks]
                      for t in range(STEPS)],
            "hlo": {name: hlo_lines(run["records"])
                    for name, (_, run) in dry.items()}}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    code = (f"SRC = {SRC!r}; IN = {str(tmp / 'in.pkl')!r}; "
            f"OUT = {str(tmp / 'out.pkl')!r}; ARCH = {ARCH!r}; "
            f"STEPS = {STEPS}; SCHED = {SCHED!r}; "
            f"CKPT = {str(tmp / 'jax_ckpt')!r}\n" + JAX_CODE)
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, ranks, dry, single


def _close_tree(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k], tol)
        return
    if isinstance(want, list):
        for g, w in zip(got, want):
            _close_tree(g, w, tol)
        return
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


@pytest.mark.parametrize("fmt_name,n", PSUM_CASES)
def test_compressed_psum_and_roundtrip_bitwise(ran, fmt_name, n):
    ref, ranks, _, _ = ran
    want_sum, want_rt = ref[("psum", fmt_name, n)]
    for r in range(n):
        s, rt = ranks[r][f"psum/{fmt_name}/{n}"]
        np.testing.assert_array_equal(s.numpy(), want_sum[r])
        np.testing.assert_array_equal(rt.numpy(), want_rt[r])


def test_compressed_grad_allreduce_is_the_mean_with_error_feedback(ran):
    ref, ranks, _, _ = ran
    want_sum, want_rt = ref[("psum", "int8", 4)]
    xs = psum_inputs(4, 11)
    for r in range(4):
        (g,), (e,) = ranks[r]["allreduce"]
        np.testing.assert_array_equal(g.numpy(), want_sum[r] / 4)
        np.testing.assert_array_equal(e.numpy(), xs[r] - want_rt[r])


def test_compressed_step_shard_gradients_match_jax(ran):
    ref, ranks, _, _ = ran
    for t in range(STEPS):
        for r in range(4):
            _close_tree(ranks[r]["compressed"][t]["grads"],
                        ref["compressed"][t]["shard_grads"][r], 1e-4)


def test_compressed_step_matches_composed_reference(ran):
    ref, ranks, _, _ = ran
    for t in range(STEPS):
        got, want = ranks[0]["compressed"][t], ref["compressed"][t]
        _close_tree(got["params"], want["params"])
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            TOL * want["grad_norm"]


def test_compressed_step_keeps_ranks_bitwise_equal(ran):
    _, ranks, _, _ = ran
    assert all(s["same"] for r in ranks for s in r["compressed"])


@pytest.mark.parametrize("key", ["trainer21", "trainer22", "elastic"])
def test_trainer_over_mesh_matches_reference_trainer(ran, key):
    ref, ranks, _, _ = ran
    want = ref["trainer21"]
    holders = ranks[:2] if key != "trainer22" else ranks
    for r in holders:
        got = r[key]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert abs(g - w) <= TOL * abs(w), (key, got, want)


def test_elastic_restart_resumes_on_the_new_mesh(ran):
    _, ranks, _, _ = ran
    for r in ranks[:2]:
        assert r["elastic_step"] == 2
        cfg = get_smoke(ARCH)
        assert r["elastic_shard"] == (cfg.d_model, cfg.n_heads * cfg.hd // 2)


def test_trainer_on_a_sub_mesh_without_world_rank_0_resumes(ran):
    ref, ranks, _, _ = ran
    want = ref["trainer21"]
    assert [r["far"]["writer"] for r in ranks[2:]] == [True, False]
    for r in ranks[2:]:
        got = r["far"]
        assert got["step"] == 2
        for g, w in zip(got["losses"], want):
            assert abs(g - w) <= TOL * abs(w), (got["losses"], want)


def test_launcher_model_parallel_matches_single_device(ran):
    _, ranks, _, single = ran
    want = [x["loss"] for x in single.metrics_log]
    for r in ranks:
        losses, mesh, step = r["launcher"]
        assert mesh == (2, 2) and step == 2
        for g, w in zip(losses, want):
            assert abs(g - w) <= TOL * abs(w), (losses, want)


def test_dryrun_small_cell_records(ran):
    _, _, dry, _ = ran
    for name, (rec, _) in dry.items():
        assert rec["flops"] > 0 and rec["model_flops"] > 0
        assert rec["flops_probe"] == pytest.approx(rec["flops"], rel=1e-9)
        assert rec["chips"] == 8 and "not XLA" in rec["counts_from"]
        b = rec["bytes_per_rank"]
        assert b["params"] > 0 and b["opt_state"] > 0 and b["batch"] > 0


def test_dryrun_manual_layers_make_two_gathers_and_two_scatters(ran):
    """internlm2 SMOKE has 6 heads: at R = 4 (mesh (2, 4)) no layer is
    eligible (6 % 4), at R = 2 (mesh (4, 2)) both are."""
    _, _, dry, _ = ran
    cfg = get_smoke("internlm2_20b")
    assert "tp_block.seq" not in dry["2x4"][0]["collective_sites"]
    sites = dry["4x2"][0]["collective_sites"]["tp_block.seq"]
    n = cfg.n_layers
    assert sites == {"all-gather forward": 2 * n,
                     "reduce-scatter forward": 2 * n,
                     "reduce-scatter backward": 2 * n,
                     "all-gather backward": 2 * n}


def test_dryrun_collective_bytes_model_flops_probe_equal_reference(ran):
    ref, _, dry, _ = ran
    for name, (rec, run) in dry.items():
        want = ref["dry"][name]
        got = run["coll"]
        assert got["counts"] == want["counts"]
        for k in want:
            if k != "counts":
                assert got[k] == pytest.approx(want[k], rel=1e-12), k
        assert rec["model_flops"] == ref["dry"]["model_flops"]
        assert rec["n_params"] == ref["dry"]["n_params"]
    for arch in ARCH_IDS:
        for name, c in (("smoke", get_smoke(arch)),
                        ("config", get_config(arch))):
            a, b, mult = D.probe_pair(c)
            assert (a.n_layers, b.n_layers, mult) == \
                ref["dry"]["probe"][(arch, name)]
    from repro_torch.dist.specs import param_tree
    tree = param_tree(T.Transformer(get_smoke("olmoe_1b_7b"), device="meta"))
    assert D._active_params(tree, get_smoke("olmoe_1b_7b")) == \
        ref["dry"]["olmoe_active"]


def test_dryrun_cli_writes_a_record(tmp_path, monkeypatch):
    """The CLI over one cell of a cut-down production mesh (the full
    (16, 16) cell is the same code at 256 ranks)."""
    import json
    monkeypatch.setattr(D, "get_config", get_smoke)
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False: ShapeMesh(
                            (2, 2, 2) if multi_pod else (2, 2),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model")))
    monkeypatch.setattr(D, "SHAPES", {"train_4k": CELL})
    D.main(["--arch", "qwen2_1p5b", "--shape", "train_4k", "--out",
            str(tmp_path), "--both-meshes"])
    single = json.loads((tmp_path / "qwen2_1p5b__train_4k__single.json")
                        .read_text())
    multi = json.loads((tmp_path / "qwen2_1p5b__train_4k__multi.json")
                       .read_text())
    assert single["flops"] > 0 and "probe" in single
    assert multi["mesh"] == "2x2x2" and multi["dp"] == 4
