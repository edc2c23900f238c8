"""The port's model parallelism (`models/tp_block.py`, the automatic path
of `layers` / `attention`, the expert-parallel MoE) against the JAX
package's, on the CPU, at R = 2 ranks of "model" on a (2, 2) mesh.

* The manual TP+SP block against the reference's `manual_dense_block`
  called directly (under jax 0.9.0 the reference's own gate never lets
  `forward` reach it: ROADMAP C), within 1e-5 in f32: internlm2 SMOKE,
  gemma2 SMOKE's local and global layers (window, softcap, post-norm) and a
  gelu variant of gpt2 SMOKE with n_kv_heads=2.
* The automatic path: the full forward under the mesh equals the
  single-device forward (the port's, and the reference's) on qwen2 and
  llama2 SMOKE, and the forward through manual layers on internlm2,
  gemma2 and kimi SMOKE.
* Expert parallelism against the reference's `_moe_apply_ep` on (2, 2)
  (capacity per DP shard) for olmoe and kimi SMOKE: output and aux, and
  the sequence-sharded variant against the all-reduce one.
* The reference behaviour under jax 0.9.0 that the port does not copy:
  the reference's `manual_tp_ok` is False on an eligible (2, 2) mesh (its
  axis-type test reads "AxisType.Auto" != "Auto") where the port's is
  True, and its manual block raises on qwen2's QKV bias, which the port's
  gate refuses.

Weights are the port's seeded init, carried to JAX by `bridge.params_to_jax`;
the JAX references come from one subprocess with 4 host devices, the port
cases from one gloo world of 4 ranks, side by side."""
import dataclasses
import os
import pickle
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.launch.world import spawn_world
from repro_torch.models import transformer as T

import _xdist_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.timeout(240)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
B, L = 2, 32
TOL = 1e-5


def _gpt2_kv2():
    return dataclasses.replace(get_smoke("gpt2_small"), n_kv_heads=2)


def configs():
    """name -> the port config (the JAX side builds the same by name)."""
    out = {a: get_smoke(a) for a in ("internlm2_20b", "gemma2_27b",
                                     "qwen2_1p5b", "llama2_7b",
                                     "olmoe_1b_7b", "kimi_k2")}
    out["gpt2_kv2"] = _gpt2_kv2()
    return out


# (case, config, layer index, reference segment key, window)
MANUAL = [("internlm2", "internlm2_20b", 0, (0, "0_dense", 0)),
          ("gemma2_local", "gemma2_27b", 0, (0, "0_dense_local", 0)),
          ("gemma2_global", "gemma2_27b", 1, (0, "1_dense_global", 0)),
          ("gpt2_kv2", "gpt2_kv2", 0, (0, "0_dense", 0))]
EP = [("olmoe", "olmoe_1b_7b", 0, (0, "0_moe", 0)),
      ("kimi", "kimi_k2", 1, (1, "0_moe", 0))]
FORWARD = ["qwen2_1p5b", "llama2_7b", "internlm2_20b", "gemma2_27b",
           "kimi_k2"]


def inputs(name, cfg):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return {"x": rng.standard_normal((B, L, cfg.d_model)).astype(np.float32),
            "tokens": rng.randint(0, cfg.vocab, (B, L)).astype(np.int32)}


JAX_CODE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, SRC)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.dist.sharding import set_mesh
from repro.models.layers import QuantPolicy
from repro.models.moe import _moe_apply_ep
from repro.models.tp_block import manual_dense_block, manual_tp_ok
from repro.models.transformer import forward

data = pickle.load(open(IN, "rb"))
cfgs = {a: get_smoke(a) for a in ("internlm2_20b", "gemma2_27b", "qwen2_1p5b",
                                  "llama2_7b", "olmoe_1b_7b", "kimi_k2")}
cfgs["gpt2_kv2"] = dataclasses.replace(get_smoke("gpt2_small"), n_kv_heads=2)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 2)
tree = lambda t: jax.tree.map(jnp.asarray, t)
out = {}

def layer(params, seg):
    s, key, i = seg
    return jax.tree.map(lambda a: a[i], params["segments"][s][key])

for case, arch, _, seg in MANUAL:
    cfg = cfgs[arch]
    p = layer(tree(data["params"][arch]), seg)
    window = cfg.sliding_window if "local" in seg[1] or (
        seg[1] == "0_dense" and cfg.sliding_window) else None
    x = jnp.asarray(data["inputs"][case]["x"])
    with set_mesh(mesh):
        y = jax.jit(lambda p, x: manual_dense_block(
            p, x, cfg, window=window, softcap=cfg.softcap_attn,
            post_norm=cfg.post_norm))(p, x)
    out["manual/" + case] = np.asarray(y)

for case, arch, _, seg in EP:
    cfg = cfgs[arch]
    p = layer(tree(data["params"][arch]), seg)["moe"]
    x = jnp.asarray(data["inputs"][case]["x"])
    with set_mesh(mesh):
        am = jax.sharding.get_abstract_mesh()
        y, aux = jax.jit(lambda p, x: _moe_apply_ep(
            p, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            mesh_info=(("data",), 2, 2, am)))(p, x)
    out["ep/" + case] = (np.asarray(y), float(aux))

for arch in FORWARD:          # per DP shard: MoE capacity is a shard's
    toks = jnp.asarray(data["inputs"]["fwd/" + arch]["tokens"])
    params = tree(data["params"][arch])
    out["forward/" + arch] = np.concatenate(
        [np.asarray(jax.jit(lambda p, t: forward(p, t, cfgs[arch])[0])(
            params, toks[d:d + 1])) for d in range(B)], 0)

x = jnp.zeros((B, L, cfgs["internlm2_20b"].d_model))
with set_mesh(mesh):
    out["gate/internlm2"] = bool(manual_tp_ok(cfgs["internlm2_20b"], x, None,
                                              QuantPolicy()))
    am = jax.sharding.get_abstract_mesh()
    out["axis_types"] = [str(t) for t in am.axis_types]
    try:
        manual_dense_block(layer(tree(data["params"]["qwen2_1p5b"]),
                                 (0, "0_dense", 0)),
                           jnp.zeros((B, L, cfgs["qwen2_1p5b"].d_model)),
                           cfgs["qwen2_1p5b"], window=None, softcap=None,
                           post_norm=False)
        out["qwen2_manual"] = None
    except Exception as e:
        out["qwen2_manual"] = (type(e).__name__, str(e)[:400])
pickle.dump(out, open(OUT, "wb"))
"""


# --------------------------------------------------------------- the world
def _rank_main(rank, world, init):
    import torch.distributed as dist
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.dist.collectives import all_gather, record_collectives
    from repro_torch.dist.sharding import axis_rank, dp_rank
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.moe import _ep_context, _moe_apply_ep
    from repro_torch.models.tp_block import manual_dense_block, manual_tp_ok
    init_world(init_method=init, rank=rank, world_size=world, device="cpu")
    mesh = make_mesh((2, 2))
    d, m = dp_rank(mesh), axis_rank("model", mesh)
    cfgs = configs()
    res = {}

    def rows(a):                     # this DP rank's batch row
        return torch.from_numpy(a)[d:d + 1]

    for case, arch, idx, _ in MANUAL:
        cfg = cfgs[arch]
        model = T.init_params(cfg, device="cpu")
        shard_params(model, mesh)
        x = rows(inputs(case, cfg)["x"]).chunk(2, 1)[m]
        with set_mesh(mesh), torch.no_grad(), record_collectives() as rec:
            y = manual_dense_block(model.layers[idx], x, cfg)
            res["manual/" + case] = all_gather(y, 1, "model")
        res["manual_count/" + case] = sorted(
            (r["kind"], str(r["site"])) for r in rec)
    for case, arch, idx, _ in EP:
        cfg = cfgs[arch]
        model = T.init_params(cfg, device="cpu")
        shard_params(model, mesh)
        x = rows(inputs(case, cfg)["x"])
        moe = model.layers[idx].moe
        with set_mesh(mesh), torch.no_grad():
            ep = _ep_context(x, cfg.n_experts)
            y, aux = _moe_apply_ep(moe, x, ep, seq_sharded=False)
            ys, auxs = _moe_apply_ep(moe, x.chunk(2, 1)[m], ep,
                                     seq_sharded=True)
            res["ep/" + case] = (y, float(aux))
            res["ep_seq/" + case] = (all_gather(ys, 1, "model"), float(auxs))
    for arch in FORWARD:
        cfg = cfgs[arch]
        model = T.init_params(cfg, device="cpu")
        toks = rows(inputs("fwd/" + arch, cfg)["tokens"]).long()
        with torch.no_grad():
            single, _ = T.forward(model, toks)
            shard_params(model, mesh)
            with set_mesh(mesh), record_collectives() as rec:
                logits, _ = T.forward(model, toks)
                res["gate/" + arch] = manual_tp_ok(
                    cfg, torch.zeros(1, L, cfg.d_model), None, cfg.quant,
                    model)
        res["forward/" + arch] = (logits, single)
        res["forward_sites/" + arch] = sorted({str(r["site"]) for r in rec})
    dist.barrier()
    dist.destroy_process_group()
    return {"dp": d, "model": m, **res}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfgs = configs()
    data = {"params": {}, "inputs": {}}
    for arch in {a for _, a, _, _ in MANUAL + EP} | set(FORWARD):
        data["params"][arch] = params_to_jax(
            T.init_params(cfgs[arch], device="cpu"))
    for case, arch, _, _ in MANUAL + EP:
        data["inputs"][case] = inputs(case, cfgs[arch])
    for arch in FORWARD:
        data["inputs"]["fwd/" + arch] = inputs("fwd/" + arch, cfgs[arch])
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    code = (f"SRC = {SRC!r}; IN = {str(tmp / 'in.pkl')!r}; "
            f"OUT = {str(tmp / 'out.pkl')!r}; B, L = {B}, {L}; "
            f"MANUAL = {MANUAL!r}; EP = {EP!r}; FORWARD = {FORWARD!r}\n"
            + JAX_CODE)
    jax_proc = subprocess.Popen([sys.executable, "-c", code],
                                env=dict(os.environ, PYTHONPATH=SRC),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_world(4, "test_torch_tp:_rank_main",
                            sys_path=[HERE, SRC], timeout=600)
        log, _ = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, log[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    # rows of the global batch from the model-rank-0 rank of each DP rank
    lead = sorted((r for r in ranks if r["model"] == 0),
                  key=lambda r: r["dp"])
    return ref, ranks, lead


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _rows(lead, key, i=None):
    return np.concatenate([np.asarray(r[key] if i is None else r[key][i])
                           for r in lead], 0)


@pytest.mark.parametrize("case", [c for c, *_ in MANUAL])
def test_manual_block_matches_reference(ran, case):
    ref, _, lead = ran
    _close(_rows(lead, "manual/" + case), ref["manual/" + case])


@pytest.mark.parametrize("case", [c for c, *_ in MANUAL])
def test_manual_block_makes_two_gathers_and_two_scatters(ran, case):
    _, ranks, _ = ran
    for r in ranks:
        sites = [k for k in r["manual_count/" + case]
                 if k[1] == "tp_block.seq"]
        assert sorted(sites) == [("all-gather", "tp_block.seq")] * 2 + [
            ("reduce-scatter", "tp_block.seq")] * 2, r["manual_count/" + case]


@pytest.mark.parametrize("case", [c for c, *_ in EP])
def test_expert_parallel_matches_reference(ran, case):
    ref, ranks, lead = ran
    want, want_aux = ref["ep/" + case]
    _close(_rows(lead, "ep/" + case, 0), want)
    for r in ranks:
        assert abs(r["ep/" + case][1] - want_aux) <= TOL * max(1, want_aux)


@pytest.mark.parametrize("case", [c for c, *_ in EP])
def test_expert_parallel_sequence_sharded_variant(ran, case):
    _, ranks, _ = ran
    for r in ranks:
        y, aux = r["ep/" + case]
        ys, auxs = r["ep_seq/" + case]
        _close(ys, y, 1e-6)
        assert aux == auxs


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_under_mesh_equals_single_device(ran, arch):
    ref, ranks, lead = ran
    for r in ranks:
        logits, single = r["forward/" + arch]
        _close(logits, single)
    _close(_rows(lead, "forward/" + arch, 0), ref["forward/" + arch])


def test_automatic_and_manual_paths_are_taken(ran):
    _, ranks, _ = ran
    for r in ranks:
        for arch in ("qwen2_1p5b", "llama2_7b"):    # automatic
            assert not r["gate/" + arch]
            assert "row" in r["forward_sites/" + arch]
            assert "tp_block.seq" not in r["forward_sites/" + arch]
        for arch in ("internlm2_20b", "gemma2_27b", "kimi_k2"):
            assert r["gate/" + arch]
            assert "tp_block.seq" in r["forward_sites/" + arch]
        assert "moe.seq" in r["forward_sites/kimi_k2"]
        assert {"embed", "unembed"} <= set(r["forward_sites/qwen2_1p5b"])


def test_reference_gate_never_fires_under_installed_jax(ran):
    """ROADMAP C, reference behaviour under jax 0.9.0: its `manual_tp_ok`
    compares str(axis_type) with "Auto", and the installed jax prints
    "AxisType.Auto", so an eligible (2, 2) mesh gets False; the port's
    gate, the rule as written, says True."""
    ref, ranks, _ = ran
    assert ref["axis_types"] == ["AxisType.Auto"] * 2
    assert ref["gate/internlm2"] is False
    assert all(r["gate/internlm2_20b"] for r in ranks)


def test_reference_manual_block_raises_on_qkv_bias(ran):
    """ROADMAP C, a reference fault the port refuses to copy: the
    reference's manual block gives q/k/v only a weight, so a qwen2 block
    (QKV bias) fails in its shard_map; the port's gate refuses qwen2 and
    the automatic path serves it (the forward test above)."""
    ref, ranks, _ = ran
    assert ref["qwen2_manual"] is not None, "the reference block ran"
    assert not any(r["gate/qwen2_1p5b"] for r in ranks)
