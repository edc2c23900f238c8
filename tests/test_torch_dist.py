"""The port's distribution layer (`repro_torch.dist`, `launch.mesh`) against
the JAX package's, on the CPU.

* Every test of `tests/test_dist.py`, mirrored on a gloo world of 4 ranks
  (the spec functions, the ambient mesh, `constrain` on DTensors).
* The placements equal the reference's `PartitionSpec`s leaf for leaf: the
  params of all twelve SMOKE configs on meshes (1, 1), (2, 2) and (1, 4),
  and the stacked caches and a batch on (2, 2).
* The collectives over one mesh axis (values, the exact-adjoint gradients,
  the host-buffer transport of bf16 and int32, the records), the meshes
  of `launch.mesh`, and `shard_params` on a ShapeMesh.

The JAX references come from one subprocess with 4 host devices; the port
cases run in one gloo world (`launch.world.spawn_world`, file
rendezvous)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.dist import ShapeMesh, cache_specs, param_specs
from repro_torch.dist.specs import Placements, param_tree, shard_params
from repro_torch.launch.world import spawn_world
from repro_torch.models import transformer as T

import _xdist_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.timeout(240)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "1x4": (1, 4)}

JAX_CODE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, SRC)
import numpy as np, jax
from jax.sharding import Mesh
from jax.tree_util import DictKey, GetAttrKey, SequenceKey, tree_flatten_with_path
from repro.configs import ARCH_IDS, get_smoke
from repro.dist import batch_specs, cache_specs, param_specs
from repro.models.transformer import init_caches, init_params

def mesh(shape):
    n = int(np.prod(shape))
    types = (jax.sharding.AxisType.Auto,) * 2
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"),
                axis_types=types)

def key(path):
    out = []
    for k in path:
        if isinstance(k, DictKey): out.append(str(k.key))
        elif isinstance(k, SequenceKey): out.append(str(k.idx))
        elif isinstance(k, GetAttrKey): out.append(k.name)
    return "/".join(out)

def flat(tree, specs):
    leaves = tree_flatten_with_path(tree)[0]
    return {key(p): [list(x.shape), list(s.spec) + [None] * (x.ndim - len(s.spec))]
            for (p, x), s in zip(leaves, jax.tree.leaves(specs))}

out = {"params": {}}
for arch in ARCH_IDS:
    cfg = get_smoke(arch)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.key(0))
    out["params"][arch] = {m: flat(shapes, param_specs(shapes, mesh(s)))
                           for m, s in MESHES.items()}
cfg = get_smoke("qwen2_1p5b")
caches = jax.eval_shape(lambda: init_caches(cfg, batch=4, max_len=16))
out["caches"] = flat(caches, cache_specs(caches, mesh((2, 2))))
batch = {"tokens": jax.ShapeDtypeStruct((4, 16), np.int32),
         "labels": jax.ShapeDtypeStruct((3, 16), np.int32)}
out["batch"] = flat(batch, batch_specs(batch, mesh((2, 2))))
json.dump(out, open(OUT, "w"))
"""


# --------------------------------------------------------------- the world
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rank_main(rank, world, init):
    """Every port case on this rank; returns {case: result}."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.dist import (batch_specs, constrain, ctx_dp_axes,
                                  opt_state_specs, param_specs, set_mesh)
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import axis_rank, dp_rank, dp_size
    from repro_torch.launch.mesh import (init_world, make_local_mesh,
                                         make_mesh)
    from repro_torch.optim import AdamWState, adamw_init
    res = {}
    res["world"] = init_world(init_method=init, rank=rank, world_size=world,
                              device="cpu")
    res["world_again"] = init_world(device="cpu")     # reuses the group
    mesh = make_local_mesh()                         # (4, 1)
    m22, m14 = make_mesh((2, 2)), make_local_mesh(model=4)
    res["meshes"] = [(tuple(m.shape), tuple(m.mesh_dim_names))
                     for m in (mesh, m22, m14)]
    res["coords"] = (dp_rank(m22), axis_rank("model", m22), dp_size(m22))

    # ---- the mirror of tests/test_dist.py
    tree = {"embed": {"table": _meta((256, 32))},
            "attn": {"q": {"w": _meta((32, 64))},
                     "o": {"w": _meta((64, 32))}}}
    specs = param_specs(tree, mesh)
    res["tree_structure"] = (
        set(specs) == set(tree) and set(specs["attn"]) == {"q", "o"}
        and all(isinstance(s, Placements) and len(s) == 2 for s in
                (specs["embed"]["table"], specs["attn"]["q"]["w"],
                 specs["attn"]["o"]["w"])))
    params = {"w": torch.ones(8, 8), "b": torch.zeros(8)}
    ps = param_specs(params, mesh)
    placed = {k: distribute_tensor(v, mesh, list(ps[k]))
              for k, v in params.items()}
    res["roundtrip"] = bool(torch.equal(placed["w"].full_tensor(),
                                        torch.ones(8, 8)))
    opt = AdamWState(step=_meta((), torch.int32), mu={"w": _meta((4, 4))},
                     nu={"w": _meta((4, 4))}, master={"w": _meta((4, 4))})
    os_ = opt_state_specs(opt, mesh)
    real = adamw_init([torch.ones(4, 4)])
    res["opt_specs"] = (type(os_).__name__, isinstance(os_.mu["w"],
                                                       Placements),
                        int(real.step))
    batch = {"tokens": _meta((8, 16), torch.int32),
             "labels": _meta((8, 16), torch.int32)}
    bs = batch_specs(batch, mesh)
    res["batch_specs"] = (set(bs), [tuple(type(p).__name__ for p in s)
                                    for s in bs.values()],
                          bs["tokens"][0].dim)
    caches = [{"0_dense": {"k": _meta((2, 4, 1, 8, 16), torch.bfloat16),
                           "pos": _meta((2,), torch.int32)},
               "1_none": None}]
    cs = cache_specs(caches, mesh)
    res["cache_none"] = (cs[0]["1_none"] is None,
                         isinstance(cs[0]["0_dense"]["pos"], Placements),
                         cs[0]["0_dense"]["k"][0].dim)
    res["dp_axes_outside"] = ctx_dp_axes()
    with set_mesh(mesh):
        res["dp_axes_inside"] = ctx_dp_axes()
    res["dp_axes_after"] = ctx_dp_axes()
    x = torch.ones(4, 4)
    res["constrain_noop"] = constrain(x, "model", None) is x
    d = distribute_tensor(torch.ones(4, 4), m22, [Replicate(), Replicate()])
    with set_mesh(m22):
        y = constrain(d, ("data",), "model")
        z = constrain(d, ("pod", "data"), "nonexistent")
        res["constrain_plain"] = constrain(x, ("data",), "model") is x
    res["constrain"] = (isinstance(y, DTensor), tuple(y.placements) ==
                        (Shard(0), Shard(1)),
                        bool(torch.equal(y.full_tensor(), torch.ones(4, 4))),
                        tuple(y.to_local().shape))
    res["constrain_drop"] = (tuple(z.placements) == (Shard(0), Replicate()),
                             bool(torch.equal(z.full_tensor(),
                                              torch.ones(4, 4))))

    # ---- collectives over one mesh axis
    g = torch.Generator().manual_seed(rank)
    a = torch.randn(3, 4, 5, generator=g)
    every = [torch.empty_like(a) for _ in range(world)]
    dist.all_gather(every, a)
    res["every"] = every
    with set_mesh(m14), C.record_collectives() as rec:
        res["ag1"] = C.all_gather(a, 1, "model")
        res["ag0"] = C.all_gather(a, 0, "model", site="s")
        res["rs"] = C.reduce_scatter(torch.cat([a] * 4, 2), 2, "model")
        res["ar_sum"] = C.all_reduce(a, "model")
        res["ar_max"] = C.all_reduce(a, "model", "max")
        res["ar_data"] = C.all_reduce(a, "data")      # an axis of one rank
        res["bf16"] = C.all_reduce(a.to(torch.bfloat16), "model")
        res["int32"] = C.all_reduce((a * 100).to(torch.int32), "model")
        res["split"] = C.seq_split(torch.arange(8.0)[None], 1, "model")
    res["records"] = [(r["kind"], r["shape"], str(r["dtype"]), r["group"],
                       r["site"], r["phase"]) for r in rec]
    with set_mesh(m22):
        res["ar_two_axes"] = C.all_reduce(a, ("data", "model"))
    # gradients: the exact adjoints
    w = a.clone().requires_grad_(True)
    with set_mesh(m14):
        gath = C.all_gather(w, 1, "model")
        (gath * torch.arange(16.0)[None, :, None]).sum().backward()
        res["ag_grad"] = w.grad.clone()
        w.grad = None
        C.reduce_scatter(w, 1, "model").pow(2).sum().backward()
        res["rs_grad"] = w.grad.clone()
        w.grad = None
        (C.all_reduce(w, "model") * (rank + 1)).sum().backward()
        res["ar_grad"] = w.grad.clone()
    dist.barrier()
    dist.destroy_process_group()
    return res


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """(JAX reference dict, per-rank port results): the JAX subprocess and
    the gloo world run side by side."""
    out = str(tmp_path_factory.mktemp("dist") / "ref.json")
    code = f"SRC = {SRC!r}; OUT = {out!r}; MESHES = {MESHES!r}\n" + JAX_CODE
    env = dict(os.environ, PYTHONPATH=SRC)
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_world(4, "test_torch_dist:_rank_main",
                            sys_path=[HERE, SRC], timeout=600)
        log, _ = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, log[-3000:]
    with open(out) as f:
        return json.load(f), ranks


def _entries(placements, mesh_names, ndim):
    """Placements back to a positional spec: tensor dim -> the mesh axes
    sharding it (as a list), None where none does."""
    ent = [None] * ndim
    for name, pl in zip(mesh_names, placements):
        if hasattr(pl, "dim"):
            ent[pl.dim] = (ent[pl.dim] or []) + [name]
    return ent


def _norm(entry):
    if entry is None:
        return None
    return [entry] if isinstance(entry, str) else list(entry)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


# ----------------------------------------------------- placements vs JAX
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_equal_reference_leaf_for_leaf(ran, arch):
    ref, _ = ran
    tree = param_tree(T.Transformer(get_smoke(arch), device="meta"))
    for mname, shape in MESHES.items():
        mesh = ShapeMesh(shape, ("data", "model"))
        flat_t = _flat(tree)
        flat_s = _flat(param_specs(tree, mesh))
        want = ref["params"][arch][mname]
        assert set(flat_t) == set(want), (mname, set(flat_t) ^ set(want))
        for path, (wshape, wspec) in want.items():
            assert list(flat_t[path].shape) == wshape, (path, wshape)
            got = _entries(flat_s[path], mesh.mesh_dim_names, len(wshape))
            assert got == [_norm(e) for e in wspec], (mname, path, got,
                                                      wspec)


def test_stacked_cache_and_batch_placements_equal_reference(ran):
    ref, _ = ran
    mesh = ShapeMesh((2, 2), ("data", "model"))
    for kind in ("caches", "batch"):
        want = ref[kind]
        tree = {p: _meta(s) for p, (s, _) in want.items()}
        if kind == "caches":
            specs = cache_specs(tree, mesh)
        else:
            from repro_torch.dist import batch_specs
            specs = batch_specs(tree, mesh)
        for path, (s, wspec) in want.items():
            got = _entries(specs[path], mesh.mesh_dim_names, len(s))
            assert got == [_norm(e) for e in wspec], (kind, path, got, wspec)


def test_port_cache_specs_shard_the_per_layer_batch_axis():
    mesh = ShapeMesh((2, 2), ("data", "model"))
    caches = T.init_caches(get_smoke("qwen2_1p5b"), 4, 16, device="meta")
    specs = cache_specs(caches, mesh, stacked=False)
    assert specs[0].k[0].dim == 0 and specs[0].v[0].dim == 0
    assert not hasattr(specs[0].pos[0], "dim")      # (B,) pos replicated


def test_shard_params_cuts_each_leaf_to_its_placement():
    cfg = get_smoke("kimi_k2")
    model = T.Transformer(cfg, device="meta")
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = ShapeMesh((1, 2), ("data", "model"))
    shard_params(model, mesh)
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moe = model.layers[1].moe
    assert local["layers.1.moe.gate"] == (4,) + full["layers.1.moe.gate"][1:]
    assert local["layers.0.attn.q.w"][1] * 2 == full["layers.0.attn.q.w"][1]
    assert local["layers.0.attn.o.w"][0] * 2 == full["layers.0.attn.o.w"][0]
    assert local["embed.table"][0] * 2 == full["embed.table"][0]
    assert local["final_norm.g"] == full["final_norm.g"]
    assert moe.shards["gate"] == (-3, "model", 2)
    assert model.layers[0].attn.q.tp == "col"
    assert model.layers[0].attn.o.tp == "row"


# --------------------------------------------- the mirror of test_dist.py
def test_param_specs_match_tree_structure(ran):
    assert all(r["tree_structure"] for r in ran[1])


def test_param_specs_device_put_roundtrip(ran):
    assert all(r["roundtrip"] for r in ran[1])


def test_opt_state_specs_mirror_params(ran):
    assert all(r["opt_specs"] == ("AdamWState", True, 0) for r in ran[1])


def test_batch_specs_shard_leading_axis(ran):
    for r in ran[1]:
        keys, kinds, dim = r["batch_specs"]
        assert keys == {"tokens", "labels"} and dim == 0
        assert kinds == [("Shard", "Replicate")] * 2


def test_cache_specs_handle_none_leaves(ran):
    assert all(r["cache_none"] == (True, True, 1) for r in ran[1])


def test_ctx_dp_axes_empty_without_mesh(ran):
    assert all(r["dp_axes_outside"] == () for r in ran[1])


def test_ctx_dp_axes_inside_mesh_context(ran):
    for r in ran[1]:
        assert r["dp_axes_inside"] == ("data",) and r["dp_axes_after"] == ()


def test_constrain_noop_without_mesh(ran):
    assert all(r["constrain_noop"] for r in ran[1])


def test_constrain_under_mesh_redistributes_dtensor(ran):
    for r in ran[1]:
        assert r["constrain"] == (True, True, True, (2, 2))
        assert r["constrain_plain"]          # a plain tensor: identity


def test_constrain_drops_axes_missing_from_mesh(ran):
    assert all(r["constrain_drop"] == (True, True) for r in ran[1])


# ------------------------------------------------------------ the meshes
def test_world_and_local_meshes(ran):
    for rank, r in enumerate(ran[1]):
        assert r["world"] == 4 and r["world_again"] == 4
        assert r["meshes"] == [((4, 1), ("data", "model")),
                               ((2, 2), ("data", "model")),
                               ((1, 4), ("data", "model"))]
        assert r["coords"] == (rank // 2, rank % 2, 2)


def test_production_mesh_is_shape_only():
    from repro_torch.launch.mesh import make_production_mesh
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert one.size() == 256 and two.size() == 512
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------- collectives
def test_all_gather_concatenates_in_rank_order(ran):
    every = ran[1][0]["every"]
    for r in ran[1]:
        assert torch.equal(r["ag1"], torch.cat(every, 1))
        assert torch.equal(r["ag0"], torch.cat(every, 0))


def test_reduce_scatter_is_the_rank_slice_of_the_sum(ran):
    every = ran[1][0]["every"]
    total = sum(torch.cat([e] * 4, 2) for e in every)
    for rank, r in enumerate(ran[1]):
        want = total.chunk(4, 2)[rank]
        torch.testing.assert_close(r["rs"], want, rtol=0, atol=1e-6)


def test_all_reduce_sum_max_and_axes(ran):
    every = ran[1][0]["every"]
    total = sum(every)
    for rank, r in enumerate(ran[1]):
        torch.testing.assert_close(r["ar_sum"], total, rtol=0, atol=1e-6)
        assert torch.equal(r["ar_max"], torch.stack(every).amax(0))
        assert torch.equal(r["ar_data"], every[rank])   # one-rank axis
        torch.testing.assert_close(r["ar_two_axes"], total, rtol=0,
                                   atol=1e-6)
        assert r["bf16"].dtype == torch.bfloat16
        assert r["int32"].dtype == torch.int32
        assert torch.equal(r["int32"], sum((e * 100).to(torch.int32)
                                           for e in every))
        assert torch.equal(r["split"], torch.arange(8.0)[None, 2 * rank:
                                                          2 * rank + 2])
    # every rank holds the same bits
    assert all(torch.equal(r["ar_sum"], ran[1][0]["ar_sum"]) for r in ran[1])


def test_collective_records(ran):
    rec = ran[1][0]["records"]
    assert rec[0] == ("all-gather", (3, 16, 5), "torch.float32", 4, None,
                      "forward")
    assert rec[1][:5] == ("all-gather", (12, 4, 5), "torch.float32", 4, "s")
    assert rec[2][:4] == ("reduce-scatter", (3, 4, 5), "torch.float32", 4)
    assert [k for k, *_ in rec] == ["all-gather", "all-gather",
                                    "reduce-scatter", "all-reduce",
                                    "all-reduce", "all-reduce", "all-reduce"]


def test_collective_gradients_are_exact_adjoints(ran):
    for rank, r in enumerate(ran[1]):
        # d/dw of sum(gather(w) * c): the sum over ranks of their slices of c
        c = torch.arange(16.0)[None, :, None].expand(3, 16, 5)
        assert torch.equal(r["ag_grad"], 4 * c[:, 4 * rank:4 * rank + 4])
        # d/dw of sum(allreduce(w) * (rank+1)) summed over ranks: 1+2+3+4
        assert torch.equal(r["ar_grad"], torch.full((3, 4, 5), 10.0))


def test_reduce_scatter_gradient_gathers(ran):
    every = ran[1][0]["every"]
    # rs(w) on rank r = sum_s w_s[:, r-th quarter of dim 1]; loss_r =
    # sum(rs_r^2) -> dL/dw_s = concat_r(2 rs_r)
    rs = [sum(e.chunk(4, 1)[r] for e in every) for r in range(4)]
    want = torch.cat([2 * x for x in rs], 1)
    for r in ran[1]:
        torch.testing.assert_close(r["rs_grad"], want, rtol=0, atol=1e-5)
