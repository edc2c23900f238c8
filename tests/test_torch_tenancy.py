"""Port parity of multi-tenant serving against the JAX package:

* the morphable scheduler's plans and partitions on 2x2 and 4x4 grids of
  `torch.device("cpu")` (the reference's on the same grids of JAX CPU
  devices), the degenerate 1x1 grid's fused 128x128 plan, and
  `MorphableScheduler()` raising without a card;
* `attach_engine`, `occupancy` and `utilization` over two SMOKE engines;
* the serve launcher: `--multi-tenant` serves both tenants, and each
  tenant's tokens equal the reference launcher's `_run_engine` on the same
  SMOKE config, prompts and weights (carried across by
  `bridge.params_from_jax`); the port's kernel route (`--backend auto`,
  the kernels' plain versions on the CPU) against the reference's
  `pallas` route, and `--format int8 --backend ref` on one tenant against
  the reference's `ref` route under the same format.

The reference's engines run once each (a module-scoped fixture): three in
all, their weights kept for the port's side.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.tenancy import MorphableScheduler as JScheduler
from repro.tenancy import Tenant as JTenant
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine
from repro_torch.tenancy import (DeviceGrid, MorphableScheduler, Tenant,
                                 device_grid, fission_mesh)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

CPU = torch.device("cpu")
REQUESTS, MAX_NEW = 3, 5

# tenant lists (name, weight rows, cols, format): the reference tests' two
# cases, the launcher's, and wider mixes
TENANT_LISTS = [
    [("captioning", 64, 512, "bf16"), ("classification", 64, 768, "bf16")],
    [("big", 4096, 4096, "bf16")],
    [("captioning", 64, 512, "int8"), ("classification", 64, 768, "int8")],
    [("a", 256, 256, "fp8a"), ("b", 128, 128, "fp8a"), ("c", 64, 64, "fp8a")],
    [("a", 512, 64, "int4"), ("b", 64, 512, "int4"), ("c", 300, 300, "int4"),
     ("d", 16, 16, "int4")],
    [("a", 1000, 30, "bf16"), ("b", 30, 1000, "bf16"),
     ("c", 128, 256, "bf16"), ("d", 256, 128, "bf16"),
     ("e", 64, 64, "bf16")],
]


def _jax_grid(rows, cols):
    return np.array(jax.devices() * rows * cols)[:rows * cols].reshape(
        rows, cols)


def _cpu_grid(rows, cols):
    return device_grid([[CPU] * cols] * rows)


def _plan(plan):
    return tuple((a.blocks, a.rows, a.cols) for a in plan.arrays)


def _partitions(parts):
    return [(p.tenants, p.mesh.devices.shape, tuple(p.mesh.axis_names))
            for p in parts]


@pytest.mark.parametrize("shape", [(2, 2), (4, 4), (1, 1), (3, 5)])
@pytest.mark.parametrize("tenants", TENANT_LISTS,
                         ids=lambda t: "+".join(n for n, *_ in t))
def test_partitions_equal_reference(tenants, shape):
    """Plans, tenant assignment and sub-grid shapes equal the reference
    scheduler's on the same grid shape (3x5 trims to 2x4, as it does)."""
    jsched = JScheduler(devices=_jax_grid(*shape))
    sched = MorphableScheduler(devices=_cpu_grid(*shape))
    want = jsched.reconfigure([JTenant(*t) for t in tenants])
    got = sched.reconfigure([Tenant(*t) for t in tenants])
    assert _plan(sched.plan) == _plan(jsched.plan)
    assert _partitions(got) == _partitions(want)
    assert sched.devices.shape == jsched.devices.shape
    for name, *_ in tenants:
        assert sched.partition_of(name).tenants == \
            jsched.partition_of(name).tenants


def test_tenancy_planning_two_tenants():
    """The reference's test_substrate case on a 2x2 CPU grid: two wide
    tenants land on separate partitions."""
    sched = MorphableScheduler(devices=_cpu_grid(2, 2))
    parts = sched.reconfigure([Tenant("captioning", 64, 512),
                               Tenant("classification", 64, 768)])
    assert len(parts) >= 2
    names = [t for p in parts for t in p.tenants]
    assert set(names) == {"captioning", "classification"}
    assert sched.partition_of("captioning") is not None
    assert all(isinstance(p.mesh, DeviceGrid) for p in parts)


def test_tenancy_single_tenant_fuses():
    sched = MorphableScheduler(devices=_cpu_grid(2, 2))
    parts = sched.reconfigure([Tenant("big", 4096, 4096)])
    assert len(parts) == 1
    assert parts[0].mesh.devices.size == 4


def test_one_device_takes_the_fused_plan():
    """A 1x1 grid (one card, one CPU) takes the Fig 8-(h) plan with every
    tenant in one partition, whatever the planner picked."""
    sched = MorphableScheduler(devices=[[CPU]])
    parts = sched.reconfigure([Tenant("captioning", 64, 512, "int8"),
                               Tenant("classification", 64, 768, "int8")])
    assert sched.plan.describe() == "128x128"
    assert [p.tenants for p in parts] == [("captioning", "classification")]
    assert parts[0].mesh.first() == CPU
    assert sched.run("classification", lambda a, b=0: a + b, 2, b=3) == 5
    with pytest.raises(KeyError):
        sched.partition_of("nobody")


def test_fission_mesh_blocks():
    """Each partition of a 4x4 grid is the plan's block rectangle."""
    grid = device_grid([[f"cpu:{4 * r + c}" for c in range(4)]
                        for r in range(4)])
    sched = MorphableScheduler(devices=grid)
    sched.reconfigure([Tenant("a", 64, 512), Tenant("b", 64, 768)])
    subs = fission_mesh(grid, sched.plan)
    assert [g.devices.shape for g in subs] == [(2, 4), (2, 4)]
    assert [d.index for d in subs[1].devices.flat] == list(range(8, 16))
    assert subs[0].axis_names == ("data", "model")


def test_scheduler_and_launcher_without_a_card_raise(monkeypatch):
    """No fallback to the CPU: the scheduler's default grid and the
    launcher's default device need a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MorphableScheduler()
    for argv in (["--multi-tenant"], ["--smoke"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv + ["--requests", "1", "--max-new", "1"])


def test_attach_engine_occupancy_and_utilization():
    """Two SMOKE engines attached: the scheduler reads each one's slots,
    mid-flight and drained."""
    sched = MorphableScheduler(devices=[[CPU]])
    sched.reconfigure([Tenant("captioning", 64, 512, "int8"),
                       Tenant("classification", 64, 768, "int8")])
    engines = {}
    for (tenant, arch, *_), n in zip(serve.TENANTS, (3, 1)):
        cfg = get_smoke(arch)
        eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                            slots=4, max_len=32, prefill_chunk=8)
        sched.attach_engine(tenant, eng)
        engines[tenant] = eng
        for rid in range(n):
            assert eng.submit(Request(rid, np.arange(1, 6, dtype=np.int32),
                                      max_new_tokens=3))
    assert sched.utilization() == {"captioning": 0.0, "classification": 0.0}
    for eng in engines.values():
        eng.step()
    assert sched.utilization() == {"captioning": 0.75,
                                   "classification": 0.25}
    occ = sched.occupancy()
    assert [o["rid"] for o in occ["captioning"][:3]] == [0, 1, 2]
    assert occ["captioning"][3] is None
    # the step admitted the prompt (its first token) and decoded one more
    assert occ["classification"][0] == {"rid": 0, "generated": 2,
                                        "remaining": 1}
    for eng in engines.values():
        eng.run_until_drained()
    assert sched.utilization() == {"captioning": 0.0, "classification": 0.0}
    assert all(o is None for occ in sched.occupancy().values() for o in occ)


# ------------------------------------------------------------ the launcher
# the reference launcher's weights by config name, kept as its engines
# build them (init_params(jax.random.key(seed), cfg) of the SMOKE config;
# its format plane does not change them)
_JAX_PARAMS = {}


def _recording_init(cfg_key, cfg):
    params = jinit_params(cfg_key, cfg)
    _JAX_PARAMS.setdefault(cfg.name, jax.tree.map(np.asarray, params))
    return params


@contextlib.contextmanager
def _jax_weights():
    """The port launcher's `init_params` replaced by the reference
    launcher's weights of the same SMOKE config, carried across by the
    bridge."""
    arch_of = {get_smoke(a).name: a for a in ARCH_IDS}

    def bridged(cfg, seed=0, device="cuda"):
        if cfg.name not in _JAX_PARAMS:
            _recording_init(jax.random.key(seed), jax_smoke(arch_of[cfg.name]))
        return params_from_jax(_JAX_PARAMS[cfg.name], cfg, device=device)
    saved = serve.init_params
    serve.init_params = bridged
    try:
        yield
    finally:
        serve.init_params = saved


def _tokens(done):
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def reference():
    """The reference launcher's engines, as its --multi-tenant branch (and
    its single-tenant one) call `_run_engine`: each tenant on the pallas
    route, and qwen2 under --format int8 --backend ref."""
    runs = {"captioning": ("olmoe_1b_7b", dict(backend="pallas")),
            "classification": ("qwen2_1p5b", dict(backend="pallas")),
            "int8-ref": ("qwen2_1p5b", dict(format="int8", backend="ref"))}
    saved = jserve.init_params
    jserve.init_params = _recording_init
    try:
        return {name: _tokens(jserve._run_engine(
            arch, True, REQUESTS, MAX_NEW,
            policy=japi.ExecutionPolicy(**policy)))
            for name, (arch, policy) in runs.items()}
    finally:
        jserve.init_params = saved


@pytest.fixture(scope="module")
def multi_tenant_run(reference):
    with _jax_weights():
        return serve.main(["--multi-tenant", "--device", "cpu",
                           "--requests", str(REQUESTS),
                           "--max-new", str(MAX_NEW)])


def test_multi_tenant_serves_both_tenants(multi_tenant_run, capsys):
    done = multi_tenant_run
    assert set(done) == {"captioning", "classification"}
    for reqs in done.values():
        assert sorted(r.rid for r in reqs) == list(range(REQUESTS))
        assert all(len(r.out_tokens) == MAX_NEW for r in reqs)
    with _jax_weights():
        serve.main(["--multi-tenant", "--device", "cpu", "--requests", "2",
                    "--max-new", "4"])
    out = capsys.readouterr().out
    assert ("[serve] fusion plan: 128x128; partitions: "
            "[('captioning', 'classification')]") in out
    for arch in ("olmoe_1b_7b", "qwen2_1p5b"):     # occupancy mid-flight
        assert f"[serve:{arch}] step 1: slots [r0+2 r1+2 -- --] util 0.50" \
            in out
    assert "[serve] tenant classification: final 4 slots, 0 busy" in out


@pytest.mark.parametrize("tenant,arch", [(t, a) for t, a, *_ in serve.TENANTS])
def test_multi_tenant_tokens_equal_reference_launcher(multi_tenant_run,
                                                      reference, tenant,
                                                      arch):
    """The port's default (kernel) route against the reference's pallas
    route: for the MoE tenant the routes differ from `ref` (a chunk's pad
    rows compete for expert capacity, and the routes give them other
    values), so the kernel routes are compared."""
    assert _tokens(multi_tenant_run[tenant]) == reference[tenant]


def test_format_and_backend_flags_equal_reference_launcher(reference):
    """--format int8 --backend ref, single tenant: fake-quant int8 on every
    Linear over the ref route, the reference launcher's same flags."""
    with _jax_weights():
        got = serve.main(["--arch", "qwen2_1p5b", "--smoke", "--device",
                          "cpu", "--format", "int8", "--backend", "ref",
                          "--requests", str(REQUESTS),
                          "--max-new", str(MAX_NEW)])
    want = reference["int8-ref"]
    assert _tokens(got) == want
    # the format reached every Linear: other tokens than the bf16 plane's
    with _jax_weights():
        plain = serve.main(["--arch", "qwen2_1p5b", "--smoke", "--device",
                            "cpu", "--backend", "ref", "--requests",
                            str(REQUESTS), "--max-new", str(MAX_NEW)])
    assert _tokens(plain) != want


def test_launcher_format_reaches_the_quant_policy(monkeypatch):
    """--format sets QuantPolicy(activations=fmt, weights=fmt) on the
    config the model is built from; bf16 leaves it off."""
    seen = []

    def capture(cfg, seed=0, device="cuda"):
        seen.append(cfg.quant)
        return init_params(cfg, seed=seed, device=device)
    monkeypatch.setattr(serve, "init_params", capture)
    for fmt in ("fp8a", "bf16"):
        serve.main(["--smoke", "--device", "cpu", "--format", fmt,
                    "--requests", "1", "--max-new", "1"])
    assert seen[0].activations == seen[0].weights == "fp8a"
    assert not seen[1].active
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--backend", "pallas"])
