"""Port parity of the MoE layer (`repro_torch.models.moe`) against the JAX
package's `moe_apply`: routing, the sort-based capacity dispatch with its
dropped assignments, the expert products, the shared expert and the aux
loss, from the same weights and inputs. Plus the reference behaviour the
port mirrors on purpose: every position of a launch competes for expert
capacity (pad positions and idle rows included), so which assignments a
token keeps depends on its launch's B x L; and resident weights leave the
MoE layer dense (the shared expert fake-quantizes in the residency
format, as the reference's pinned policy makes it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import quantize_params as jquantize_params
from repro.models.moe import moe_apply, moe_init, router_topk
from repro_torch import api
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import forward, quantize_params
from repro_torch.models.layers import Linear
from repro_torch.models.moe import MoE, expert_capacity

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-5
D, FF = 32, 48


def _pair(e, k, n_shared, cf, seed=0):
    """A JAX MoE param tree and the port's MoE holding the same weights."""
    p = moe_init(jax.random.key(seed), D, FF, e, n_shared)
    mod = MoE(D, FF, e, k, n_shared=n_shared, capacity_factor=cf,
              device="cpu")
    with torch.no_grad():
        mod.router.w.copy_(torch.from_numpy(np.asarray(p["router"]["w"])))
        for name in ("gate", "up", "down"):
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(p[name])))
            if n_shared:
                getattr(mod.shared, name).w.copy_(
                    torch.from_numpy(np.asarray(p["shared"][name]["w"])))
    return p, mod


def _jax_dispatch(p, x, e, k, cf):
    """The reference's routing and keep mask, in (token, k) order: its own
    lines of `moe_apply` (`src/repro/models/moe.py`), which it does not
    return."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    t = xt.shape[0]
    gates, ids = router_topk(jnp.einsum("td,de->te", xt, p["router"]["w"]),
                             k)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = jnp.searchsorted(se, jnp.arange(e), side="left")
    pos = jnp.arange(t * k) - seg_start[se]
    cap = int(max(k * t / e * cf, 4))
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return np.asarray(ids), keep.reshape(t, k), cap


def _port_keep(mod, x):
    d = mod.dispatch(x.reshape(-1, x.shape[-1]))
    keep = torch.empty_like(d.keep)
    keep[d.order] = d.keep
    return d, keep.view(-1, mod.top_k).numpy()


# (experts, top-k, shared experts, capacity factor): every case drops
MOE_CASES = [(8, 2, 0, 0.5), (8, 2, 1, 1.0), (16, 4, 0, 0.75)]


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_matches_jax_with_dropped_assignments(case):
    """Kept and dropped (token, expert) assignments equal the reference's,
    the output within 1e-5 and the aux loss within 1e-5."""
    e, k, n_shared, cf = case
    p, mod = _pair(e, k, n_shared, cf)
    x = np.random.RandomState(1).randn(2, 16, D).astype(np.float32)
    want, waux = moe_apply(p, jnp.asarray(x), n_experts=e, top_k=k,
                           capacity_factor=cf)
    got, aux = mod(torch.from_numpy(x))
    ids, keep, cap = _jax_dispatch(p, x, e, k, cf)
    d, pkeep = _port_keep(mod, torch.from_numpy(x))
    assert d.capacity == cap
    np.testing.assert_array_equal(d.ids.numpy(), ids)
    np.testing.assert_array_equal(pkeep, keep)
    assert (~keep).sum() > 0 and int(d.dropped) == (~keep).sum()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL, atol=TOL)


def test_moe_launch_with_pad_and_idle_rows():
    """One launch of three rows: a pad row (its tail one repeated pad
    vector), an idle row (copies of the real row's tokens, as a row sitting
    a launch out carries stale inputs) and the real row last. Every
    position counts toward T and competes for capacity, in both packages:
    the outputs agree everywhere, and the real row keeps other assignments
    (so gets another output) than it does alone in its own launch."""
    e, k, cf = 8, 2, 1.0
    p, mod = _pair(e, k, 0, cf, seed=2)
    rng = np.random.RandomState(3)
    real = rng.randn(8, D).astype(np.float32)
    pad_row = rng.randn(8, D).astype(np.float32)
    pad_row[3:] = pad_row[3]
    x = np.stack([pad_row, real, real])          # pad, idle, real
    for inp in (x, x[2:]):
        want, _ = moe_apply(p, jnp.asarray(inp), n_experts=e, top_k=k,
                            capacity_factor=cf)
        got, _ = mod(torch.from_numpy(inp))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        _, keep, cap = _jax_dispatch(p, inp, e, k, cf)
        _, pkeep = _port_keep(mod, torch.from_numpy(inp))
        np.testing.assert_array_equal(pkeep, keep)
        assert cap == expert_capacity(inp.shape[0] * 8, e, k, cf)
    # the real row: alone, then behind its copies in the launch
    alone_keep = _port_keep(mod, torch.from_numpy(x[2:]))[1]
    launch_keep = _port_keep(mod, torch.from_numpy(x))[1][16:]
    assert (alone_keep != launch_keep).any()
    alone = mod(torch.from_numpy(x[2:]))[0][0]
    in_launch = mod(torch.from_numpy(x))[0][2]
    assert not torch.allclose(alone, in_launch, rtol=TOL, atol=TOL)
    jalone = np.asarray(moe_apply(p, jnp.asarray(x[2:]), n_experts=e,
                                  top_k=k, capacity_factor=cf)[0])[0]
    jlaunch = np.asarray(moe_apply(p, jnp.asarray(x), n_experts=e, top_k=k,
                                   capacity_factor=cf)[0])[2]
    assert not np.allclose(jalone, jlaunch, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tokens,want", [(8, 4), (256, 40), (1, 4)])
def test_expert_capacity_at_the_olmoe_step_widths(tokens, want):
    """olmoe-1b-7b (64 experts, top 8, factor 1.25): a decode step of 8
    slots keeps 4 assignments an expert, a 32-token chunk of 8 slots 40."""
    assert expert_capacity(tokens, 64, 8, 1.25) == want


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_resident_weights_leave_the_moe_layer_dense(fmt):
    """`quantize_params` on kimi-k2 SMOKE makes the attention and dense-MLP
    Linears resident (the reference's coverage, leaf for leaf) and leaves
    the router, the experts and the shared expert dense; the shared expert
    fake-quantizes its weights in `fmt`, as the reference's resident engine
    pins its policy, so the logits agree with the reference's forward on
    its resident params."""
    jcfg, tcfg = jax_smoke("kimi_k2"), get_smoke("kimi_k2")
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    quantize_params(model, fmt)
    resident = {n for n, m in model.named_modules()
                if isinstance(m, Linear) and m.fmt is not None}
    dense = {n for n, m in model.named_modules()
             if isinstance(m, Linear) and m.fmt is None}
    assert all(".moe." not in n for n in resident)
    routers = {n for n in dense if n.endswith(".moe.router")}
    shared = {n for n in dense if ".moe.shared." in n}
    assert dense == routers | shared | {"lm_head"}
    assert len(routers) == 2 and len(shared) == 6
    for n in dense:
        assert model.get_submodule(n).policy.weights == \
            (fmt if n in shared else "none")
    assert all(b.moe.gate.dtype == torch.float32
               for b in model.layers if b.moe is not None)
    jq = jquantize_params(jparams, fmt)
    # the reference stacks a segment's layers: one leaf holds n of them
    assert len(resident) == sum(
        leaf.codes.shape[0] for leaf in jax.tree.leaves(
            jq, is_leaf=lambda x: hasattr(x, "codes"))
        if hasattr(leaf, "codes"))
    pinned = dataclasses.replace(
        jcfg, quant=dataclasses.replace(jcfg.quant, weights=fmt,
                                        resident=True))
    toks = np.random.RandomState(1).randint(1, jcfg.vocab, (2, 12))
    want, waux = jforward(jq, jnp.asarray(toks, jnp.int32), pinned)
    with api.policy(backend="ref"):
        got, aux = forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4,
                               atol=1e-4)
