"""The varlen flash-prefill kernel's launch plan and arithmetic, on the CPU.

`prefill_plan` sizes the kernel's grid, split workspace and counters from
the shapes alone (the rows' positions and lengths stay on the device), with
the splits cut at absolute key positions. The kernel's products run on the
tensor cores as bf16 MMAs over operands split into three bf16 terms; a CPU
emulation of that arithmetic (the terms, 256-key splits merged in order)
is held to `flash_prefill_plain` within a tenth of the card gate of 1e-4."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import ceil_div
from repro_torch.kernels.flash_attention import flash_prefill_plain
from repro_torch.kernels.flash_attention import prefill as prefill_mod
from repro_torch.kernels.flash_attention.prefill import (ROWS_PER_BLOCK,
                                                         SPLIT_KEYS,
                                                         TILE_KEYS,
                                                         prefill_plan)
from repro_torch.kernels.flash_attention.shared import dequant
from repro_torch.models.attention import _q8

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4          # the kernel's gate against its plain version on the card
NEG_INF = -1e30

# the serving shapes of qwen2-1.5B (chip_smoke.py phase 3)
B, HQ, HKV, D, LK, W = 8, 12, 2, 128, 2048, 32
PREFILL_POS = [0, 127, 128, 1000, LK - 1 - W, 300, 1700, 64]
PREFILL_LEN = [W, 1, 17, 0, W, 5, W, 20]


def test_plan_takes_shapes_only():
    params = list(inspect.signature(prefill_plan).parameters)
    assert params == ["b", "hkv", "group", "w", "bq", "lk", "d"]


@pytest.mark.parametrize("b,hkv,group,w,bq,lk,d", [
    (B, HKV, HQ // HKV, W, 32, LK, D),      # a serving chunk step
    (5, 2, 4, 20, 8, 300, 128),             # q-blocks of 8, a short cache
    (4, 2, 6, 1, 32, 4096, 16),             # one query a row, bq clamped
    (3, 1, 1, 13, 32, 257, 64),             # MHA, Lk not a multiple of 32
])
def test_plan_grid_workspace_and_counters(b, hkv, group, w, bq, lk, d):
    plan = prefill_plan(b, hkv, group, w, bq, lk, d)
    bq = min(bq, w)
    rblocks = ceil_div(w, bq) * ceil_div(group * bq, ROWS_PER_BLOCK)
    splits = ceil_div(lk, SPLIT_KEYS)
    assert plan.grid == (b * hkv, rblocks, splits)
    assert plan.counters == b * hkv * rblocks
    # one 64-row partial (acc of D, then m and l) for every block
    assert plan.workspace == b * hkv * rblocks * splits * 64 * (d + 2)


def test_serving_plan_fills_the_card():
    """At the serving shapes the grid has 16 x 3 x 8 blocks (the first
    design had 16 x 1 x 6)."""
    plan = prefill_plan(B, HKV, HQ // HKV, W, 32, LK, D)
    assert plan.grid == (16, 3, 8)
    assert 4 * 132 > np.prod(plan.grid) > 132


@pytest.mark.parametrize("lk", [1, SPLIT_KEYS, SPLIT_KEYS + 1, LK,
                                2 * LK + 5])
def test_splits_are_whole_tiles_at_absolute_positions(lk):
    """Split s holds the cache positions [s span, (s + 1) span): whole
    32-key tiles, just enough splits for the cache, and the same span
    whatever the chunk, the rows or the cache length."""
    plan = prefill_plan(B, HKV, HQ // HKV, W, 32, lk, D)
    span = plan.span
    assert span == SPLIT_KEYS and span % TILE_KEYS == 0
    assert (plan.grid[2] - 1) * span < lk <= plan.grid[2] * span
    assert prefill_plan(2, 1, 1, 1, 1, lk, 16).span == span


@pytest.mark.parametrize("span", [64, 128, 512])
def test_plan_follows_the_split_constant(monkeypatch, span):
    """A sweep of the split span patches `SPLIT_KEYS`; the plan's splits,
    workspace and span all follow it, and the grid's other axes do not."""
    base = prefill_plan(B, HKV, HQ // HKV, W, 32, LK, D)
    monkeypatch.setattr(prefill_mod, "SPLIT_KEYS", span)
    plan = prefill_plan(B, HKV, HQ // HKV, W, 32, LK, D)
    assert plan.span == span and plan.grid[2] == ceil_div(LK, span)
    assert plan.grid[:2] == base.grid[:2] and plan.counters == base.counters
    assert plan.workspace * base.grid[2] == base.workspace * plan.grid[2]


# ------------------------------------------ the kernel's arithmetic on CPU
def _split3(x):
    """x = hi + mid + lo, each term the nearest bf16 to what is left."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def _products(a_terms, b, b_split):
    """The kernel's MMA sequence, smallest terms first: a split A times an
    exact-bf16 B (3 products), or times a split B (the 6 with i + j <= 2)."""
    if not b_split:
        return sum(t @ b for t in reversed(a_terms))
    (ah, am, al), (bh, bm, bl) = a_terms, _split3(b)
    return al @ bh + am @ bm + ah @ bl + am @ bh + ah @ bm + ah @ bh


def _emulate(q, k, v, pos, lens, *, kv_split, window=None, softcap=None):
    """The prefill kernel's arithmetic in a few batched ops: bf16-term
    products, each split's softmax state (m, l, acc) over its keys, the
    splits merged in order. (The kernel also rescales between the 32-key
    tiles of a split; that adds roundings of f32 size, not of the terms.)"""
    b, hq, w, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, 1)
    v = v.repeat_interleave(group, 1)
    lk = k.shape[2]
    span = SPLIT_KEYS
    ns = lk // span
    x = _products(_split3(q), k.transpose(2, 3), kv_split) * d ** -0.5
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    qpos = torch.tensor(pos)[:, None] + torch.arange(w)[None, :]
    valid = torch.arange(w)[None, :] < torch.tensor(lens)[:, None]
    key = torch.arange(lk)[None, None, :]
    keep = valid[:, :, None] & (key <= qpos[:, :, None])
    if window:
        keep &= key > qpos[:, :, None] - window
    x = torch.where(keep[:, None], x, torch.tensor(NEG_INF))
    x = x.reshape(b, hq, w, ns, span)
    m = x.amax(-1, keepdim=True)                         # (.., ns, 1)
    p = torch.exp(x - m)
    l = p.sum(-1, keepdim=True)
    vs = v.reshape(b, hq, ns, span, d)
    pv = [torch.einsum("bhwsk,bhskd->bhwsd", t, vs) for t in _split3(p)]
    if kv_split:
        vh, vm, vl = (t.reshape(b, hq, ns, span, d) for t in _split3(v))
        ph, pm, pl = _split3(p)
        pv = [torch.einsum("bhwsk,bhskd->bhwsd", a, c) for a, c in
              ((pl, vh), (pm, vm), (ph, vl), (pm, vh), (ph, vm), (ph, vh))]
    else:
        pv = pv[::-1]
    acc = sum(pv)
    mo, lo, ao = m[..., 0, :], l[..., 0, :], acc[..., 0, :]
    for s in range(1, ns):
        m2, l2, a2 = m[..., s, :], l[..., s, :], acc[..., s, :]
        mn = torch.maximum(mo, m2)
        x1, x2 = torch.exp(mo - mn), torch.exp(m2 - mn)
        lo, ao, mo = lo * x1 + l2 * x2, ao * x1 + a2 * x2, mn
    out = ao / lo.clamp_min(1e-30)
    return torch.where(valid[:, None, :, None], out, torch.zeros_like(out))


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
def test_three_term_bf16_products_meet_the_gate(kv, window, softcap):
    """At the phase-3 serving case the emulated kernel is within 1e-5 of
    the plain version: a tenth of the card's 1e-4 gate. int8 K/V is
    dequantized and then takes the f32 path (6 MMAs), as in the kernel."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(B, HQ, W, D).astype(np.float32)) * 0.5
    k = torch.from_numpy(rng.randn(B, HKV, LK, D).astype(np.float32)) * 0.5
    v = torch.from_numpy(rng.randn(B, HKV, LK, D).astype(np.float32))
    if kv == "bf16":
        k, v = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float()
    if kv == "int8":
        k, v = (dequant(*_q8(t), torch.float32) for t in (k, v))
    got = _emulate(q, k, v, PREFILL_POS, PREFILL_LEN, kv_split=kv != "bf16",
                   window=window, softcap=softcap)
    want = flash_prefill_plain(q, k, v, pos=PREFILL_POS, lengths=PREFILL_LEN,
                               window=window, softcap=softcap)
    err = (got - want).abs().max().item()
    assert err <= TOL / 10, err
