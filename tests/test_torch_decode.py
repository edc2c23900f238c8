"""The flash-decode kernel's launch plan, on the CPU.

`decode_plan` sizes the kernel's grid, split workspace and counters from
the shapes alone (the rows' positions stay on the device), with the splits
cut at absolute key positions: a row's sums then run in one order whatever
the other rows, the cache's layout (flat or paged) or its block size."""
import inspect

import numpy as np
import pytest

from repro_torch.kernels.common import ceil_div
from repro_torch.kernels.flash_attention import decode as decode_mod
from repro_torch.kernels.flash_attention.decode import (ROWS_PER_BLOCK,
                                                        SPLIT_KEYS,
                                                        TILE_KEYS,
                                                        decode_plan)

# the serving shapes of qwen2-1.5B (chip_smoke.py phase 4)
B, HQ, HKV, D, LK = 8, 12, 2, 128, 2048
DECODE_POS = [0, 127, 128, 1000, LK - 1 - 1, 500, 1500, 64]


def test_plan_takes_shapes_only():
    params = list(inspect.signature(decode_plan).parameters)
    assert params == ["b", "hkv", "group", "lq", "lk", "d"]


@pytest.mark.parametrize("b,hkv,group,lq,lk,d", [
    (B, HKV, HQ // HKV, 1, LK, D),          # a serving decode step
    (5, 2, 4, 4, 300, 128),                 # 4 queries a row, 2 row groups
    (4, 2, 6, 8, 4096, 16),                 # 48 packed rows, a long cache
    (3, 1, 1, 1, 257, 64),                  # MHA, Lk not a multiple of 32
])
def test_plan_grid_workspace_and_counters(b, hkv, group, lq, lk, d):
    plan = decode_plan(b, hkv, group, lq, lk, d)
    groups = ceil_div(group * lq, ROWS_PER_BLOCK)
    splits = ceil_div(lk, SPLIT_KEYS)
    assert plan.grid == (b * hkv, groups, splits)
    assert plan.counters == b * hkv * groups
    # one 8-row partial (acc of D, then m and l) for every block
    assert plan.workspace == b * hkv * groups * splits * 8 * (d + 2)


def test_serving_plan_fills_the_card():
    """At the serving shapes the grid has 16 x 1 x 16 blocks (the first
    design had 16 x 1): the rows at DECODE_POS keep 90 of them live, each
    walking one 32-key tile a warp, where the row at 2046 once walked 16
    tiles a warp in one block."""
    plan = decode_plan(B, HKV, HQ // HKV, 1, LK, D)
    assert plan.grid == (16, 1, 16)
    live = HKV * sum(p // plan.span + 1 for p in DECODE_POS)
    assert live == 90 and 132 > live > 16
    assert 4 * TILE_KEYS == plan.span


@pytest.mark.parametrize("lk", [1, SPLIT_KEYS, SPLIT_KEYS + 1, LK,
                                2 * LK + 5])
def test_splits_are_whole_tiles_at_absolute_positions(lk):
    """Split s holds the cache positions [s span, (s + 1) span): whole
    32-key tiles, just enough splits for the cache, and the same span
    whatever the queries, the rows or the cache length."""
    plan = decode_plan(B, HKV, HQ // HKV, 1, lk, D)
    span = plan.span
    assert span == SPLIT_KEYS and span % TILE_KEYS == 0
    assert (plan.grid[2] - 1) * span < lk <= plan.grid[2] * span
    assert decode_plan(2, 1, 1, 8, lk, 16).span == span
    # a paged pool of any block size reaches the same positions: the same
    # splits for nblk * bs keys
    for bs in (16, 32, 128):
        nblk = ceil_div(lk, bs)
        paged = decode_plan(B, HKV, HQ // HKV, 1, nblk * bs, D)
        assert paged.span == span
        assert np.array_equal(
            np.arange(lk) // paged.span, np.arange(lk) // span)


@pytest.mark.parametrize("span", [64, 256, 512])
def test_plan_follows_the_split_constant(monkeypatch, span):
    """A sweep of the split span patches `SPLIT_KEYS`; the plan's splits,
    workspace and span all follow it, and the grid's other axes do not."""
    base = decode_plan(B, HKV, HQ // HKV, 1, LK, D)
    monkeypatch.setattr(decode_mod, "SPLIT_KEYS", span)
    plan = decode_plan(B, HKV, HQ // HKV, 1, LK, D)
    assert plan.span == span and plan.grid[2] == ceil_div(LK, span)
    assert plan.grid[:2] == base.grid[:2] and plan.counters == base.counters
    assert plan.workspace * base.grid[2] == base.workspace * plan.grid[2]
