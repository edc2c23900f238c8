"""Launch contracts of the three attention kernel impls.

Each contract rebuilds, in plain Python, the launch of one C entry point
for a concrete case: the grid from the wrapper's own plan (`decode_plan`,
`prefill_plan`; the full-sequence kernel's launch is chosen in C++, so its
contract models `csrc/flash_full.cu` `launch`), the dynamic shared memory
from the sources' `smem_bytes` / `Smem`, and for each block the keys it
walks, computed from the rows' concrete positions, lengths and block
tables exactly as the kernels compute them on the device: a block past its
rows' causal frontier or before their window touches nothing; a live one
reads the keys [k_begin, k_end] of its split, stores its partial in its
own slot of the workspace and arrives on its row group's counter when its
rows need more than one split, and the last block of a row group merges
and writes the output. The workspace and the counters are operands sized
as the wrapper allocates them, so a plan one block short is an
out-of-bounds finding (KC102).

Every flat offset into q, K/V, the scales, the workspaces and out is
64-bit in these kernels (`long`); the positions, lengths, table entries
and in-row table offsets are `int` (index_bits=32).

Cases include the reference's own case dicts (`repro/kernels/
flash_attention/contract.py`), then the flat, paged and int8 variants the
same impl key reaches (four C entry points for decode and prefill), the
serving shapes of qwen2-1.5B, a 32k-key cache, and edge rows: a row at
position 0, a row at Lk - Lq, a row with lengths == 0 and a window shorter
than one split.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import (BlockContract, KernelLaunch, LaunchContract,
                             register_contract)
from ..common import ceil_div
from ..contracts import SPLITK_STATIC, card_and_plain, paged_table, span
from . import decode as dec
from . import prefill as pre
from .full import flash_attention, full_workspace

__all__ = ["attention_contract", "decode_contract", "prefill_contract",
           "decode_smem", "prefill_smem", "full_smem"]

_ES = {"bf16": 2, "f32": 4, "int8": 1}
_TORCH = {"bf16": torch.bfloat16, "f32": torch.float32}
TOL = 1e-4                  # f32 sums in another order than the plain one

# csrc/flash_common.cuh and flash_decode.cu
WARPS, TK, RW = 4, dec.TILE_KEYS, dec.ROWS_PER_BLOCK
# csrc/flash_prefill.cu and flash_mma.cuh
RB, PK, PAD = pre.ROWS_PER_BLOCK, pre.TILE_KEYS, 8
# csrc/flash_full.cu
FT, FR = 256, 128
SPLIT_KV_THREADS, SPLIT_KV_MAX_BLOCKS = 256, 132 * 16


def decode_smem(d: int, es: int) -> int:
    """`decode::smem_bytes(D, es)`: the rows' queries and positions, then
    the larger of the warps' tile buffers and the merge's states."""
    tile = TK * (d * es + 16) + TK * d * es + 2 * TK * 4
    warps = WARPS * (tile + RW * TK * 4)
    merge = 4 * (2 * WARPS * RW + WARPS * RW * d)
    return 4 * (RW * d + 2 * RW) + max(warps, merge)


def _padded_d(d: int) -> int:
    return (d + 15) & ~15


def prefill_smem(d: int, kv: str) -> int:
    """`prefill::Smem<KV>(D).bytes()`: the query's three bf16 terms and the
    rows' positions, then two K/V buffers (bf16 K/V staged directly; f32
    and int8 staged raw and split into three bf16 terms)."""
    st = _padded_d(d) + PAD
    q = 3 * RB * st * 2 + 2 * RB * 4
    raw = 2 * PK * d * _ES[kv] + (2 * PK * 4 if kv == "int8" else 0)
    kvb = (2 * 2 * PK * st * 2 if kv == "bf16"
           else 2 * raw + 2 * 3 * PK * st * 2)
    return q + kvb


def full_smem(d: int, terms: int) -> int:
    """`full::smem_bytes(D, T)`."""
    st = _padded_d(d) + PAD
    return 2 * (3 * FR * st + 2 * 2 * terms * PK * st)


def _kv_operands(case, rows: int, state_of, *, paged: bool, table):
    """The K/V operands (dense k, v or int8 codes + scales): flat caches
    (B * Hkv, Lk, D) read over the block's keys [k0, k1), or (P, Hkv, bs,
    D) pools read through the table, one tile a pool block the keys
    reach. `state_of(x, y, z)` is the block's state (None: no keys)."""
    hkv, d, quant = case["hkv"], case["d"], case["quant"]
    kv = "int8" if quant else case.get("kv", "bf16")

    def index_map(x, y, z, *_):
        s = state_of(x, y, z)
        if s is None:
            return None
        k0, k1 = s["keys"]
        if not paged:
            return (x, range(k0, k1), 0)
        bs = case["bs"]
        return [(int(table[s["b"], j]), s["h"],
                 range(max(k0, j * bs) - j * bs,
                       min(k1, (j + 1) * bs) - j * bs), 0)
                for j in range(k0 // bs, (k1 - 1) // bs + 1)]

    if paged:
        shape, block = (case["pool"], hkv, case["bs"], d), (1, 1, 1, d)
    else:
        shape, block = (rows, case["lk"], d), (1, 1, d)
    ops = []
    for name in ("k", "v"):
        if not quant:
            ops.append(BlockContract(name, shape, block, index_map,
                                     dtype_bytes=_ES[kv]))
            continue
        ops.append(BlockContract(f"{name}_codes", shape, block, index_map,
                                 dtype_bytes=1, quant="int8"))
        ops.append(BlockContract(f"{name}_scale", shape[:-1] + (1,),
                                 block[:-1] + (1,), index_map,
                                 scale_for=f"{name}_codes"))
    return ops


def _row_operands(case, scalars, state_of):
    """The per-row int32 vectors every block reads first (pos, lengths)
    and the block table a live block reads over its keys."""
    hkv, paged = case["hkv"], bool(case.get("paged"))
    vectors = ("pos", "lengths")[:len(scalars) - paged]
    ops = [BlockContract(name, (case["b"],), (1,),
                         lambda x, *_: (x // hkv,), index_bits=32)
           for name in vectors]
    if paged:
        bs = case["bs"]

        def table_map(x, y, z, *_):
            s = state_of(x, y, z)
            if s is None:
                return None
            k0, k1 = s["keys"]
            return [(s["b"], j) for j in range(k0 // bs, (k1 - 1) // bs + 1)]
        ops.append(BlockContract("table", tuple(scalars[-1].shape), (1, 1),
                                 table_map, index_bits=32))
    return ops


def _packed_rows(x: int, r0: int, r1: int, group: int, q_base: int,
                 q_end: int) -> list:
    """The tiles (x, heads, queries, 0) of an (B * Hkv, group, L, D)
    operand that packed rows [r0, r1) cover, row r being head r % group of
    query q_base + r // group, up to query q_end: a partial query, whole
    queries, a partial query."""
    tiles, r = [], r0
    while r < r1 and q_base + r // group < q_end:
        q, g0 = q_base + r // group, r % group
        if g0 == 0 and r1 - r >= group:
            nq = min((r1 - r) // group, q_end - q)
            tiles.append((x, range(0, group), range(q, q + nq), 0))
            r += nq * group
        else:
            g1 = min(group, g0 + r1 - r)
            tiles.append((x, range(g0, g1), range(q, q + 1), 0))
            r += g1 - g0
    return tiles


def _cache_inputs(case, g: torch.Generator):
    """The K/V arguments of a case on the CPU: (k, v) or (k_codes,
    k_scale, v_codes, v_scale), flat (B, Hkv, Lk, D) or pooled."""
    hkv, d = case["hkv"], case["d"]
    shape = ((case["pool"], hkv, case["bs"], d) if case.get("paged")
             else (case["b"], hkv, case["lk"], d))
    if case["quant"]:
        def codes():
            return torch.randint(-127, 128, shape, generator=g,
                                 dtype=torch.int8)

        def scale():
            e = torch.randint(-9, -4, shape[:3] + (1,), generator=g)
            return torch.exp2(e.to(torch.float32))
        return (codes(), scale(), codes(), scale())
    dt = _TORCH[case.get("kv", "bf16")]
    return (torch.randn(shape, generator=g).to(dt),
            torch.randn(shape, generator=g).to(dt))


def _split(lo: int, hi: int, span_: int, tile: int, z: int):
    """Split z of a row block whose keys are [lo, hi]: None when the split
    holds none of them (the block exits at once), else (live splits, the
    keys [k0, k1) it walks: from its first whole tile at or before lo)."""
    s_lo, s_hi = lo // span_, hi // span_
    if not s_lo <= z <= s_hi:
        return None
    k0 = max(z * span_, lo // tile * tile)
    return s_hi - s_lo + 1, (k0, min(z * span_ + span_ - 1, hi) + 1)


# --------------------------------------------------------------------------
# attention / cuda-decode: flash_decode.cu (flat and paged, dense and int8)
# --------------------------------------------------------------------------

_DECODE_CASES = (
    # the reference's cases
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "lk": 640, "d": 64,
     "pos": (0, 37, 639), "window": None, "quant": False},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "lk": 640, "d": 64,
     "pos": (0, 37, 639), "window": 64, "quant": False},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 4, "lk": 512, "d": 64,
     "pos": (12, 500), "window": None, "quant": True},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "d": 64, "paged": True,
     "bs": 16, "nblk": 8, "pool": 26, "pos": (0, 37, 127), "window": None,
     "quant": False},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 4, "d": 64, "paged": True,
     "bs": 16, "nblk": 8, "pool": 18, "pos": (12, 124), "window": None,
     "quant": True},
    # f32 K/V; int8 windowed; paged windowed, paged int8 at Lq 1
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "lk": 640, "d": 64,
     "pos": (0, 37, 639), "window": None, "quant": False, "kv": "f32"},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 4, "lk": 512, "d": 64,
     "pos": (12, 500), "window": 100, "quant": True},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "d": 64, "paged": True,
     "bs": 16, "nblk": 20, "pool": 64, "pos": (0, 150, 319), "window": 64,
     "quant": False},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 1, "d": 64, "paged": True,
     "bs": 32, "nblk": 10, "pool": 31, "pos": (0, 150, 319),
     "window": None, "quant": True},
    # edge rows: position 0, position Lk - Lq, a window inside one split
    {"b": 2, "hq": 4, "hkv": 2, "lq": 4, "lk": 384, "d": 64,
     "pos": (0, 380), "window": 16, "quant": False},
    {"b": 2, "hq": 4, "hkv": 2, "lq": 4, "d": 64, "paged": True,
     "bs": 16, "nblk": 24, "pool": 50, "pos": (0, 380), "window": 16,
     "quant": True},
    # qwen2-1.5B serving: 8 rows, 12 / 2 heads, 2,048 keys, head dim 128
    {"b": 8, "hq": 12, "hkv": 2, "lq": 1, "lk": 2048, "d": 128,
     "pos": (0, 1, 127, 128, 700, 1500, 2046, 2047), "window": None,
     "quant": False},
    {"b": 8, "hq": 12, "hkv": 2, "lq": 1, "d": 128, "paged": True,
     "bs": 16, "nblk": 128, "pool": 1030,
     "pos": (0, 1, 127, 128, 700, 1500, 2046, 2047), "window": None,
     "quant": True},
    # one rank of qwen2-1.5B on a (1, 2) partition: its 6 q heads over its
    # one KV head (a GQA group of 6; flat bf16 and paged int8 KV, as
    # chip_smoke serves it)
    {"b": 4, "hq": 6, "hkv": 1, "lq": 1, "lk": 256, "d": 128,
     "pos": (0, 17, 128, 255), "window": None, "quant": False},
    {"b": 4, "hq": 6, "hkv": 1, "lq": 1, "d": 128, "paged": True,
     "bs": 16, "nblk": 16, "pool": 66, "pos": (0, 17, 128, 255),
     "window": None, "quant": True},
    # a 32k-key cache (contract only: too large for the card's checks)
    {"b": 4, "hq": 32, "hkv": 8, "lq": 1, "lk": 32768, "d": 128,
     "pos": (0, 4095, 20000, 32767), "window": None, "quant": False},
)


def _decode_entry(case) -> str:
    return "flash_decode_paged" if case.get("paged") else "flash_decode"


@register_contract("attention", "cuda-decode", cases=_DECODE_CASES,
                   sweep_fields=("bkv",))
def decode_contract(case: dict, policy: ExecutionPolicy) -> LaunchContract:
    paged = bool(case.get("paged"))
    b, hq, hkv, lq, d = (case[k] for k in ("b", "hq", "hkv", "lq", "d"))
    group = hq // hkv
    lk = case["nblk"] * case["bs"] if paged else case["lk"]
    window = case["window"] or 0
    pos = np.asarray(case["pos"], np.int32)
    table = paged_table(b, case["nblk"], case["pool"]) if paged else None
    plan = dec.decode_plan(b, hkv, group, lq, lk, d)
    gx, gy, gz = plan.grid
    nblocks = gx * gy * gz
    kv = "int8" if case["quant"] else case.get("kv", "bf16")

    @functools.cache      # every operand's map reads a block's state
    def state(x, y, z):
        bi, h = divmod(x, hkv)
        start = int(pos[bi])
        hi = min(start + lq - 1, lk - 1)
        lo = min(max(start - window + 1, 0), hi) if window else 0
        live = _split(lo, hi, plan.span, TK, z)
        if live is None:
            return None
        rgi = x * gy + y
        return {"b": bi, "h": h, "keys": live[1], "nlive": live[0],
                "rgi": rgi, "slot": rgi * gz + z,
                "rows": min(RW, group * lq - y * RW)}
    multi = any(state(x, y, z) and state(x, y, z)["nlive"] > 1
                for x in range(gx) for y in range(gy) for z in range(gz))

    def tile(x, y, z, *_):
        return None if state(x, y, z) is None else (x, y, 0)

    def partial(width, base):
        def index_map(x, y, z, *_):
            s = state(x, y, z)
            if s is None or s["nlive"] == 1:
                return None
            lo = base + s["slot"] * RW * width
            return (range(lo, lo + s["rows"] * width),)
        return index_map

    def counter(x, y, z, *_):
        s = state(x, y, z)
        return None if s is None or s["nlive"] == 1 else (s["rgi"],)

    scalars = (pos,) if not paged else (pos, table)
    rows = (b * hkv, group * lq, d)
    blocks = [BlockContract("q", rows, (1, RW, d), tile, masked_tail=True)]
    blocks += _kv_operands(case, b * hkv, state, paged=paged, table=table)
    blocks += _row_operands(case, scalars, state)
    rev = (2,) if multi else ()
    blocks += [
        BlockContract("out", rows, (1, RW, d), tile, masked_tail=True,
                      is_output=True, revisits=rev),
        BlockContract("work_acc", (plan.workspace,), (1,),
                      partial(d, 0), is_output=True),
        BlockContract("work_ml", (plan.workspace,), (1,),
                      partial(2, nblocks * RW * d), is_output=True),
        BlockContract("counters", (plan.counters,), (1,), counter,
                      is_output=True, revisits=rev),
    ]
    launch = KernelLaunch("flash_decode_kernel", plan.grid, tuple(blocks),
                          threads=32 * WARPS,
                          smem_bytes=decode_smem(d, _ES[kv]),
                          static_smem=SPLITK_STATIC)
    return LaunchContract((launch,), scalars=scalars,
                          num_scalars=len(scalars), entry=_decode_entry(case),
                          body=lambda: _decode_body(case), tol=TOL)


def _decode_body(case):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(case["b"], case["hq"], case["lq"], case["d"],
                    generator=g)
    kw = {"pos": torch.as_tensor(np.asarray(case["pos"], np.int32)),
          "window": case["window"]}
    paged, quant = bool(case.get("paged")), case["quant"]
    if paged:
        kw["table"] = torch.from_numpy(paged_table(case["b"], case["nblk"],
                                                   case["pool"]))
    fn = {(False, False): dec.flash_decode,
          (False, True): dec.flash_decode_quant,
          (True, False): dec.flash_decode_paged,
          (True, True): dec.flash_decode_paged_quant}[(paged, quant)]
    return card_and_plain(fn, q, *_cache_inputs(case, g), **kw)


# --------------------------------------------------------------------------
# attention / cuda-prefill: flash_prefill.cu (flat and paged, dense and int8)
# --------------------------------------------------------------------------

_PREFILL_CASES = (
    # the reference's cases
    {"b": 3, "hq": 4, "hkv": 2, "lq": 64, "lk": 384, "d": 64,
     "pos": (0, 37, 256), "lens": (3, 64, 17), "window": None,
     "quant": False},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 64, "lk": 384, "d": 64,
     "pos": (0, 37, 256), "lens": (3, 64, 17), "window": 64, "quant": False},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 48, "lk": 256, "d": 64,
     "pos": (128, 0), "lens": (48, 1), "window": None, "quant": True},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 32, "d": 64, "paged": True,
     "bs": 16, "nblk": 8, "pool": 26, "pos": (0, 37, 70),
     "lens": (3, 32, 17), "window": None, "quant": False},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 48, "d": 64, "paged": True,
     "bs": 16, "nblk": 8, "pool": 18, "pos": (80, 0), "lens": (48, 1),
     "window": None, "quant": True},
    # f32 K/V; int8 windowed; paged windowed; paged int8 across splits
    {"b": 3, "hq": 4, "hkv": 2, "lq": 64, "lk": 384, "d": 64,
     "pos": (0, 37, 256), "lens": (3, 64, 17), "window": None,
     "quant": False, "kv": "f32"},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 48, "lk": 640, "d": 64,
     "pos": (128, 500), "lens": (48, 30), "window": 300, "quant": True},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 32, "d": 64, "paged": True,
     "bs": 16, "nblk": 40, "pool": 130, "pos": (0, 300, 600),
     "lens": (3, 32, 17), "window": 64, "quant": False},
    {"b": 2, "hq": 8, "hkv": 2, "lq": 48, "d": 64, "paged": True,
     "bs": 32, "nblk": 20, "pool": 45, "pos": (240, 0),
     "lens": (48, 1), "window": None, "quant": True},
    # edge rows: position 0, Lk - Lq, lengths == 0, a window inside a split
    {"b": 3, "hq": 4, "hkv": 2, "lq": 32, "lk": 544, "d": 64,
     "pos": (0, 512, 100), "lens": (32, 32, 0), "window": 16,
     "quant": False},
    {"b": 3, "hq": 4, "hkv": 2, "lq": 32, "d": 64, "paged": True,
     "bs": 16, "nblk": 34, "pool": 110, "pos": (0, 512, 100),
     "lens": (32, 32, 0), "window": 16, "quant": True},
    # qwen2-1.5B serving: chunk 128 over 2,048 keys, head dim 128
    {"b": 8, "hq": 12, "hkv": 2, "lq": 128, "lk": 2048, "d": 128,
     "pos": (0, 128, 256, 700, 1000, 1500, 1800, 1920),
     "lens": (128, 128, 5, 128, 0, 77, 128, 128), "window": None,
     "quant": False},
    {"b": 8, "hq": 12, "hkv": 2, "lq": 128, "d": 128, "paged": True,
     "bs": 16, "nblk": 128, "pool": 1030,
     "pos": (0, 128, 256, 700, 1000, 1500, 1800, 1920),
     "lens": (128, 128, 5, 128, 0, 77, 128, 128), "window": None,
     "quant": True},
    # one rank of qwen2-1.5B on a (1, 2) partition: chunk 32, its 6 q
    # heads over its one KV head (flat bf16 and paged int8 KV, as chip_smoke
    # serves it)
    {"b": 4, "hq": 6, "hkv": 1, "lq": 32, "lk": 256, "d": 128,
     "pos": (0, 32, 100, 224), "lens": (32, 5, 0, 32), "window": None,
     "quant": False},
    {"b": 4, "hq": 6, "hkv": 1, "lq": 32, "d": 128, "paged": True,
     "bs": 16, "nblk": 16, "pool": 66, "pos": (0, 32, 100, 224),
     "lens": (32, 5, 0, 32), "window": None, "quant": True},
    # a 32k-key cache
    {"b": 2, "hq": 4, "hkv": 2, "lq": 32, "lk": 32768, "d": 128,
     "pos": (0, 32736), "lens": (32, 32), "window": None, "quant": False},
)


def _prefill_entry(case) -> str:
    return "flash_prefill_paged" if case.get("paged") else "flash_prefill"


@register_contract("attention", "cuda-prefill", cases=_PREFILL_CASES,
                   sweep_fields=("bq",))
def prefill_contract(case: dict, policy: ExecutionPolicy) -> LaunchContract:
    paged = bool(case.get("paged"))
    b, hq, hkv, lq, d = (case[k] for k in ("b", "hq", "hkv", "lq", "d"))
    group = hq // hkv
    lk = case["nblk"] * case["bs"] if paged else case["lk"]
    window = case["window"] or 0
    pos = np.asarray(case["pos"], np.int32)
    lens = np.asarray(case["lens"], np.int32)
    table = paged_table(b, case["nblk"], case["pool"]) if paged else None
    bq = max(1, min(policy.bq, lq))            # the wrapper's resolution
    plan = pre.prefill_plan(b, hkv, group, lq, bq, lk, d)
    gx, gy, gz = plan.grid
    nblocks = gx * gy * gz
    nrb = ceil_div(group * bq, RB)
    kv = "int8" if case["quant"] else case.get("kv", "bf16")

    @functools.cache
    def state(x, y, z):
        bi, h = divmod(x, hkv)
        qlo, r0 = (y // nrb) * bq, (y % nrb) * RB
        rows = min(RB, group * bq - r0)        # packed rows that exist
        q_first = qlo + r0 // group
        q_end = min(qlo + (r0 + rows - 1) // group, min(qlo + bq, lq) - 1)
        # the (head, query) tiles of the rows the block reads and writes
        box = _packed_rows(x, r0, r0 + rows, group, qlo, min(qlo + bq, lq))
        start, ln = int(pos[bi]), int(lens[bi])
        q_last = min(q_end, ln - 1)            # the last VALID query
        if q_first > q_last:                   # no valid row: zeros, once
            return {"b": bi, "h": h, "dead": True, "zero": z == 0,
                    "box": box}
        hi = min(start + q_last, lk - 1)
        lo = min(max(start + q_first - window + 1, 0), hi) if window else 0
        live = _split(lo, hi, plan.span, PK, z)
        if live is None:
            return None
        rbi = x * gy + y
        return {"b": bi, "h": h, "dead": False, "keys": live[1],
                "nlive": live[0], "rbi": rbi, "slot": rbi * gz + z,
                "box": box}
    multi = any((s := state(x, y, z)) and not s["dead"] and s["nlive"] > 1
                for x in range(gx) for y in range(gy) for z in range(gz))

    def qbox(x, y, z, *_):
        s = state(x, y, z)
        return None if s is None or s["dead"] else s["box"]

    def outbox(x, y, z, *_):
        s = state(x, y, z)
        return None if s is None or (s["dead"] and not s["zero"]) \
            else s["box"]

    def partial(width, base):
        def index_map(x, y, z, *_):
            s = state(x, y, z)
            if s is None or s["dead"] or s["nlive"] == 1:
                return None
            lo = base + s["slot"] * RB * width
            return (range(lo, lo + RB * width),)
        return index_map

    def counter(x, y, z, *_):
        s = state(x, y, z)
        if s is None or s["dead"] or s["nlive"] == 1:
            return None
        return (s["rbi"],)

    scalars = (pos, lens) if not paged else (pos, lens, table)
    box = (b * hkv, group, lq, d)
    blocks = [BlockContract("q", box, (1, 1, 1, d), qbox)]

    def walking(x, y, z):
        s = state(x, y, z)
        return None if s is None or s["dead"] else s
    blocks += _kv_operands(case, b * hkv, walking, paged=paged, table=table)
    blocks += _row_operands(case, scalars, walking)
    rev = (2,) if multi else ()
    blocks += [
        BlockContract("out", box, (1, 1, 1, d), outbox, is_output=True,
                      revisits=rev),
        BlockContract("work_acc", (plan.workspace,), (1,), partial(d, 0),
                      is_output=True),
        BlockContract("work_ml", (plan.workspace,), (1,),
                      partial(2, nblocks * RB * d), is_output=True),
        BlockContract("counters", (plan.counters,), (1,), counter,
                      is_output=True, revisits=rev),
    ]
    launch = KernelLaunch("flash_prefill_kernel", plan.grid, tuple(blocks),
                          threads=2 * RB, smem_bytes=prefill_smem(d, kv),
                          static_smem=SPLITK_STATIC)
    return LaunchContract((launch,), scalars=scalars,
                          num_scalars=len(scalars), entry=_prefill_entry(case),
                          body=lambda: _prefill_body(case, policy.bq),
                          tol=TOL)


def _prefill_body(case, bq):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(case["b"], case["hq"], case["lq"], case["d"],
                    generator=g)
    kw = {"pos": torch.as_tensor(np.asarray(case["pos"], np.int32)),
          "lengths": torch.as_tensor(np.asarray(case["lens"], np.int32)),
          "window": case["window"], "bq": bq}
    paged, quant = bool(case.get("paged")), case["quant"]
    if paged:
        kw["table"] = torch.from_numpy(paged_table(case["b"], case["nblk"],
                                                   case["pool"]))
    fn = {(False, False): pre.flash_prefill,
          (False, True): pre.flash_prefill_quant,
          (True, False): pre.flash_prefill_paged,
          (True, True): pre.flash_prefill_paged_quant}[(paged, quant)]
    return card_and_plain(fn, q, *_cache_inputs(case, g), **kw)


# --------------------------------------------------------------------------
# attention / cuda: flash_full.cu, the K/V pre-pass and the main launch
# --------------------------------------------------------------------------

_FLASH_CASES = (
    # the reference's cases
    {"b": 1, "hq": 4, "hkv": 2, "lq": 256, "lk": 300, "d": 64},
    {"b": 2, "hq": 2, "hkv": 2, "lq": 128, "lk": 128, "d": 128},
    # bf16 K/V (one term), a window, an offset, non-causal cross attention
    # at whisper's shape (1,500 frames)
    {"b": 1, "hq": 4, "hkv": 2, "lq": 256, "lk": 300, "d": 64, "kv": "bf16"},
    {"b": 2, "hq": 12, "hkv": 2, "lq": 128, "lk": 128, "d": 128,
     "window": 40},
    {"b": 1, "hq": 4, "hkv": 2, "lq": 64, "lk": 300, "d": 64,
     "offset": 236},
    {"b": 1, "hq": 6, "hkv": 6, "lq": 256, "lk": 1500, "d": 64,
     "causal": False},
)


@register_contract("attention", "cuda", cases=_FLASH_CASES)
def attention_contract(case: dict, policy: ExecutionPolicy) -> LaunchContract:
    b, hq, hkv, lq, lk, d = (case[k] for k in
                             ("b", "hq", "hkv", "lq", "lk", "d"))
    kv = case.get("kv", "f32")
    causal, window = case.get("causal", True), case.get("window") or 0
    offset = case.get("offset", 0)
    terms = 1 if kv == "bf16" else 3
    group = hq // hkv
    dp = _padded_d(d)
    work = full_workspace(b, hkv, lk, d, kv == "bf16")

    # split_kv_kernel: a grid-stride loop over n units of 4 head dims
    n = b * hkv * 2 * lk * (dp // 4)
    grid0 = min(ceil_div(n, SPLIT_KV_THREADS), SPLIT_KV_MAX_BLOCKS)
    stride = grid0 * SPLIT_KV_THREADS

    c4, plane = dp // 4, lk * (dp // 4)     # units a key row, a K/V plane

    def unit(i):
        """(terms offset, K or V row offset, column, K or V) of unit i: 4
        head dims of one key of one (row, kv-head)'s K or V."""
        col, r = i % c4 * 4, i // c4
        key, r = r % lk, r // lk
        bh, c = r // 2, r % 2
        return (((bh * 2 * terms + c * terms) * lk + key) * dp + col,
                (bh * lk + key) * d, col, c)

    @functools.cache
    def walk(x):
        """Per K/V plane of each iteration of block x's grid-stride loop:
        (the ranges of the plane's T terms written, K or V, the range of
        it read: columns past D are padding, written as zeros)."""
        out = []
        for i0 in range(x * SPLIT_KV_THREADS, n, stride):
            u, i1 = i0, min(i0 + SPLIT_KV_THREADS, n)
            while u < i1:
                e = min(i1, (u // plane + 1) * plane)
                t0, row0, col0, c = unit(u)
                t1, row1, col1, _ = unit(e - 1)
                out.append(([range(t0 + t * lk * dp, t1 + 4 + t * lk * dp)
                             for t in range(terms)], c,
                            span(row0 + min(col0, d),
                                 row1 + min(col1 + 4, d))))
                u = e
        return out

    def terms_written(x, *_):
        return [(r,) for ranges, _, _ in walk(x) for r in ranges]

    def kv_read(which):
        def index_map(x, *_):
            return [(r,) for _, c, r in walk(x) if c == which and r]
        return index_map

    flat_kv = (b * hkv * lk * d,)
    kv_es = _ES[kv]
    pre_pass = KernelLaunch(
        "split_kv_kernel", (grid0,), (
            BlockContract("k", flat_kv, (1,), kv_read(0), dtype_bytes=kv_es),
            BlockContract("v", flat_kv, (1,), kv_read(1), dtype_bytes=kv_es),
            BlockContract("terms", (work,), (1,), terms_written,
                          dtype_bytes=2, is_output=True)),
        threads=SPLIT_KV_THREADS)

    rblocks = ceil_div(lq * group, FR)

    @functools.cache
    def state(x, y):
        r0 = (rblocks - 1 - y) * FR                  # long rows first
        q_first = r0 // group
        q_last = min((r0 + FR - 1) // group, lq - 1)
        hi = min(lk - 1, offset + q_last) if causal else lk - 1
        lo = max(0, offset + q_first - window + 1) if window else 0
        k_begin = lo // PK * PK
        return {"keys": (k_begin, hi + 1) if hi >= k_begin else None,
                "rows": _packed_rows(x, r0, r0 + FR, group, 0, lq)}

    def terms_read(x, y, *_):
        keys = state(x, y)["keys"]
        if keys is None:
            return None
        lo = ((x * 2 * terms) * lk + keys[0]) * dp
        hi = ((x * 2 * terms + 2 * terms - 1) * lk + keys[1] - 1) * dp + dp
        return (range(lo, hi),)

    def rowbox(x, y, *_):
        return state(x, y)["rows"]

    box = (b * hkv, group, lq, d)
    main = KernelLaunch(
        "flash_full_kernel", (b * hkv, rblocks), (
            BlockContract("q", box, (1, 1, 1, d), rowbox),
            BlockContract("terms", (work,), (1,), terms_read, dtype_bytes=2),
            BlockContract("out", box, (1, 1, 1, d), rowbox, is_output=True)),
        threads=FT, smem_bytes=full_smem(d, terms))
    return LaunchContract((pre_pass, main), entry="flash_attention_full",
                          body=lambda: _full_body(case), tol=TOL)


def _full_body(case):
    g = torch.Generator().manual_seed(0)
    dt = _TORCH[case.get("kv", "f32")]
    q = torch.randn(case["b"], case["hq"], case["lq"], case["d"],
                    generator=g)
    shape = (case["b"], case["hkv"], case["lk"], case["d"])
    k = torch.randn(shape, generator=g).to(dt)
    v = torch.randn(shape, generator=g).to(dt)
    return card_and_plain(flash_attention, q, k, v,
                          causal=case.get("causal", True),
                          window=case.get("window"),
                          offset=case.get("offset", 0))


