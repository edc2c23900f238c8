"""The port's CUDA kernels on the card against their plain versions. Every
test here is marked `cuda` and skips without a CUDA device; run them on a
machine with an H100:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the machine with the card has none). Attention:
tolerance 1e-4 (atol and rtol), f32 attention summed in another order than
the plain version's; the fused int8-KV kernels must equal the same kernels
run on the dequantized f32 K/V bitwise, prefill pad rows must be exact
zeros, and the paged kernels must equal the flat kernels on the un-paged
cache bitwise at every block size. AIO GEMM: integer modes bitwise, float modes rtol 2e-5, atol 2e-5 *
max|plain|; the quantizer bitwise, on every float32 bit pattern at scale 1
and every pattern of its formats' edge binades at other scales:

    python -m pytest -q -m cuda tests/test_torch_cuda.py -k quant"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_smoke
from repro_torch.core import formats as F
from repro_torch.kernels.aio_matmul import (MODES, aio_matmul,
                                            aio_matmul_plain, gemm_plan,
                                            quantize_operands_ref)
from repro_torch.kernels.aio_quant import (KERNEL_FLOOR, aio_quant,
                                           aio_quant_plain, quant_edge_rows)
from repro_torch.kernels.aio_quant import ops as quant_ops
from repro_torch.kernels.aio_quant.ops import (CLUSTER_SIZES, MAX_THREADS,
                                               MAX_UNITS, QUANT_FORMATS,
                                               QuantPlan, plan_with)
from repro_torch.kernels.depthwise import depthwise_conv, depthwise_plain
from repro_torch.kernels.flash_attention import (
    KERNELS, PAGED_KERNELS, flash_attention, flash_attention_plain,
    flash_decode, flash_decode_paged,
    flash_decode_paged_plain, flash_decode_paged_quant,
    flash_decode_paged_quant_plain, flash_decode_plain,
    flash_decode_quant, flash_decode_quant_plain, flash_prefill,
    flash_prefill_paged,
    flash_prefill_paged_plain, flash_prefill_paged_quant,
    flash_prefill_paged_quant_plain, flash_prefill_plain,
    flash_prefill_quant, flash_prefill_quant_plain)
from repro_torch.kernels.flash_attention.shared import dequant
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain,
                                                grouped_plan, make_group_ids,
                                                pack_tenants)
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.models.attention import _q8
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(dev, seed, b, hq, hkv, lq, lk, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    # q as the engine hands it over: a head-split (strided) view
    q = torch.randn(b, lq, hq, d, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(b, hkv, lk, d, generator=g, device=dev)
    v = torch.randn(b, hkv, lk, d, generator=g, device=dev)
    return q * 0.5, k * 0.5, v


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("group,lq,lk,window,softcap,kv_dtype", [
    (6, 1, 2048, None, None, torch.bfloat16),
    (6, 1, 2048, None, None, torch.float32),
    (4, 1, 300, 48, 30.0, torch.bfloat16),
    (4, 4, 300, 48, 30.0, torch.bfloat16),
    (1, 8, 257, None, None, torch.float32),
    (6, 4, 300, None, None, torch.bfloat16),
])
@pytest.mark.parametrize("d,bkv", [(128, 128), (16, 32)])
def test_decode_kernel_matches_plain(dev, group, lq, lk, window, softcap,
                                     kv_dtype, d, bkv):
    b, hkv = 5, 2
    q, k, v = _data(dev, 1, b, hkv * group, hkv, lq, lk, d)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    pos = torch.tensor([0, 127, 128, lk // 2, lk - lq], dtype=torch.int32,
                       device=dev)
    n = flash_decode.launches
    got = flash_decode(q, k, v, pos=pos, window=window, softcap=softcap,
                       bkv=bkv)
    torch.cuda.synchronize()
    assert flash_decode.launches == n + 1
    _close(got, flash_decode_plain(q, k, v, pos=pos, window=window,
                                   softcap=softcap))


@pytest.mark.parametrize("group,w,lk,window,softcap,bq", [
    (6, 32, 2048, None, None, 32),
    (4, 20, 300, 48, 30.0, 8),
    (1, 13, 257, None, None, 32),
])
def test_prefill_kernel_matches_plain_with_zero_pad_rows(dev, group, w, lk,
                                                         window, softcap, bq):
    b, hkv = 5, 2
    q, k, v = _data(dev, 2, b, hkv * group, hkv, w, lk)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    pos = torch.tensor([0, 127, 128, 3, lk - w], dtype=torch.int32,
                       device=dev)
    lens = torch.tensor([w, 1, w // 2 + 1, 0, w], dtype=torch.int32,
                        device=dev)
    got = flash_prefill(q, k, v, pos=pos, lengths=lens, window=window,
                        softcap=softcap, bq=bq)
    want = flash_prefill_plain(q, k, v, pos=pos, lengths=lens, window=window,
                               softcap=softcap)
    _close(got, want)
    pad = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    assert not got.transpose(1, 2)[pad].any()


@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
def test_fused_int8_equals_kernel_on_dequantized_kv(dev, window, softcap):
    b, hkv, group, lk = 4, 2, 6, 512
    q1, k, v = _data(dev, 3, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 4, b, hkv * group, hkv, 32, lk)
    kc, ks = _q8(k)
    vc, vs = _q8(v)
    kd, vd = dequant(kc, ks, torch.float32), dequant(vc, vs, torch.float32)
    pos = torch.tensor([0, 100, 300, lk - 32], dtype=torch.int32, device=dev)
    lens = torch.tensor([32, 7, 0, 32], dtype=torch.int32, device=dev)
    kw = dict(window=window, softcap=softcap)
    assert torch.equal(
        flash_decode_quant(q1, kc, ks, vc, vs, pos=pos, **kw),
        flash_decode(q1, kd, vd, pos=pos, **kw))
    assert torch.equal(
        flash_prefill_quant(qw, kc, ks, vc, vs, pos=pos, lengths=lens, **kw),
        flash_prefill(qw, kd, vd, pos=pos, lengths=lens, **kw))


def _kv_forms(k, v, kv):
    """K/V as the kernels take them: bf16 or f32 caches, or int8 codes and
    scales (flat arguments of the prefill wrappers, and their kernel)."""
    if kv == "int8":
        kc, ks = _q8(k)
        vc, vs = _q8(v)
        return (kc, ks, vc, vs), flash_prefill_quant
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    return (k.to(dtype), v.to(dtype)), flash_prefill


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, 30.0)])
def test_prefill_long_rows_span_many_splits(dev, kv, window, softcap):
    """Rows near the end of a 4096-key cache (16 key splits) against the
    plain version, pad rows exactly 0; the int8 kernel equals the kernel on
    the dequantized K/V bitwise, and the paged kernel at block sizes 16,
    32 and 128 equals the flat one bitwise."""
    b, hkv, group, lk, w = 4, 2, 6, 4096, 32
    qw, k, v = _data(dev, 21, b, hkv * group, hkv, w, lk)
    pos = torch.tensor([lk - w, 4000, 2500, 0], dtype=torch.int32,
                       device=dev)
    lens = torch.tensor([w, 7, w, 0], dtype=torch.int32, device=dev)
    flat, kern = _kv_forms(k, v, kv)
    kw = dict(pos=pos, lengths=lens, window=window, softcap=softcap)
    got = kern(qw, *flat, **kw)
    if kv == "int8":
        deq = (dequant(flat[0], flat[1], torch.float32),
               dequant(flat[2], flat[3], torch.float32))
        assert torch.equal(got, flash_prefill(qw, *deq, **kw))
        _close(got, flash_prefill_quant_plain(qw, *flat, **kw))
    else:
        _close(got, flash_prefill_plain(qw, *flat, **kw))
    pad = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    assert not got.transpose(1, 2)[pad].any()
    paged = flash_prefill_paged_quant if kv == "int8" else flash_prefill_paged
    for bs in (16, 32, 128):
        pools, table = _paged(dev, flat, bs, seed=bs)
        assert torch.equal(paged(qw, *pools, table=table, **kw), got), bs


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
def test_prefill_query_does_not_depend_on_chunk_width(dev, kv, window,
                                                      softcap):
    """A query's output is bitwise the same whether it arrives alone (W =
    1), in a 5-token chunk or in a 32-token one, at any index of the chunk,
    beside any other rows: its sums depend on its position and keys only
    (splits and tiles at absolute key positions)."""
    b, hkv, group, lk = 3, 2, 6, 1024
    _, k, v = _data(dev, 22, b, hkv * group, hkv, 1, lk)
    flat, kern = _kv_forms(k, v, kv)
    g = torch.Generator(device=dev).manual_seed(23)
    target = torch.randn(hkv * group, 128, generator=g, device=dev) * 0.5
    row, at = 1, 700                    # the query: row 1, position 700
    outs = []
    for w, idx, others in ((1, 0, (0, 1)), (5, 2, (600, 3)),
                           (32, 30, (0, 32)), (32, 0, (1000, 24))):
        q = torch.randn(b, w, hkv * group, 128, generator=g,
                        device=dev) * 0.5
        q[row, idx] = target
        q = q.transpose(1, 2)           # the engine's head-split view
        pos = torch.tensor([others[0], at - idx, 900], dtype=torch.int32,
                           device=dev)
        lens = torch.tensor([others[1], w, min(w, 3)], dtype=torch.int32,
                            device=dev)
        out = kern(q, *flat, pos=pos, lengths=lens, window=window,
                   softcap=softcap)
        outs.append(out[row, :, idx])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def _decode_forms(k, v, kv):
    """K/V as the decode kernels take them, and their flat and paged
    wrappers."""
    if kv == "int8":
        kc, ks = _q8(k)
        vc, vs = _q8(v)
        return (kc, ks, vc, vs), flash_decode_quant, flash_decode_paged_quant
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    return (k.to(dtype), v.to(dtype)), flash_decode, flash_decode_paged


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("lq,window,softcap", [(1, None, None),
                                               (1, 300, 30.0),
                                               (4, 700, 50.0)])
def test_decode_rows_span_many_splits(dev, kv, lq, window, softcap):
    """Rows across a 4096-key cache (32 key splits of 128) against the
    plain version, with and without a window and a softcap; the int8
    kernel equals the kernel on the dequantized K/V bitwise, and the paged
    kernel at block sizes 16, 32 and 128 equals the flat one bitwise."""
    b, hkv, group, lk = 5, 2, 6, 4096
    q, k, v = _data(dev, 24, b, hkv * group, hkv, lq, lk)
    pos = torch.tensor([lk - lq, 4000, 2500, 0, 130], dtype=torch.int32,
                       device=dev)
    flat, kern, paged = _decode_forms(k, v, kv)
    kw = dict(pos=pos, window=window, softcap=softcap)
    got = kern(q, *flat, **kw)
    if kv == "int8":
        deq = (dequant(flat[0], flat[1], torch.float32),
               dequant(flat[2], flat[3], torch.float32))
        assert torch.equal(got, flash_decode(q, *deq, **kw))
        _close(got, flash_decode_quant_plain(q, *flat, **kw))
    else:
        _close(got, flash_decode_plain(q, *flat, **kw))
    for bs in (16, 32, 128):
        pools, table = _paged(dev, flat, bs, seed=bs)
        assert torch.equal(paged(q, *pools, table=table, **kw), got), bs


@pytest.mark.parametrize("span", [64, 256, 512])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_decode_other_split_spans_match_plain(dev, monkeypatch, span, kv):
    """A sweep of the split span (`decode.SPLIT_KEYS` patched) runs the
    same kernel: spans of 256 and more give a warp two tiles of a split,
    the second staged into its buffer once the first is computed. Each
    span is within 1e-4 of the plain version and paged equals flat
    bitwise."""
    from repro_torch.kernels.flash_attention import decode as decode_mod
    monkeypatch.setattr(decode_mod, "SPLIT_KEYS", span)
    b, hkv, group, lk = 4, 2, 6, 2048
    q, k, v = _data(dev, 27, b, hkv * group, hkv, 1, lk)
    pos = torch.tensor([lk - 1, 1000, 37, 700], dtype=torch.int32,
                       device=dev)
    flat, kern, paged = _decode_forms(k, v, kv)
    kw = dict(pos=pos, window=900, softcap=30.0)
    got = kern(q, *flat, **kw)
    plain = flash_decode_quant_plain if kv == "int8" else flash_decode_plain
    _close(got, plain(q, *flat, **kw))
    pools, table = _paged(dev, flat, 16, seed=span)
    assert torch.equal(paged(q, *pools, table=table, **kw), got)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, 30.0)])
def test_decode_row_does_not_depend_on_other_rows(dev, kv, window, softcap):
    """A decode row's output is bitwise the same beside any other rows, at
    any batch index and batch size: its splits and tiles are cut at
    absolute key positions and merged in a fixed order."""
    hkv, group, lk, at = 2, 6, 2048, 1700
    _, k, v = _data(dev, 25, 4, hkv * group, hkv, 1, lk)
    flat, kern, _ = _decode_forms(k, v, kv)
    g = torch.Generator(device=dev).manual_seed(26)
    target = torch.randn(hkv * group, 128, generator=g, device=dev) * 0.5
    outs = []
    for b, row, others in ((1, 0, ()), (4, 2, (0, 2047, 900)),
                           (4, 0, (5, 1, 1000)), (3, 1, (129, 2000))):
        q = torch.randn(b, 1, hkv * group, 128, generator=g,
                        device=dev) * 0.5
        q[row, 0] = target
        pos = list(others)
        pos.insert(row, at)
        idx = [i for i in range(4) if i != 1][:b - 1]
        idx.insert(row, 1)              # the row's own cache stays row 1
        cache = tuple(t[idx] for t in flat)
        out = kern(q.transpose(1, 2), *cache,
                   pos=torch.tensor(pos, dtype=torch.int32, device=dev),
                   window=window, softcap=softcap)
        outs.append(out[row])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_wrapper_rejects_bad_operands(dev):
    q, k, v = _data(dev, 5, 2, 4, 2, 1, 64)
    kb = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, kb.transpose(2, 3).contiguous().transpose(2, 3),
                     kb, pos=3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, kb.cpu(), kb, pos=3)
    with pytest.raises(ValueError, match="bkv"):
        flash_decode(q, kb, kb, pos=3, bkv=48)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode(torch.zeros(2, 4, 1, 132, device=dev),
                     torch.zeros(2, 2, 8, 132, device=dev),
                     torch.zeros(2, 2, 8, 132, device=dev), pos=3)
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode(q, torch.zeros_like(kb, dtype=torch.int8),
                     torch.zeros_like(kb, dtype=torch.int8), pos=3)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_on_card_matches_ref_engine(dev, kv_quant):
    """The smoke config served through the kernels emits the tokens the
    plain reference route emits on the card, and every kernel of the path
    launched."""
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    model = init_params(cfg, seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (3, 40, 5, 18)]
    outs = {}
    for backend in ("auto", "ref"):
        eng = ServingEngine(cfg, model, slots=2, max_len=128,
                            prefill_chunk=16,
                            policy=api.ExecutionPolicy(backend=backend))
        for k in KERNELS:
            k.launches = 0
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=6))
        outs[backend] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        launched = {k.__name__: k.launches for k in KERNELS}
        used = [n for n in launched if n.endswith("_quant") == kv_quant]
        if backend == "auto":
            assert all(launched[n] > 0 for n in used), launched
        else:
            assert not any(launched.values()), launched
    assert outs["auto"] == outs["ref"]


def _family_prompts(cfg, head=0):
    """Prompts that cross gemma2 SMOKE's window of 16 in prefill and in
    decode, optionally behind a shared head."""
    rng = np.random.RandomState(1)
    shared = rng.randint(1, cfg.vocab, head).astype(np.int32)
    return [np.concatenate([shared, rng.randint(1, cfg.vocab, n)])
            .astype(np.int32) for n in (3, 40, 11, 25)]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_gemma2_engine_on_card_matches_ref_engine(dev, kv_quant):
    """gemma2 SMOKE (local window 16 on every other layer, softcaps 50 / 30,
    head_dim 16, GQA group 2) through the kernels emits the ref route's
    tokens over prompts and decodes that cross the window."""
    cfg = dataclasses.replace(get_smoke("gemma2_27b"), kv_quant=kv_quant)
    model = init_params(cfg, seed=0)
    outs = {}
    for backend in ("auto", "ref"):
        eng = ServingEngine(cfg, model, slots=2, max_len=128,
                            prefill_chunk=16,
                            policy=api.ExecutionPolicy(backend=backend))
        for k in KERNELS:
            k.launches = 0
        for rid, p in enumerate(_family_prompts(cfg)):
            eng.submit(Request(rid, p, max_new_tokens=24))
        outs[backend] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        used = [k for k in KERNELS if k.__name__.endswith("_quant") == kv_quant]
        assert all((k.launches > 0) == (backend == "auto") for k in used)
    assert outs["auto"] == outs["ref"]


@pytest.mark.parametrize("arch,head", [("gemma2_27b", 20),
                                       ("olmoe_1b_7b", 0)])
def test_family_paged_engine_on_card_matches_flat_engine(dev, arch, head):
    """gemma2's windowed layers and olmoe's MoE layers served from the
    block pool through the paged kernels emit the per-slot kernel engine's
    tokens (on MoE configs a chunk's pad rows compete for expert capacity,
    so this also holds the paged kernels' pad rows to the flat ones').
    gemma2's prompts share a head (prefix hits); olmoe's do not: a hit
    skips the shared tokens' prefill, which changes the launches whose
    positions compete for capacity, in the reference as in the port."""
    cfg = get_smoke(arch)
    model = init_params(cfg, seed=0)
    outs = {}
    for paged in (False, True):
        eng = ServingEngine(cfg, model, slots=2, max_len=128,
                            prefill_chunk=16, paged=paged, block_size=16)
        for kern in PAGED_KERNELS:
            kern.launches = 0
        for rid, p in enumerate(_family_prompts(cfg, head=head)):
            eng.submit(Request(rid, p, max_new_tokens=24))
        outs[paged] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        assert (flash_prefill_paged.launches > 0) == paged
    assert outs[True] == outs[False]
    assert (eng.pool_stats()["prefix_hits"] > 0) == (head > 0)


# ======================================================= paged attention
def _paged(dev, flat, bs, seed):
    """A (B, Hkv, L, X) cache scattered into a shuffled (B * L / bs, Hkv,
    bs, X) pool, and its (B, L / bs) int32 table."""
    b, _, lk, _ = flat[0].shape
    nblk = lk // bs
    g = torch.Generator().manual_seed(seed)
    table = torch.randperm(b * nblk, generator=g).reshape(b, nblk).to(dev)
    pools = []
    for a in flat:
        blocks = a.reshape(b, a.shape[1], nblk, bs, a.shape[3]).transpose(1, 2)
        pool = torch.empty((b * nblk,) + blocks.shape[2:], dtype=a.dtype,
                           device=dev)
        pool[table.reshape(-1)] = blocks.reshape((-1,) + blocks.shape[2:])
        pools.append(pool)
    return pools, table.to(torch.int32)


@pytest.mark.parametrize("bs", [8, 16, 32, 128])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_kernels_bitwise_equal_flat(dev, bs, kv):
    """At the same bkv the paged kernels read through the table the keys
    the flat kernels read, in the same order: bitwise equal outputs, at
    ragged positions (a fresh row, a full one) and lengths (a full chunk,
    3 tokens, an idle row)."""
    b, hkv, group, lk, w = 4, 2, 6, 512, 32
    q1, k, v = _data(dev, 11, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 12, b, hkv * group, hkv, w, lk)
    if kv == "int8":
        kc, ks = _q8(k)
        vc, vs = _q8(v)
        flat, dec, pre = (kc, ks, vc, vs), flash_decode_quant, \
            flash_prefill_quant
        pdec, ppre = flash_decode_paged_quant, flash_prefill_paged_quant
    else:
        flat = (k.to(torch.bfloat16), v.to(torch.bfloat16))
        dec, pre = flash_decode, flash_prefill
        pdec, ppre = flash_decode_paged, flash_prefill_paged
    pools, table = _paged(dev, flat, bs, seed=bs)
    pos = torch.tensor([0, 37, lk - 1, 200], dtype=torch.int32, device=dev)
    ppos = torch.tensor([0, 37, lk - w, 200], dtype=torch.int32, device=dev)
    lens = torch.tensor([w, 3, w, 0], dtype=torch.int32, device=dev)
    n = pdec.launches, ppre.launches
    for kw in ({}, dict(window=48, softcap=30.0)):
        assert torch.equal(pdec(q1, *pools, table=table, pos=pos, **kw),
                           dec(q1, *flat, pos=pos, **kw))
        assert torch.equal(
            ppre(qw, *pools, table=table, pos=ppos, lengths=lens, **kw),
            pre(qw, *flat, pos=ppos, lengths=lens, **kw))
    torch.cuda.synchronize()
    assert (pdec.launches, ppre.launches) == (n[0] + 2, n[1] + 2)


@pytest.mark.parametrize("bs,kv_dtype", [(16, torch.bfloat16),
                                         (8, torch.float32)])
def test_paged_kernels_match_plain(dev, bs, kv_dtype):
    b, hkv, group, lk, w = 5, 2, 4, 304, 20
    q1, k, v = _data(dev, 13, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 14, b, hkv * group, hkv, w, lk)
    pools, table = _paged(dev, (k.to(kv_dtype), v.to(kv_dtype)), bs, seed=1)
    pos = torch.tensor([0, 127, 128, 5, lk - w], dtype=torch.int32,
                       device=dev)
    lens = torch.tensor([w, 1, 11, 0, w], dtype=torch.int32, device=dev)
    kw = dict(window=48, softcap=30.0)
    _close(flash_decode_paged(q1, *pools, table=table, pos=pos, **kw),
           flash_decode_paged_plain(q1, *pools, table=table, pos=pos, **kw))
    got = flash_prefill_paged(qw, *pools, table=table, pos=pos,
                              lengths=lens, **kw)
    _close(got, flash_prefill_paged_plain(qw, *pools, table=table, pos=pos,
                                          lengths=lens, **kw))
    pad = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    assert not got.transpose(1, 2)[pad].any()


def test_paged_fused_int8_equals_kernel_on_dequantized_pool(dev):
    b, hkv, group, lk = 4, 2, 6, 256
    q1, k, v = _data(dev, 15, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 16, b, hkv * group, hkv, 32, lk)
    kc, ks = _q8(k)
    vc, vs = _q8(v)
    (pkc, pks, pvc, pvs), table = _paged(dev, (kc, ks, vc, vs), 16, seed=2)
    pkd, pvd = dequant(pkc, pks, torch.float32), dequant(pvc, pvs,
                                                         torch.float32)
    pos = torch.tensor([0, 100, 200, lk - 32], dtype=torch.int32, device=dev)
    lens = torch.tensor([32, 7, 0, 32], dtype=torch.int32, device=dev)
    kw = dict(table=table, pos=pos)
    assert torch.equal(flash_decode_paged_quant(q1, pkc, pks, pvc, pvs, **kw),
                       flash_decode_paged(q1, pkd, pvd, **kw))
    assert torch.equal(
        flash_prefill_paged_quant(qw, pkc, pks, pvc, pvs, lengths=lens, **kw),
        flash_prefill_paged(qw, pkd, pvd, lengths=lens, **kw))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_one_kv_head_shard_matches_plain(dev, kv, paged):
    """One rank of qwen2-1.5B on a (1, 2) partition: its 6 q heads over its
    one KV head (a GQA group of 6, head dim 128), a decode step and a
    32-token chunk, flat and paged, bf16 and int8 K/V, against the plain
    versions (1e-4); the chunk's pad rows exactly 0."""
    b, hkv, group, lk, w = 4, 1, 6, 512, 32
    q1, k, v = _data(dev, 21, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 22, b, hkv * group, hkv, w, lk)
    if kv == "int8":
        kc, ks = _q8(k)
        vc, vs = _q8(v)
        cache = (kc, ks, vc, vs)
    else:
        cache = (k.to(torch.bfloat16), v.to(torch.bfloat16))
    fns = {(False, "bf16"): (flash_decode, flash_decode_plain, flash_prefill,
                             flash_prefill_plain),
           (False, "int8"): (flash_decode_quant, flash_decode_quant_plain,
                             flash_prefill_quant, flash_prefill_quant_plain),
           (True, "bf16"): (flash_decode_paged, flash_decode_paged_plain,
                            flash_prefill_paged, flash_prefill_paged_plain),
           (True, "int8"): (flash_decode_paged_quant,
                            flash_decode_paged_quant_plain,
                            flash_prefill_paged_quant,
                            flash_prefill_paged_quant_plain)}
    dec, dec_plain, pre, pre_plain = fns[(paged, kv)]
    kw = {}
    if paged:
        cache, kw["table"] = _paged(dev, cache, 16, seed=21)
    pos = torch.tensor([0, 17, 300, lk - 1], dtype=torch.int32, device=dev)
    ppos = torch.tensor([0, 17, 300, lk - w], dtype=torch.int32, device=dev)
    lens = torch.tensor([w, 5, 0, w], dtype=torch.int32, device=dev)
    n = dec.launches, pre.launches
    _close(dec(q1, *cache, pos=pos, **kw),
           dec_plain(q1, *cache, pos=pos, **kw))
    got = pre(qw, *cache, pos=ppos, lengths=lens, **kw)
    _close(got, pre_plain(qw, *cache, pos=ppos, lengths=lens, **kw))
    torch.cuda.synchronize()
    assert (dec.launches, pre.launches) == (n[0] + 1, n[1] + 1)
    pad = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    assert not got.transpose(1, 2)[pad].any()


def test_paged_wrapper_rejects_bad_operands(dev):
    q, k, v = _data(dev, 17, 2, 4, 2, 1, 64)
    (pk, pv), table = _paged(dev, (k.to(torch.bfloat16),
                                   v.to(torch.bfloat16)), 16, seed=3)
    with pytest.raises(ValueError, match="block table"):
        flash_decode_paged(q, pk, pv, table=table.long(), pos=3)
    with pytest.raises(ValueError, match="block table"):
        flash_decode_paged(q, pk, pv, table=table[:1], pos=3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_paged(q, pk, pv, table=table.cpu(), pos=3)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_engine_on_card_matches_flat_engine(dev, kv_quant):
    """The smoke config served from the block pool through the paged
    kernels emits the per-slot kernel engine's tokens over a mix sharing a
    prompt prefix; only the paged kernels launch in the paged pass."""
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    model = init_params(cfg, seed=0)
    rng = np.random.RandomState(0)
    head = rng.randint(1, cfg.vocab, 37).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(1, cfg.vocab, n)])
               .astype(np.int32) for n in (3, 40, 5, 18)]
    outs = {}
    for paged in (False, True):
        eng = ServingEngine(cfg, model, slots=2, max_len=128,
                            prefill_chunk=16, paged=paged, block_size=16)
        for kern in (*KERNELS, *PAGED_KERNELS):
            kern.launches = 0
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=6))
        outs[paged] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        used, idle = (PAGED_KERNELS, KERNELS) if paged else \
            (KERNELS, PAGED_KERNELS)
        used = [kern for kern in used
                if kern.__name__.endswith("_quant") == kv_quant]
        assert all(kern.launches > 0 for kern in used)
        assert not any(kern.launches for kern in idle)
    assert outs[True] == outs[False]
    assert eng.pool_stats()["prefix_hits"] > 0


# ====================================================== AIO GEMM + quantizer
def _gemm_operands(dev, mode, m, k, n, seed):
    """Quantized operands as the kernel takes them: x codes (int4: one per
    byte), w codes (int4: packed along K), per-row / per-column pow2
    scales; bf16 operands without scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
    xq, wq, xs, ws = quantize_operands_ref(x, w, mode)
    if mode == "bf16":
        return xq, wq, None, None
    if mode == "int4":
        return (xq.to(torch.int8), F.pack_int4(wq.t()).t().contiguous(),
                xs, ws)
    return xq.to(torch.int8), wq.to(torch.int8), xs, ws


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n", [(8, 1536, 256), (256, 1536, 1536),
                                   (7, 131, 40), (33, 200, 130),
                                   (16, 64, 16), (8, 8960, 256),
                                   (256, 8960, 1536), (40, 1536, 256),
                                   (37, 1001, 130)])
def test_gemm_kernel_matches_plain(dev, mode, m, k, n):
    """Integer modes bitwise; float modes within rtol 2e-5, atol 2e-5 *
    max|plain| (float32 sums in another order). The shapes take every
    row tile (M up to 16, 32, above), split K over slices with a narrow and
    a wide N, and ragged K with rows that are not 16-byte aligned (K 1001:
    odd int4 K; N 130)."""
    x, w, xs, ws = _gemm_operands(dev, mode, m, k, n, seed=m + k + n)
    before = aio_matmul.launches
    got = aio_matmul(x, w, xs, ws, mode=mode)
    torch.cuda.synchronize()
    assert aio_matmul.launches == before + 1
    want = aio_matmul_plain(x, w, xs, ws, mode=mode)
    if mode in ("int8", "int4"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5,
                                   atol=2e-5 * want.abs().max().item())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n", [(1536, 8960), (8960, 1536), (1536, 1536),
                                 (1536, 256), (200, 1536)])
def test_gemm_rows_do_not_depend_on_m(dev, mode, k, n):
    """A row's result is the same at every width the engine launches, from
    one row to the chunk width (the launch plan, and so the K reduction
    order, does not depend on M), bitwise in every mode. The shapes take
    every plan `gemm_plan` gives: 128 columns unsplit (gate/up) and split
    (down), 64 columns split (q/o, k/v) and unsplit (a short K)."""
    x, w, xs, ws = _gemm_operands(dev, mode, 256, k, n, seed=9)
    full = aio_matmul(x, w, xs, ws, mode=mode)
    for m in (1, 8, 17, 64, 100, 256):
        part = aio_matmul(x[:m].contiguous(), w,
                          None if xs is None else xs[:m].contiguous(), ws,
                          mode=mode)
        assert torch.equal(full[:m], part), m


@pytest.mark.parametrize("kernel", ["aio_matmul", "grouped_matmul",
                                    "flash_prefill", "flash_decode"])
def test_split_k_launches_on_two_streams_do_not_race(dev, kernel):
    """Split-K launches queued on two streams at once (B5's down projection
    at M = 8, 11 slices; B9 on a two-model mix, 6 slices; the prefill
    kernel over rows of up to 16 key splits; the decode kernel over rows of
    up to 32) each take the tile counters of their own stream: every
    result equals the one computed alone, bitwise (the slices are summed
    in index order)."""
    if kernel == "flash_decode":
        q1, k, v = _data(dev, 32, 4, 12, 2, 1, 4096)
        pos = torch.tensor([4095, 3000, 100, 2047], dtype=torch.int32,
                           device=dev)
        run = functools.partial(flash_decode, q1, k.to(torch.bfloat16),
                                v.to(torch.bfloat16), pos=pos)
    elif kernel == "flash_prefill":
        qw, k, v = _data(dev, 31, 4, 12, 2, 32, 4096)
        pos = torch.tensor([4064, 3000, 100, 2047], dtype=torch.int32,
                           device=dev)
        lens = torch.tensor([32, 9, 32, 1], dtype=torch.int32, device=dev)
        run = functools.partial(flash_prefill, qw, k.to(torch.bfloat16),
                                v.to(torch.bfloat16), pos=pos, lengths=lens)
    elif kernel == "aio_matmul":
        x, w, xs, ws = _gemm_operands(dev, "fp8a", 8, 8960, 1536, seed=5)
        assert gemm_plan(8960, 1536, "fp8a")[1] > 1
        run = functools.partial(aio_matmul, x, w, xs, ws, mode="fp8a")
    else:
        g = torch.Generator(device=dev).manual_seed(5)
        shapes = [(128, 4096, 4096), (256, 1536, 1536)]
        tenants = [(torch.randn(m, k, generator=g, device=dev),
                    torch.randn(k, n, generator=g, device=dev))
                   for m, k, n in shapes]
        x, w, sizes, _ = pack_tenants(tenants, 128, 128, 128)
        gids = make_group_ids(sizes, 128, device=dev)
        assert grouped_plan(x.shape[0], x.shape[1], w.shape[2], 128)[2] > 1
        run = functools.partial(grouped_matmul, gids, x, w)
    want = run()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(40):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(run())
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("mode", ["fp8a", "fp8b"])
def test_gemm_fp8_decode_is_exact(dev, mode):
    """Each of the 256 codes, subnormal ones included, goes through the
    kernel's decode exactly, as x and as w: a one-hot GEMM returns the
    decoded values bitwise."""
    fmt = F.REGISTRY[mode]
    codes = torch.arange(256, dtype=torch.int32)
    want = F.decode(codes, fmt).to(dev)
    bits = codes.to(torch.uint8).view(torch.int8).to(dev)
    one = F.encode(torch.ones(1), fmt).to(torch.uint8).view(torch.int8)
    eye = torch.diag(one.to(dev).expand(256)).contiguous()
    ones = functools.partial(torch.ones, dtype=torch.float32, device=dev)
    as_w = aio_matmul(eye, bits.view(256, 1).expand(256, 16).contiguous(),
                      ones(256, 1), ones(1, 16), mode=mode)
    as_x = aio_matmul(bits.view(256, 1).contiguous(),
                      one.to(dev).expand(1, 16).contiguous(), ones(256, 1),
                      ones(1, 16), mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(as_w, want.view(256, 1).expand(256, 16))
    assert torch.equal(as_x, want.view(256, 1).expand(256, 16))


@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
@pytest.mark.parametrize("floor", [KERNEL_FLOOR, F.FLT_MIN])
@pytest.mark.parametrize("m,n", [(8, 1536), (37, 130)])
def test_quantizer_kernel_matches_plain_bitwise(dev, fmt, floor, m, n):
    """Rows over many binades, the first seven replaced by
    `quant_edge_rows` (all zero, between the floors, RNE ties at scales 1,
    2^-20 and 2^12, saturation and +-inf, NaN)."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(m, n, generator=g, device=dev) * torch.exp(
        torch.randn(m, 1, generator=g, device=dev) * 4)
    edge = quant_edge_rows(fmt, n).to(dev)
    x[: len(edge)] = edge
    before = aio_quant.launches
    codes, scale = aio_quant(x, fmt_name=fmt, floor=floor)
    torch.cuda.synchronize()
    assert aio_quant.launches == before + 1
    want_codes, want_scale = aio_quant_plain(x, fmt_name=fmt, floor=floor)
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)


# The quantizer's encoder against the plain version on every bit pattern
# that can decide it: rows of PATTERN_ROW values, each led by a value that
# fixes the row's scale, in chunks of about 2^26 elements (the plain
# version's temporaries stay a few GB).
PATTERN_ROW = 4096
PATTERN_CHUNK_ROWS = 1 << 14


def _pattern_rows(dev, lo: int, hi: int, lead: float) -> torch.Tensor:
    """float32 rows: `lead`, then the bit patterns lo..hi-1 (ints in
    [0, 2^32)) in order, the last row padded with pattern lo."""
    per = PATTERN_ROW - 1
    rows = -(-(hi - lo) // per)
    bits = torch.arange(lo, lo + rows * per, dtype=torch.int64, device=dev)
    bits = torch.where(bits < hi, bits, lo)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    vals = bits.to(torch.int32).view(torch.float32).view(rows, per)
    return torch.cat([vals.new_full((rows, 1), lead), vals], 1)


def _assert_quant_equal(x, fmt, floor):
    """Kernel and plain version bitwise on x; a difference names its first
    input's bits and both codes."""
    codes, scale = aio_quant(x, fmt_name=fmt, floor=floor)
    want, want_scale = aio_quant_plain(x, fmt_name=fmt, floor=floor)
    torch.cuda.synchronize()
    assert torch.equal(scale, want_scale), f"{fmt}: scales differ"
    bad = (codes != want).nonzero()
    if len(bad):
        r, c = bad[0].tolist()
        bits = x[r, c].view(torch.int32).item() & 0xFFFFFFFF
        raise AssertionError(
            f"{fmt}: {len(bad)} codes differ; first x bits {bits:#010x} "
            f"scale {scale[r].item()}: kernel {codes[r, c].item()}, plain "
            f"{want[r, c].item()}")
    return scale


@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quantizer_every_f32_pattern_at_scale_1(dev, fmt):
    """All 2^32 float32 bit patterns (zeros, f32 subnormals, every binade,
    +-inf, NaNs with either sign) coded at scale 1: each row is led by
    +inf, so its scale is 1 and the rest is coded as it is."""
    step = PATTERN_CHUNK_ROWS * (PATTERN_ROW - 1)
    for lo in range(0, 1 << 32, step):
        x = _pattern_rows(dev, lo, min(lo + step, 1 << 32), float("inf"))
        scale = _assert_quant_equal(x, fmt, KERNEL_FLOOR)
        assert (scale == 1).all()


def _edge_binades(fmt_name: str):
    """The quotient ranges [2^lo, 2^hi) around the format's subnormal range
    (int: around 1/2 and 1, where rounding to 0 and 1 decides) and
    [2^top, max_finite] at its saturation edge, as (lo, hi, top)."""
    fmt = F.REGISTRY[fmt_name]
    if fmt.kind == "fp":
        emin = 1 - fmt.bias
        emax = (1 << fmt.ebits) - 1 - fmt.bias
        return emin - fmt.mbits - 2, emin + 1, emax - 1
    return -3, 1, int(np.floor(np.log2(fmt.max_finite))) - 1


def _edge_scales(fmt_name: str):
    """Exponents k of the scales 2^k the edge binades are coded at: the
    least a row reaches above the FLT_MIN floor (a subnormal scale), the
    two sides of where 2^-k leaves the float range, 2^-126, 2^-20, 2^12,
    2^100 and the largest."""
    mf = F.REGISTRY[fmt_name].max_finite
    k_min = int(np.ceil(np.log2(F.FLT_MIN / mf)))
    k_max = int(np.floor(np.log2(np.finfo(np.float32).max / mf)))
    return sorted({k_min, -128, -127, -126, -20, 12, 100, k_max})


def _bits(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.uint32))


@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quantizer_edge_binades_at_other_scales(dev, fmt):
    """Every float32 bit pattern x, of either sign, whose quotient x / 2^k
    lies in the binades around the format's subnormal range or between
    2^(emax - 1) and max_finite, at scales 2^k from subnormal to the
    largest (`_edge_scales`): each row led by max_finite * 2^k, so its
    scale is exactly 2^k (floor FLT_MIN)."""
    lo, hi, top = _edge_binades(fmt)
    mf = F.REGISTRY[fmt].max_finite
    for k in _edge_scales(fmt):
        lead = float(np.float32(mf * 2.0 ** k))
        assert lead == mf * 2.0 ** k and lead >= F.FLT_MIN
        spans = [(_bits(2.0 ** (lo + k)), _bits(2.0 ** (hi + k))),
                 (_bits(2.0 ** (top + k)), _bits(lead) + 1)]
        for sign in (0, 1 << 31):
            for a, b in spans:
                step = PATTERN_CHUNK_ROWS * (PATTERN_ROW - 1)
                for s in range(a, b, step):
                    x = _pattern_rows(dev, sign + s, sign + min(s + step, b),
                                      lead)
                    scale = _assert_quant_equal(x, fmt, F.FLT_MIN)
                    assert (scale == 2.0 ** k).all(), (fmt, k)


def _last_block_rows(dev, m, n, plan, seed):
    """Random rows with a NaN or an inf only in the last block's part of
    the row: at its last value, and at the first value of its part."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, n, generator=g, device=dev) * 3.0
    unit = 4 if n % 4 == 0 else 1
    part = -(-(n // unit) // plan.cluster) * unit
    first = (plan.cluster - 1) * part
    for r, (col, val) in enumerate([(n - 1, float("nan")),
                                    (n - 1, -float("inf")),
                                    (first, float("inf")),
                                    (first, -float("nan"))]):
        x[r % m, col] = val
    return x


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("fmt", ["fp8a", "fp8b", "int8", "int4"])
def test_quantizer_every_cluster_size(dev, monkeypatch, cluster, fmt):
    """Every cluster size the plan can choose, each with every count of
    values a thread holds and the re-read path, at the chip-smoke shapes
    (M 8 and 256, N 1536 and 8960) and a ragged one (M 37, N 130, scalar):
    `quant_edge_rows` on random rows, and rows whose only NaN or inf lies
    in the last block's part, bitwise against the plain version at both
    floors."""
    for m, n in [(8, 1536), (8, 8960), (256, 1536), (256, 8960), (37, 130)]:
        plans = [plan_with(n, cluster, u) for u in (0, 1, 2, 4, MAX_UNITS)]
        for plan in plans:
            if plan.threads > MAX_THREADS:
                continue
            monkeypatch.setattr(quant_ops, "quant_plan",
                                lambda m, n, plan=plan: plan)
            g = torch.Generator(device=dev).manual_seed(m + n)
            x = torch.randn(m, n, generator=g, device=dev) * torch.exp(
                torch.randn(m, 1, generator=g, device=dev) * 4)
            edge = quant_edge_rows(fmt, n).to(dev)
            x[: min(m, len(edge))] = edge[:m]
            for floor in (KERNEL_FLOOR, F.FLT_MIN):
                _assert_quant_equal(x, fmt, floor)
                _assert_quant_equal(_last_block_rows(dev, m, n, plan, n),
                                    fmt, floor)


def test_quantizer_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """A cluster size past the portable ones, or too few threads for a
    part, is refused by the launch: the wrapper raises and falls back to
    nothing."""
    x = torch.randn(8, 1536, device=dev)
    for plan in (QuantPlan(3, 64, 4), QuantPlan(8, 32, 4),
                 QuantPlan(1, 1024, 4), QuantPlan(2, 64, 12)):
        monkeypatch.setattr(quant_ops, "quant_plan",
                            lambda m, n, plan=plan: plan)
        before = aio_quant.launches
        with pytest.raises(RuntimeError, match="aio_quant"):
            aio_quant(x, fmt_name="int4", floor=KERNEL_FLOOR)
        assert aio_quant.launches == before


def test_resident_engine_on_card_matches_plain_gemm_engine(dev):
    """The smoke config with resident int4 weights served through the
    kernels emits the tokens of the same engine computing every resident
    Linear with the plain versions of the quantizer and the GEMM (attention
    on the kernels in both), and both AIO kernels launched."""
    cfg = get_smoke("qwen2_1p5b")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (3, 40, 5, 18)]
    outs = {}
    for plain in (False, True):
        model = init_params(cfg, seed=0)
        eng = ServingEngine(cfg, model, slots=2, max_len=128,
                            prefill_chunk=16, weight_format="int4")
        aio_matmul.launches = aio_quant.launches = 0
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=6))
        if plain:
            with _plain_resident_gemms():
                done = eng.run_until_drained()
            assert aio_matmul.launches == aio_quant.launches == 0
        else:
            done = eng.run_until_drained()
            assert aio_matmul.launches > 0 and aio_quant.launches > 0
        outs[plain] = {r.rid: r.out_tokens for r in done}
    assert outs[False] == outs[True]


@contextlib.contextmanager
def _plain_resident_gemms():
    """Swap the kernel route of `matmul_codes` for the plain versions of
    the quantizer and the GEMM, for this test only."""
    key = ("matmul_codes", "cuda")
    saved = api.registry._impls[key]

    def plain(x, wq, *, policy):
        x2 = x.reshape(-1, wq.k).to(torch.float32)
        xq, xs = aio_quant_plain(x2, fmt_name=wq.fmt, floor=F.FLT_MIN)
        out = aio_matmul_plain(xq, wq.codes, xs, wq.scale, mode=wq.fmt)
        return out.reshape(*x.shape[:-1], -1)

    api.registry._impls[key] = plain
    try:
        yield
    finally:
        api.registry._impls[key] = saved


# ========================================= full-sequence flash attention
FULL_CASES = [
    # the reference's six cases (tests/test_kernels.py)
    dict(b=2, hq=4, hkv=2, lq=128, lk=128, d=64),
    dict(b=1, hq=8, hkv=2, lq=256, lk=300, d=64),
    dict(b=1, hq=4, hkv=4, lq=128, lk=256, d=64, window=100),
    dict(b=1, hq=4, hkv=2, lq=128, lk=256, d=64, softcap=30.0),
    dict(b=1, hq=4, hkv=2, lq=128, lk=384, d=64, offset=256),
    dict(b=1, hq=2, hkv=1, lq=128, lk=128, d=128, window=64, softcap=50.0),
    # non-causal, GQA group 6 at qwen2-1.5B's head width, ragged Lq and D
    dict(b=2, hq=6, hkv=2, lq=128, lk=200, d=32, causal=False),
    dict(b=1, hq=4, hkv=2, lq=128, lk=256, d=64, causal=False, window=90),
    dict(b=2, hq=12, hkv=2, lq=384, lk=384, d=128),
    dict(b=1, hq=2, hkv=1, lq=77, lk=77, d=96),
]


def _full_kw(case):
    return {k: case[k] for k in ("causal", "window", "softcap", "offset")
            if k in case}


@pytest.mark.parametrize("case", FULL_CASES, ids=str)
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_full_attention_kernel_matches_plain(dev, case, kv_dtype):
    """max |diff| <= 1e-4 (atol and rtol): f32 attention summed in another
    order. q f32 (a head-split strided view, as the model hands it over),
    K/V f32 or bf16."""
    q, k, v = _data(dev, 11, case["b"], case["hq"], case["hkv"], case["lq"],
                    case["lk"], case["d"])
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **_full_kw(case))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.float32 and not got.isnan().any()
    _close(got, flash_attention_plain(q, k, v, **_full_kw(case)))


def test_full_attention_kernel_all_bf16(dev):
    """q, K and V bf16, a bf16 output: the kernel's f32 result and the
    plain version's differ by at most 1e-4 before the final rounding, so
    after it by one bf16 ulp of the value (at most 2^-7 of it) plus
    1e-4."""
    q, k, v = _data(dev, 12, 2, 12, 2, 256, 256)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=TOL)


def test_full_attention_rows_without_keys_are_finite(dev):
    """A window that ends before the queries' positions leaves rows with no
    valid key: their output is finite; every other row matches."""
    q, k, v = _data(dev, 13, 1, 4, 2, 128, 100, 64)
    got = flash_attention(q, k, v, window=8, offset=50)
    want = flash_attention_plain(q, k, v, window=8, offset=50)
    assert torch.isfinite(got).all()
    _close(got[:, :, :57], want[:, :, :57])  # 50 + i < 100 + 8 - 1


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(offset=400), dict(window=300),
                                dict(offset=77, window=200, softcap=30.0),
                                dict(offset=1000, window=40),
                                dict(causal=False, softcap=50.0)], ids=str)
def test_full_attention_over_many_tiles(dev, kv_dtype, kw):
    """Queries over many 32-key tiles and several 128-row blocks (GQA group
    6, Lq 700 and Lk 1100, neither a multiple of the tiles), with an
    offset, a window and a softcap, against the plain version; the rows
    that have no valid key (past a window that ends before Lk) are finite
    and every other row matches."""
    q, k, v = _data(dev, 15, 2, 12, 2, 700, 1100)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    qpos = kw.get("offset", 0) + torch.arange(700, device=dev)
    has_key = qpos < 1100 + kw.get("window", 1100) - 1
    _close(got[:, :, has_key], want[:, :, has_key])


def test_full_attention_wrapper_rejects_bad_operands(dev):
    q, k, v = _data(dev, 14, 1, 4, 2, 128, 128, 64)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 2, 128, 130, device=dev)
        flash_attention(z, z, z)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


def test_forward_on_card_runs_the_full_kernel_per_layer(dev):
    """The smoke config's full-sequence forward at L = 256: one
    full-sequence kernel launch per layer and no serving kernel; logits
    within 1e-4 of the ref route's and the loss within 1e-5."""
    cfg = get_smoke("qwen2_1p5b")
    model = init_params(cfg, seed=0)
    toks = torch.randint(1, cfg.vocab, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    for kern in (flash_attention, *KERNELS, *PAGED_KERNELS):
        kern.launches = 0
    logits, _ = forward(model, toks)
    loss, _ = loss_fn(model, batch)
    assert flash_attention.launches == 2 * cfg.n_layers
    assert not any(k.launches for k in (*KERNELS, *PAGED_KERNELS))
    with api.policy(backend="ref"):
        want, _ = forward(model, toks)
        want_loss, _ = loss_fn(model, batch)
    assert flash_attention.launches == 2 * cfg.n_layers
    _close(logits, want)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)


# ====================================================== grouped GEMM (B9)
@pytest.mark.parametrize("sizes,k,n,bm", [
    ((128, 384, 128), 192, 160, 128), ((64, 192), 131, 70, 64),
    ((32, 96), 40, 200, 32), ((16, 48, 16), 1536, 33, 16),
    ((256, 128), 4096, 4096, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernel_matches_plain(dev, sizes, k, n, bm, dtype):
    """max |kernel - plain| <= 1e-5 * max |plain| (f32 sums in another
    order; bf16 operands are widened exactly); ragged K and N."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn(sum(sizes), k, generator=g, device=dev).to(dtype)
    w = (torch.randn(len(sizes), k, n, generator=g, device=dev)
         * k ** -0.5).to(dtype)
    gids = torch.tensor([i for i, s in enumerate(sizes)
                         for _ in range(s // bm)], dtype=torch.int32,
                        device=dev)
    before = grouped_matmul.launches
    got = grouped_matmul(gids, x, w, bm=bm)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    want = grouped_matmul_plain(gids, x, w, bm=bm)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    half = grouped_matmul(gids, x, w, bm=bm, out_dtype=torch.bfloat16)
    torch.testing.assert_close(half.float(), want, rtol=2 ** -8,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("shapes,bm,tm,slices", [
    ([(128, 4096, 4096), (256, 1536, 1536)], 128, 128, 6),
    ([(512, 1024, 1024), (500, 700, 1000)], 128, 128, 2),
    ([(512, 1024, 1024), (448, 1000, 900)], 64, 64, 1),
    ([(256, 1024, 1024), (250, 333, 777)], 32, 32, 1),
    ([(64, 512, 160), (170, 300, 33)], 16, 16, 1),
    ([(128, 512, 160), (100, 300, 33)], 128, 16, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernel_skips_padding(dev, shapes, bm, tm, slices, dtype):
    """Tenants packed as `morphable_multi_gemm` packs them, on shapes that
    pick each block tile (bm 16, 32, 64, 128; a 16-row tile at bm 128) and
    split K into 6 and 2 slices: with and without each
    tenant's (K, N) the kernel is within 1e-5 * max|plain| of the plain
    version on the padded operands, and with them the padded output
    columns are exactly 0."""
    g = torch.Generator(device=dev).manual_seed(bm)
    tenants = [(torch.randn(m, k, generator=g, device=dev).to(dtype),
                (torch.randn(k, n, generator=g, device=dev)
                 * k ** -0.5).to(dtype)) for m, k, n in shapes]
    x, w, sizes, metas = pack_tenants(tenants, bm, bm, bm)
    gids = make_group_ids(sizes, bm, device=dev)
    plan = grouped_plan(x.shape[0], x.shape[1], w.shape[2], bm)
    assert (plan[0], plan[2]) == (tm, slices)
    want = grouped_matmul_plain(gids, x, w, bm=bm)
    ext = dict(group_k=[k for _, k, _ in shapes],
               group_n=[n for _, _, n in shapes])
    before = grouped_matmul.launches
    for kw in ({}, ext):
        got = grouped_matmul(gids, x, w, bm=bm, **kw)
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert grouped_matmul.launches == before + 2
    row = 0
    for size, (m, k, n) in zip(sizes, shapes):
        assert torch.equal(got[row:row + size, n:],
                           torch.zeros_like(got[row:row + size, n:]))
        row += size


def test_morphable_multi_gemm_on_card_is_one_launch(dev):
    """Three unrelated tenants in ONE grouped launch: each result as the
    plain product, the utilization as the CPU packing's."""
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = [(100, 64, 96), (300, 120, 50), (60, 256, 256)]
    tenants = [(torch.randn(m, k, generator=g, device=dev),
                torch.randn(k, n, generator=g, device=dev))
               for m, k, n in shapes]
    before = grouped_matmul.launches
    got, util = api.ops.morphable_multi_gemm(tenants)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    _, want_util = api.ops.morphable_multi_gemm(
        [(x.cpu(), w.cpu()) for x, w in tenants])
    assert util == want_util
    for (x, w), r in zip(tenants, got):
        want = x @ w
        assert (r - want).abs().max() <= 1e-5 * want.abs().max()


def test_grouped_wrapper_rejects_bad_operands(dev):
    x = torch.zeros(128, 32, device=dev)
    w = torch.zeros(2, 32, 16, device=dev)
    gids = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        grouped_matmul(torch.zeros(16, dtype=torch.int32, device=dev), x, w,
                       bm=8)
    with pytest.raises(TypeError, match="int32"):
        grouped_matmul(gids.long(), x, w)
    with pytest.raises(TypeError, match="both float32"):
        grouped_matmul(gids, x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="group ids"):
        grouped_matmul(gids, x[:64], w)
    with pytest.raises(ValueError, match="group_k"):
        grouped_matmul(gids, x, w, group_k=[32, 33])
    with pytest.raises(ValueError, match="group_n"):
        grouped_matmul(gids, x, w, group_n=torch.zeros(2, device=dev))


# ===================================================== depthwise conv (B11)
@pytest.mark.parametrize("n,h,w,c,kk", [
    (2, 9, 7, 3, 3), (1, 13, 11, 130, 5), (2, 15, 9, 576, 7),
    (8, 56, 56, 144, 3), (1, 6, 5, 64, 4), (2, 14, 14, 576, 3),
    (1, 5, 6, 24, 1), (2, 8, 10, 130, 7), (1, 10, 13, 40, 9),
    (1, 1, 1, 9, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_bitwise_equals_plain(dev, n, h, w, c, kk, dtype):
    g = torch.Generator(device=dev).manual_seed(kk * c)
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
    f = torch.randn(kk, kk, c, generator=g, device=dev).to(dtype)
    before = depthwise_conv.launches
    got = depthwise_conv(x, f)
    torch.cuda.synchronize()
    assert depthwise_conv.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, depthwise_plain(x, f))
    assert torch.equal(api.ops.depthwise_conv(x, f), got)
    assert depthwise_conv.launches == before + 2


@pytest.mark.parametrize("kh,kw", [(3, 1), (1, 7), (5, 3), (2, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_rectangular_filters(dev, kh, kw, dtype):
    """Filters of kh != kw (SAME padding per axis, the extra row or column
    after) over C = 130 (not a multiple of either vector width) and 64."""
    g = torch.Generator(device=dev).manual_seed(kh * 10 + kw)
    for c in (130, 64):
        x = torch.randn(2, 11, 9, c, generator=g, device=dev).to(dtype)
        f = torch.randn(kh, kw, c, generator=g, device=dev).to(dtype)
        assert torch.equal(depthwise_conv(x, f), depthwise_plain(x, f))


def test_depthwise_wrapper_rejects_bad_operands(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(ValueError, match="kh, kw, C"):
        depthwise_conv(x, torch.zeros(3, 3, 4, device=dev))
    with pytest.raises(TypeError, match="both float32"):
        depthwise_conv(x, torch.zeros(3, 3, 8, device=dev,
                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv(x.transpose(1, 2), torch.zeros(3, 3, 8, device=dev))


# ========================================== robustness layer on the card
def _poisoned(flat, row, value, kv):
    """A copy of the K/V operands with K (or the int8 K scale) of batch
    row `row` set to `value` at position 0, every head: the engine's KV
    poison."""
    out = [a.clone() for a in flat]
    k = out[1] if kv == "int8" else out[0]
    k[row, :, 0, :] = value
    return out


def _poison_case(dev, kv):
    """Decode and prefill operands over a 512-key cache (4 decode splits,
    2 prefill splits): row 0 holds one key (position 0, so one whole split
    sees only the poisoned key), row 1 many splits."""
    b, hkv, group, lk, w = 4, 2, 6, 512, 32
    q1, k, v = _data(dev, 40, b, hkv * group, hkv, 1, lk)
    qw, _, _ = _data(dev, 41, b, hkv * group, hkv, w, lk)
    if kv == "int8":
        kc, ks = _q8(k)
        vc, vs = _q8(v)
        flat = (kc, ks, vc, vs)
    else:
        flat = (k.to(torch.bfloat16), v.to(torch.bfloat16))
    pos = torch.tensor([0, 300, 200, 450], dtype=torch.int32, device=dev)
    ppos = torch.tensor([0, 300, 100, 5], dtype=torch.int32, device=dev)
    lens = torch.tensor([1, 32, 7, 0], dtype=torch.int32, device=dev)
    return q1, qw, flat, pos, ppos, lens


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")], ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_poisoned_key_makes_its_row_non_finite(dev, value, kv, paged):
    """A non-finite K (or K scale) at position 0 of one row makes every
    valid query of that row non-finite in the decode and prefill kernels
    (B1-B4, paged B6/B7) — also where a whole key split holds only the
    poisoned key, whose running max drops the NaN — as the reference's
    softmax does; every other row stays bitwise equal to the clean call
    and pad queries stay exactly 0. This is what the serving engine's
    health flag reads."""
    q1, qw, flat, pos, ppos, lens = _poison_case(dev, kv)
    if kv == "int8":
        dec, pre = ((flash_decode_paged_quant, flash_prefill_paged_quant)
                    if paged else (flash_decode_quant, flash_prefill_quant))
    else:
        dec, pre = ((flash_decode_paged, flash_prefill_paged)
                    if paged else (flash_decode, flash_prefill))

    def run(ops):
        kw = {}
        if paged:
            ops, table = _paged(dev, ops, 16, seed=5)
            kw = dict(table=table)
        return (dec(q1, *ops, pos=pos, **kw),
                pre(qw, *ops, pos=ppos, lengths=lens, **kw))

    clean = run(flat)
    for row in (0, 1):
        got = run(_poisoned(flat, row, value, kv))
        n = int(lens[row])
        for out, want, nq in ((got[0], clean[0], 1), (got[1], clean[1], n)):
            assert not torch.isfinite(out[row, :, :nq]).any(), (row, nq)
            assert not out[row, :, nq:].any()          # pad queries: 0
            others = [r for r in range(out.shape[0]) if r != row]
            assert torch.equal(out[others], want[others])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_pool_blocks_round_trip_on_card(dev, kv_quant):
    """gather_pool_blocks -> the host block store -> write_pool_blocks
    moves blocks bitwise (bf16 as its 16-bit pattern; int8 codes and
    scales), and sentinel-padded destinations land in the trash block
    only."""
    from repro_torch.models import init_caches
    from repro_torch.models.transformer import (gather_pool_blocks,
                                                write_pool_blocks)
    from repro_torch.serving import HostBlockStore
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    caches = init_caches(cfg, 2, 64, paged=(8, 16))
    g = torch.Generator(device=dev).manual_seed(0)
    for c in caches:
        for f in dataclasses.fields(c):
            if f.name not in ("table", "pos"):
                t = getattr(c, f.name)
                t.copy_(torch.randn(t.shape, generator=g, device=dev)
                        .mul(9).to(t.dtype))
    before = [{f.name: getattr(c, f.name).clone()
               for f in dataclasses.fields(c)} for c in caches]
    store = HostBlockStore()
    hids = store.put(gather_pool_blocks(caches, [5, 2, 7]), 3)
    back = store.get(hids)
    assert store.bytes_in == store.bytes_out > 0
    pad = {n: torch.cat([a, a.new_zeros(a.shape[:1] + (2,) + a.shape[2:])],
                        1) for n, a in back.items()}
    write_pool_blocks(caches, pad, torch.tensor([0, 3, 1, 8, 8]))
    names = ("k_codes", "k_scale", "v_codes", "v_scale") if kv_quant \
        else ("k", "v")
    for c, old in zip(caches, before):
        for name in names:
            new = getattr(c, name)
            for dst, src in ((0, 5), (3, 2), (1, 7)):
                assert torch.equal(new[dst], old[name][src])
            for b in (2, 4, 5, 6, 7):
                assert torch.equal(new[b], old[name][b])
            assert torch.equal(new[8], torch.zeros_like(new[8]))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_scrubbed_slot_serves_as_a_fresh_cache(dev, kv_quant, paged):
    """Stale non-finite values in a slot's cache (past its frontier, where
    the kernels mask the keys but still read their tile's V) are gone after
    scrub_slots: the reused slot emits a fresh engine's tokens through the
    kernels, with no quarantine."""
    from repro_torch.models.transformer import scrub_slots
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=kv_quant)
    model = init_params(cfg, seed=3)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (5, 21)]
    outs = []
    for dirty in (False, True):
        eng = ServingEngine(cfg, model, slots=2, max_len=64,
                            prefill_chunk=8, paged=paged, block_size=16)
        if dirty:
            for c in eng.caches:
                for f in dataclasses.fields(c):
                    if f.name not in ("table", "pos", "k_codes", "v_codes"):
                        getattr(c, f.name).fill_(float("nan"))
            scrub_slots(eng.caches, torch.ones(2, dtype=torch.bool,
                                               device=dev))
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=6))
        outs.append({r.rid: r.out_tokens for r in eng.run_until_drained()})
        assert eng.stats.quarantines == 0
    assert outs[0] == outs[1]


def test_engine_faults_and_preemption_on_card(dev):
    """On the card, through the kernels: logits and KV poison quarantine
    and replay to the unfaulted tokens; a launch fault demotes once to the
    reference route's tokens; a contended paged pool with alternating
    priorities preempts, swaps and resumes to the uncontended tokens."""
    from repro_torch.serving import FaultPlan
    cfg = get_smoke("qwen2_1p5b")
    model = init_params(cfg, seed=4)
    rng = np.random.RandomState(4)
    spec = [rng.randint(1, cfg.vocab, rng.randint(18, 30)).astype(np.int32)
            for _ in range(6)]

    def serve(plan=None, **kw):
        eng = ServingEngine(cfg, model, slots=2, max_len=64, prefill_chunk=8,
                            **kw)
        eng.arm_fault_plan(plan)
        for rid, p in enumerate(spec):
            eng.submit(Request(rid, p, max_new_tokens=12, priority=rid % 2))
        return {r.rid: r.out_tokens for r in eng.run_until_drained()}, eng

    want, _ = serve()
    plan = FaultPlan([FaultPlan.single("poison", step=3, slot=0).faults[0],
                      FaultPlan.single("poison", step=5, slot=1, target="kv",
                                       value=float("inf")).faults[0]])
    got, eng = serve(plan)
    assert got == want and eng.stats.quarantines == 2
    assert eng.stats.demotions == 0
    ref, _ = serve(policy=api.ExecutionPolicy(backend="ref"))
    with pytest.warns(RuntimeWarning, match="demoted"):
        got, eng = serve(FaultPlan.single("launch", step=0))
    assert got == ref and eng.stats.demotions == 1
    got, eng = serve(paged=True, block_size=16, pool_blocks=4)
    st = eng.pool_stats()
    assert got == want and st["preemptions"] >= 1 and st["swap_ins"] >= 1
    assert st["swap_bytes_in"] == st["swap_bytes_out"] > 0


# ================================== zamba2's attention shapes (D = 80)
# 32 heads of 80 (MHA: Hq = Hkv), a 1024-position cache: the only config
# the port serves whose head_dim is neither 64 nor 128. A bf16 row of 80
# is 160 bytes (a multiple of the kernels' 16-byte copies), 20 lanes of 4
# head dims are live, and the MMA k-steps run 80 / 16 = 5.
ZAMBA_D, ZAMBA_H, ZAMBA_LK = 80, 32, 1024


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
def test_decode_kernels_at_zamba2_head_dim(dev, kv):
    """B1 (bf16 / f32 cache) and B2 (int8) at 8 rows of one query: within
    1e-4 of the plain version; the int8 kernel equals the kernel on the
    dequantized K/V bitwise."""
    q, k, v = _data(dev, 80, 8, ZAMBA_H, ZAMBA_H, 1, ZAMBA_LK, ZAMBA_D)
    pos = torch.tensor([0, 1, 127, 128, 500, 777, 1022, 1023],
                       dtype=torch.int32, device=dev)
    flat, kern, _ = _decode_forms(k, v, kv)
    n = kern.launches
    got = kern(q, *flat, pos=pos)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    if kv == "int8":
        deq = (dequant(flat[0], flat[1], torch.float32),
               dequant(flat[2], flat[3], torch.float32))
        assert torch.equal(got, flash_decode(q, *deq, pos=pos))
        _close(got, flash_decode_quant_plain(q, *flat, pos=pos))
    else:
        _close(got, flash_decode_plain(q, *flat, pos=pos))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_kernel_at_zamba2_head_dim(dev, kv_dtype, causal):
    """B8 over a 1024-token sequence of zamba2's heads: within 1e-4 of the
    plain version, no NaN."""
    q, k, v = _data(dev, 81, 1, ZAMBA_H, ZAMBA_H, ZAMBA_LK, ZAMBA_LK,
                    ZAMBA_D)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert not got.isnan().any()
    _close(got, flash_attention_plain(q, k, v, causal=causal))


class _MarginEngine(ServingEngine):
    """Records each emitted token's top-1 / top-2 logit margin."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.margins, self._now = {}, None

    def _greedy(self, rows, health):
        top = rows.topk(2, dim=-1).values
        self._now = (top[:, 0] - top[:, 1]).cpu().numpy()
        return super()._greedy(rows, health)

    def _emit(self, s, tok, newly):
        rid = self._slot_req[s].rid
        self.margins.setdefault(rid, []).append(float(self._now[s]))
        super()._emit(s, tok, newly)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_zamba2_merged_engine_on_card_matches_ref_in_lockstep(dev,
                                                              kv_quant):
    """zamba2 at full width over 12 layers (10 Mamba2, the shared block
    twice): the merged engine's kernel route, with a ref-route engine put
    in its state before every step, emits the ref engine's token at every
    step but near-ties (margin <= 1e-3). flash_decode launches once per
    shared-block invocation of each model call, no chunk launch is made,
    and the ref route launches no kernel."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2_2p7b"), n_layers=12,
                              kv_quant=kv_quant)
    model = init_params(cfg, seed=0)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, cfg.vocab, n).astype(np.int32)
               for n in (3, 40, 17, 9)]
    geo = dict(slots=2, max_len=128)
    eng = ServingEngine(cfg, model, **geo)
    ref = _MarginEngine(cfg, model, **geo,
                        policy=api.ExecutionPolicy(backend="ref"))
    for e in (eng, ref):
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=8))
    kern = flash_decode_quant if kv_quant else flash_decode
    for k in KERNELS:
        k.launches = 0
    compared = 0
    while eng.pending():
        for dc, sc in zip(ref.caches, eng.caches):
            for f in dataclasses.fields(sc):
                setattr(dc, f.name, getattr(sc, f.name).clone())
        ref._last[:] = eng._last
        before = {r.rid: len(r.out_tokens) for r in eng._slot_req if r}
        launched = kern.launches
        eng.step()
        assert kern.launches - launched == \
            cfg.block_kinds().count("shared_attn")
        launched = sum(k.launches for k in KERNELS)
        ref.step()
        assert sum(k.launches for k in KERNELS) == launched == kern.launches
        for rid, n in before.items():
            got = next(r for r in [*eng.finished, *filter(None,
                                                          eng._slot_req)]
                       if r.rid == rid).out_tokens[n:]
            want = next(r for r in [*ref.finished, *filter(None,
                                                           ref._slot_req)]
                        if r.rid == rid).out_tokens[n:]
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                if ref.margins[rid][n + i] > 1e-3:
                    assert a == b, (rid, n + i)
                    compared += 1
    assert not ref.pending() and compared > 20
    st = eng.stats
    assert st.prefill_chunk_calls == 0
    assert kern.launches == 2 * st.model_calls
    assert st.quarantines == ref.stats.quarantines == 0


# ================================= the frontend families' shapes (A7 step 5)
# whisper-tiny's cross attention: 6 heads of 64 (MHA) over 1500 frames;
# its resident cross k/v projections at 8 slots x 1500 frames; internvl2's
# down projection
WHISPER_H, WHISPER_D, WHISPER_FRAMES = 6, 64, 1500


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq", [(1, 256), (8, 128), (1, 77)])
def test_full_attention_kernel_at_whisper_cross_shape(dev, kv_dtype, b, lq):
    """B8 non-causal over whisper's 1500 frames (not a multiple of the key
    tile: the tail is masked): a 256-token forward, a 128-token chunk of 8
    slots and a ragged Lq, within 1e-4 of the plain version, no NaN."""
    q, k, v = _data(dev, 83, b, WHISPER_H, WHISPER_H, lq, WHISPER_FRAMES,
                    WHISPER_D)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert not got.isnan().any()
    _close(got, flash_attention_plain(q, k, v, causal=False))


@pytest.mark.parametrize("mode", ["int4", "fp8a"])
@pytest.mark.parametrize("m,k,n", [(12000, 384, 384), (8, 28672, 8192)])
def test_gemm_and_quantizer_at_frontend_shapes(dev, mode, m, k, n):
    """B10 then B5 as a resident Linear runs them: whisper's cross k/v
    projection of 8 slots x 1500 frames (M 12,000, K = N = 384) and
    internvl2's down projection (K 28,672, N 8192) at a decode step's 8
    rows. The quantizer bitwise on the activations; the GEMM bitwise
    (int4) or within rtol 2e-5, atol 2e-5 * max|plain| (fp8a)."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=dev)
    codes, scale = aio_quant(x, fmt_name=mode, floor=F.FLT_MIN)
    want_codes, want_scale = aio_quant_plain(x, fmt_name=mode,
                                             floor=F.FLT_MIN)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    _, w, _, ws = _gemm_operands(dev, mode, 8, k, n, seed=k + n)
    got = aio_matmul(codes, w, scale, ws, mode=mode)
    want = aio_matmul_plain(codes, w, scale, ws, mode=mode)
    if mode == "int4":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5,
                                   atol=2e-5 * want.abs().max().item())


# ====================================== multi-tenant serving and the model (A8)
@pytest.mark.parametrize("mode", ["fp8a", "fp8b", "int8", "int4", "bf16"])
def test_gemm_kernel_equals_the_multiplier_model(dev, mode):
    """One launch of the AIO GEMM as an outer product of single products
    (`kernels/aio_matmul/oracle.py`), bit for bit against the paper's
    multiplier model `core.aio_mac`: every fp8 / int8 / int4 code pair,
    65,536 random bf16 pairs (after RNE to bf16)."""
    from repro_torch.kernels.aio_matmul.oracle import oracle_check
    before = aio_matmul.launches
    got = oracle_check(mode, dev)
    assert aio_matmul.launches == before + 1
    assert got["mismatches"] == 0, got


@pytest.mark.parametrize("weight_format", [None, "int8"])
def test_two_tenants_stepped_in_turn_equal_each_alone(dev, weight_format):
    """The launcher's two SMOKE tenants (olmoe, qwen2) on one card: their
    engines stepped in turn until both drain emit exactly the tokens each
    engine emits run alone."""
    from repro_torch.launch.serve import TENANTS
    runs = []
    for _ in range(2):
        engines = []
        for seed, (_, arch, *_) in enumerate(TENANTS):
            cfg = get_smoke(arch)
            eng = ServingEngine(cfg, init_params(cfg, seed=seed), slots=2,
                                max_len=64, prefill_chunk=8,
                                weight_format=weight_format)
            rng = np.random.RandomState(seed)
            for rid in range(5):
                p = rng.randint(1, cfg.vocab, rng.randint(3, 30))
                assert eng.submit(Request(rid, p.astype(np.int32),
                                          max_new_tokens=6))
            engines.append(eng)
        runs.append(engines)
    alone = []
    for eng in runs[0]:
        alone.append({r.rid: r.out_tokens for r in eng.run_until_drained()})
    while any(e.pending() for e in runs[1]):
        for eng in runs[1]:
            if eng.pending():
                eng.step()
    together = [{r.rid: r.out_tokens for r in e.finished} for e in runs[1]]
    assert together == alone


# ================================================ the training stack (A9)
def _launch_cases(dev):
    """{wrapper name: (wrapper, operands, index of a float operand)}: each
    ctypes entry point with valid operands, one float input to mark as
    requiring grad."""
    b, hkv, group, lk, w = 2, 2, 2, 256, 32
    q1, k, v = _data(dev, 21, b, hkv * group, hkv, 1, lk, d=64)
    qw, _, _ = _data(dev, 22, b, hkv * group, hkv, w, lk, d=64)
    q1, qw = q1.contiguous(), qw.contiguous()
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    kc, ks = _q8(k)
    vc, vs = _q8(v)
    pos = torch.tensor([0, lk - 1], dtype=torch.int32, device=dev)
    ppos = torch.tensor([0, lk - w], dtype=torch.int32, device=dev)
    lens = torch.tensor([w, 3], dtype=torch.int32, device=dev)
    pools, table = _paged(dev, (kb, vb), 16, seed=1)
    qpools, qtable = _paged(dev, (kc, ks, vc, vs), 16, seed=2)
    x, wq, _, _ = _gemm_operands(dev, "bf16", 8, 64, 32, seed=3)
    xi, wi, xs, ws = _gemm_operands(dev, "int8", 8, 64, 32, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    gx = torch.randn(32, 48, generator=g, device=dev)
    gw = torch.randn(2, 48, 40, generator=g, device=dev)
    gids = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    dx = torch.randn(1, 6, 7, 24, generator=g, device=dev)
    df = torch.randn(3, 3, 24, generator=g, device=dev)
    fq, fk, fv = _data(dev, 23, 1, 4, 2, 128, 128, d=64)
    return {
        "flash_decode": (flash_decode, [q1, k, v], dict(pos=pos), 0),
        "flash_decode_quant": (flash_decode_quant, [q1, kc, ks, vc, vs],
                               dict(pos=pos), 0),
        "flash_prefill": (flash_prefill, [qw, kb, vb],
                          dict(pos=ppos, lengths=lens), 0),
        "flash_prefill_quant": (flash_prefill_quant, [qw, kc, ks, vc, vs],
                                dict(pos=ppos, lengths=lens), 0),
        "flash_decode_paged": (flash_decode_paged, [q1, *pools],
                               dict(table=table, pos=pos), 0),
        "flash_decode_paged_quant": (flash_decode_paged_quant,
                                     [q1, *qpools],
                                     dict(table=qtable, pos=pos), 0),
        "flash_prefill_paged": (flash_prefill_paged, [qw, *pools],
                                dict(table=table, pos=ppos, lengths=lens),
                                0),
        "flash_prefill_paged_quant": (flash_prefill_paged_quant,
                                      [qw, *qpools],
                                      dict(table=qtable, pos=ppos,
                                           lengths=lens), 0),
        "flash_attention": (flash_attention, [fq, fk.contiguous(), fv], {},
                            1),
        "aio_matmul": (aio_matmul, [x, wq], dict(mode="bf16"), 0),
        "aio_matmul_int8_scale": (aio_matmul, [xi, wi, xs, ws],
                                  dict(mode="int8"), 2),
        "aio_quant": (aio_quant, [gx], dict(fmt_name="int8",
                                            floor=KERNEL_FLOOR), 0),
        "grouped_matmul": (grouped_matmul, [gids, gx, gw], dict(bm=16), 1),
        "depthwise_conv": (depthwise_conv, [dx, df], {}, 1),
    }


@pytest.mark.parametrize("case", [
    "flash_decode", "flash_decode_quant", "flash_prefill",
    "flash_prefill_quant", "flash_decode_paged", "flash_decode_paged_quant",
    "flash_prefill_paged", "flash_prefill_paged_quant", "flash_attention",
    "aio_matmul", "aio_matmul_int8_scale", "aio_quant", "grouped_matmul",
    "depthwise_conv"])
def test_kernel_refuses_inputs_that_require_grad(dev, case):
    """Under grad mode a ctypes launch refuses an input that requires grad
    (it would record no backward and drop that input's gradient), naming
    the entry point, and launches nothing; under no_grad, or with the
    input detached, it launches."""
    kernel, args, kw, i = _launch_cases(dev)[case]
    args = list(args)
    args[i] = args[i].detach().clone().requires_grad_()
    before = kernel.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        kernel(*args, **kw)
    assert kernel.launches == before
    with torch.no_grad():
        want = kernel(*args, **kw)
    plain = list(args)
    plain[i] = plain[i].detach()
    got = kernel(*plain, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


def _tree_leaves(tree):
    """The numpy leaves of a nested dict / list tree (the reference's
    param layout of `bridge.params_to_jax`), in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _train_pair(dev, arch="olmo_1b"):
    """The same weights on the CPU and on the card."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    cfg = get_smoke(arch)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = params_from_jax(params_to_jax(cpu), cfg, device=dev)
    return cfg, cpu, card


def test_train_step_on_card_matches_cpu_and_launches_no_full_kernel(dev):
    """Two train steps of olmo SMOKE at L = 128 (every attention call
    kernel-eligible): no full-sequence kernel launch inside the steps
    (autograd routes to ref), losses within 1e-5, each leaf's gradient
    within 1e-4 x its max |g| of the CPU's, params within 1e-5; then the
    no-grad loss of the trained model launches B8 once a layer."""
    from repro_torch.bridge import grads_to_jax, params_to_jax
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    cfg, cpu, card = _train_pair(dev)
    step = make_train_step(cfg, base_lr=1e-3, warmup=1, total=10)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=2, seq=128, seed=5))
    opts = [adamw_init(list(m.trainable_().parameters()))
            for m in (cpu, card)]
    flash_attention.launches = 0
    for _ in range(2):
        batch = next(data)
        got = [step(m, o, {k: torch.from_numpy(a).to(d)
                           for k, a in batch.items()})
               for m, o, d in ((cpu, opts[0], "cpu"), (card, opts[1], dev))]
        torch.cuda.synchronize()
        assert flash_attention.launches == 0
        torch.testing.assert_close(got[1]["loss"].cpu(), got[0]["loss"],
                                   rtol=1e-5, atol=0)
        for gc, gd in zip(*(_tree_leaves(grads_to_jax(m))
                            for m in (cpu, card))):
            assert np.abs(gd - gc).max() <= 1e-4 * np.abs(gc).max()
    for pc, pd in zip(*(_tree_leaves(params_to_jax(m))
                        for m in (cpu, card))):
        np.testing.assert_allclose(pd, pc, rtol=0, atol=1e-5)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in next(data).items()}
    with torch.no_grad():
        loss, _ = loss_fn(card, batch)
        with api.policy(backend="ref"):
            want, _ = loss_fn(card, batch)
    assert flash_attention.launches == cfg.n_layers
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)


def test_full_attention_at_32k_matches_chunked_ref(dev):
    """B8 at prefill_32k's sequence (B 1, Hq 12, Hkv 2, D 128, causal,
    f32; 16x the longest length the other tests reach) against the ref
    route's long-sequence path, `chunked_attention`, within 1e-4."""
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    q, k, v = _data(dev, 16, 1, 12, 2, 32768, 32768)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = chunked_attention(q, k, v, causal=True)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_remat_step_on_card_equals_plain_step(dev):
    """A train step of the olmo and olmoe SMOKE configs with remat: the
    loss, every gradient and the updated parameters equal those of the
    same step without remat (1e-6 x the leaf's max |g|; the recompute
    runs the same kernels on the same inputs)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    for arch in ("olmo_1b", "olmoe_1b_7b"):
        runs = []
        for remat in (True, False):
            cfg = dataclasses.replace(get_smoke(arch), remat=remat)
            model = init_params(cfg, seed=0).trainable_()
            opt = adamw_init(list(model.parameters()))
            batch = next(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=2,
                                                seq=128, seed=5)))
            m = make_train_step(cfg, base_lr=1e-3, warmup=1, total=10)(
                model, opt, {k: torch.from_numpy(a).to(dev)
                             for k, a in batch.items()})
            runs.append((float(m["loss"]),
                         [p.grad.clone() for p in model.parameters()],
                         [p.detach().clone() for p in model.parameters()]))
        (loss_r, grads_r, params_r), (loss_p, grads_p, params_p) = runs
        assert abs(loss_r - loss_p) <= 1e-6 * abs(loss_p)
        for a, b in zip(grads_r, grads_p):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
        for a, b in zip(params_r, params_p):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -------------------------------------------- static analysis on the card
# One contract case of each of the 13 entry points (repro_torch.analysis):
# (label, registry key, case index). The card checks launch the case's
# body with every operand inside NaN-filled redzones and under the
# profiler: no guard may change, the output must equal the plain version,
# and each kernel record's grid, block and shared memory must equal the
# contract's.
ENTRY_CASES = [
    ("B1 flash_decode", ("attention", "cuda-decode"), 0),
    ("B2 flash_decode_quant", ("attention", "cuda-decode"), 2),
    ("B3 flash_prefill", ("attention", "cuda-prefill"), 0),
    ("B4 flash_prefill_quant", ("attention", "cuda-prefill"), 2),
    ("B5 aio_matmul", ("matmul", "cuda"), 6),
    ("B6 flash_decode_paged", ("attention", "cuda-decode"), 3),
    ("B6 flash_decode_paged_quant", ("attention", "cuda-decode"), 4),
    ("B7 flash_prefill_paged", ("attention", "cuda-prefill"), 3),
    ("B7 flash_prefill_paged_quant", ("attention", "cuda-prefill"), 4),
    ("B8 flash_attention", ("attention", "cuda"), 0),
    ("B9 grouped_matmul", ("grouped_matmul", "cuda"), 2),
    ("B10 aio_quant", ("quantize", "cuda"), 4),
    ("B11 depthwise_conv", ("depthwise_conv", "cuda"), 0),
]


@pytest.mark.parametrize("label,key,ci", ENTRY_CASES,
                         ids=[c[0].split()[0] + "-" + c[0].split()[1]
                              for c in ENTRY_CASES])
def test_entry_point_is_clean_in_redzones_and_matches_its_contract(
        dev, label, key, ci):
    from repro_torch.analysis import card
    fn = api.registry.contract(*key)
    lc = fn(fn.cases[ci], api.ExecutionPolicy())
    assert card.run_body(lc) == []


def test_decode_workspace_one_block_short_is_caught_in_the_redzones(
        dev, monkeypatch):
    """Negative control: the real decode launch given a split workspace one
    block short writes its last partials past the buffer. The output can
    still come out right (the merge reads back what was written there), so
    only the redzone after the workspace shows it."""
    from repro_torch.analysis import card
    from repro_torch.kernels.flash_attention import decode as dec
    fn = api.registry.contract("attention", "cuda-decode")
    lc = fn(fn.cases[0], api.ExecutionPolicy())
    real = dec.decode_plan

    def short(b, hkv, group, lq, lk, d):
        plan = real(b, hkv, group, lq, lk, d)
        return dataclasses.replace(
            plan, workspace=plan.workspace - dec.ROWS_PER_BLOCK * (d + 2))
    monkeypatch.setattr(dec, "decode_plan", short)
    found = card.run_body(lc)
    assert any(code == "KB400" and "redzone after" in msg
               for code, msg in found), found


def _tp_rank(rank, world, init):
    """A rank of the card's 2-rank TP world: qwen2 SMOKE's automatic TP
    forward on cuda:0 (gloo, host buffers) against rank 0's one-rank
    forward; returns (max |diff|, max |logit|, B8 launches)."""
    import torch.distributed as dist
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.launch.mesh import init_world, make_mesh
    torch.cuda.set_device(0)
    init_world(init_method=init, rank=rank, world_size=world, device="cuda",
               backend="gloo")
    mesh = make_mesh((1, world))
    dev = torch.device("cuda", 0)
    model = init_params(get_smoke("qwen2_1p5b"), seed=0, device=dev)
    toks = torch.randint(0, model.cfg.vocab, (2, 128), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        ref, _ = forward(model, toks)
        shard_params(model, mesh)
        flash_attention.launches = 0
        with set_mesh(mesh):
            got, _ = forward(model, toks)
    out = (float((got - ref).abs().max()), float(ref.abs().max()),
           flash_attention.launches)
    dist.destroy_process_group()
    return out


def test_automatic_tp_on_the_card_matches_one_rank(dev):
    """2 gloo ranks sharing the card run qwen2 SMOKE's automatic TP path
    (column/row-parallel Linears, vocab-parallel embedding, B8 on each
    rank's heads) against one rank's forward."""
    import os
    from repro_torch.launch.world import spawn_world
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    for diff, scale, launches in spawn_world(
            2, "test_torch_cuda:_tp_rank", sys_path=[here, src],
            timeout=240):
        assert diff <= TOL * scale, (diff, scale)
        assert launches == get_smoke("qwen2_1p5b").n_layers
