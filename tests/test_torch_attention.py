"""Port parity: the plain versions of the port's attention kernels (what the
CUDA kernels are held against) vs the JAX package's Pallas kernels in
interpret mode — flash-decode and varlen flash-prefill, dense and int8-KV —
over GQA, window, softcap, unaligned cache lengths, pos 0 and pos at the
end, zero-length rows and exact-zero pad rows. Plus the port's `mha_ref`
and `api.ops.attention` against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.flash_attention import (flash_decode_pallas,
                                           flash_decode_quant_pallas,
                                           flash_prefill_pallas,
                                           flash_prefill_quant_pallas,
                                           mha_ref as jmha_ref)
from repro.models.attention import _q8 as jq8
from repro_torch import api
from repro_torch.kernels.flash_attention import (flash_decode,
                                                 flash_decode_plain,
                                                 flash_decode_quant,
                                                 flash_decode_quant_plain,
                                                 flash_prefill,
                                                 flash_prefill_plain,
                                                 flash_prefill_quant,
                                                 flash_prefill_quant_plain,
                                                 mha_ref)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 2e-5            # f32 attention, another summation order
MAX_LEN = 256


def _data(seed, b, hq, hkv, lq, lk, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, lq, d).astype(np.float32) * 0.5,
            rng.randn(b, hkv, lk, d).astype(np.float32) * 0.5,
            rng.randn(b, hkv, lk, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ================================================================ decode
DECODE_CASES = [
    # (group, lq, lk, pos, window, softcap)
    (1, 1, MAX_LEN, [0, 5, 128, MAX_LEN - 1], None, None),
    (2, 1, MAX_LEN, [0, 5, 128, MAX_LEN - 1], None, None),
    (4, 1, MAX_LEN, [0, 5, 128, MAX_LEN - 1], 40, None),
    (4, 1, MAX_LEN, [0, 5, 128, MAX_LEN - 1], None, 30.0),
    (4, 1, MAX_LEN, [0, 5, 128, MAX_LEN - 1], 40, 30.0),
    (3, 3, MAX_LEN, [0, 77, 100, MAX_LEN - 3], None, None),
    (2, 8, MAX_LEN, [0, 1, 130, MAX_LEN - 8], 16, None),
    (2, 1, 200, [199, 64, 0, 150], None, None),       # unaligned Lk
]


@pytest.mark.parametrize("group,lq,lk,pos,window,softcap", DECODE_CASES)
def test_decode_plain_matches_pallas(group, lq, lk, pos, window, softcap):
    q, k, v = _data(1, 4, 2 * group, 2, lq, lk)
    want = flash_decode_pallas(*_j(q, k, v), pos=jnp.asarray(pos, jnp.int32),
                               window=window, softcap=softcap, interpret=True)
    got = flash_decode_plain(*_t(q, k, v), pos=torch.tensor(pos),
                             window=window, softcap=softcap)
    _close(got, want)
    # the wrapper takes the plain version for CPU tensors
    via_wrapper = flash_decode(*_t(q, k, v), pos=torch.tensor(pos),
                               window=window, softcap=softcap)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)])
def test_decode_quant_plain_matches_pallas(window, softcap):
    q, k, v = _data(2, 4, 8, 2, 1, MAX_LEN)
    kc, ks = jq8(jnp.asarray(k))
    vc, vs = jq8(jnp.asarray(v))
    pos = [0, 5, 128, MAX_LEN - 1]
    want = flash_decode_quant_pallas(jnp.asarray(q), kc, ks, vc, vs,
                                     pos=jnp.asarray(pos, jnp.int32),
                                     window=window, softcap=softcap,
                                     interpret=True)
    args = _t(q, kc, ks, vc, vs)
    got = flash_decode_quant_plain(*args, pos=torch.tensor(pos),
                                   window=window, softcap=softcap)
    _close(got, want)
    assert torch.equal(flash_decode_quant(*args, pos=torch.tensor(pos),
                                          window=window, softcap=softcap),
                       got)


def test_decode_scalar_pos_broadcasts():
    q, k, v = _data(3, 2, 4, 2, 1, MAX_LEN)
    want = flash_decode_pallas(*_j(q, k, v), pos=100, interpret=True)
    _close(flash_decode_plain(*_t(q, k, v), pos=100), want)


# ================================================================ prefill
LQ = 20
PREFILL_CASES = [
    # (group, lq, lk, pos, lengths, window, softcap)
    (1, LQ, MAX_LEN, [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ], None, None),
    (2, LQ, MAX_LEN, [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ], None, None),
    (4, LQ, MAX_LEN, [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ], 40, None),
    (4, LQ, MAX_LEN, [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ], None, 30.0),
    (4, LQ, MAX_LEN, [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ], 40, 30.0),
    (2, 13, 200, [187, 64, 0, 3], [13, 7, 1, 0], None, None),  # unaligned
]


def _assert_valid_close(got, want, lens):
    got, want = np.asarray(got), np.asarray(want)
    for b, ln in enumerate(lens):
        np.testing.assert_allclose(got[b, :, :ln], want[b, :, :ln],
                                   rtol=TOL, atol=TOL)
        # pad rows are EXACT zeros in both packages
        assert not got[b, :, ln:].any(), f"row {b}: pad tail not zero"
        assert not want[b, :, ln:].any()


@pytest.mark.parametrize("group,lq,lk,pos,lengths,window,softcap",
                         PREFILL_CASES)
def test_prefill_plain_matches_pallas(group, lq, lk, pos, lengths, window,
                                      softcap):
    q, k, v = _data(4, 4, 2 * group, 2, lq, lk)
    want = flash_prefill_pallas(*_j(q, k, v), pos=jnp.asarray(pos, jnp.int32),
                                lengths=jnp.asarray(lengths, jnp.int32),
                                bq=8, bkv=64, window=window, softcap=softcap,
                                interpret=True)
    got = flash_prefill_plain(*_t(q, k, v), pos=torch.tensor(pos),
                              lengths=torch.tensor(lengths), window=window,
                              softcap=softcap)
    _assert_valid_close(got, want, lengths)
    via_wrapper = flash_prefill(*_t(q, k, v), pos=torch.tensor(pos),
                                lengths=torch.tensor(lengths), window=window,
                                softcap=softcap)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)])
def test_prefill_quant_plain_matches_pallas(window, softcap):
    q, k, v = _data(5, 4, 8, 2, LQ, MAX_LEN)
    kc, ks = jq8(jnp.asarray(k))
    vc, vs = jq8(jnp.asarray(v))
    pos, lengths = [0, 37, 128, MAX_LEN - LQ], [LQ, 5, 0, LQ]
    want = flash_prefill_quant_pallas(
        jnp.asarray(q), kc, ks, vc, vs, pos=jnp.asarray(pos, jnp.int32),
        lengths=jnp.asarray(lengths, jnp.int32), bq=8, bkv=64, window=window,
        softcap=softcap, interpret=True)
    args = _t(q, kc, ks, vc, vs)
    got = flash_prefill_quant_plain(*args, pos=torch.tensor(pos),
                                    lengths=torch.tensor(lengths),
                                    window=window, softcap=softcap)
    _assert_valid_close(got, want, lengths)
    assert torch.equal(flash_prefill_quant(*args, pos=torch.tensor(pos),
                                           lengths=torch.tensor(lengths),
                                           window=window, softcap=softcap),
                       got)


def test_prefill_all_rows_empty_is_zero():
    q, k, v = _data(6, 2, 4, 2, 8, 64)
    out = flash_prefill_plain(*_t(q, k, v), pos=torch.tensor([3, 9]),
                              lengths=torch.tensor([0, 0]))
    assert not out.any()


# ====================================================== reference + op
@pytest.mark.parametrize("offset,window,softcap", [
    (0, None, None), (7, 5, None), ([0, 3], None, 20.0)])
def test_mha_ref_matches_jax(offset, window, softcap):
    q, k, v = _data(7, 2, 6, 3, 4, 12)
    want = jmha_ref(*_j(q, k, v), causal=True, window=window,
                    softcap=softcap, offset=jnp.asarray(offset))
    got = mha_ref(*_t(q, k, v), causal=True, window=window, softcap=softcap,
                  offset=torch.tensor(offset))
    _close(got, want)


@pytest.mark.parametrize("lq,backend", [(1, "auto"), (1, "ref"),
                                        (LQ, "auto"), (LQ, "ref")])
def test_api_attention_matches_jax(lq, backend):
    """The op surface end to end: same routing, same values (the JAX side
    runs its Pallas kernels in interpret mode under the kernel backend)."""
    q, k, v = _data(8, 4, 8, 2, lq, MAX_LEN)
    pos = [0, 5, 128, MAX_LEN - lq]
    jbackend = "pallas" if backend == "auto" else "ref"
    want = japi.ops.attention(*_j(q, k, v), offset=jnp.asarray(pos, jnp.int32),
                              backend=jbackend, interpret=True)
    offset = torch.tensor(pos, dtype=torch.int32)
    got = api.ops.attention(*_t(q, k, v), offset=offset, backend=backend)
    _close(got, want)


def test_cuda_backend_refuses_cpu_tensors():
    q, k, v = _t(*_data(10, 1, 2, 1, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        api.ops.attention(q, k, v, offset=torch.tensor([3]), backend="cuda")
