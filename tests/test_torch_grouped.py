"""Port parity of the morphable ops: the grouped GEMM (`grouped_matmul`'s
plain version and the op's two routes), `make_group_ids`, tenant packing
and `morphable_multi_gemm` (results, and the MAC utilization exactly), and
the depthwise conv (plain version and both routes), against the JAX
package's Pallas kernels in interpret mode and its references."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.grouped_matmul import make_group_ids as jmake_group_ids
from repro_torch import api
from repro_torch.kernels.depthwise import (depthwise_conv, depthwise_plain,
                                           depthwise_ref)
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain,
                                                grouped_matmul_ref,
                                                grouped_plan,
                                                make_group_ids,
                                                pack_tenants)
from repro_torch.kernels.grouped_matmul import ops as grouped_ops
from repro_torch.kernels.grouped_matmul.kernel import ROW_TILES

import _xdist_threads  # noqa: F401  (one torch thread a worker)

GEMM_TOL = 1e-5       # f32 sums in another order
DW_TOL = 1e-6         # the same taps; the lax conv sums in its own order

# the grouped GEMM's launch-contract cases in the reference, plus ragged
# K/N and a bf16 one
GROUPED = [((128, 384, 128), 192, 160, np.float32),
           ((256, 128), 96, 96, np.float32),
           ((128, 128, 256), 131, 70, np.float32),
           ((128, 256), 64, 96, "bfloat16")]

# tenants of the reference's morphable test (tests/test_kernels.py), the
# mixes of examples/morphable_inference.py, and a two-model mix: qwen2-1.5B's
# q projection beside llama2-7B's, at a smaller row count
MIXES = {
    "kernel test": [(100, 64, 96), (300, 120, 50), (60, 256, 256)],
    "one big GEMM": [(1024, 1024, 1024)],
    "two wide GEMMs (Fig 3)": [(128, 512, 2048), (128, 512, 1536)],
    "four small tenants": [(100, 64, 96), (60, 128, 64), (200, 96, 128),
                           (50, 256, 80)],
    "qwen2 q + llama2 q": [(32, 1536, 1536), (16, 4096, 4096)],
}


def _grouped_data(sizes, k, n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(sum(sizes), k).astype(np.float32)
    w = (rng.randn(len(sizes), k, n) * k ** -0.5).astype(np.float32)
    if dtype == "bfloat16":
        xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        wt = torch.from_numpy(w).to(torch.bfloat16)
        return xj, wj, xt, wt
    return jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x), \
        torch.from_numpy(w)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("sizes,k,n,dtype", GROUPED, ids=str)
def test_grouped_matmul_routes_match_jax(sizes, k, n, dtype):
    xj, wj, xt, wt = _grouped_data(sizes, k, n, dtype)
    want_pallas = japi.ops.grouped_matmul(xj, wj, sizes, backend="pallas",
                                          interpret=True)
    want_ref = japi.ops.grouped_matmul(xj, wj, sizes, backend="ref")
    got_cuda = api.ops.grouped_matmul(xt, wt, sizes)   # plain on the CPU
    got_ref = api.ops.grouped_matmul(xt, wt, sizes, backend="ref")
    assert got_cuda.shape == got_ref.shape == (sum(sizes), n)
    assert got_cuda.dtype == got_ref.dtype == torch.float32
    _close(got_cuda, want_pallas, GEMM_TOL)
    _close(got_ref, want_ref, GEMM_TOL)


@pytest.mark.parametrize("bm", [128, 64])
def test_grouped_matmul_plain_and_ref_agree(bm):
    """The kernel's plain version (a product per run of equal groups) and
    the oracle (gather + batched matmul) on unpadded operands, with the
    groups out of order and one repeated."""
    rng = np.random.RandomState(1)
    gids = torch.tensor([2, 2, 0, 1, 1, 1, 0], dtype=torch.int32)
    x = torch.from_numpy(rng.randn(7 * bm, 40).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 40, 24).astype(np.float32))
    plain = grouped_matmul_plain(gids, x, w, bm=bm)
    assert torch.equal(grouped_matmul(gids, x, w, bm=bm), plain)
    torch.testing.assert_close(plain, grouped_matmul_ref(gids, x, w, bm=bm),
                               rtol=GEMM_TOL, atol=GEMM_TOL)
    half = grouped_matmul_plain(gids, x, w, bm=bm, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, plain.to(torch.bfloat16))


def test_make_group_ids_matches_jax_and_raises_alike():
    assert make_group_ids((128, 384, 128), 128).tolist() == \
        np.asarray(jmake_group_ids((128, 384, 128), 128)).tolist()
    assert make_group_ids((128, 384, 128), 128).dtype == torch.int32
    with pytest.raises(ValueError) as want:
        jmake_group_ids((128, 100), 128)
    with pytest.raises(ValueError) as got:
        make_group_ids((128, 100), 128)
    assert str(got.value) == str(want.value)
    x, w = torch.zeros(228, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="not a multiple of bm=128"):
        api.ops.grouped_matmul(x, w, (128, 100))


@pytest.mark.parametrize("mix", list(MIXES), ids=str)
def test_morphable_multi_gemm_matches_jax(mix):
    """Each tenant's result within 1e-5 of JAX's, and the MAC utilization
    exactly JAX's (host arithmetic on the same packing). The small mix runs
    JAX's Pallas kernel in interpret mode, the larger ones its reference."""
    rng = np.random.RandomState(2)
    shapes = MIXES[mix]
    arrays = [(rng.randn(m, k).astype(np.float32),
               rng.randn(k, n).astype(np.float32)) for m, k, n in shapes]
    jbackend = "pallas" if mix == "kernel test" else "ref"
    want, want_util = japi.ops.morphable_multi_gemm(
        [(jnp.asarray(x), jnp.asarray(w)) for x, w in arrays],
        backend=jbackend, interpret=True)
    got, util = api.ops.morphable_multi_gemm(
        [(torch.from_numpy(x), torch.from_numpy(w)) for x, w in arrays])
    assert util == want_util
    assert 0 < util <= 1
    for (x, w), g, wnt in zip(arrays, got, want):
        assert tuple(g.shape) == (x.shape[0], w.shape[1])
        _close(g, wnt, GEMM_TOL)


def test_pack_tenants_pads_with_zeros():
    x1, w1 = torch.ones(3, 5), torch.ones(5, 7)
    x2, w2 = torch.full((20, 2), 2.0), torch.full((2, 3), 3.0)
    x, w, sizes, metas = pack_tenants([(x1, w1), (x2, w2)], 16, 8, 4)
    assert x.shape == (48, 8) and w.shape == (2, 8, 8)
    assert sizes == [16, 32] and metas == [(slice(0, 3), 7),
                                           (slice(16, 36), 3)]
    assert x.sum() == 3 * 5 + 20 * 2 * 2 and w.sum() == 5 * 7 + 2 * 3 * 3
    _, util = api.ops.morphable_multi_gemm([(x1, w1), (x2[:16], w2)],
                                           bm=16, bk=8, bn=4)
    assert util == (3 * 5 * 7 + 16 * 2 * 3) / (32 * 8 * 8)


def test_multi_gemm_hands_the_kernel_each_tenants_extents(monkeypatch):
    """`morphable_multi_gemm` passes the grouped GEMM wrapper each tenant's
    own (K, N), so the kernel skips the padding; the results and the MAC
    utilization stay those of the ref route, which multiplies the
    padding."""
    seen = []
    real = grouped_ops.grouped_matmul

    def spy(*args, **kw):
        seen.append((kw.get("group_k"), kw.get("group_n")))
        return real(*args, **kw)

    monkeypatch.setattr(grouped_ops, "grouped_matmul", spy)
    shapes = MIXES["kernel test"]
    rng = np.random.RandomState(3)
    tenants = [(torch.from_numpy(rng.randn(m, k).astype(np.float32)),
                torch.from_numpy(rng.randn(k, n).astype(np.float32)))
               for m, k, n in shapes]
    got, util = api.ops.morphable_multi_gemm(tenants)
    assert seen == [([k for _, k, _ in shapes], [n for _, _, n in shapes])]
    want, want_util = api.ops.morphable_multi_gemm(tenants, backend="ref")
    assert util == want_util
    for g, wnt in zip(got, want):
        _close(g, wnt.numpy(), GEMM_TOL)


def _product_within_extents(gids, x, w, bm, ks, ns):
    """The extent contract of the grouped GEMM: row tile i of group g
    multiplies only k < ks[g] and is zero at n >= ns[g]."""
    out = torch.zeros(x.shape[0], w.shape[2])
    for i, g in enumerate(gids.tolist()):
        rows = slice(i * bm, (i + 1) * bm)
        out[rows, :ns[g]] = x[rows, :ks[g]] @ w[g, :ks[g], :ns[g]]
    return out


def test_grouped_plain_honours_extents():
    """On operands zero past each group's extents (as `pack_tenants` pads
    them) the CPU route, which checks the extents and multiplies the
    padding, gives the product within the extents, with the padded columns
    exactly 0; bad extents raise, a tensor among them."""
    rng = np.random.RandomState(4)
    gids = torch.tensor([0, 0, 1], dtype=torch.int32)
    ks, ns = [40, 17], [24, 9]
    x = torch.from_numpy(rng.randn(48, 40).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 40, 24).astype(np.float32))
    x[32:, ks[1]:] = 0
    w[1, ks[1]:] = 0
    w[1, :, ns[1]:] = 0
    got = grouped_matmul(gids, x, w, bm=16, group_k=ks, group_n=ns)
    assert torch.equal(got, grouped_matmul_plain(gids, x, w, bm=16))
    torch.testing.assert_close(
        got, _product_within_extents(gids, x, w, 16, ks, ns),
        rtol=GEMM_TOL, atol=GEMM_TOL)
    assert torch.equal(got[32:, 9:], torch.zeros(16, 15))
    with pytest.raises(ValueError, match="group_k"):
        grouped_matmul(gids, x, w, bm=16, group_k=[41, 1])
    with pytest.raises(ValueError, match="group_n"):
        grouped_matmul(gids, x, w, bm=16, group_n=[24])
    with pytest.raises(ValueError, match="group_n"):
        grouped_matmul(gids, x, w, bm=16, group_n=torch.tensor(ns))


@pytest.mark.parametrize("t,k,n,bm", [(1024, 1024, 1024, 128),
                                      (384, 4096, 4096, 128),
                                      (640, 256, 128, 128),
                                      (80, 1536, 33, 16), (96, 40, 200, 32)])
def test_grouped_plan_tiles_divide_bm_and_slices_cover_k(t, k, n, bm):
    tm, kc, slices = grouped_plan(t, k, n, bm)
    assert tm in ROW_TILES and bm % tm == 0
    assert kc % 16 == 0 and (slices - 1) * kc < k <= slices * kc


# ============================================================ depthwise
DEPTHWISE = [(2, 9, 7, 96, 3), (1, 7, 11, 130, 5), (2, 13, 9, 3, 7),
             (1, 6, 5, 64, 4)]


@pytest.mark.parametrize("n,h,w,c,kk", DEPTHWISE, ids=str)
def test_depthwise_matches_jax(n, h, w, c, kk):
    rng = np.random.RandomState(kk)
    x = rng.randn(n, h, w, c).astype(np.float32)
    f = rng.randn(kk, kk, c).astype(np.float32)
    want_pallas = japi.ops.depthwise_conv(jnp.asarray(x), jnp.asarray(f),
                                          backend="pallas", interpret=True)
    want_ref = japi.ops.depthwise_conv(jnp.asarray(x), jnp.asarray(f),
                                       backend="ref")
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    plain = depthwise_plain(xt, ft)
    _close(plain, want_pallas, DW_TOL)
    assert torch.equal(depthwise_conv(xt, ft), plain)  # the wrapper, on CPU
    assert torch.equal(api.ops.depthwise_conv(xt, ft), plain)
    got_ref = api.ops.depthwise_conv(xt, ft, backend="ref")
    _close(got_ref, want_ref, DW_TOL)
    torch.testing.assert_close(depthwise_ref(xt, ft), got_ref, rtol=0,
                               atol=0)


def test_depthwise_plain_bf16_multiplies_in_bf16():
    """A bf16 input multiplies in bf16 and adds in f32, as the reference
    kernel does; the output is bf16."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 5, 6, 8).astype(np.float32)).to(
        torch.bfloat16)
    f = torch.from_numpy(rng.randn(3, 3, 8).astype(np.float32)).to(
        torch.bfloat16)
    got = depthwise_plain(x, f)
    assert got.dtype == torch.bfloat16
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(1, 5, 6, 8)
    for dh in range(3):
        for dw in range(3):
            prod = (xp[:, dh:dh + 5, dw:dw + 6].float() * f[dh, dw].float()
                    ).to(torch.bfloat16)
            acc = acc + prod.float()
    assert torch.equal(got, acc.to(torch.bfloat16))
