"""Port parity of the exact pieces: `pow2_ceil` and the int8-KV `_q8` codes
and scales bitwise against the JAX package, the per-row cache write (drop,
never clamp, out-of-range positions; rows with lengths == 0 keep their
cache), the attention routing table against the JAX rule, the policy and
registry surface, and an import audit: nothing under `src/repro_torch/`
or `chip_smoke.py` imports `jax` or `repro`."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.formats import pow2_ceil as jpow2_ceil
from repro.models.attention import _q8 as jq8
from repro_torch import api
from repro_torch.core.formats import pow2_ceil
from repro_torch.models.attention import _q8, _row_update

import _xdist_threads  # noqa: F401  (one torch thread a worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ================================================================ formats
# normal float32 inputs: the JAX reference on the CPU flushes subnormal
# results to zero, while the port stays exact down to 2^-149 (checked by
# test_pow2_ceil_exact_power_is_its_own_scale)
POW2_POINTS = np.concatenate([
    np.float32(2.0) ** np.arange(-126, 128, dtype=np.float32),   # exact
    np.float32([2.0 ** -64, 1.5 * 2.0 ** -126, 1e-30, 1e-8, 0.3, 1.0, 1.5,
                127.0, 1000.0, 3e38]),
]).astype(np.float32)


def test_pow2_ceil_bitwise_matches_jax():
    want = np.asarray(jpow2_ceil(jnp.asarray(POW2_POINTS)))
    got = pow2_ceil(torch.from_numpy(POW2_POINTS)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("e", [-149, -127, -126, -64, -1, 0, 1, 64, 127])
def test_pow2_ceil_exact_power_is_its_own_scale(e):
    x = torch.tensor([2.0 ** e], dtype=torch.float32)
    assert pow2_ceil(x).item() == 2.0 ** e
    # just above the power rounds up to the next one
    up = torch.nextafter(x, torch.tensor([np.inf], dtype=torch.float32))
    if e < 127:
        assert pow2_ceil(up).item() == 2.0 ** (e + 1)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 40.0])
def test_q8_codes_and_scales_bitwise(scale):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 3, 17, 16) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # the 1e-8 floor
    x[1, 2, 5, :4] = [127.5, -128.5, 0.5, 2.5]         # half-to-even ties
    jc, js = jq8(jnp.asarray(x))
    tc, ts = _q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


# ============================================================ cache writes
def _buf(b=3, h=2, lmax=10, d=4):
    return torch.arange(b * h * lmax * d, dtype=torch.float32).reshape(
        b, h, lmax, d)


def test_row_update_drops_out_of_range_tail():
    """A final partial chunk whose window overruns max_len keeps its valid
    tokens at the right positions: the overrun is dropped, not clamped."""
    buf = _buf()
    old = buf.clone()
    new = -1.0 - torch.arange(3 * 2 * 4 * 4, dtype=torch.float32).reshape(
        3, 2, 4, 4)
    start = torch.tensor([8, 0, 9], dtype=torch.int32)
    _row_update(buf, new, start)
    # row 0: positions 8, 9 get tokens 0, 1; tokens 2, 3 are dropped
    assert torch.equal(buf[0, :, 8:], new[0, :, :2])
    assert torch.equal(buf[0, :, :8], old[0, :, :8])
    # row 1: all four land at 0..3
    assert torch.equal(buf[1, :, :4], new[1])
    assert torch.equal(buf[1, :, 4:], old[1, :, 4:])
    # row 2: only token 0 fits, at position 9
    assert torch.equal(buf[2, :, 9], new[2, :, 0])
    assert torch.equal(buf[2, :, :9], old[2, :, :9])


def test_row_update_keeps_rows_with_zero_length():
    buf = _buf()
    old = buf.clone()
    new = torch.full((3, 2, 1, 4), -7.0)
    keep = torch.tensor([True, False, True])
    _row_update(buf, new, torch.tensor([2, 2, 9], dtype=torch.int32), keep)
    assert torch.equal(buf[1], old[1])
    assert torch.equal(buf[0, :, 2], new[0, :, 0])
    assert torch.equal(buf[2, :, 9], new[2, :, 0])
    buf[0, :, 2] = old[0, :, 2]
    buf[2, :, 9] = old[2, :, 9]
    assert torch.equal(buf, old)


# ================================================================ routing
ROUTE_CASES = [
    dict(lq=1, lk=256, offset_ndim=1),
    dict(lq=1, lk=256, offset_ndim=0),
    dict(lq=8, lk=256, offset_ndim=0),
    dict(lq=9, lk=256, offset_ndim=0),
    dict(lq=20, lk=256, offset_ndim=1),
    dict(lq=2, lk=2, offset_ndim=1),
    dict(lq=32, lk=2048, offset_ndim=1, quantized=True),
    dict(lq=16, lk=16, offset_ndim=0),
    dict(lq=128, lk=128, offset_ndim=0),
    dict(lq=128, lk=512, offset_ndim=0),
    dict(lq=1, lk=256, offset_ndim=1, causal=False),
    dict(lq=4, lk=256, offset_ndim=1, causal=False),
    dict(lq=128, lk=384, offset_ndim=0),
    dict(lq=256, lk=300, offset_ndim=0),
    dict(lq=128, lk=128, offset_ndim=0, causal=False),
    dict(lq=128, lk=128, offset_ndim=0, quantized=True),
    dict(lq=128, lk=2048, offset_ndim=1),
    dict(lq=120, lk=120, offset_ndim=0),
]
# the JAX route names under its kernel backend, in the port's terms
_PORT_NAME = {"pallas-decode": "cuda-decode", "pallas-prefill": "cuda-prefill",
              "pallas": "cuda", "ref": "ref"}


@pytest.mark.parametrize("case", ROUTE_CASES, ids=str)
@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_attention_route_matches_jax(case, backend):
    jbackend = "ref" if backend == "ref" else "pallas"
    want = japi.ops.attention_route(backend=jbackend, **case)
    assert api.ops.attention_route(backend=backend, **case) == \
        _PORT_NAME[want]


def test_policy_nesting_and_validation():
    assert api.current_policy() == api.default_policy
    with api.policy(backend="ref", bq=8) as outer:
        assert api.current_policy() is outer
        with api.policy(bkv=64) as inner:
            assert (inner.backend, inner.bq, inner.bkv) == ("ref", 8, 64)
        assert api.current_policy() is outer
    assert api.current_policy() == api.default_policy
    with pytest.raises(ValueError, match="backend"):
        api.ExecutionPolicy(backend="pallas")
    with pytest.raises(ValueError, match="tile"):
        api.ExecutionPolicy(bq=0)
    with pytest.raises(ValueError, match="tile"):
        api.ExecutionPolicy(bm=0)
    with pytest.raises(ValueError, match="out_dtype"):
        api.ExecutionPolicy(out_dtype=torch.int32)
    pol = api.ExecutionPolicy()
    assert (pol.bm, pol.bn, pol.bk, pol.out_dtype) == (128, 128, 128,
                                                       torch.float32)


def test_registry_lookup():
    assert api.registry.implementations("attention") == [
        "cuda", "cuda-decode", "cuda-prefill", "ref"]
    with pytest.raises(KeyError, match="no 'cuda-decode' implementation"):
        api.registry.lookup("matmul", "cuda-decode")
    for op in ("matmul_codes", "grouped_matmul", "depthwise_conv"):
        assert api.registry.implementations(op) == ["cuda", "ref"]
    with pytest.raises(KeyError, match="unknown op"):
        api.registry.lookup("conv3d", "ref")
    with pytest.raises(ValueError, match="not in"):
        api.register("attention", "pallas")


# ================================================================ imports
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + sorted((ROOT / "examples").glob("pt_*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(
        {m for m in _imported_roots(p) if m in ("jax", "jaxlib", "repro")})
        for p in files}
    assert not {p: m for p, m in bad.items() if m}, bad
