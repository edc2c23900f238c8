"""The full-sequence flash kernel's arithmetic, on the CPU.

The kernel (`csrc/flash_full.cu`) runs its products on the tensor cores as
bf16 MMAs over operands split into three bf16 terms: q and P always, K and
V too when they are f32, keeping the 6 term products with i + j <= 2 (3
products for bf16 K/V). A CPU emulation of that arithmetic is held to
`flash_attention_plain` within the card's gate of 1e-4 on the cases of
`chip_smoke.py` phase 3d (the reference's six, non-causal, bf16 K/V, GQA
group 6 at qwen2-1.5B's heads)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention.full import full_workspace

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-4          # the kernel's gate against its plain version on the card
NEG_INF = -1e30

CASES = [
    ("causal", dict(b=2, hq=4, hkv=2, lq=128, lk=128, d=64)),
    ("lk 300", dict(b=1, hq=8, hkv=2, lq=256, lk=300, d=64)),
    ("window 100", dict(b=1, hq=4, hkv=4, lq=128, lk=256, d=64, window=100)),
    ("softcap 30", dict(b=1, hq=4, hkv=2, lq=128, lk=256, d=64,
                        softcap=30.0)),
    ("offset 256", dict(b=1, hq=4, hkv=2, lq=128, lk=384, d=64, offset=256)),
    ("window 64 softcap 50", dict(b=1, hq=2, hkv=1, lq=128, lk=128, d=128,
                                  window=64, softcap=50.0)),
    ("non-causal", dict(b=2, hq=6, hkv=2, lq=128, lk=200, d=32,
                        causal=False)),
    ("bf16 K/V", dict(b=2, hq=12, hkv=2, lq=256, lk=256, d=128,
                      kv="bf16")),
    ("group 6", dict(b=2, hq=12, hkv=2, lq=512, lk=512, d=128)),
]


def _split3(x):
    """x = hi + mid + lo, each term the nearest bf16 to what is left."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def _products(eq, a, b, b_split):
    """einsum(eq, a, b) as the kernel's MMA sequence, smallest terms first:
    a split A times an exact-bf16 B (3 products), or times a split B (the 6
    with i + j <= 2)."""
    ah, am, al = _split3(a)
    if not b_split:
        return sum(torch.einsum(eq, t, b) for t in (al, am, ah))
    bh, bm, bl = _split3(b)
    return sum(torch.einsum(eq, x, y) for x, y in (
        (al, bh), (am, bm), (ah, bl), (am, bh), (ah, bm), (ah, bh)))


def _emulate(q, k, v, *, kv_split, causal=True, window=None, softcap=None,
             offset=0):
    """The kernel's arithmetic in a few batched ops: three-term products
    for Q K^T and P V, the scale, softcap and mask, one softmax over all
    keys. (The kernel also rescales between its 32-key tiles; that adds
    roundings of f32 size, not of the terms.)"""
    b, hq, lq, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, 1)
    v = v.repeat_interleave(group, 1)
    lk = k.shape[2]
    x = _products("bhqd,bhkd->bhqk", q, k, kv_split) * d ** -0.5
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    qpos = offset + torch.arange(lq)[:, None]
    key = torch.arange(lk)[None, :]
    keep = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        keep &= key <= qpos
    if window:
        keep &= key > qpos - window
    x = torch.where(keep, x, torch.tensor(NEG_INF))
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    acc = _products("bhqk,bhkd->bhqd", p, v, kv_split)
    return acc / p.sum(-1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("label,case", CASES, ids=[c[0] for c in CASES])
def test_three_term_bf16_products_meet_the_gate(label, case):
    """The emulated kernel is within 1e-4 of the plain version (the card's
    gate) on every row: f32 K/V through 6 products, bf16 K/V through 3."""
    rng = np.random.RandomState(5)
    b, hq, hkv, lq, lk, d = (case[n] for n in ("b", "hq", "hkv", "lq", "lk",
                                               "d"))
    q = torch.from_numpy(rng.randn(b, hq, lq, d).astype(np.float32)) * 0.5
    k = torch.from_numpy(rng.randn(b, hkv, lk, d).astype(np.float32)) * 0.5
    v = torch.from_numpy(rng.randn(b, hkv, lk, d).astype(np.float32))
    bf16 = case.get("kv") == "bf16"
    if bf16:
        k, v = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float()
    kw = {n: case[n] for n in ("causal", "window", "softcap", "offset")
          if n in case}
    got = _emulate(q, k, v, kv_split=not bf16, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    err = (got - want).abs().max().item()
    assert err <= TOL, err


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0, 1e4])
def test_three_terms_hold_an_f32_value_exactly(scale):
    """hi + mid + lo is the f32 value itself (8 + 8 + 8 significand bits
    hold f32's 24): the terms that the kernel's pre-pass splits f32 K/V
    into lose nothing, so only the dropped products with i + j > 2 and the
    f32 sums round."""
    x = torch.from_numpy(
        np.random.RandomState(3).randn(4096).astype(np.float32)) * scale
    hi, mid, lo = _split3(x)
    assert torch.equal((hi.double() + mid.double() + lo.double()),
                       x.double())


@pytest.mark.parametrize("d,kv_bf16,terms", [(128, False, 3), (128, True, 1),
                                              (36, False, 3), (96, True, 1)])
def test_workspace_holds_each_kv_row_in_its_terms(d, kv_bf16, terms):
    """The K/V term workspace: for each kv-row, K and V in 1 (bf16) or 3
    (f32) terms of Lk rows of D padded to 16 (the MMAs' k-step)."""
    b, hkv, lk = 4, 2, 2048
    dp = -(-d // 16) * 16
    assert full_workspace(b, hkv, lk, d, kv_bf16) == \
        b * hkv * 2 * terms * lk * dp
