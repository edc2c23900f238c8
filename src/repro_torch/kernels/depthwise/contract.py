"""Launch contract of the depthwise-conv impl (`depthwise_conv`,
`csrc/depthwise.cu`).

The kernel chooses its tile plan in C++ (`make_plan`, from the shapes and
the card's 132 SMs), so this contract models that function: a block
computes a th x (sw * 4) tile of outputs over cv 16-byte channel vectors
(4 f32 or 8 bf16 channels); grid (wt * ct, ht, N), cv * sw * th threads,
and its halo and filter taps in dynamic shared memory. Block (x, y, z)
reads the halo rows [h0 - ph, h0 + th + kh - 1 - ph) and columns [w0 - pw,
w0 + tw + kw - 1 - pw) of image z, clipped to the image (the SAME padding
is zero fill), over its channels clipped to C, and writes its outputs
clipped to the image and to C. Offsets are 64-bit (`long`).

Cases: the reference's (`repro/kernels/depthwise/contract.py`), then
MobileNetV2's 3 x 3 at 14 x 14 x 576 in f32 and bf16, a channel count
that is not a multiple of the vector width, and a 2 x 4 filter (the
kernel's generic-width instance).
"""
from __future__ import annotations

import dataclasses

import torch

from ...api.policy import ExecutionPolicy
from ...api.registry import (BlockContract, KernelLaunch, LaunchContract,
                             register_contract)
from ..common import ceil_div
from ..contracts import card_and_plain, span
from .ops import _depthwise_cuda

__all__ = ["depthwise_contract", "make_plan"]

# csrc/depthwise.cu
OW, MAX_THREADS, MAX_SMEM = 4, 256, 96 * 1024
PLAN_BLOCKS, PLAN_CV_MIN, PLAN_CV_MAX = 4, 8, 16
SMS = 132                  # an H100 SXM (the kernel asks the device)

_CASES = (
    # the reference's cases
    {"n": 2, "h": 12, "w": 20, "c": 96, "kh": 3, "kw": 3},
    {"n": 1, "h": 7, "w": 7, "c": 320, "kh": 5, "kw": 5},
    # MobileNetV2 at 14 x 14 x 576 (f32, bf16); C % 4 != 0; a 2 x 4 filter
    {"n": 8, "h": 14, "w": 14, "c": 576, "kh": 3, "kw": 3},
    {"n": 8, "h": 14, "w": 14, "c": 576, "kh": 3, "kw": 3, "dtype": "bf16"},
    {"n": 2, "h": 9, "w": 11, "c": 10, "kh": 7, "kw": 7},
    {"n": 1, "h": 5, "w": 13, "c": 64, "kh": 2, "kw": 4},
)


@dataclasses.dataclass
class Plan:
    cv: int = 0
    sw: int = 1
    th: int = 8
    wt: int = 0
    ht: int = 0
    ct: int = 0

    def tw(self) -> int:
        return self.sw * OW

    def threads(self) -> int:
        return self.cv * self.sw * self.th


def smem_bytes(p: Plan, kh: int, kw: int) -> int:
    return 16 * p.cv * ((p.th + kh - 1) * (p.tw() + kw - 1) + kh * kw)


def _least_waste(n: int, lo: int, hi: int) -> int:
    best, waste = hi, 1 << 30
    for d in range(hi, lo - 1, -1):
        wd = ceil_div(n, d) * d - n
        if wd < waste:
            waste, best = wd, d
    return best


def make_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, vec: int,
              sms: int = SMS) -> Plan:
    """`make_plan` of csrc/depthwise.cu, step for step."""
    p = Plan()
    cvt = ceil_div(c, vec)
    waste = 1 << 30
    for sw in range(min(16 // OW, ceil_div(w, OW)), 0, -1):
        wd = ceil_div(w, sw * OW) * sw * OW - w
        if wd < waste:
            waste, p.sw = wd, sw
    p.cv = cvt if cvt <= PLAN_CV_MAX else _least_waste(
        cvt, PLAN_CV_MAX // 2, PLAN_CV_MAX)
    while p.th > 1 and p.th // 2 >= h:
        p.th //= 2

    def tiles(q: Plan) -> int:
        return (n * ceil_div(h, q.th) * ceil_div(w, q.tw())
                * ceil_div(cvt, q.cv))
    target = PLAN_BLOCKS * sms
    while p.cv > PLAN_CV_MIN and tiles(p) < target:
        p.cv = max(PLAN_CV_MIN, p.cv // 2)
    while p.th > 1 and tiles(p) < target:
        p.th //= 2

    def fits(q: Plan) -> bool:
        return q.threads() <= MAX_THREADS and smem_bytes(q, kh, kw) <= MAX_SMEM
    while p.th > 1 and not fits(p):
        p.th //= 2
    while p.sw > 1 and not fits(p):
        p.sw //= 2
    while p.cv > 1 and not fits(p):
        p.cv = ceil_div(p.cv, 2)
    p.ht, p.wt = ceil_div(h, p.th), ceil_div(w, p.tw())
    p.ct = ceil_div(cvt, p.cv)
    return p


@register_contract("depthwise_conv", "cuda", cases=_CASES)
def depthwise_contract(case: dict,
                       policy: ExecutionPolicy) -> LaunchContract:
    n, h, w, c, kh, kw = (case[k] for k in ("n", "h", "w", "c", "kh", "kw"))
    bf16 = case.get("dtype") == "bf16"
    vec = 8 if bf16 else 4
    p = make_plan(n, h, w, c, kh, kw, vec)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    es = 2 if bf16 else 4

    def where(x, y):
        cb, wb = x % p.ct, x // p.ct
        return y * p.th, wb * p.tw(), cb * p.cv * vec

    def halo(x, y, z, *_):
        h0, w0, c0 = where(x, y)
        return (z, span(max(h0 - ph, 0), min(h0 + p.th + kh - 1 - ph, h)),
                span(max(w0 - pw, 0), min(w0 + p.tw() + kw - 1 - pw, w)),
                span(c0, min(c0 + p.cv * vec, c)))

    def taps(x, y, z, *_):
        c0 = where(x, y)[2]
        return (0, 0, span(c0, min(c0 + p.cv * vec, c)))

    def outputs(x, y, z, *_):
        h0, w0, c0 = where(x, y)
        return (z, span(h0, min(h0 + p.th, h)), span(w0, min(w0 + p.tw(), w)),
                span(c0, min(c0 + p.cv * vec, c)))

    img = (n, h, w, c)
    blocks = (
        BlockContract("x", img, (1, 1, 1, 1), halo, dtype_bytes=es),
        BlockContract("filt", (kh, kw, c), (kh, kw, 1), taps, dtype_bytes=es),
        BlockContract("out", img, (1, 1, 1, 1), outputs, dtype_bytes=es,
                      is_output=True),
    )
    launch = KernelLaunch("depthwise_kernel", (p.wt * p.ct, p.ht, n), blocks,
                          threads=p.threads(),
                          smem_bytes=smem_bytes(p, kh, kw))

    def body():
        g = torch.Generator().manual_seed(0)
        dt = torch.bfloat16 if bf16 else torch.float32
        x = torch.randn(n, h, w, c, generator=g).to(dt)
        f = torch.randn(kh, kw, c, generator=g).to(dt)
        return card_and_plain(_depthwise_cuda, x, f, policy=policy)
    return LaunchContract((launch,), entry="depthwise_conv", body=body)
