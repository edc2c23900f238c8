#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100); exits non-zero without one. Imports nothing
of JAX or of the JAX package `repro`. Phases:

1. Device: the card's name, count, and `nvidia-smi` name and power limit.
2. Build: nvcc-builds every kernel source for sm_90a (one process per
   source, in parallel) and prints each kernel's `-Xptxas -v` report.
3. Kernel vs plain: each of the 4 kernels (flash-decode and varlen
   flash-prefill, dense and int8-KV) against its plain PyTorch version on
   the card, at the serving shapes of qwen2-1.5B (B=8, Hq=12, Hkv=2, D=128,
   Lk=2048) and on a small windowed, softcapped GQA case: max |diff| <= 1e-4
   (atol and rtol; f32 summed in another order), prefill pad rows exactly
   0, fused int8 bitwise equal to the kernel on the dequantized K/V.
4. Timing: CUDA-event time per launch of each kernel, its plain version and
   one PyTorch library call computing the same function
   (scaled_dot_product_attention with an explicit boolean mask over the
   same cache, timed only here), beside the least time the card could take
   (bytes this run's inputs need over 3.35 TB/s, or f32 flops of the kept
   (query, key) pairs over 67 TFLOP/s, whichever is larger). Inputs rotate
   over enough cache copies to exceed the 50 MB L2, as 28 layers' caches
   do on the serving path.
5. Engine: ServingEngine on the full-width qwen2_1p5b CONFIG (random f32
   weights, seed 0), 8 slots, max_len 2048, prefill chunk 32, 8 requests
   with prompts of 16..1000 tokens and 32 new tokens each — dense and
   int8-KV. A free-running pass of the kernel engine alone gives the
   launch counts (every kernel of the path must have launched), tokens/s,
   step times and peak memory; routes must be cuda-decode / cuda-prefill.
   A second pass serves the same requests beside two backend="ref"
   engines on the card. Its tokens must equal the first pass's, match the
   lockstep reference (put in the kernel engine's state before each step)
   at every step but near-ties (top-1/top-2 logit margin <= 1e-3), and
   match the free-running reference up to each request's first near-tie
   or, with int8 KV, its first step where the two engines' codes or
   scales differ (after either the streams may rightly diverge).
6. Summary: a `{"kernels": [...]}` line, then as the last line
   `{"ok": true, "device": {...}}`. Any failed check exits non-zero before.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNELS, flash_decode, flash_decode_plain, flash_decode_quant,
    flash_decode_quant_plain, flash_prefill, flash_prefill_plain,
    flash_prefill_quant, flash_prefill_quant_plain)
from repro_torch.kernels.flash_attention.shared import dequant  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.attention import _q8  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
TOL = 1e-4
MARGIN = 1e-3

# serving shapes of qwen2-1.5B
B, HQ, HKV, D, LK, W = 8, 12, 2, 128, 2048, 32
DECODE_POS = [0, 127, 128, 1000, LK - 1 - 1, 500, 1500, 64]
PREFILL_POS = [0, 127, 128, 1000, LK - 1 - W, 300, 1700, 64]
PREFILL_LEN = [W, 1, 17, 0, W, 5, W, 20]

KERNEL_META = {
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:321"),
    "flash_decode_quant": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_attention/decode.py:351"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention/prefill.py:364"),
    "flash_prefill_quant": ("src/repro_torch/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_attention/prefill.py:395"),
}


def check(cond, msg: str):
    """A failed check ends the run at once with a non-zero exit code."""
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def phase(title: str):
    print(f"\n=== {title}", flush=True)


def cuda_ms(fns, iters: int) -> float:
    """Mean CUDA-event milliseconds per call, cycling through `fns` (the
    same call on different input copies), after a warm-up."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs
def make_case(dev, seed, *, b, hq, hkv, lq, lk, pos, lens=None):
    """One attention case as the serving path hands it over: q a head-split
    (strided) f32 view, a bf16 cache, and its int8 codes + pow2 scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, hq, D, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(b, hkv, lk, D, generator=g, device=dev) * 0.5
    v = torch.randn(b, hkv, lk, D, generator=g, device=dev)
    kc, ks = _q8(k)
    vc, vs = _q8(v)
    case = dict(q=q * 0.5, k=k.to(torch.bfloat16), v=v.to(torch.bfloat16),
                kc=kc, ks=ks, vc=vc, vs=vs,
                pos=torch.tensor(pos, dtype=torch.int32, device=dev))
    if lens is not None:
        case["lens"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    return case


def calls(name, c, kw):
    """(kernel call, plain call, dequantized-kernel call or None) of one
    kernel on case c."""
    q, pos = c["q"], c["pos"]
    quant = (c["kc"], c["ks"], c["vc"], c["vs"])
    if name.startswith("flash_prefill"):
        kw = dict(kw, lengths=c["lens"])
    if name == "flash_decode":
        return (lambda: flash_decode(q, c["k"], c["v"], pos=pos, **kw),
                lambda: flash_decode_plain(q, c["k"], c["v"], pos=pos, **kw),
                None)
    if name == "flash_prefill":
        return (lambda: flash_prefill(q, c["k"], c["v"], pos=pos, **kw),
                lambda: flash_prefill_plain(q, c["k"], c["v"], pos=pos, **kw),
                None)
    deq = (dequant(c["kc"], c["ks"], q.dtype), dequant(c["vc"], c["vs"],
                                                       q.dtype))
    if name == "flash_decode_quant":
        return (lambda: flash_decode_quant(q, *quant, pos=pos, **kw),
                lambda: flash_decode_quant_plain(q, *quant, pos=pos, **kw),
                lambda: flash_decode(q, *deq, pos=pos, **kw))
    return (lambda: flash_prefill_quant(q, *quant, pos=pos, **kw),
            lambda: flash_prefill_quant_plain(q, *quant, pos=pos, **kw),
            lambda: flash_prefill(q, *deq, pos=pos, **kw))


def library_call(name, c):
    """scaled_dot_product_attention over the same cache (widened or
    dequantized to f32 beforehand, outside the timed call) with an explicit
    boolean causal mask at the per-row positions."""
    q, pos = c["q"], c["pos"]
    if name.endswith("_quant"):
        k32, v32 = dequant(c["kc"], c["ks"], q.dtype), dequant(
            c["vc"], c["vs"], q.dtype)
    else:
        k32, v32 = c["k"].float(), c["v"].float()
    lq, lk = q.shape[2], k32.shape[2]
    qpos = pos[:, None] + torch.arange(lq, device=q.device)
    mask = (torch.arange(lk, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(q, k32, v32,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def bound(name, c):
    """Least time (ms) for this run's inputs, and what sets it: the bytes
    that must move (the K/V positions the rows need, once; valid q rows in,
    the output out) over the memory rate, or the f32 flops of the kept
    (query, key) pairs over the f32 rate."""
    b, hq, lq, d = c["q"].shape
    hkv = c["k"].shape[1]
    pos = c["pos"].tolist()
    lens = c["lens"].tolist() if "lens" in c else [lq] * b
    per_pos = 2 * hkv * d * (1 if name.endswith("_quant") else 2)
    if name.endswith("_quant"):
        per_pos += 2 * hkv * 4                         # the pow2 scales
    keys = sum(p + n for p, n in zip(pos, lens) if n > 0)
    pairs = sum(p + i + 1 for p, n in zip(pos, lens) for i in range(n))
    nbytes = keys * per_pos + (sum(lens) + b * lq) * hq * d * 4 + 8 * b
    flops = pairs * hq * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ phases
def device_phase():
    phase("1. device")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one card")
        return None
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"device {name!r}, count {count}")
    print(smi)
    return name, count, smi


def build_phase():
    phase("2. build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    paths = common.build_kernels()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f}s with "
          f"nvcc {' '.join(common.NVCC_FLAGS)}")
    for src, report in sorted(common.BUILD_REPORTS.items()):
        for line in report.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  [{src}] {line.strip()}")


def kernel_phase(dev):
    phase("3. kernel vs plain (max |diff| <= 1e-4; pad rows 0; int8 fused "
          "== kernel on dequantized K/V bitwise)")
    main = {"decode": make_case(dev, 1, b=B, hq=HQ, hkv=HKV, lq=1, lk=LK,
                                pos=DECODE_POS),
            "prefill": make_case(dev, 2, b=B, hq=HQ, hkv=HKV, lq=W, lk=LK,
                                 pos=PREFILL_POS, lens=PREFILL_LEN)}
    small = {"decode": make_case(dev, 3, b=4, hq=8, hkv=2, lq=1, lk=300,
                                 pos=[0, 47, 200, 299]),
             "prefill": make_case(dev, 4, b=4, hq=8, hkv=2, lq=20, lk=300,
                                  pos=[0, 47, 200, 280], lens=[20, 3, 0, 20])}
    errs = {}
    for name in (k.__name__ for k in KERNELS):
        kind = "prefill" if "prefill" in name else "decode"
        for label, c, kw in (("main", main[kind], {}),
                             ("window48-softcap30-group4", small[kind],
                              dict(window=48, softcap=30.0))):
            kern, plain, deq = calls(name, c, kw)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
            line = f"  {name:20s} {label:26s} max|diff| {err:.3e}"
            if "lens" in c:
                pad = torch.arange(c["q"].shape[2], device=dev)[None, :] \
                    >= c["lens"][:, None]
                zero = not got.transpose(1, 2)[pad].any().item()
                line += f"  pad rows zero: {zero}"
                check(zero, f"{name} {label}: pad rows not exactly zero")
            if deq is not None:
                same = torch.equal(got, deq())
                line += f"  fused == dequantized: {same}"
                check(same, f"{name} {label}: fused int8 differs from the "
                      "kernel on dequantized K/V")
            print(line, flush=True)
            check(ok, f"{name} {label}: max |diff| {err} above {TOL}")
            if label == "main":
                errs[name] = err
    return errs


def timing_phase(dev):
    phase("4. timing at the serving shapes (ms per launch, CUDA events)")
    copies = {"decode": [], "prefill": []}
    for i in range(6):          # 6 x >= 8 MB of K/V per kernel: > 50 MB L2
        copies["decode"].append(make_case(dev, 10 + i, b=B, hq=HQ, hkv=HKV,
                                          lq=1, lk=LK, pos=DECODE_POS))
        copies["prefill"].append(make_case(dev, 20 + i, b=B, hq=HQ, hkv=HKV,
                                           lq=W, lk=LK, pos=PREFILL_POS,
                                           lens=PREFILL_LEN))
    rows = {}
    for name in (k.__name__ for k in KERNELS):
        cases = copies["prefill" if "prefill" in name else "decode"]
        kern = [calls(name, c, {})[0] for c in cases]
        plain = [calls(name, c, {})[1] for c in cases]
        lib = [library_call(name, c) for c in cases]
        ms = cuda_ms(kern, 60)
        plain_ms = cuda_ms(plain, 12)
        library_ms = cuda_ms(lib, 12)
        bound_ms, bound_by = bound(name, cases[0])
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"  {name:20s} kernel {ms:.4f}  plain {plain_ms:.4f}  "
              f"library {library_ms:.4f}  bound {bound_ms:.4f} ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it)", flush=True)
    return rows


class MarginEngine(ServingEngine):
    """The reference engine, also recording each emitted token's top-1 /
    top-2 logit margin."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.margins = {}
        self._margin_now = None

    def _greedy(self, rows, health):
        top = rows.topk(2, dim=-1).values
        self._margin_now = (top[:, 0] - top[:, 1]).cpu().numpy()
        return super()._greedy(rows, health)

    def _emit(self, s, tok, newly):
        rid = self._slot_req[s].rid
        self.margins.setdefault(rid, []).append(float(self._margin_now[s]))
        super()._emit(s, tok, newly)


def submit_all(eng, prompts, max_new):
    reqs = [Request(rid, p, max_new_tokens=max_new)
            for rid, p in enumerate(prompts)]
    for r in reqs:
        check(eng.submit(r), f"request {r.rid} refused")
    return reqs


def copy_state(dst, src):
    """Put engine `dst` in the device and host state of `src` (same
    geometry): caches, positions and last tokens."""
    for dc, sc in zip(dst.caches, src.caches):
        for f in dataclasses.fields(sc):
            getattr(dc, f.name).copy_(getattr(sc, f.name))
    dst._last[:] = src._last


def profile_step(eng) -> str:
    """One engine step under torch.profiler: its wall time, the device time
    of the kernels it ran, the device's idle share, and the host's kernel
    launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - ts)
    avg = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in avg) / 1e3
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    top = sorted(avg, key=dev_us, reverse=True)[:4]
    busy_txt = (f"device busy {busy:.2f} ms, idle "
                f"{100 * (1 - busy / wall):.0f}%" if busy > 0
                else "device time not measured (no CUDA events)")
    return (f"wall {wall:.2f} ms, {busy_txt}, {launches} host launches; top: "
            + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
                        for e in top))


def serve_timed(eng, prompts, max_new):
    """The main path as a user drives it: submit every request and step the
    engine until it drains, with nothing else on the card. Returns the
    pass's wall seconds (ended by a synchronize) and each step's host
    milliseconds, split into steps with a chunk launch and decode-only
    steps; a step ends where the engine reads its tokens back."""
    submit_all(eng, prompts, max_new)
    chunk_ms, decode_ms = [], []
    t0 = time.perf_counter()
    while eng.pending():
        calls_before = eng.stats.prefill_chunk_calls
        ts = time.perf_counter()
        eng.step()
        dt = 1e3 * (time.perf_counter() - ts)
        (chunk_ms if eng.stats.prefill_chunk_calls > calls_before
         else decode_ms).append(dt)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, chunk_ms, decode_ms


def quant_rows_differ(a, b) -> np.ndarray:
    """(slots,) bool: rows whose position, int8 KV codes or scales differ
    between two engines' caches, up to each row's frontier."""
    pos = a.caches[0].pos
    lmax = a.caches[0].k_codes.shape[2]
    live = (torch.arange(lmax, device=pos.device)[None, :]
            < pos[:, None].long())[:, None, :, None]
    differ = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    for ca, cb in zip(a.caches, b.caches):
        differ |= ca.pos != cb.pos
        for name in ("k_codes", "k_scale", "v_codes", "v_scale"):
            x, y = getattr(ca, name), getattr(cb, name)
            differ |= ((x != y) & live).flatten(1).any(1)
    return differ.cpu().numpy()


def drive_checked(eng, shadow, free, prompts, max_new, profile_at, quant):
    """Serve every prompt through kernel engine `eng` beside two reference
    engines. `shadow` is put in eng's state before each step, then takes
    the same step (lockstep): its tokens are the reference's choices from
    the very state the kernels saw. `free` serves the same requests on its
    own. With int8 KV, after each step the rows whose codes or scales first
    differ between eng and free are recorded: {rid: tokens the request had
    emitted before that step}. The steps in `profile_at` run under the
    profiler."""
    reqs = submit_all(eng, prompts, max_new)
    submit_all(shadow, prompts, max_new)
    submit_all(free, prompts, max_new)
    owner, first_diff, profiles = {}, {}, []
    step = 0
    while eng.pending():
        copy_state(shadow, eng)
        before = {r.rid: len(r.out_tokens) for r in reqs}
        if step in profile_at:
            profiles.append((step, profile_step(eng)))
        else:
            eng.step()
        shadow.step()
        free.step()
        owner.update({s: r for s, r in enumerate(eng._slot_req)
                      if r is not None})
        if quant:
            for s in np.flatnonzero(quant_rows_differ(eng, free)):
                rid = owner[int(s)].rid
                first_diff.setdefault(rid, before[rid])
        step += 1
    check(not shadow.pending() and not free.pending(),
          "a reference engine did not drain in step")
    return first_diff, profiles


def tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.finished}


def compare(label, got, ref, limit=None):
    """Tokens of the kernel engine vs the reference engine. Without
    `limit` (lockstep) every step is compared except near-ties (reference
    margin <= MARGIN); with it (free-running), each request is compared up
    to its first near-tie or limit[rid], whichever comes first: after
    either the two streams may rightly diverge. Returns (compared, skipped,
    first mismatch or None)."""
    compared = skipped = 0
    want = tokens(ref)
    for rid, ref_toks in sorted(want.items()):
        low = [i for i, m in enumerate(ref.margins[rid]) if m <= MARGIN]
        if limit is None:
            keep = [i for i in range(len(ref_toks)) if i not in low]
        else:
            keep = range(min(low[0] if low else len(ref_toks),
                             limit.get(rid, len(ref_toks))))
        skipped += len(ref_toks) - len(keep)
        for i in keep:
            if got[rid][i] != ref_toks[i]:
                return compared, skipped, (
                    f"{label}: request {rid} token {i}: {got[rid][i]} vs the "
                    f"reference's {ref_toks[i]} (margin "
                    f"{ref.margins[rid][i]:.3g})")
            compared += 1
    return compared, skipped, None


def engine_phase(dev, card):
    phase("5. engine: qwen2_1p5b CONFIG, 8 slots, max_len 2048, chunk 32")
    base = get_config("qwen2_1p5b")
    t0 = time.perf_counter()
    model = init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {base.name}: {base.n_layers} layers, d_model {base.d_model}, "
          f"{base.n_heads}/{base.n_kv_heads} heads, d_ff {base.d_ff}, vocab "
          f"{base.vocab}; {n_params / 1e9:.3f} B f32 params in "
          f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.RandomState(0)
    plens = [16, 1000, 137, 512, 64, 800, 300, 33]
    prompts = [rng.randint(1, base.vocab, n).astype(np.int32) for n in plens]
    max_new = 32
    # step 6: the 1000-token prompt admits while others decode; step 45:
    # every prompt is in, decode only
    profile_at = (6, 45)
    launches = {}
    for kv_quant in (False, True):
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        label = "int8-KV" if kv_quant else "dense bf16-KV"
        geo = dict(slots=8, max_len=LK, prefill_chunk=W)
        ref_policy = api.ExecutionPolicy(backend="ref")

        # the main path, free-running and alone on the card: launches,
        # tokens/s, step times and peak memory
        eng = ServingEngine(cfg, model, **geo)
        routes = (eng.decode_route(), eng.prefill_route())
        check(routes == ("cuda-decode", "cuda-prefill"),
              f"{label}: routes {routes}")
        eng.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNELS:
            k.launches = 0
        wall_s, chunk_ms, decode_ms = serve_timed(eng, prompts, max_new)
        counts = {k.__name__: k.launches for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        path = [n for n in counts if n.endswith("_quant") == kv_quant]
        launches.update({n: counts[n] for n in path})
        st = eng.stats
        check(all(counts[n] > 0 for n in path),
              f"{label}: a kernel of the path never launched: {counts}")
        n_tok = st.generated_tokens
        print(f"  [{label}] routes {routes}; launches {counts}; per step: "
              f"decode {counts[path[0]] / st.decode_steps:g}, prefill "
              f"{counts[path[1]] / st.prefill_chunk_calls:g}")
        print(f"  [{label}] free-running: {n_tok} tokens in {wall_s:.3f} s = "
              f"{n_tok / wall_s:.1f} tok/s; {len(chunk_ms)} chunk steps "
              f"(median {np.median(chunk_ms):.2f} ms), {len(decode_ms)} "
              f"decode-only steps (median {np.median(decode_ms):.2f} ms); "
              f"max_memory_allocated {peak / 2**30:.2f} GiB (weights, this "
              f"engine's caches and activations); {card}", flush=True)
        served = tokens(eng)
        del eng
        torch.cuda.empty_cache()

        # correctness: the same requests through a kernel engine beside a
        # lockstep and a free-running reference engine
        eng = ServingEngine(cfg, model, **geo)
        shadow = MarginEngine(cfg, model, policy=ref_policy, **geo)
        free = MarginEngine(cfg, model, policy=ref_policy, **geo)
        first_diff, profiles = drive_checked(eng, shadow, free, prompts,
                                             max_new, profile_at, kv_quant)
        for step, text in profiles:
            print(f"  [{label}] profile of step {step}: {text}", flush=True)
        got = tokens(eng)
        check(got == served, f"{label}: the checked pass's tokens differ "
              "from the free-running pass's")
        compared, skipped, bad = compare(label, got, shadow)
        check(bad is None, f"lockstep: {bad}")
        print(f"  [{label}] lockstep vs the ref engine: {compared} tokens "
              f"match, {skipped} near-tie step(s) skipped", flush=True)
        compared, skipped, bad = compare(label, got, free, limit=first_diff)
        check(bad is None, f"free-running: {bad}")
        tie = sum(any(m <= MARGIN for m in ms) for ms in free.margins.values())
        text = (f"{compared} tokens match, {skipped} not compared; "
                f"{tie} request(s) reach a margin <= {MARGIN}")
        if kv_quant:
            text += (f", {len(first_diff)} reach a step where the two "
                     f"engines' int8 codes or scales differ (tokens "
                     f"before it: {sorted(first_diff.values())})")
        print(f"  [{label}] free-running vs the ref engine: {text}",
              flush=True)
        del eng, shadow, free
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    dev_info = device_phase()
    if dev_info is None:
        return 2
    name, count, smi = dev_info
    dev = torch.device("cuda")
    build_phase()
    errs = kernel_phase(dev)
    times = timing_phase(dev)
    launches = engine_phase(dev, smi)
    phase("6. summary")
    kernels = []
    for kname in (k.__name__ for k in KERNELS):
        source, replaces = KERNEL_META[kname]
        kernels.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=launches[kname],
                            max_abs_err=errs[kname], **times[kname]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
