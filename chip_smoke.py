#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100); exits non-zero without one. Imports nothing
of JAX or of the JAX package `repro`. Phases:

1. Device: the card's name, count, and `nvidia-smi` name and power limit.
2. Build: nvcc-builds every kernel source for sm_90a (one process per
   source, in parallel) and prints each kernel's `-Xptxas -v` report.
3. Kernel vs plain, on the card, each kernel against its plain PyTorch
   version. Attention (flash-decode and varlen flash-prefill, dense and
   int8-KV) at the serving shapes of qwen2-1.5B (B=8, Hq=12, Hkv=2, D=128,
   Lk=2048) and on a small windowed, softcapped GQA case: max |diff| <=
   1e-4 (atol and rtol; f32 summed in another order), prefill pad rows
   exactly 0, fused int8 bitwise equal to the kernel on the dequantized
   K/V. The varlen prefill also on rows near the end of a 4096-key cache
   (16 key splits), with and without a window of 300 and softcap 30, bf16,
   f32 and int8 K/V (1e-4, pad rows 0, fused int8 bitwise), and one query
   sent alone, in a 5-token and in a 32-token chunk at two indices beside
   other rows: bitwise the same output each time. The AIO GEMM in all
   five modes at every Linear shape of qwen2-1.5B, (K, N) in {(1536,
   1536), (1536, 256), (1536, 8960), (8960, 1536)}, at M = 8 (decode) and
   256 (chunk), plus a ragged case
   (M=7, K=131, N=40; odd-K int4): int8/int4 bitwise, bf16/fp8a/fp8b
   within rtol 2e-5, atol 2e-5 * max|plain|. The AIO quantizer in
   fp8a/fp8b/int8/int4 at M in {8, 256}, N in {1536, 8960}, with both
   floors (1e-30, FLT_MIN), on random rows whose first seven are the
   edge rows of `quant_edge_rows` (all zero; max |x| between the floors;
   +-max_finite, so the scale is exactly 1, then every RNE tie of the
   grid, also at scales 2^-20 and 2^12; +-inf and values past
   max_finite, which saturate; a NaN): codes and scales bitwise, at the
   launch `quant_plan` takes and at each cluster size (1, 2, 4 and 8 blocks
   a row, `plan_with`'s threads and values a thread). A plain quantizer
   that rounds half away from zero (C's roundf) must give other codes on
   every row with ties.
   Paged attention (the same four kernels read through a block table:
   flash_decode_paged, flash_decode_paged_quant, flash_prefill_paged,
   flash_prefill_paged_quant) at the same serving shapes, the cache
   scattered into a pool by a shuffled table (unused pool blocks hold NaN,
   so a misaddressed read shows), at block sizes 16, 32 and 128: each
   kernel within 1e-4 of its plain version (gather the pages, then the flat
   plain version) and bitwise equal to the flat kernel on the un-paged
   cache, at ragged positions (0, 37, the full cache) and lengths (a full
   chunk, 3, 0); prefill pad rows exactly 0; fused int8 bitwise equal to
   the paged kernel on the dequantized pool.
3d. The full-sequence flash kernel (B8) on the reference's six cases
   (tests/test_kernels.py), a non-causal case, bf16 K/V and GQA group 6
   (Hq 12, Hkv 2, D 128): max |diff| <= 1e-4 and no NaN; all-bf16 within
   one bf16 ulp + 1e-4. The grouped GEMM (B9) on ragged tenants packed at
   bm = bk = bn in {128, 64, 16}, f32 and bf16, with and without each
   tenant's (K, N): max |kernel - plain| <= 1e-5 * max |plain|, and with
   them the padded output columns exactly 0. The depthwise conv (B11) at
   1x1, 3x3, 5x5, 7x7 and 9x9 and at 3x5 and 7x1, odd H and W, C = 3, 24,
   40, 130, 576, f32 and bf16: bitwise.
4. Timing: CUDA-event time per launch of each kernel, its plain version and
   one PyTorch library call computing the same function (timed only here),
   beside the least time the card could take: the larger of the bytes the
   call must move over 3.35 TB/s and its operations over the card's rate
   for their type (f32 outside the tensor cores 67 TFLOP/s; bf16 989
   TFLOP/s, which the fp8 GEMM modes run at, decoded to bf16; int8 1,979
   TOPS, which int4 runs at, unpacked to int8). Attention: the serving
   shapes, against scaled_dot_product_attention with an explicit boolean
   mask. Each kernel's bound counts the instructions it runs: the decode
   kernels' f32 FMA, the prefill kernels' bf16 MMAs (3 a product for bf16
   K/V, 6 for f32 or int8 on three-term operands), their f32 bound
   printed beside; the decode lines also give the launch's key splits and
   how many of its blocks are live at the rows' positions. AIO GEMM: each
   mode at M = 8 and 256 of every Linear shape of qwen2-1.5B ((K, N) =
   (1536, 1536) q/o, (1536, 256) k/v, (1536, 8960) gate/up, (8960, 1536)
   down), against torch.matmul on operands decoded to
   bf16 beforehand and, where its shape rules allow (M = 256), torch._int_mm
   on int8 operands. AIO quantizer: each format at M = 8 and 256 of
   N = 1536 and 8960 (eight input copies: at M = 8 they lie in the L2, as
   a step's activations do), beside the plan it takes and the launch
   floor (back-to-back `torch.cuda._sleep(0)` launches, timed the same
   way); no single library call computes it. Paged attention
   at block size 16 beside the flat kernel on the same data (the cost of
   the address indirection); its bound adds the table entries the rows
   read; no single library call reads through a block table. Attention
   and GEMM inputs rotate over enough copies to exceed the 50 MB L2, as 28
   layers' caches and weights do on the serving path.
4d. B8 at B 4, Hq 12, Hkv 2, D 128, L 2048, causal, f32: held against
   its plain version there (max |diff| <= 1e-4, no NaN), then timed
   against SDPA (K/V expanded to Hq beforehand), bound by its own
   instruction mix (6 bf16 MMAs a product on three-term operands at 989
   TFLOP/s), its f32 bound (67 TFLOP/s) printed beside.
   B9 on the tenant mixes of examples/morphable_inference.py and
   qwen2-1.5B's q projection (256, 1536, 1536) beside llama2-7B's (128,
   4096, 4096), launched as morphable_multi_gemm launches it (the packed
   operands with each tenant's (K, N), so the padding is skipped), against
   one torch.matmul per tenant (TF32 off); bound by max(bytes / 3.35 TB/s,
   2 M K N / 67 TFLOP/s) of the tenants' useful work (the summary's
   bound), printed beside the same bound of the packed launch. B11
   at MobileNetV2 (8,56,56,144) and (8,14,14,576) 3x3 and ConvNeXt-S
   (8,56,56,96) and (8,14,14,384) 7x7, against conv2d(groups=C); bound by
   the larger of its bytes over 3.35 TB/s and its unfused f32
   instructions (a multiply and an add a tap: the bitwise order forbids
   FMA) over 33.5 T a second, the rate 67 TFLOP/s counts as FMAs.
5. Engine: ServingEngine on the full-width qwen2_1p5b CONFIG (random f32
   weights, seed 0), 8 slots, max_len 2048, prefill chunk 32, 8 requests
   with prompts of 16..1000 tokens and 32 new tokens each — dense bf16-KV,
   int8-KV, and bf16-KV with the Linear weights resident in int4 and in
   fp8a (converted in place by `quantize_params`, as the serve launcher
   does: the quantizer and the AIO GEMM run on every Linear). A
   free-running pass of the kernel engine alone gives the launch counts
   (every kernel of the path must have launched), tokens/s, step times
   and peak memory; routes must be cuda-decode / cuda-prefill
   (and resident-<fmt>). A second pass serves the same requests beside two
   comparison engines on the card. For dense and int8-KV they run the
   backend="ref" route; for the resident variants they compute the same
   function with the plain versions of the quantizer and the GEMM in
   place of their kernels (attention on its kernels). The second pass's
   tokens must equal the first pass's, match the lockstep comparison
   engine (put in the kernel engine's state before each step) at every
   step but near-ties (top-1/top-2 logit margin <= 1e-3), and match the
   free-running comparison engine up to
   each request's first near-tie or first step where the two engines'
   int8 KV codes (int8-KV) or activation codes (resident) differ in its
   row (after either the streams may rightly diverge). In the resident
   lockstep, every activation row whose float input is bitwise equal in
   the two engines (at least the first Linears of every step) must get
   bitwise equal codes and scale from the plain quantizer and the kernel;
   the lockstep GEMMs then take the kernel engine's codes, so the two
   differ only by their float32 sums.
5b. Paged engine: ServingEngine(paged=True, block_size=16) on the same
   full-width model, 8 slots, max_len 2048, chunk 32, serving 16 requests
   that share a 300-token prompt head (18 full blocks and 12 tokens, so the
   boundary block forks) with tails of 16, 700, 137, 212, 64, 500, 3 and
   33 tokens, each length twice, 32 new tokens each: (a) bf16 KV, default
   pool; (b) int8 KV; (c) bf16 KV with a 160-block pool, which forces
   deferral and LRU eviction. Each beside the flat kernel engine on the
   same mix: every request's tokens must be equal; prefix hits, shared
   tokens and copy-on-write forks must be > 0 in (a) and (b), deferrals
   and evictions > 0 in (c); the paged kernels of the path must launch and
   the flat attention kernels must not during a paged pass. Reports
   tokens/s, step medians, peak memory, launches per step and pool_stats().
5c. Robustness on the card, the qwen2_1p5b CONFIG at full width and depth
   (phase 5's weights), each case against the tokens phases 5 and 5b
   computed: (1) preemption: 5b's mix with priorities alternating 0/1 by
   request id on a paged engine of 160 blocks (smaller if that preempts
   nothing) and swap_watermark 0.9, bf16 and int8 KV: every request's
   tokens equal 5b's bitwise, preemptions, swap-outs and swap-ins >= 1,
   bytes swapped in == out > 0, the host store empty when drained; (2)
   quarantine: phase 5's mix on the flat engine under a NaN logits poison,
   a +inf KV poison, a latency fault and a malformed submission
   (drive_with_plan), then int8 KV under a NaN K-scale poison: tokens
   equal phase 5's, one quarantine a poison, none failed or demoted, the
   malformed request rejected; (3) demotion: a launch fault at step 0 at
   the launch and at the dispatch boundary: one demotion each,
   cuda-decode/cuda-prefill -> ref/ref, tokens equal phase 5's
   free-running ref engine's; (4) snapshot/restore into a fresh engine
   mid-stream (flat: rows mid-prefill and mid-decode; paged: case 1 with a
   row PREEMPTED): the tokens equal the earlier phase's; (5) weight poison
   on the int4-resident engine after a snapshot with the weights at step
   2: every request FAILED, then the restore's tokens equal phase 5's int4
   free pass. Snapshots go under build/snapshots and are deleted. Prints
   each case's wall time, counters and pool_stats().
5d. The other families, each as a phase-5 variant (bf16 KV, random f32
   weights from seed 0, chunk 32; the free-running kernel engine, then the
   checked pass beside a lockstep and a free-running ref-route engine):
   olmoe_1b_7b CONFIG at full width and depth (16 MoE layers, d_model
   2048, 64 experts top 8 at d_ff 1024, vocab 50304; 6.9 B parameters) on
   phase 5's mix and geometry, one decode-only step profiled beside the
   experts' byte bound, each step width's expert capacity and the first
   launch's dropped assignments printed; gemma2_27b CONFIG at full width
   over 4 layers (2 local/global pairs, window 4096, softcaps 50 / 30,
   head_dim 128, GQA group 2; 3.45 B parameters), 4 slots, max_len 6144,
   prompts of 4600, 4200, 700 and 90 tokens (two past the window), one
   chunk step profiled; gpt2_small and olmo_1b CONFIG at full width and
   depth and internlm2_20b CONFIG at full width over 4 layers, 4 slots,
   max_len 2048, 4 requests each. The MoE variant's comparison engines
   follow the kernel engine's expert dispatch in lockstep (a top-k choice
   or a capacity cut flips at a tie, and a chunk's pad rows, which the
   routes give other values, compete for capacity); the ref route's own
   choice of experts may differ on at most 1% of valid token-layers.
   kimi_k2 is not run on the card (one MoE layer at full width is 16.9 B
   parameters, 67 GB in f32). Prints the phase's wall time.
6. Full-sequence path: the qwen2_1p5b CONFIG at full width and depth
   (phase 5's weights, seed 0), 4 random prompts of 1,920 tokens:
   `forward`, `launch.steps.make_prefill_step` and `loss_fn` (labels the
   next token) on the kernel route and on the ref route. B8 must launch
   exactly 28 times per forward and no other kernel; max |dlogit| <= 1e-3 *
   max |logit|, greedy tokens equal, loss within 1e-4 (relative). The same
   prompts through the serving engine (chunked prefill through the varlen
   prefill kernel, f32 caches so it computes the forward's function): its
   first tokens must equal make_prefill_step's. Prints the forward's wall
   ms, prompt tokens/s, peak memory and one profiled forward.
7. Morphable ops: api.ops.morphable_multi_gemm on each 4d mix (one grouped
   launch each; every tenant within 1e-5 of its plain product; the MAC
   utilization equal to the plain packing's) and api.ops.depthwise_conv on
   a MobileNetV2 block (one launch, bitwise).
8. Summary: no engine of any phase demoted but phase 5c's two injected
   faults (every demotion warns; the script records the warnings), a
   `{"kernels": [...]}` line (13 kernel entry points), the script's wall
   time, then as the last line `{"ok": true, "device": {...}}`. Any failed
   check exits non-zero before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import formats as FM  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.aio_matmul import (MODES, aio_matmul,  # noqa: E402
                                            aio_matmul_plain,
                                            quantize_operands_ref)
from repro_torch.kernels.aio_quant import (KERNEL_FLOOR,  # noqa: E402
                                           aio_quant, aio_quant_plain,
                                           quant_edge_rows)
from repro_torch.kernels.aio_quant import ops as quant_ops  # noqa: E402
from repro_torch.kernels.aio_quant.ops import (  # noqa: E402
    CLUSTER_SIZES, plan_with, quant_plan)
from repro_torch.kernels.depthwise import (depthwise_conv,  # noqa: E402
                                           depthwise_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNELS, PAGED_KERNELS, flash_attention, flash_attention_plain,
    flash_decode, flash_decode_paged,
    flash_decode_paged_plain, flash_decode_paged_quant,
    flash_decode_paged_quant_plain, flash_decode_plain, flash_decode_quant,
    flash_decode_quant_plain, flash_prefill, flash_prefill_paged,
    flash_prefill_paged_plain, flash_prefill_paged_quant,
    flash_prefill_paged_quant_plain, flash_prefill_plain,
    flash_prefill_quant, flash_prefill_quant_plain)
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    decode_plan)
from repro_torch.kernels.flash_attention.shared import dequant  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, grouped_matmul_plain, make_group_ids, pack_tenants)
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import (forward, init_caches,  # noqa: E402
                                init_params, loss_fn, quantize_params)
from repro_torch.models.attention import _q8  # noqa: E402
from repro_torch.models.moe import MoE, expert_capacity  # noqa: E402
from repro_torch.serving import (FaultPlan, Request,  # noqa: E402
                                 ServingEngine, drive_with_plan)
from repro_torch.serving.faults import Fault  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
F32_INSTR_PER_S = F32_FLOPS_PER_S / 2  # f32 instructions; an FMA is 2 flops
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12           # H100 SXM int8 tensor cores, dense
SPIN_CYCLES = 100_000_000        # ~50 ms at the H100's ~2 GHz SM clock
TOL = 1e-4
GEMM_TOL = 2e-5                    # rtol, and atol * max|plain|
MARGIN = 1e-3

# serving shapes of qwen2-1.5B
B, HQ, HKV, D, LK, W = 8, 12, 2, 128, 2048, 32
DECODE_POS = [0, 127, 128, 1000, LK - 1 - 1, 500, 1500, 64]
PREFILL_POS = [0, 127, 128, 1000, LK - 1 - W, 300, 1700, 64]
PREFILL_LEN = [W, 1, 17, 0, W, 5, W, 20]

# Linear shapes (K, N) of qwen2-1.5B: q/o, k/v, gate/up, down
GEMM_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
GEMM_M = (8, 256)                  # decode and chunk widths (8 slots x 32)
QUANT_FORMATS = ("fp8a", "fp8b", "int8", "int4")
RESIDENT = ("int4", "fp8a")        # the resident engine variants
AIO_KERNELS = (aio_matmul, aio_quant)
# the kernels of the full-sequence path (B8) and of the morphable ops (B9,
# B11)
FULL_KERNELS = (flash_attention, grouped_matmul, depthwise_conv)
ALL_KERNELS = (*KERNELS, *PAGED_KERNELS, *AIO_KERNELS, *FULL_KERNELS)

# full-sequence attention, timed at qwen2-1.5B's heads over 4 x 2048 tokens
FULL_B, FULL_L = 4, 2048
# phase 6: 4 prompts of 1,920 tokens (15 x 128), qwen2-1.5B at full width
SEQ_B, SEQ_L = 4, 1920
LOGIT_TOL = 1e-3                   # max |dlogit| <= 1e-3 * max |logit|
LOSS_TOL = 1e-4                    # relative
# grouped GEMM tenant mixes (M, K, N): examples/morphable_inference.py's,
# and qwen2-1.5B's q projection at a 256-token chunk beside llama2-7B's at
# 128 tokens
MIXES = {
    "one big GEMM": [(1024, 1024, 1024)],
    "two wide GEMMs (Fig 3)": [(128, 512, 2048), (128, 512, 1536)],
    "four small tenants": [(100, 64, 96), (60, 128, 64), (200, 96, 128),
                           (50, 256, 80)],
    "qwen2-1.5B q + llama2-7B q": [(256, 1536, 1536), (128, 4096, 4096)],
}
SUMMARY_MIX = "qwen2-1.5B q + llama2-7B q"
# depthwise layers of the repo's vision workloads (N, H, W, C, k):
# MobileNetV2 3x3 and ConvNeXt-S 7x7 (src/repro/perfmodel/workloads.py)
DW_SHAPES = [(8, 56, 56, 144, 3), (8, 14, 14, 576, 3), (8, 56, 56, 96, 7),
             (8, 14, 14, 384, 7)]

# paged attention: block sizes held bitwise to the flat kernels, the one
# timed (the engine's default), ragged positions and lengths
PAGED_BS = (16, 32, 128)
PAGED_TIMED_BS = 16
PAGED_DECODE_POS = [0, 37, 128, 1000, LK - 1, 500, 1500, 64]
PAGED_PREFILL_POS = [0, 37, 128, 1000, LK - W, 300, 1700, 64]
PAGED_PREFILL_LEN = [W, 3, 17, 0, W, 5, W, 20]

KERNEL_META = {
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:321"),
    "flash_decode_quant": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_attention/decode.py:351"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention/prefill.py:364"),
    "flash_prefill_quant": ("src/repro_torch/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_attention/prefill.py:395"),
    "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_attention/decode.py:225"),
    "flash_decode_paged_quant": (
        "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:247"),
    "flash_prefill_paged": (
        "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_attention/prefill.py:255"),
    "flash_prefill_paged_quant": (
        "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_attention/prefill.py:275"),
    "aio_matmul": ("src/repro_torch/csrc/aio_matmul.cu",
                   "src/repro/kernels/aio_matmul/kernel.py:109"),
    "aio_quant": ("src/repro_torch/csrc/aio_quant.cu",
                  "src/repro/kernels/aio_quant/kernel.py:57"),
    "flash_attention": ("src/repro_torch/csrc/flash_full.cu",
                        "src/repro/kernels/flash_attention/kernel.py:92"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul/kernel.py:58"),
    "depthwise_conv": ("src/repro_torch/csrc/depthwise.cu",
                       "src/repro/kernels/depthwise/kernel.py:64"),
}


def check(cond, msg: str):
    """A failed check ends the run at once with a non-zero exit code."""
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def phase(title: str):
    print(f"\n=== {title}", flush=True)


def cuda_ms(fns, iters: int) -> float:
    """Mean CUDA-event milliseconds per call, cycling through `fns` (the
    same call on different input copies), after a warm-up. The timed calls
    are queued behind a ~50 ms device-side spin, so the card runs them back
    to back: the time is the device's, not the host's rate of launching
    them (a 15 us kernel behind ~50 us of Python per launch would
    otherwise time as 50 us)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
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


def attention_work(name, c, bs=None):
    """(bytes, f32 flops) of one attention launch on this run's inputs: the
    K/V positions the rows need, read once; valid q rows in, the output
    out; paged, with block size bs, also the table entries that map those
    positions; and 4 D flops a kept (query, key) pair and head."""
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
    if bs is not None:
        nbytes += 4 * sum(-(-(p + n) // bs) for p, n in zip(pos, lens)
                          if n > 0)
    return nbytes, pairs * hq * d * 4


def bound(name, c, bs=None):
    """Least time (ms) for this run's inputs, and what sets it: the bytes
    that must move over the memory rate, or the f32 flops of the kept
    (query, key) pairs over the f32 rate."""
    nbytes, flops = attention_work(name, c, bs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mma_bound(name, c, bs=None):
    """Least time (ms) of the same work at the prefill kernel's own
    instruction mix: each f32 product as bf16 tensor-core MMAs on operands
    split into three bf16 terms, 3 MMAs for bf16 K/V and 6 for f32 or int8
    (dequantized to f32) K/V, over the bf16 tensor rate; or the bytes, if
    they take longer. And what sets it."""
    nbytes, flops = attention_work(name, c, bs)
    kv = c["k"] if bs is None else c["pk"]
    mmas = 3 if kv.dtype == torch.bfloat16 and "_quant" not in name else 6
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops * mmas / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def row_bound(name, c, bs=None):
    """The bound of an attention kernel's row in the kernels line: at the
    instructions it runs, the prefill kernels' bf16 MMAs (`mma_bound`),
    the decode kernels' f32 FMA (`bound`)."""
    return (bound if "decode" in name else mma_bound)(name, c, bs)


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
    prefill_split_checks(dev)
    return errs


def prefill_split_checks(dev):
    """The varlen prefill over many key splits, and a query's output
    independent of the chunk it arrives in."""
    lk, w = 4096, W
    c = make_case(dev, 7, b=4, hq=HQ, hkv=HKV, lq=w, lk=lk,
                  pos=[lk - w, 4000, 2500, 0], lens=[w, 7, w, 0])
    f32 = (c["k"].float(), c["v"].float())
    quant = (c["kc"], c["ks"], c["vc"], c["vs"])
    deq = (dequant(c["kc"], c["ks"], torch.float32),
           dequant(c["vc"], c["vs"], torch.float32))
    pad = torch.arange(w, device=dev)[None, :] >= c["lens"][:, None]
    for kw in ({}, dict(window=300, softcap=30.0)):
        kw = dict(kw, pos=c["pos"], lengths=c["lens"])
        for label, got, want in (
                ("bf16", flash_prefill(c["q"], c["k"], c["v"], **kw),
                 flash_prefill_plain(c["q"], c["k"], c["v"], **kw)),
                ("f32", flash_prefill(c["q"], *f32, **kw),
                 flash_prefill_plain(c["q"], *f32, **kw)),
                ("int8", flash_prefill_quant(c["q"], *quant, **kw),
                 flash_prefill_quant_plain(c["q"], *quant, **kw))):
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            zero = not got.transpose(1, 2)[pad].any().item()
            how = "window 300 softcap 30" if "window" in kw else "no window"
            line = (f"  flash_prefill {label:5s} Lk 4096, rows at 4064 / "
                    f"4000 / 2500, {how:21s} max|diff| {err:.3e}  pad rows "
                    f"zero: {zero}")
            check(err <= TOL, f"prefill {label} Lk 4096 {kw}: max |diff| "
                  f"{err} above {TOL}")
            check(zero, f"prefill {label} Lk 4096: pad rows not exactly 0")
            if label == "int8":
                same = torch.equal(got, flash_prefill(c["q"], *deq, **kw))
                line += f"  fused == dequantized: {same}"
                check(same, "prefill int8 Lk 4096: fused int8 differs from "
                      "the kernel on dequantized K/V")
            print(line, flush=True)
    # one query (row 1, position 3000) sent alone, in a 5-token chunk and in
    # a 32-token chunk at two indices, beside other rows
    g = torch.Generator(device=dev).manual_seed(8)
    target = torch.randn(HQ, D, generator=g, device=dev) * 0.5
    outs = []
    for wq, idx, other in ((1, 0, (0, 1)), (5, 2, (100, 5)),
                           (32, 31, (4000, 32)), (32, 0, (10, 3))):
        q = torch.randn(4, wq, HQ, D, generator=g, device=dev) * 0.5
        q[1, idx] = target
        pos = torch.tensor([other[0], 3000 - idx, 2000, 7], dtype=torch.int32,
                           device=dev)
        lens = torch.tensor([min(other[1], wq), wq, min(3, wq), 0],
                            dtype=torch.int32, device=dev)
        for fn, kv in ((flash_prefill, (c["k"], c["v"])),
                       (flash_prefill_quant, quant)):
            out = fn(q.transpose(1, 2), *kv, pos=pos, lengths=lens)
            outs.append((fn.__name__, out[1, :, idx]))
    same = all(torch.equal(o, outs[i % 2][1])
               for i, (_, o) in enumerate(outs))
    print(f"  flash_prefill / _quant: one query alone, in 5- and 32-token "
          f"chunks beside other rows: bitwise equal {same}", flush=True)
    check(same, "prefill: a query's output depends on the chunk it "
          "arrived in")


def paged_case(dev, c, bs, seed):
    """Case c with its caches (bf16 K/V; int8 codes and scales) scattered
    into pools of block size bs by a shuffled table (pk, pv, pkc, pks, pvc,
    pvs; table). 64 pool blocks that no table names hold NaN (codes 127
    with a NaN scale): a read through a wrong address shows."""
    b, hkv, lk, _ = c["k"].shape
    nblk = lk // bs
    g = torch.Generator().manual_seed(seed)
    n_pool = b * nblk + 64
    table = torch.randperm(n_pool, generator=g)[: b * nblk].reshape(b, nblk)
    out = dict(c, table=table.to(device=dev, dtype=torch.int32))
    for name in ("k", "v", "kc", "ks", "vc", "vs"):
        a = c[name]
        x = a.shape[-1]
        blocks = a.reshape(b, hkv, nblk, bs, x).transpose(1, 2) \
            .reshape(-1, hkv, bs, x)
        fill = 127 if a.dtype == torch.int8 else float("nan")
        pool = torch.full((n_pool, hkv, bs, x), fill, dtype=a.dtype,
                          device=dev)
        pool[table.reshape(-1).to(dev)] = blocks
        out["p" + name] = pool
    return out


def paged_calls(name, c, kw):
    """(paged kernel call, its plain version, the flat kernel on the
    un-paged cache, the paged kernel on the dequantized pool or None) of
    one paged kernel on paged case c."""
    q, pos, t = c["q"], c["pos"], c["table"]
    if "prefill" in name:
        kw = dict(kw, lengths=c["lens"])
    if name == "flash_decode_paged":
        pools = (c["pk"], c["pv"])
        return (lambda: flash_decode_paged(q, *pools, table=t, pos=pos, **kw),
                lambda: flash_decode_paged_plain(q, *pools, table=t, pos=pos,
                                                 **kw),
                lambda: flash_decode(q, c["k"], c["v"], pos=pos, **kw), None)
    if name == "flash_prefill_paged":
        pools = (c["pk"], c["pv"])
        return (lambda: flash_prefill_paged(q, *pools, table=t, pos=pos,
                                            **kw),
                lambda: flash_prefill_paged_plain(q, *pools, table=t,
                                                  pos=pos, **kw),
                lambda: flash_prefill(q, c["k"], c["v"], pos=pos, **kw), None)
    pools = (c["pkc"], c["pks"], c["pvc"], c["pvs"])
    flat = (c["kc"], c["ks"], c["vc"], c["vs"])
    deq = (dequant(c["pkc"], c["pks"], q.dtype),
           dequant(c["pvc"], c["pvs"], q.dtype))
    if name == "flash_decode_paged_quant":
        return (lambda: flash_decode_paged_quant(q, *pools, table=t, pos=pos,
                                                 **kw),
                lambda: flash_decode_paged_quant_plain(q, *pools, table=t,
                                                       pos=pos, **kw),
                lambda: flash_decode_quant(q, *flat, pos=pos, **kw),
                lambda: flash_decode_paged(q, *deq, table=t, pos=pos, **kw))
    return (lambda: flash_prefill_paged_quant(q, *pools, table=t, pos=pos,
                                              **kw),
            lambda: flash_prefill_paged_quant_plain(q, *pools, table=t,
                                                    pos=pos, **kw),
            lambda: flash_prefill_quant(q, *flat, pos=pos, **kw),
            lambda: flash_prefill_paged(q, *deq, table=t, pos=pos, **kw))


def paged_kernel_phase(dev):
    phase("3c. paged attention vs plain (max |diff| <= 1e-4) and vs the "
          "flat kernel on the un-paged cache (bitwise), block sizes 16, 32, "
          "128; pad rows 0; int8 fused == paged kernel on the dequantized "
          "pool bitwise")
    flat = {"decode": make_case(dev, 5, b=B, hq=HQ, hkv=HKV, lq=1, lk=LK,
                                pos=PAGED_DECODE_POS),
            "prefill": make_case(dev, 6, b=B, hq=HQ, hkv=HKV, lq=W, lk=LK,
                                 pos=PAGED_PREFILL_POS,
                                 lens=PAGED_PREFILL_LEN)}
    errs = {}
    for bs in PAGED_BS:
        cases = {kind: paged_case(dev, c, bs, seed=bs)
                 for kind, c in flat.items()}
        for name in (k.__name__ for k in PAGED_KERNELS):
            c = cases["prefill" if "prefill" in name else "decode"]
            for label, kw in (("", {}), ("window48-softcap30",
                                         dict(window=48, softcap=30.0))):
                kern, plain, flat_kern, deq = paged_calls(name, c, kw)
                got, want, ref = kern(), plain(), flat_kern()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
                same = torch.equal(got, ref)
                line = (f"  {name:26s} bs {bs:3d} {label:18s} max|diff| "
                        f"{err:.3e}  == flat kernel: {same}")
                if "lens" in c:
                    pad = torch.arange(W, device=dev)[None, :] \
                        >= c["lens"][:, None]
                    zero = not got.transpose(1, 2)[pad].any().item()
                    line += f"  pad rows zero: {zero}"
                    check(zero, f"{name} bs {bs}: pad rows not exactly zero")
                if deq is not None:
                    fused = torch.equal(got, deq())
                    line += f"  fused == dequantized: {fused}"
                    check(fused, f"{name} bs {bs}: fused int8 differs from "
                          "the paged kernel on the dequantized pool")
                print(line, flush=True)
                check(ok, f"{name} bs {bs} {label}: max |diff| {err} above "
                      f"{TOL}")
                check(same, f"{name} bs {bs} {label}: not bitwise equal to "
                      "the flat kernel on the un-paged cache")
                errs[name] = max(errs.get(name, 0.0), err)
        del cases
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
        bound_ms, bound_by = row_bound(name, cases[0])
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"  {name:20s} kernel {ms:.4f}  plain {plain_ms:.4f}  "
              f"library {library_ms:.4f}  bound {bound_ms:.4f} ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it)"
              f"{mix_text(name, cases[0], ms)}", flush=True)
    return rows


def mix_text(name, c, ms, bs=None):
    """For a timing line, after its bound: the prefill kernels' bound at
    the f32 CUDA-core rate (the bound of their rows before the tensor-core
    design), the decode kernels' key splits and live blocks."""
    if "decode" in name:
        return decode_split_text(c)
    t, _ = bound(name, c, bs)
    return f"  f32 bound {t:.5f} ({100 * t / ms:.1f}% of it)"


def decode_split_text(c):
    """The decode launch's key splits on case c and how many of its blocks
    are live (hold keys a row needs; the rest exit at once)."""
    b, hq, lq, d = c["q"].shape
    hkv, lk = c["k"].shape[1], c["k"].shape[2]
    plan = decode_plan(b, hkv, hq // hkv, lq, lk, d)
    live = hkv * plan.grid[1] * sum(min(p + lq - 1, lk - 1) // plan.span + 1
                                    for p in c["pos"].tolist())
    return (f"  {plan.grid[2]} splits of {plan.span} keys, {live} of "
            f"{int(np.prod(plan.grid))} blocks live")


def paged_timing_phase(dev):
    phase(f"4c. paged attention timing at block size {PAGED_TIMED_BS} (ms "
          "per launch, CUDA events), beside the flat kernel on the same "
          "data")
    copies = {"decode": [], "prefill": []}
    for i in range(6):          # 6 x >= 8 MB of K/V per kernel: > 50 MB L2
        copies["decode"].append(paged_case(
            dev, make_case(dev, 30 + i, b=B, hq=HQ, hkv=HKV, lq=1, lk=LK,
                           pos=PAGED_DECODE_POS), PAGED_TIMED_BS, seed=i))
        copies["prefill"].append(paged_case(
            dev, make_case(dev, 40 + i, b=B, hq=HQ, hkv=HKV, lq=W, lk=LK,
                           pos=PAGED_PREFILL_POS, lens=PAGED_PREFILL_LEN),
            PAGED_TIMED_BS, seed=i))
    rows = {}
    for name in (k.__name__ for k in PAGED_KERNELS):
        cases = copies["prefill" if "prefill" in name else "decode"]
        fns = [paged_calls(name, c, {}) for c in cases]
        ms = cuda_ms([f[0] for f in fns], 60)
        flat_ms = cuda_ms([f[2] for f in fns], 60)
        plain_ms = cuda_ms([f[1] for f in fns], 12)
        bound_ms, bound_by = row_bound(name, cases[0], bs=PAGED_TIMED_BS)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"  {name:26s} kernel {ms:.4f}  flat kernel {flat_ms:.4f} "
              f"({100 * (ms / flat_ms - 1):+.1f}%)  plain {plain_ms:.4f}  "
              f"library none  bound {bound_ms:.5f} ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it)"
              f"{mix_text(name, cases[0], ms, PAGED_TIMED_BS)}", flush=True)
    return rows


# ------------------------------------------------- AIO GEMM and quantizer
def gemm_case(dev, mode, m, k, n, seed):
    """GEMM operands as a resident Linear hands them over: activations and
    weights quantized from random floats (x codes one per byte, w int4
    packed along K); bf16 operands without scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
    xq, wq, xs, ws = quantize_operands_ref(x, w, mode)
    if mode == "bf16":
        return xq, wq, None, None
    if mode == "int4":
        wq = FM.pack_int4(wq.t()).t().contiguous()
    return xq.to(torch.int8), wq.to(torch.int8), xs, ws


def quant_case(dev, fmt, m, n, seed):
    """Quantizer input: rows over many binades, the first seven replaced by
    `quant_edge_rows` (all zero; max |x| between the floors; every RNE tie
    of fmt's grid at scales 1, 2^-20 and 2^12; saturation and +-inf; a
    NaN)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, n, generator=g, device=dev) * torch.exp(
        4 * torch.randn(m, 1, generator=g, device=dev))
    edge = quant_edge_rows(fmt, n).to(dev)
    x[: len(edge)] = edge
    return x


@contextlib.contextmanager
def forced_quant_plan(plan):
    """Every quantizer launch in the block takes `plan` (None: its own)."""
    saved = quant_ops.quant_plan
    if plan is not None:
        quant_ops.quant_plan = lambda m, n: plan
    try:
        yield
    finally:
        quant_ops.quant_plan = saved


def quant_timing_copies(dev, m, n):
    """Eight random (M, N) quantizer inputs, the timed calls' rotation: at
    M = 8 they lie in the L2, as a step's activations do."""
    g = torch.Generator(device=dev).manual_seed(8)
    return [torch.randn(m, n, generator=g, device=dev) for _ in range(8)]


def launch_floor_ms():
    """The launch floor: ms a launch of back-to-back minimal kernels
    (`torch.cuda._sleep(0)`), timed as the kernels are."""
    return cuda_ms([functools.partial(torch.cuda._sleep, 0)], 200)


@contextlib.contextmanager
def round_half_away():
    """torch.round rounding half away from zero (C's roundf) inside the
    block: a deliberately wrong plain quantizer the edge rows must
    catch."""
    saved = torch.round
    torch.round = lambda t: torch.sign(t) * torch.floor(t.abs() + 0.5)
    try:
        yield
    finally:
        torch.round = saved


def aio_kernel_phase(dev):
    phase("3b. AIO GEMM vs plain (int modes bitwise, float modes rtol 2e-5, "
          "atol 2e-5 * max|plain|) and AIO quantizer vs plain (bitwise)")
    cases = [(m, k, n) for k, n in GEMM_SHAPES for m in GEMM_M]
    cases.append((7, 131, 40))
    errs = {}
    for mode in MODES:
        worst = 0.0
        for i, (m, k, n) in enumerate(cases):
            x, w, xs, ws = gemm_case(dev, mode, m, k, n, seed=100 + i)
            got = aio_matmul(x, w, xs, ws, mode=mode)
            want = aio_matmul_plain(x, w, xs, ws, mode=mode)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if mode in ("int8", "int4"):
                ok = torch.equal(got, want)
            else:
                ok = torch.allclose(got, want, rtol=GEMM_TOL,
                                    atol=GEMM_TOL * want.abs().max().item())
            check(ok, f"aio_matmul {mode} M={m} K={k} N={n}: max |diff| "
                  f"{err} (bitwise for int modes)")
            worst = max(worst, err)
        errs["aio_matmul"] = max(errs.get("aio_matmul", 0.0), worst)
        print(f"  aio_matmul {mode:5s} {len(cases)} shapes (M, K, N) "
              f"{cases}: max|diff| {worst:.3e}", flush=True)
    for fmt in QUANT_FORMATS:
        n_cases = 0
        for floor in (KERNEL_FLOOR, FM.FLT_MIN):
            for m in GEMM_M:
                for n in (1536, 8960):
                    x = quant_case(dev, fmt, m, n, seed=m + n)
                    want_codes, want_scale = aio_quant_plain(
                        x, fmt_name=fmt, floor=floor)
                    with round_half_away():
                        away_codes, _ = aio_quant_plain(
                            x, fmt_name=fmt, floor=floor)
                    # the plan's own launch, then every cluster size
                    plans = [None] + [plan_with(n, c) for c in CLUSTER_SIZES]
                    for plan in plans:
                        with forced_quant_plan(plan):
                            codes, scale = aio_quant(x, fmt_name=fmt,
                                                     floor=floor)
                        torch.cuda.synchronize()
                        check(torch.equal(codes, want_codes)
                              and torch.equal(scale, want_scale),
                              f"aio_quant {fmt} floor {floor} M={m} N={n} "
                              f"plan {plan or quant_plan(m, n)}: codes or "
                              "scales differ from the plain version")
                        n_cases += 1
                    caught = (away_codes != codes)[2:7].any(1).all().item()
                    check(caught, f"aio_quant {fmt} M={m} N={n}: a plain "
                          "quantizer rounding half away from zero matched "
                          "the kernel on a row of ties")
        print(f"  aio_quant  {fmt:5s} {n_cases} cases (floors 1e-30 and "
              "FLT_MIN, M 8/256, N 1536/8960, edge rows; the plan's own "
              "launch and clusters of 1, 2, 4 and 8): codes and scales "
              "bitwise equal; the round-half-away plain variant differs on "
              "every row of ties", flush=True)
    errs["aio_quant"] = 0.0
    return errs


def gemm_bound(mode, m, k, n):
    """Least time (ms) of one GEMM call and what sets it: each input read
    once (codes, scales), the f32 output written once, over the memory
    rate; or 2 M N K operations over the tensor-core rate the mode runs at
    (int8 for int8/int4, bf16 for bf16/fp8)."""
    xb = m * k * (2 if mode == "bf16" else 1)
    wb = (k + 1) // 2 * n if mode == "int4" else k * n * (
        2 if mode == "bf16" else 1)
    nbytes = xb + wb + (0 if mode == "bf16" else 4 * (m + n)) + 4 * m * n
    rate = INT8_OPS_PER_S if mode in ("int8", "int4") else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gemm_timing_copies(dev, mode, m, k, n):
    """Random operands in bulk on the card (every code is a finite value),
    as many copies as it takes to put 100 MB of weights past the L2."""
    g = torch.Generator(device=dev).manual_seed(7)
    wrows = (k + 1) // 2 if mode == "int4" else k
    wbytes = wrows * n * (2 if mode == "bf16" else 1)
    out = []
    for _ in range(max(2, -(-100_000_000 // wbytes))):
        if mode == "bf16":
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            w = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
            out.append((x, w, None, None))
            continue
        lo = -8 if mode == "int4" else -128
        x = torch.randint(lo, -lo, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (wrows, n), generator=g, device=dev,
                          dtype=torch.int8)
        out.append((x, w, torch.full((m, 1), 2.0 ** -7, device=dev),
                    torch.full((1, n), 2.0 ** -7, device=dev)))
    return out


def decoded_bf16(mode, x, w):
    """The operands of a GEMM call decoded to bf16 (exact), for the
    library yardstick."""
    if mode == "bf16":
        return x, w
    if mode in ("fp8a", "fp8b"):
        fmt = FM.REGISTRY[mode]
        return (FM.decode(x, fmt).to(torch.bfloat16),
                FM.decode(w, fmt).to(torch.bfloat16))
    k = x.shape[1]
    wv = FM.unpack_int4(w.t(), k=k).t() if mode == "int4" else w
    xv = (x.to(torch.int32) << 28) >> 28 if mode == "int4" else x
    return xv.to(torch.bfloat16), wv.to(torch.bfloat16).contiguous()


def aio_timing_phase(dev):
    phase("4b. AIO GEMM and quantizer timing (ms per launch, CUDA events)")
    rows = {}
    for k, n in GEMM_SHAPES:
        for m in GEMM_M:
            for mode in MODES:
                copies = gemm_timing_copies(dev, mode, m, k, n)
                kern = [functools.partial(aio_matmul, *c, mode=mode)
                        for c in copies]
                plain = [functools.partial(aio_matmul_plain, *c, mode=mode)
                         for c in copies]
                dec = [decoded_bf16(mode, c[0], c[1]) for c in copies]
                lib = [functools.partial(torch.matmul, *d) for d in dec]
                ms = cuda_ms(kern, 50)
                plain_ms = cuda_ms(plain, 6)
                lib_ms = cuda_ms(lib, 20)
                int_mm_ms = None
                if mode in ("int8", "int4") and m > 16:
                    ints = [(d[0].to(torch.int8), d[1].to(torch.int8))
                            for d in dec]
                    int_mm_ms = cuda_ms([functools.partial(torch._int_mm, *i)
                                         for i in ints], 20)
                bound_ms, bound_by = gemm_bound(mode, m, k, n)
                rows[(mode, m, k, n)] = dict(
                    ms=ms, plain_ms=plain_ms,
                    library_ms=int_mm_ms if int_mm_ms is not None else lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
                int_txt = "" if int_mm_ms is None else \
                    f"  _int_mm {int_mm_ms:.4f}"
                print(f"  aio_matmul {mode:5s} M={m:3d} K={k} N={n}: kernel "
                      f"{ms:.4f}  plain {plain_ms:.4f}  matmul(bf16) "
                      f"{lib_ms:.4f}{int_txt}  bound {bound_ms:.5f} "
                      f"({bound_by}; {100 * bound_ms / ms:.1f}% of it)",
                      flush=True)
                del copies, dec
    floor_ms = launch_floor_ms()
    print(f"  launch floor (back-to-back torch.cuda._sleep(0)): "
          f"{floor_ms:.4f} ms", flush=True)
    for n in (1536, 8960):
        for m in GEMM_M:
            xs = quant_timing_copies(dev, m, n)
            for fmt in QUANT_FORMATS:
                kern = [functools.partial(aio_quant, x, fmt_name=fmt,
                                          floor=FM.FLT_MIN) for x in xs]
                plain = [functools.partial(aio_quant_plain, x, fmt_name=fmt,
                                           floor=FM.FLT_MIN) for x in xs]
                ms = cuda_ms(kern, 50)
                plain_ms = cuda_ms(plain, 6)
                nbytes = m * n * 5 + 4 * m
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = 2 * m * n / F32_FLOPS_PER_S
                bound_ms = 1e3 * max(t_bytes, t_ops)
                bound_by = "bytes" if t_bytes >= t_ops else "operations"
                rows[(fmt, m, n)] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=None, bound_ms=bound_ms,
                                         bound_by=bound_by)
                p = quant_plan(m, n)
                print(f"  aio_quant  {fmt:5s} M={m:3d} N={n}: kernel "
                      f"{ms:.4f}  plain {plain_ms:.4f}  library none  bound "
                      f"{bound_ms:.5f} ({bound_by}; "
                      f"{100 * bound_ms / ms:.1f}% of it)  launch floor "
                      f"{floor_ms:.4f} (+{1e3 * (ms - floor_ms):.2f} us)  "
                      f"plan cluster {p.cluster} x {p.threads} threads x "
                      f"{p.vals} values", flush=True)
    # the summary line's shapes: the commonest launch of each on the main
    # path (int4 decode: gate/up GEMM; the quantizer on a d_model row)
    return {"aio_matmul": rows[("int4", 8, 1536, 8960)],
            "aio_quant": rows[("int4", 8, 1536)]}


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


def profiled(fn) -> str:
    """fn() once under torch.profiler: its wall time, the device time of
    what ran on the card (kernels, copies), the device's idle share, the
    host's kernel launches and the largest device items. Only events that
    ran on the device are summed: a CPU op's own device time is the time of
    the kernels it launched, which appear again as events of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - ts)
    avg = prof.key_averages()
    on_card = [e for e in avg if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in on_card) / 1e3
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    top = sorted(on_card, key=dev_us, reverse=True)[:4]
    busy_txt = (f"device busy {busy:.2f} ms, idle "
                f"{100 * (1 - busy / wall):.0f}%" if busy > 0
                else "device time not measured (no CUDA events)")
    # the port's GEMM and attention kernels summed over their template
    # instances
    ours = {}
    for e in on_card:
        for name in ("aio_mm_kernel", "aio_quant", "grouped_matmul_kernel",
                     "flash_prefill_kernel", "flash_decode_kernel"):
            if name in e.key:
                ms, n = ours.get(name, (0.0, 0))
                ours[name] = (ms + dev_us(e) / 1e3, n + e.count)
    ours_txt = "".join(f"; {k} in all {ms:.2f} ms x{n}"
                       for k, (ms, n) in ours.items())
    return (f"wall {wall:.2f} ms, {busy_txt}, {launches} host launches; top: "
            + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
                        for e in top) + ours_txt)


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


@contextlib.contextmanager
def registry_impl(op, impl, fn):
    """Put `fn` in the registry as (op, impl) inside the block. Only the
    comparison engines below use it, around their own steps."""
    key = (op, impl)
    saved = api.registry._impls[key]
    api.registry._impls[key] = fn
    try:
        yield
    finally:
        api.registry._impls[key] = saved


KERNEL_GEMM = (aio_quant, aio_matmul)
PLAIN_GEMM = (aio_quant_plain, aio_matmul_plain)


class CodeEngine(MarginEngine):
    """An engine whose resident Linears run `gemm` — (quantizer, GEMM): the
    kernels, or their plain versions — in place of the kernel route of
    `matmul_codes`, and which keeps its last step's activations, codes and
    scales (with each call's batch size) in `codes`.

    With `follow` (the lockstep engine), each call first holds its own
    quantizer's codes and scales to those `follow` made in the same call
    of its last step, on every row whose float input is bitwise equal in
    the two: `rows_same` counts those rows, `rows_bad` the ones among them
    whose codes or scale differ, and `first_differ` the rows of each
    step's first call whose inputs differ (none should: the step starts
    from the state copied from `follow`). Its GEMM then takes `follow`'s
    codes: the two engines differ only by their GEMMs' float32 sums,
    which a code flip at a rounding tie would otherwise amplify. The
    counters stay on the card until read."""

    def __init__(self, *args, gemm, follow=None, **kw):
        super().__init__(*args, **kw)
        self.gemm = gemm
        self.follow = follow
        self.codes = []
        zero = functools.partial(torch.zeros, (), dtype=torch.int64,
                                 device=self.device)
        self.rows_same, self.rows_bad, self.first_differ = (zero(), zero(),
                                                            zero())
        self.rows_seen = 0

    def step(self):
        self.codes = []
        return super().step()

    def _step_program(self, tokens, lengths):
        quant, matmul = self.gemm

        def impl(x, wq, *, policy):
            x2 = x.reshape(-1, wq.k).to(torch.float32).clone(
                memory_format=torch.contiguous_format)
            xq, xs = quant(x2, fmt_name=wq.fmt, floor=FM.FLT_MIN)
            self.codes.append((x.shape[0], x2, xq, xs))
            if self.follow is not None:
                _, fx, fq, fs = self.follow.codes[len(self.codes) - 1]
                check(fq.shape == xq.shape, "the lockstep engines' calls "
                      "differ")
                same = (x2.view(torch.int32) == fx.view(torch.int32)).all(1)
                differ = (xq != fq).any(1) | (xs != fs).any(1)
                self.rows_same += same.sum()
                self.rows_bad += (same & differ).sum()
                if len(self.codes) == 1:
                    self.first_differ += (~same).sum()
                self.rows_seen += x2.shape[0]
                xq, xs = fq, fs
            out = matmul(xq, wq.codes, xs, wq.scale, mode=wq.fmt)
            return out.reshape(*x.shape[:-1], out.shape[-1])

        with registry_impl("matmul_codes", "cuda", impl):
            return super()._step_program(tokens, lengths)


def code_rows_differ(a, b) -> np.ndarray:
    """(slots,) bool: rows whose activation codes or scales differed
    between two CodeEngines' last steps."""
    check(len(a.codes) == len(b.codes), "the engines made different calls")
    differ = torch.zeros(a.slots, dtype=torch.bool, device=a.device)
    for (rows, _, xa, sa), (_, _, xb, sb) in zip(a.codes, b.codes):
        d = (xa != xb).any(1) | (sa != sb).any(1)
        differ |= d.reshape(rows, -1).any(1)
    return differ.cpu().numpy()


@contextlib.contextmanager
def patched(owner, name, value):
    """`owner.name` set to `value` inside the block."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def token_routes(d):
    """A dispatch's experts (T, k) and keep mask (T, k), in token order."""
    keep = torch.empty_like(d.keep)
    keep[d.order] = d.keep
    return d.ids, keep.view(d.ids.shape)


class RouteEngine(MarginEngine):
    """An engine that keeps every MoE dispatch of its last step in
    `routes`, each with its launch's valid-token mask (T,) (pad positions
    and idle rows False), and every launch's dropped-assignment counts in
    `dropped` (per launch width, per layer; 0-d tensors on the card).

    With `follow` (the lockstep engine), each MoE call routes as `follow`
    did in the same call of its last step: a top-k choice or a capacity
    cut is a discrete decision that a 1e-6 difference can flip at a tie,
    and a chunk's pad rows, which the two attention routes give different
    values, compete for capacity. It still computes its own dispatch and
    counts, over valid tokens, those whose own experts (`ids_differ`) or
    own kept assignments (`keep_differ`) differ from the followed ones."""

    def __init__(self, *args, follow=None, **kw):
        super().__init__(*args, **kw)
        self.follow = follow
        self.routes, self.dropped = [], {}
        zero = functools.partial(torch.zeros, (), dtype=torch.int64,
                                 device=self.device)
        self.ids_differ, self.keep_differ, self.valid_seen = (zero(), zero(),
                                                              zero())

    def step(self):
        self.routes = []
        return super().step()

    def _step_program(self, tokens, lengths):
        width = tokens.shape[1]
        valid = (torch.arange(width, device=self.device)[None, :]
                 < lengths[:, None]).reshape(-1)
        own = MoE.dispatch

        def dispatch(mod, xt):
            d = own(mod, xt)
            if self.follow is not None:
                fd, _ = self.follow.routes[len(self.routes)]
                ids, keep = token_routes(d)
                fids, fkeep = token_routes(fd)
                self.ids_differ += ((ids != fids).any(1) & valid).sum()
                self.keep_differ += ((keep != fkeep).any(1) & valid).sum()
                self.valid_seen += valid.sum()
                d = fd
            self.routes.append((d, valid))
            self.dropped.setdefault(width, []).append(d.dropped)
            return d

        with patched(MoE, "dispatch", dispatch):
            return super()._step_program(tokens, lengths)


def route_rows_differ(a, b) -> np.ndarray:
    """(slots,) bool: rows with a valid token whose experts or kept
    assignments differed between two RouteEngines' last steps."""
    check(len(a.routes) == len(b.routes), "the engines made different "
          "MoE calls")
    differ = torch.zeros(a.slots, dtype=torch.bool, device=a.device)
    for (da, valid), (db, _) in zip(a.routes, b.routes):
        (ia, ka), (ib, kb) = token_routes(da), token_routes(db)
        tok = ((ia != ib) | (ka != kb)).any(1) & valid
        differ |= tok.view(a.slots, -1).any(1)
    return differ.cpu().numpy()


def report_routes(label, cfg, eng, shadow):
    """The MoE checks of a checked pass: each step width's expert
    capacity, the first chunk launch's dropped assignments, and how often
    the lockstep comparison engine's own dispatch differed from the kernel
    engine's it followed. A valid token's experts depend on its own hidden
    state only, so they may differ at a near-tie of its router's
    probabilities alone (at most 1% of the valid tokens); its kept
    assignments also depend on the pad rows before it, which the ref
    route gives other values (reported, not checked)."""
    n_moe = cfg.block_kinds().count("moe")
    for width in sorted(eng.dropped):
        tokens_ = eng.slots * width
        cap = expert_capacity(tokens_, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
        first = [int(x) for x in eng.dropped[width][:n_moe]]
        print(f"  [{label}] step width {width}: T = {tokens_} tokens, "
              f"expert capacity {cap}; the first such launch dropped "
              f"{sum(first)} of {tokens_ * cfg.top_k * n_moe} assignments "
              f"over its {n_moe} MoE layers (per layer {first})",
              flush=True)
    ids, keep, seen = (int(shadow.ids_differ), int(shadow.keep_differ),
                       int(shadow.valid_seen))
    check(seen > 0 and ids <= seen // 100,
          f"{label}: the ref route's own expert choice differed from the "
          f"kernel engine's on {ids} of {seen} valid token-layers")
    print(f"  [{label}] lockstep dispatch: the ref route's own choice of "
          f"experts differed from the kernel engine's on {ids} of {seen} "
          f"valid token-layers, its own kept assignments on {keep} (pad "
          "rows compete for capacity, and the two routes give them other "
          "values)", flush=True)


def drive_checked(eng, shadow, free, prompts, max_new, profile_at,
                  rows_differ):
    """Serve every prompt through kernel engine `eng` beside two comparison
    engines. `shadow` is put in eng's state before each step, then takes
    the same step (lockstep): its tokens are the comparison's choices from
    the very state the kernels saw. `free` serves the same requests on its
    own. `rows_differ(a, b)` (or None) names the rows whose quantized
    state — int8 KV codes, or activation codes — differs between two
    engines after a step. Returns ({rid: tokens emitted before the first
    step where its row differed between eng and free}, profiles). The
    steps in `profile_at` run under the profiler."""
    reqs = submit_all(eng, prompts, max_new)
    submit_all(shadow, prompts, max_new)
    submit_all(free, prompts, max_new)
    owner, first_diff, profiles = {}, {}, []
    step = 0
    while eng.pending():
        copy_state(shadow, eng)
        before = {r.rid: len(r.out_tokens) for r in reqs}
        if step in profile_at:
            calls = eng.stats.prefill_chunk_calls
            text = profiled(eng.step)
            kind = ("a chunk step" if eng.stats.prefill_chunk_calls > calls
                    else "decode only")
            profiles.append((step, f"({kind}) {text}"))
        else:
            eng.step()
        shadow.step()
        free.step()
        owner.update({s: r for s, r in enumerate(eng._slot_req)
                      if r is not None})
        if rows_differ is not None:
            for s in np.flatnonzero(rows_differ(eng, free)):
                rid = owner[int(s)].rid
                first_diff.setdefault(rid, before[rid])
        step += 1
    check(not shadow.pending() and not free.pending(),
          "a comparison engine did not drain in step")
    return first_diff, profiles


def tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.finished}


def check_no_faults(label, *engines):
    """No row of these engines was quarantined and no request failed. With
    no fault injected, a non-finite row is a kernel's fault, which the
    engine would otherwise scrub and replay without a word."""
    for eng in engines:
        st = eng.stats
        check(st.quarantines == 0 and st.failed_requests == 0,
              f"{label}: {st.quarantines} quarantines and "
              f"{st.failed_requests} failed requests with no fault injected")


def compare(label, got, ref, limit=None):
    """Tokens of the kernel engine vs a comparison engine. Without `limit`
    (lockstep) every step is compared except near-ties (comparison margin
    <= MARGIN); with it
    (free-running), each request is compared up to its first near-tie or
    limit[rid], whichever comes first: after either the two streams may
    rightly diverge. Returns (compared, skipped, first mismatch or
    None)."""
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
                    f"comparison's {ref_toks[i]} (margin "
                    f"{ref.margins[rid][i]:.3g})")
            compared += 1
    return compared, skipped, None


def run_variant(label, cfg, model, prompts, max_new, card, *,
                resident=None, geo=None, profile_at=(6, 45)):
    """One engine variant: the free-running pass of the kernel engine
    alone (launches, tokens/s, step times, peak memory), then the checked
    pass beside two comparison engines. Returns the launch counts of the
    kernels on the variant's path. `geo`: the engine's slots, max_len and
    prefill chunk (phase 5's by default); `profile_at`: the checked pass's
    steps to profile (phase 5's mix: at step 6 the 1000-token prompt
    admits while others decode; at step 45 every prompt is in, decode
    only). An MoE config's comparison engines follow the kernel engine's
    expert dispatch (`RouteEngine`)."""
    geo = geo or dict(slots=8, max_len=LK, prefill_chunk=W)
    moe = cfg.n_experts > 0

    # the main path, free-running and alone on the card; resident weights
    # converted in place (as the serve launcher does), so no dense copy of
    # the weights stays alive beside the codes
    if resident:
        quantize_params(model, resident)
    eng = ServingEngine(cfg, model, **geo)
    routes = (eng.decode_route(), eng.prefill_route(), eng.weight_route())
    want = ("cuda-decode", "cuda-prefill",
            f"resident-{resident}" if resident else "dense")
    check(routes == want, f"{label}: routes {routes}, want {want}")
    eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ALL_KERNELS:
        k.launches = 0
    wall_s, chunk_ms, decode_ms = serve_timed(eng, prompts, max_new)
    counts = {k.__name__: k.launches for k in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    path = [k.__name__ for k in KERNELS
            if k.__name__.endswith("_quant") == cfg.kv_quant]
    if resident:
        path += [k.__name__ for k in AIO_KERNELS]
    st = eng.stats
    check(all(counts[n] > 0 for n in path),
          f"{label}: a kernel of the path never launched: {counts}")
    check(not any(counts[k.__name__] for k in PAGED_KERNELS),
          f"{label}: a paged kernel launched on the flat path: {counts}")
    per_call = 7 * cfg.n_layers * st.model_calls
    if resident:
        check(counts["aio_matmul"] == counts["aio_quant"] == per_call,
              f"{label}: {counts} AIO launches, want {per_call} (7 Linears "
              f"x {cfg.n_layers} layers x {st.model_calls} model calls)")
    n_tok = st.generated_tokens
    print(f"  [{label}] routes {routes}; launches {counts}; per step: "
          f"decode {counts[path[0]] / st.decode_steps:g}, prefill "
          f"{counts[path[1]] / st.prefill_chunk_calls:g}"
          + (f"; AIO GEMM and quantizer "
             f"{counts['aio_matmul'] / st.model_calls:g} each per model "
             f"call ({st.model_calls} model calls)" if resident else ""))
    print(f"  [{label}] free-running: {n_tok} tokens in {wall_s:.3f} s = "
          f"{n_tok / wall_s:.1f} tok/s; {len(chunk_ms)} chunk steps "
          f"(median {np.median(chunk_ms):.2f} ms), {len(decode_ms)} "
          f"decode-only steps (median {np.median(decode_ms):.2f} ms); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (weights, this "
          f"engine's caches and activations); {card}", flush=True)
    check_no_faults(f"{label} free-running", eng)
    served = tokens(eng)
    del eng
    torch.cuda.empty_cache()

    # correctness: the same requests beside a lockstep and a free-running
    # comparison engine — the ref route (dense, int8-KV), or the plain
    # quantizer and GEMM in place of their kernels (resident)
    if resident:
        eng = CodeEngine(cfg, model, gemm=KERNEL_GEMM, **geo)
        shadow = CodeEngine(cfg, model, gemm=PLAIN_GEMM, follow=eng, **geo)
        free = CodeEngine(cfg, model, gemm=PLAIN_GEMM, **geo)
        rows_differ = code_rows_differ
    elif moe:
        ref_policy = api.ExecutionPolicy(backend="ref")
        eng = RouteEngine(cfg, model, **geo)
        shadow = RouteEngine(cfg, model, policy=ref_policy, follow=eng,
                             **geo)
        free = RouteEngine(cfg, model, policy=ref_policy, **geo)
        rows_differ = route_rows_differ
    else:
        ref_policy = api.ExecutionPolicy(backend="ref")
        eng = ServingEngine(cfg, model, **geo)
        shadow = MarginEngine(cfg, model, policy=ref_policy, **geo)
        free = MarginEngine(cfg, model, policy=ref_policy, **geo)
        rows_differ = quant_rows_differ if cfg.kv_quant else None
    first_diff, profiles = drive_checked(
        eng, shadow, free, prompts, max_new, profile_at, rows_differ)
    for step, text in profiles:
        print(f"  [{label}] profile of step {step}: {text}", flush=True)
    check_no_faults(f"{label} checked pass", eng, shadow, free)
    got = tokens(eng)
    check(got == served, f"{label}: the checked pass's tokens differ from "
          "the free-running pass's")
    compared, skipped, bad = compare(label, got, shadow)
    check(bad is None, f"lockstep: {bad}")
    text = (f"{compared} tokens match, {skipped} near-tie step(s) "
            f"skipped")
    if resident:
        same, bad, first = (int(shadow.rows_same), int(shadow.rows_bad),
                            int(shadow.first_differ))
        check(bad == 0 and first == 0 and same > 0,
              f"{label}: lockstep quantizer check: {bad} of {same} "
              f"activation rows with bitwise equal inputs got other codes "
              f"or scales from the plain quantizer than from the kernel; "
              f"{first} rows of the steps' first calls had unequal inputs")
        text += (f"; {same} of {shadow.rows_seen} activation rows had "
                 "bitwise equal inputs in the two engines (all of every "
                 "step's first call), and the plain quantizer gave each "
                 "the kernel's codes and scale bitwise (the GEMMs then "
                 "took the kernel engine's codes)")
    if moe:
        report_routes(label, cfg, eng, shadow)
        text += ("; the lockstep engine took the kernel engine's expert "
                 "dispatch")
    print(f"  [{label}] lockstep vs the comparison engine: {text}",
          flush=True)
    compared, skipped, bad = compare(label, got, free, limit=first_diff)
    check(bad is None, f"free-running: {bad}")
    tie = sum(any(m <= MARGIN for m in ms) for ms in free.margins.values())
    text = (f"{compared} tokens match, {skipped} not compared; "
            f"{tie} request(s) reach a margin <= {MARGIN}")
    if rows_differ is not None:
        what = ("activation codes or scales" if resident
                 else "expert dispatch (experts or kept assignments)" if moe
                 else "int8 KV codes or scales")
        text += (f", {len(first_diff)} reach a step where the two engines' "
                 f"{what} differ (tokens before it: "
                 f"{sorted(first_diff.values())})")
    print(f"  [{label}] free-running vs the comparison engine: {text}",
          flush=True)
    free_tokens = tokens(free)
    del eng, shadow, free
    torch.cuda.empty_cache()
    return {n: counts[n] for n in path}, served, free_tokens


ENGINE_PLENS = [16, 1000, 137, 512, 64, 800, 300, 33]
MAX_NEW = 32


def engine_prompts(vocab):
    """Phase 5's mix: 8 prompts of 16..1000 tokens (32 new tokens each)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in ENGINE_PLENS]


def engine_phase(dev, card):
    """Returns the launch counts and, per variant, the free-running kernel
    pass's tokens (phase 5c's baselines), and the dense variant's
    free-running ref engine's."""
    phase("5. engine: qwen2_1p5b CONFIG, 8 slots, max_len 2048, chunk 32")
    base = get_config("qwen2_1p5b")
    prompts = engine_prompts(base.vocab)
    max_new = MAX_NEW
    launches = {k.__name__: 0 for k in ALL_KERNELS}
    served_by = {}
    variants = [("dense bf16-KV", False, None), ("int8-KV", True, None)]
    variants += [(f"{fmt}-resident", False, fmt) for fmt in RESIDENT]
    for label, kv_quant, resident in variants:
        t0 = time.perf_counter()
        model = init_params(base, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"  [{label}] {base.name}: {base.n_layers} layers, d_model "
              f"{base.d_model}, {base.n_heads}/{base.n_kv_heads} heads, d_ff "
              f"{base.d_ff}, vocab {base.vocab}; {n_params / 1e9:.3f} B f32 "
              f"params in {time.perf_counter() - t0:.1f}s", flush=True)
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        counts, served, free = run_variant(label, cfg, model, prompts,
                                           max_new, card, resident=resident)
        for name, n in counts.items():
            launches[name] += n
        served_by[label] = served
        if label == "dense bf16-KV":
            served_by["dense ref"] = free
        del model
        torch.cuda.empty_cache()
    return launches, served_by


PAGED_HEAD = 300                   # 18 full blocks of 16 and 12 tokens
PAGED_TAILS = [16, 700, 137, 212, 64, 500, 3, 33]
PAGED_VARIANTS = [("paged bf16-KV", False, None),
                  ("paged int8-KV", True, None),
                  ("paged bf16-KV, pool 160", False, 160)]


def paged_prompts(vocab):
    """Phase 5b's mix: 16 prompts of a shared 300-token head and the tails
    of PAGED_TAILS, each twice (32 new tokens each)."""
    rng = np.random.RandomState(1)
    head = rng.randint(1, vocab, PAGED_HEAD).astype(np.int32)
    return [np.concatenate([head, rng.randint(1, vocab, n)])
            .astype(np.int32) for n in PAGED_TAILS * 2]


def paged_engine_phase(dev, card):
    """Returns the launch counts and, per variant, the paged engine's
    tokens (phase 5c's baselines)."""
    phase("5b. paged engine: qwen2_1p5b CONFIG, 8 slots, max_len 2048, "
          "chunk 32, block size 16; 16 requests sharing a 300-token head")
    base = get_config("qwen2_1p5b")
    model = init_params(base, seed=0, device=dev)
    prompts = paged_prompts(base.vocab)
    max_new = MAX_NEW
    launches = {k.__name__: 0 for k in PAGED_KERNELS}
    served_by = {}
    flat_served = {}      # the flat kernel engine's tokens, per KV layout
    for label, kv_quant, pool_blocks in PAGED_VARIANTS:
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        served = {False: flat_served.get(kv_quant), True: None}
        if served[False] is not None:
            print(f"  [{label}] flat: the flat kernel engine's pass above "
                  "(same layout, model and mix)", flush=True)
        for paged in (False, True):
            if served[paged] is not None:
                continue
            kind = "paged" if paged else "flat"
            eng = ServingEngine(cfg, model, slots=8, max_len=LK,
                                prefill_chunk=W, paged=paged, block_size=16,
                                pool_blocks=pool_blocks if paged else None)
            routes = (eng.decode_route(), eng.prefill_route())
            check(routes == ("cuda-decode", "cuda-prefill"),
                  f"{label}: routes {routes}")
            eng.warmup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in ALL_KERNELS:
                k.launches = 0
            wall_s, chunk_ms, decode_ms = serve_timed(eng, prompts, max_new)
            counts = {k.__name__: k.launches for k in ALL_KERNELS}
            peak = torch.cuda.max_memory_allocated()
            used, idle = (PAGED_KERNELS, KERNELS) if paged else \
                (KERNELS, PAGED_KERNELS)
            path = [k.__name__ for k in used
                    if k.__name__.endswith("_quant") == kv_quant]
            check(all(counts[n] > 0 for n in path),
                  f"{label} ({kind}): a kernel of the path never launched: "
                  f"{counts}")
            check(not any(counts[k.__name__] for k in idle),
                  f"{label} ({kind}): a kernel of the other layout "
                  f"launched: {counts}")
            check_no_faults(f"{label} ({kind})", eng)
            st = eng.stats
            n_tok = st.generated_tokens
            print(f"  [{label}] {kind}: {n_tok} tokens in {wall_s:.3f} s = "
                  f"{n_tok / wall_s:.1f} tok/s; {len(chunk_ms)} chunk steps "
                  f"(median {np.median(chunk_ms):.2f} ms), {len(decode_ms)} "
                  f"decode-only steps (median {np.median(decode_ms):.2f} "
                  f"ms); launches per step: decode "
                  f"{counts[path[0]] / st.decode_steps:g}, prefill "
                  f"{counts[path[1]] / st.prefill_chunk_calls:g} "
                  f"({counts[path[0]]} / {counts[path[1]]}); "
                  f"max_memory_allocated {peak / 2**30:.2f} GiB; {card}",
                  flush=True)
            served[paged] = tokens(eng)
            if not paged:
                flat_served[kv_quant] = served[False]
            else:
                ps = eng.pool_stats()
                print(f"  [{label}] pool_stats {json.dumps(ps)}", flush=True)
                for n in path:
                    launches[n] += counts[n]
            del eng
            torch.cuda.empty_cache()
        check(served[True] == served[False],
              f"{label}: the paged engine's tokens differ from the flat "
              "kernel engine's")
        served_by[label] = served[True]
        need = ("deferred_admissions", "evictions") if pool_blocks else \
            ("prefix_hits", "shared_tokens", "cow_copies")
        check(all(ps[k] > 0 for k in need), f"{label}: want {need} > 0, "
              f"got {ps}")
        n_tok = sum(map(len, served[True].values()))
        print(f"  [{label}] all {len(served[True])} requests' tokens equal "
              f"to the flat kernel engine's ({n_tok} tokens); "
              + ", ".join(f"{k} {ps[k]}" for k in need), flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, served_by


# ------------------------------------------------ robustness on the card
DEMOTED = "serving engine demoted"
# every warning of the run (main records them): the demotions among them
# must be exactly phase 5c's two injected ones
WARNINGS: list = []
SNAP_DIR = ROOT / "build" / "snapshots"


def demotion_count() -> int:
    return sum(DEMOTED in w for w in WARNINGS)


def record_warnings():
    """Keep the text of every warning of the run in WARNINGS (still
    printed), each RuntimeWarning every time it is raised."""
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        WARNINGS.append(str(message))
        show(message, category, filename, lineno, file, line)
    warnings.showwarning = record
    warnings.simplefilter("always", RuntimeWarning)


def submit_mix(eng, prompts, priorities=None):
    for rid, p in enumerate(prompts):
        check(eng.submit(Request(rid, p, max_new_tokens=MAX_NEW,
                                 priority=priorities[rid] if priorities
                                 else 0)), f"request {rid} refused")


def same_tokens(label, got, want):
    """Every request's tokens bitwise equal to the earlier phase's for the
    same request id."""
    check(set(got) <= set(want), f"{label}: unknown requests {set(got)}")
    bad = [rid for rid in got if got[rid] != want[rid]]
    check(not bad, f"{label}: requests {bad} differ from the earlier "
          f"phase's tokens (first: {got[bad[0]] if bad else ''} vs "
          f"{want[bad[0]] if bad else ''})")


def case_report(label, eng, t0, extra=""):
    torch.cuda.synchronize()
    st = eng.stats
    counters = {k: getattr(st, k) for k in (
        "quarantines", "demotions", "timeouts", "rejected_submits",
        "failed_requests", "preemptions", "swap_outs", "swap_ins",
        "generated_tokens", "prefill_chunk_calls", "decode_steps")}
    print(f"  [{label}] {time.perf_counter() - t0:.2f} s wall; "
          f"{eng.step_no} steps; counters {json.dumps(counters)}"
          f"{extra}; pool_stats {json.dumps(eng.pool_stats())}",
          flush=True)


def snapshot_midstream(label, make, prompts, want, cond, priorities=None):
    """Serve `prompts` with engine A = make() until cond(A) holds, snapshot
    it, restore into a FRESH engine B = make() and drain B: the requests A
    finished before the snapshot and those B finishes after it must have
    the tokens `want`. Returns A (for the caller to go on with)."""
    a = make()
    submit_mix(a, prompts, priorities)
    while a.pending() and not cond(a):
        a.step()
    check(a.pending(), f"{label}: the run drained before the snapshot")
    t0 = time.perf_counter()
    path = a.snapshot(SNAP_DIR)
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    t_save = time.perf_counter() - t0
    b = make()
    t0 = time.perf_counter()
    check(b.restore(SNAP_DIR) == a.step_no, f"{label}: restored step")
    t_load = time.perf_counter() - t0
    preempted = len(b._preempted)
    b.run_until_drained()
    check_no_faults(label, a, b)
    got = tokens(a) | tokens(b)
    check(set(got) == set(range(len(prompts))), f"{label}: requests lost "
          f"across the restore: {sorted(got)}")
    same_tokens(label, got, want)
    print(f"  [{label}] snapshot at step {a.step_no} ({len(a.finished)} "
          f"done, {int(a._prefilling.sum())} mid-prefill, "
          f"{int((a._occupied() & ~a._prefilling).sum())} mid-decode, "
          f"{preempted} preempted) of {size / 1e6:.1f} MB: save "
          f"{t_save:.2f} s, restore {t_load:.2f} s; every request's tokens "
          f"equal the earlier phase's after the restore", flush=True)
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    del b
    return a


def robustness_phase(dev, card, served, paged_served):
    phase("5c. robustness on the card: qwen2_1p5b CONFIG at full width and "
          "depth (phase 5's weights), the mixes of phases 5 and 5b")
    t_phase = time.perf_counter()
    base = get_config("qwen2_1p5b")
    model = init_params(base, seed=0, device=dev)
    geo = dict(slots=8, max_len=LK, prefill_chunk=W)
    prompts = engine_prompts(base.vocab)
    pprompts = paged_prompts(base.vocab)
    prios = [rid % 2 for rid in range(len(pprompts))]
    shutil.rmtree(SNAP_DIR, ignore_errors=True)

    # 1. preemption: the contended shared-head mix, priorities 0/1
    for label, kv_quant, want in (
            ("preemption bf16-KV", False, paged_served["paged bf16-KV"]),
            ("preemption int8-KV", True, paged_served["paged int8-KV"])):
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        for pool in (160, 128, 96):
            def make():
                return ServingEngine(cfg, model, paged=True, block_size=16,
                                     pool_blocks=pool, swap_watermark=0.9,
                                     **geo)
            t0 = time.perf_counter()
            if kv_quant:
                eng = make()
                submit_mix(eng, pprompts, prios)
            else:
                # case 4b rides along: snapshot while a row is PREEMPTED,
                # restore into a fresh engine, finish there
                eng = snapshot_midstream(
                    f"snapshot/restore paged, pool {pool}", make, pprompts,
                    want, lambda e: e._preempted and len(e._swap_store),
                    prios)
            eng.run_until_drained()
            if eng.stats.preemptions:
                break
            print(f"  [{label}] pool {pool}: no preemption, shrinking the "
                  "pool", flush=True)
        case_report(label, eng, t0, f"; pool {pool} blocks, watermark 0.9")
        same_tokens(label, tokens(eng), want)
        check(len(eng.finished) == len(pprompts) and all(
            r.status == "done" for r in eng.finished),
            f"{label}: not every request done")
        ps = eng.pool_stats()
        check(min(ps["preemptions"], ps["swap_outs"], ps["swap_ins"]) >= 1,
              f"{label}: want preemptions, swap-outs and swap-ins: {ps}")
        check(ps["swap_bytes_in"] == ps["swap_bytes_out"] > 0,
              f"{label}: swap bytes out {ps['swap_bytes_out']}, in "
              f"{ps['swap_bytes_in']}")
        check(ps["host_blocks"] == ps["host_bytes"] == 0,
              f"{label}: the host store is not empty when drained: {ps}")
        check(eng.stats.demotions == 0, f"{label}: demoted")
        check_no_faults(label, eng)
        print(f"  [{label}] all {len(pprompts)} requests' tokens equal "
              f"phase 5b's ({'int8' if kv_quant else 'bf16'} KV) bitwise; "
              f"{ps['preemptions']} preemptions, {ps['swap_bytes_out']} "
              "bytes swapped out and back", flush=True)
        del eng
        torch.cuda.empty_cache()

    # 2. quarantine: phase 5's mix (request r in slot r) under four faults
    for label, kv_quant, want, faults in (
            ("quarantine bf16-KV", False, served["dense bf16-KV"], [
                Fault("poison", step=5, slot=7, target="logits"),
                Fault("poison", step=10, slot=4, target="kv",
                      value=float("inf")),
                Fault("latency", step=6, delay_s=0.05),
                Fault("malformed", step=2, target="2d-prompt")]),
            ("quarantine int8-KV", True, served["int8-KV"], [
                Fault("poison", step=10, slot=4, target="kv")])):
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        eng = ServingEngine(cfg, model, **geo)
        plan = FaultPlan(faults)
        t0 = time.perf_counter()
        submit_mix(eng, prompts)
        _, rejections = drive_with_plan(eng, plan)
        case_report(label, eng, t0, f"; plan {plan.describe()}")
        same_tokens(label, tokens(eng), want)
        poisons = [f for f in faults if f.kind == "poison"]
        check(all(f.tripped for f in faults), f"{label}: a fault did not "
              f"trip: {plan.describe()}")
        check(eng.stats.quarantines == len(poisons),
              f"{label}: {eng.stats.quarantines} quarantines, want "
              f"{len(poisons)} (one row a poison)")
        check(eng.stats.failed_requests == 0 and eng.stats.demotions == 0,
              f"{label}: failed or demoted: {eng.stats}")
        n_bad = sum(f.kind == "malformed" for f in faults)
        check(len(rejections) == n_bad, f"{label}: rejections {rejections}")
        print(f"  [{label}] every request's tokens equal phase 5's; "
              f"{eng.stats.quarantines} rows quarantined and replayed; "
              f"{len(rejections)} malformed submission(s) rejected",
              flush=True)
        del eng
        torch.cuda.empty_cache()

    # 3. demotion: a launch fault at step 0, at each boundary
    for boundary in ("launch", "dispatch"):
        label = f"demotion at the {boundary} boundary"
        eng = ServingEngine(base, model, **geo)
        before = demotion_count()
        t0 = time.perf_counter()
        eng.arm_fault_plan(FaultPlan.single("launch", step=0,
                                            boundary=boundary))
        submit_mix(eng, prompts)
        eng.run_until_drained()
        (event,) = eng.degraded_routes()
        case_report(label, eng, t0, f"; degraded {json.dumps(event)}")
        check(eng.stats.demotions == 1 and demotion_count() == before + 1,
              f"{label}: {eng.stats.demotions} demotions")
        check(event["from"] == {"decode": "cuda-decode",
                                "prefill": "cuda-prefill"}
              and event["to"] == {"decode": "ref", "prefill": "ref"},
              f"{label}: routes {event}")
        same_tokens(label, tokens(eng), served["dense ref"])
        check_no_faults(label, eng)
        print(f"  [{label}] one demotion, cuda-decode/cuda-prefill -> "
              "ref/ref; tokens equal phase 5's free-running ref engine's",
              flush=True)
        del eng
        torch.cuda.empty_cache()

    # 4. snapshot/restore of the flat engine, rows mid-prefill and
    # mid-decode (the paged one rode along with case 1)
    t0 = time.perf_counter()
    eng = snapshot_midstream(
        "snapshot/restore flat", lambda: ServingEngine(base, model, **geo),
        prompts, served["dense bf16-KV"],
        lambda e: e._prefilling.any() and (e._occupied()
                                           & ~e._prefilling).any()
        and e.step_no >= 8)
    del eng
    torch.cuda.empty_cache()

    # 5. weight poison on the int4-resident engine, then restore with the
    # weights
    label = "weight poison int4-resident"
    quantize_params(model, "int4")
    eng = ServingEngine(base, model, max_replays=0, **geo)
    t0 = time.perf_counter()
    submit_mix(eng, prompts)
    eng.step()
    eng.step()
    ts = time.perf_counter()
    path = eng.snapshot(SNAP_DIR, include_params=True)
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    t_save = time.perf_counter() - ts
    pre = tokens(eng)
    eng.arm_fault_plan(FaultPlan.single("poison", step=eng.step_no,
                                        target="weight"))
    eng.run_until_drained()
    case_report(f"{label}, poisoned", eng, t0)
    failed = [r.status for r in eng.finished if r.rid not in pre]
    check(len(failed) == len(prompts) - len(pre)
          and set(failed) == {"FAILED"},
          f"{label}: statuses under weight poison {failed}")
    n_failed = eng.stats.failed_requests
    eng.arm_fault_plan(None)
    ts = time.perf_counter()
    eng.restore(SNAP_DIR)
    t_load = time.perf_counter() - ts
    t0 = time.perf_counter()
    eng.run_until_drained()
    case_report(f"{label}, restored", eng, t0)
    # the restore put back the counters of step 2, before the poison
    check_no_faults(f"{label}, restored", eng)
    same_tokens(label, pre | tokens(eng), served["int4-resident"])
    check(all(r.status == "done" for r in eng.finished),
          f"{label}: not every request done after the restore")
    print(f"  [{label}] snapshot with the weights at step 2 "
          f"({size / 1e9:.2f} GB: save {t_save:.2f} s, restore "
          f"{t_load:.2f} s); the weight poison failed all {n_failed} "
          "requests in flight; after the restore every request's tokens "
          "equal phase 5's int4 free pass", flush=True)
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    del eng, model
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 5c: {wall:.1f} s wall; {card}", flush=True)


# ------------------------------------------------ the other families (5d)
# gemma2-27B at full width over 4 layers: two prompts past its 4096-token
# window, so the local layers' chunked prefill and decode cross it
GEMMA_PLENS = [4600, 4200, 700, 90]
GEMMA_GEO = dict(slots=4, max_len=6144, prefill_chunk=W)
# the dense configs: four requests each
DENSE_PLENS = [16, 1000, 300, 64]
DENSE_GEO = dict(slots=4, max_len=LK, prefill_chunk=W)


def family_prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in lens]


def families_phase(dev, card):
    """Phase 5d: the families beside the llama family, each served by the
    kernel engine and checked as phase 5 checks its variants. Returns the
    launch counts of the kernels on their paths."""
    phase("5d. the other families: olmoe_1b_7b CONFIG (full width and "
          "depth), gemma2_27b CONFIG over 4 layers, gpt2_small and olmo_1b "
          "CONFIG, internlm2_20b CONFIG over 4 layers; bf16 KV, f32 weights "
          "(seed 0), chunk 32. kimi_k2 stays on the CPU: one of its MoE "
          "layers at full width is 16.9 B parameters (67 GB in f32)")
    t_phase = time.perf_counter()
    olmoe = get_config("olmoe_1b_7b")
    variants = [
        ("olmoe_1b_7b", olmoe, engine_prompts(olmoe.vocab), MAX_NEW,
         None, (45,)),
        ("gemma2_27b x4", dataclasses.replace(get_config("gemma2_27b"),
                                              n_layers=4),
         None, 16, GEMMA_GEO, (6,)),
        ("gpt2_small", get_config("gpt2_small"), None, MAX_NEW, DENSE_GEO,
         ()),
        ("olmo_1b", get_config("olmo_1b"), None, MAX_NEW, DENSE_GEO, ()),
        ("internlm2_20b x4", dataclasses.replace(
            get_config("internlm2_20b"), n_layers=4), None, MAX_NEW,
         DENSE_GEO, ()),
    ]
    launches = {}
    for label, cfg, prompts, max_new, geo, profile_at in variants:
        t0 = time.perf_counter()
        if prompts is None:
            lens = GEMMA_PLENS if cfg.local_global else DENSE_PLENS
            prompts = family_prompts(cfg.vocab, lens, seed=2)
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"  [{label}] {cfg.name}: {cfg.n_layers} layers "
              f"({'/'.join(sorted(set(cfg.block_kinds())))}), d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.hd}, d_ff {cfg.d_ff}"
              + (f" x {cfg.n_experts} experts (top {cfg.top_k})"
                 if cfg.n_experts else "")
              + f", vocab {cfg.vocab}, window {cfg.sliding_window}, "
              f"softcaps {cfg.softcap_attn}/{cfg.softcap_final}; "
              f"{n_params / 1e9:.3f} B f32 params in "
              f"{time.perf_counter() - t0:.1f}s; prompts "
              f"{[len(p) for p in prompts]}, {max_new} new tokens each",
              flush=True)
        if cfg.n_experts:
            n_moe = cfg.block_kinds().count("moe")
            expert_bytes = 4 * 3 * n_moe * cfg.n_experts * cfg.d_model \
                * cfg.d_ff
            print(f"  [{label}] the experts' f32 weights, read whole by "
                  f"each step's batched expert products: "
                  f"{expert_bytes / 1e9:.2f} GB, >= "
                  f"{1e3 * expert_bytes / HBM_BYTES_PER_S:.2f} ms a launch "
                  f"at 3.35 TB/s", flush=True)
        counts, _, _ = run_variant(label, cfg, model, prompts, max_new,
                                   card, geo=geo, profile_at=profile_at)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  [{label}] {time.perf_counter() - t0:.1f} s", flush=True)
        del model
        torch.cuda.empty_cache()
    print(f"  phase 5d: {time.perf_counter() - t_phase:.1f} s wall; {card}",
          flush=True)
    return launches


# ------------------------------------- full-sequence attention, B9 and B11
FULL_CASES = [
    # the reference's six cases (tests/test_kernels.py), then non-causal,
    # bf16 K/V, and GQA group 6 at qwen2-1.5B's heads
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
                      kv=torch.bfloat16)),
    ("group 6", dict(b=2, hq=12, hkv=2, lq=512, lk=512, d=128)),
]


def full_case(dev, seed, *, b, hq, hkv, lq, lk, d, kv=torch.float32, **_):
    """q as the model hands it over (a head-split, strided f32 view), K/V
    f32 or bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, hq, d, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(b, hkv, lk, d, generator=g, device=dev) * 0.5
    v = torch.randn(b, hkv, lk, d, generator=g, device=dev)
    return q * 0.5, k.to(kv), v.to(kv)


def attn_kw(case):
    return {k: case[k] for k in ("causal", "window", "softcap", "offset")
            if k in case}


def tenant_data(dev, shapes, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(m, k, generator=g, device=dev).to(dtype),
             (torch.randn(k, n, generator=g, device=dev) * k ** -0.5
              ).to(dtype)) for m, k, n in shapes]


def extents(shapes):
    """Each tenant's (K, N), as morphable_multi_gemm hands them to the
    grouped GEMM."""
    return dict(group_k=[k for _, k, _ in shapes],
                group_n=[n for _, _, n in shapes])


def packed(tenants, pol=api.default_policy):
    """The grouped launch of a tenant mix as `morphable_multi_gemm` makes
    it: group ids, packed x (T, K), stacked w (G, K, N)."""
    x, w, sizes, _ = pack_tenants(tenants, pol.bm, pol.bk, pol.bn)
    return make_group_ids(sizes, pol.bm, device=x.device), x, w


def new_kernel_phase(dev):
    phase("3d. full-sequence attention vs plain (max |diff| <= 1e-4, no "
          "NaN), grouped GEMM vs plain (max |diff| <= 1e-5 * max |plain|), "
          "depthwise conv vs plain (bitwise)")
    errs = {"flash_attention": 0.0, "grouped_matmul": 0.0,
            "depthwise_conv": 0.0}
    for i, (label, case) in enumerate(FULL_CASES):
        q, k, v = full_case(dev, 50 + i, **case)
        got = flash_attention(q, k, v, **attn_kw(case))
        want = flash_attention_plain(q, k, v, **attn_kw(case))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        nan = got.isnan().any().item()
        print(f"  flash_attention {label:22s} {tuple(q.shape)} K/V "
              f"{tuple(k.shape)} {str(k.dtype)[6:]}: max|diff| {err:.3e}, "
              f"NaN {nan}", flush=True)
        check(err <= TOL and not nan, f"flash_attention {label}: max |diff| "
              f"{err} above {TOL} or NaN")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    # all bf16 (a bf16 output): the f32 results agree to 1e-4 before the
    # final rounding, so to one bf16 ulp (at most 2^-7 of the value) plus
    # 1e-4 after it
    q, k, v = (t.to(torch.bfloat16) for t in full_case(
        dev, 60, b=2, hq=12, hkv=2, lq=256, lk=256, d=128))
    got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
    ok = torch.allclose(got.float(), want.float(), rtol=2 ** -7, atol=TOL)
    print(f"  flash_attention all bf16 (bf16 output): within one bf16 ulp "
          f"+ 1e-4: {ok}", flush=True)
    check(ok, "flash_attention all-bf16: beyond one bf16 ulp + 1e-4")

    ragged = [(100, 64, 96), (300, 120, 50), (60, 256, 256), (7, 1536, 33)]
    for dtype in (torch.float32, torch.bfloat16):
        for bm in (128, 64, 16):
            pol = api.ExecutionPolicy(bm=bm, bk=bm, bn=bm)
            gids, x, w = packed(tenant_data(dev, ragged, bm, dtype), pol)
            want = grouped_matmul_plain(gids, x, w, bm=bm)
            for label, kw in (("packed", {}), ("extents", extents(ragged))):
                got = grouped_matmul(gids, x, w, bm=bm, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                print(f"  grouped_matmul {str(dtype)[6:]:8s} bm=bk=bn="
                      f"{bm:3d} {label:7s} tenants {ragged} -> x "
                      f"{tuple(x.shape)} w {tuple(w.shape)}: max|diff| "
                      f"{err:.3e} ({rel:.2e} of max|plain|)", flush=True)
                check(rel <= 1e-5, f"grouped_matmul {dtype} bm={bm} "
                      f"{label}: {rel}")
                errs["grouped_matmul"] = max(errs["grouped_matmul"], err)
            row = 0
            for m, _, n in ragged:
                size = -(-m // bm) * bm
                check(not got[row:row + size, n:].any().item(),
                      f"grouped_matmul bm={bm}: a padded output column of "
                      "a tenant is not 0")
                row += size
    # odd H and W, C = 3, 130, 576 (also not multiples of 4 or 8), 1x1 to
    # 9x9 taps (9x9 and the even sizes take the kernel's runtime-kw path),
    # non-square filters
    for n, h, w_, c, kh, kw in [
            (2, 9, 7, 3, 3, 3), (1, 13, 11, 130, 5, 5), (2, 15, 9, 576, 7, 7),
            (1, 7, 13, 130, 3, 3), (2, 11, 11, 3, 7, 7), (1, 9, 15, 576, 5, 5),
            (1, 5, 6, 24, 1, 1), (1, 10, 13, 40, 9, 9), (2, 11, 9, 130, 3, 5),
            (2, 8, 10, 64, 7, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(kh * kw * c)
            x = torch.randn(n, h, w_, c, generator=g, device=dev).to(dtype)
            f = torch.randn(kh, kw, c, generator=g, device=dev).to(dtype)
            got, want = depthwise_conv(x, f), depthwise_plain(x, f)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"  depthwise_conv {str(dtype)[6:]:8s} x {(n, h, w_, c)} "
                  f"{kh}x{kw}: bitwise equal {same}", flush=True)
            check(same, f"depthwise_conv {dtype} {(n, h, w_, c, kh, kw)}: "
                  "not bitwise equal to the plain version")
    return errs


def full_bound(b, hq, hkv, lq, lk, d, es=4, mmas=None):
    """Least time (ms) of causal full-sequence attention: the f32 flops of
    the kept (query, key) pairs over the f32 CUDA-core rate (the rate B3's
    row uses), against q, k, v read once and the output written once over
    the memory rate. With `mmas`, the same work at the kernel's own
    instruction mix instead: each f32 product as that many bf16
    tensor-core MMAs on three-term operands (6 for f32 K/V, 3 for bf16)
    over the bf16 tensor rate."""
    pairs = b * hq * sum(min(i + 1, lk) for i in range(lq))
    t_ops = pairs * d * 4 / F32_FLOPS_PER_S
    if mmas is not None:
        t_ops = pairs * d * 4 * mmas / BF16_FLOPS_PER_S
    t_bytes = (2 * b * hq * lq * d * es + 2 * b * hkv * lk * d * es) \
        / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def depthwise_bound(n, h, w, c, k, es=4):
    """Least time (ms) of a k x k depthwise conv: x and the taps read once
    and the output written once over the memory rate, or its unfused f32
    instructions, a multiply and an add per tap and output (the bitwise
    order of the reference forbids fusing them), over the f32 instruction
    rate; and which of the two sets it."""
    t_bytes = es * (2 * n * h * w * c + k * k * c) / HBM_BYTES_PER_S
    t_ops = 2 * k * k * n * h * w * c / F32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dw_bound_text(bound_by, k):
    return ("x, taps and output over 3.35 TB/s" if bound_by == "bytes"
            else f"2 x {k * k} unfused f32 instructions an output over "
            "33.5 T/s")


def tenants_f32_bound(shapes):
    """Least time (ms) of a tenant mix's useful work: each tenant's x, w
    and output moved once, max(bytes / 3.35 TB/s, 2 M K N / 67 TFLOP/s)."""
    t_bytes = 4 * sum(m * k + k * n + m * n for m, k, n in shapes) \
        / HBM_BYTES_PER_S
    t_ops = 2 * sum(m * k * n for m, k, n in shapes) / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gemm_f32_bound(t, k, n, g):
    """Least time (ms) of a grouped f32 GEMM launch: max(bytes / 3.35 TB/s,
    2 T K N / 67 TFLOP/s); x, w and out moved once."""
    t_bytes = 4 * (t * k + g * k * n + t * n) / HBM_BYTES_PER_S
    t_ops = 2 * t * k * n / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def full_timing_phase(dev, errs):
    phase("4d. full-sequence attention, grouped GEMM and depthwise conv "
          "timing (ms per launch, CUDA events)")
    rows = {}
    # B8: B 4, Hq 12, Hkv 2, D 128, L 2048, causal, f32 (67 MB a copy),
    # first held against its plain version at this shape (max |diff| <=
    # 1e-4, no NaN), the full-sequence forward's
    cases = [full_case(dev, 70 + i, b=FULL_B, hq=HQ, hkv=HKV, lq=FULL_L,
                       lk=FULL_L, d=D) for i in range(2)]
    got = flash_attention(*cases[0])
    want = flash_attention_plain(*cases[0])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    nan = got.isnan().any().item()
    del got, want
    print(f"  flash_attention at the timed shape {tuple(cases[0][0].shape)}"
          f" K/V {tuple(cases[0][1].shape)} f32: max|diff| {err:.3e}, NaN "
          f"{nan}", flush=True)
    check(err <= TOL and not nan, f"flash_attention at the timed shape: max "
          f"|diff| {err} above {TOL} or NaN")
    errs["flash_attention"] = max(errs["flash_attention"], err)
    group = HQ // HKV
    wide = [(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))
            for q, k, v in cases]
    ms = cuda_ms([functools.partial(flash_attention, *c) for c in cases], 10)
    plain_ms = cuda_ms([functools.partial(flash_attention_plain, *c)
                        for c in cases], 3)
    lib_ms = cuda_ms([functools.partial(F.scaled_dot_product_attention, *c,
                                        is_causal=True) for c in wide], 10)
    f32_ms, f32_by = full_bound(FULL_B, HQ, HKV, FULL_L, FULL_L, D)
    bound_ms, bound_by = full_bound(FULL_B, HQ, HKV, FULL_L, FULL_L, D,
                                    mmas=6)
    rows["flash_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
    print(f"  flash_attention B={FULL_B} Hq={HQ} Hkv={HKV} D={D} L={FULL_L} "
          f"causal f32: kernel {ms:.4f}  plain {plain_ms:.4f}  SDPA (K/V "
          f"expanded to Hq beforehand) {lib_ms:.4f} ({ms / lib_ms:.2f}x)  "
          f"bound {bound_ms:.4f} ({bound_by}, MMA mix: 6 bf16 MMAs a "
          f"product at 989 TFLOP/s; {100 * bound_ms / ms:.1f}% of it)  f32 "
          f"bound {f32_ms:.4f} ({f32_by}, 67 TFLOP/s; "
          f"{100 * f32_ms / ms:.1f}% of it)", flush=True)
    del cases, wide

    for name, shapes in MIXES.items():
        mix_bytes = 4 * sum(m * k + k * n for m, k, n in shapes)
        copies = [tenant_data(dev, shapes, 80 + i)
                  for i in range(max(2, -(-100_000_000 // mix_bytes)))]
        launches = [packed(t) for t in copies]
        gids, x, w = launches[0]
        t, kmax, nmax = x.shape[0], x.shape[1], w.shape[2]
        # as morphable_multi_gemm launches it: with each tenant's (K, N)
        ext = extents(shapes)
        ms = cuda_ms([functools.partial(grouped_matmul, *a, **ext)
                      for a in launches], 20)
        packed_ms = cuda_ms([functools.partial(grouped_matmul, *a)
                             for a in launches], 20)
        plain_ms = cuda_ms([functools.partial(grouped_matmul_plain, *a)
                            for a in launches], 5)

        def per_tenant(tenants):
            for xi, wi in tenants:
                torch.matmul(xi, wi)
        lib_ms = cuda_ms([functools.partial(per_tenant, c) for c in copies],
                         20)
        bound_ms, bound_by = tenants_f32_bound(shapes)
        launch_ms, launch_by = gemm_f32_bound(t, kmax, nmax, len(shapes))
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        rows[("grouped_matmul", name)] = row
        print(f"  grouped_matmul {name}: {shapes} -> T={t} K={kmax} "
              f"N={nmax}: kernel {ms:.4f} (each tenant's K, N; the packed "
              f"launch without them {packed_ms:.4f})  plain {plain_ms:.4f}  "
              f"torch.matmul per tenant (f32, TF32 off) {lib_ms:.4f}  bound "
              f"of the useful work {bound_ms:.5f} ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it), of the packed launch "
              f"{launch_ms:.5f} ({launch_by})", flush=True)
        del copies, launches

    for n, h, w_, c, kk in DW_SHAPES:
        nbytes = 4 * (2 * n * h * w_ * c + kk * kk * c)
        g = torch.Generator(device=dev).manual_seed(kk * c)
        copies = [(torch.randn(n, h, w_, c, generator=g, device=dev),
                   torch.randn(kk, kk, c, generator=g, device=dev))
                  for _ in range(max(2, -(-100_000_000 // nbytes)))]
        # the library call: cuDNN's grouped conv2d on the same NHWC memory
        # (a channels-last NCHW view), padding (k-1)/2 = SAME for odd k
        lib = [functools.partial(
            F.conv2d, x.permute(0, 3, 1, 2),
            f.permute(2, 0, 1).unsqueeze(1).contiguous(), padding=kk // 2,
            groups=c) for x, f in copies]
        ms = cuda_ms([functools.partial(depthwise_conv, *a) for a in copies],
                     50)
        plain_ms = cuda_ms([functools.partial(depthwise_plain, *a)
                            for a in copies], 10)
        lib_ms = cuda_ms(lib, 50)
        bound_ms, bound_by = depthwise_bound(n, h, w_, c, kk)
        rows[("depthwise_conv", (n, h, w_, c, kk))] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        print(f"  depthwise_conv x {(n, h, w_, c)} {kk}x{kk} f32: kernel "
              f"{ms:.4f}  plain {plain_ms:.4f}  conv2d(groups=C) "
              f"{lib_ms:.4f} ({ms / lib_ms:.2f}x)  bound {bound_ms:.5f} "
              f"({bound_by}: {dw_bound_text(bound_by, kk)}; "
              f"{100 * bound_ms / ms:.1f}% of it)", flush=True)
        del copies, lib
    torch.cuda.empty_cache()
    return {"flash_attention": rows["flash_attention"],
            "grouped_matmul": rows[("grouped_matmul", SUMMARY_MIX)],
            "depthwise_conv": rows[("depthwise_conv", DW_SHAPES[0])]}


def fullseq_phase(dev, card):
    phase(f"6. full-sequence path: qwen2_1p5b CONFIG, {SEQ_B} prompts of "
          f"{SEQ_L} tokens: forward, make_prefill_step and loss_fn on the "
          "kernel route and the ref route; the serving engine's first tokens")
    cfg = get_config("qwen2_1p5b")
    model = init_params(cfg, seed=0, device=dev)     # phase 5's weights
    rng = np.random.RandomState(6)
    toks_np = rng.randint(1, cfg.vocab, (SEQ_B, SEQ_L)).astype(np.int64)
    toks = torch.from_numpy(toks_np).to(dev)
    labels = torch.cat([toks[:, 1:], torch.full((SEQ_B, 1), -100,
                                                device=dev)], 1)
    batch = {"tokens": toks, "labels": labels}
    step = make_prefill_step(cfg)
    route = api.ops.attention_route(lq=SEQ_L, lk=SEQ_L)
    check(route == "cuda", f"the forward's attention routes to {route}")
    others = [k for k in ALL_KERNELS if k is not flash_attention]

    forward(model, toks[:1, :128])                   # first-launch setup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ALL_KERNELS:
        k.launches = 0
    ts = time.perf_counter()
    logits, _ = forward(model, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    peak = torch.cuda.max_memory_allocated()
    n_full = flash_attention.launches
    check(n_full == cfg.n_layers, f"{n_full} full-sequence launches in one "
          f"forward, want {cfg.n_layers}")
    check(not any(k.launches for k in others),
          f"another kernel launched in the forward: "
          f"{ {k.__name__: k.launches for k in others} }")
    nxt = step(model, batch)
    loss, _ = loss_fn(model, batch)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    check(launches == 3 * cfg.n_layers and not any(
        k.launches for k in others), f"{launches} full-sequence launches in "
        f"forward + prefill step + loss, want {3 * cfg.n_layers}")
    print(f"  kernel route: forward {1e3 * wall:.1f} ms wall = "
          f"{SEQ_B * SEQ_L / wall:.0f} prompt tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (weights, "
          f"activations, {SEQ_B}x{SEQ_L}x{cfg.vocab} f32 logits); "
          f"flash_attention {n_full} launches per forward, {launches} in "
          f"forward + prefill step + loss, no other kernel; {card}",
          flush=True)
    top2 = logits[:, -1].topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    last = logits[:, -1].clone()
    print(f"  profile of one forward: "
          f"{profiled(functools.partial(forward, model, toks))}", flush=True)
    launched = flash_attention.launches

    with api.policy(backend="ref"):
        ref_logits, _ = forward(model, toks)
        diff = (logits - ref_logits).abs().max().item()
        scale = ref_logits.abs().max().item()
        del logits, ref_logits
        torch.cuda.empty_cache()
        ref_next = step(model, batch)
        ref_loss, _ = loss_fn(model, batch)
    torch.cuda.synchronize()
    check(flash_attention.launches == launched, "the ref route launched the "
          "full-sequence kernel")
    rel_loss = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    print(f"  vs the ref route: max|dlogit| {diff:.3e} ({diff / scale:.2e} "
          f"of max|logit| {scale:.2f}); greedy tokens {nxt.tolist()} vs "
          f"{ref_next.tolist()} (top-1/top-2 margins "
          f"{[round(m, 4) for m in margins]}); loss {loss.item():.6f} vs "
          f"{ref_loss.item():.6f} (relative {rel_loss:.2e})", flush=True)
    check(diff <= LOGIT_TOL * scale, f"max |dlogit| {diff} above "
          f"{LOGIT_TOL} x {scale}")
    check(torch.equal(nxt, ref_next), "greedy tokens differ from the ref "
          "route's")
    check(torch.equal(nxt, last.argmax(-1)), "the prefill step's tokens are "
          "not the forward's argmax")
    check(rel_loss <= LOSS_TOL, f"loss differs by {rel_loss} (relative)")

    # the same prompts through the serving engine's chunked prefill (B3)
    # with float32 caches, so it computes the forward's function
    eng = ServingEngine(cfg, model, slots=SEQ_B, max_len=LK,
                        prefill_chunk=W)
    eng.caches = init_caches(cfg, SEQ_B, LK, device=dev,
                             dtype=torch.float32)
    for k in ALL_KERNELS:
        k.launches = 0
    submit_all(eng, list(toks_np.astype(np.int32)), 1)
    ts = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - ts
    check_no_faults("serving engine, f32 caches", eng)
    first = [r.out_tokens[0] for r in sorted(done, key=lambda r: r.rid)]
    print(f"  serving engine (f32 caches, chunk {W}): first tokens {first} "
          f"in {eng_s:.2f} s ({eng.stats.prefill_chunk_calls} chunk steps; "
          f"flash_prefill {flash_prefill.launches} launches, "
          f"flash_attention {flash_attention.launches})", flush=True)
    check(flash_prefill.launches > 0 and flash_attention.launches == 0,
          "the engine's prefill did not run on the varlen prefill kernel")
    check(first == nxt.tolist(), f"the engine's first tokens {first} differ "
          f"from make_prefill_step's {nxt.tolist()}")
    del eng, model
    torch.cuda.empty_cache()
    return {"flash_attention": launches}


def morphable_phase(dev):
    phase("7. morphable ops: api.ops.morphable_multi_gemm on each mix (one "
          "grouped launch), api.ops.depthwise_conv on a MobileNetV2 block")
    for k in FULL_KERNELS:
        k.launches = 0
    pol = api.default_policy
    for i, (name, shapes) in enumerate(MIXES.items()):
        tenants = tenant_data(dev, shapes, 90 + i)
        before = grouped_matmul.launches
        results, util = api.ops.morphable_multi_gemm(tenants)
        torch.cuda.synchronize()
        check(grouped_matmul.launches == before + 1,
              f"{name}: {grouped_matmul.launches - before} grouped launches")
        x, w, _, _ = pack_tenants(tenants, pol.bm, pol.bk, pol.bn)
        useful = sum(m * k * n for m, k, n in shapes)
        plain_util = useful / (x.shape[0] * x.shape[1] * w.shape[2])
        check(util == plain_util, f"{name}: utilization {util} vs the plain "
              f"packing's {plain_util}")
        worst = 0.0
        for (xi, wi), r in zip(tenants, results):
            want = xi @ wi
            rel = (r - want).abs().max().item() / want.abs().max().item()
            worst = max(worst, rel)
        check(worst <= 1e-5, f"{name}: a tenant's result is {worst} (of its "
              "max) from the plain product")
        print(f"  {name}: one grouped launch, MAC utilization {util:.4f} "
              f"(= the packing's), every tenant within {worst:.2e} of its "
              "plain product", flush=True)
    n, h, w_, c, kk = DW_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn(n, h, w_, c, generator=g, device=dev)
    f = torch.randn(kk, kk, c, generator=g, device=dev)
    out = api.ops.depthwise_conv(x, f)
    torch.cuda.synchronize()
    check(depthwise_conv.launches == 1, "api.ops.depthwise_conv did not "
          "launch the depthwise kernel once")
    check(torch.equal(out, depthwise_plain(x, f)), "depthwise_conv: the op "
          "is not bitwise equal to the plain version")
    print(f"  depthwise_conv MobileNetV2 {(n, h, w_, c)} {kk}x{kk}: one "
          "launch, bitwise equal to the plain version", flush=True)
    return {"grouped_matmul": grouped_matmul.launches,
            "depthwise_conv": depthwise_conv.launches}


def main() -> int:
    t_start = time.perf_counter()
    dev_info = device_phase()
    if dev_info is None:
        return 2
    _, _, smi = dev_info
    dev = torch.device("cuda")
    record_warnings()
    build_phase()
    errs = kernel_phase(dev)
    errs.update(paged_kernel_phase(dev))
    errs.update(aio_kernel_phase(dev))
    errs.update(new_kernel_phase(dev))
    times = timing_phase(dev)
    times.update(paged_timing_phase(dev))
    times.update(aio_timing_phase(dev))
    times.update(full_timing_phase(dev, errs))
    launches, served = engine_phase(dev, smi)
    paged_launches, paged_served = paged_engine_phase(dev, smi)
    launches.update(paged_launches)
    robustness_phase(dev, smi, served, paged_served)
    for kname, n in families_phase(dev, smi).items():
        launches[kname] += n
    launches.update(fullseq_phase(dev, smi))
    launches.update(morphable_phase(dev))
    phase("8. summary")
    demotions = [w for w in WARNINGS if DEMOTED in w]
    check(len(demotions) == 2, f"{len(demotions)} engine demotions in the "
          f"run, want only phase 5c's two injected ones: {demotions}")
    print("engine demotions: the two injected in phase 5c, no other",
          flush=True)
    kernels = []
    for kname in (k.__name__ for k in ALL_KERNELS):
        source, replaces = KERNEL_META[kname]
        kernels.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=launches[kname],
                            max_abs_err=errs[kname], **times[kname]))
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
