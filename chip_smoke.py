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
3e. The AIO GEMM (B5) against the paper's multiplier model
   (`core/aio_mac.py`), bit for bit: one launch a mode computes an outer
   product of single products (x holds M codes at k = 0, w holds N codes,
   every other k position a zero code, scales 1;
   `kernels/aio_matmul/oracle.py`): every fp8a x fp8a and fp8b x fp8b
   code pair equal to `aio_fp_multiply(a, b, f, f, BF16)` decoded, every
   int8 pair (256 x 256) and int4 pair (16 x 16) to `aio_int_multiply`,
   and 65,536 random bf16 pairs, RNE-rounded to bf16, to
   `aio_fp_multiply(..., BF16)`; a zero product compares as +0 (the K-long
   sum's sign). Prints each mode's mismatches, and those among the pairs
   with a subnormal operand; any mismatch fails. These launches are not
   counted as the main path's.
3f. Static analysis on the card (`repro_torch.analysis.run_all()`, what
   `python -m repro_torch.analysis` runs): the launch contracts of the 8
   kernel impls swept on the CPU (KC100-KC105: tiles in bounds at every
   block, masked tails, 32-bit offsets, the H100's launch limits); every
   contract case's body (each C entry point, flat, paged and int8, at the
   contracts' cases) launched with every operand inside 64 KiB redzones
   filled with NaN patterns (guards unchanged, output equal to the plain
   version, NaN nowhere the plain version has none), under torch.profiler
   (each kernel record's grid, block and shared memory equal to the
   contract's), and under compute-sanitizer (memcheck, synccheck,
   racecheck, initcheck; this machine's refuses the device: a KB433
   warning with its words); the hot-loop audit of the default smoke
   engines; the format matrix. Prints the findings, their counts against
   the `cuda` section of `src/repro_torch/analysis/baseline.json` and the
   phase's wall time. Phases 5 (dense, int8 KV, int4 resident), 5b
   (paged), 5d (olmoe) and 5e (zamba2, bf16 KV) then audit their own
   engines after the free-running pass (`hotloop.check_engine`): the idle
   step at each width recorded op by op (host syncs, rebound cache
   buffers, dequants, the health guard), then 3 live steps of 2 requests
   under `torch.cuda.set_sync_debug_mode`; their counts are held to the
   section's `engines`. Launches made here do not count as the main
   path's.
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
   with prompts of 16..256 tokens (16..1000 until phase 3f, 16..512
   until the partition phase needed the time) and 24 new tokens each (32
   until phase 7e needed the time) — dense bf16-KV,
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
   33 tokens, each length twice, 24 new tokens each: (a) bf16 KV, default
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
   max_len 2048, 4 requests each of 16, 500, 300 and 64 prompt tokens
   (1000 until phase 3f needed the time). The MoE variant's comparison engines
   follow the kernel engine's expert dispatch in lockstep (a top-k choice
   or a capacity cut flips at a tie, and a chunk's pad rows, which the
   routes give other values, compete for capacity); the ref route's own
   choice of experts may differ on at most 1% of valid token-layers.
   kimi_k2 is not run on the card (one MoE layer at full width is 16.9 B
   parameters, 67 GB in f32). Prints the phase's wall time.
5e. The recurrent and hybrid families at full width and depth, random f32
   weights from seed 0, 8 slots, max_len 1024, served through the merged
   engine (one l=1 launch a step for prefilling and decoding rows):
   zamba2_2p7b CONFIG (54 layers: 45 Mamba2 and 9 invocations of one
   shared attention + MLP block, d_model 2560, 32 heads of 80; 2.06 B
   parameters) in bf16 KV, int8 KV and int4 resident (the shared block's
   seven Linears; the Mamba2 mixers stay dense, as in the reference), and
   xlstm_1p3b CONFIG (48 layers: 42 mLSTM, 6 sLSTM, d_model 2048, mLSTM
   heads of 1024 with a 1024 x 1025 state; 3.61 B), each as a phase-5
   variant on 8 prompts of 4-24 tokens, 16 new tokens each. First B1, B2
   and B8 at zamba2's head_dim 80 against their plain versions (1e-4; B2
   bitwise equal to B1 on the dequantized K/V), timed beside their plain
   versions, SDPA and their bounds. Then per config a teacher-forced
   `decode_step` over 256 tokens (one row, f32 caches) against `forward`:
   max |dlogit| <= 2e-3 x max |logit|, the reference test's tolerance.
   zamba2 must launch its decode kernel once per shared-block invocation
   of every model call (9), the AIO kernels 63 times a call when
   resident, and no chunk launch; xlstm no kernel. One merged step of each
   config is profiled. Prints the phase's wall time.
5f. The frontend families, random f32 weights from seed 0: (a)
   whisper_tiny CONFIG at full width and depth (4 encoder and 4 decoder
   layers, d_model 384, 6 heads of 64, vocab 51,865), 8 slots, one random
   1500-frame clip a slot (`frames=`, encoded once per engine), max_len
   1024, chunk 32, 8 prompts of 4-64 tokens and 32 new tokens each, as
   phase-5 variants: bf16 KV, int8 KV, bf16 KV at chunk 128 (its chunk
   launches send the cross attention to B8, which must launch once a
   decoder layer in each) and int4 resident (the encoder's and the cross
   attention's Linears too: B10 then B5 on the 12,000 memory rows of each
   step's cross k/v projections); first a teacher-forced `decode_step`
   over 256 tokens against `forward(frames=)` (B8 causal and non-causal,
   8 launches), max |dlogit| <= 1e-3 x max |logit|, and a paged engine
   must be refused naming ROADMAP C. (b) internvl2_76b CONFIG at full
   width over 4 of 80 layers (d_model 8192, 64/8 heads of 128, d_ff
   28,672, vocab 128,256; 3.4 B parameters in the layers) as a bf16-KV
   variant on phase 5d's dense mix, then `forward` over 1024 random patch
   embeddings and 1024 tokens (2048 positions, B8 once a layer) against
   the ref route within 1e-3 x max |logit|. (c) The kernels at the new
   shapes against their plain versions, timed beside them, their library
   call and their bound: B8 non-causal at (B 1, H 6, Lq 256, Lk 1500, D
   64); B10 then B5 in int4 at M 12,000, K = N = 384 and at M 8, K
   28,672, N 8192. One decode step of whisper and of internvl2 is
   profiled. Prints the phase's wall time.
5g. Multi-tenant serving: `MorphableScheduler()` on the card's device grid
   (1 x 1: the fused 128 x 128 plan of Fig 8-(h), both tenants in one
   partition) with the serve launcher's two tenants, declared int8:
   captioning on the olmoe_1b_7b CONFIG (full width and depth, seed 0)
   and classification on the qwen2_1p5b CONFIG (full width and depth,
   seed 1), their Linears resident in int8 (`quantize_params`; olmoe's
   experts stay dense), ~29 GB together; 4 slots, max_len 256, chunk 32,
   8 requests a tenant of 16-200 prompt tokens, 16 new tokens. (1) The
   launcher's order: both engines built (routes cuda-decode /
   cuda-prefill / resident-int8) and attached, then each served through
   `sched.run`, one after the other; B1, B3, B5 and B10 must launch in
   each tenant (counted as differences around its own steps; B5 and B10
   once per resident Linear of each model call), and the scheduler's
   `occupancy()` / `utilization()` read mid-flight must show the serving
   tenant busy and the other idle. Prints each tenant's tok/s, step
   medians and the peak memory. (2) Each tenant in lockstep against an
   engine running the plain quantizer and GEMM (attention on its kernels;
   olmoe's also following the expert dispatch): tokens equal to (1) and
   to the comparison's but at near-ties, the quantizer's codes bitwise on
   every row with bitwise equal inputs. (3) Interleaved: the same
   requests on fresh engines, both tenants pending, `step()` alternating
   between the engines until both drain: every token bitwise equal to
   (1), the same launches, both tenants busy at once; one decode-only
   step of each profiled. (4) `launch.serve.main(["--multi-tenant",
   "--requests", "2", "--max-new", "4"])` (the SMOKE tenants), then a
   single-tenant run with `--format int8 --backend ref` (no kernel
   launch). No engine may quarantine a row or fail a request. Prints the
   phase's wall time.
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
7b. Training: (a) the olmo_1b CONFIG at full width and depth (16 layers,
   d_model 2048, d_ff 8192, vocab 50,304; 1.18 B f32 parameters) trained
   10 steps by `runtime.Trainer` (seed 0; `data.SyntheticLM` seed 5, 4 x
   512 tokens; AdamW, base_lr 3e-4, warmup 2; no checkpoint written):
   every loss and grad norm finite, step 1 (lr 0 at the pre-increment
   step) leaves every parameter bitwise unchanged, every attention call of
   the steps on the ref route (autograd records it; the CONFIG
   rematerializes, so each layer's attention runs twice a step, in the
   forward and in the backward's recompute) and no kernel launched in
   them, B8 0 times though L = 512 is 128-aligned; a direct B8 call on
   a query that requires grad must raise. Prints the losses, the step
   median, tokens/s, peak memory and one profiled step. (a') The same
   Trainer fed the stream's first batch at every step: step 10's loss
   below step 2's (on the stream itself the loss stays within its
   batch-to-batch spread for 10 steps at this width). (b) The same
   widths at depth 2, seed 0, one batch of 2 x 128: every parameter's
   gradient on the card within 1e-4 x the leaf's max
   |g| of the CPU's (which the CPU tests hold against JAX). (c) (a)'s
   trained model under no_grad: `loss_fn` on B8 (16 launches a forward)
   within 1e-4 (relative) of the ref route, `make_prefill_step` tokens
   equal but at near-ties; `make_serve_step` over 4 prompts of 64 tokens
   fed one token a step, then 32 greedy tokens (f32 caches): B1 16 times
   a step and no other kernel, every token equal to the ref route's
   `decode_step` in lockstep but at near-ties (margin <= 1e-3). (d)
   `launch.train.main(["--arch", "olmo_1b", "--smoke", "--steps", "8",
   "--simulate-preemption", "4", "--device", "cuda"])` against the
   uninterrupted 8-step launch: final params within atol 1e-6 (printed:
   whether bitwise equal). (e) The hybrid-FP8 recipe
   (examples/fp8_training.py): the qwen2_1p5b CONFIG at full width over 4
   of its 28 layers under QuantPolicy(fp8a, fp8a), against the
   unquantized run, 20 steps each of 8 x 64 tokens at base_lr 2e-3: every
   fp8 loss finite and the last below the first; prints the final-loss
   gap. Checkpoints go under build/train_ckpt and are deleted. The
   launches of (c) count as the main path's.
7c. Distribution on one card: a world of 8 ranks (`launch.world.
   spawn_world`), every rank on cuda:0 over gloo (NCCL refuses two ranks
   a device, so every collective goes through host memory; NCCL across
   cards is not exercised). (a) qwen2_1p5b CONFIG over 2 layers, B 2 x L
   512, the automatic TP path on mesh (1, 2); (b) internlm2_20b CONFIG
   over 2 layers, L 1024, the manual TP+SP block on (1, 8) (each rank
   builds the whole model in turn and keeps its shards); (c) olmoe_1b_7b
   CONFIG over 2 layers, B 2 x L 512, expert parallelism on (1, 2): each
   against rank 0's one-rank forward on the ref route (plain attention),
   max |dlogit| <= 1e-4 x max |logit| (olmoe's reference routed as the EP
   run chose; its own expert choice may differ on at most 1% of
   token-layers). Each rank's recorded collectives show the path taken:
   (a) two row-parallel all-reduces a layer and no sequence collective,
   (b) two sequence all-gathers and two reduce-scatters a layer, (c) one
   expert combine over "model" a layer and no all-gather of the experts;
   B8 launches once a layer on every rank. (d) olmo_1b CONFIG over 2
   layers on (2, 1), 3 steps of a global 4 x 256 batch: the int8
   compressed step (step 1's reduced gradient within scale/2 of the f32
   mean, elementwise; the ranks' params bitwise equal after every step),
   then the plain-DP Trainer within 1e-5 (relative) of one rank's
   Trainer. (e) The launcher's two tenants on partitions of ranks 0-3
   as a (2, 2) grid (`MorphableScheduler(ranks=)`, each partition a (1, 2)
   mesh bound by `run`), served at once: olmoe_1b_7b CONFIG over 4 of its
   16 layers on ranks 0-1, qwen2_1p5b CONFIG over all 28 on ranks 2-3, each
   rank's weights its shards from `dist.init_sharded` (one KV head a rank
   for qwen2), flat bf16-KV and paged int8-KV engines over 6 prompts of
   16-160 tokens, 8 new tokens each; a one-rank engine of the whole
   model on each partition's first rank runs in lockstep (put in the
   partition's state before every step, the heads all-gathered; it emits
   the partition's tokens, and olmoe's follows its expert choices): logits
   of every consumed row within 1e-3 (bf16 KV) / 1e-2 (int8 KV) of max
   |logit|, tokens equal but at near-ties (counted), expert choice
   differing on at most 1% of token-layers; every rank's caches hold
   n_kv / 2 heads, no weight all-gathered, each variant's two attention
   kernels launched on every rank. qwen2's two engines are snapshotted
   (`include_params=False`) once a request has finished (after chunk and
   decode steps), each rank writing its heads under one manifest, and restored
   into fresh engines on the partition that finish the streams with
   every token bitwise equal to the uninterrupted engines' on every rank.
   On olmoe's partition a flat engine serves 5 prompts with TTLs of 0 s,
   60 s and none while the second rank's engine reads a clock skewed by
   +1000 s and +50 s a read: both ranks end the same requests (the 0 s
   ones) TIMEOUT at the same steps, on the lead rank's clock; its
   snapshot restored under the (2, 1) mesh of the same ranks is refused
   on both. Prints each case's max |diff|, times and
   peak memory (every rank's in (e)); the launches of B8 in (a)-(c) and of
   B1 / B3 / B6 / B7 on the partitions count as the main path's. A failed
   rank fails the run.
7d. The examples (`examples/pt_*.py`) at the reference examples' sizes,
   in this process: pt_quickstart (formats, the CSM product, the
   quantized matmul in bf16 / int8 / fp8a through B10 and B5, the
   morphable GEMM through B9, 6 Trainer steps on a world of one), each
   kernel's launches counted and its outputs held to the plain route on
   the same inputs (int8 and the quantizer's codes bitwise, float modes
   within rtol 2e-5, the grouped GEMM within 1e-5 x max |plain|);
   pt_fp8_training (40 steps of qwen2 SMOKE, f32 and fp8a: its two
   asserts); pt_morphable_inference (plans and utilizations equal to the
   CPU run's); pt_multi_tenant_serving with `--backend cuda`, each tenant's
   engine in lockstep with a ref-route engine (phase 5's rule: tokens
   equal but at near-ties). Prints each example's wall time; the launches
   of B5, B9, B10, B1 and B3 count as the main path's.
7e. Long sequences (runs after 7b): (a) the olmo_1b CONFIG at full width
   and depth, which rematerializes (`ModelConfig.remat`), trained 3
   Trainer steps at 2 x 4,096 tokens (train_4k's sequence; seed 0,
   `SyntheticLM` seed 9): losses and grad norms finite, each layer
   checkpointed once a step and its attention routed to ref twice (the
   forward and the recompute), no kernel launched; prints the step ms,
   tokens/s, peak memory and one profiled step. (b) The same model and
   optimizer state with `dataclasses.replace(cfg, remat=False)`, one
   forward and backward at 2 x 512, 1,024 and 2,048: the quadratic
   through the three peaks carried to 4,096 is printed beside (a)'s peak
   (nothing runs at 4,096 without remat: it would not fit). (c) One
   batch of 2 x 512 with remat and without: the loss and every gradient
   within 1e-6 x the leaf's max |g|. (d) The qwen2_1p5b CONFIG at full
   width and depth (seed 0), `forward` and `make_prefill_step` over one
   prompt of 32,768 tokens (prefill_32k's sequence) on the kernel route:
   B8 exactly 28 times each and no other kernel; the logits against the ref route's (past
   4096 x 8192 scores it runs `chunked_attention`, 28 calls) within 1e-3
   x max |logit|, an argmax that differs only where the ref logits' top
   two lie within twice that difference, the prefill token equal but at
   a near-tie (margin <= 1e-3); prints the wall, prompt tokens/s and peak
   memory; then B8 alone at that shape (B 1, Hq 12, Hkv 2, D 128, causal,
   f32) against its plain version (1e-4, no NaN), timed beside it,
   memory-efficient SDPA and its bound. (e) The qwen2_1p5b CONFIG over 4
   of its 28 layers and a prompt of 32,700 tokens, not 128-aligned, so
   the kernel backend routes it to ref, which runs chunked (4 calls, no
   kernel): finite logits, peak memory printed, and its logits at the
   first 32,640 positions within 1e-3 x max |logit| of B8's forward over
   them (4 launches). The launches of (d)'s forward and prefill step and
   of (e)'s prefix count as the main path's. Prints the phase's wall time.
8. Summary: no engine of any phase demoted but phase 5c's two injected
   faults (every demotion warns; the script records the warnings), a
   `{"kernels": [...]}` line (13 kernel entry points), the script's wall
   time, then as the last line `{"ok": true, "device": {...}}`. Any failed
   check exits non-zero before; so does any drift of phase 3f's or the
   engine audits' finding counts from the baseline's `cuda` section (an
   error finding not pinned there included).

`python3 chip_smoke.py --write-baseline` runs the same phases and rewrites
that whole `cuda` section (phase 3f's counts and each audited engine's)
from the run instead of holding the run to it.
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

from repro_torch import analysis, api  # noqa: E402
from repro_torch.analysis import hotloop  # noqa: E402
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
from repro_torch.bridge import (grads_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_caches, init_params, loss_fn,
                                quantize_params)
from repro_torch.models.attention import _q8  # noqa: E402
from repro_torch.models.layers import Linear, QuantPolicy  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    RECURRENT_KINDS, encode, has_recurrent, kv_caches)
from repro_torch.models.moe import MoE, expert_capacity  # noqa: E402
from repro_torch.serving import (FaultPlan, Request,  # noqa: E402
                                 ServingEngine, drive_with_plan)
from repro_torch.serving.faults import Fault  # noqa: E402
from repro_torch.kernels.aio_matmul.oracle import (  # noqa: E402
    ORACLE_MODES, oracle_check)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.tenancy import MorphableScheduler, Tenant  # noqa: E402

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


T_START = time.perf_counter()


def phase(title: str):
    print(f"\n=== {title}  [t = {time.perf_counter() - T_START:.1f} s]",
          flush=True)


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
def make_case(dev, seed, *, b, hq, hkv, lq, lk, pos, lens=None, d=D):
    """One attention case as the serving path hands it over: q a head-split
    (strided) f32 view, a bf16 cache, and its int8 codes + pow2 scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, hq, d, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(b, hkv, lk, d, generator=g, device=dev) * 0.5
    v = torch.randn(b, hkv, lk, d, generator=g, device=dev)
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


def oracle_phase(dev):
    """Phase 3e: the AIO GEMM against the paper's multiplier model
    (`core/aio_mac.py`), bit for bit, one outer-product launch a mode
    (`kernels/aio_matmul/oracle.py`). Its launches compare a kernel with
    the model and are not the main path's."""
    phase("3e. AIO GEMM vs the multiplier model core/aio_mac.py, bit for "
          "bit (one outer-product launch a mode: every fp8 / int8 / int4 "
          "code pair, 65,536 random bf16 pairs)")
    for mode in ORACLE_MODES:
        before = aio_matmul.launches
        got = oracle_check(mode, dev)
        check(aio_matmul.launches == before + 1, f"oracle {mode}: the GEMM "
              "kernel did not launch once")
        print(f"  {mode}: {got['mismatches']} of {got['pairs']} products "
              f"differ from aio_mac; {got['subnormal_mismatches']} of the "
              f"{got['subnormal_pairs']} pairs with a subnormal operand",
              flush=True)
        check(got["mismatches"] == 0, f"oracle {mode}: the GEMM kernel "
              f"differs from the multiplier model: {got}")


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


def prefill_calls(eng) -> int:
    """Launches with no decoding row: chunk launches, and a merged
    engine's prefill token steps."""
    return eng.stats.prefill_chunk_calls + eng.stats.prefill_token_steps


def serve_timed(eng, prompts, max_new):
    """The main path as a user drives it: submit every request and step the
    engine until it drains, with nothing else on the card. Returns the
    pass's wall seconds (ended by a synchronize) and each step's host
    milliseconds, split into steps with a prefill launch (a chunk launch,
    or a merged engine's prefill-only launch) and the others; a step ends
    where the engine reads its tokens back."""
    submit_all(eng, prompts, max_new)
    chunk_ms, decode_ms = [], []
    t0 = time.perf_counter()
    while eng.pending():
        calls_before = prefill_calls(eng)
        ts = time.perf_counter()
        eng.step()
        dt = 1e3 * (time.perf_counter() - ts)
        (chunk_ms if prefill_calls(eng) > calls_before
         else decode_ms).append(dt)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, chunk_ms, decode_ms


def quant_rows_differ(a, b) -> np.ndarray:
    """(slots,) bool: rows whose position, int8 KV codes or scales differ
    between two engines' caches, up to each row's frontier (the attention
    layers' caches; a hybrid model's recurrent states are float)."""
    kv_a, kv_b = kv_caches(a.caches), kv_caches(b.caches)
    pos = kv_a[0].pos
    lmax = kv_a[0].k_codes.shape[2]
    live = (torch.arange(lmax, device=pos.device)[None, :]
            < pos[:, None].long())[:, None, :, None]
    differ = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    for ca, cb in zip(kv_a, kv_b):
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
            prefilling = int(eng._prefilling.sum())
            occupied = int(eng._occupied().sum())
            text = profiled(eng.step)
            kind = (f"merged: {occupied} rows, {prefilling} prefilling"
                    if eng._merged_mode()
                    else "a chunk step" if eng.stats.prefill_chunk_calls
                    > calls else "decode only")
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
                resident=None, geo=None, profile_at=(6, 30), also=(),
                audit=False):
    """One engine variant: the free-running pass of the kernel engine
    alone (launches, tokens/s, step times, peak memory), then the checked
    pass beside two comparison engines. Returns the launch counts of the
    kernels on the variant's path. `geo`: the engine's keywords, slots,
    max_len, prefill chunk and (an encoder-decoder model) frames (phase
    5's by default); `also`: kernels beside the attention (and resident
    AIO) kernels that must launch on the path; `profile_at`: the checked
    pass's
    steps to profile (phase 5's mix: at step 6 the 500- and 512-token
    prompts admit while others decode; at step 45 every prompt is in,
    decode only); `audit`: run the hot-loop audit on the kernel engine after its
    free-running pass. An MoE config's comparison engines follow the kernel
    engine's
    expert dispatch (`RouteEngine`). A model with recurrent blocks runs
    merged l=1 launches: flash_decode (or its int8 variant) launches once
    per attention layer of every model call, no chunk launch is made,
    and an attention-free model launches no kernel."""
    geo = geo or dict(slots=8, max_len=LK, prefill_chunk=W)
    moe = cfg.n_experts > 0
    merged = has_recurrent(cfg)
    n_attn = sum(k not in RECURRENT_KINDS for k in cfg.block_kinds())

    # the main path, free-running and alone on the card; resident weights
    # converted in place (as the serve launcher does), so no dense copy of
    # the weights stays alive beside the codes
    if resident:
        quantize_params(model, resident)
    eng = ServingEngine(cfg, model, **geo)
    routes = (eng.decode_route(), eng.prefill_route(), eng.weight_route())
    want = ("cuda-decode", "cuda-decode" if merged else "cuda-prefill",
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
            if k.__name__.endswith("_quant") == cfg.kv_quant
            and n_attn and not (merged and "prefill" in k.__name__)]
    if resident:
        path += [k.__name__ for k in AIO_KERNELS]
    path += list(also)
    st = eng.stats
    check(all(counts[n] > 0 for n in path),
          f"{label}: a kernel of the path never launched: {counts}")
    check(not any(counts[k.__name__] for k in PAGED_KERNELS),
          f"{label}: a paged kernel launched on the flat path: {counts}")
    if resident:
        # resident Linears a model call runs: each layer position's (a
        # shared block at each of its positions; the encoder ran once, at
        # the engine's construction)
        n_lin = sum(isinstance(m, Linear) and m.fmt is not None
                    for layer in model.layers for m in layer.modules())
        per_call = n_lin * st.model_calls
        check(counts["aio_matmul"] == counts["aio_quant"] == per_call,
              f"{label}: {counts} AIO launches, want {per_call} ({n_lin} "
              f"resident Linears a call x {st.model_calls} model calls)")
    if merged:
        others = {n: c for n, c in counts.items() if c and n not in path}
        check(st.prefill_chunk_calls == 0 and not others and (
            not path or counts[path[0]] == n_attn * st.model_calls),
            f"{label}: merged engine: {st.prefill_chunk_calls} chunk "
            f"launches; launches {counts}, want {path[:1]} x {n_attn} a "
            f"model call ({st.model_calls} model calls) and no other "
            "kernel but the path's")
        per_step = (f"merged: {st.model_calls} model calls "
                    f"({st.prefill_token_steps} prefill-only, "
                    f"{st.decode_steps} with a decoding row)"
                    + (f", {path[0]} {counts[path[0]] / st.model_calls:g} a "
                       "call" if path else ", no kernel launched"))
    else:
        per_step = (f"decode {counts[path[0]] / st.decode_steps:g}, prefill "
                    f"{counts[path[1]] / st.prefill_chunk_calls:g}")
    n_tok = st.generated_tokens
    print(f"  [{label}] routes {routes}; launches {counts}; per step: "
          + per_step
          + (f"; AIO GEMM and quantizer "
             f"{counts['aio_matmul'] / st.model_calls:g} each per model "
             f"call ({st.model_calls} model calls)" if resident else ""))
    print(f"  [{label}] free-running: {n_tok} tokens in {wall_s:.3f} s = "
          f"{n_tok / wall_s:.1f} tok/s; {len(chunk_ms)} "
          f"{'prefill-only' if merged else 'chunk'} steps "
          f"(median {np.median(chunk_ms):.2f} ms), {len(decode_ms)} "
          f"{'other' if merged else 'decode-only'} steps (median "
          f"{np.median(decode_ms):.2f} ms); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (weights, this "
          f"engine's caches and activations); {card}", flush=True)
    check_no_faults(f"{label} free-running", eng)
    served = tokens(eng)
    if audit:
        audit_engine(label, eng, prompts)
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


# 1000 and 800 cut to 500 and 400 for phase 3f's time, then halved for
# phase 7c (e)'s (5b keeps prompts of up to 1000 tokens); the new tokens
# (of phases 5, 5b, 5c, 5d and 5f's internvl2) cut from 32 for phase 7e's
MAX_NEW = 24
ENGINE_PLENS = [16, 250, 137, 256, 64, 200, 150, 33]


def engine_prompts(vocab):
    """Phase 5's mix: 8 prompts of 16..256 tokens (MAX_NEW new tokens
    each)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in ENGINE_PLENS]


# ------------------------------------------------- static analysis (3f)
BASELINE = ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"
HOTLOOP_STEPS = 3                  # live steps of each audited engine
# the engines' hot-loop reports, by label (phase 8 holds them to the
# baseline)
HOTLOOP = {}


def cuda_baseline() -> dict:
    with open(BASELINE) as f:
        return json.load(f).get("cuda", {})


def analysis_phase(card):
    """Phase 3f: every checker of `repro_torch.analysis` on the card.
    Returns its report and the drift of its counts from the baseline's
    cuda section."""
    phase("3f. static analysis on the card: kernel contracts, kernel bodies "
          "(redzones, profiled geometry, compute-sanitizer), the default "
          "hot-loop engines, the format matrix")
    t0 = time.perf_counter()
    rep = analysis.run_all()
    print(rep.render(), flush=True)
    counts = analysis.run.counts_by_code(rep)
    drift = analysis.compare_baseline(rep, cuda_baseline())
    print(f"  phase 3f: findings {counts}; against the baseline's cuda "
          f"section: {drift or 'no drift'}; "
          f"{time.perf_counter() - t0:.1f} s wall; {card}", flush=True)
    return rep, drift


def write_cuda_baseline(rep) -> None:
    """Rewrite the baseline's whole `cuda` section from this run: phase
    3f's counts and every audited engine's (`--write-baseline`)."""
    with open(BASELINE) as f:
        data = json.load(f)
    data["cuda"] = {
        "counts_by_code": analysis.run.counts_by_code(rep),
        "engines": {label: {"counts_by_code":
                            analysis.run.counts_by_code(r)}
                    for label, r in HOTLOOP.items()}}
    with open(BASELINE, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote the cuda section of {BASELINE}", flush=True)


def audit_engine(label, eng, prompts):
    """The hot-loop audit of a served engine: the idle step at each width,
    then HOTLOOP_STEPS live steps of two short requests."""
    t0 = time.perf_counter()
    rep = analysis.Report()
    submit_all(eng, [p[:24] for p in prompts[:2]], 4)
    hotloop.check_engine(eng, rep, label=label, live_steps=HOTLOOP_STEPS)
    HOTLOOP[label] = rep
    for f in rep.findings:
        print(f"  [{label}] {f.render()}", flush=True)
    print(f"  [{label}] hot-loop audit: "
          f"{analysis.run.counts_by_code(rep)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
        counts, served, free = run_variant(
            label, cfg, model, prompts, max_new, card, resident=resident,
            audit=resident in (None, "int4"))
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
    of PAGED_TAILS, each twice (MAX_NEW new tokens each)."""
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
                # the pool counters of the main pass alone, before the
                # audit's own requests and warmup add to them
                ps = eng.pool_stats()
                print(f"  [{label}] pool_stats {json.dumps(ps)}", flush=True)
                for n in path:
                    launches[n] += counts[n]
                if label == PAGED_VARIANTS[0][0]:
                    audit_engine(label, eng, prompts)
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
        and e.step_no >= 4)
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
DENSE_PLENS = [16, 500, 300, 64]   # 1000 cut to 500 for phase 3f's time
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
         None, (30,)),
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
                                   card, geo=geo, profile_at=profile_at,
                                   audit=bool(cfg.n_experts))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  [{label}] {time.perf_counter() - t0:.1f} s", flush=True)
        del model
        torch.cuda.empty_cache()
    print(f"  phase 5d: {time.perf_counter() - t_phase:.1f} s wall; {card}",
          flush=True)
    return launches


# --------------------------------------- recurrent and hybrid (5e)
# the merged engine makes one launch a token, so the longest prompt and
# the new tokens set the step count: 24 + 16 steps a pass (the mix 16-256
# took 463 s; cut to 4-48 and 32 new tokens, 80 steps, 190 s; cut again to
# make room for phase 5f, and the new tokens from 24 to 16 for phase 3f)
RECURRENT_PLENS = [4, 12, 24, 16, 8, 20, 6, 10]
RECURRENT_NEW = 16
# the decode kernel rows at D 80 keep the positions of the 4-48 mix
ZAMBA_ROW_POS = [4, 12, 24, 48, 8, 40, 16, 32]
RECURRENT_GEO = dict(slots=8, max_len=1024)
TEACHER_L = 256
TEACHER_TOL = 2e-3                 # the reference test's tolerance


def teacher_forced(label, cfg, model, dev, frames=None, tol=TEACHER_TOL):
    """`decode_step` token by token over TEACHER_L tokens (one row, f32
    caches) against `forward` on the same tokens: the step recurrence
    against the chunked one (and the decode kernel against B8) at full
    width; with `frames` (1, T, d_model), both cross-attend their encoding
    (`forward` encodes them, the steps take `encode`'s memory). Returns
    max |dlogit| / max |logit|, which must stay within `tol`."""
    rng = np.random.RandomState(11)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (1, TEACHER_L))).to(
        dev)
    ts = time.perf_counter()
    full, _ = forward(model, toks, frames=frames)
    memory = None if frames is None else encode(model, frames)
    caches = init_caches(cfg, 1, TEACHER_L, device=dev, dtype=torch.float32)
    worst = torch.zeros((), device=dev)
    for t in range(TEACHER_L):
        step, _ = decode_step(model, caches, toks[:, t:t + 1],
                              memory=memory)
        worst = torch.maximum(worst, (step[:, 0] - full[:, t]).abs().max())
    worst = worst.item()
    rel = worst / full.abs().max().item()
    print(f"  [{label}] teacher-forced decode_step over {TEACHER_L} tokens "
          f"(f32 caches) vs forward: max |dlogit| {worst:.3e} = {rel:.2e} "
          f"of max |logit| {full.abs().max().item():.3f} (bound "
          f"{tol}); {time.perf_counter() - ts:.1f} s", flush=True)
    check(rel <= tol, f"{label}: teacher-forced decode is {rel} of "
          f"max |logit| from forward, above {tol}")
    del full, caches
    torch.cuda.empty_cache()
    return rel


def zamba2_kernel_rows(dev, card):
    """B1, B2 and B8 at zamba2's head_dim of 80 (32 heads, MHA), the only
    served head_dim beside 64 and 128: held against the plain versions
    (max |diff| <= 1e-4; B2 bitwise equal to B1 on the dequantized K/V),
    then timed beside their plain versions, SDPA and their bounds. Decode:
    8 rows of one query over a 1024-position cache at positions 4-48
    (mid-stream positions of an earlier, longer mix); B8: one row of
    TEACHER_L tokens, the teacher-forced forward's shape. Returns the max
    |diff| per kernel."""
    cfg = get_config("zamba2_2p7b")
    h, d, lk = cfg.n_heads, cfg.hd, RECURRENT_GEO["max_len"]
    cases = [make_case(dev, 90 + i, b=RECURRENT_GEO["slots"], hq=h, hkv=h,
                       lq=1, lk=lk, pos=ZAMBA_ROW_POS, d=d)
             for i in range(3)]          # 3 x 84 MB of bf16 K/V: > 50 MB L2
    errs = {}
    for name in ("flash_decode", "flash_decode_quant"):
        kern, plain, deq = calls(name, cases[0], {})
        got = kern()
        err = (got - plain()).abs().max().item()
        check(err <= TOL, f"{name} at D={d}: max |diff| {err} above {TOL}")
        if deq is not None:
            check(torch.equal(got, deq()), f"{name} at D={d}: not bitwise "
                  "equal to flash_decode on the dequantized K/V")
        errs[name] = err
        ms = cuda_ms([calls(name, c, {})[0] for c in cases], 60)
        plain_ms = cuda_ms([calls(name, c, {})[1] for c in cases], 12)
        lib_ms = cuda_ms([library_call(name, c) for c in cases], 12)
        bound_ms, bound_by = bound(name, cases[0])
        print(f"  {name} B={RECURRENT_GEO['slots']} Hq=Hkv={h} D={d} "
              f"Lk={lk} at positions {ZAMBA_ROW_POS}: max|diff| "
              f"{err:.3e}; kernel {ms:.4f}  plain {plain_ms:.4f}  library "
              f"{lib_ms:.4f}  bound {bound_ms:.4f} ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it){decode_split_text(cases[0])}"
              f"; {card}", flush=True)
    del cases
    full = [full_case(dev, 95 + i, b=1, hq=h, hkv=h, lq=TEACHER_L,
                      lk=TEACHER_L, d=d) for i in range(8)]
    got = flash_attention(*full[0])
    err = (got - flash_attention_plain(*full[0])).abs().max().item()
    check(err <= TOL and not got.isnan().any(), f"flash_attention at D={d}: "
          f"max |diff| {err} above {TOL} or NaN")
    errs["flash_attention"] = err
    ms = cuda_ms([functools.partial(flash_attention, *c) for c in full], 40)
    plain_ms = cuda_ms([functools.partial(flash_attention_plain, *c)
                        for c in full], 10)
    lib_ms = cuda_ms([functools.partial(F.scaled_dot_product_attention, *c,
                                        is_causal=True) for c in full], 40)
    bound_ms, bound_by = full_bound(1, h, h, TEACHER_L, TEACHER_L, d, mmas=6)
    print(f"  flash_attention B=1 H={h} D={d} L={TEACHER_L} causal f32: "
          f"max|diff| {err:.3e}; kernel {ms:.4f}  plain {plain_ms:.4f}  SDPA "
          f"{lib_ms:.4f}  bound {bound_ms:.4f} ({bound_by}, MMA mix; "
          f"{100 * bound_ms / ms:.1f}% of it); {card}", flush=True)
    return errs


def recurrent_phase(dev, card):
    """Phase 5e: zamba2 (Mamba2 + one shared attention block) and xlstm
    (mLSTM / sLSTM) at full width and depth, served by the merged engine
    and checked as phase 5 checks its variants. Returns the launch counts
    of the kernels on their paths."""
    phase("5e. recurrent and hybrid: zamba2_2p7b CONFIG (bf16 KV, int8 KV, "
          "int4 resident) and xlstm_1p3b CONFIG at full width and depth, "
          "f32 weights (seed 0), 8 slots, max_len 1024, merged l=1 launches")
    t_phase = time.perf_counter()
    errs = zamba2_kernel_rows(dev, card)
    launches = {}
    cases = [("zamba2_2p7b", [("zamba2 bf16-KV", False, None, (16,)),
                              ("zamba2 int8-KV", True, None, ()),
                              ("zamba2 int4-resident", False, "int4", ())]),
             ("xlstm_1p3b", [("xlstm", False, None, (16,))])]
    for arch, variants in cases:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        kinds = cfg.block_kinds()
        heads = (f"{cfg.n_heads} heads of {cfg.hd}" if cfg.attn_every else
                 f"{cfg.n_heads} heads (mLSTM heads of {2 * cfg.hd}, a "
                 f"{2 * cfg.hd} x {2 * cfg.hd + 1} state each)")
        print(f"  [{arch}] {cfg.name}: {cfg.n_layers} layers ("
              + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(
                  kinds)) + f"), d_model {cfg.d_model}, {heads}, vocab "
              f"{cfg.vocab}; {n_params / 1e9:.3f} B f32 "
              f"params ({4 * n_params / 1e9:.1f} GB) in "
              f"{time.perf_counter() - t0:.1f}s; prompts {RECURRENT_PLENS}, "
              f"{RECURRENT_NEW} new tokens each", flush=True)
        teacher_forced(arch, cfg, model, dev)
        prompts = family_prompts(cfg.vocab, RECURRENT_PLENS, seed=3)
        for label, kv_quant, resident, profile_at in variants:
            t1 = time.perf_counter()
            vcfg = dataclasses.replace(cfg, kv_quant=kv_quant)
            counts, _, _ = run_variant(label, vcfg, model, prompts,
                                       RECURRENT_NEW,
                                       card, resident=resident,
                                       geo=RECURRENT_GEO,
                                       profile_at=profile_at,
                                       audit=label == "zamba2 bf16-KV")
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            print(f"  [{label}] {time.perf_counter() - t1:.1f} s",
                  flush=True)
        del model
        torch.cuda.empty_cache()
    print(f"  phase 5e: {time.perf_counter() - t_phase:.1f} s wall; {card}",
          flush=True)
    return launches, errs


# ------------------------------------------------ the frontends (5f)
# whisper-tiny: 8 slots, one random 1500-frame clip each; prompts of 4-64
# tokens (start-of-transcript tokens and earlier text), 32 new tokens each
# (64 until phase 3f needed the time)
WHISPER_PLENS = [4, 12, 24, 64, 8, 40, 16, 32]
WHISPER_NEW = 32
WHISPER_GEO = dict(slots=8, max_len=1024, prefill_chunk=W)
WHISPER_TOL = 1e-3                 # teacher-forced max |dlogit| / max|logit|
INTERNVL_LAYERS = 4                # of 80: 3.4 B f32 parameters in them
PATCHES = 1024                     # internvl2's patch embeddings a sample


def frontend_kernel_rows(dev, card):
    """The kernels at the frontend families' new shapes, each held against
    its plain version, then timed beside it, its library call and its
    bound: B8 non-causal at whisper's cross attention of a 256-token
    forward (B 1, H 6, Lq 256, Lk 1500, D 64); B10 then B5 in int4 at
    whisper's resident cross k/v projection of 8 slots x 1500 frames (M
    12,000, K = N = 384) and at internvl2's down projection in a decode
    step (M 8, K 28,672, N 8192). Returns the max |diff| per kernel."""
    wcfg = get_config("whisper_tiny")
    h, d, t = wcfg.n_heads, wcfg.hd, wcfg.frontend_len
    full = [full_case(dev, 97 + i, b=1, hq=h, hkv=h, lq=TEACHER_L, lk=t, d=d)
            for i in range(8)]
    got = flash_attention(*full[0], causal=False)
    err = (got - flash_attention_plain(*full[0], causal=False)).abs().max()
    err = err.item()
    check(err <= TOL and not got.isnan().any(), f"flash_attention "
          f"non-causal at Lk {t}: max |diff| {err} above {TOL} or NaN")
    errs = {"flash_attention": err}
    ms = cuda_ms([functools.partial(flash_attention, *c, causal=False)
                  for c in full], 40)
    plain_ms = cuda_ms([functools.partial(flash_attention_plain, *c,
                                          causal=False) for c in full], 10)
    lib_ms = cuda_ms([functools.partial(F.scaled_dot_product_attention, *c)
                      for c in full], 40)
    bound_ms, bound_by = full_bound(1, h, h, TEACHER_L, t, d, mmas=6,
                                    causal=False)
    print(f"  flash_attention B=1 H={h} D={d} Lq={TEACHER_L} Lk={t} "
          f"non-causal f32: max|diff| {err:.3e}; kernel {ms:.4f}  plain "
          f"{plain_ms:.4f}  SDPA {lib_ms:.4f}  bound {bound_ms:.4f} "
          f"({bound_by}, MMA mix; {100 * bound_ms / ms:.1f}% of it); {card}",
          flush=True)
    del full
    vcfg = get_config("internvl2_76b")
    shapes = [("whisper cross k/v, 8 slots x 1500 frames",
               WHISPER_GEO["slots"] * t, wcfg.d_model, wcfg.d_model),
              ("internvl2 down projection, 8 rows", 8, vcfg.d_ff,
               vcfg.d_model)]
    errs["aio_matmul"] = errs["aio_quant"] = 0.0
    for name, m, k, n in shapes:
        g = torch.Generator(device=dev).manual_seed(m + k)
        x = torch.randn(m, k, generator=g, device=dev)
        codes, scale = aio_quant(x, fmt_name="int4", floor=FM.FLT_MIN)
        want = aio_quant_plain(x, fmt_name="int4", floor=FM.FLT_MIN)
        check(torch.equal(codes, want[0]) and torch.equal(scale, want[1]),
              f"aio_quant int4 M={m} N={k}: codes or scales differ from "
              "the plain version")
        _, w, _, ws = gemm_case(dev, "int4", 8, k, n, seed=k + n)
        got = aio_matmul(codes, w, scale, ws, mode="int4")
        check(torch.equal(got, aio_matmul_plain(codes, w, scale, ws,
                                                mode="int4")),
              f"aio_matmul int4 M={m} K={k} N={n}: not bitwise equal to "
              "the plain version")
        del got, x
        # operand copies past the 50 MB L2 (x and w together)
        n_copies = max(2, -(-100_000_000 // (m * k + (k + 1) // 2 * n)))
        copies = [(torch.randint(-8, 8, (m, k), generator=g, device=dev,
                                 dtype=torch.int8),
                   torch.randint(-128, 128, ((k + 1) // 2, n), generator=g,
                                 device=dev, dtype=torch.int8),
                   torch.full((m, 1), 2.0 ** -7, device=dev),
                   torch.full((1, n), 2.0 ** -7, device=dev))
                  for _ in range(n_copies)]
        ms = cuda_ms([functools.partial(aio_matmul, *c, mode="int4")
                      for c in copies], 20)
        plain_ms = cuda_ms([functools.partial(aio_matmul_plain, *c,
                                              mode="int4")
                            for c in copies], 4)
        dec = [decoded_bf16("int4", c[0], c[1]) for c in copies]
        lib_ms = cuda_ms([functools.partial(torch.matmul, *dd)
                          for dd in dec], 20)
        lib_txt = f"matmul(bf16) {lib_ms:.4f}"
        if m > 16:
            ints = [(dd[0].to(torch.int8), dd[1].to(torch.int8))
                    for dd in dec]
            int_ms = cuda_ms([functools.partial(torch._int_mm, *i)
                              for i in ints], 20)
            lib_txt += f"  _int_mm {int_ms:.4f}"
            del ints
        bound_ms, bound_by = gemm_bound("int4", m, k, n)
        print(f"  aio_matmul int4 M={m} K={k} N={n} ({name}): bitwise; "
              f"kernel {ms:.4f}  plain {plain_ms:.4f}  {lib_txt}  bound "
              f"{bound_ms:.5f} ({bound_by}; {100 * bound_ms / ms:.1f}% of "
              f"it); {card}", flush=True)
        del copies, dec
        xs = quant_timing_copies(dev, m, k)
        ms = cuda_ms([functools.partial(aio_quant, x_, fmt_name="int4",
                                        floor=FM.FLT_MIN) for x_ in xs], 40)
        plain_ms = cuda_ms([functools.partial(aio_quant_plain, x_,
                                              fmt_name="int4",
                                              floor=FM.FLT_MIN)
                            for x_ in xs], 6)
        t_bytes = (5 * m * k + 4 * m) / HBM_BYTES_PER_S
        t_ops = 2 * m * k / F32_FLOPS_PER_S
        qbound = 1e3 * max(t_bytes, t_ops)
        p = quant_plan(m, k)
        print(f"  aio_quant  int4 M={m} N={k}: bitwise; kernel {ms:.4f}  "
              f"plain {plain_ms:.4f}  library none  bound {qbound:.5f} "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{100 * qbound / ms:.1f}% of it; 8 input copies)  plan "
              f"cluster {p.cluster} x {p.threads} threads x {p.vals} "
              f"values; {card}", flush=True)
        del xs
    torch.cuda.empty_cache()
    return errs


def whisper_part(dev, card, launches):
    """Phase 5f (a): whisper-tiny CONFIG at full width and depth."""
    cfg = get_config("whisper_tiny")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn(WHISPER_GEO["slots"], cfg.frontend_len,
                         cfg.d_model, generator=g, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  [whisper_tiny] {cfg.name}: {cfg.encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.frontend_len} frames a slot; "
          f"{n_params / 1e6:.1f} M f32 params in "
          f"{time.perf_counter() - t0:.1f}s; prompts {WHISPER_PLENS}, "
          f"{WHISPER_NEW} new tokens each", flush=True)
    try:
        ServingEngine(cfg, model, frames=frames, paged=True, **WHISPER_GEO)
        refused = None
    except ValueError as err:
        refused = str(err)
    check(refused is not None and "ROADMAP C" in refused,
          f"whisper: the paged engine was not refused naming ROADMAP C "
          f"({refused})")
    print(f"  [whisper_tiny] paged engine refused: {refused}", flush=True)
    before = flash_attention.launches
    teacher_forced("whisper_tiny", cfg, model, dev, frames=frames[:1],
                   tol=WHISPER_TOL)
    n_full = flash_attention.launches - before
    check(n_full == 2 * cfg.n_layers, f"whisper forward at L {TEACHER_L}: "
          f"{n_full} B8 launches, want {2 * cfg.n_layers} (causal self and "
          "non-causal cross attention a decoder layer)")
    prompts = family_prompts(cfg.vocab, WHISPER_PLENS, seed=4)
    geo = dict(WHISPER_GEO, frames=frames)
    # the resident variant last: it converts the weights in place
    variants = [("whisper bf16-KV", False, None, geo, (), (10,)),
                ("whisper int8-KV", True, None, geo, (), ()),
                ("whisper bf16-KV chunk 128", False, None,
                 dict(geo, prefill_chunk=128), ("flash_attention",), ()),
                ("whisper int4-resident", False, "int4", geo, (), (10,))]
    for label, kv_quant, resident, vgeo, also, profile_at in variants:
        t1 = time.perf_counter()
        vcfg = dataclasses.replace(cfg, kv_quant=kv_quant)
        counts, _, _ = run_variant(label, vcfg, model, prompts, WHISPER_NEW,
                                   card, resident=resident, geo=vgeo,
                                   profile_at=profile_at, also=also)
        if also:
            # the cross attention of each decoder layer in each chunk launch
            n_full = counts["flash_attention"]
            check(n_full % cfg.n_layers == 0, f"{label}: {n_full} B8 "
                  f"launches, not a multiple of {cfg.n_layers} layers")
            print(f"  [{label}] cross attention on B8 in "
                  f"{n_full // cfg.n_layers} chunk launches "
                  f"({cfg.n_layers} a launch)", flush=True)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  [{label}] {time.perf_counter() - t1:.1f} s", flush=True)
    del model, frames
    torch.cuda.empty_cache()


def internvl_part(dev, card, launches):
    """Phase 5f (b): internvl2-76b CONFIG over INTERNVL_LAYERS layers."""
    cfg = dataclasses.replace(get_config("internvl2_76b"),
                              n_layers=INTERNVL_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    prompts = family_prompts(cfg.vocab, DENSE_PLENS, seed=2)
    print(f"  [internvl2 x{INTERNVL_LAYERS}] {cfg.name}: {cfg.n_layers} of "
          f"80 layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; {n_params / 1e9:.3f} B f32 params "
          f"({4 * n_params / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}"
          f"s; prompts {DENSE_PLENS}, {MAX_NEW} new tokens each",
          flush=True)
    label = f"internvl2 x{INTERNVL_LAYERS}"
    counts, _, _ = run_variant(label, cfg, model, prompts, MAX_NEW, card,
                               geo=DENSE_GEO, profile_at=(45,))
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    # scoring with the patch embeddings prepended: 2048 positions, every
    # layer's attention on B8; against the ref route
    g = torch.Generator(device=dev).manual_seed(1)
    patches = torch.randn(1, PATCHES, cfg.d_model, generator=g, device=dev)
    rng = np.random.RandomState(12)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (1, PATCHES))).to(dev)
    route = api.ops.attention_route(lq=2 * PATCHES, lk=2 * PATCHES)
    check(route == "cuda", f"internvl2 forward routes to {route}")
    before = flash_attention.launches
    ts = time.perf_counter()
    logits, _ = forward(model, toks, prefix_embeds=patches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    n_full = flash_attention.launches - before
    check(n_full == cfg.n_layers, f"{label} forward: {n_full} B8 launches, "
          f"want {cfg.n_layers}")
    check(logits.shape == (1, PATCHES, cfg.vocab), f"{label} forward: "
          f"logits {tuple(logits.shape)}, want the tokens' positions only")
    with api.policy(backend="ref"):
        ref_logits, _ = forward(model, toks, prefix_embeds=patches)
    torch.cuda.synchronize()
    check(flash_attention.launches == before + n_full,
          "the ref route launched B8")
    diff = (logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    print(f"  [{label}] forward over {PATCHES} patch embeddings + {PATCHES} "
          f"tokens: {1e3 * wall:.1f} ms wall, B8 {n_full} launches; vs the "
          f"ref route max|dlogit| {diff:.3e} ({diff / scale:.2e} of "
          f"max|logit| {scale:.2f}); {card}", flush=True)
    check(finite and diff <= LOGIT_TOL * scale, f"{label} forward: max "
          f"|dlogit| {diff} above {LOGIT_TOL} x {scale} (or not finite)")
    launches["flash_attention"] = launches.get("flash_attention", 0) + n_full
    del model, logits, ref_logits
    torch.cuda.empty_cache()


def frontends_phase(dev, card):
    """Phase 5f: the frontend families, whisper-tiny (audio encoder and
    cross attention) at full width and depth and internvl2-76b over
    INTERNVL_LAYERS layers (patch embeddings prepended), served by the
    kernel engine and checked as phase 5 checks its variants, then their
    kernels at the new shapes. Returns the launch counts of the kernels on
    their paths and the max |diff| of the kernel rows."""
    phase("5f. frontends: whisper_tiny CONFIG (bf16 KV, int8 KV, chunk "
          "128, int4 resident; 8 slots, 1500 frames a slot) and "
          f"internvl2_76b CONFIG over {INTERNVL_LAYERS} layers; f32 weights "
          "(seed 0)")
    t_phase = time.perf_counter()
    launches = {}
    whisper_part(dev, card, launches)
    internvl_part(dev, card, launches)
    errs = frontend_kernel_rows(dev, card)
    print(f"  phase 5f: {time.perf_counter() - t_phase:.1f} s wall; {card}",
          flush=True)
    return launches, errs


# ---------------------------------------------- multi-tenant serving (5g)
# the serve launcher's two tenants (captioning olmoe_1b_7b, classification
# qwen2_1p5b) at full width and depth, seeds 0 and 1, Linears resident in
# int8 (olmoe's experts dense, as in the reference)
TENANT_FORMAT = "int8"
TENANT_GEO = dict(slots=4, max_len=256, prefill_chunk=W)
TENANT_PLENS = [16, 200, 64, 137, 33, 180, 90, 24]
TENANT_NEW = 16                    # 32 until phase 3f needed the time
TENANT_OCC_STEP = 8                # decode steps before the mid-flight read
TENANT_PROFILE_STEP = 12           # profile a decode-only step from here
TENANT_KERNELS = (flash_decode, flash_prefill, aio_matmul, aio_quant)


class TenantEngine(CodeEngine, RouteEngine):
    """An MoE tenant's checked engine: its resident Linears' codes
    followed as `CodeEngine` follows them, its expert dispatch as
    `RouteEngine` follows it."""


def occupancy_text(sched) -> str:
    cells = {name: " ".join("--" if o is None else
                            f"r{o['rid']}+{o['generated']}" for o in occ)
             for name, occ in sched.occupancy().items()}
    util = sched.utilization()
    return "; ".join(f"{name} [{cells[name]}] util {util[name]:.2f}"
                     for name in cells)


def tenant_launches(fn, *args):
    """fn(*args) and the launches of the tenant kernels it made, counted
    as differences (the counters are module-global)."""
    before = {k.__name__: k.launches for k in TENANT_KERNELS}
    out = fn(*args)
    return out, {k.__name__: k.launches - before[k.__name__]
                 for k in TENANT_KERNELS}


def serve_tenant(sched, name, eng, prompts, max_new):
    """The launcher's loop for one tenant: submit, then step until it
    drains, reading the scheduler's occupancy once mid-flight. Returns
    (wall s, chunk-step ms, decode-step ms, the mid-flight reading)."""
    submit_all(eng, prompts, max_new)
    chunk_ms, decode_ms, seen = [], [], None
    t0 = time.perf_counter()
    while eng.pending():
        calls = prefill_calls(eng)
        ts = time.perf_counter()
        eng.step()
        dt = 1e3 * (time.perf_counter() - ts)
        (chunk_ms if prefill_calls(eng) > calls else decode_ms).append(dt)
        if seen is None and eng.stats.decode_steps >= TENANT_OCC_STEP:
            seen = (occupancy_text(sched), sched.utilization())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, chunk_ms, decode_ms, seen


def drive_lockstep(eng, shadow, prompts, max_new):
    """`shadow` put in eng's state before every step, then the same step."""
    submit_all(eng, prompts, max_new)
    submit_all(shadow, prompts, max_new)
    while eng.pending():
        copy_state(shadow, eng)
        eng.step()
        shadow.step()
    check(not shadow.pending(), "a lockstep engine did not drain in step")


def tenancy_phase(dev, card):
    """Phase 5g: the multi-tenant path. Returns the launch counts of the
    tenant kernels over the launcher-order pass (the main path)."""
    phase(f"5g. multi-tenant: MorphableScheduler() on the card's grid, "
          f"olmoe_1b_7b (captioning) and qwen2_1p5b (classification) "
          f"CONFIG at full width and depth, Linears resident in "
          f"{TENANT_FORMAT}; 4 slots, max_len 256, chunk 32, 8 requests a "
          f"tenant, {TENANT_NEW} new tokens")
    t_phase = time.perf_counter()
    sched = MorphableScheduler()
    parts = sched.reconfigure([
        Tenant(name, weight_rows=rows, weight_cols=cols, fmt=TENANT_FORMAT)
        for name, _, rows, cols in serve_launcher.TENANTS])
    names = tuple(name for name, *_ in serve_launcher.TENANTS)
    check(sched.plan.describe() == "128x128" and len(parts) == 1
          and parts[0].tenants == names
          and parts[0].mesh.devices.shape == (1, 1),
          f"one card: want the fused 128x128 plan with both tenants in one "
          f"partition, got {sched.plan.describe()} {parts}")
    print(f"  fusion plan {sched.plan.describe()}; partitions "
          f"{[(p.tenants, p.mesh.devices.shape) for p in parts]} on "
          f"{parts[0].mesh.first()}", flush=True)

    # the launcher's order: both models and engines built, engines attached
    tenants = {}
    for seed, (name, arch, *_) in enumerate(serve_launcher.TENANTS):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = init_params(cfg, seed=seed, device=dev)
        quantize_params(model, TENANT_FORMAT)
        eng = ServingEngine(cfg, model, **TENANT_GEO)
        routes = (eng.decode_route(), eng.prefill_route(), eng.weight_route())
        want = ("cuda-decode", "cuda-prefill", f"resident-{TENANT_FORMAT}")
        check(routes == want, f"{name}: routes {routes}, want {want}")
        eng.warmup()
        sched.attach_engine(name, eng)
        n_lin = sum(isinstance(m, Linear) and m.fmt is not None
                    for layer in model.layers for m in layer.modules())
        torch.cuda.synchronize()
        print(f"  [{name}] {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}"
              + (f", {cfg.n_experts} experts top {cfg.top_k} (dense)"
                 if cfg.n_experts else "")
              + f"; {n_lin} resident Linears; built in "
              f"{time.perf_counter() - t0:.1f}s; routes {routes}",
              flush=True)
        tenants[name] = dict(cfg=cfg, model=model, eng=eng, n_lin=n_lin,
                             prompts=family_prompts(cfg.vocab, TENANT_PLENS,
                                                    seed=3 + seed))
    mem = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ALL_KERNELS:
        k.launches = 0
    served = {}
    for name, t in tenants.items():
        (wall, chunk_ms, decode_ms, seen), counts = tenant_launches(
            sched.run, name, serve_tenant, sched, name, t["eng"],
            t["prompts"], TENANT_NEW)
        st = t["eng"].stats
        t["counts"] = counts
        check(all(counts.values()), f"{name}: a kernel of the path never "
              f"launched: {counts}")
        per_call = t["n_lin"] * st.model_calls
        check(counts["aio_matmul"] == counts["aio_quant"] == per_call,
              f"{name}: {counts} AIO launches, want {per_call}")
        others = [k for k, u in seen[1].items() if k != name]
        check(seen[1][name] > 0 and all(seen[1][k] == 0 for k in others),
              f"{name}: mid-flight utilization {seen[1]}")
        check_no_faults(name, t["eng"])
        served[name] = tokens(t["eng"])
        n_tok = st.generated_tokens
        print(f"  [{name}] sched.run: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tok/s; {len(chunk_ms)} chunk steps "
              f"(median {np.median(chunk_ms):.2f} ms), {len(decode_ms)} "
              f"decode-only steps (median {np.median(decode_ms):.2f} ms); "
              f"launches {counts} ({t['n_lin']} AIO pairs a model call x "
              f"{st.model_calls}); mid-flight: {seen[0]}", flush=True)
    launches = {k.__name__: k.launches for k in TENANT_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f"  both tenants resident: {mem / 2**30:.2f} GiB allocated before "
          f"serving, max_memory_allocated {peak / 2**30:.2f} GiB; final "
          f"occupancy: {occupancy_text(sched)}; {card}", flush=True)

    t_part = time.perf_counter()
    print(f"  launcher order: {t_part - t_phase:.1f} s", flush=True)

    # each tenant in lockstep against the plain quantizer and GEMM
    for name, t in tenants.items():
        cfg, model = t["cfg"], t["model"]
        cls = TenantEngine if cfg.n_experts else CodeEngine
        eng = cls(cfg, model, gemm=KERNEL_GEMM, **TENANT_GEO)
        shadow = cls(cfg, model, gemm=PLAIN_GEMM, follow=eng, **TENANT_GEO)
        sched.run(name, drive_lockstep, eng, shadow, t["prompts"],
                  TENANT_NEW)
        check_no_faults(f"{name} lockstep", eng, shadow)
        got = tokens(eng)
        check(got == served[name], f"{name}: the checked pass's tokens "
              "differ from the launcher-order pass's")
        compared, skipped, bad = compare(name, got, shadow)
        check(bad is None, f"lockstep: {bad}")
        same, bad_rows, first = (int(shadow.rows_same),
                                 int(shadow.rows_bad),
                                 int(shadow.first_differ))
        check(bad_rows == 0 and first == 0 and same > 0,
              f"{name}: lockstep quantizer check: {bad_rows} of {same} rows "
              f"with bitwise equal inputs got other codes; {first} rows of "
              "the steps' first calls had unequal inputs")
        if cfg.n_experts:
            # the two engines differ only by the GEMM's and quantizer's
            # implementations, bitwise equal in int8: the same dispatch
            ids, keep, seen = (int(shadow.ids_differ),
                               int(shadow.keep_differ),
                               int(shadow.valid_seen))
            check(seen > 0 and ids <= seen // 100, f"{name}: the lockstep "
                  f"engine's own experts differed on {ids} of {seen} valid "
                  "token-layers")
            print(f"  [{name}] lockstep dispatch: the plain-GEMM engine's own "
                  f"experts differed on {ids}, its kept assignments on "
                  f"{keep}, of {seen} valid token-layers", flush=True)
        print(f"  [{name}] lockstep vs the plain quantizer and GEMM: "
              f"{compared} tokens match, {skipped} near-tie step(s) "
              f"skipped; {same} of {shadow.rows_seen} activation rows had "
              "bitwise equal inputs, each given the kernel's codes and "
              "scale by the plain quantizer", flush=True)
        del eng, shadow
    torch.cuda.empty_cache()
    print(f"  lockstep: {time.perf_counter() - t_part:.1f} s", flush=True)
    t_part = time.perf_counter()

    # interleaved: fresh engines, both tenants pending, steps alternating
    fresh = {}
    for name, t in tenants.items():
        eng = ServingEngine(t["cfg"], t["model"], **TENANT_GEO)
        submit_all(eng, t["prompts"], TENANT_NEW)
        sched.attach_engine(name, eng)
        fresh[name] = dict(eng=eng, counts=dict.fromkeys(
            (k.__name__ for k in TENANT_KERNELS), 0), profile=None)
    both_busy, steps = None, 0
    while any(f["eng"].pending() for f in fresh.values()):
        for name, f in fresh.items():
            eng = f["eng"]
            if not eng.pending():
                continue
            decode_only = (steps >= TENANT_PROFILE_STEP and not eng.queue
                           and not eng._prefilling.any())
            calls = prefill_calls(eng)
            if f["profile"] is None and decode_only:
                text, counts = tenant_launches(sched.run, name, profiled,
                                               eng.step)
                if prefill_calls(eng) == calls:
                    f["profile"] = (steps, int(eng._occupied().sum()), text)
            else:
                _, counts = tenant_launches(sched.run, name, eng.step)
            for k, n in counts.items():
                f["counts"][k] += n
        steps += 1
        util = sched.utilization()
        if both_busy is None and all(u > 0 for u in util.values()):
            both_busy = occupancy_text(sched)
    check(both_busy is not None, "interleaved: the two tenants were never "
          "busy at once")
    for name, f in fresh.items():
        check_no_faults(f"{name} interleaved", f["eng"])
        check(tokens(f["eng"]) == served[name], f"{name}: interleaved "
              "tokens differ from the tenant served alone")
        check(f["counts"] == tenants[name]["counts"], f"{name}: "
              f"interleaved launches {f['counts']}, alone "
              f"{tenants[name]['counts']}")
        if f["profile"] is not None:
            step, rows, text = f["profile"]
            print(f"  [{name}] profile of interleaved step {step} (decode "
                  f"only, {rows} rows): {text}", flush=True)
    print(f"  interleaved ({steps} rounds, {time.perf_counter() - t_part:.1f}"
          " s): every token of both tenants bitwise equal to the tenant "
          f"served alone, the same launches; both busy: {both_busy}",
          flush=True)
    t_part = time.perf_counter()
    del tenants, fresh, sched
    torch.cuda.empty_cache()

    # the launcher itself: --multi-tenant (SMOKE tenants), then one
    # single-tenant run with the format and backend flags
    done = serve_launcher.main(["--multi-tenant", "--requests", "2",
                                "--max-new", "4"])
    check(sorted(done) == sorted(names) and all(
        len(reqs) == 2 and all(len(r.out_tokens) == 4 for r in reqs)
        for reqs in done.values()), f"launcher --multi-tenant: {done}")
    done = serve_launcher.main(["--format", TENANT_FORMAT, "--backend",
                                "ref", "--requests", "2", "--max-new", "4"])
    check(len(done) == 2 and all(len(r.out_tokens) == 4 for r in done)
          and not any(k.launches for k in serve_launcher.KERNELS),
          "launcher --format int8 --backend ref: 2 requests of 4 tokens, "
          "and no kernel launch on the ref route")
    torch.cuda.empty_cache()
    print(f"  launcher runs: {time.perf_counter() - t_part:.1f} s", flush=True)
    print(f"  phase 5g: {time.perf_counter() - t_phase:.1f} s wall; {card}",
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


def full_bound(b, hq, hkv, lq, lk, d, es=4, mmas=None, causal=True):
    """Least time (ms) of full-sequence attention (causal: query i at
    position i): the f32 flops of the kept (query, key) pairs over the f32
    CUDA-core rate (the rate B3's row uses), against q, k, v read once and
    the output written once over the memory rate. With `mmas`, the same
    work at the kernel's own instruction mix instead: each f32 product as
    that many bf16 tensor-core MMAs on three-term operands (6 for f32 K/V,
    3 for bf16) over the bf16 tensor rate."""
    pairs = b * hq * (sum(min(i + 1, lk) for i in range(lq)) if causal
                      else lq * lk)
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


TRAIN_ARCH = "olmo_1b"
TRAIN_B, TRAIN_L, TRAIN_STEPS = 4, 512, 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
GRAD_DEPTH, GRAD_B, GRAD_L = 2, 2, 128   # (b): card against the CPU
GRAD_TOL = 1e-4                    # of each leaf's max |g| on the CPU
SERVE_B, SERVE_PLEN, SERVE_NEW, SERVE_MAX_LEN = 4, 64, 32, 128
RESUME_STEPS, RESUME_AT = 8, 4     # (d), on the SMOKE config
FP8_ARCH, FP8_LAYERS, FP8_STEPS = "qwen2_1p5b", 4, 20
FP8_B, FP8_L, FP8_LR = 8, 64, 2e-3
TRAIN_DIR = ROOT / "build" / "train_ckpt"


def reset_launches():
    for k in ALL_KERNELS:
        k.launches = 0


def launched():
    return {k.__name__: k.launches for k in ALL_KERNELS if k.launches}


def batch_on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def route_log():
    """A stand-in for api.ops.attention_route that records each route."""
    real = api.ops.attention_route
    routes = []

    def spy(**kw):
        routes.append(real(**kw))
        return routes[-1]
    return spy, routes


def train_full(dev, card):
    """(a) the full-width olmo-1b CONFIG trained 10 steps by the Trainer;
    returns the trainer."""
    cfg = get_config(TRAIN_ARCH)
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(TRAIN_DIR / "full"),
                                    ckpt_every=10**9, base_lr=TRAIN_LR,
                                    warmup=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS),
                 seed=0, device=dev)
    n_params = sum(p.numel() for p in tr.model.parameters())
    data = iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=TRAIN_B,
                                       seq=TRAIN_L, seed=5)))
    check(api.ops.attention_route(lq=TRAIN_L, lk=TRAIN_L) == "cuda"
          and api.ops.attention_route(lq=TRAIN_L, lk=TRAIN_L, grad=True)
          == "ref", "the route rule: kernel-eligible without grad, ref with")
    spy, routes = route_log()
    reset_launches()
    before = [p.detach().clone() for p in tr.model.parameters()]
    with patched(api.ops, "attention_route", spy):
        tr.run(data, 1)
        torch.cuda.synchronize()
        check(all(torch.equal(p, q) for p, q in
                  zip(tr.model.parameters(), before)),
              "step 1 (lr 0) changed a parameter")
        del before
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr.run(data, TRAIN_STEPS - 2)
        prof = profiled(lambda: tr.run(data, 1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_launched = launched()
    check(not n_launched, f"a kernel launched inside the train steps: "
          f"{n_launched}")
    # remat: the backward recomputes each layer's forward, attention too
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    check(len(routes) == TRAIN_STEPS * per_step
          and set(routes) == {"ref"}, f"attention routes under grad: "
          f"{sorted(set(routes))} x{len(routes)}, want ref "
          f"x{TRAIN_STEPS * per_step}")
    log = tr.metrics_log
    losses = [m["loss"] for m in log]
    check(len(log) == TRAIN_STEPS and all(
        np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log),
        f"non-finite loss or grad norm: {log}")
    ms = 1e3 * float(np.median([m["step_time_s"] for m in log[1:-1]]))
    q = torch.randn(1, 4, 128, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 4, 128, 64, device=dev)
    try:
        flash_attention(q, kv, kv)
        refused = False
    except RuntimeError as e:
        refused = "forward-only" in str(e)
    check(refused, "B8 took a query that requires grad under grad mode")
    print(f"  (a) {cfg.name} CONFIG ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params:,} "
          f"f32 parameters): {TRAIN_STEPS} Trainer steps at {TRAIN_B} x "
          f"{TRAIN_L} tokens, base_lr {TRAIN_LR}, warmup {TRAIN_WARMUP}",
          flush=True)
    norms = [round(m["grad_norm"], 3) for m in log]
    lrs = [float(f"{m['lr']:.3g}") for m in log]
    print(f"      losses {[round(x, 4) for x in losses]}; grad norms "
          f"{norms}; lr {lrs}", flush=True)
    print(f"      step 1 (lr 0) left every parameter bitwise unchanged; "
          f"attention route under grad: ref x{len(routes)} (remat "
          f"{cfg.remat}: {per_step} a step; no kernel "
          f"launched in the steps, B8 0 times though L = {TRAIN_L} is "
          f"128-aligned); a direct B8 call on a query that requires grad "
          f"raises", flush=True)
    print(f"      step median {ms:.1f} ms = {TRAIN_B * TRAIN_L / ms * 1e3:.0f}"
          f" tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB "
          f"(steps 2-{TRAIN_STEPS}); {card}", flush=True)
    print(f"      profile of step {TRAIN_STEPS}: {prof}", flush=True)
    return tr


def train_one_batch(dev):
    """(a') the same Trainer and first batch, that batch fed at every step:
    step 10's loss must be below step 2's. (On the stream the loss stays
    within its batch-to-batch spread over 10 steps at this width: the
    successor rule over 50,304 tokens is not learnt from 20,480 tokens.)"""
    cfg = get_config(TRAIN_ARCH)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(TRAIN_DIR / "one"),
                                    ckpt_every=10**9, base_lr=TRAIN_LR,
                                    warmup=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS),
                 seed=0, device=dev)
    batch = next(iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=TRAIN_B,
                                             seq=TRAIN_L, seed=5))))
    reset_launches()
    tr.run(iter([batch] * TRAIN_STEPS), TRAIN_STEPS)
    torch.cuda.synchronize()
    check(not launched(), f"a kernel launched in training: {launched()}")
    losses = [m["loss"] for m in tr.metrics_log]
    check(all(np.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    print(f"  (a') the same Trainer on its first batch at every step: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    check(losses[-1] < losses[1], f"step {TRAIN_STEPS}'s loss "
          f"{losses[-1]} is not below step 2's {losses[1]}")
    del tr
    torch.cuda.empty_cache()


def grads_card_vs_cpu(dev, card):
    """(b) the full widths at depth 2: one batch's gradient on the card
    against the CPU's, leaf by leaf."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=GRAD_DEPTH)
    cpu = init_params(cfg, seed=0, device="cpu")
    on_card = params_from_jax(params_to_jax(cpu), cfg, device=dev)
    batch = next(iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=GRAD_B,
                                             seq=GRAD_L, seed=6))))
    reset_launches()
    losses = []
    for m, d in ((cpu, torch.device("cpu")), (on_card, dev)):
        loss, _ = loss_fn(m.trainable_(), batch_on(batch, d))
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    check(not launched(), f"a kernel launched in the backward: {launched()}")
    worst, where = 0.0, None
    flat = [jax_layout_leaves(grads_to_jax(m)) for m in (cpu, on_card)]
    for (path, gc), (_, gd) in zip(*flat):
        rel = float(np.abs(gd - gc).max()) / max(float(np.abs(gc).max()),
                                                 1e-30)
        if rel > worst:
            worst, where = rel, path
    check(worst <= GRAD_TOL, f"card gradient of {where} is {worst:.2e} of "
          f"the leaf's max |g| from the CPU's")
    rel_loss = abs(losses[1] - losses[0]) / abs(losses[0])
    print(f"  (b) depth {GRAD_DEPTH} at full width, {GRAD_B} x {GRAD_L} "
          f"tokens: loss {losses[1]:.6f} on the card vs {losses[0]:.6f} on "
          f"the CPU (relative {rel_loss:.2e}); every leaf's gradient within "
          f"{worst:.2e} of its max |g| (limit {GRAD_TOL}; worst {where})",
          flush=True)


def jax_layout_leaves(tree, path=""):
    """[(path, leaf)] of a `bridge.params_to_jax`-shaped tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in jax_layout_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in jax_layout_leaves(t, f"{path}/{i}")]
    return [(path, tree)]


@torch.no_grad()
def trained_on_kernels(dev, model):
    """(c) the trained model's no-grad loss and prefill on B8 and its
    serve step on B1, against the ref route. Returns the launches."""
    cfg = model.cfg
    counts = {}
    batch = batch_on(next(iter(SyntheticLM(DataConfig(
        vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_L, seed=7)))), dev)
    prefill = make_prefill_step(cfg)
    reset_launches()
    loss, _ = loss_fn(model, batch)
    torch.cuda.synchronize()
    check(flash_attention.launches == cfg.n_layers and len(launched()) == 1,
          f"no-grad loss_fn launches: {launched()}, want B8 x{cfg.n_layers}")
    nxt = prefill(model, batch)
    torch.cuda.synchronize()
    counts["flash_attention"] = flash_attention.launches
    check(flash_attention.launches == 2 * cfg.n_layers,
          f"the prefill step launched B8 {flash_attention.launches} times")
    with api.policy(backend="ref"):
        ref_loss, _ = loss_fn(model, batch)
        ref_nxt = prefill(model, batch)
        top2 = forward(model, batch["tokens"])[0][:, -1].topk(2, -1).values
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(rel <= LOSS_TOL, f"trained model's loss on B8 {loss.item()} vs "
          f"ref {ref_loss.item()} (relative {rel:.2e})")
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    check(all(a == b or m <= MARGIN for a, b, m in
              zip(nxt.tolist(), ref_nxt.tolist(), margins)),
          f"prefill tokens {nxt.tolist()} vs ref {ref_nxt.tolist()}")
    print(f"  (c) the trained model under no_grad: loss_fn on B8 "
          f"{loss.item():.6f} vs ref {ref_loss.item():.6f} (relative "
          f"{rel:.2e}), B8 x{cfg.n_layers} a forward; make_prefill_step "
          f"tokens {nxt.tolist()} = ref's", flush=True)

    # the serve step: prompts fed one token a step, then greedy tokens,
    # the ref route in lockstep (fed the kernel route's tokens)
    rng = np.random.RandomState(8)
    prompts = torch.from_numpy(rng.randint(1, cfg.vocab, (
        SERVE_B, SERVE_PLEN))).to(dev)
    serve = make_serve_step(cfg)
    caches = init_caches(cfg, SERVE_B, SERVE_MAX_LEN, device=dev,
                         dtype=torch.float32)
    ref_caches = init_caches(cfg, SERVE_B, SERVE_MAX_LEN, device=dev,
                             dtype=torch.float32)
    reset_launches()
    n_steps = SERVE_PLEN + SERVE_NEW - 1
    compared = skipped = 0
    tok = None
    ts = time.perf_counter()
    for i in range(n_steps):
        feed = prompts[:, i:i + 1] if i < SERVE_PLEN else tok
        tok, caches = serve(model, caches, feed)
        with api.policy(backend="ref"):
            logits, ref_caches = decode_step(model, ref_caches, feed)
        if i < SERVE_PLEN - 1:
            continue                      # prompt steps: no token emitted
        top2 = logits[:, -1].topk(2, -1)
        near = (top2.values[:, 0] - top2.values[:, 1]) <= MARGIN
        same = tok[:, 0] == top2.indices[:, 0]
        check(bool((same | near).all()), f"serve step {i}: tokens "
              f"{tok[:, 0].tolist()} vs ref {top2.indices[:, 0].tolist()}")
        compared += int((~near).sum())
        skipped += int(near.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    counts["flash_decode"] = flash_decode.launches
    check(flash_decode.launches == cfg.n_layers * n_steps
          and len(launched()) == 1, f"serve step launches {launched()}, "
          f"want B1 x{cfg.n_layers * n_steps}")
    print(f"  (c) make_serve_step, {SERVE_B} prompts of {SERVE_PLEN} tokens "
          f"fed one a step then {SERVE_NEW} greedy tokens ({n_steps} steps, "
          f"f32 caches): B1 x{cfg.n_layers} a step, no other kernel; "
          f"{compared} tokens equal the ref route's in lockstep, {skipped} "
          f"near-ties (margin <= {MARGIN}) not compared; {wall:.1f} s with "
          f"the ref steps", flush=True)
    return counts


def resume_matches(dev):
    """(d) the launcher preempted at step 4 and restarted, against an
    uninterrupted run."""
    common = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(RESUME_STEPS),
              "--device", dev.type]
    shutil.rmtree(TRAIN_DIR / "resume", ignore_errors=True)
    full = train_launcher.main(common + [
        "--ckpt-dir", str(TRAIN_DIR / "resume" / "full")])
    cut = train_launcher.main(common + [
        "--ckpt-dir", str(TRAIN_DIR / "resume" / "cut"),
        "--simulate-preemption", str(RESUME_AT)])
    pairs = list(zip(full.model.parameters(), cut.model.parameters()))
    diff = max((a - b).abs().max().item() for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    check(int(cut.opt_state.step) == RESUME_STEPS and diff <= 1e-6,
          f"resumed params differ by {diff}")
    print(f"  (d) launch.train.main --smoke --steps {RESUME_STEPS} "
          f"--simulate-preemption {RESUME_AT} --device {dev.type} against "
          f"the uninterrupted run: max |dparam| {diff:.3e} (atol 1e-6), "
          f"bitwise equal: {bitwise}", flush=True)
    shutil.rmtree(TRAIN_DIR / "resume", ignore_errors=True)


def fp8_training(dev):
    """(e) the paper's hybrid-FP8 recipe against the unquantized run."""
    base = dataclasses.replace(get_config(FP8_ARCH), n_layers=FP8_LAYERS)
    runs = {}
    for label, policy in (("fp8a", QuantPolicy("fp8a", "fp8a")),
                          ("none", QuantPolicy())):
        cfg = dataclasses.replace(base, quant=policy)
        tr = Trainer(cfg, TrainerConfig(
            ckpt_dir=str(TRAIN_DIR / "fp8"), ckpt_every=10**9,
            base_lr=FP8_LR, warmup=TRAIN_WARMUP, total_steps=FP8_STEPS),
            seed=0, device=dev)
        reset_launches()
        tr.run(iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=FP8_B,
                                           seq=FP8_L, seed=5))), FP8_STEPS)
        check(not launched(), f"{label}: a kernel launched in training: "
              f"{launched()}")
        runs[label] = [m["loss"] for m in tr.metrics_log]
        del tr
        torch.cuda.empty_cache()
    fp8, ref = runs["fp8a"], runs["none"]
    check(all(np.isfinite(x) for x in fp8), f"non-finite fp8 loss: {fp8}")
    check(fp8[-1] < fp8[0], f"fp8 training did not descend: {fp8}")
    print(f"  (e) {FP8_ARCH} CONFIG over {FP8_LAYERS} of its layers, "
          f"QuantPolicy(fp8a, fp8a) on every Linear, {FP8_STEPS} steps of "
          f"{FP8_B} x {FP8_L} at base_lr {FP8_LR}: fp8 loss {fp8[0]:.4f} -> "
          f"{fp8[-1]:.4f}, unquantized {ref[0]:.4f} -> {ref[-1]:.4f}; final "
          f"gap fp8 - unquantized {fp8[-1] - ref[-1]:+.4f}", flush=True)


def training_phase(dev, card):
    phase(f"7b. training: {TRAIN_ARCH} CONFIG trained {TRAIN_STEPS} steps "
          f"on the card (no kernel under autograd), its gradient against the "
          f"CPU's, the trained model on B8 and B1, resume, fp8 training")
    ts = time.perf_counter()
    tr = train_full(dev, card)
    grads_card_vs_cpu(dev, card)
    counts = trained_on_kernels(dev, tr.model)
    del tr
    torch.cuda.empty_cache()
    train_one_batch(dev)
    resume_matches(dev)
    fp8_training(dev)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"  phase 7b wall time {time.perf_counter() - ts:.1f} s",
          flush=True)
    return counts


# ------------------------------------------------- long sequences (7e)
LONG_ARCH = "olmo_1b"
LONG_B, LONG_L, LONG_STEPS = 2, 4096, 3   # train_4k's sequence (batch 256
#                                           is a pod's)
LONG_PLAIN_L = (512, 1024, 2048)          # (b) remat off: the peak's fit
LONG_EQ_L = 512                           # (c) remat against not
REMAT_TOL = 1e-6                          # of each leaf's max |g|
SCORE_ARCH, SCORE_L = "qwen2_1p5b", 32768  # prefill_32k's sequence
UNALIGNED_L = 32700                       # (e) not 128-aligned: ref route
UNALIGNED_LAYERS = 4                      # (e) of qwen2's 28
UNALIGNED_PREFIX = UNALIGNED_L // 128 * 128


def gib(x) -> float:
    return x / 2**30


def counting(fn, counter):
    """fn, with each call counted in counter[0]."""
    def wrapped(*a, **kw):
        counter[0] += 1
        return fn(*a, **kw)
    return wrapped


def long_train(dev, card):
    """(a) olmo-1b trained at 2 x 4,096 with remat, (b) its peak without
    remat at shorter lengths, fitted and carried to 4,096, (c) remat's
    gradients against none on one batch."""
    from repro_torch.models import transformer as tmod
    cfg = get_config(LONG_ARCH)
    check(cfg.remat, f"{cfg.name} CONFIG does not rematerialize")
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(TRAIN_DIR / "long"),
                                    ckpt_every=10**9, base_lr=TRAIN_LR,
                                    warmup=TRAIN_WARMUP, total_steps=10),
                 seed=0, device=dev)
    data = iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=LONG_B,
                                       seq=LONG_L, seed=9)))
    spy, routes = route_log()
    units = [0]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with patched(api.ops, "attention_route", spy), \
            patched(tmod, "checkpoint", counting(tmod.checkpoint, units)):
        tr.run(data, LONG_STEPS - 1)
        prof = profiled(lambda: tr.run(data, 1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(not launched(), f"a kernel launched in training: {launched()}")
    log = tr.metrics_log
    check(len(log) == LONG_STEPS and all(
        np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log),
        f"non-finite loss or grad norm at L {LONG_L}: {log}")
    # the backward recomputes each layer's forward, attention included
    check(units[0] == LONG_STEPS * cfg.n_layers
          and len(routes) == 2 * LONG_STEPS * cfg.n_layers
          and set(routes) == {"ref"}, f"{units[0]} checkpointed layers, "
          f"attention routes {sorted(set(routes))} x{len(routes)}")
    ms = [1e3 * m["step_time_s"] for m in log]
    print(f"  (a) {cfg.name} CONFIG ({cfg.n_layers} layers, remat) trained "
          f"{LONG_STEPS} Trainer steps at {LONG_B} x {LONG_L} tokens: "
          f"losses {[round(m['loss'], 4) for m in log]}; step ms "
          f"{[round(x, 1) for x in ms]} (step 2: "
          f"{LONG_B * LONG_L / ms[1] * 1e3:.0f} tokens/s); "
          f"max_memory_allocated {gib(peak):.2f} GiB; {units[0]} layers "
          f"checkpointed, attention ref x{len(routes)} (each layer twice a "
          f"step: forward and recompute), no kernel; {card}", flush=True)
    print(f"      profile of step {LONG_STEPS}: {prof}", flush=True)

    # (b) the same model and optimizer state without remat: the peak of
    # one forward and backward at each length, then the quadratic through
    # the three (the update's own peak, 27.5 GiB of moments and their
    # temporaries, would hide the activations at the shorter lengths)
    model, params = tr.model, list(tr.model.parameters())
    peaks = []
    with patched(model, "cfg", dataclasses.replace(cfg, remat=False)):
        for n in LONG_PLAIN_L:
            batch = batch_on(next(iter(SyntheticLM(DataConfig(
                vocab=cfg.vocab, batch=LONG_B, seq=n, seed=11)))), dev)
            for p in params:
                p.grad = None
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = loss_fn(model, batch)
            loss.backward()
            check(np.isfinite(loss.item()), f"no-remat loss at L {n}")
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
    for p in params:
        p.grad = None
    coef = np.polyfit(np.array(LONG_PLAIN_L, dtype=np.float64),
                      np.array(peaks, dtype=np.float64), 2)
    at_long = float(np.polyval(coef, LONG_L))
    print(f"  (b) without remat (dataclasses.replace(cfg, remat=False)), one "
          f"forward and backward at {LONG_B} x L beside the weights and "
          f"AdamW moments: peaks "
          + ", ".join(f"L {n} {gib(p):.2f} GiB"
                      for n, p in zip(LONG_PLAIN_L, peaks))
          + f"; the quadratic through them gives {gib(at_long):.2f} GiB at L "
          f"{LONG_L} ({at_long / 1e9:.1f} GB; the card holds 80 GB) against "
          f"(a)'s step peak with remat {gib(peak):.2f} GiB "
          f"({at_long / peak:.1f}x)", flush=True)

    # (c) one batch, remat against not: loss and every gradient
    batch = batch_on(next(iter(SyntheticLM(DataConfig(
        vocab=cfg.vocab, batch=LONG_B, seq=LONG_EQ_L, seed=12)))), dev)
    out = {}
    for remat in (True, False):
        with patched(model, "cfg", dataclasses.replace(cfg, remat=remat)):
            for p in params:
                p.grad = None
            loss, _ = loss_fn(model, batch)
            loss.backward()
            out[remat] = (loss.item(), [p.grad for p in params])
    worst, where = 0.0, None
    for (name, _), a, b in zip(model.named_parameters(), out[True][1],
                               out[False][1]):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    for p in params:
        p.grad = None
    print(f"  (c) one batch of {LONG_B} x {LONG_EQ_L}: loss with remat "
          f"{out[True][0]:.6f}, without {out[False][0]:.6f}; every "
          f"gradient within {worst:.2e} of its leaf's max |g| (limit "
          f"{REMAT_TOL}; worst {where})", flush=True)
    check(worst <= REMAT_TOL, f"remat gradient of {where} is {worst:.2e} of "
          "the leaf's max |g| from the no-remat one")
    check(abs(out[True][0] - out[False][0]) <= REMAT_TOL * abs(out[False][0]),
          f"remat loss {out[True][0]} vs {out[False][0]}")
    del tr, model, params, out
    torch.cuda.empty_cache()


def compare_logits(got, want, block=4096):
    """(max |got - want|, max |want|, positions whose argmax differ and
    the largest top-1/top-2 margin of `want` among them) over (1, L, V)
    logits, a block of positions at a time (no full-size temporary)."""
    diff = scale = worst_margin = 0.0
    flips = 0
    for i in range(0, got.shape[1], block):
        g, w = got[:, i:i + block], want[:, i:i + block]
        diff = max(diff, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        other = g.argmax(-1) != w.argmax(-1)
        if other.any():
            top2 = w[other].topk(2, -1).values
            flips += int(other.sum())
            worst_margin = max(worst_margin,
                               (top2[:, 0] - top2[:, 1]).max().item())
    return diff, scale, flips, worst_margin


def long_score(dev, card):
    """(d) qwen2-1.5B over 32,768 tokens on B8 against the chunked ref
    route; B8 at that shape against its plain version, timed. Returns
    (B8's main-path launches, its max |diff|, its timing row)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    cfg = get_config(SCORE_ARCH)
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.RandomState(13).randint(
        1, cfg.vocab, (1, SCORE_L))).to(dev)
    route = api.ops.attention_route(lq=SCORE_L, lk=SCORE_L)
    check(route == "cuda", f"L {SCORE_L} routes to {route}")
    forward(model, toks[:, :128])                  # first-launch setup
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ts = time.perf_counter()
    logits, _ = forward(model, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    n_fwd = flash_attention.launches
    nxt = make_prefill_step(cfg)(model, {"tokens": toks})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = flash_attention.launches
    check(n_fwd == cfg.n_layers and launches == 2 * cfg.n_layers
          and set(launched()) == {"flash_attention"},
          f"forward + prefill step at L {SCORE_L}: {launched()}, want B8 "
          f"x{cfg.n_layers} each")
    print(f"  (d) {cfg.name} CONFIG, forward over 1 x {SCORE_L} tokens on "
          f"B8: {1e3 * wall:.1f} ms wall = {SCORE_L / wall:.0f} prompt "
          f"tokens/s; forward + make_prefill_step max_memory_allocated "
          f"{gib(peak):.2f} GiB (weights, 1 x {SCORE_L} x {cfg.vocab} f32 "
          f"logits each); B8 x{n_fwd} a forward, {launches} in both, no "
          f"other kernel; {card}", flush=True)

    chunked = [0]
    with api.policy(backend="ref"), patched(
            attn_ops, "chunked_attention",
            counting(attn_ops.chunked_attention, chunked)):
        ts = time.perf_counter()
        ref_logits, _ = forward(model, toks)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - ts
    check(chunked[0] == cfg.n_layers and flash_attention.launches ==
          launches, f"the ref route ran chunked_attention {chunked[0]} "
          f"times and launched B8 {flash_attention.launches - launches}")
    diff, scale, flips, margin = compare_logits(logits, ref_logits)
    ref_next = ref_logits[:, -1].argmax(-1)
    top2 = ref_logits[:, -1].topk(2, -1).values[0]
    last_margin = (top2[0] - top2[1]).item()
    print(f"      the ref route (chunked_attention x{chunked[0]}, chunk "
          f"{api.current_policy().chunk}): {1e3 * ref_wall:.1f} ms; max "
          f"|dlogit| {diff:.3e} ({diff / scale:.2e} of max|logit| "
          f"{scale:.2f}; limit {LOGIT_TOL}); argmax differs at {flips} of "
          f"{SCORE_L} positions (largest ref top-1/top-2 margin there "
          f"{margin:.2e}); make_prefill_step's token {nxt.tolist()} vs "
          f"{ref_next.tolist()} (margin {last_margin:.4f})", flush=True)
    check(diff <= LOGIT_TOL * scale, f"L {SCORE_L}: max |dlogit| {diff} "
          f"above {LOGIT_TOL} x {scale}")
    check(flips == 0 or margin <= 2 * diff, f"argmax differs at {flips} "
          f"positions, at a margin up to {margin} > 2 x max |dlogit|")
    check(torch.equal(nxt, ref_next) or last_margin <= MARGIN,
          f"prefill token {nxt.tolist()} vs ref {ref_next.tolist()}")
    del logits, ref_logits, model
    torch.cuda.empty_cache()

    # B8 alone at the forward's shape: against its plain version, timed
    # beside it, SDPA (K/V expanded to Hq beforehand) and its bound
    from torch.nn.attention import SDPBackend, sdpa_kernel
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cases = [full_case(dev, 90 + i, b=1, hq=hq, hkv=hkv, lq=SCORE_L,
                       lk=SCORE_L, d=d) for i in range(2)]
    got = flash_attention(*cases[0])
    want = flash_attention_plain(*cases[0])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    nan = got.isnan().any().item()
    del got, want
    check(err <= TOL and not nan, f"B8 at L {SCORE_L}: max |diff| {err} "
          f"above {TOL} or NaN")
    group = hq // hkv
    wide = [(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))
            for q, k, v in cases]
    ms = cuda_ms([functools.partial(flash_attention, *c) for c in cases], 4)
    plain_ms = cuda_ms([functools.partial(flash_attention_plain, *cases[0])],
                       1)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_ms = cuda_ms([functools.partial(
            F.scaled_dot_product_attention, *c, is_causal=True)
            for c in wide], 4)
    bound_ms, bound_by = full_bound(1, hq, hkv, SCORE_L, SCORE_L, d, mmas=6)
    f32_ms, _ = full_bound(1, hq, hkv, SCORE_L, SCORE_L, d)
    print(f"      B8 at (1, {hq}, {SCORE_L}, {d}) K/V (1, {hkv}, {SCORE_L}, "
          f"{d}) causal f32: max|diff| {err:.3e} against its plain version; "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  SDPA (memory-efficient,"
          f" K/V expanded) {lib_ms:.4f} ({ms / lib_ms:.2f}x)  bound "
          f"{bound_ms:.4f} ({bound_by}, 6 bf16 MMAs a product; "
          f"{100 * bound_ms / ms:.1f}% of it)  f32 bound {f32_ms:.4f} "
          f"({100 * f32_ms / ms:.1f}%)", flush=True)
    del cases, wide
    torch.cuda.empty_cache()
    return launches, err


def long_unaligned(dev, card):
    """(e) a 32,700-token prompt: not 128-aligned, so the kernel backend
    routes it to ref, which runs chunked; its logits at the aligned prefix
    against B8's forward over that prefix. Returns B8's launches."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    cfg = dataclasses.replace(get_config(SCORE_ARCH),
                              n_layers=UNALIGNED_LAYERS)
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.RandomState(14).randint(
        1, cfg.vocab, (1, UNALIGNED_L))).to(dev)
    route = api.ops.attention_route(lq=UNALIGNED_L, lk=UNALIGNED_L)
    check(route == "ref", f"L {UNALIGNED_L} routes to {route}")
    chunked = [0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with patched(attn_ops, "chunked_attention",
                 counting(attn_ops.chunked_attention, chunked)):
        ts = time.perf_counter()
        logits, _ = forward(model, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    peak = torch.cuda.max_memory_allocated()
    check(chunked[0] == cfg.n_layers and not launched(),
          f"L {UNALIGNED_L}: chunked_attention x{chunked[0]}, launches "
          f"{launched()}")
    check(tuple(logits.shape) == (1, UNALIGNED_L, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"L {UNALIGNED_L}: non-finite or misshapen logits")
    prefix, _ = forward(model, toks[:, :UNALIGNED_PREFIX])
    torch.cuda.synchronize()
    n_b8 = flash_attention.launches
    check(n_b8 == cfg.n_layers, f"the aligned prefix launched B8 {n_b8} "
          f"times")
    diff, scale, _, _ = compare_logits(prefix, logits[:, :UNALIGNED_PREFIX])
    print(f"  (e) {cfg.name} CONFIG over {UNALIGNED_LAYERS} of its "
          f"{get_config(SCORE_ARCH).n_layers} layers, "
          f"a prompt of {UNALIGNED_L} tokens (route {route}, "
          f"chunked_attention x{chunked[0]}, no kernel): {1e3 * wall:.1f} ms,"
          f" max_memory_allocated {gib(peak):.2f} GiB; its logits at the "
          f"first {UNALIGNED_PREFIX} positions against B8's forward over "
          f"them: max |dlogit| {diff:.3e} ({diff / scale:.2e} of max|logit|)"
          f"; {card}", flush=True)
    check(diff <= LOGIT_TOL * scale, f"L {UNALIGNED_L}: the chunked ref "
          f"route's prefix logits differ by {diff} from B8's")
    del logits, prefix, model
    torch.cuda.empty_cache()
    return n_b8


def long_phase(dev, card):
    phase(f"7e. long sequences: {LONG_ARCH} CONFIG trained at {LONG_B} x "
          f"{LONG_L} with remat, its peak without, remat's gradients; "
          f"{SCORE_ARCH} CONFIG over {SCORE_L} tokens on B8 against the "
          f"chunked ref route; a {UNALIGNED_L}-token prompt on the chunked "
          "ref route")
    ts = time.perf_counter()
    long_train(dev, card)
    launches, err = long_score(dev, card)
    launches += long_unaligned(dev, card)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"  phase 7e wall time {time.perf_counter() - ts:.1f} s",
          flush=True)
    return {"flash_attention": launches}, {"flash_attention": err}


# --------------------------------------- distribution on one card (7c)
# NCCL refuses two ranks on one device, so the ranks share cuda:0 over
# gloo (every collective through host buffers); the cases run on meshes of
# ranks 0-1 or 0-7 of one world of 8
DIST_RANKS = 8
DIST_DEVICE = torch.device("cuda", 0)     # every rank's device
DIST_TP = ("qwen2_1p5b", 2, 2, 512)       # (a): arch, layers, B, L; (1, 2)
DIST_SP = ("internlm2_20b", 2, 1, 1024)   # (b): (1, 8), the manual block
DIST_EP = ("olmoe_1b_7b", 2, 2, 512)      # (c): (1, 2)
DIST_DP = ("olmo_1b", 2, 4, 256, 3)       # (d): (2, 1), global B x L, steps
DIST_TOL = 1e-4                           # max |dlogit| / max |logit|
DIST_ROUTE_TOL = 0.01                     # token-layers routed otherwise
DIST_LOSS_TOL = 1e-5                      # relative, plain DP vs one rank


def dist_sync():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def dist_peak(reset=False):
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2**30


def dist_calls(rec, site, kind):
    """The forward calls of one kind at one call site in a record of
    `record_collectives`."""
    return sum(1 for c in rec if c["site"] == site and c["kind"] == kind
               and c["phase"] == "forward")


def dist_forward_case(rank, ranks, arch, layers, b, l, mesh, manual,
                      seed=0):
    """One forward at full width over `layers` layers on a mesh of
    `ranks` ranks against rank 0's one-rank forward of the same model on
    the ref route (plain attention): each rank builds the whole model on
    the card in turn (a whole internlm2-20b x2 is 7.6 GB) and keeps its
    shards. manual: the layers must run the manual TP+SP block (two
    sequence all-gathers and two reduce-scatters a layer), else the
    automatic path (two row-parallel all-reduces a layer). Returns rank
    0's (max |diff|, max |logit|, ms, peak GiB, B8 launches) or this
    rank's launches."""
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.dist.collectives import barrier, record_collectives
    from repro_torch.models.tp_block import SITE
    dev = DIST_DEVICE
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    toks = torch.randint(0, cfg.vocab, (b, l), generator=torch.Generator()
                         .manual_seed(seed)).to(dev)
    model = ref = None
    for r in range(ranks):
        if rank == r:
            model = init_params(cfg, seed=0, device=dev)
            if rank == 0:
                with torch.no_grad(), api.policy(backend="ref"):
                    ref, _ = forward(model, toks)
            shard_params(model, mesh)
            dist_sync()
        barrier(mesh)
    dist_peak(reset=True)
    reset_launches()
    t0 = time.perf_counter()
    with set_mesh(mesh), torch.no_grad(), record_collectives() as rec:
        logits, _ = forward(model, toks)
    dist_sync()
    ms = 1e3 * (time.perf_counter() - t0)
    n_b8 = flash_attention.launches
    peak = dist_peak()
    seq = (dist_calls(rec, SITE, "all-gather"),
           dist_calls(rec, SITE, "reduce-scatter"))
    rows = dist_calls(rec, "row", "all-reduce")
    check(n_b8 == layers, f"{arch} rank {rank}: {n_b8} B8 launches in the "
          f"forward, want {layers}")
    if manual:
        check(seq == (2 * layers, 2 * layers), f"{arch} rank {rank}: "
              f"{seq} sequence all-gathers / reduce-scatters, want "
              f"{2 * layers} each (the manual TP+SP block did not run)")
    else:
        check(seq == (0, 0) and rows == 2 * layers, f"{arch} rank {rank}: "
              f"{seq} sequence all-gathers / reduce-scatters and {rows} "
              f"row all-reduces, want none and {2 * layers}")
    if rank:
        return {"launches": n_b8, "peak": peak}
    diff = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.isfinite(logits).all() and logits.shape == ref.shape,
          f"{arch}: non-finite or misshapen logits {tuple(logits.shape)}")
    check(diff <= DIST_TOL * scale, f"{arch} on {tuple(mesh.shape)}: max "
          f"|dlogit| {diff:.3e} > {DIST_TOL} x {scale:.3e}")
    return {"launches": n_b8, "peak": peak, "diff": diff, "scale": scale,
            "ms": ms, "seq": seq, "rows": rows}


def dist_ep_case(rank, mesh):
    """(c) olmoe's expert-parallel forward against rank 0's one-rank
    forward on the ref route, the reference routed as the EP run chose (a
    top-k near-tie may flip between them: counted, at most 1% of
    token-layers). Each layer must combine its experts' outputs over
    "model" and no rank may all-gather the experts."""
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.models import moe as moe_mod
    arch, layers, b, l = DIST_EP
    dev = DIST_DEVICE
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    toks = torch.randint(0, cfg.vocab, (b, l), generator=torch.Generator()
                         .manual_seed(1)).to(dev)
    model = init_params(cfg, seed=0, device=dev)
    shard_params(model, mesh)
    routes = FollowRoutes(moe_mod.router_topk)
    routes.mode = "record"
    dist_peak(reset=True)
    reset_launches()
    t0 = time.perf_counter()
    with set_mesh(mesh), torch.no_grad(), record_collectives() as rec, \
            patched(moe_mod, "router_topk", routes):
        logits, aux = forward(model, toks)
    dist_sync()
    ms = 1e3 * (time.perf_counter() - t0)
    n_moe = cfg.block_kinds().count("moe")
    combines = dist_calls(rec, "moe.combine", "all-reduce")
    experts = sum(1 for c in rec if c["site"] == "weight"
                  and len(c["shape"]) == 3
                  and c["shape"][0] == cfg.n_experts)
    n_b8 = flash_attention.launches
    check(n_b8 == layers and combines == n_moe and experts == 0,
          f"olmoe EP rank {rank}: {n_b8} B8 launches, {combines} expert "
          f"combines, {experts} expert all-gathers; want {layers}, "
          f"{n_moe}, 0")
    out = {"launches": n_b8, "peak": dist_peak()}
    del model
    dist_sync()
    if rank:
        return out
    full = init_params(cfg, seed=0, device=dev)
    routes.mode = "follow"
    with torch.no_grad(), api.policy(backend="ref"), \
            patched(moe_mod, "router_topk", routes):
        ref, ref_aux = forward(full, toks)
    flips = routes.flips
    diff = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    flipped = float(np.mean(flips))
    check(len(flips) == n_moe, f"olmoe: {len(flips)} routed calls")
    check(flipped <= DIST_ROUTE_TOL, f"olmoe EP: expert choice differs on "
          f"{flipped:.2%} of token-layers")
    check(diff <= DIST_TOL * scale, f"olmoe EP: max |dlogit| {diff:.3e} > "
          f"{DIST_TOL} x {scale:.3e}")
    out.update(diff=diff, scale=scale, ms=ms, flipped=flipped,
               aux=abs(float(aux) - float(ref_aux)), combines=combines)
    return out


def dist_dp_case(rank, mesh):
    """(d) olmo-1b x2 trained data-parallel on (2, 1): the int8 compressed
    step (the ranks' params bitwise equal after every step; step 1's
    reduced gradient within scale/2 of the f32 mean, elementwise), then the
    plain-DP Trainer against one rank's Trainer on the same global
    batches."""
    import torch.distributed as dist
    from repro_torch.dist import set_mesh, shard_params
    from repro_torch.dist.collectives import all_gather, all_reduce
    from repro_torch.dist.specs import _leaves, param_tree
    from repro_torch.launch.steps import dp_slice
    from repro_torch.launch.steps_compressed import make_compressed_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.grad_compress import (compressed_psum,
                                                 init_error_state,
                                                 shared_scale)
    arch, layers, b, l, steps = DIST_DP
    dev = DIST_DEVICE
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    data = iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=b, seq=l,
                                       seed=7)))
    batches = [batch_on(next(data), dev) for _ in range(steps)]
    fmt = FM.REGISTRY["int8"]
    model = init_params(cfg, seed=0, device=dev).trainable_()
    shard_params(model, mesh)
    dist_peak(reset=True)
    t0 = time.perf_counter()
    # step 1's reduced gradient against the f32 mean, group by group
    with set_mesh(mesh):
        with torch.enable_grad():
            loss_fn(model, dp_slice(batches[0], mesh))[0].backward()
        worst = 0.0
        for ref in _leaves(param_tree(model)):
            x = torch.cat([p.grad.reshape(-1) for _, _, p in ref.params])
            got = compressed_psum(x, ("data",), fmt) / 2
            mean = all_reduce(x, "data") / 2
            scale = shared_scale(all_reduce(x.abs().amax(), "data", "max"),
                                 fmt)
            gap = float(((got - mean).abs() / (scale / 2)).max())
            worst = max(worst, gap)
        check(worst <= 1 + 1e-4, f"compressed step 1: a reduced gradient "
              f"element {worst:.6f} x scale/2 from the f32 mean")
    params = list(model.parameters())
    opt = adamw_init(params)
    err = init_error_state(params)
    step = make_compressed_train_step(cfg, mesh, fmt_name="int8",
                                      warmup=TRAIN_WARMUP, total=10)
    closs, same = [], True
    for batch in batches:
        closs.append(float(step(model, opt, err, batch)["loss"]))
        with set_mesh(mesh):
            for p in params:
                both = all_gather(p.detach()[None], 0, "data")
                same &= bool(torch.equal(both[0], both[1]))
        check(same, f"compressed DP: the ranks' params differ after step "
              f"{len(closs)}")
    ms_comp = 1e3 * (time.perf_counter() - t0) / steps
    peak = dist_peak()
    del model, opt, err, params
    dist_sync()
    tcfg = dict(ckpt_every=10**9, warmup=TRAIN_WARMUP, total_steps=10)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(TRAIN_DIR / "dp"), **tcfg),
                 seed=0, device=dev, mesh=mesh)
    tr.run(iter([{k: v.cpu().numpy() for k, v in x.items()}
                 for x in batches]), steps)
    dp_loss = [m["loss"] for m in tr.metrics_log]
    del tr
    dist_sync()
    out = {"peak": peak, "closs": closs, "dp_loss": dp_loss,
           "ms": ms_comp, "worst": worst}
    if rank == 0:
        one = Trainer(cfg, TrainerConfig(ckpt_dir=str(TRAIN_DIR / "one_dp"),
                                         **tcfg), seed=0, device=dev)
        one.run(iter([{k: v.cpu().numpy() for k, v in x.items()}
                      for x in batches]), steps)
        one_loss = [m["loss"] for m in one.metrics_log]
        gap = max(abs(a - c) / abs(c) for a, c in zip(dp_loss, one_loss))
        check(gap <= DIST_LOSS_TOL, f"plain DP losses {dp_loss} vs one "
              f"rank's {one_loss}")
        out.update(one_loss=one_loss, gap=gap)
        del one
        dist_sync()
    dist.barrier(group=mesh.get_group("data"))
    return out


# --------------------------- tenants on partitions of ranks (7c, case e)
# ranks 0-3 of the world as a (2, 2) grid of ranks: the launcher's two
# tenants, each on a (1, 2) partition of its own, served tensor-parallel at
# once by `ServingEngine`s built under `MorphableScheduler.run`
PART_GRID = np.arange(4).reshape(2, 2)
# (tenant, arch, weight rows, cols, layers: None = all)
PART_TENANTS = (("captioning", "olmoe_1b_7b", 64, 512, 4),   # of 16
                ("classification", "qwen2_1p5b", 64, 768, None))
PART_VARIANTS = (("flat bf16-KV", False, False),
                 ("paged int8-KV", True, True))
PART_GEO = dict(slots=4, max_len=256, prefill_chunk=W, block_size=16)
PART_PLENS = [16, 160, 48, 100, 24, 130]
PART_NEW = 8
PART_TOL = 1e-3                 # max |dlogit| / max |logit|; ties below it
PART_TOL_INT8 = 1e-2            # int8 KV: see `partition_tenant`
PART_KERNELS = (flash_decode, flash_prefill, flash_decode_paged_quant,
                flash_prefill_paged_quant)
PART_SNAP_ARCH = "qwen2_1p5b"   # its variants snapshotted and restored
PART_TTL_ARCH = "olmoe_1b_7b"   # the skewed-clock TTL and wrong-mesh cases
PART_TTLS = [0.0, 60.0, None, 0.0, 60.0]   # seconds on the lead's clock
PART_TTL_NEW = 4
PART_SKEW = (1000.0, 50.0)      # the other rank: + 1000 s, + 50 s a read


class StepLog(ServingEngine):
    """A partition's engine that keeps each launch's logit rows and tokens
    in `log` (the lockstep comparison drains it)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.log = []

    def _greedy(self, rows, health):
        tok, ok = super()._greedy(rows, health)
        self.log.append((rows, tok))
        return tok, ok


class Follower(ServingEngine):
    """The one-rank engine in lockstep with a partition's engine `lead`:
    each launch emits the tokens the lead's same launch chose (so both
    serve the same streams) and holds its own logits against the lead's
    on every row whose token is consumed: max |dlogit| / max |logit|
    (`worst`), and a token of its own other than the lead's only where its
    top-1 / top-2 gap is at most `tol` x max |logit| (`ties`; any other is
    `wrong`)."""

    def __init__(self, *args, lead, tol, **kw):
        super().__init__(*args, **kw)
        self.lead, self.tol = lead, tol
        self.worst, self.ties, self.compared, self.wrong = 0.0, 0, 0, []
        self._now = None

    def _greedy(self, rows, health):
        own, ok = super()._greedy(rows, health)
        theirs_rows, theirs = self.lead.log.pop(0)
        self._now = (rows, theirs_rows, own)
        return theirs, ok

    def _emit(self, s, tok, newly):
        rows, theirs_rows, own = self._now
        mine = rows[s].float()
        scale = float(mine.abs().max())
        self.worst = max(self.worst, float(
            (theirs_rows[s].float() - mine).abs().max()) / scale)
        if int(own[s]) != int(tok):
            top = mine.topk(2).values
            if float(top[0] - top[1]) <= self.tol * scale:
                self.ties += 1
            else:
                self.wrong.append((self._slot_req[s].rid, int(own[s]),
                                   int(tok)))
        self.compared += 1
        super()._emit(s, tok, newly)


class FollowRoutes:
    """`moe.router_topk` recording the partition engine's expert choices
    (`mode` "record") and giving them to the one-rank engine's same calls
    ("follow"), counting the token-layers whose own choice differs."""

    def __init__(self, real):
        self.real, self.mode, self.ids, self.flips = real, None, [], []

    def __call__(self, probs, k):
        if self.mode == "record":
            gates, ids = self.real(probs, k)
            self.ids.append(ids)
            return gates, ids
        if self.mode == "follow":
            _, own = self.real(probs, k)
            ids = self.ids.pop(0)
            self.flips.append(float((torch.sort(own, -1).values
                                     != torch.sort(ids, -1).values).any(1)
                                    .float().mean()))
            gates = torch.gather(probs, -1, ids)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids
        return self.real(probs, k)


def gather_state(dst, src):
    """Put the one-rank engine `dst` (None on the partition's other ranks)
    in the device state of the partition's engine `src`: each cache field
    sharded on its heads axis is all-gathered over "model" (every rank of
    the partition calls this), the rest copied."""
    from repro_torch.dist.collectives import all_gather
    for i, sc in enumerate(src.caches):
        for f in dataclasses.fields(sc):
            t = getattr(sc, f.name)
            if f.name not in ("pos", "table"):
                t = all_gather(t, 1, "model", site="lockstep")
            if dst is not None:
                getattr(dst.caches[i], f.name).copy_(t)
    if dst is not None:
        dst._last[:] = src._last


class SkewedClock:
    """The engine module's `time` on a rank whose clock runs apart from
    the lead's: the real monotonic clock plus `offset`, plus `rate`
    seconds more at every read."""

    def __init__(self, offset, rate):
        self.offset, self.rate, self.reads = offset, rate, 0

    def monotonic(self):
        self.reads += 1
        return time.monotonic() + self.offset + self.rate * self.reads

    def __getattr__(self, name):
        return getattr(time, name)


def partition_ttl(cfg, model, geo, lead, tall):
    """The skewed-clock TTL case and the wrong-mesh refusal on a tenant's
    partition: a flat bf16 engine serves prompts with PART_TTLS while the
    non-lead rank's engine reads a SkewedClock; returns {rid: (status,
    step it ended in)}, then the engine's snapshot restored into an
    engine of the same model under the (2, 1) mesh `tall` of the same
    ranks: the refusal's text (or "restored")."""
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.serving import engine as engine_mod
    eng = ServingEngine(cfg, model, **geo)
    ends = {}
    with patched(engine_mod, "time",
                 time if lead else SkewedClock(*PART_SKEW)):
        for rid, (p, ttl) in enumerate(zip(
                family_prompts(cfg.vocab, [16] * len(PART_TTLS), seed=7),
                PART_TTLS)):
            check(eng.submit(Request(rid, p, max_new_tokens=PART_TTL_NEW,
                                     ttl_s=ttl)), f"TTL request {rid}")
        while eng.pending():
            for r in eng.step():
                ends[r.rid] = (r.status, eng.step_no)
    snap = SNAP_DIR / f"7c_{cfg.name}_ttl"
    eng.snapshot(snap)
    with set_mesh(tall):
        other = ServingEngine(cfg, model, **geo)
    try:
        other.restore(snap)
        refused = "restored"
    except ValueError as err:
        refused = str(err)
    return ends, refused


def partition_tenant(rank, arch, layers):
    """One tenant on its partition (every rank of it, under its mesh):
    the model built as this rank's shards (`init_sharded`), each variant
    served by a partition engine in lockstep with a one-rank engine of the
    whole model on the partition's first rank (put in the partition's
    state before every step). PART_SNAP_ARCH's engines are snapshotted
    once a request has finished, and restored into fresh engines that
    finish the streams; PART_TTL_ARCH's partition
    runs `partition_ttl`. Returns this rank's launches, peak memory,
    cache heads and collectives, and on the first rank the comparison.

    Tolerances of the lockstep logits (of max |logit|): the two engines
    sum their products in other orders (row-parallel partial sums, other
    GEMM column blocks), so each step's fresh K/V differ by f32 ulps
    before they are stored; a bf16 cache rounds a few elements the other
    way (half a bf16 ulp, PART_TOL = 1e-3 holds), an int8 cache moves a
    key by a whole code step (amax / 127) wherever x / scale sits that
    close to a rounding tie, several a chunk step at 28 layers:
    PART_TOL_INT8 = 1e-2. A wrong head or slice moves logits by O(1)."""
    from repro_torch.dist import init_sharded, set_mesh
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.dist.sharding import axis_rank, ctx_mesh
    from repro_torch.models import moe as moe_mod
    mesh = ctx_mesh()
    lead = axis_rank("model", mesh) == 0
    dev = DIST_DEVICE
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dist_peak(reset=True)
    t0 = time.perf_counter()
    model = init_sharded(cfg, mesh, seed=0, device=dev)
    full = init_params(cfg, seed=0, device=dev) if lead else None
    dist_sync()
    out = {"arch": arch, "rank": rank, "lead": lead, "layers": cfg.n_layers,
           "build_s": time.perf_counter() - t0, "variants": {}}
    prompts = family_prompts(cfg.vocab, PART_PLENS, seed=5)
    routes = FollowRoutes(moe_mod.router_topk)
    for label, paged, int8 in PART_VARIANTS:
        vcfg = dataclasses.replace(cfg, kv_quant=int8)
        geo = dict(PART_GEO, paged=paged)
        eng = StepLog(vcfg, model, **geo).warmup()
        one = None
        if lead:
            with set_mesh(None):
                one = Follower(vcfg, full, lead=eng, **geo,
                               tol=PART_TOL_INT8 if int8 else PART_TOL
                               ).warmup()
            submit_all(one, prompts, PART_NEW)
        submit_all(eng, prompts, PART_NEW)
        counts = {k.__name__: 0 for k in PART_KERNELS}
        steps, t_serve, snapped = 0, 0.0, None
        snap = SNAP_DIR / f"7c_{arch}_{int(paged)}"
        with patched(moe_mod, "router_topk", routes), \
                record_collectives() as rec:
            while eng.pending():
                n_rec = len(rec)
                gather_state(one, eng)
                del rec[n_rec:]           # the lockstep's own gathers
                before = {k.__name__: k.launches for k in PART_KERNELS}
                ts = time.perf_counter()
                routes.mode = "record" if lead else None
                eng.step()
                dist_sync()
                t_serve += time.perf_counter() - ts
                for k in PART_KERNELS:
                    counts[k.__name__] += k.launches - before[k.__name__]
                if lead:
                    with set_mesh(None):
                        routes.mode = "follow"
                        one.step()
                routes.mode = None
                eng.log.clear()
                steps += 1
                if arch == PART_SNAP_ARCH and snapped is None \
                        and eng.finished and eng.pending():
                    ts = time.perf_counter()
                    eng.snapshot(snap)
                    snapped = (eng.step_no, time.perf_counter() - ts,
                               len(eng.finished),
                               int(eng._prefilling.sum()))
        dist_sync()
        check_no_faults(f"partition {arch} {label}", eng)
        weights = sum(1 for c in rec if c["site"] == "weight")
        heads = {c.k_codes.shape[1] if int8 else c.k.shape[1]
                 for c in kv_caches(eng.caches)}
        check(heads == {cfg.n_kv_heads // 2} and weights == 0,
              f"partition {arch} {label} rank {rank}: cache heads {heads} "
              f"(want {cfg.n_kv_heads // 2}), {weights} weight all-gathers")
        check(len(eng.finished) == len(prompts), f"partition {arch} "
              f"{label}: {len(eng.finished)} requests finished")
        v = {"counts": counts, "steps": steps, "serve_s": t_serve,
             "heads": min(heads),
             "rows": sum(1 for c in rec if c["site"] == "row"),
             "tokens": sum(len(r.out_tokens) for r in eng.finished)}
        if lead:
            check(not one.pending(), f"partition {arch} {label}: the "
                  "one-rank engine did not drain in step")
            check_no_faults(f"one-rank {arch} {label}", one)
            check(not one.wrong and one.worst <= one.tol,
                  f"partition {arch} {label}: max |dlogit| {one.worst:.3e}"
                  f" x max |logit| (limit {one.tol}); tokens other than "
                  f"the one-rank engine's past a near-tie (rid, one-rank, "
                  f"partition): {one.wrong[:5]}")
            v.update(worst=one.worst, tol=one.tol, ties=one.ties,
                     compared=one.compared)
        if snapped is not None:
            fresh = ServingEngine(vcfg, model, **geo)
            ts = time.perf_counter()
            check(fresh.restore(snap) == snapped[0], f"partition {arch} "
                  f"{label}: the restored step")
            t_load = time.perf_counter() - ts
            fresh.run_until_drained()
            dist_sync()
            check_no_faults(f"partition {arch} {label} restored", fresh)
            got, want = tokens(fresh), tokens(eng)
            check(len(got) + snapped[2] == len(prompts) and
                  all(got[rid] == want[rid] for rid in got),
                  f"partition {arch} {label} rank {rank}: the engine "
                  f"restored at step {snapped[0]} finished with other "
                  "tokens than the uninterrupted one")
            v["restore"] = dict(at=snapped[0], save_s=snapped[1],
                                done=snapped[2], prefilling=snapped[3],
                                load_s=t_load, steps=fresh.step_no
                                - snapped[0],
                                s=time.perf_counter() - ts)
            del fresh
        out["variants"][label] = v
        del eng, one
        dist_sync()
    if routes.flips:
        flipped = float(np.mean(routes.flips))
        check(flipped <= DIST_ROUTE_TOL, f"partition {arch}: expert "
              f"choice differs on {flipped:.2%} of token-layers")
        out["flipped"] = flipped
    if arch == PART_TTL_ARCH:
        ts = time.perf_counter()
        tall = next(m for m in DIST_TALL if m.get_coordinate() is not None)
        out["ttl"] = partition_ttl(cfg, model, dict(PART_GEO), lead, tall)
        out["ttl_s"] = time.perf_counter() - ts
    out["peak"] = dist_peak()
    del model, full
    dist_sync()
    return out


DIST_TALL: list = []            # (2, 1) meshes of the partitions' ranks


def dist_rank_main(rank, world, init):
    """One rank of phase 7c's world (every rank on cuda:0, gloo)."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import barrier
    from repro_torch.launch.mesh import init_world, make_mesh, make_meshes
    torch.cuda.set_device(DIST_DEVICE)
    init_world(init_method=init, rank=rank, world_size=world,
               device="cuda", backend="gloo")
    pair = [0, 1]
    m12 = make_mesh((1, 2), ranks=pair)
    m18 = make_mesh((1, DIST_RANKS))
    m21 = make_mesh((2, 1), ranks=pair)
    out, wall = {}, {}
    t0 = time.perf_counter()
    if rank in pair:
        out["a"] = dist_forward_case(rank, 2, *DIST_TP, m12, manual=False)
    barrier(m18)
    wall["a"] = time.perf_counter() - t0
    out["b"] = dist_forward_case(rank, DIST_RANKS, *DIST_SP, m18,
                                 manual=True, seed=2)
    barrier(m18)
    wall["b"] = time.perf_counter() - t0 - wall["a"]
    if rank in pair:
        out["c"] = dist_ep_case(rank, m12)
    barrier(m18)
    wall["c"] = time.perf_counter() - t0 - wall["a"] - wall["b"]
    if rank in pair:
        out["d"] = dist_dp_case(rank, m21)
    barrier(m18)
    wall["d"] = time.perf_counter() - t0 - sum(wall.values())
    # (e) every rank of the world makes the partitions' meshes (and a (2,
    # 1) mesh of each partition's ranks, a mesh of another shape); the
    # partitions' ranks serve their tenants at once, the others wait
    DIST_TALL[:] = make_meshes([PART_GRID[i].reshape(2, 1) for i in (0, 1)])
    sched = MorphableScheduler(ranks=PART_GRID)
    sched.reconfigure([Tenant(n, weight_rows=r, weight_cols=c, fmt="int8")
                       for n, _, r, c, _ in PART_TENANTS])
    for name, arch, _, _, layers in PART_TENANTS:
        got = sched.run(name, partition_tenant, rank, arch, layers)
        if got is not None:
            out["e"] = got
    barrier(m18)
    if rank == 0:
        shutil.rmtree(SNAP_DIR, ignore_errors=True)
    wall["e"] = time.perf_counter() - t0 - sum(wall.values())
    out["wall"] = wall
    dist.destroy_process_group()
    return out


def distribution_phase(card):
    """Phase 7c: the distribution layer on one card. Returns B8's
    launches in the cases' forwards (every rank's)."""
    phase(f"7c. distribution on one card: {DIST_RANKS} gloo ranks on cuda:0 "
          f"(host buffers): (a) automatic TP, (b) manual TP+SP block, (c) "
          f"expert parallelism, (d) int8-compressed and plain DP, (e) two "
          f"tenants served on (1, 2) partitions of ranks 0-3")
    from repro_torch.launch.world import spawn_world
    torch.cuda.empty_cache()
    ts = time.perf_counter()
    ranks = spawn_world(DIST_RANKS, "chip_smoke:dist_rank_main",
                        sys_path=[str(ROOT)], timeout=900)
    wall_s = time.perf_counter() - ts
    r0 = ranks[0]
    launches = sum(r[c]["launches"] for r in ranks for c in "abc"
                   if c in r)
    for c, (arch, layers, b, l), shape in (
            ("a", DIST_TP, (1, 2)), ("b", DIST_SP, (1, DIST_RANKS)),
            ("c", DIST_EP, (1, 2))):
        x = r0[c]
        peaks = [r[c]["peak"] for r in ranks if c in r]
        n = sum(r[c]["launches"] for r in ranks if c in r)
        if c == "c":
            path = (f"{x['combines']} expert combines over \"model\" a "
                    f"rank, no expert all-gather; expert choice differs on "
                    f"{x['flipped']:.3%} of token-layers, |daux| "
                    f"{x['aux']:.2e}")
        else:
            path = (f"{x['seq'][0]} sequence all-gathers and {x['seq'][1]} "
                    f"reduce-scatters, {x['rows']} row all-reduces a rank")
        print(f"  ({c}) {arch} CONFIG x{layers} layers, B {b} x L {l} on "
              f"mesh {shape}: max |dlogit| {x['diff']:.3e} (<= {DIST_TOL} x "
              f"max |logit| {x['scale']:.3e}) against one rank on the ref "
              f"route; forward {x['ms']:.1f} ms (rank 0); B8 launches {n} "
              f"({layers} a rank); {path}; peak {max(peaks):.2f} GiB a "
              f"rank, {sum(peaks):.2f} GiB all ranks; case wall "
              f"{r0['wall'][c]:.1f} s", flush=True)
    d = r0["d"]
    print(f"  (d) {DIST_DP[0]} CONFIG x{DIST_DP[1]} layers on mesh (2, 1), "
          f"global batch {DIST_DP[2]} x {DIST_DP[3]}, {DIST_DP[4]} steps: "
          f"int8 compressed losses {[round(x, 5) for x in d['closs']]}, "
          f"the ranks' params bitwise equal after every step; step 1's "
          f"reduced gradient at most {d['worst']:.4f} x scale/2 from the "
          f"f32 mean; plain-DP Trainer {[round(x, 6) for x in d['dp_loss']]}"
          f" vs one rank {[round(x, 6) for x in d['one_loss']]} (max rel "
          f"{d['gap']:.2e}); {d['ms']:.1f} ms a compressed step; peak "
          f"{d['peak']:.2f} GiB a rank; case wall {r0['wall']['d']:.1f} s",
          flush=True)
    part = partition_report(ranks, r0["wall"]["e"])
    print(f"  phase 7c wall time {wall_s:.1f} s (spawn to exit, {DIST_RANKS}"
          f" ranks); NCCL across cards not exercised (one card); {card}",
          flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return {"flash_attention": launches, **part}


def partition_report(ranks, wall_s):
    """Print case (e), check that every partition rank launched each
    attention kernel of its variants, and return the partition engines'
    launches of them (every rank's)."""
    parts = sorted((r["e"] for r in ranks if "e" in r),
                   key=lambda x: x["rank"])
    total = {k.__name__: 0 for k in PART_KERNELS}
    for x in parts:
        for label, v in x["variants"].items():
            for name, n in v["counts"].items():
                total[name] += n
            used = [k for k, n in v["counts"].items() if n]
            check(len(used) == 2, f"partition {x['arch']} {label} rank "
                  f"{x['rank']}: kernels launched {v['counts']}")
    for x in (p for p in parts if p["lead"]):
        members = [p for p in parts if p["arch"] == x["arch"]]
        for label, v in x["variants"].items():
            counts = [m["variants"][label]["counts"] for m in members]
            kern = ", ".join(f"{k} {[c[k] for c in counts]}"
                             for k in counts[0] if counts[0][k])
            print(f"  (e) {x['arch']} CONFIG x{x['layers']} layers on "
                  f"partition ranks {[m['rank'] for m in members]} (1, 2), "
                  f"{label}: {v['heads']} KV head(s) a rank; lockstep max "
                  f"|dlogit| {v['worst']:.3e} x max |logit| (<= "
                  f"{v['tol']}) over {v['compared']} tokens, {v['ties']} "
                  f"near-tie(s) (top-2 gap <= {v['tol']} x max |logit|) "
                  f"where the one-rank engine would choose otherwise; "
                  f"{v['tokens']} tokens in {v['steps']} steps, partition "
                  f"step time {1e3 * v['serve_s'] / v['steps']:.1f} ms "
                  f"(rank 0 of it), {v['rows']} row all-reduces, no weight "
                  f"all-gather; launches a rank {kern}", flush=True)
        for label, v in x["variants"].items():
            if "restore" in v:
                r = v["restore"]
                print(f"  (e) {x['arch']} {label}: snapshot at step "
                      f"{r['at']} ({r['done']} request(s) done, "
                      f"{r['prefilling']} row(s) mid-prefill; save "
                      f"{r['save_s']:.2f} s), restored into a fresh engine "
                      f"on every rank of the partition ({r['load_s']:.2f} "
                      f"s), which finished in {r['steps']} steps "
                      f"({r['s']:.1f} s) with every token bitwise equal to "
                      f"the uninterrupted engine's", flush=True)
        if "ttl" in x:
            ends = [m["ttl"][0] for m in members]
            check(all(e == ends[0] for e in ends), f"partition "
                  f"{x['arch']} TTL: the ranks ended the requests "
                  f"otherwise: {ends}")
            want = {rid: "TIMEOUT" if ttl == 0.0 else "done"
                    for rid, ttl in enumerate(PART_TTLS)}
            check({rid: s for rid, (s, _) in ends[0].items()} == want,
                  f"partition {x['arch']} TTL: statuses {ends[0]}, want "
                  f"{want}")
            refused = [m["ttl"][1] for m in members]
            check(all("not onto mesh (data=2, model=1)" in t
                      for t in refused), f"partition {x['arch']}: a "
                  f"snapshot restored on the (2, 1) mesh: {refused}")
            print(f"  (e) {x['arch']} TTL on the lead rank's clock, the "
                  f"other rank's skewed by +{PART_SKEW[0]:.0f} s and "
                  f"+{PART_SKEW[1]:.0f} s a read: both ranks ended every "
                  f"request alike (rid: status, step) {ends[0]}; the "
                  f"partition's snapshot refused on every rank on the (2, "
                  f"1) mesh of its ranks ({x['ttl_s']:.1f} s)", flush=True)
        flips = (f"; expert choice differs on {x['flipped']:.3%} of "
                 f"token-layers" if "flipped" in x else "")
        print(f"  (e) {x['arch']}: peak "
              f"{[round(m['peak'], 2) for m in members]} GiB by rank "
              f"(the first also holds the one-rank engine's whole model); "
              f"build {x['build_s']:.1f} s{flips}", flush=True)
    print(f"  (e) both partitions served at once: case wall {wall_s:.1f} s",
          flush=True)
    return total


# ------------------------------------------------------- the examples (7d)
EXAMPLES = ROOT / "examples"
EXAMPLE_KERNELS = (aio_quant, aio_matmul, grouped_matmul, flash_decode,
                   flash_prefill)


class LockstepEngine(RouteEngine):
    """The multi-tenant example's engine (patched into its module): the
    example's engine on its kernel route, with a `shadow` engine of the
    same model on the ref route, put in this engine's state before every
    step and then taking the same step (phase 5's lockstep; an MoE
    shadow routes as this engine did). Every instance is kept in
    `made`."""

    made: list = []

    def __init__(self, cfg, model, *, policy, **kw):
        super().__init__(cfg, model, policy=policy, **kw)
        self.shadow = RouteEngine(cfg, model, follow=self, policy=dataclasses
                                  .replace(policy, backend="ref"), **kw)
        LockstepEngine.made.append(self)

    def submit(self, req):
        check(self.shadow.submit(dataclasses.replace(req)), "the shadow "
              f"refused request {req.rid}")
        return super().submit(req)

    def step(self):
        copy_state(self.shadow, self)
        done = super().step()
        self.shadow.step()
        return done


def quiet(fn, *args, **kw):
    """fn(*args, **kw) with its printing swallowed (a comparison run)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def example_launches(fn, *args, **kw):
    """fn(*args, **kw) and the launches of EXAMPLE_KERNELS it made."""
    before = {k.__name__: k.launches for k in EXAMPLE_KERNELS}
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches - before[k.__name__]
                 for k in EXAMPLE_KERNELS}


def examples_phase(dev, card):
    """Phase 7d: the four `examples/pt_*.py` at their reference sizes.
    Returns the launches of B5, B9, B10, B1 and B3 they made on their
    main paths."""
    phase("7d. the examples: pt_quickstart, pt_fp8_training, "
          "pt_morphable_inference and pt_multi_tenant_serving (kernel "
          "backend) on the card at the reference examples' sizes")
    sys.path.insert(0, str(EXAMPLES))
    import pt_fp8_training
    import pt_morphable_inference
    import pt_multi_tenant_serving
    import pt_quickstart
    t_phase = time.perf_counter()
    walls, total = {}, dict.fromkeys((k.__name__ for k in EXAMPLE_KERNELS),
                                     0)

    # pt_quickstart: B10 and B5 (matmul, quantizer), B9 (morphable GEMM)
    ts = time.perf_counter()
    (fmt, (outs, codes), (res, util, _), losses), counts = example_launches(
        lambda: (pt_quickstart.demo_formats(dev),
                 pt_quickstart.demo_quant_matmul(dev),
                 pt_quickstart.demo_morphable(dev),
                 pt_quickstart.demo_training(dev, TRAIN_DIR / "quickstart")))
    walls["pt_quickstart"] = time.perf_counter() - ts
    check(all(counts[k] for k in ("aio_quant", "aio_matmul",
                                  "grouped_matmul")),
          f"pt_quickstart: B10 / B5 / B9 did not launch: {counts}")
    for k, n in counts.items():
        total[k] += n
    check(fmt["csm"] == -3.375 and np.isfinite(losses).all(),
          f"pt_quickstart: CSM product {fmt['csm']}, losses {losses}")
    plain, plain_codes = quiet(pt_quickstart.demo_quant_matmul, dev,
                               backend="ref")
    for mode, (out, rel) in outs.items():
        want, want_rel = plain[mode]
        if mode == "int8":
            ok = np.array_equal(out, want) and rel == want_rel
        else:
            ok = np.allclose(out, want, rtol=GEMM_TOL,
                             atol=GEMM_TOL * np.abs(want).max()) and \
                abs(rel - want_rel) <= GEMM_TOL * want_rel
        check(ok, f"pt_quickstart {mode}: rel err {rel} on the kernels, "
              f"{want_rel} on the plain route")
    for mode, (q, sc) in codes.items():
        check(np.array_equal(q, plain_codes[mode][0]) and
              np.array_equal(sc, plain_codes[mode][1]),
              f"pt_quickstart {mode}: quantizer codes differ from plain")
    p_res, p_util, _ = quiet(pt_quickstart.demo_morphable, dev,
                             backend="ref")
    worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(res, p_res))
    check(util == p_util and worst <= 1e-5, f"pt_quickstart morphable: "
          f"util {util} vs {p_util}, max |diff| {worst:.2e} x max |plain|")
    print(f"  pt_quickstart: matmul rel err {[round(outs[m][1], 4) for m in outs]}"
          f" ({list(outs)}), equal to the plain route's (int8 bitwise, "
          f"float within rtol {GEMM_TOL}); quantizer codes bitwise equal; "
          f"morphable GEMM within {worst:.2e} x max |plain|, utilization "
          f"{util:.3f}; losses {[round(x, 4) for x in losses]}; launches "
          f"{counts}; {walls['pt_quickstart']:.1f} s", flush=True)

    # pt_fp8_training: its two asserts, at the reference's 40 steps
    ts = time.perf_counter()
    try:
        (l_f32, l_fp8), counts = example_launches(pt_fp8_training.main, [])
    except AssertionError as err:
        check(False, f"pt_fp8_training: {err}")
    walls["pt_fp8_training"] = time.perf_counter() - ts
    check(not any(counts.values()), f"pt_fp8_training: a kernel launched "
          f"under autograd: {counts}")
    print(f"  pt_fp8_training: both asserts held; losses f32 "
          f"{l_f32[0]:.4f} -> {l_f32[-1]:.4f}, fp8a {l_fp8[0]:.4f} -> "
          f"{l_fp8[-1]:.4f}; {walls['pt_fp8_training']:.1f} s", flush=True)

    # pt_morphable_inference: the card's plans and utilizations are the
    # CPU's
    ts = time.perf_counter()
    got = pt_morphable_inference.kernel_level(dev)
    n_plans, modeled = pt_morphable_inference.hardware_level()
    walls["pt_morphable_inference"] = time.perf_counter() - ts
    cpu = quiet(pt_morphable_inference.kernel_level, "cpu")
    check(got == cpu, f"pt_morphable_inference: card {got} vs CPU {cpu}")
    print(f"  pt_morphable_inference: plans and utilizations equal to the "
          f"CPU run's; {n_plans} fusion plans; MODELED ms {modeled}; "
          f"{walls['pt_morphable_inference']:.1f} s", flush=True)

    # pt_multi_tenant_serving on the kernels, each engine in lockstep with
    # a ref shadow
    LockstepEngine.made.clear()
    ts = time.perf_counter()
    with patched(pt_multi_tenant_serving, "ServingEngine", LockstepEngine):
        served, counts = example_launches(pt_multi_tenant_serving.main,
                                          ["--backend", "cuda"])
    walls["pt_multi_tenant_serving"] = time.perf_counter() - ts
    check(sorted(served) == ["assistant", "captioning"]
          and len(LockstepEngine.made) == 2, f"pt_multi_tenant_serving: "
          f"served {sorted(served)}, {len(LockstepEngine.made)} engines")
    check(counts["flash_decode"] and counts["flash_prefill"],
          f"pt_multi_tenant_serving: B1 / B3 did not launch: {counts}")
    for k, n in counts.items():
        total[k] += n
    for (name, _, _), eng in zip(pt_multi_tenant_serving.TENANTS,
                                 LockstepEngine.made):
        check_no_faults(f"pt_multi_tenant_serving {name}", eng, eng.shadow)
        check(not eng.shadow.pending(), f"{name}: the shadow did not drain")
        compared, skipped, bad = compare(name, tokens(eng), eng.shadow)
        check(bad is None, f"pt_multi_tenant_serving lockstep: {bad}")
        print(f"  pt_multi_tenant_serving [{name}]: lockstep against the "
              f"ref route: {compared} tokens match, {skipped} near-tie "
              f"step(s) skipped; {served[name][1]:.0f} ms", flush=True)
    LockstepEngine.made.clear()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"  example wall times (s): "
          f"{ {k: round(v, 1) for k, v in walls.items()} }; launches "
          f"{total}; phase 7d {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return total


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--write-baseline"]):
        sys.exit("usage: python3 chip_smoke.py [--write-baseline]")
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
    oracle_phase(dev)
    analysis_rep, drift = analysis_phase(smi)
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
    recurrent_launches, d80_errs = recurrent_phase(dev, smi)
    for kname, n in recurrent_launches.items():
        launches[kname] += n
    for kname, err in d80_errs.items():
        errs[kname] = max(errs[kname], err)
    frontend_launches, frontend_errs = frontends_phase(dev, smi)
    for kname, n in frontend_launches.items():
        launches[kname] += n
    for kname, err in frontend_errs.items():
        errs[kname] = max(errs[kname], err)
    for kname, n in tenancy_phase(dev, smi).items():
        launches[kname] += n
    for kname, n in fullseq_phase(dev, smi).items():
        launches[kname] += n
    launches.update(morphable_phase(dev))
    for kname, n in training_phase(dev, smi).items():
        launches[kname] += n
    long_launches, long_errs = long_phase(dev, smi)
    for kname, n in long_launches.items():
        launches[kname] += n
    for kname, err in long_errs.items():
        errs[kname] = max(errs[kname], err)
    for kname, n in distribution_phase(smi).items():
        launches[kname] += n
    for kname, n in examples_phase(dev, smi).items():
        launches[kname] += n
    phase("8. summary")
    demotions = [w for w in WARNINGS if DEMOTED in w]
    check(len(demotions) == 2, f"{len(demotions)} engine demotions in the "
          f"run, want only phase 5c's two injected ones: {demotions}")
    print("engine demotions: the two injected in phase 5c, no other",
          flush=True)
    pinned = cuda_baseline().get("engines", {})
    for label, rep in HOTLOOP.items():
        drift += [f"{label}: {m}" for m in analysis.compare_baseline(
            rep, pinned.get(label, {}))]
    drift += [f"{label}: pinned in the baseline, but no engine of that "
              "label was audited" for label in pinned if label not in HOTLOOP]
    print("hot-loop audits: " + json.dumps(
        {label: analysis.run.counts_by_code(rep)
         for label, rep in HOTLOOP.items()}), flush=True)
    if argv:
        write_cuda_baseline(analysis_rep)
        drift = []
    check(not drift, "static-analysis findings drifted from the baseline's "
          f"cuda section ({BASELINE.name}): {drift}")
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
