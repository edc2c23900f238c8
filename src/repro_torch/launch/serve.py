"""Serving launcher.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1p5b \\
        --requests 6 --max-new 8                         # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1p5b \\
        --smoke --device cpu --requests 2 --max-new 4    # plain, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1p5b \\
        --weight-format int4                             # resident int4
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --paged --block-size 8                           # paged KV pool
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2p7b \\
        --weight-format int4                     # hybrid: merged launches
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --paged --pool-blocks 16 --priority 0,1 --swap-watermark 0.75 \\
        --deadline-steps 40 --max-queue 8                # robustness knobs

Random weights from seed 0, 4 slots of 128 positions, prompts of 3-9
random tokens. Prints the routes the attention and the Linear weights
take, the token rate and the launch counts of the kernels, the fault
counters, every route demotion, and with --paged the block pool's
occupancy, sharing and swap counters.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.formats import RESIDENT_FORMATS
from ..kernels.aio_matmul import aio_matmul
from ..kernels.aio_quant import aio_quant
from ..kernels.flash_attention import KERNELS as ATTENTION_KERNELS
from ..kernels.flash_attention import PAGED_KERNELS
from ..models import init_params, quantize_params
from ..serving import Request, ServingEngine


KERNELS = (*ATTENTION_KERNELS, *PAGED_KERNELS, aio_matmul, aio_quant)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1p5b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config instead of full width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (codes + pow2 scales)")
    ap.add_argument("--weight-format", choices=RESIDENT_FORMATS,
                    help="serve the Linear weights resident in this format "
                         "(quantizer + AIO GEMM kernels on every Linear)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens a row advances per admission launch")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged block-pool KV cache (prefix "
                         "sharing, copy-on-write, LRU eviction)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="positions per pool block (--paged; divides 128)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="blocks in the pool (--paged; default: every slot "
                         "can reach max_len)")
    ap.add_argument("--swap-watermark", type=float, default=1.0,
                    help="fraction of the pool an admission may fill before "
                         "the engine evicts cold prefixes and then PREEMPTS "
                         "lower-priority rows (live KV swapped to the host, "
                         "resumed bitwise); 1.0 = only when a reservation "
                         "cannot be met at all (--paged)")
    ap.add_argument("--priority", default=None,
                    help="comma-separated priority cycle given to the "
                         "requests, e.g. '0,1' alternates low and high; "
                         "higher preempts lower under pool pressure")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: submits past it are "
                         "REJECTED instead of queued")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request deadline in engine steps; an expired "
                         "request finishes with status TIMEOUT")
    ap.add_argument("--ttl-s", type=float, default=None,
                    help="per-request wall-clock TTL in seconds")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant)
    model = init_params(cfg, seed=0, device=args.device)
    if args.weight_format:
        # in place, so the dense weights are freed before the engine's
        # caches exist (the reference's launcher quantizes with donation)
        quantize_params(model, args.weight_format)
    eng = ServingEngine(cfg, model, slots=4, max_len=128,
                        prefill_chunk=args.prefill_chunk, paged=args.paged,
                        block_size=args.block_size,
                        pool_blocks=args.pool_blocks,
                        swap_watermark=args.swap_watermark,
                        max_queue=args.max_queue,
                        deadline_steps=args.deadline_steps, ttl_s=args.ttl_s)
    t0 = time.perf_counter()
    eng.warmup()
    print(f"[serve:{args.arch}] warmup {time.perf_counter() - t0:.2f}s "
          f"(prefill route {eng.prefill_route()}, decode route "
          f"{eng.decode_route()}, weight route {eng.weight_route()}, device "
          f"{eng.device})")
    for k in KERNELS:
        k.launches = 0
    priorities = ([int(x) for x in args.priority.split(",")]
                  if args.priority else [0])
    rng = np.random.RandomState(0)
    for rid in range(args.requests):
        prompt = rng.randint(1, cfg.vocab, rng.randint(3, 10)).astype(np.int32)
        eng.submit(Request(rid, prompt, max_new_tokens=args.max_new,
                           priority=priorities[rid % len(priorities)]))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    st = eng.stats
    print(f"[serve:{args.arch}] {len(done)} requests, {toks} tokens, "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s; {st.decode_steps} decode "
          f"steps, {st.prefill_chunk_calls} chunked prefills, "
          f"{st.prefill_token_steps} prefill token steps)")
    print(f"[serve:{args.arch}] kernel launches: "
          + ", ".join(f"{k.__name__}={k.launches}" for k in KERNELS))
    print(f"[serve:{args.arch}] fault counters: quarantines={st.quarantines} "
          f"demotions={st.demotions} timeouts={st.timeouts} "
          f"rejected={st.rejected_submits} failed={st.failed_requests}")
    if args.paged:
        ps = eng.pool_stats()
        print(f"[serve:{args.arch}] pool: {ps['pool_blocks']} blocks "
              f"(block_size={ps['block_size']}) used={ps['used_blocks']} "
              f"registry={ps['registry_entries']} "
              f"hits={ps['prefix_hits']}/{ps['admitted']} "
              f"shared_tokens={ps['shared_tokens']} cow={ps['cow_copies']} "
              f"evictions={ps['evictions']} skips={ps['eviction_skips']} "
              f"deferred={ps['deferred_admissions']}")
        print(f"[serve:{args.arch}] swap: watermark "
              f"{ps['swap_watermark']:.2f} (soft cap "
              f"{ps['watermark_blocks']} blocks) preemptions="
              f"{ps['preemptions']} out={ps['swap_outs']} "
              f"in={ps['swap_ins']} bytes_out={ps['swap_bytes_out']} "
              f"bytes_in={ps['swap_bytes_in']} host_resident="
              f"{ps['host_blocks']} blocks ({ps['host_bytes']} B)")
    for ev in eng.degraded_routes():
        print(f"[serve:{args.arch}] DEGRADED at step {ev['step']}: "
              f"{ev['from']} -> {ev['to']} ({ev['error']})")
    return done


if __name__ == "__main__":
    main()
