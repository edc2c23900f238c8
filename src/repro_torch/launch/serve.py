"""Serving launcher — single- or multi-tenant.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --format int8 --backend ref      # fake-quant int8 Linears, ref route
    PYTHONPATH=src python -m repro_torch.launch.serve --multi-tenant \\
        --requests 2 --max-new 4         # two tenants on the card's grid
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --multi-tenant --device cpu --backend ref    # on a world of ranks

Random weights from seed 0, 4 slots of 128 positions, prompts of 3-9
random tokens. Prints the routes the attention and the Linear weights
take, the slots' occupancy mid-flight, the token rate and the launch
counts of the kernels, the fault counters, every route demotion, and with
--paged the block pool's occupancy, sharing and swap counters.

--multi-tenant runs the paper's §VI-C scenario shape, as the reference
launcher does: a captioning tenant (olmoe_1b_7b) and a classification
tenant (qwen2_1p5b), both declared in int8, placed by the morphable
scheduler on partitions of the device grid (one card: the fused 128x128
plan, both tenants in one partition), and served one after the other
through `MorphableScheduler.run` from their SMOKE configs, whatever
--smoke says. On a world of ranks (`torchrun`, or a caller that started the
process group) the scheduler's grid is the world's ranks: on 4 ranks each
tenant gets a (1, 2) partition of its own, the two partitions serve at
once, each rank builds its shards of the tenant's weights
(`dist.init_sharded`; whole weights with --weight-format, which are served
replicated) and serves tensor-parallel, and rank 0 of each partition
prints the tenant's lines. Each rank runs on `launch.mesh.rank_device`:
its own card under NCCL, the given device under gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

import torch.distributed as dist

from .. import api
from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.formats import RESIDENT_FORMATS
from ..dist import init_sharded
from ..dist.sharding import ctx_mesh
from ..kernels.aio_matmul import aio_matmul
from ..kernels.aio_quant import aio_quant
from ..kernels.flash_attention import KERNELS as ATTENTION_KERNELS
from ..kernels.flash_attention import PAGED_KERNELS
from ..models import init_params, quantize_params
from ..models.layers import QuantPolicy
from ..serving import Request, ServingEngine
from ..tenancy import MorphableScheduler, Tenant, device_grid
from .mesh import init_world, rank_device


KERNELS = (*ATTENTION_KERNELS, *PAGED_KERNELS, aio_matmul, aio_quant)
# the reference launcher's §VI-C tenants: (name, arch, weight rows, cols)
TENANTS = (("captioning", "olmoe_1b_7b", 64, 512),
           ("classification", "qwen2_1p5b", 64, 768))


def _lead() -> bool:
    """True outside a partition, and on the first rank of one: the rank
    that speaks for its partition."""
    mesh = ctx_mesh()
    return mesh is None or all(mesh.get_local_rank(n) == 0
                               for n in mesh.mesh_dim_names)


def _say(*args, **kwargs) -> None:
    if _lead():
        print(*args, **kwargs)


def _occupancy_line(eng: ServingEngine) -> str:
    cells = ["--" if o is None else f"r{o['rid']}+{o['generated']}"
             for o in eng.occupancy()]
    return f"slots [{' '.join(cells)}] util {eng.utilization():.2f}"


def _run_engine(arch: str, smoke: bool, n_requests: int, max_new: int,
                seed: int = 0, policy: api.ExecutionPolicy = None,
                sched=None, tenant: str = None, weight_format: str = None,
                device="cuda", kv_quant: bool = False,
                prefill_chunk: int = 32, max_queue: int = None,
                deadline_steps: int = None, ttl_s: float = None,
                paged: bool = False, block_size: int = 16,
                pool_blocks: int = None, swap_watermark: float = 1.0,
                priorities: list = None):
    """Build one engine (random weights from `seed`), serve `n_requests`
    random prompts step by step and return the finished requests. Under a
    partition's mesh the weights are this rank's shards (whole with
    `weight_format`: resident codes are served replicated)."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    if policy is not None and policy.format != "bf16":
        # the policy's format plane reaches the model through its
        # QuantPolicy: every Linear fake-quantizes activations and weights
        # to the format
        cfg = dataclasses.replace(cfg, quant=QuantPolicy(
            activations=policy.format, weights=policy.format))
    mesh = ctx_mesh()
    if mesh is not None and weight_format in (None, "none"):
        model = init_sharded(cfg, mesh, seed=seed, device=device)
    else:
        model = init_params(cfg, seed=seed, device=device)
    if weight_format not in (None, "none"):
        # in place, so the dense weights are freed before the engine's
        # caches exist (the reference's launcher quantizes with donation)
        quantize_params(model, weight_format)
    eng = ServingEngine(cfg, model, slots=4, max_len=128, policy=policy,
                        prefill_chunk=prefill_chunk, paged=paged,
                        block_size=block_size, pool_blocks=pool_blocks,
                        swap_watermark=swap_watermark, max_queue=max_queue,
                        deadline_steps=deadline_steps, ttl_s=ttl_s)
    t0 = time.perf_counter()
    eng.warmup()
    _say(f"[serve:{arch}] warmup {time.perf_counter() - t0:.2f}s "
         f"(prefill route {eng.prefill_route()}, decode route "
         f"{eng.decode_route()}, weight route {eng.weight_route()}, device "
         f"{eng.device})")
    if sched is not None and tenant is not None:
        sched.attach_engine(tenant, eng)
    for k in KERNELS:
        k.launches = 0
    rng = np.random.RandomState(seed)
    for rid in range(n_requests):
        prompt = rng.randint(1, cfg.vocab, rng.randint(3, 10)).astype(np.int32)
        prio = priorities[rid % len(priorities)] if priorities else 0
        if not eng.submit(Request(rid, prompt, max_new_tokens=max_new,
                                  priority=prio)):
            _say(f"[serve:{arch}] request {rid} REJECTED "
                 f"(queue full at {max_queue})")
    # drive step by step so the slots' occupancy is observable mid-flight
    t0 = time.perf_counter()
    while eng.pending():
        eng.step()
        if eng.stats.decode_steps in (1, max(2, max_new // 2)):
            _say(f"[serve:{arch}] step {eng.stats.decode_steps}: "
                 f"{_occupancy_line(eng)}")
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = eng.finished
    toks = sum(len(r.out_tokens) for r in done)
    st = eng.stats
    _say(f"[serve:{arch}] {len(done)} requests, {toks} tokens, "
         f"{dt:.2f}s ({toks / dt:.1f} tok/s; {st.decode_steps} decode "
         f"steps, {st.prefill_chunk_calls} chunked prefills, "
         f"{st.prefill_token_steps} prefill token steps)")
    _say(f"[serve:{arch}] kernel launches: "
         + ", ".join(f"{k.__name__}={k.launches}" for k in KERNELS))
    _say(f"[serve:{arch}] fault counters: quarantines={st.quarantines} "
         f"demotions={st.demotions} timeouts={st.timeouts} "
         f"rejected={st.rejected_submits} failed={st.failed_requests}")
    if paged:
        ps = eng.pool_stats()
        _say(f"[serve:{arch}] pool: {ps['pool_blocks']} blocks "
             f"(block_size={ps['block_size']}) used={ps['used_blocks']} "
             f"registry={ps['registry_entries']} "
             f"hits={ps['prefix_hits']}/{ps['admitted']} "
             f"shared_tokens={ps['shared_tokens']} cow={ps['cow_copies']} "
             f"evictions={ps['evictions']} skips={ps['eviction_skips']} "
             f"deferred={ps['deferred_admissions']}")
        _say(f"[serve:{arch}] swap: watermark "
             f"{ps['swap_watermark']:.2f} (soft cap "
             f"{ps['watermark_blocks']} blocks) preemptions="
             f"{ps['preemptions']} out={ps['swap_outs']} "
             f"in={ps['swap_ins']} bytes_out={ps['swap_bytes_out']} "
             f"bytes_in={ps['swap_bytes_in']} host_resident="
             f"{ps['host_blocks']} blocks ({ps['host_bytes']} B)")
    for ev in eng.degraded_routes():
        _say(f"[serve:{arch}] DEGRADED at step {ev['step']}: "
             f"{ev['from']} -> {ev['to']} ({ev['error']})")
    _say(f"[serve:{arch}] tokens: " + "; ".join(
        f"r{r.rid} {list(r.out_tokens)}"
        for r in sorted(done, key=lambda r: r.rid)))
    return done


def main(argv=None):
    """Returns the finished requests, or with --multi-tenant a dict of
    them by tenant name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1p5b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config instead of full width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--multi-tenant", action="store_true",
                    help="two tenants (olmoe_1b_7b captioning, qwen2_1p5b "
                         "classification; SMOKE configs) on the morphable "
                         "scheduler's partitions of the device grid")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "ref"),
                    help="ExecutionPolicy backend plane: 'auto' routes the "
                         "attention and resident Linears to the kernels "
                         "(their plain versions on CPU tensors), 'cuda' "
                         "too but refuses CPU tensors, 'ref' runs the plain "
                         "eager reference")
    ap.add_argument("--format", default="bf16",
                    choices=("bf16", "fp8a", "fp8b", "int8", "int4"),
                    help="AIO format applied to every Linear through the "
                         "model's QuantPolicy (fake-quantized activations "
                         "and weights; bf16 = none)")
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

    policy = api.ExecutionPolicy(format=args.format, backend=args.backend)
    priorities = ([int(x) for x in args.priority.split(",")]
                  if args.priority else None)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1"))) > 1
    if world and not args.multi_tenant:
        ap.error("a world of ranks serves --multi-tenant only")
    if world:
        own = not dist.is_initialized()
        init_world(device=args.device)
        try:
            return _multi_tenant(args, policy, MorphableScheduler(),
                                 rank_device(args.device))
        finally:
            if own:
                dist.destroy_process_group()
    if not args.multi_tenant:
        return _run_engine(args.arch, args.smoke, args.requests,
                           args.max_new, policy=policy,
                           weight_format=args.weight_format,
                           device=args.device, kv_quant=args.kv_quant,
                           prefill_chunk=args.prefill_chunk,
                           max_queue=args.max_queue,
                           deadline_steps=args.deadline_steps,
                           ttl_s=args.ttl_s, paged=args.paged,
                           block_size=args.block_size,
                           pool_blocks=args.pool_blocks,
                           swap_watermark=args.swap_watermark,
                           priorities=priorities)

    # §VI-C-shaped scenario: two tenants on morphable grid partitions (the
    # card's grid, or one CPU device when asked for the CPU)
    sched = MorphableScheduler(None if args.device == "cuda"
                               else device_grid([[args.device]]))
    return _multi_tenant(args, policy, sched, args.device)


def _multi_tenant(args, policy, sched, device) -> dict:
    """Plan the two tenants onto the scheduler's partitions and serve each
    on its own; returns {tenant: finished requests} of the tenants this
    process served (on a world of ranks, those of its partition)."""
    parts = sched.reconfigure([Tenant(name, weight_rows=rows,
                                      weight_cols=cols, fmt="int8")
                               for name, _, rows, cols in TENANTS])
    rank = dist.get_rank() if sched.ranks is not None else 0
    if rank == 0:
        where = "" if sched.ranks is None else "; ranks " + str(
            [p.ranks for p in parts])
        print(f"[serve] fusion plan: {sched.plan.describe()}; partitions: "
              f"{[p.tenants for p in parts]}{where}")
    done = {}
    for tenant, arch, _, _ in TENANTS:
        got = sched.run(
            tenant, _run_engine, arch, True, args.requests, args.max_new,
            policy=policy, sched=sched, tenant=tenant,
            weight_format=args.weight_format, device=device,
            prefill_chunk=args.prefill_chunk)
        if got is not None:
            done[tenant] = got
    for name, occ in sched.occupancy().items():
        ranks = sched.partition_of(name).ranks
        if ranks is None or ranks[0] == rank:
            print(f"[serve] tenant {name}: final {len(occ)} slots, "
                  f"{sum(o is not None for o in occ)} busy")
    return done


if __name__ == "__main__":
    main()
