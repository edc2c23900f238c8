"""The paper's §VI-C scenario end to end on the PyTorch/CUDA port (the
port's `examples/multi_tenant_serving.py`).

Two applications share one "chip":
  * image captioning: a vision-conditioned MoE LM (olmoe SMOKE stands in
    for the CNN+Transformer captioner, as in the reference),
  * text assistant: a decoder-only LM tenant (olmo-1b SMOKE).

The morphable scheduler fissions the grid per Fig 8, each tenant runs its
serving engine on its partition, INT8 weights via the AIO format plane,
and each tenant's latency is reported.

Run:  python examples/pt_multi_tenant_serving.py [--device cpu]
          [--backend ref|auto|cuda]
or, the tenants at once on partitions of ranks:
      torchrun --nproc-per-node 4 examples/pt_multi_tenant_serving.py

In one process the tenants run in turn, whatever the grid; under
`torchrun` (a world of several ranks) each tenant is served on its own
partition of ranks, tensor-parallel, and the partitions run at once. The
engines run on the card unless `--device cpu` is given; with no card and
no `--device cpu` it stops with an error. `--backend` defaults to the
reference example's "ref"; "cuda" (or "auto") takes the kernels.

Deliberate differences from the reference example: each tenant's weights
come from a fixed seed (`zlib.crc32` of its name; the reference's
`hash(name)` changes with every process), and no concurrency is claimed
for tenants that ran one after the other.
"""
import argparse
import os
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api, resolve_device
from repro_torch.configs import get_smoke
from repro_torch.core import formats as F
from repro_torch.dist import shard_params
from repro_torch.dist.sharding import ctx_mesh
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine
from repro_torch.tenancy import MorphableScheduler, Tenant, device_grid

TENANTS = (("captioning", "olmoe_1b_7b", 512),
           ("assistant", "olmo_1b", 768))       # (name, arch, weight cols)


@torch.no_grad()
def quantize_params_int8(model):
    """PTQ every weight the reference's pytree holds as an array of >= 2
    dims with a last axis of >= 8 to int8 codes and a pow2 scale per row
    of its last axis, and decode it back, in place: the serving deployment
    path of the format plane. A layer's tensors are stacked over the
    layers in the reference's pytree, so a layer's vectors (norm gains,
    biases) are quantized too, one scale each."""
    for name, p in model.named_parameters():
        ndim = p.dim() + name.startswith("layers.")
        if ndim >= 2 and p.shape[-1] >= 8:
            codes, scale = F.quantize_scaled(p, F.INT8, axis=-1, pow2=True)
            p.copy_(F.decode(codes, F.INT8) * scale)
    return model


def tenant_seed(name: str) -> int:
    return zlib.crc32(name.encode()) % 2 ** 31


def run_tenant(name, arch, n_requests=3, max_new=6, int8=True, *,
               device="cuda", backend="ref"):
    """Serve `n_requests` random 6-token prompts on the tenant's engine (2
    slots, max_len 96) under the ambient partition: on a partition of
    ranks the weights are cut to this rank's shards after the int8
    round trip. Returns (finished requests, wall ms)."""
    dev = resolve_device(device)
    cfg = get_smoke(arch)
    model = init_params(cfg, seed=tenant_seed(name), device=dev)
    if int8:
        quantize_params_int8(model)
    mesh = ctx_mesh()
    if mesh is not None:
        shard_params(model, mesh)
    eng = ServingEngine(cfg, model, slots=2, max_len=96,
                        policy=api.ExecutionPolicy(backend=backend))
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for rid in range(n_requests):
        eng.submit(Request(rid, rng.randint(1, cfg.vocab, 6).astype(np.int32),
                           max_new_tokens=max_new))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) * 1e3
    if mesh is None or all(mesh.get_local_rank(n) == 0
                           for n in mesh.mesh_dim_names):
        print(f"  [{name}] {len(done)} requests in {dt:.0f} ms "
              f"({sum(len(r.out_tokens) for r in done)} tokens, "
              f"int8={int8})")
    return done, dt


def in_world() -> bool:
    """A live process group of several ranks."""
    return dist.is_initialized() and dist.get_world_size() > 1


def scheduler(device) -> MorphableScheduler:
    """The world's ranks on a live world of several ranks (started here
    under `torchrun`), the card(s) on CUDA, one CPU device otherwise."""
    if in_world() or device.type == "cuda":
        return MorphableScheduler()
    return MorphableScheduler(device_grid([[device]]))


def main(argv=None):
    """Plan the two tenants, serve each through `sched.run`; returns
    {tenant: (finished requests, wall ms)} of the tenants this process
    served."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="ref",
                    choices=("ref", "auto", "cuda"),
                    help="the engines' ExecutionPolicy backend")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    started = int(os.environ.get("WORLD_SIZE", 1)) > 1 \
        and not dist.is_initialized()
    if started:
        from repro_torch.launch.mesh import init_world
        init_world(device=dev.type)
    world = in_world()
    if world:
        from repro_torch.launch.mesh import rank_device
        dev = rank_device(args.device)
    sched = scheduler(dev)
    lead = not world or dist.get_rank() == 0
    parts = sched.reconfigure([Tenant(name, 64, cols, fmt="int8")
                               for name, _, cols in TENANTS])
    if lead:
        print(f"fusion plan: {sched.plan.describe()}")
        for p in parts:
            where = (f"ranks {p.ranks}" if p.ranks is not None else
                     f"{p.mesh.devices.size} device(s)")
            print(f"  partition {p.tenants}: {where}")
    served = {}
    for name, arch, _ in TENANTS:
        got = sched.run(name, run_tenant, name, arch, device=dev,
                        backend=args.backend)
        if got is not None:
            served[name] = got
    ms = [served[name][1] if name in served else 0.0
          for name, *_ in TENANTS]
    if world:
        t = torch.tensor(ms, dtype=torch.float64, device=dev if
                         dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        ms = t.tolist()
        if lead:
            print(f"the tenants ran at once on their partitions of ranks: "
                  f"makespan {max(ms):.0f} ms (slowest tenant)")
        if started:
            dist.barrier()
            dist.destroy_process_group()
    else:
        print(f"the tenants ran in turn in one process: makespan "
              f"{sum(ms):.0f} ms (the sum)")
    if lead:
        print("multi_tenant_serving OK")
    return served


if __name__ == "__main__":
    main()
