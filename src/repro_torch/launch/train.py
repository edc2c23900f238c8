"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --smoke --steps 3 --batch 2 --seq 16 --device cpu \\
        --ckpt-dir /tmp/ck                               # plain, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 50 --batch 4 --seq 512 --ckpt-every 1000  # on the card

The reference launcher's flags, plus --device (default cuda). Random
weights from seed 0, the synthetic Markov stream (`data.SyntheticLM`,
seed 0) behind a prefetch thread, the cosine schedule with a warmup of
steps / 20. Restarts from the newest checkpoint under --ckpt-dir
automatically, and always writes a final checkpoint.
--simulate-preemption N stops the loop at step N, writes its checkpoint
and restarts from it in a fresh Trainer, exercising the fault-tolerance
path end to end.

The checkpoint's data position is that of the batches the trainer has
consumed, not the prefetcher's (which runs up to its depth ahead), so a
restart replays no batch and skips none: a preempted run ends with the
params of an uninterrupted one. (The reference launcher checkpoints the
source's own position and so may skip up to the prefetch depth.)

Distributed: under a launcher environment (`torchrun --nproc-per-node N
-m repro_torch.launch.train ... --model-parallel M`, or RANK / WORLD_SIZE
/ MASTER_ADDR / MASTER_PORT set by hand, or --init-method) the process
group starts from it (`launch.mesh.init_world`: NCCL when each rank has a
card of its own, gloo otherwise) and the mesh is (world / M, M) ("data",
"model"). Every rank reads the same global batch from the same stream;
the Trainer takes its DP rows. Rank 0 prints and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Iterator, Optional, Sequence

import torch

from ..configs import get_config, get_smoke
from ..data import DataConfig, PipelineState, Prefetcher, SyntheticLM
from ..runtime import Trainer, TrainerConfig
from .mesh import init_world, make_local_mesh, rank_device


def _consumed(it: Iterator, state: PipelineState) -> Iterator:
    """`it`'s batches, advancing `state` by one as each is handed out."""
    for batch in it:
        state.step += 1
        yield batch


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Run the launcher on `argv` (default: the command line); returns
    the Trainer that ran the last steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--simulate-preemption", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of a multi-rank world (default: the "
                         "launcher environment, env://)")
    args = ap.parse_args(argv)

    mesh, device, lead = None, args.device, True
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", 1))
    if args.model_parallel < 1 or world % args.model_parallel:
        raise ValueError(
            f"--model-parallel {args.model_parallel} does not divide the "
            f"world of {world} rank(s): start the ranks with torchrun, or "
            "set RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, or pass "
            "--init-method with RANK / WORLD_SIZE")
    if args.model_parallel > 1 or args.init_method or world > 1 or \
            torch.distributed.is_initialized():
        init_world(init_method=args.init_method, device=args.device)
        mesh = make_local_mesh(model=args.model_parallel)
        device = rank_device(args.device)
        lead = torch.distributed.get_rank() == 0

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         base_lr=args.lr, total_steps=args.steps,
                         warmup=max(args.steps // 20, 1))

    def make_data(trainer: Trainer) -> Prefetcher:
        src = SyntheticLM(DataConfig(
            vocab=cfg.vocab, batch=args.batch, seq=args.seq,
            frontend=cfg.frontend, frontend_len=cfg.frontend_len,
            d_model=cfg.d_model), PipelineState(trainer.pipeline_state.step))
        consumed = PipelineState(trainer.pipeline_state.step)
        trainer.attach_pipeline(consumed)
        return Prefetcher(src)

    def on_step(step, m):
        if lead and (step % 10 == 0 or step == 1):
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{m['step_time_s']*1e3:.0f} ms", flush=True)

    def train_until(last: int) -> Trainer:
        trainer = Trainer(cfg, tcfg, seed=0, device=device, mesh=mesh)
        resumed = trainer.maybe_restore()
        if resumed and lead:
            print(f"[train] resumed from checkpoint step {resumed}")
        start = int(trainer.opt_state.step)
        data = make_data(trainer)
        try:
            trainer.run(_consumed(data, trainer.pipeline_state),
                        max(last - start, 0), on_step=on_step)
        finally:
            data.close()
        trainer.checkpoint(int(trainer.opt_state.step))
        trainer.wait()
        return trainer

    preempt = args.simulate_preemption
    trainer = train_until(preempt if 0 < preempt < args.steps else args.steps)
    if int(trainer.opt_state.step) < args.steps:
        if lead:
            print("[train] simulated preemption — restarting from "
                  "checkpoint")
        trainer = train_until(args.steps)
    if lead:
        print("[train] done")
    return trainer


if __name__ == "__main__":
    main()
