"""Fault-tolerant training runtime: the reference's
`repro.runtime.trainer`, on one device or over a mesh.

Responsibilities:
  * the train loop (`launch.steps.make_train_step`, in place on the
    model's parameters and the AdamW state),
  * placement: with a mesh, the parameters are cut to this rank's shards
    by the specs (`dist.shard_params`) and the AdamW state is built over
    those shards, so it mirrors their placement; each DP rank trains on
    its slice of the global batch and the gradients are mean-all-reduced
    over DP (the reference's implicit GSPMD psum),
  * periodic async checkpoints of the params, the optimizer state and the
    pipeline state (checkpoint/restart, `checkpoint.store`); over a mesh
    the shards are all-gathered and one rank writes full, unsharded
    tensors,
  * straggler mitigation: a per-step deadline watchdog -- steps that exceed
    `straggler_factor` x the trailing-median step time are counted; after
    `max_straggler_strikes` the runtime raises StragglerAbort for the
    harness to act on,
  * elastic re-mesh: `elastic_restart` rebuilds the trainer on another
    mesh and restores the newest checkpoint onto it (its full tensors are
    cut to the new mesh's shards).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..checkpoint.store import AsyncCheckpointer, latest_step, restore
from ..data.pipeline import PipelineState
from ..dist.collectives import all_gather, barrier
from ..dist.grads import param_shards
from ..dist.sharding import axis_rank
from ..dist.specs import shard_params
from ..launch.steps import make_train_step
from ..models import transformer as T
from ..optim import adamw_init

__all__ = ["TrainerConfig", "Trainer", "StragglerAbort", "elastic_restart"]


class StragglerAbort(RuntimeError):
    """Raised when repeated straggling steps demand a restart."""


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_ckpts: int = 3
    base_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    straggler_factor: float = 3.0
    max_straggler_strikes: int = 5
    min_timing_samples: int = 8


class Trainer:
    """Trains `model` (default: `init_params(cfg, seed=seed)` on `device`)
    in place; its parameters are made trainable here. `params` is the
    model's {name: parameter} and `opt_state` the `optim.AdamWState` over
    them, in `model.parameters()` order. With `mesh` (a DeviceMesh over the
    live world), `model` is a FULL model that is cut to this rank's shards
    here; the batches are global."""

    def __init__(self, cfg: T.ModelConfig, tcfg: TrainerConfig,
                 model: Optional[T.Transformer] = None, *, seed: int = 0,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        # the data iterator owns this object and advances it; the trainer
        # only snapshots it into checkpoints (attach via attach_pipeline)
        self.pipeline_state = PipelineState()
        self.step_times: list = []
        self.straggler_strikes = 0
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        if model is None:
            model = T.init_params(cfg, seed=seed, device=self.device)
        if mesh is not None:
            shard_params(model, mesh)
        self.model = model.trainable_(True)
        self.opt_state = adamw_init(list(self.model.parameters()))
        self._step = make_train_step(cfg, base_lr=tcfg.base_lr,
                                     warmup=tcfg.warmup,
                                     total=tcfg.total_steps, mesh=mesh)
        self.metrics_log: list = []

    @property
    def writer(self) -> bool:
        """Whether this rank writes checkpoints: the mesh's rank at
        coordinate 0 of every axis (rank 0 of the world without a
        mesh)."""
        if self.mesh is not None:
            return all(axis_rank(n, self.mesh) == 0
                       for n in self.mesh.mesh_dim_names)
        return not dist.is_initialized() or dist.get_rank() == 0

    def _full(self, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """{name: tensor} with each shard all-gathered to its full tensor
        (the sharded parameter of the same name tells the placement)."""
        shards = param_shards(self.model)
        params = self.params
        out = {}
        for name, t in tensors.items():
            s = shards.get(id(params[name]))
            out[name] = t if s is None else all_gather(
                t, s[0], s[1], mesh=self.mesh, site="checkpoint")
        return out

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full tensor of parameter `name`."""
        s = param_shards(self.model).get(id(self.params[name]))
        if s is None:
            return full
        dim, axis, n = s
        return full.chunk(n, dim=dim)[axis_rank(axis, self.mesh)]

    def _local_trees(self):
        """The params and the optimizer state as name-keyed trees of this
        rank's tensors."""
        names = list(self.params)
        trees = {"params": dict(self.params)}
        for field in ("mu", "nu", "master"):
            trees[field] = dict(zip(names, getattr(self.opt_state, field)))
        return trees

    def _state_trees(self):
        """The params and the optimizer state as name-keyed trees (full
        tensors over a mesh: every shard all-gathered)."""
        trees = self._local_trees()
        if self.mesh is not None:
            trees = {k: self._full(v) for k, v in trees.items()}
        return trees

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def attach_pipeline(self, state: PipelineState):
        """Share the data iterator's state so checkpoints capture it."""
        self.pipeline_state = state

    # ------------------------------------------------------------- restore
    @torch.no_grad()
    def maybe_restore(self) -> Optional[int]:
        """Resume from the newest checkpoint if one exists: params,
        optimizer state and pipeline state, copied into this trainer's
        tensors in place (each rank its shards of the full tensors).
        Returns the step, or None."""
        if self.mesh is not None:
            barrier(self.mesh)
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return None
        live = self._local_trees()
        if self.mesh is not None:
            # full shapes from each shard's placement: nothing is gathered
            shards, params = param_shards(self.model), self.params

            def full(name, t):
                shape = list(t.shape)
                s = shards.get(id(params[name]))
                if s is not None:
                    shape[s[0]] *= s[2]
                return torch.empty(shape, dtype=t.dtype, device="meta")
            live = {k: {n: full(n, t) for n, t in v.items()}
                    for k, v in live.items()}
        live = {"params": live["params"],
                "opt": {"step": self.opt_state.step, "mu": live["mu"],
                        "nu": live["nu"], "master": live["master"]}}
        tree, extra, step = restore(self.tcfg.ckpt_dir, live)
        for name, p in self.params.items():
            p.copy_(self._local(name, tree["params"][name]))
        opt = tree["opt"]
        self.opt_state.step.copy_(opt["step"])
        for field in ("mu", "nu", "master"):
            for name, dst in zip(self.params, getattr(self.opt_state,
                                                      field)):
                dst.copy_(self._local(name, opt[field][name]))
        self.pipeline_state = PipelineState.from_dict(
            extra.get("pipeline", {"step": 0}))
        return step

    # ------------------------------------------------------------- loop
    def run(self, data_iter, n_steps: int,
            on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict:
        """n_steps train steps on batches of `data_iter` (dicts of numpy
        arrays or tensors, moved to the device here). The one host read of
        a step is its metrics (`float`), after which its time is taken."""
        start = int(self.opt_state.step)
        for i in range(n_steps):
            batch = next(data_iter)
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            t0 = time.time()
            metrics = self._step(self.model, self.opt_state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            self._watchdog(dt)
            step = start + i + 1
            rec["step_time_s"] = dt
            self.metrics_log.append(rec)
            if on_step:
                on_step(step, rec)
            if step % self.tcfg.ckpt_every == 0:
                self.checkpoint(step)
        self.wait()
        return self.metrics_log[-1] if self.metrics_log else {}

    def checkpoint(self, step: int):
        """Save params, optimizer state and pipeline state (asynchronously;
        `wait` joins). Over a mesh every rank gathers its shards and the
        mesh's first rank (`writer`) writes the full tensors."""
        trees = self._state_trees()
        extra = {"pipeline": self.pipeline_state.to_dict(),
                 "device": str(self.device)}
        if self.mesh is not None:
            extra["mesh"] = list(self.mesh.shape)
        if self.writer:
            self.ckpt.save(step, {
                "params": trees["params"],
                "opt": {"step": self.opt_state.step, "mu": trees["mu"],
                        "nu": trees["nu"], "master": trees["master"]}},
                extra=extra)

    def wait(self):
        """Join the checkpoint write in flight, then (over a mesh) wait for
        every rank, so a checkpoint is on disk for all of them."""
        self.ckpt.wait()
        if self.mesh is not None:
            barrier(self.mesh)

    # ------------------------------------------------------------- watchdog
    def _watchdog(self, dt: float):
        self.step_times.append(dt)
        n = self.tcfg.min_timing_samples
        if len(self.step_times) <= n:
            return
        med = statistics.median(self.step_times[-50:-1])
        if dt > self.tcfg.straggler_factor * med:
            self.straggler_strikes += 1
            if self.straggler_strikes >= self.tcfg.max_straggler_strikes:
                raise StragglerAbort(
                    f"{self.straggler_strikes} steps exceeded "
                    f"{self.tcfg.straggler_factor}x median ({med:.3f}s); "
                    f"requesting a restart")
        else:
            self.straggler_strikes = max(0, self.straggler_strikes - 1)


def elastic_restart(cfg: T.ModelConfig, tcfg: TrainerConfig, new_mesh, *,
                    model: Optional[T.Transformer] = None, seed: int = 0,
                    device="cuda") -> Trainer:
    """Rebuild a Trainer on a different mesh (of the same world) and
    restore the newest checkpoint onto it: its tensors are full, so
    resharding is cutting them to the new mesh's shards."""
    tr = Trainer(cfg, tcfg, model, seed=seed, device=device, mesh=new_mesh)
    tr.maybe_restore()
    return tr
