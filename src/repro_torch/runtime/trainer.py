"""Fault-tolerant training runtime on one device: the reference's
`repro.runtime.trainer` with a device in place of the mesh.

Responsibilities:
  * the train loop (`launch.steps.make_train_step`, in place on the
    model's parameters and the AdamW state),
  * periodic async checkpoints of the params, the optimizer state and the
    pipeline state (checkpoint/restart, `checkpoint.store`),
  * straggler mitigation: a per-step deadline watchdog -- steps that exceed
    `straggler_factor` x the trailing-median step time are counted; after
    `max_straggler_strikes` the runtime raises StragglerAbort for the
    harness to act on.
(The reference's `elastic_restart` re-meshes, and belongs to the
distribution layer.)
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..checkpoint.store import AsyncCheckpointer, latest_step, restore
from ..data.pipeline import PipelineState
from ..launch.steps import make_train_step
from ..models import transformer as T
from ..optim import adamw_init

__all__ = ["TrainerConfig", "Trainer", "StragglerAbort"]


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
    them, in `model.parameters()` order."""

    def __init__(self, cfg: T.ModelConfig, tcfg: TrainerConfig,
                 model: Optional[T.Transformer] = None, *, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        # the data iterator owns this object and advances it; the trainer
        # only snapshots it into checkpoints (attach via attach_pipeline)
        self.pipeline_state = PipelineState()
        self.step_times: list = []
        self.straggler_strikes = 0
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        if model is None:
            model = T.init_params(cfg, seed=seed, device=self.device)
        self.model = model.trainable_(True)
        self.opt_state = adamw_init(list(self.model.parameters()))
        self._step = make_train_step(cfg, base_lr=tcfg.base_lr,
                                     warmup=tcfg.warmup,
                                     total=tcfg.total_steps)
        self.metrics_log: list = []

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
        tensors in place. Returns the step, or None."""
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return None
        live = {"params": self.params, "opt": self.opt_state}
        tree, extra, step = restore(self.tcfg.ckpt_dir, live)
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        opt = tree["opt"]
        self.opt_state.step.copy_(opt.step)
        for field in ("mu", "nu", "master"):
            for dst, src in zip(getattr(self.opt_state, field),
                                getattr(opt, field)):
                dst.copy_(src)
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
        self.ckpt.wait()
        return self.metrics_log[-1] if self.metrics_log else {}

    def checkpoint(self, step: int):
        self.ckpt.save(step, {"params": self.params, "opt": self.opt_state},
                       extra={"pipeline": self.pipeline_state.to_dict(),
                              "device": str(self.device)})

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
