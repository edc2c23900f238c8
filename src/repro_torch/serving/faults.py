"""Deterministic fault injection for the serving engine.

A seeded `FaultPlan` injects faults at precise (step, slot) coordinates, so
every recovery path of the engine runs deterministically and the recovered
output can be held byte for byte against an unfaulted run.

Fault classes (`Fault.kind`):

  "launch"     a kernel-launch failure. boundary="launch" raises
               `KernelLaunchError` where the engine launches the step;
               boundary="dispatch" installs the `api.registry` dispatch hook,
               so the error fires at the first op dispatch of the step's
               launch (the reference fires it where the step traces; the
               port has no trace, so every launch dispatches).
  "poison"     NaN/Inf corruption. target="logits" corrupts one slot's step
               logits; target="kv" corrupts one slot's KV cache (bf16 K, or
               the f32 K scales of an int8 cache: int codes hold no NaN);
               target="weight" corrupts the shared weights (a resident
               Linear's scale, else the final norm): every slot's logits go
               non-finite, quarantine cannot help, and recovery is a
               snapshot restore.
  "latency"    a host-side stall of `delay_s` seconds before the step's
               launches: visible in inter-token latency and TTL deadlines,
               invisible in outputs.
  "malformed"  a hostile submission: `malformed_request` builds it,
               `drive_with_plan` submits it at the fault's step and records
               the engine's rejection.
  "pool_pressure"
               for paged engines: at `step`, squeeze the pool's free list
               down to `blocks` blocks (the rest held aside, released after
               `duration` steps; None holds them forever). It forces the
               eviction -> preemption -> host-swap path; a no-op (not
               tripped) on a per-slot engine or a pool already that full.

Faults are one-shot: `FaultPlan.take` marks them fired. An engine with no
plan armed pays one `is None` check a step, and the registry hook one
`is not None` check a dispatch. A mirror of the reference's
`repro.serving.faults`: the same plans from the same seeds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Fault", "FaultPlan", "KernelLaunchError", "KINDS",
           "POISON_TARGETS", "MALFORMED_KINDS", "malformed_request",
           "poison_logits", "poison_caches", "poison_weights",
           "drive_with_plan"]

KINDS = ("launch", "poison", "latency", "malformed", "pool_pressure")
POISON_TARGETS = ("logits", "kv", "weight")
LAUNCH_BOUNDARIES = ("launch", "dispatch")
MALFORMED_KINDS = ("empty-prompt", "float-prompt", "2d-prompt",
                   "negative-max-new", "float-max-new", "absurd-max-new")

NAN = float("nan")
INF = float("inf")


class KernelLaunchError(RuntimeError):
    """An injected kernel-launch failure: the stand-in for a launch or
    build error of a kernel on the card."""


@dataclasses.dataclass
class Fault:
    """One injected fault at a (step, slot) coordinate.

    step is the engine step (`ServingEngine.step_no`) it fires at; slot the
    cache row it targets (None = global, e.g. weight poison). `fired` says
    the engine consumed it, `tripped` that the failure took effect."""
    kind: str
    step: int = 0
    slot: Optional[int] = None
    target: str = "logits"            # poison target / malformed defect
    value: float = NAN                # poison value (nan or +/-inf)
    boundary: str = "launch"          # launch faults: launch | dispatch
    op: Optional[str] = None          # dispatch faults: only this op
    delay_s: float = 0.0              # latency faults
    blocks: int = 0                   # pool_pressure: free blocks LEFT
    duration: Optional[int] = None    # pool_pressure: steps until release
    fired: bool = False
    tripped: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")
        if self.kind == "poison" and self.target not in POISON_TARGETS:
            raise ValueError(f"poison target {self.target!r} not in "
                             f"{POISON_TARGETS}")
        if self.kind == "launch" and self.boundary not in LAUNCH_BOUNDARIES:
            raise ValueError(f"launch boundary {self.boundary!r} not in "
                             f"{LAUNCH_BOUNDARIES}")
        if self.kind == "malformed" and self.target not in MALFORMED_KINDS:
            raise ValueError(f"malformed defect {self.target!r} not in "
                             f"{MALFORMED_KINDS}")
        if self.kind == "pool_pressure":
            if self.blocks < 0:
                raise ValueError(
                    f"pool_pressure blocks ({self.blocks}) must be >= 0")
            if self.duration is not None and self.duration < 1:
                raise ValueError(
                    f"pool_pressure duration ({self.duration}) must be "
                    f">= 1 step (or None to hold forever)")

    def describe(self) -> str:
        extra = {
            "launch": f"boundary={self.boundary}" +
                      (f" op={self.op}" if self.op else ""),
            "poison": f"target={self.target} slot={self.slot} "
                      f"value={self.value}",
            "latency": f"delay={self.delay_s}s",
            "malformed": f"defect={self.target}",
            "pool_pressure": f"free->{self.blocks} "
                             f"duration={self.duration}",
        }[self.kind]
        return f"{self.kind}@step{self.step} {extra}"


class FaultPlan:
    """An ordered, seeded list of one-shot faults. Arm it on an engine
    (`ServingEngine.arm_fault_plan`), which consults it at its step and
    launch boundaries, or drive with `drive_with_plan`, which also submits
    the plan's malformed requests."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)

    @classmethod
    def single(cls, kind: str, **kw) -> "FaultPlan":
        return cls([Fault(kind=kind, **kw)])

    @classmethod
    def seeded(cls, seed: int, *, steps: int, slots: int,
               kinds: Sequence[str] = KINDS,
               n_faults: int = 4) -> "FaultPlan":
        """`n_faults` faults drawn from `kinds` at seeded (step, slot)
        coordinates in [1, steps) x [0, slots): the reference's draw, so
        one seed gives one plan in both packages."""
        rng = np.random.RandomState(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.randint(len(kinds)))]
            step = int(rng.randint(1, max(steps, 2)))
            slot = int(rng.randint(slots))
            if kind == "poison":
                # weight poison is global and not recoverable in place: the
                # seeded sweep keeps to the slot targets
                target = ("logits", "kv")[int(rng.randint(2))]
                value = (NAN, INF, -INF)[int(rng.randint(3))]
                faults.append(Fault("poison", step=step, slot=slot,
                                    target=target, value=value))
            elif kind == "launch":
                faults.append(Fault("launch", step=step))
            elif kind == "latency":
                faults.append(Fault("latency", step=step,
                                    delay_s=0.001 * (1 + int(rng.randint(5)))))
            elif kind == "pool_pressure":
                # a bounded squeeze that always releases, so a sweep cannot
                # hold preempted rows out forever
                faults.append(Fault("pool_pressure", step=step,
                                    blocks=int(rng.randint(3)),
                                    duration=2 + int(rng.randint(6))))
            else:
                defect = MALFORMED_KINDS[int(rng.randint(
                    len(MALFORMED_KINDS)))]
                faults.append(Fault("malformed", step=step, target=defect))
        return cls(faults)

    def take(self, kind: str, step: int,
             target: Optional[str] = None) -> List[Fault]:
        """Unfired faults of `kind` due at `step` (of `target`, if given),
        marked fired."""
        hits = [f for f in self.faults
                if not f.fired and f.kind == kind and f.step == step
                and (target is None or f.target == target)]
        for f in hits:
            f.fired = True
        return hits

    def take_due(self, kind: str, step: int, target: Optional[str] = None,
                 pred=None) -> List[Fault]:
        """As `take`, for faults due AT OR BEFORE `step`, and `pred(fault)`
        may veto. Logits poison uses it: the fault fires at the first launch
        from its step on whose logits its slot reads (a mid-prompt chunk's
        logits are never read, so poisoning them would change nothing)."""
        hits = [f for f in self.faults
                if not f.fired and f.kind == kind and f.step <= step
                and (target is None or f.target == target)
                and (pred is None or pred(f))]
        for f in hits:
            f.fired = True
        return hits

    def pending(self, kind: Optional[str] = None) -> List[Fault]:
        return [f for f in self.faults
                if not f.fired and (kind is None or f.kind == kind)]

    def exhausted(self) -> bool:
        return not self.pending()

    def describe(self) -> str:
        return "; ".join(f.describe() for f in self.faults) or "(empty plan)"


# ------------------------------------------------------------------ poison
@torch.no_grad()
def poison_logits(logits: torch.Tensor, slot: int,
                  value: float = NAN) -> torch.Tensor:
    """Set one slot's logits to a non-finite value, in place; returns
    `logits`."""
    logits[slot] = value
    return logits


@torch.no_grad()
def poison_caches(caches: List, slot: int, value: float = NAN) -> List:
    """Corrupt one slot's cache in every layer, in place: its K at position
    0 (bf16 values, or the f32 K scales of an int8 cache), which every
    later query of the row reads, or every field of a recurrent state's
    row. Paged caches are poisoned through the block table: position 0 of
    the slot's first mapped block, so a prefix-shared block poisons every
    row that maps it — what the engine's transitive quarantine contains.
    The non-finite value reaches the row's logits at its next launch that
    reads them, where the engine's health flag trips."""
    from ..models.attention import (KVCache, PagedKVCache, PagedQuantKVCache,
                                    QuantKVCache)
    from ..models.ssm import RECURRENT_TYPES
    for c in caches:
        if isinstance(c, RECURRENT_TYPES):
            for f in dataclasses.fields(c):
                getattr(c, f.name)[slot] = value
            continue
        if isinstance(c, KVCache):
            c.k[slot, :, 0, :] = value
        elif isinstance(c, QuantKVCache):
            c.k_scale[slot, :, 0, :] = value
        elif isinstance(c, (PagedKVCache, PagedQuantKVCache)):
            pool = c.k if isinstance(c, PagedKVCache) else c.k_scale
            # the block id stays on the device: no host read
            pool[c.table[slot, :1].long(), :, 0, :] = value
        else:
            raise TypeError(f"not a KV cache: {type(c).__name__}")
    return caches


@torch.no_grad()
def poison_weights(model, value: float = NAN):
    """A copy of `model` with its shared weight plane corrupted: one scale
    element of the first resident Linear, or one element of the final norm
    of a dense model. Either way every slot's logits go non-finite at the
    next launch. The copy shares every other tensor with `model` (the
    reference poisons a new param tree; `model` itself is left intact)."""
    from ..models.layers import Linear
    from ..models.transformer import _shallow_copy
    out = _shallow_copy(model)
    for mod in out.modules():
        if isinstance(mod, Linear) and mod.fmt is not None:
            scale = mod.w_scale.clone()
            scale.view(-1)[0] = value
            mod.register_buffer("w_scale", scale)
            return out
    g = out.final_norm.g.detach().clone()
    g.view(-1)[0] = value
    out.final_norm.g = torch.nn.Parameter(g, requires_grad=False)
    return out


# ---------------------------------------------------------- malformed input
def malformed_request(defect: str, rid: int = 9000, vocab: int = 32):
    """A Request with one input defect that `submit()` must reject with a
    ValueError or TypeError."""
    from .engine import Request
    if defect == "empty-prompt":
        return Request(rid, np.zeros(0, np.int32))
    if defect == "float-prompt":
        return Request(rid, np.asarray([1.5, 2.5, 3.5], np.float32))
    if defect == "2d-prompt":
        return Request(rid, np.ones((2, 3), np.int32))
    if defect == "negative-max-new":
        return Request(rid, np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=-4)
    if defect == "float-max-new":
        return Request(rid, np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=2.5)                 # type: ignore
    if defect == "absurd-max-new":
        return Request(rid, np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=1 << 40)
    raise ValueError(f"malformed defect {defect!r} not in {MALFORMED_KINDS}")


def drive_with_plan(engine, plan: FaultPlan, max_steps: int = 100000):
    """Drain `engine` with `plan` armed, submitting the plan's malformed
    requests at their steps. Returns (finished, rejections), one (step,
    defect, message) per malformed submission the engine refused. The
    engine consults the plan itself for the other kinds."""
    engine.arm_fault_plan(plan)
    rejections = []
    for _ in range(max_steps):
        for f in plan.take("malformed", engine.step_no):
            bad = malformed_request(f.target)
            try:
                engine.submit(bad)
            except (ValueError, TypeError) as e:
                f.tripped = True
                rejections.append((engine.step_no, f.target, str(e)))
        if not engine.pending() and not plan.pending("malformed"):
            break
        engine.step()
    else:
        raise RuntimeError(f"fault drive not drained after {max_steps} steps")
    return engine.finished, rejections
