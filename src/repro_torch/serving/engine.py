"""Serving engine: continuous per-slot batched greedy decoding with CHUNKED
admission prefill.

The engine owns `slots` cache rows. Every slot progresses independently —
`KVCache.pos` is a per-row vector — so a finished slot is refilled from the
queue at once while the others keep decoding. A new prompt advances in
fixed `prefill_chunk`-token right-padded slices, one chunk launch per
engine step, interleaved with one batched decode launch for the generating
rows. Rows that sit a launch out pass `lengths == 0` and keep their caches;
admitted rows advance by their true token count, so pad keys stay beyond
every row's causal frontier. There are exactly two launch widths: 1 and
`prefill_chunk`. Greedy outputs are identical to one-shot admission.

A model with recurrent blocks (zamba2's Mamba2 layers, xlstm's mLSTM and
sLSTM layers) advances its states one token a launch, so its engine runs
in MERGED mode, as does any engine with `prefill_chunk == 1`: ONE l=1
launch a step, in which prefilling rows feed their next prompt token and
decoding rows their last sampled one (`EngineStats.prefill_token_steps`
counts the steps in which no row decoded). The paged block pool is
refused for such a model (ROADMAP C: the reference's paged engine starts
a prefix-hit row past the shared tokens, which then never pass through
its recurrent state).

An encoder-decoder model (whisper) is served with `frames=`, one audio
clip a SLOT: the engine encodes them once, at construction, and every
launch's decoder layers cross-attend that memory, so a request hears the
audio of the slot it lands in (a quarantine replay too, and a snapshot
restored into an engine built with other frames), as in the reference.
Its paged engine is refused too (ROADMAP C: from the second decoder layer
on, a row's self-attention K/V depend on its slot's audio, so a prefix
block written in one slot is not the prefix of another).

Each launch is ONE step program: `decode_step` plus a fused per-row
numeric-health reduction (all logits finite). The gather of each row's last
valid position and the argmax run on the device; only (slots,) int32
tokens and (slots,) health flags come back to the host, in one transfer, at
launches whose tokens are consumed.

With `paged=True` the KV residency is a BLOCK POOL instead of per-slot
stripes: every cache layer holds `pool_blocks` blocks of `block_size`
positions, and a per-row block table (one device tensor, shared by the
layers) maps each row's positions onto pool blocks; the paged attention
kernels read through it. A host-side refcounted allocator reserves a
row's whole block budget at admission, shares fully covered prompt-prefix
blocks through a prompt-hash prefix registry, forks the one partly covered
boundary block copy-on-write before the row writes into it, evicts cold
registry prefixes LRU when the pool runs short, and DEFERS admission at
the queue head (FIFO kept) when the pool cannot hold the reservation;
sustained pressure then backs up into the bounded queue's REJECTED path.
Greedy outputs are identical to the per-slot engine. All of it happens at
admission, where the host synchronizes anyway; the steps stay unchanged.

Pool pressure degrades gracefully: past a high watermark
(`swap_watermark`, the fraction of the pool an admission may fill), the
admission PREEMPTS resident rows of strictly lower priority — victims by
(priority, deadline slack, blocks freed) — and spills each victim's private
blocks to a host block store (`serving/swap.py`), codes and scales for an
int8 cache. Blocks it shares with the prefix registry or other rows stay
resident, and its swap entry keeps their references. A PREEMPTED request
re-admits ahead of fresh ones: swap-in reserves fresh blocks, writes the
host bytes back (`write_pool_blocks`) and rewinds the row to its saved
frontier, with no prefill recomputed, so its greedy output equals an
uncontended run's. Equal priorities never preempt each other. Every
transfer happens at the scheduler boundary, where the host synchronizes
anyway; the step program moves nothing between host and card.

Fault tolerance (a mirror of the reference engine's):

* A slot whose logits go non-finite is QUARANTINED: its cache row is
  scrubbed (`scrub_slots`: values AND position, since a NaN reaches the
  output through P V even where its key is masked) and its request replays
  from its prompt, byte-identically, up to `max_replays` times before it
  fails terminally (status "FAILED"). A paged engine first closes the bad
  set over shared blocks.
* A launch that raises the fault plans' `KernelLaunchError` DEMOTES the
  engine: its policy is re-pinned to the reference route
  (`ExecutionPolicy.demoted()`) and the same step retries once down it.
  Every demotion is counted (`stats.demotions`), recorded in
  `degraded_routes()` and warned about. Any other error of a launch
  propagates, as does a failure on the reference route: a fallback must
  never hide a broken kernel.
* Requests carry deadlines, `deadline_steps` (engine steps) and `ttl_s`
  (wall clock); an expired request finishes with status "TIMEOUT".
  `max_queue` bounds the queue: past it `submit()` REJECTS.
* `snapshot()` / `restore()` persist the whole engine state (caches, host
  bookkeeping, queue, stats, the host block store, optionally the weights)
  through `checkpoint.store`, so a run recovers mid-stream and finishes
  byte-identically.

`serving.faults` drives all of it: a seeded fault plan armed with
`arm_fault_plan()`. An engine with no plan armed and no deadline set pays a
few `None` checks a step.

On a partition (an engine built under `dist.set_mesh`, which it binds
again around every launch) each rank of the mesh runs its own engine over
the same requests. A model cut by `dist.shard_params` or
`dist.init_sharded` is served tensor-parallel: each rank's caches hold its
n_kv / R heads (`init_caches(..., model=)`), q/k/v/gate/up run
column-parallel and o/down row-parallel (one all-reduce each), the logits
are all-gathered, so every rank takes the same argmax and the same host
decisions (admission, blocks, preemption, quarantine) without a word
between them. A wall-clock `ttl_s` is judged there by the partition's
lead rank's clock (the rank at coordinate 0 of every axis): every rank
stamps a request's submit time and reads the time of each step from it
(one max all-reduce of a float64, made only while some request carries
a TTL), so every rank expires the same requests at the same step.
`arm_fault_plan` checks
that every rank of the partition arms the same plan (ValueError
otherwise), so its launch faults demote every rank at the same step; a
`KernelLaunchError` that no plan injected raises RuntimeError there
instead of demoting: the other ranks would go on into collectives that
the retrying rank's layers answer. Resident
weights are refused on a sharded model (they stay replicated).
`snapshot()` on a partition writes one checkpoint: each rank its own
tree (its caches, with `include_params` its weight shards, and its host
block store) under `rank-<r>/`, and the lead one manifest of the mesh
and the host bookkeeping, which a collective first checks is the same
on every rank; `restore()` takes it back onto a partition of the same
mesh shape only (ValueError on every rank otherwise).

Attention dispatches under the engine's ExecutionPolicy:
`decode_route()` / `prefill_route()` report the impls ("cuda-decode" /
"cuda-prefill" on the default policy). With `weight_format=` the Linear
weights are resident codes and every covered Linear runs the quantizer and
the AIO GEMM kernels (`weight_route()`: "resident-<fmt>"). The caches are
updated in place (the JAX engine donates them instead).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import json
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .. import api
from ..dist.sharding import ctx_mesh, set_mesh
from ..models import transformer as T
from ..models.attention import Attention, CrossAttention
from ..models.layers import MLP
from . import faults as faultlib
from .swap import HostBlockStore

__all__ = ["Request", "ServingEngine", "EngineStats", "EngineStalledError",
           "TERMINAL_STATES", "PAD"]

PAD = 0

# Request.status values once a request leaves the engine for good.
TERMINAL_STATES = ("done", "TIMEOUT", "REJECTED", "FAILED")


class EngineStalledError(RuntimeError):
    """`run_until_drained` hit its step budget with work still in flight;
    carries which slots are stuck (their occupancy dicts) and the queue
    depth."""

    def __init__(self, msg: str, *, stuck=(), queue_depth: int = 0):
        self.stuck = list(stuck)
        self.queue_depth = int(queue_depth)
        super().__init__(
            f"{msg}; {len(self.stuck)} stuck slot(s): {self.stuck!r}; "
            f"queue depth {self.queue_depth}")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # (L,) integer token ids
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False
    status: str = "new"               # queued | active | PREEMPTED ->
    #                                   TERMINAL_STATES
    deadline_steps: Optional[int] = None   # engine steps from submit
    ttl_s: Optional[float] = None          # wall seconds from submit
    replays: int = 0                  # quarantine replays consumed so far
    priority: int = 0                 # higher admits first under pressure
    #                                   and may swap out strictly lower rows
    _submit_step: int = 0
    _submit_t: float = 0.0


@dataclasses.dataclass
class EngineStats:
    """Model-invocation accounting."""
    prefill_chunk_calls: int = 0      # chunk-shaped batched prefill launches
    prefill_token_steps: int = 0      # merged l=1 launches with no decoding
    #                                   row (recurrent models, chunk 1)
    prefill_tokens: int = 0           # valid prompt tokens prefilled
    decode_steps: int = 0             # batch decode launches
    generated_tokens: int = 0
    # --- fault counters ---
    quarantines: int = 0              # poisoned slots evicted and scrubbed
    demotions: int = 0                # kernel -> ref route demotions
    timeouts: int = 0                 # requests expired (deadline / TTL)
    rejected_submits: int = 0         # submits refused by the bounded queue
    failed_requests: int = 0          # replay budget spent -> FAILED
    # --- memory pressure (paged engines) ---
    preemptions: int = 0              # resident rows preempted
    swap_outs: int = 0                # preemptions that moved blocks to host
    swap_ins: int = 0                 # preempted rows restored

    @property
    def model_calls(self) -> int:
        return self.prefill_chunk_calls + self.prefill_token_steps \
            + self.decode_steps


class ServingEngine:
    """Continuous per-slot batching over `slots` preallocated cache rows."""

    def __init__(self, cfg: T.ModelConfig, model: T.Transformer, *,
                 slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None,
                 frames=None,
                 policy: Optional[api.ExecutionPolicy] = None,
                 weight_format: Optional[str] = None,
                 prefill_chunk: int = 32,
                 max_queue: Optional[int] = None,
                 max_replays: int = 2,
                 deadline_steps: Optional[int] = None,
                 ttl_s: Optional[float] = None,
                 paged: bool = False,
                 block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 swap_watermark: float = 1.0):
        """model: the Transformer to serve; the engine runs on the device
        its weights live on (`init_params` puts them on the card unless
        asked for the CPU).

        frames: (slots, T, d_model) audio frame embeddings (numpy or a
        tensor), required for an encoder-decoder model and unused
        otherwise: encoded once here, under the engine's policy and
        weights (`transformer.encode`), into `self.memory`, which every
        launch's decoder layers cross-attend, row s the audio of slot s.

        policy: the ExecutionPolicy every op of the engine dispatches
        under; one engine = one policy (a launch failure re-pins it to the
        reference route, `demoted()`).

        weight_format: make the Linear weights RESIDENT in this AIO format
        (int4/int8/fp8a/fp8b): the engine serves its own view of `model`
        (`resident_view`: the module tree copied, every tensor shared but
        the covered Linears' weights, whose codes are new) and every
        covered Linear dispatches through `api.ops.matmul_codes`. The
        caller's `model` keeps its dense weights, as the reference's engine
        leaves the caller's params dense; to free them, convert the model
        in place with `quantize_params` first, as the serve launcher does.
        Other format names (incl. "bf16") raise: they are not residency
        formats. A model that is already resident is served in its own
        format.

        prefill_chunk: tokens a new prompt advances per admission launch
        (clamped to max_len). Greedy outputs are identical for any chunk.
        A model with recurrent blocks ignores it: its engine runs merged
        l=1 launches (as does a chunk of 1).

        max_queue: bound on the admission queue; beyond it `submit()`
        REJECTS (returns False) instead of queueing. None = unbounded.

        max_replays: quarantine replays a request may take before it fails
        terminally (status "FAILED") instead of being queued again.

        deadline_steps / ttl_s: default deadlines, given at submit() to
        requests that carry none.

        paged / block_size / pool_blocks: block-pool KV residency. Every KV
        cache layer becomes a pool of `pool_blocks` blocks of `block_size`
        positions (default: slots x max_len / block_size, the token
        capacity of the per-slot stripes) plus a (slots, max_len /
        block_size) block table the host allocator owns. block_size must
        divide max_len; any size works for the kernels (they resolve each
        key's block, so it need not match their tiles).

        swap_watermark: the fraction (0, 1] of the pool an admission may
        fill before the engine reclaims: LRU registry eviction first, then
        PREEMPTION of strictly lower-priority resident rows (their private
        blocks spill to the host block store; the request resumes
        byte-identically when re-admitted). 1.0 reclaims only when a
        reservation cannot be met at all; below it the engine keeps
        pool x (1 - watermark) blocks of headroom. With equal priorities
        the watermark only drives registry eviction. A model with
        recurrent blocks or cross attention cannot be served paged:
        ValueError."""
        # the partition this engine serves on: the ambient mesh at
        # construction, bound again around every launch
        self.mesh = ctx_mesh()
        if weight_format not in (None, "none"):
            if _sharded(model):
                raise ValueError(
                    f"{cfg.name}: resident weights are served replicated "
                    "on every rank of a partition (ROADMAP: sharded codes); "
                    "build the model whole on each rank, not sharded")
            model = T.resident_view(model, weight_format)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk ({prefill_chunk}) must be >= 1")
        # recurrent states advance one token a launch: the merged path
        self._recurrent = T.has_recurrent(cfg)
        self._paged = bool(paged)
        if self._paged and self._recurrent:
            raise ValueError(
                f"{cfg.name}: paged serving of a model with recurrent "
                "blocks is not supported (ROADMAP C: a prefix hit would "
                "start the row past tokens its recurrent state never saw)")
        if self._paged and T.has_cross_attention(cfg):
            raise ValueError(
                f"{cfg.name}: paged serving of a model with cross attention "
                "is not supported (ROADMAP C: a row's K/V past the first "
                "decoder layer depend on its slot's audio, so a prefix "
                "block another slot wrote is not this row's prefix)")
        if self._paged:
            self._pg_init(slots, max_len, block_size, pool_blocks,
                          swap_watermark)
        self.cfg = cfg
        self.model = model
        # a resident engine's health flag also reads the `_InputProbe`
        self._probing = T.resident_format(model) is not None
        self._probe: Optional[_InputProbe] = None
        self.device = model.embed.table.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.policy = policy
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.max_queue = max_queue
        self.max_replays = max_replays
        self.deadline_steps = deadline_steps
        self.ttl_s = ttl_s
        self.memory = None
        if model.encoder is not None:
            self.memory = self._encode(frames)
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.stats = EngineStats()
        self.caches = T.init_caches(
            cfg, slots, max_len, device=self.device,
            paged=(self._pg_pool, self._pg_bs) if self._paged else None,
            model=model)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._last = np.zeros((slots, 1), np.int32)
        self._remaining = np.zeros(slots, np.int64)
        self._prefilling = np.zeros(slots, bool)
        self._prefill_off = np.zeros(slots, np.int64)
        self._step_no = 0
        # preemption and swap state (used by paged engines only, but always
        # present, so pending() and snapshot() need not ask)
        self._preempted: List[Request] = []
        self._swap_entries: Dict[int, dict] = {}
        self._swap_store = HostBlockStore()
        # slots filled in the current admission pass: no preemption victim
        # before its device state exists
        self._admit_protect: set = set()
        # fault tolerance
        self._fault_plan: Optional[faultlib.FaultPlan] = None
        self._degraded: List[dict] = []
        self._has_deadlines = deadline_steps is not None or ttl_s is not None
        # some request carries a wall-clock TTL: the partition's ranks then
        # agree on the time of each step
        self._has_ttl = ttl_s is not None
        # token widths the step program has run at (`step_trace_count`)
        self._widths_launched: set = set()

    # ------------------------------------------------------------ launches
    def _policy_ctx(self):
        """The engine's policy and its partition's mesh, bound."""
        ctx = contextlib.ExitStack()
        if self.mesh is not None:
            ctx.enter_context(set_mesh(self.mesh))
        if self.policy is not None:
            ctx.enter_context(api.policy(self.policy))
        return ctx

    def _encode(self, frames) -> torch.Tensor:
        """The cross-attention memory of (slots, T, d_model) frames."""
        if frames is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder model is "
                             "served with frames= (slots, T, d_model)")
        frames = torch.as_tensor(frames, dtype=torch.float32).to(self.device)
        if frames.dim() != 3 or frames.shape[0] != self.slots \
                or frames.shape[2] != self.cfg.d_model:
            raise ValueError(f"frames {tuple(frames.shape)}: want (slots "
                             f"{self.slots}, T, d_model {self.cfg.d_model})")
        with self._policy_ctx(), torch.no_grad():
            return T.encode(self.model, frames)

    def _merged_mode(self) -> bool:
        """Recurrent models (and chunk-1 engines) advance prefill one token
        a launch: prefill and decode share one l=1 launch a step."""
        return self._recurrent or self.prefill_chunk == 1

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step_program(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """The ONE step program: decode_step plus the fused numeric-health
        reduction — a (slots,) bool, True where every logit of the row is
        finite. On a resident-weight engine a row is healthy only if the
        `_InputProbe` sums are finite too. The caches are updated in
        place."""
        self._widths_launched.add(int(tokens.shape[1]))
        probe = None
        if self._probing:
            if self._probe is None or self._probe.model is not self.model:
                self._probe = _InputProbe(self.model)
            probe = self._probe
        with self._policy_ctx(), probe or contextlib.nullcontext():
            logits, _ = T.decode_step(self.model, self.caches, tokens,
                                      memory=self.memory, lengths=lengths)
        health = torch.isfinite(logits).flatten(1).all(1)
        if probe is not None:
            health &= probe.finite()
        return logits, health

    def _greedy(self, rows: torch.Tensor, health: torch.Tensor):
        """Argmax of (slots, V) logits on the device; one transfer brings
        back the (slots,) tokens and health flags."""
        tok = rows.argmax(-1)
        both = torch.stack([tok, health.to(tok.dtype)]).cpu().numpy()
        return both[0].astype(np.int32), both[1].astype(bool)

    def _launch(self, toks: torch.Tensor, lens: torch.Tensor,
                consumed: np.ndarray):
        """Every model launch goes through here: the launch-fault boundary,
        the demote-and-retry recovery, and logits poison. Returns (logits,
        health) on the device.

        On a failure the caches' rebound fields are put back: the KV
        positions (the layers before the failing op already advanced them;
        the K/V they wrote lie past the restored frontiers, where the retry
        writes them again) and the recurrent states (each step binds new
        tensors, so the old ones are intact and the retry does not apply
        the token twice). A
        `KernelLaunchError`, the fault plans' launch failure, then demotes
        the policy to the reference route and retries the SAME step once;
        it propagates with no route left or on the retry. Any other error
        propagates at once: the reference demotes on every exception of
        its trace, but on the card that would serve a broken kernel's steps
        through the plain route without a word (a sticky CUDA error, a
        refused launch plan). `consumed` marks the rows whose logits this
        launch's caller reads: a logits poison fires only on such a launch,
        so every injected fault shows. On a partition of several ranks
        only the armed plan's faults (the same on every rank) demote."""
        plan = self._fault_plan
        step = self._step_no
        raise_fault = hook_fault = None
        if plan is not None:
            for f in plan.take("launch", step):
                if f.boundary == "dispatch":
                    hook_fault = f
                else:
                    f.tripped = True
                    raise_fault = f
        saved = [_cache_refs(c) for c in self.caches]
        for attempt in (0, 1):
            try:
                if raise_fault is not None and attempt == 0:
                    raise faultlib.KernelLaunchError(
                        f"injected kernel-launch failure at step {step} "
                        f"({raise_fault.describe()})")
                ctx = contextlib.nullcontext()
                if hook_fault is not None and attempt == 0:
                    ctx = api.dispatch_intercepted(
                        _dispatch_raiser(hook_fault))
                with ctx:
                    logits, health = self._step_program(toks, lens)
                break
            except Exception as err:
                for c, refs in zip(self.caches, saved):
                    for name, t in refs.items():
                        setattr(c, name, t)
                if attempt == 1 or not isinstance(
                        err, faultlib.KernelLaunchError):
                    raise
                planned = raise_fault is not None or (
                    hook_fault is not None and hook_fault.tripped)
                if self._ranks() > 1 and not planned:
                    raise RuntimeError(
                        f"a launch failed at step {step} on one rank of a "
                        f"partition of {self._ranks()}; the engine does not "
                        "demote there, the other ranks cannot retry "
                        f"alike: {err}") from err
                if not self._demote(err):
                    raise
        if plan is not None:
            poisoned = plan.take_due(
                "poison", step, target="logits",
                pred=lambda f: f.slot is not None and bool(consumed[f.slot]))
            for f in poisoned:
                faultlib.poison_logits(logits, int(f.slot), f.value)
                f.tripped = True
            if poisoned:
                health = torch.isfinite(logits).flatten(1).all(1)
        return logits, health

    def _demote(self, err: Exception) -> bool:
        """Re-pin the policy to the reference route after a launch failure
        (no cache or weight is reallocated). False when the policy already
        runs the reference route: the caller re-raises."""
        pol = self.policy if self.policy is not None \
            else api.current_policy()
        if not pol.use_kernels():
            return False
        event = {"step": int(self._step_no),
                 "error": f"{type(err).__name__}: {err}",
                 "from": {"decode": self.decode_route(),
                          "prefill": self.prefill_route()}}
        self.policy = pol.demoted()
        event["to"] = {"decode": self.decode_route(),
                       "prefill": self.prefill_route()}
        self._degraded.append(event)
        self.stats.demotions += 1
        warnings.warn(
            f"serving engine demoted at step {event['step']}: "
            f"{event['from']} -> {event['to']} after {event['error']}",
            RuntimeWarning, stacklevel=3)
        return True

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> bool:
        """Queue a request; True if admitted to the queue.

        Malformed requests raise at once: empty or non-1-D prompts and
        non-integer prompt dtypes, non-int or negative max_new_tokens (0 is
        legal: emit nothing), a non-int priority, and requests whose prompt
        + budget can never fit the cache rows. With `max_queue` set, a full
        queue REJECTS the request: status "REJECTED", returns False,
        nothing is queued."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"request {req.rid}: prompt must be a 1-D token-id vector, "
                f"got shape {tuple(prompt.shape)}")
        if prompt.shape[0] == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise TypeError(
                f"request {req.rid}: prompt dtype {prompt.dtype} is not an "
                f"integer token dtype")
        m = req.max_new_tokens
        if isinstance(m, bool) or not isinstance(m, (int, np.integer)):
            raise TypeError(
                f"request {req.rid}: max_new_tokens must be an int, got "
                f"{type(m).__name__} ({m!r})")
        if m < 0:
            raise ValueError(f"request {req.rid}: max_new_tokens < 0")
        p = req.priority
        if isinstance(p, bool) or not isinstance(p, (int, np.integer)):
            raise TypeError(
                f"request {req.rid}: priority must be an int, got "
                f"{type(p).__name__} ({p!r})")
        plen = int(prompt.shape[0])
        if plen + m > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt_len ({plen}) + max_new_tokens "
                f"({m}) exceeds the engine's max_len "
                f"({self.max_len}); shorten the request or grow the cache")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.status = "REJECTED"
            req.done = True
            self.stats.rejected_submits += 1
            return False
        req.prompt = prompt
        req.out_tokens = []
        req.done = False
        req.status = "queued"
        if req.deadline_steps is None:
            req.deadline_steps = self.deadline_steps
        if req.ttl_s is None:
            req.ttl_s = self.ttl_s
        req._submit_step = self._step_no
        req._submit_t = self._clock(agree=req.ttl_s is not None)
        if req.deadline_steps is not None or req.ttl_s is not None:
            self._has_deadlines = True
        if req.ttl_s is not None:
            self._has_ttl = True
        self.queue.append(req)
        return True

    def _finish(self, slot: int, status: str = "done"):
        req = self._slot_req[slot]
        req.done = True
        req.status = status
        self.finished.append(req)
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._prefilling[slot] = False
        if self._paged:
            self._pg_release_row(slot)

    def _admit(self, newly: List[Request]):
        """Assign queued requests to free slots and rewind their cache rows.
        No model call happens here: the prompts advance chunk by chunk in
        the following steps, interleaved with everyone else's decode.

        Paged engines also RESERVE each request's whole block budget here
        (shared prefix blocks counted out), fork the partly covered
        boundary block copy-on-write, install the updated block table and
        rewind the admitted rows to their shared-prefix frontier. A request
        whose reservation cannot be met even after LRU prefix eviction and
        preemption is DEFERRED at the queue head and admission stops for
        the step.

        PREEMPTED rows re-admit FIRST (highest priority first, preemption
        order within a priority): swap-in reserves fresh blocks for the
        host-held part, writes the saved bytes back and rewinds the row to
        its saved frontier — nothing recomputed."""
        admitted = []
        new_pos = np.zeros(self.slots, np.int32)
        cow: List[tuple] = []
        restores: List[tuple] = []        # (req, entry, dst blocks)
        deferred = False
        self._admit_protect = set()
        for s in range(self.slots):
            if deferred:
                break
            while self._slot_req[s] is None and (self._preempted
                                                 or self.queue):
                if self._preempted:
                    i = self._best_preempted()
                    req = self._preempted[i]
                    got = self._pg_swap_in(s, req)
                    if got is None:
                        # still no room: the row keeps its place ahead of
                        # fresh admissions, and admission stops
                        self._pg_deferred += 1
                        deferred = True
                        break
                    self._preempted.pop(i)
                    entry, dst = got
                    restores.append((req, entry, dst))
                    req.status = "active"
                    self._slot_req[s] = req
                    self._prefilling[s] = entry["prefilling"]
                    self._prefill_off[s] = entry["prefill_off"]
                    self._remaining[s] = entry["remaining"]
                    self._last[s, 0] = entry["last"]
                    new_pos[s] = entry["pos"]
                    admitted.append(s)
                    self._admit_protect.add(s)
                    continue
                req = self.queue.popleft()
                if req.max_new_tokens == 0:
                    # emit nothing, without spending a prefill launch
                    req.done = True
                    req.status = "done"
                    self.finished.append(req)
                    newly.append(req)
                    continue
                covered = 0
                if self._paged:
                    got = self._pg_admit(s, req)
                    if got is None:
                        # the pool cannot hold the reservation: back to the
                        # HEAD, and no later (smaller) request may pass it
                        self.queue.appendleft(req)
                        self._pg_deferred += 1
                        deferred = True
                        break
                    covered, pairs = got
                    new_pos[s] = covered
                    cow += pairs
                req.status = "active"
                self._slot_req[s] = req
                self._prefilling[s] = True
                self._prefill_off[s] = covered
                self._remaining[s] = req.max_new_tokens
                admitted.append(s)
                self._admit_protect.add(s)
        if admitted:
            mask = np.zeros(self.slots, bool)
            mask[admitted] = True
            if self._paged:
                if cow:
                    src, dst = zip(*cow)
                    T.copy_pool_blocks(self.caches, src, dst)
                    self._pg_cow_copies += len(cow)
                T.set_block_tables(self.caches, self._tensor(self._pg_table))
                T.reset_slots(self.caches, self._tensor(mask),
                              new_pos=self._tensor(new_pos))
                # the swapped-out bytes go back after the table and the
                # positions, so the restored frontier bounds them exactly
                for req, entry, dst in restores:
                    self._pg_restore_blocks(entry, dst)
                    del self._swap_entries[req.rid]
                    self.stats.swap_ins += 1
            else:
                T.reset_slots(self.caches, self._tensor(mask))

    # ------------------------------------------------------ paged block pool
    def _pg_init(self, slots: int, max_len: int, block_size: int,
                 pool_blocks: Optional[int], swap_watermark: float):
        """The allocator's state: free list, refcounts, rows' blocks, the
        host copy of the block table, the prefix registry, the watermark,
        counters."""
        if block_size < 1 or max_len % block_size:
            raise ValueError(
                f"block_size ({block_size}) must divide max_len "
                f"({max_len})")
        self._pg_bs = int(block_size)
        self._pg_nblk = max_len // block_size
        self._pg_pool = int(pool_blocks) if pool_blocks is not None \
            else slots * self._pg_nblk
        if self._pg_pool < self._pg_nblk:
            raise ValueError(
                f"pool_blocks ({self._pg_pool}) cannot hold even one "
                f"full row ({self._pg_nblk} blocks)")
        if not 0.0 < swap_watermark <= 1.0:
            raise ValueError(
                f"swap_watermark ({swap_watermark}) must be in (0, 1]")
        self._swap_watermark = float(swap_watermark)
        # free blocks kept in reserve past the watermark: an admission that
        # would leave fewer reclaims (evicts, then preempts)
        self._pg_headroom = self._pg_pool - int(
            self._swap_watermark * self._pg_pool)
        # blocks a pool_pressure fault holds off the free list:
        # [release step | None, [block ids]] per squeeze
        self._pg_holds: List[list] = []
        # the free list is kept sorted, so allocation is deterministic
        self._pg_free: List[int] = list(range(self._pg_pool))
        self._pg_ref = np.zeros(self._pg_pool, np.int64)
        self._pg_rows: List[List[int]] = [[] for _ in range(slots)]
        self._pg_table = np.zeros((slots, self._pg_nblk), np.int32)
        # prefix registry: sha1(prompt) -> {tokens, blocks, reg_tokens,
        # last_used}; an entry holds its own block references, so a
        # prefix outlives its donor request until LRU eviction
        self._pg_registry: Dict[str, dict] = {}
        self._pg_clock = 0
        self._pg_admits = 0
        self._pg_hits = 0
        self._pg_shared_tokens = 0
        self._pg_cow_copies = 0
        self._pg_evictions = 0
        self._pg_deferred = 0
        self._pg_evict_skips = 0

    def _pg_key(self, prompt: np.ndarray) -> str:
        return hashlib.sha1(
            np.ascontiguousarray(prompt, np.int32).tobytes()).hexdigest()

    def _pg_free_block(self, b: int):
        """Drop one reference to block b; at none it returns to the free
        list (kept sorted)."""
        self._pg_ref[b] -= 1
        if self._pg_ref[b] == 0:
            bisect.insort(self._pg_free, b)

    def _pg_take_block(self) -> int:
        b = self._pg_free.pop(0)
        self._pg_ref[b] = 1
        return b

    def _pg_release_row(self, slot: int):
        """Drop the slot's block references."""
        for b in self._pg_rows[slot]:
            self._pg_free_block(b)
        self._pg_rows[slot] = []

    def _pg_evict(self, target_free: int, protect=None):
        """LRU-evict registry prefixes until `target_free` blocks are free.
        Only the registry's own references are dropped: blocks still shared
        with an active row stay until that row finishes. An entry whose
        blocks are ALL pinned by in-flight sharers is SKIPPED (and counted),
        not evicted: dropping it would free nothing now and destroy sharing
        a resident row is using. `protect` shields the entry the current
        admission is about to share."""
        order = sorted(self._pg_registry.items(),
                       key=lambda kv: kv[1]["last_used"])
        for key, ent in order:
            if len(self._pg_free) >= target_free:
                break
            if ent is protect:
                continue
            if all(self._pg_ref[b] > 1 for b in ent["blocks"]):
                self._pg_evict_skips += 1
                continue
            for b in ent["blocks"]:
                self._pg_free_block(b)
            del self._pg_registry[key]
            self._pg_evictions += 1

    def _pg_lookup(self, prompt: np.ndarray):
        """Longest usable shared prefix in the registry: (entry, covered),
        covered capped at prompt_len - 1 so the row prefills at least its
        last prompt token (its first sampled logits come from its own
        launch) and at the entry's registered tokens; or (None, 0)."""
        plen = int(prompt.shape[0])
        best, best_cov = None, 0
        for ent in self._pg_registry.values():
            toks = ent["tokens"]
            n = min(len(toks), plen)
            neq = np.flatnonzero(toks[:n] != prompt[:n])
            common = int(neq[0]) if neq.size else n
            cov = min(common, plen - 1, ent["reg_tokens"])
            if cov > best_cov:
                best, best_cov = ent, cov
        return best, best_cov

    def _pg_admit(self, slot: int, req: Request):
        """Reserve the row's whole block budget: shared prefix blocks by
        reference, the partly covered boundary block by a copy-on-write
        fork, the rest fresh. Returns (covered, [(src, dst) copies]), or
        None when the pool cannot hold the reservation even after eviction
        and preemption."""
        bs = self._pg_bs
        prompt = np.asarray(req.prompt)
        plen = int(prompt.shape[0])
        total = min(-(-(plen + int(req.max_new_tokens)) // bs),
                    self._pg_nblk)
        ent, covered = self._pg_lookup(prompt)
        shared_full = covered // bs
        fresh_needed = total - shared_full
        # the soft target is the reservation plus the watermark headroom:
        # past it, evict cold registry prefixes, then preempt strictly
        # lower-priority rows. The hard gate stays fresh_needed: an
        # admission that fits is never deferred to keep headroom.
        want_free = fresh_needed + self._pg_headroom
        if len(self._pg_free) < want_free:
            self._pg_evict(want_free, protect=ent)
            if len(self._pg_free) < want_free:
                self._pg_preempt_for(req.priority, want_free)
        if len(self._pg_free) < fresh_needed:
            return None
        blocks: List[int] = []
        pairs: List[tuple] = []
        if ent is not None and covered > 0:
            for b in ent["blocks"][:shared_full]:
                self._pg_ref[b] += 1
                blocks.append(b)
            if covered % bs:
                # the boundary block is only partly covered: this row will
                # write positions >= covered into it, so it gets a private
                # copy first
                dst = self._pg_take_block()
                blocks.append(dst)
                pairs.append((ent["blocks"][shared_full], dst))
            ent["last_used"] = self._pg_clock
            self._pg_clock += 1
            self._pg_hits += 1
            self._pg_shared_tokens += covered
        while len(blocks) < total:
            blocks.append(self._pg_take_block())
        self._pg_rows[slot] = blocks
        self._pg_set_row(slot, blocks)
        self._pg_admits += 1
        return covered, pairs

    def _pg_set_row(self, slot: int, blocks: List[int]):
        """The slot's host table row: `blocks`, then entries repeating the
        row's first block (nothing reads them: the row's frontier stays in
        its reservation; scrub derives its block mask from the whole row,
        so they must name a block this row owns, never a neighbour's)."""
        row = np.full(self._pg_nblk, blocks[0], np.int32)
        row[:len(blocks)] = blocks
        self._pg_table[slot] = row

    def _pg_register(self, slot: int):
        """Register a freshly prefilled prompt in the prefix registry: the
        blocks covering [0, prompt_len) gain a registry reference, so the
        prefix outlives its donor. Decode tokens the donor appends past
        prompt_len may land in the registered tail block — harmless: a
        later sharer forks that block and prefills past `covered`."""
        prompt = np.asarray(self._slot_req[slot].prompt)
        key = self._pg_key(prompt)
        ent = self._pg_registry.get(key)
        if ent is not None:
            ent["last_used"] = self._pg_clock
            self._pg_clock += 1
            return
        nb = -(-int(prompt.shape[0]) // self._pg_bs)
        blocks = list(self._pg_rows[slot][:nb])
        for b in blocks:
            self._pg_ref[b] += 1
        self._pg_registry[key] = {
            "tokens": prompt.astype(np.int32).copy(),
            "blocks": blocks,
            "reg_tokens": int(prompt.shape[0]),
            "last_used": self._pg_clock,
        }
        self._pg_clock += 1

    def _pg_extend_bad(self, bad_slots):
        """Close a quarantine set over block sharing: scrubbing a bad row
        zeroes every block its table names, prefix blocks other rows share
        included — those rows lose their values too and must replay.
        Registry entries touching a scrubbed block are dropped. Returns
        (closed slot list, scrubbed block set); the caller also drops the
        swap entries whose KEPT blocks got scrubbed."""
        bad = set(int(s) for s in bad_slots
                  if self._slot_req[int(s)] is not None)
        scrubbed = set()
        for s in bad:
            scrubbed.update(self._pg_rows[s])
        changed = True
        while changed:
            changed = False
            for s in range(self.slots):
                if s in bad or self._slot_req[s] is None:
                    continue
                if scrubbed.intersection(self._pg_rows[s]):
                    bad.add(s)
                    scrubbed.update(self._pg_rows[s])
                    changed = True
        for key in [k for k, ent in self._pg_registry.items()
                    if scrubbed.intersection(ent["blocks"])]:
            for b in self._pg_registry.pop(key)["blocks"]:
                self._pg_free_block(b)
        return np.asarray(sorted(bad), np.int64), scrubbed

    # ---------------------------------------------- swap-out / preemption
    def _pg_victims(self, prio: int) -> List[int]:
        """Resident rows an admission at priority `prio` may preempt,
        cheapest first. Only STRICTLY lower priorities qualify (equal never
        preempts equal: no two rows thrash each other's residency). Order:
        lowest priority, then most deadline slack (no deadline is infinite
        slack), then most blocks freed at once."""
        cands = []
        for s in range(self.slots):
            r = self._slot_req[s]
            if r is None or r.priority >= prio:
                continue
            if s in self._admit_protect:
                # admitted in this pass: its device state does not exist
                # yet, so a swap-out would gather stale bytes
                continue
            freeable = sum(1 for b in self._pg_rows[s]
                           if self._pg_ref[b] == 1)
            slack = (float("inf") if r.deadline_steps is None
                     else r.deadline_steps - (self._step_no - r._submit_step))
            cands.append(((r.priority, -slack, -freeable), s))
        return [s for _, s in sorted(cands)]

    def _pg_preempt_for(self, prio: int, want_free: int):
        """Swap out strictly lower-priority rows until `want_free` blocks
        are free or no victim is left."""
        for s in self._pg_victims(prio):
            if len(self._pg_free) >= want_free:
                break
            self._pg_swap_out(s)

    def _best_preempted(self) -> int:
        """Index of the PREEMPTED request to re-admit next: highest
        priority first, preemption order within a priority."""
        return max(range(len(self._preempted)),
                   key=lambda i: (self._preempted[i].priority, -i))

    def _pg_swap_out(self, slot: int):
        """Preempt the resident row: gather its PRIVATE blocks off the card
        into the host block store (at the scheduler boundary, outside the
        step program) and free them. Blocks it shares with the registry or
        other rows are NOT swapped (their bytes stay resident either way;
        copying them would duplicate them, and eviction could then tear
        them from the sharers): the swap entry keeps the row's reference.
        The request parks as PREEMPTED and re-admits ahead of fresh
        ones."""
        req = self._slot_req[slot]
        kept: List[tuple] = []        # (logical j, physical block)
        priv_j: List[int] = []
        priv_b: List[int] = []
        for j, b in enumerate(self._pg_rows[slot]):
            if self._pg_ref[b] > 1:
                kept.append((j, int(b)))
            else:
                priv_j.append(j)
                priv_b.append(int(b))
        hids: List[int] = []
        if priv_b:
            slabs = T.gather_pool_blocks(self.caches, priv_b)
            hids = self._swap_store.put(slabs, len(priv_b))
            self.stats.swap_outs += 1
        self._swap_entries[req.rid] = {
            "kept": kept, "js": priv_j, "hids": hids,
            "total": len(self._pg_rows[slot]),
            "pos": int(T.kv_caches(self.caches)[0].pos[slot]),
            "prefilling": bool(self._prefilling[slot]),
            "prefill_off": int(self._prefill_off[slot]),
            "remaining": int(self._remaining[slot]),
            "last": int(self._last[slot, 0]),
        }
        for b in priv_b:
            self._pg_free_block(b)
        self._pg_rows[slot] = []
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._prefilling[slot] = False
        self._prefill_off[slot] = 0
        req.status = "PREEMPTED"
        self._preempted.append(req)
        self.stats.preemptions += 1

    def _pg_swap_in(self, slot: int, req: Request):
        """Reserve room for a PREEMPTED row's host-held blocks (eviction,
        then preemption of rows strictly below `req.priority`, may run) and
        rebuild its logical block list around the references it kept.
        Returns (entry, dst blocks), or None when the pool still cannot
        hold it."""
        entry = self._swap_entries[req.rid]
        fresh_needed = len(entry["js"])
        want_free = fresh_needed + self._pg_headroom
        if len(self._pg_free) < want_free:
            self._pg_evict(want_free)
            if len(self._pg_free) < want_free:
                self._pg_preempt_for(req.priority, want_free)
        if len(self._pg_free) < fresh_needed:
            return None
        blocks: List[int] = [-1] * entry["total"]
        for j, b in entry["kept"]:
            blocks[j] = b
        dst: List[int] = []
        for j in entry["js"]:
            blocks[j] = self._pg_take_block()
            dst.append(blocks[j])
        self._pg_rows[slot] = blocks
        self._pg_set_row(slot, blocks)
        return entry, dst

    def _pg_restore_blocks(self, entry: dict, dst: List[int]):
        """Write the host-held block bytes into the freshly reserved blocks
        — one write of nblk blocks, the slabs zero-padded and `dst` padded
        with the trash block P, a fixed width as the reference's — then
        drop them from the host store."""
        if not dst:
            return
        slabs = self._swap_store.get(entry["hids"])
        pad_n = self._pg_nblk - len(dst)
        if pad_n:
            slabs = {name: torch.cat([a, a.new_zeros(
                a.shape[:1] + (pad_n,) + a.shape[2:])], dim=1)
                for name, a in slabs.items()}
        dvec = np.full(self._pg_nblk, self._pg_pool, np.int64)
        dvec[:len(dst)] = dst
        T.write_pool_blocks(self.caches, slabs, self._tensor(dvec))
        self._swap_store.free(entry["hids"])

    def _drop_swap_entry(self, req: Request):
        """Release what a PREEMPTED request holds: its kept block
        references and its host-store bytes (it expired, or its kept
        blocks were scrubbed)."""
        entry = self._swap_entries.pop(req.rid, None)
        if entry is None:
            return
        for _, b in entry["kept"]:
            self._pg_free_block(b)
        self._swap_store.free(entry["hids"])

    def _pg_apply_pressure(self, fault) -> bool:
        """pool_pressure fault: squeeze the free list down to `fault.blocks`
        blocks by holding the rest aside (released after `fault.duration`
        steps; None = never)."""
        if not self._paged:
            return False
        n_hold = max(0, len(self._pg_free) - max(0, int(fault.blocks)))
        if n_hold == 0:
            return False
        # from the tail: the held set is deterministic and the low blocks
        # the allocator prefers stay free
        held = [self._pg_free.pop() for _ in range(n_hold)]
        release = None if fault.duration is None \
            else self._step_no + int(fault.duration)
        self._pg_holds.append([release, held])
        return True

    def _pg_release_pressure(self):
        """Return expired pool_pressure holds to the free list."""
        keep = []
        for release, held in self._pg_holds:
            if release is not None and self._step_no >= release:
                for b in held:
                    bisect.insort(self._pg_free, b)
            else:
                keep.append([release, held])
        self._pg_holds = keep

    def _pg_block_layout(self) -> dict:
        """{pool name: (shape, dtype tag)} of one host-stored block of this
        engine's caches (one slab a KV layer): the layout a snapshot's swap
        store must match."""
        layers = T.kv_caches(self.caches)
        c = layers[0]
        return {name: ((len(layers), 1) + tuple(pool.shape[1:]),
                       str(pool.dtype).replace("torch.", ""))
                for name in T.pool_fields(c)
                for pool in (getattr(c, name),)}

    def pool_stats(self) -> dict:
        """Block-pool occupancy, prefix-sharing and swap counters; {"paged":
        False} for a per-slot engine."""
        if not self._paged:
            return {"paged": False}
        used = self._pg_pool - len(self._pg_free)
        return {
            "paged": True,
            "pool_blocks": self._pg_pool,
            "block_size": self._pg_bs,
            "used_blocks": used,
            "free_blocks": len(self._pg_free),
            "occupancy": used / self._pg_pool,
            "registry_entries": len(self._pg_registry),
            "admitted": self._pg_admits,
            "prefix_hits": self._pg_hits,
            "prefix_hit_rate": (self._pg_hits / self._pg_admits
                                if self._pg_admits else 0.0),
            "shared_tokens": self._pg_shared_tokens,
            "cow_copies": self._pg_cow_copies,
            "evictions": self._pg_evictions,
            "eviction_skips": self._pg_evict_skips,
            "deferred_admissions": self._pg_deferred,
            "swap_watermark": self._swap_watermark,
            "watermark_blocks": self._pg_pool - self._pg_headroom,
            "preemptions": self.stats.preemptions,
            "swap_outs": self.stats.swap_outs,
            "swap_ins": self.stats.swap_ins,
            "preempted_now": len(self._preempted),
            "host_blocks": len(self._swap_store),
            "host_bytes": self._swap_store.nbytes(),
            "swap_bytes_out": self._swap_store.bytes_out,
            "swap_bytes_in": self._swap_store.bytes_in,
            "pressure_held": sum(len(h) for _, h in self._pg_holds),
        }

    # -------------------------------------------------------- fault surface
    def arm_fault_plan(self, plan: Optional[faultlib.FaultPlan]):
        """Arm (or disarm, with None) a fault-injection plan. The engine
        consults it at step start (latency, KV and weight poison, pool
        pressure) and at every launch (launch faults, logits poison). On a
        partition of several ranks every rank arms the same plan (a
        collective checks it): ValueError on every rank otherwise."""
        if self._ranks() > 1:
            self._check_plan_alike(plan)
        self._fault_plan = plan
        return self

    def _check_plan_alike(self, plan: Optional[faultlib.FaultPlan]):
        text = repr([] if plan is None else [
            dataclasses.replace(f, fired=False, tripped=False)
            for f in plan.faults])
        if not self._same_on_every_rank(text, "engine.fault_plan"):
            raise ValueError(
                f"the ranks of a partition of {self._ranks()} armed "
                "different fault plans; arm the same plan on every rank")

    @property
    def step_no(self) -> int:
        """Engine steps taken so far: the fault plan's step coordinate. It
        advances on every step(), idle ones too."""
        return self._step_no

    def degraded_routes(self) -> tuple:
        """Every demotion so far, oldest first: dicts of the step, the
        error, and the decode/prefill routes before and after."""
        return tuple(self._degraded)

    def _inject_pre_step(self, plan: faultlib.FaultPlan, step: int):
        """Host-side faults due before this step's launches: latency
        stalls, device-state poison (a slot's KV, the shared weights) and
        pool pressure."""
        for f in plan.take("latency", step):
            f.tripped = True
            time.sleep(f.delay_s)
        for f in plan.take("poison", step, target="kv"):
            if f.slot is None:
                continue
            faultlib.poison_caches(self.caches, int(f.slot), f.value)
            f.tripped = True
        for f in plan.take("poison", step, target="weight"):
            self.model = faultlib.poison_weights(self.model, f.value)
            f.tripped = True
        for f in plan.take("pool_pressure", step):
            f.tripped = self._pg_apply_pressure(f)

    def _requeue_or_fail(self, req: Request, newly: List[Request]):
        """A quarantined request: replay it from its prompt at the FRONT of
        the queue, or fail it once its replay budget is spent."""
        self.stats.quarantines += 1
        req.replays += 1
        if req.replays > self.max_replays:
            req.status = "FAILED"
            req.done = True
            self.stats.failed_requests += 1
            self.finished.append(req)
            newly.append(req)
        else:
            req.out_tokens = []
            req.status = "queued"
            self.queue.appendleft(req)

    def _quarantine(self, bad_slots, newly: List[Request]):
        """Evict poisoned slots: scrub their cache rows (values AND
        positions, `scrub_slots`) and replay each request from its prompt;
        a request whose replay budget is spent fails instead.

        Paged engines first close the bad set over block sharing
        (scrubbing a row's blocks corrupts every row sharing them) and drop
        the registry prefixes whose blocks get scrubbed: a quarantined NaN
        must never reach another row through a shared block. A PREEMPTED
        request whose KEPT blocks get scrubbed loses its resume point the
        same way: its swap entry goes and it replays from its prompt."""
        scrubbed = set()
        if self._paged:
            bad_slots, scrubbed = self._pg_extend_bad(bad_slots)
        mask = np.zeros(self.slots, bool)
        for s in bad_slots:
            req = self._slot_req[s]
            if req is None:
                continue
            mask[s] = True
            self._slot_req[s] = None
            self._remaining[s] = 0
            self._prefilling[s] = False
            self._prefill_off[s] = 0
            self._last[s, 0] = 0
            if self._paged:
                # host bookkeeping only: the device table still names the
                # blocks, which is what scrub_slots reads below
                self._pg_release_row(s)
            self._requeue_or_fail(req, newly)
        if scrubbed:
            for req in [r for r in self._preempted
                        if scrubbed.intersection(
                            b for _, b in self._swap_entries[r.rid]["kept"])]:
                self._preempted.remove(req)
                self._drop_swap_entry(req)
                self._requeue_or_fail(req, newly)
        if mask.any():
            T.scrub_slots(self.caches, self._tensor(mask))

    def _lead_rank(self) -> bool:
        """True on one rank, and on the rank of a partition at coordinate
        0 of every axis: the rank whose clock the partition keeps."""
        return self.mesh is None or all(
            self.mesh.get_local_rank(n) == 0 for n in self.mesh.mesh_dim_names)

    def _clock(self, agree: bool = True) -> float:
        """The time TTLs are judged by: this process's monotonic clock. On
        a partition of several ranks, with `agree`, every rank takes the
        lead rank's reading (a max all-reduce of one float64, the other
        ranks giving -inf), so all of them stamp and expire alike."""
        now = time.monotonic()
        if agree and self._ranks() > 1:
            from ..dist.collectives import all_reduce
            t = torch.tensor([now if self._lead_rank() else -np.inf],
                             dtype=torch.float64, device=self.device)
            now = float(all_reduce(t, self.mesh.mesh_dim_names, "max",
                                   mesh=self.mesh, site="engine.clock")[0])
        return now

    def _expired(self, req: Request, now: float) -> bool:
        if req.deadline_steps is not None and \
                self._step_no - req._submit_step >= req.deadline_steps:
            return True
        return req.ttl_s is not None and now - req._submit_t > req.ttl_s

    def _timeout(self, req: Request, newly: List[Request]):
        req.status = "TIMEOUT"
        req.done = True
        self.stats.timeouts += 1
        self.finished.append(req)
        newly.append(req)

    def _expire_deadlines(self, newly: List[Request]):
        """Finish expired requests with status TIMEOUT: PREEMPTED ones
        (their kept blocks and host bytes released), queued ones, and
        resident ones (slot freed; the next admission rewinds the row)."""
        now = self._clock(agree=self._has_ttl)
        kept_p: List[Request] = []
        for req in self._preempted:
            if self._expired(req, now):
                self._drop_swap_entry(req)
                self._timeout(req, newly)
            else:
                kept_p.append(req)
        self._preempted = kept_p
        kept: Deque[Request] = deque()
        for req in self.queue:
            if self._expired(req, now):
                self._timeout(req, newly)
            else:
                kept.append(req)
        self.queue = kept
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is not None and self._expired(req, now):
                self.stats.timeouts += 1
                self._finish(s, status="TIMEOUT")
                newly.append(req)

    # -------------------------------------------------------------- stepping
    def _emit(self, s: int, tok: int, newly: List[Request]):
        """Record one sampled token of slot s; finish the request at its
        budget or at EOS."""
        req = self._slot_req[s]
        req.out_tokens.append(tok)
        self.stats.generated_tokens += 1
        self._remaining[s] -= 1
        self._last[s, 0] = tok
        if self._remaining[s] <= 0 or (self.eos_id is not None
                                       and tok == self.eos_id):
            self._finish(s)
            newly.append(req)

    def _occupied(self) -> np.ndarray:
        return np.asarray([r is not None for r in self._slot_req])

    def _prefill_chunk_step(self, newly: List[Request]):
        """ONE chunk-shaped prefill launch: every prefilling row advances by
        up to `prefill_chunk` prompt tokens (right-padded, `lengths` marking
        the real count); decoding and free rows ride along with
        lengths == 0 and keep their caches untouched. Health is read only
        where logits are: at a launch that completes a prompt, where a
        poisoned row shows after its attention."""
        c = self.prefill_chunk
        toks = np.full((self.slots, c), PAD, np.int32)
        lens = np.zeros(self.slots, np.int32)
        finishing = []
        for s, r in enumerate(self._slot_req):
            if r is None or not self._prefilling[s]:
                continue
            off = int(self._prefill_off[s])
            take = min(c, len(r.prompt) - off)
            toks[s, :take] = r.prompt[off:off + take]
            lens[s] = take
            if off + take >= len(r.prompt):
                finishing.append(s)
        consumed = np.zeros(self.slots, bool)
        consumed[finishing] = True
        logits, health = self._launch(self._tensor(toks), self._tensor(lens),
                                      consumed)
        self.stats.prefill_chunk_calls += 1
        self.stats.prefill_tokens += int(lens.sum())
        for s, r in enumerate(self._slot_req):
            if r is not None and self._prefilling[s]:
                self._prefill_off[s] += lens[s]
        if not finishing:
            # mid-prompt chunks consume no logits: no sync, no transfer
            return
        idx = self._tensor(np.clip(lens - 1, 0, c - 1).astype(np.int64))
        rows = torch.arange(self.slots, device=self.device)
        first, ok = self._greedy(logits[rows, idx], health)
        bad = self._occupied() & ~ok
        if bad.any():
            self._quarantine(np.flatnonzero(bad), newly)
        for s in finishing:
            if bad[s] or self._slot_req[s] is None:
                continue
            self._prefilling[s] = False
            if self._paged:
                # the prompt's K/V is resident now: register the prefix
                # before the finish check, so even a one-token request
                # donates its prompt
                self._pg_register(s)
            self._emit(s, int(first[s]), newly)

    def _decode_launch(self, newly: List[Request]):
        """ONE batched decode launch for every mid-generation slot;
        prefilling and free rows pass lengths == 0 and sit it out. Any
        occupied row gone non-finite (its own logits, or a poisoned cache
        seen by a row sitting the launch out) is quarantined, its token
        never emitted."""
        active = np.asarray([r is not None and not self._prefilling[s]
                             for s, r in enumerate(self._slot_req)])
        if not active.any():
            return
        logits, health = self._launch(
            self._tensor(self._last), self._tensor(active.astype(np.int32)),
            active)
        self.stats.decode_steps += 1
        nxt, ok = self._greedy(logits[:, -1], health)
        bad = self._occupied() & ~ok
        if bad.any():
            self._quarantine(np.flatnonzero(bad), newly)
        for s in np.flatnonzero(active & ~bad):
            if self._slot_req[s] is not None:
                self._emit(int(s), int(nxt[s]), newly)

    def _merged_step(self, newly: List[Request]):
        """Merged mode: ONE l=1 launch advances every occupied row —
        prefilling rows feed their next prompt token, decoding rows their
        last sampled one — and its health is read for every row. Counted
        as a decode step when any row decoded, else as a prefill token
        step."""
        toks = np.full((self.slots, 1), PAD, np.int32)
        lens = np.zeros(self.slots, np.int32)
        consumed = np.zeros(self.slots, bool)
        n_prefill = n_decode = 0
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            lens[s] = 1
            if self._prefilling[s]:
                toks[s, 0] = r.prompt[int(self._prefill_off[s])]
                consumed[s] = self._prefill_off[s] + 1 >= len(r.prompt)
                n_prefill += 1
            else:
                toks[s, 0] = self._last[s, 0]
                consumed[s] = True
                n_decode += 1
        logits, health = self._launch(self._tensor(toks), self._tensor(lens),
                                      consumed)
        if n_decode:
            self.stats.decode_steps += 1
        else:
            self.stats.prefill_token_steps += 1
        self.stats.prefill_tokens += n_prefill
        nxt, ok = self._greedy(logits[:, 0], health)
        bad = self._occupied() & ~ok
        if bad.any():
            self._quarantine(np.flatnonzero(bad), newly)
        for s in range(self.slots):
            if self._slot_req[s] is None or bad[s]:
                continue
            if self._prefilling[s]:
                self._prefill_off[s] += 1
                if self._prefill_off[s] < len(self._slot_req[s].prompt):
                    continue
                self._prefilling[s] = False
                if self._paged:
                    self._pg_register(s)
            self._emit(s, int(nxt[s]), newly)

    # --------------------------------------------------------------- driving
    def step(self) -> List[Request]:
        """Admit into free slots, then advance every in-flight request once:
        one chunk-prefill launch for admitting rows (when any), then one
        batched decode launch for generating rows (when any); in merged
        mode one l=1 launch for all of them. Returns the requests that
        finished during this step (TIMEOUT and FAILED ones included). The
        step counter advances on every call, idle or not."""
        newly: List[Request] = []
        plan = self._fault_plan
        if plan is not None:
            self._inject_pre_step(plan, self._step_no)
        if self._paged and self._pg_holds:
            self._pg_release_pressure()
        if self._has_deadlines:
            self._expire_deadlines(newly)
        self._admit(newly)
        if self._merged_mode():
            if self._occupied().any():
                self._merged_step(newly)
        else:
            if self._prefilling.any():
                self._prefill_chunk_step(newly)
            self._decode_launch(newly)
        self._step_no += 1
        return newly

    def pending(self) -> bool:
        return bool(self.queue) or bool(self._preempted) \
            or any(r is not None for r in self._slot_req)

    def run_until_drained(self, max_steps: int = 100000) -> List[Request]:
        for _ in range(max_steps):
            if not self.pending():
                break
            self.step()
        else:
            if self.pending():
                raise EngineStalledError(
                    f"engine not drained after {max_steps} steps",
                    stuck=[o for o in self.occupancy() if o is not None],
                    queue_depth=len(self.queue))
        return self.finished

    def warmup(self) -> "ServingEngine":
        """Build the kernels and make one idle launch of each width (the
        chunk and 1; 1 alone in merged mode) with every row at lengths == 0
        — a bitwise no-op on the caches — so the first request pays no
        build or first-launch cost. Returns self."""
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        for w in (1,) if self._merged_mode() else (self.prefill_chunk, 1):
            tok = torch.zeros((self.slots, w), dtype=torch.int32,
                              device=self.device)
            self._step_program(tok, zeros)
        return self

    # ---------------------------------------------------------- introspection
    def step_widths(self) -> tuple:
        """Token widths the ONE step program runs at over the engine's
        lifetime: (1,) for merged-mode engines, else (1, prefill_chunk)."""
        return (1,) if self._merged_mode() else (1, self.prefill_chunk)

    def step_trace(self, width: int, recorder):
        """Run the step program once at token width `width` with every row
        idle (lengths == 0: no cache value changes) inside `recorder`, a
        context manager the caller passes in (the analysis package's
        `hotloop.StepRecorder` records the step's ops), and return the
        recorder."""
        tok = torch.zeros((self.slots, width), dtype=torch.int32,
                          device=self.device)
        lens = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        with recorder, torch.no_grad():
            self._step_program(tok, lens)
        return recorder

    def cache_buffers(self) -> List[tuple]:
        """(name, data_ptr, shape, dtype) of every tensor field of every
        cache layer, as "layer.field": the buffers a captured step would
        have to keep in place."""
        return [(f"{i}.{f.name}", t.data_ptr(), tuple(t.shape), t.dtype)
                for i, c in enumerate(self.caches)
                for f in dataclasses.fields(c)
                if isinstance(t := getattr(c, f.name), torch.Tensor)]

    def step_trace_count(self) -> int:
        """Distinct token widths the step program has run at. After warmup
        (or any real traffic) it must equal len(step_widths())."""
        return len(self._widths_launched)

    # ------------------------------------------------------- snapshot/restore
    def _ranks(self) -> int:
        """The ranks of the partition this engine serves on (1 without
        one)."""
        return 1 if self.mesh is None else self.mesh.size()

    def _same_on_every_rank(self, text: str, site: str) -> bool:
        """True when every rank of the partition holds the same `text` (a
        max all-reduce of a digest and its negation)."""
        from ..dist.collectives import all_reduce
        d = int.from_bytes(hashlib.sha256(text.encode()).digest()[:7],
                           "little")
        got = all_reduce(torch.tensor([d, -d], device=self.device),
                         self.mesh.mesh_dim_names, "max", mesh=self.mesh,
                         site=site)
        return int(got[0]) == -int(got[1])

    def snapshot(self, ckpt_dir, *, step: Optional[int] = None,
                 include_params: bool = False) -> str:
        """Persist the whole engine state through `checkpoint.store`: the
        caches as the checkpoint tree (plus the model's tensors with
        `include_params`, the recovery from weight corruption), and the
        host bookkeeping — per-slot requests, queue, stats, last tokens,
        the block allocator, the PREEMPTED requests and the host block
        store — as JSON. Atomic (temp dir, then rename). Returns the
        checkpoint's path.

        On a partition of several ranks every rank calls it: each writes
        its own caches (its heads), weight shards and host block store,
        and the lead the one manifest of the mesh and the bookkeeping. A
        collective first checks that the bookkeeping is the same on every
        rank; if it is not, every rank raises ValueError and nothing is
        written."""
        from ..checkpoint import store
        tree = {"caches": self.caches}
        if include_params:
            tree["params"] = self.model.state_dict()

        extra = {"engine": {
            "cache_kinds": _cache_kinds(self.caches),
            "step_no": int(self._step_no),
            "include_params": include_params,
            "last": self._last.tolist(),
            "remaining": self._remaining.tolist(),
            "prefilling": self._prefilling.tolist(),
            "prefill_off": self._prefill_off.tolist(),
            "slots": [_req_state(r) if r is not None else None
                      for r in self._slot_req],
            "queue": [_req_state(r) for r in self.queue],
            "stats": dataclasses.asdict(self.stats),
        }}
        mesh = self.mesh if self._ranks() > 1 else None
        rank_extra = None
        if self._paged:
            extra["engine"]["paged"] = {
                "block_size": self._pg_bs,
                "pool_blocks": self._pg_pool,
                "free": list(self._pg_free),
                "ref": self._pg_ref.tolist(),
                "rows": [list(r) for r in self._pg_rows],
                "table": self._pg_table.tolist(),
                "registry": [
                    {"tokens": ent["tokens"].tolist(),
                     "blocks": list(ent["blocks"]),
                     "reg_tokens": ent["reg_tokens"],
                     "last_used": ent["last_used"]}
                    for ent in self._pg_registry.values()],
                "clock": self._pg_clock,
                "counters": [self._pg_admits, self._pg_hits,
                             self._pg_shared_tokens, self._pg_cow_copies,
                             self._pg_evictions, self._pg_deferred],
                "evict_skips": self._pg_evict_skips,
                "swap_watermark": self._swap_watermark,
                "preempted": [_req_state(r) for r in self._preempted],
                "swap_entries": {
                    str(rid): {**e, "kept": [[j, b] for j, b in e["kept"]]}
                    for rid, e in self._swap_entries.items()},
            }
            # preempted rows' spilled bytes round-trip, so they still
            # resume bitwise after a restore; on a partition they are this
            # rank's heads, so each rank keeps its own
            swap = {"swap_store": self._swap_store.state_dict()}
            if mesh is None:
                extra["engine"]["paged"].update(swap)
            else:
                rank_extra = swap
        if mesh is not None and not self._same_on_every_rank(
                json.dumps(extra, sort_keys=True), "engine.snapshot"):
            raise ValueError(
                f"snapshot of an engine on a partition of {self._ranks()} "
                "ranks: the ranks' host bookkeeping differs, so no "
                "checkpoint was written")
        return str(store.save(ckpt_dir,
                              step if step is not None else self._step_no,
                              tree, extra=extra, mesh=mesh,
                              rank_extra=rank_extra))

    def _load_snapshot(self, ckpt_dir, step: Optional[int], mesh):
        """Read a `snapshot()` and check that it fits this engine, changing
        nothing: (caches tree, engine extra, step, host block store, params
        tree or None), or ValueError."""
        from ..checkpoint import store
        try:
            tree, extra, got = store.restore(
                ckpt_dir, {"caches": self.caches}, step=step, mesh=mesh)
        except KeyError as err:
            raise ValueError(
                f"snapshot does not fit this engine's cache layout "
                f"({_kinds_text(_cache_kinds(self.caches))}): {err}") \
                from None
        eng = extra["engine"]
        kinds = _cache_kinds(self.caches)
        if eng["cache_kinds"] != kinds:
            raise ValueError(
                f"snapshot caches ({_kinds_text(eng['cache_kinds'])}) do "
                f"not fit this engine's ({_kinds_text(kinds)})")
        if len(eng["last"]) != self.slots:
            raise ValueError(f"snapshot has {len(eng['last'])} slots, "
                             f"engine has {self.slots}")
        pg = eng.get("paged")
        if (pg is not None) != self._paged:
            raise ValueError(
                "snapshot and engine disagree on paged mode: snapshot "
                f"{'has' if pg is not None else 'lacks'} a block pool, "
                f"engine paged={self._paged}")
        if self._paged and (pg["block_size"] != self._pg_bs
                            or pg["pool_blocks"] != self._pg_pool):
            raise ValueError(
                f"snapshot pool geometry ({pg['pool_blocks']} blocks x "
                f"{pg['block_size']} tokens) does not match the "
                f"engine's ({self._pg_pool} x {self._pg_bs})")
        swap_store = HostBlockStore()
        swap = (pg or {}).get("swap_store") if mesh is None \
            else extra["rank"].get("swap_store")
        if self._paged and swap is not None:
            swap_store.load_state(swap, self._pg_block_layout())
        ptree = None
        if eng["include_params"]:
            ptree, _, _ = store.restore(
                ckpt_dir, {"params": self.model.state_dict()}, step=got,
                mesh=mesh)
        return tree, eng, got, swap_store, ptree

    @torch.no_grad()
    def restore(self, ckpt_dir, step: Optional[int] = None) -> int:
        """Load a `snapshot()` into THIS engine: same config, slots,
        max_len and cache layout (the kinds of the layers' caches, KV or
        recurrent, and their shapes), or ValueError before anything
        changes.
        The cache tensors (and with a params snapshot the model's) are
        written in place, never rebound. In-flight generation resumes
        byte-identically: caches, positions, last tokens and the replay
        and queue bookkeeping all round-trip. TTLs restart at restore time
        (the monotonic clock does not survive a process; on a partition
        the lead rank's time) and `finished` starts empty (requests done
        before the snapshot were delivered). Returns the restored step.

        On a partition of several ranks every rank calls it and loads its
        own shard. A snapshot of another mesh shape or axis names (one of
        a single rank among them, and the reverse), a missing rank shard
        or a shard whose caches are not this rank's (its n_kv / R heads)
        is refused with ValueError on every rank (a collective carries
        one rank's refusal to the others)."""
        mesh = self.mesh if self._ranks() > 1 else None
        err = loaded = None
        try:
            loaded = self._load_snapshot(ckpt_dir, step, mesh)
        except (ValueError, KeyError, OSError) as e:
            if mesh is None:
                raise
            err = e
        if mesh is not None:
            from ..dist.collectives import all_reduce
            bad = all_reduce(torch.tensor([int(err is not None)],
                                          device=self.device),
                             mesh.mesh_dim_names, "max", mesh=mesh,
                             site="engine.restore")
            if err is not None:
                raise ValueError(str(err)) from err
            if int(bad[0]):
                raise ValueError(
                    f"restore on a partition of {self._ranks()} ranks: "
                    "another rank refused the snapshot")
        tree, eng, got, swap_store, ptree = loaded
        if ptree is not None:
            params = self.model.state_dict()
            for name, t in ptree["params"].items():
                params[name].copy_(t)
        for dst, src in zip(self.caches, tree["caches"]):
            for f in dataclasses.fields(dst):
                getattr(dst, f.name).copy_(getattr(src, f.name))

        now = self._clock()
        pg = eng.get("paged")
        self._step_no = int(eng["step_no"])
        self._last = np.asarray(eng["last"], np.int32)
        self._remaining = np.asarray(eng["remaining"], np.int64)
        self._prefilling = np.asarray(eng["prefilling"], bool)
        self._prefill_off = np.asarray(eng["prefill_off"], np.int64)
        self._slot_req = [_req_rebuild(st, now) if st is not None else None
                          for st in eng["slots"]]
        self.queue = deque(_req_rebuild(st, now) for st in eng["queue"])
        self.finished = []
        self.stats = EngineStats(**eng["stats"])
        self._preempted, self._swap_entries = [], {}
        self._swap_store = swap_store
        if self._paged:
            self._pg_free = list(pg["free"])
            self._pg_ref = np.asarray(pg["ref"], np.int64)
            self._pg_rows = [list(r) for r in pg["rows"]]
            self._pg_table = np.asarray(pg["table"], np.int32)
            self._pg_registry = {}
            for ent in pg["registry"]:
                toks = np.asarray(ent["tokens"], np.int32)
                self._pg_registry[self._pg_key(toks)] = {
                    "tokens": toks, "blocks": list(ent["blocks"]),
                    "reg_tokens": int(ent["reg_tokens"]),
                    "last_used": int(ent["last_used"])}
            self._pg_clock = int(pg["clock"])
            (self._pg_admits, self._pg_hits, self._pg_shared_tokens,
             self._pg_cow_copies, self._pg_evictions,
             self._pg_deferred) = [int(x) for x in pg["counters"]]
            self._pg_evict_skips = int(pg["evict_skips"])
            self._pg_holds = []
            self._preempted = [_req_rebuild(st, now)
                               for st in pg["preempted"]]
            self._swap_entries = {
                int(rid): {**e, "kept": [(int(j), int(b))
                                         for j, b in e["kept"]]}
                for rid, e in pg["swap_entries"].items()}
        live = [r for r in [*self._slot_req, *self.queue, *self._preempted]
                if r is not None]
        self._has_deadlines = self._has_deadlines or any(
            r.deadline_steps is not None or r.ttl_s is not None for r in live)
        self._has_ttl = self._has_ttl or any(r.ttl_s is not None
                                             for r in live)
        return got

    # ---------------------------------------------------------- introspection
    def weight_route(self) -> str:
        """How the Linear weights reach the matmul plane: "resident-<fmt>"
        (codes through api.ops.matmul_codes), "fake-quant-<fmt>" (dense
        float32 re-quantized per call under the QuantPolicy the model's
        Linears were built with), or "dense"."""
        rfmt = T.resident_format(self.model)
        if rfmt is not None:
            return f"resident-{rfmt}"
        weights = self.model.cfg.quant.weights
        if weights != "none":
            return f"fake-quant-{weights}"
        return "dense"

    def decode_route(self) -> str:
        """Attention impl the engine's decode steps dispatch to under its
        policy: "cuda-decode" (flash-decode kernel), or "ref"."""
        with self._policy_ctx():
            return api.ops.attention_route(
                lq=1, lk=self.max_len, causal=True, offset_ndim=1,
                quantized=self.cfg.kv_quant)

    def prefill_route(self) -> str:
        """Attention impl the engine's admission prefill dispatches to:
        "cuda-prefill" (varlen flash-prefill kernel; any chunk > 1),
        "cuda-decode" (merged mode, whose prefill is l=1 launches), or
        "ref"."""
        lq = 1 if self._merged_mode() else self.prefill_chunk
        with self._policy_ctx():
            return api.ops.attention_route(
                lq=lq, lk=self.max_len, causal=True,
                offset_ndim=1, quantized=self.cfg.kv_quant)

    def occupancy(self) -> List[Optional[dict]]:
        """Per-slot view: None for a free slot, else the resident request's
        {rid, generated, remaining}."""
        return [None if r is None else
                {"rid": r.rid, "generated": len(r.out_tokens),
                 "remaining": int(self._remaining[s])}
                for s, r in enumerate(self._slot_req)]

    def utilization(self) -> float:
        """Fraction of slots currently serving a request."""
        busy = sum(r is not None for r in self._slot_req)
        return busy / self.slots if self.slots else 0.0


def _sharded(model) -> bool:
    """True when some module of the model holds only this rank's shard
    (`dist.shard_params`)."""
    return any(getattr(m, "shards", None) for m in model.modules())


def _cache_kinds(caches) -> List[str]:
    return [type(c).__name__ for c in caches]


def _kinds_text(kinds: List[str]) -> str:
    """A '4 x MambaCache, 2 x KVCache'-style summary of cache kinds."""
    return ", ".join(f"{kinds.count(k)} x {k}" for k in dict.fromkeys(kinds))


def _cache_refs(c) -> dict:
    """{field: tensor} of a cache: the references a launch rebinds (a KV
    cache's pos, a recurrent state's fields; the rest are written in place
    and come back as the same objects)."""
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def _req_state(r: Request) -> dict:
    return {"rid": r.rid, "prompt": np.asarray(r.prompt).tolist(),
            "max_new_tokens": int(r.max_new_tokens),
            "out_tokens": list(r.out_tokens or []),
            "status": r.status, "replays": int(r.replays),
            "deadline_steps": r.deadline_steps,
            "ttl_s": r.ttl_s, "priority": int(r.priority),
            "submit_step": int(r._submit_step)}


def _req_rebuild(st: dict, now: float) -> Request:
    r = Request(rid=st["rid"], prompt=np.asarray(st["prompt"], np.int32),
                max_new_tokens=st["max_new_tokens"],
                out_tokens=list(st["out_tokens"]), status=st["status"],
                replays=st["replays"], deadline_steps=st["deadline_steps"],
                ttl_s=st["ttl_s"], priority=int(st["priority"]))
    r._submit_step = st["submit_step"]
    r._submit_t = now
    return r


class _InputProbe:
    """The resident engine's health probe over one model. Inside `with`,
    each decoder attention's output (o; self and cross attention) and MLP
    output projection (down, or a GELU MLP's fc2) writes the per-row sum
    of its input into one (points, slots) float32 buffer, one reduction
    launch each, a point per
    invocation (zamba2's shared block runs at every shared position, so
    its two projections record there each time); `finite()` then
    gives (slots,) True where every sum is finite. No other check sees
    these inputs: at a resident Linear the activation quantizer codes a
    NaN or inf as a finite value (the reference's `quantize_scaled` rule,
    ROADMAP C), while a NaN anywhere else rides the residual stream to the
    logits. An MoE layer is not probed: its Linears are never resident
    (and its shared expert sees flattened tokens, not slots); nor is the
    audio encoder, which runs once, at the engine's construction. The hooks
    live only for the launch, so the model carries none between steps."""

    def __init__(self, model):
        self.model = model
        self.mods = [_probe_point(m)
                     for name, m in model.layers.named_modules()
                     if isinstance(m, _PROBED)
                     and "moe" not in name.split(".")]
        # invocations a launch: each probed module once per layer holding it
        probed = {id(m) for m in self.mods}
        self.points = sum(
            1 for layer in model.layers for m in layer.modules()
            if isinstance(m, _PROBED) and id(_probe_point(m)) in probed)
        self.buf: Optional[torch.Tensor] = None

    def __enter__(self):
        self.buf, self.n = None, 0
        self.hooks = [m.register_forward_pre_hook(self._record)
                      for m in self.mods]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()

    def _record(self, mod, args):
        x = args[0]
        if self.buf is None:
            self.buf = torch.empty((self.points, x.shape[0]),
                                   dtype=torch.float32, device=x.device)
        torch.sum(x, tuple(range(1, x.dim())), dtype=torch.float32,
                  out=self.buf[self.n])
        self.n += 1

    def finite(self) -> torch.Tensor:
        return torch.isfinite(self.buf[:self.n].sum(0))


_PROBED = (Attention, CrossAttention, MLP)


def _probe_point(m):
    """The Linear whose input `_InputProbe` sums: an attention's output
    projection, an MLP's projection back to d_model."""
    return m.out_proj if isinstance(m, MLP) else m.o


def _dispatch_raiser(fault: faultlib.Fault):
    """The registry hook a dispatch-boundary launch fault installs: raise at
    the first (matching) op dispatch of the launch."""
    def hook(op_name: str, impl: str):
        if fault.op is not None and op_name != fault.op:
            return
        fault.tripped = True
        raise faultlib.KernelLaunchError(
            f"injected dispatch failure at op {op_name!r} ({impl})")
    return hook
