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

Each launch is ONE step program: `decode_step` plus a fused per-row
numeric-health reduction (all logits finite). The gather of each row's last
valid position and the argmax run on the device; only (slots,) int32
tokens and (slots,) health flags come back to the host, in one transfer, at
launches whose tokens are consumed. A non-finite row raises: quarantine and
replay are a later slice (ROADMAP A6), and there is no fallback route — a
kernel failure raises too.

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

Attention dispatches under the engine's ExecutionPolicy:
`decode_route()` / `prefill_route()` report the impls ("cuda-decode" /
"cuda-prefill" on the default policy). With `weight_format=` the Linear
weights are resident codes and every covered Linear runs the quantizer and
the AIO GEMM kernels (`weight_route()`: "resident-<fmt>"). The caches are
updated in place (the JAX engine donates them instead). Host swap and
preemption, fault injection, deadlines and snapshots are later slices.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .. import api
from ..models import transformer as T

__all__ = ["Request", "ServingEngine", "EngineStats", "PAD"]

PAD = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # (L,) integer token ids
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False
    status: str = "new"               # queued | active | done | REJECTED


@dataclasses.dataclass
class EngineStats:
    """Model-invocation accounting."""
    prefill_chunk_calls: int = 0      # chunk-shaped batched prefill launches
    prefill_tokens: int = 0           # valid prompt tokens prefilled
    decode_steps: int = 0             # batch decode launches
    generated_tokens: int = 0
    rejected_submits: int = 0         # submits refused by the bounded queue

    @property
    def model_calls(self) -> int:
        return self.prefill_chunk_calls + self.decode_steps


class ServingEngine:
    """Continuous per-slot batching over `slots` preallocated cache rows."""

    def __init__(self, cfg: T.ModelConfig, model: T.Transformer, *,
                 slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None,
                 policy: Optional[api.ExecutionPolicy] = None,
                 weight_format: Optional[str] = None,
                 prefill_chunk: int = 32,
                 max_queue: Optional[int] = None,
                 paged: bool = False,
                 block_size: int = 16,
                 pool_blocks: Optional[int] = None):
        """model: the Transformer to serve; the engine runs on the device
        its weights live on (`init_params` puts them on the card unless
        asked for the CPU).

        policy: the ExecutionPolicy every op of the engine dispatches
        under; one engine = one policy.

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

        max_queue: bound on the admission queue; beyond it `submit()`
        REJECTS (returns False) instead of queueing. None = unbounded.

        paged / block_size / pool_blocks: block-pool KV residency. Every KV
        cache layer becomes a pool of `pool_blocks` blocks of `block_size`
        positions (default: slots x max_len / block_size, the token
        capacity of the per-slot stripes) plus a (slots, max_len /
        block_size) block table the host allocator owns. block_size must
        divide max_len; any size works for the kernels (they resolve each
        key's block, so it need not match their tiles)."""
        if weight_format not in (None, "none"):
            model = T.resident_view(model, weight_format)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk ({prefill_chunk}) must be >= 1")
        self._paged = bool(paged)
        if self._paged:
            self._pg_init(slots, max_len, block_size, pool_blocks)
        self.cfg = cfg
        self.model = model
        self.device = model.embed.table.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.policy = policy
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.stats = EngineStats()
        self.caches = T.init_caches(
            cfg, slots, max_len, device=self.device,
            paged=(self._pg_pool, self._pg_bs) if self._paged else None)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._last = np.zeros((slots, 1), np.int32)
        self._remaining = np.zeros(slots, np.int64)
        self._prefilling = np.zeros(slots, bool)
        self._prefill_off = np.zeros(slots, np.int64)
        self._step_no = 0

    # ------------------------------------------------------------ launches
    def _policy_ctx(self):
        return api.policy(self.policy) if self.policy is not None \
            else contextlib.nullcontext()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step_program(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """The ONE step program: decode_step plus the fused numeric-health
        reduction — a (slots,) bool, True where every logit of the row is
        finite. The caches are updated in place."""
        with self._policy_ctx():
            logits, _ = T.decode_step(self.model, self.caches, tokens,
                                      lengths=lengths)
        health = torch.isfinite(logits).flatten(1).all(1)
        return logits, health

    def _greedy(self, rows: torch.Tensor, health: torch.Tensor):
        """Argmax of (slots, V) logits on the device; one transfer brings
        back the (slots,) tokens and health flags."""
        tok = rows.argmax(-1)
        both = torch.stack([tok, health.to(tok.dtype)]).cpu().numpy()
        return both[0].astype(np.int32), both[1].astype(bool)

    def _check_health(self, ok: np.ndarray):
        bad = np.flatnonzero(self._occupied() & ~ok)
        if bad.size:
            raise RuntimeError(
                f"non-finite logits in slots {bad.tolist()} at step "
                f"{self._step_no}; quarantine and replay are not ported yet "
                "(ROADMAP A6)")

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> bool:
        """Queue a request; True if admitted to the queue.

        Malformed requests raise at once: empty or non-1-D prompts and
        non-integer prompt dtypes, non-int or negative max_new_tokens (0 is
        legal: emit nothing), and requests whose prompt + budget can never
        fit the cache rows. With `max_queue` set, a full queue REJECTS the
        request: status "REJECTED", returns False, nothing is queued."""
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
        self.queue.append(req)
        return True

    def _finish(self, slot: int):
        req = self._slot_req[slot]
        req.done = True
        req.status = "done"
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
        whose reservation cannot be met even after LRU prefix eviction is
        DEFERRED at the queue head and admission stops for the step."""
        admitted = []
        new_pos = np.zeros(self.slots, np.int32)
        cow: List[tuple] = []
        deferred = False
        for s in range(self.slots):
            if deferred:
                break
            while self._slot_req[s] is None and self.queue:
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
            else:
                T.reset_slots(self.caches, self._tensor(mask))

    # ------------------------------------------------------ paged block pool
    def _pg_init(self, slots: int, max_len: int, block_size: int,
                 pool_blocks: Optional[int]):
        """The allocator's state: free list, refcounts, rows' blocks, the
        host copy of the block table, the prefix registry, counters."""
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
        None when the pool cannot hold the reservation even after
        eviction."""
        bs = self._pg_bs
        prompt = np.asarray(req.prompt)
        plen = int(prompt.shape[0])
        total = min(-(-(plen + int(req.max_new_tokens)) // bs),
                    self._pg_nblk)
        ent, covered = self._pg_lookup(prompt)
        shared_full = covered // bs
        fresh_needed = total - shared_full
        if len(self._pg_free) < fresh_needed:
            self._pg_evict(fresh_needed, protect=ent)
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
        # table entries past the reservation repeat the row's first block:
        # a block the row owns (nothing reads or writes them: the row's
        # frontier stays inside its reservation)
        row = np.full(self._pg_nblk, blocks[0], np.int32)
        row[:len(blocks)] = blocks
        self._pg_table[slot] = row
        self._pg_admits += 1
        return covered, pairs

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

    def pool_stats(self) -> dict:
        """Block-pool occupancy and prefix-sharing counters; {"paged":
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
        }

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
        lengths == 0 and keep their caches untouched."""
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
        logits, health = self._step_program(self._tensor(toks),
                                            self._tensor(lens))
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
        self._check_health(ok)
        for s in finishing:
            self._prefilling[s] = False
            if self._paged:
                # the prompt's K/V is resident now: register the prefix
                # before the finish check, so even a one-token request
                # donates its prompt
                self._pg_register(s)
            self._emit(s, int(first[s]), newly)

    def _decode_launch(self, newly: List[Request]):
        """ONE batched decode launch for every mid-generation slot;
        prefilling and free rows pass lengths == 0 and sit it out."""
        active = np.asarray([r is not None and not self._prefilling[s]
                             for s, r in enumerate(self._slot_req)])
        if not active.any():
            return
        logits, health = self._step_program(
            self._tensor(self._last), self._tensor(active.astype(np.int32)))
        self.stats.decode_steps += 1
        nxt, ok = self._greedy(logits[:, -1], health)
        self._check_health(ok)
        for s in np.flatnonzero(active):
            self._emit(int(s), int(nxt[s]), newly)

    # --------------------------------------------------------------- driving
    def step(self) -> List[Request]:
        """Admit into free slots, then advance every in-flight request once:
        one chunk-prefill launch for admitting rows (when any), then one
        batched decode launch for generating rows (when any). Returns the
        requests that finished during this step."""
        newly: List[Request] = []
        self._admit(newly)
        if self._prefilling.any():
            self._prefill_chunk_step(newly)
        self._decode_launch(newly)
        self._step_no += 1
        return newly

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slot_req)

    def run_until_drained(self, max_steps: int = 100000) -> List[Request]:
        for _ in range(max_steps):
            if not self.pending():
                return self.finished
            self.step()
        if self.pending():
            raise RuntimeError(
                f"engine not drained after {max_steps} steps; occupancy "
                f"{self.occupancy()!r}, queue depth {len(self.queue)}")
        return self.finished

    def warmup(self) -> "ServingEngine":
        """Build the kernels and make one idle launch of each width (the
        chunk and 1) with every row at lengths == 0 — a bitwise no-op on
        the caches — so the first request pays no build or first-launch
        cost. Returns self."""
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        for w in (self.prefill_chunk, 1):
            tok = torch.zeros((self.slots, w), dtype=torch.int32,
                              device=self.device)
            self._step_program(tok, zeros)
        return self

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
        """Attention impl the engine's admission chunks dispatch to:
        "cuda-prefill" (varlen flash-prefill kernel; any chunk > 1),
        "cuda-decode" (chunk == 1), or "ref"."""
        with self._policy_ctx():
            return api.ops.attention_route(
                lq=self.prefill_chunk, lk=self.max_len, causal=True,
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
