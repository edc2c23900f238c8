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

Attention dispatches under the engine's ExecutionPolicy:
`decode_route()` / `prefill_route()` report the impls ("cuda-decode" /
"cuda-prefill" on the default policy). With `weight_format=` the Linear
weights are resident codes and every covered Linear runs the quantizer and
the AIO GEMM kernels (`weight_route()`: "resident-<fmt>"). The caches are
updated in place (the JAX engine donates them instead). Paging, swap,
fault injection, deadlines and snapshots are later slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Deque, List, Optional

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
                 max_queue: Optional[int] = None):
        """model: the Transformer to serve; the engine runs on the device
        its weights live on (`init_params` puts them on the card unless
        asked for the CPU).

        policy: the ExecutionPolicy every op of the engine dispatches
        under; one engine = one policy.

        weight_format: make the Linear weights RESIDENT in this AIO format
        (int4/int8/fp8a/fp8b): `quantize_params` converts `model` IN PLACE
        (its dense Linear weights are freed; other engines sharing the
        model see the codes too) and every covered Linear dispatches
        through `api.ops.matmul_codes`. Other format names (incl. "bf16")
        raise: they are not residency formats. A model that is already
        resident is served in its own format.

        prefill_chunk: tokens a new prompt advances per admission launch
        (clamped to max_len). Greedy outputs are identical for any chunk.

        max_queue: bound on the admission queue; beyond it `submit()`
        REJECTS (returns False) instead of queueing. None = unbounded."""
        if weight_format not in (None, "none"):
            T.quantize_params(model, weight_format)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk ({prefill_chunk}) must be >= 1")
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
        self.caches = T.init_caches(cfg, slots, max_len, device=self.device)
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

    def _admit(self, newly: List[Request]):
        """Assign queued requests to free slots and rewind their cache rows.
        No model call happens here: the prompts advance chunk by chunk in
        the following steps, interleaved with everyone else's decode."""
        admitted = []
        for s in range(self.slots):
            while self._slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                if req.max_new_tokens == 0:
                    # emit nothing, without spending a prefill launch
                    req.done = True
                    req.status = "done"
                    self.finished.append(req)
                    newly.append(req)
                    continue
                req.status = "active"
                self._slot_req[s] = req
                self._prefilling[s] = True
                self._prefill_off[s] = 0
                self._remaining[s] = req.max_new_tokens
                admitted.append(s)
        if admitted:
            mask = np.zeros(self.slots, bool)
            mask[admitted] = True
            T.reset_slots(self.caches, self._tensor(mask))

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
