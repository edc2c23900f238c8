"""Deterministic synthetic data pipeline with checkpointable state: the
port's own copy of the reference's `repro.data.pipeline` (numpy only, and
bit for bit the same batches).

Production shape without external deps: an infinite token stream generated
from a counter-based hash (stateless random access => any step is
reproducible), host-sharded by (host_id, n_hosts), double-buffered prefetch,
and a tiny state object (the step counter) that rides inside checkpoints so
restarts resume mid-epoch without replaying data. Batches are numpy arrays;
the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "PipelineState", "SyntheticLM", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int                  # GLOBAL batch
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    frontend: Optional[str] = None     # 'audio' | 'vision'
    frontend_len: int = 0
    d_model: int = 0


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(step=int(d["step"]))


def _hash_tokens(step: int, host: int, shape, vocab: int, seed: int,
                 salt: int = 0) -> np.ndarray:
    """Counter-based generator: splitmix64 over (seed, step, host, index)."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint64)
        x = (idx + np.uint64((seed * 0x9E3779B97F4A7C15) % 2**64)
             + np.uint64((step * 0xBF58476D1CE4E5B9) % 2**64)
             + np.uint64((host * 0x94D049BB133111EB) % 2**64)
             + np.uint64((salt * 0xD6E8FEB86659FD93) % 2**64))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return (x % np.uint64(vocab)).astype(np.int32).reshape(shape)


class SyntheticLM:
    """Iterator of host-local batches; labels are next-token shifted."""

    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None):
        if cfg.batch % cfg.n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.cfg = cfg
        self.state = state or PipelineState()
        self._local_batch = cfg.batch // cfg.n_hosts

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        shape = (self._local_batch, c.seq + 1)
        # learnable structure: 80% of transitions follow the successor rule
        # t[i+1] = t[i]+1 (mod V), 20% jump uniformly — a 1st-order Markov
        # stream whose optimal loss ~ 0.2*ln(V) + H(0.2), so training curves
        # actually descend (uniform i.i.d. tokens would pin loss at ln V).
        base = _hash_tokens(self.state.step, c.host_id, shape, c.vocab, c.seed)
        gate = _hash_tokens(self.state.step, c.host_id, shape, 5, c.seed,
                            salt=7)
        toks = np.empty(shape, np.int32)
        toks[:, 0] = base[:, 0]
        for i in range(1, shape[1]):
            follow = gate[:, i] > 0          # 4/5 of the time
            toks[:, i] = np.where(follow, (toks[:, i - 1] + 1) % c.vocab,
                                  base[:, i])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.frontend == "audio":
            batch["frames"] = _hash_tokens(
                self.state.step, c.host_id,
                (self._local_batch, c.frontend_len, c.d_model), 2048, c.seed,
                salt=1).astype(np.float32) / 1024.0 - 1.0
        elif c.frontend == "vision":
            batch["patch_embeds"] = _hash_tokens(
                self.state.step, c.host_id,
                (self._local_batch, c.frontend_len, c.d_model), 2048, c.seed,
                salt=2).astype(np.float32) / 1024.0 - 1.0
        self.state.step += 1
        return batch


class Prefetcher:
    """Background-thread prefetch (the double-buffered-SPM analogue at the
    input layer): keeps `depth` batches ready while the step runs."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err or StopIteration
        return item

    def close(self):
        self._stop.set()
