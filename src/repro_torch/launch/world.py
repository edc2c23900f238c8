"""Start a world of ranks on this host and collect what each returns.

    results = spawn_world(4, "my_module:rank_main", args=(...,))

starts 4 Python processes; rank r imports `my_module` (from `sys_path`
and the usual path) and calls ``rank_main(r, 4, init_method, *args)``,
`init_method` a `file://` rendezvous in a private temporary directory (no
port is opened). Each rank's return value comes back through `torch.save`
(so tensors, numpy arrays and plain data), in rank order. The ranks'
output goes to a log file each; a rank that fails (or a world that
outlives `timeout`) raises, with the tail of every failed rank's log, and
every process is stopped before this returns or raises. `rank_main`
starts its own process group (`launch.mesh.init_world(init_method=...,
rank=, world_size=)`) and ends it.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence

import torch

__all__ = ["spawn_world", "WorldFailed"]


class WorldFailed(RuntimeError):
    """A rank of a spawned world failed or the world timed out."""


def spawn_world(n: int, target: str, *, args: Sequence = (),
                sys_path: Sequence[str] = (), timeout: float = 300.0
                ) -> List:
    """Run `target` ("module:function") on n ranks, one torch thread
    each; returns their results. `args` must be literals (their repr is
    the rank's source)."""
    mod, fn = target.split(":")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    paths = [os.path.abspath(p) for p in sys_path]
    procs, logs = [], []
    child_env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        for r in range(n):
            res = os.path.join(tmp, f"rank{r}.pt")
            code = (f"import sys, importlib, torch; sys.path[:0] = {paths!r}; "
                    f"torch.set_num_threads(1); "
                    f"out = getattr(importlib.import_module({mod!r}), "
                    f"{fn!r})({r}, {n}, {init!r}, *{tuple(args)!r}); "
                    f"torch.save(out, {res!r})")
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-u", "-c", code],
                                          stdout=log, stderr=subprocess.STDOUT,
                                          env=child_env))
        deadline = time.monotonic() + timeout
        timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break                   # a failed rank: stop the others
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()

        def tail(r):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                return f.read()[-4000:]
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if timed_out or bad:
            first = [r for r in bad if procs[r].returncode > 0] or bad
            what = "timed out" if timed_out else "failed"
            raise WorldFailed(
                f"world of {n} ({target}) {what}; rank(s) {bad} exit codes "
                f"{[procs[r].returncode for r in bad]}:\n" + "\n".join(
                    f"--- rank {r}:\n{tail(r)}" for r in first[:2]))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
