"""Atomic checkpoints of tensor trees.

Layout (one directory per step):
    ckpt_dir/step_000120/
        manifest.json      step, flat-key index, dtypes, shapes, extra state
        host0000.npz       every leaf, as a numpy array

Saved over a mesh of several ranks (`mesh=`; every rank of it calls
`save` with its own tree, e.g. its head shards of the caches), each rank
writes its tree under a directory of its own, and one manifest holds the
mesh and the shared extra state:
    ckpt_dir/step_000120/
        manifest.json      step, mesh shape, axis names, world ranks, extra
        rank-0000/         the rank at mesh index 0 (row-major over the
            manifest.json  mesh's axes): its flat-key index, dtypes,
            host0000.npz   shapes and its own extra state; its leaves
        rank-0001/ ...
`restore` with the same `mesh` loads this rank's tree and hands its own
extra state back under the extra key "rank"; a checkpoint of another mesh
shape or axis names (or one saved without a mesh, or the reverse) and a
missing rank directory raise ValueError on every rank alike.

A tree is nested dicts, lists, tuples and dataclasses (the engine's
per-layer caches) of torch tensors or numpy arrays; a leaf's key is its
path joined by "/". numpy has no bfloat16, so a bf16 leaf is saved as its
16-bit pattern (int16) and the manifest keeps its dtype. Writes are atomic
(a temp directory, then a rename), so a crash mid-save never leaves a
partial step that `latest_step` would pick. A mirror of the reference's
`repro.checkpoint.store` for one host.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dist.collectives import barrier
from ..serving.swap import from_host, to_host

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer", "gc_old"]

_MANIFEST = "manifest.json"
_DATA = "host0000.npz"


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in kids:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """`tree`'s structure with each leaf replaced by leaves[key]."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else leaves[prefix]
    new = {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
           for k, v in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


def _host(leaf) -> Tuple[str, np.ndarray]:
    if isinstance(leaf, torch.Tensor):
        return to_host(leaf)
    a = np.asarray(leaf)
    return str(a.dtype), a


def _write_tree(d: Path, tree, head: Dict) -> None:
    """Write `tree`'s leaves as d/host0000.npz and its index beside
    `head` as d/manifest.json."""
    arrays, dtypes, shapes = {}, {}, {}
    for key, leaf in _flatten(tree):
        tag, a = _host(leaf)
        arrays[key], dtypes[key], shapes[key] = a, tag, list(a.shape)
    np.savez(d / _DATA, **arrays)
    manifest = {**head, "keys": list(arrays), "dtypes": dtypes,
                "shapes": shapes}
    (d / _MANIFEST).write_text(json.dumps(manifest, indent=2))


def _ranks(mesh) -> int:
    return 1 if mesh is None else int(mesh.size())


def _mesh_index(mesh) -> int:
    """This rank's index in the mesh, row-major over its axes."""
    r = 0
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        r = r * int(n) + int(mesh.get_local_rank(name))
    return r


def _rank_dir(r: int) -> str:
    return f"rank-{r:04d}"


def _mesh_record(mesh) -> Dict:
    return {"shape": [int(n) for n in mesh.shape],
            "names": list(mesh.mesh_dim_names),
            "ranks": [int(r) for r in mesh.mesh.reshape(-1).tolist()]}


def save(ckpt_dir, step: int, tree, extra: Optional[Dict] = None, *,
         mesh=None, rank_extra: Optional[Dict] = None) -> Path:
    """Write one checkpoint step atomically; returns its directory.

    With `mesh` of several ranks every rank of it calls this with its own
    `tree` (and its own JSON `rank_extra`); `extra` must be the same on
    all of them (the lead's copy is written). The ranks write into one
    temporary directory, wait for each other (`dist.collectives.barrier`),
    and the mesh's lead renames it; every rank returns once the step is
    in place."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    if _ranks(mesh) == 1:
        tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        _write_tree(tmp, tree, {"step": step, "extra": extra or {},
                                "time": time.time()})
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return final
    lead = _mesh_index(mesh) == 0
    tmp = ckpt_dir / f".tmp_step_{step:08d}_mesh"
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    barrier(mesh)
    mine = tmp / _rank_dir(_mesh_index(mesh))
    mine.mkdir()
    _write_tree(mine, tree, {"step": step, "extra": rank_extra or {}})
    barrier(mesh)
    if lead:
        manifest = {"step": step, "mesh": _mesh_record(mesh),
                    "extra": extra or {}, "time": time.time()}
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    barrier(mesh)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and (d / _MANIFEST).exists()]
    return max(steps) if steps else None


def _load_tree(d: Path, tree_like):
    """`tree_like`'s structure filled from directory d's leaves; returns
    (tree, d's manifest)."""
    manifest = json.loads((d / _MANIFEST).read_text())
    leaves = {}
    with np.load(d / _DATA) as data:
        for key, like in _flatten(tree_like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = from_host(manifest["dtypes"][key], data[key])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(t.shape)} != restore template "
                                 f"{tuple(like.shape)}")
            if isinstance(like, torch.Tensor):
                t = t.to(like.dtype)
            leaves[key] = t
    return _rebuild(tree_like, leaves), manifest


def _describe(rec: Optional[Dict]) -> str:
    if rec is None:
        return "one rank (no mesh)"
    dims = ", ".join(f"{n}={s}" for n, s in zip(rec["names"], rec["shape"]))
    return f"mesh ({dims})"


def restore(ckpt_dir, tree_like, step: Optional[int] = None, *,
            mesh=None):
    """Load a checkpoint into the structure of `tree_like` (a shape and
    dtype template; the latest step unless `step`). Returns (tree of CPU
    tensors, extra state, step). A leaf the checkpoint lacks raises
    KeyError, one of another shape ValueError.

    With `mesh` of several ranks the checkpoint must have been saved over
    a mesh of the same shape and axis names, with every rank's directory
    in place (ValueError otherwise, before any leaf is read); this rank's
    tree is loaded and its own extra state returned under extra["rank"].
    A checkpoint saved over a mesh does not load without one."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    saved = manifest.get("mesh")
    want = _mesh_record(mesh) if _ranks(mesh) > 1 else None
    if (saved is None) != (want is None) or (
            saved is not None and (saved["shape"], saved["names"])
            != (want["shape"], want["names"])):
        raise ValueError(f"checkpoint {d.name} was saved on "
                         f"{_describe(saved)}; it restores onto the same "
                         f"shape only, not onto {_describe(want)}")
    if saved is None:
        tree, _ = _load_tree(d, tree_like)
        return tree, manifest.get("extra", {}), step
    missing = [r for r in range(_ranks(mesh))
               if not (d / _rank_dir(r) / _MANIFEST).exists()]
    if missing:
        raise ValueError(f"checkpoint {d.name} lacks the shards of mesh "
                         f"index(es) {missing}")
    tree, mine = _load_tree(d / _rank_dir(_mesh_index(mesh)), tree_like)
    return tree, {**manifest.get("extra", {}), "rank": mine["extra"]}, step


def gc_old(ckpt_dir, keep: int = 3):
    """Delete all but the newest `keep` complete checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(
        int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
        if d.name.startswith("step_") and (d / _MANIFEST).exists())
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


class AsyncCheckpointer:
    """Saves on a worker thread; `wait()` joins the write in flight (call
    it before exit, and it raises the worker's error)."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        # copy to host memory now (cheap beside the disk write), so the
        # caller may go on updating its tensors
        snap = {}
        for k, v in _flatten(tree):
            tag, a = _host(v)
            snap[k] = from_host(tag, a.copy())
        host_tree = _rebuild(tree, snap)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                gc_old(self.ckpt_dir, self.keep)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self.wait()
        with self._lock:
            self._inflight = threading.Thread(target=work, daemon=True)
            self._inflight.start()

    def wait(self):
        with self._lock:
            t = self._inflight
        if t is not None:
            t.join()
        if self.last_error is not None:
            raise self.last_error
