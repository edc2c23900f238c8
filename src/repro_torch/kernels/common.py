"""Shared helpers for the kernel layer: the CUDA kernel build and launch check.

Each `csrc/<name>.cu` source is compiled by nvcc, at first use, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<hash>/lib<name>.so

The libraries land under `build/kernels/<hash>/` at the repository root,
keyed by a hash of every source and header, so an edited source rebuilds
and an unchanged one is reused. `build_kernels()` starts one nvcc per
source, all at once, and keeps each build's `-Xptxas -v` report (registers,
shared memory, spills) in `BUILD_REPORTS`.

Every C entry point returns the `cudaError_t` of its launch
(`cudaGetLastError()` right after it, so a refused launch is seen: it never
runs and a later synchronize does not report it); `check_launch` is the one
place that turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["build_kernels", "load_kernel", "check_launch", "CSRC",
           "BUILD_ROOT", "BUILD_REPORTS", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one library per kernel source; headers are shared by all of them
SOURCES = ("flash_decode", "flash_prefill")

BUILD_REPORTS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the CUDA "
                       "kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> Dict[str, Path]:
    """Compile every kernel source that is not built yet, one nvcc process
    per source, all started together. Returns {name: library path}; raises
    with the compiler's output if any build fails."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / f"lib{n}.so" for n in SOURCES}
    procs = {}
    for name, lib in paths.items():
        report = lib.with_suffix(".ptxas.txt")
        if lib.exists() and report.exists():
            BUILD_REPORTS[name] = report.read_text()
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, report)
    failed = []
    for name, (proc, tmp, lib, report) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        report.write_text(log)
        os.replace(tmp, lib)          # atomic: a reader never sees half a file
        BUILD_REPORTS[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_kernels()[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a kernel entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
