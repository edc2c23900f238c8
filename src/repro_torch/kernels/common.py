"""Shared helpers for the kernel layer: the CUDA kernel build, the launch
of a kernel's C entry point, the tiling helpers of the ops (`ceil_div`,
`pad_to`), and the fp code helpers the kernels' plain versions share.

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
runs and a later synchronize does not report it); `call_kernel` launches an
entry point on the current stream and `check_launch` is the one place that
turns a non-zero code into an exception.

The kernels are forward-only: a ctypes launch records nothing for autograd,
so its output would carry no gradient back to its inputs. `call_kernel`
takes the tensors of a launch as tensors and refuses, under grad mode, any
that requires grad (`refuse_grad`), so no kernel drops a gradient silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from ..core.formats import _ldexp

__all__ = ["build_kernels", "load_kernel", "check_launch", "call_kernel",
           "refuse_grad", "check_cuda", "tile_counters", "ceil_div", "pad_to",
           "set_launch_hook",
           "decode_fp_code", "encode_fp_code", "CSRC", "BUILD_ROOT",
           "BUILD_REPORTS", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one library per kernel source; headers are shared by all of them
SOURCES = ("flash_decode", "flash_prefill", "flash_full", "aio_matmul",
           "aio_quant", "grouped_matmul", "depthwise")

BUILD_REPORTS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# `hook(name, args, launch)`, called by `call_kernel` in place of the launch
# when set: it may hand `launch` other tensors (the analysis' redzones do)
_launch_hook: Optional[Callable] = None
_COUNTERS: Dict[tuple, torch.Tensor] = {}
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


def refuse_grad(name: str, tensors: Sequence) -> None:
    """Raise a RuntimeError naming kernel entry point `name` when grad mode
    is on and one of `tensors` requires grad: the launch would record no
    backward, and the gradient of that input would be silently lost."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the CUDA kernel is "
            "forward-only (it records no backward); differentiate through "
            "the plain route (backend='ref') or call it under "
            "torch.no_grad()")


def call_kernel(name: str, argtypes: Sequence, *args,
                source: Optional[str] = None) -> None:
    """Launch C entry point `name` of the library of kernel source `source`
    (default: `name`) on the current stream (appended as the last argument)
    and raise on a non-zero cudaError_t. `argtypes` are the ctypes of
    `args`, the stream excluded; a tensor argument is passed as its data
    pointer, after `refuse_grad` has seen every tensor of the launch."""
    refuse_grad(name, args)

    def launch(*args):
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        lib = load_kernel(source or name)
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(lib, name, fn(*ptrs, stream))

    if _launch_hook is None:
        launch(*args)
    else:
        _launch_hook(name, args, launch)


def set_launch_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install (or clear, with None) the launch hook: `call_kernel` then
    calls ``hook(name, args, launch)`` instead of launching, and the hook
    launches with ``launch(*args)``, the same arguments or others in their
    place. Returns the hook it replaces."""
    global _launch_hook
    prev = _launch_hook
    _launch_hook = hook
    return prev


def check_cuda(name: str, t: torch.Tensor, *, contiguous: bool = True):
    """Raise unless `t` is a CUDA tensor, contiguous (unless told
    otherwise) and 16-byte aligned, as the kernels read it."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """n zeroed int32 tile counters for a split-K launch (`csrc/splitk.cuh`)
    on `device`'s current stream, where `call_kernel` launches it: the
    first n of a buffer kept per (device, stream). A launch leaves its
    counters zeroed, so one buffer serves every launch on that stream in
    turn, and launches on two streams never share counters."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf[:n]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    """Zero-pad `axis` of x up to a multiple of `multiple` (x itself when it
    is one already)."""
    size = x.shape[axis]
    pad = ceil_div(size, multiple) * multiple - size
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


# ---------------------------------------------------------------------------
# fp code helpers of the kernels (plain tensor functions). The reference's
# in-kernel versions scale by exp2, which XLA's CPU backend computes
# inexactly; these scale by exact powers of two and give the codes and
# values of `formats.encode` / `decode`.
# ---------------------------------------------------------------------------

def decode_fp_code(code: torch.Tensor, ebits: int, mbits: int,
                   bias: int) -> torch.Tensor:
    """fp bit code [sign | e | m] (no specials) -> float32 value."""
    code = code.to(torch.int32)
    m = code & ((1 << mbits) - 1)
    e = (code >> mbits) & ((1 << ebits) - 1)
    s = (code >> (ebits + mbits)) & 1
    normal = e > 0
    sig = torch.where(normal, (1 << mbits) + m, m).to(torch.float32)
    val = _ldexp(sig, torch.where(normal, e, 1) - bias - mbits)
    return torch.where(s == 1, -val, val)


def encode_fp_code(x: torch.Tensor, ebits: int, mbits: int,
                   bias: int) -> torch.Tensor:
    """Round-to-nearest-even float32 -> fp bit code (saturating at the
    format's largest finite value; no specials). Equals
    `formats.encode(x, fmt)` for the fp8 formats."""
    x = x.to(torch.float32)
    a = x.abs()
    sgn = torch.signbit(x).to(torch.int32)
    emin = 1 - bias
    emax = (1 << ebits) - 1 - bias
    max_finite = (2.0 - 2.0 ** (-mbits)) * 2.0 ** emax
    _, e2 = torch.frexp(a.clamp_min(2.0 ** (emin - mbits)))
    step = (e2 - 1).clamp(min=emin) - mbits
    q = _ldexp(torch.round(_ldexp(a, -step)), step).clamp(max=max_finite)
    # re-derive the exponent after rounding (it may cross a binade)
    _, e2q = torch.frexp(q.clamp_min(2.0 ** (emin - mbits)))
    ebq = (e2q - 1).clamp(min=emin)
    is_normal = q >= 2.0 ** emin
    e_code = torch.where(is_normal, ebq + bias, 0).to(torch.int32)
    m_norm = torch.round(_ldexp(q, -(ebq - mbits))) - (1 << mbits)
    m_sub = torch.round(_ldexp(q, -(emin - mbits)))
    m_code = torch.where(is_normal, m_norm, m_sub).to(torch.int32)
    sign_bit = sgn << (ebits + mbits)
    code = sign_bit | (e_code << mbits) | m_code
    return torch.where(a == 0, sign_bit, code)
