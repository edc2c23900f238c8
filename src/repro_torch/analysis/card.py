"""The kernel-body checks that need a card: each contract's `body` launches
the real entry point, and three instruments watch it.

* Redzones (KB400). While a body runs, `kernels.common.call_kernel` hands
  every tensor argument of every launch to `Redzones.hook`, which copies
  the operand into the middle of a larger buffer between two 64 KiB guard
  regions and launches on that copy. Every guard holds a NaN of the
  operand's type (the byte 0x7f for int8 codes, the bits of a float NaN
  for int32), so a read past an input carries a NaN into the output (NaN
  survives the kernels' fmaxf maxima and every split merge) and a write
  past any operand changes a guard. After the launch the copies go back to
  the wrapper's tensors; the guards must be unchanged and the output must
  equal the plain version's (NaN exactly where it has NaN; else KB402).
* Geometry (KB431). The body runs under `torch.profiler`; each kernel
  record's grid, block and shared memory (dynamic plus static, as the
  profiler reports it) must equal its contract's, in launch order. Now
  and then a session hands back a trace without some or all of the
  records of the work it saw launched (`scripts/profiler_sessions.py`
  counts such sessions on a card): a trace that holds fewer of a
  contract's kernel records than it declares is profiled again, at most
  PROFILE_ATTEMPTS sessions, and every run's redzones and outputs are
  checked. A grid, block, shared memory or extra launch that differs is
  a finding at once.
* compute-sanitizer (KB400, KB410). A subprocess runs the smallest
  contract case of each C entry point and kernel variant under
  `memcheck`, `synccheck`, `racecheck` and `initcheck`, with
  `PYTORCH_NO_CUDA_MEMORY_CACHING=1` so that every tensor is its own
  allocation. A tool that refuses the device is a KB433 warning carrying
  its own words, and the tools after it are not run (the same device).

`python -m repro_torch.analysis.card --bodies` is that subprocess: it
launches the sanitizer cases' bodies and exits.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..api.registry import KernelRegistry, LaunchContract
from ..kernels import common
from .findings import Report

__all__ = ["Redzones", "check_on_card", "run_body", "profiled_body",
           "profiled_launches", "geometry_drift", "card_cases",
           "sanitizer_cases", "run_sanitizers", "GUARD_BYTES",
           "SANITIZER_TOOLS"]

CHECKER = "kernel-body"
GUARD_BYTES = 64 * 1024
# the card checks launch cases whose operands (inputs and outputs) fit in
# this many bytes: the 32k-key cases are for the CPU's sweep alone
CARD_CASE_BYTES = 256 << 20
SANITIZER_TOOLS = ("memcheck", "synccheck", "racecheck", "initcheck")
SANITIZER_EXIT = 86
SANITIZER_TIMEOUT_S = 600
# profiler sessions of one body before missing kernel records are a finding
PROFILE_ATTEMPTS = 3

# the guard pattern of each dtype, little-endian: a NaN of floats, 0x7f
# bytes for integer codes
_PATTERN = {
    torch.float32: b"\x00\x00\xc0\x7f",
    torch.bfloat16: b"\xc0\x7f",
    torch.float16: b"\x00\x7e",
    torch.int32: b"\x00\x00\xc0\x7f",
    torch.int64: b"\x00\x00\x00\x00\x00\x00\xf8\x7f",
}


def _pattern(dtype: torch.dtype) -> bytes:
    return _PATTERN.get(dtype, b"\x7f")


class Redzones:
    """Guarded copies of every tensor argument of the launches made while
    it is installed (`with Redzones() as rz:`); `problems()` then lists
    each changed guard. `hook(name, args, launch)` works on tensors of any
    device (the tests drive it with a plain function on the CPU)."""

    def __init__(self, guard: int = GUARD_BYTES):
        self.guard = guard
        self.zones: List[tuple] = []
        self._prev = None

    def __enter__(self) -> "Redzones":
        self._prev = common.set_launch_hook(self.hook)
        return self

    def __exit__(self, *exc):
        common.set_launch_hook(self._prev)

    def hook(self, name: str, args, launch):
        guarded, back = [], []
        for i, a in enumerate(args):
            if not isinstance(a, torch.Tensor) or a.numel() == 0:
                guarded.append(a)
                continue
            # the operand's storage span (a strided q reads through it)
            n = 1 + sum((s - 1) * st for s, st in zip(a.shape, a.stride()))
            flat = torch.as_strided(a, (n,), (1,))
            nbytes = n * a.element_size()
            pat = _pattern(a.dtype)
            fill = torch.tensor(list(pat), dtype=torch.uint8,
                                device=a.device).repeat(self.guard // len(pat))
            buf = torch.empty(2 * self.guard + nbytes, dtype=torch.uint8,
                              device=a.device)
            buf[:self.guard] = fill
            buf[self.guard + nbytes:] = fill
            mid = buf[self.guard:self.guard + nbytes].view(a.dtype)
            mid.copy_(flat)
            guarded.append(torch.as_strided(mid, a.shape, a.stride()))
            back.append((flat, mid))
            self.zones.append((name, i, a.dtype, tuple(a.shape), buf, nbytes,
                               fill))
        launch(*guarded)
        for flat, mid in back:
            flat.copy_(mid)

    def problems(self) -> List[str]:
        """Every guard that changed, as a message (synchronizes)."""
        out = []
        for name, i, dtype, shape, buf, nbytes, fill in self.zones:
            for side, part in (("before", buf[:self.guard]),
                               ("after", buf[self.guard + nbytes:])):
                changed = (part != fill).nonzero()
                if changed.numel():
                    first = int(changed[0 if side == "after" else -1])
                    off = (first + 1 - self.guard if side == "before"
                           else first)
                    out.append(
                        f"{name} argument {i} ({dtype}, {shape}): "
                        f"{changed.numel()} byte(s) of the redzone {side} "
                        f"the operand changed (nearest at {off:+d} bytes "
                        f"from its {'start' if side == 'before' else 'end'})")
        return out


def _pairs(got, want):
    if isinstance(got, torch.Tensor):
        return [(got, want)]
    return [p for g, w in zip(got, want) for p in _pairs(g, w)]


def compare(got, want, tol: float) -> Tuple[Optional[str], Optional[str]]:
    """(KB400 message, KB402 message) of a body's outputs: NaN where the
    plain version has none (a read of a redzone), else values beyond
    tol x max(1, max |want|) (tol 0: bitwise)."""
    for i, (g, w) in enumerate(_pairs(got, want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape:
            return None, f"output {i}: shape {tuple(g.shape)} != plain " \
                         f"{tuple(w.shape)}"
        gn, wn = torch.isnan(g), torch.isnan(w)
        if not torch.equal(gn, wn):
            return (f"output {i}: {int((gn & ~wn).sum())} NaN where the "
                    f"plain version has a value, {int((wn & ~gn).sum())} "
                    f"the other way: the kernel read a redzone"), None
        fin = ~wn
        if not fin.any():
            continue
        scale = max(1.0, float(w[fin].abs().max()))
        err = float((g[fin] - w[fin]).abs().max())
        if err > tol * scale:
            return None, (f"output {i}: max |kernel - plain| {err:.3e} > "
                          f"{tol:g} x {scale:.3g}")
    return None, None


def profiled_launches(trace_events, kernels) -> List[dict]:
    """The kernel records of a chrome trace whose names are one of
    `kernels` (the `__global__` names), in launch order."""
    pat = re.compile(r"\b(%s)\s*[<(]" % "|".join(map(re.escape, kernels)))
    recs = [e for e in trace_events
            if e.get("cat") == "kernel" and pat.search(e.get("name", ""))]
    return sorted(recs, key=lambda e: e.get("ts", 0))


def geometry_drift(lc: LaunchContract, records) -> List[str]:
    """Each difference between the contract's launches and the profiler's
    records of them (grid, block, shared memory, count)."""
    if len(records) != len(lc.launches):
        return [f"{len(records)} kernel record(s) of "
                f"{[lch.kernel for lch in lc.launches]} profiled, the "
                f"contract declares {len(lc.launches)}"]
    out = []
    for lch, rec in zip(lc.launches, records):
        args = rec.get("args", {})
        want = {"grid": list(lch.grid) + [1] * (3 - len(lch.grid)),
                "block": [lch.threads, 1, 1],
                "shared memory": lch.smem_bytes + lch.static_smem}
        for key, value in want.items():
            if args.get(key) != value:
                out.append(f"{lch.kernel}: profiled {key} {args.get(key)} "
                           f"!= contract {value}")
    return out


def profiled_body(lc: LaunchContract):
    """One run of a contract's body inside redzones under a new profiler
    session: (redzones, outputs, plain outputs, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with Redzones() as rz:
            got, want = lc.body()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return rz, got, want, events


def run_body(lc: LaunchContract) -> List[Tuple[str, str]]:
    """Launch one contract's body inside redzones and under the profiler;
    the (code, message) of every problem seen."""
    torch.cuda.synchronize()
    kernels = {lch.kernel for lch in lc.launches}
    found = []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            rz, got, want, events = profiled_body(lc)
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            return [("KB431", f"body raised {type(e).__name__}: {e}")]
        found += [("KB400", m) for m in rz.problems()]
        oob, diff = compare(got, want, lc.tol)
        if oob:
            found.append(("KB400", oob))
        if diff:
            found.append(("KB402", diff))
        recs = profiled_launches(events, kernels)
        if len(recs) >= len(lc.launches):
            break
    drift = geometry_drift(lc, recs)
    if len(recs) < len(lc.launches):
        drift = [f"{m} (in each of {attempt} profiler sessions)"
                 for m in drift]
    found += [("KB431", m) for m in drift]
    return list(dict.fromkeys(found))


def _operand_bytes(lc: LaunchContract) -> int:
    seen = {}
    for lch in lc.launches:
        for b in lch.blocks:
            seen[b.name] = math.prod(b.array_shape) * b.dtype_bytes
    return sum(seen.values())


def card_cases(reg: Optional[KernelRegistry] = None,
               sweep_values: Optional[dict] = None):
    """(where, LaunchContract) of every contract case with a body whose
    operands fit in CARD_CASE_BYTES, once for each launch geometry: the
    tiles of a sweep that leave a case's launches as they are (the decode
    kernel's bkv) do not launch it again."""
    from .kernel_body import contract_cases
    seen = set()
    for op, impl, where, lc in contract_cases(reg, sweep_values):
        key = (op, impl, where.split(" {")[0], tuple(
            (lch.kernel, lch.grid, lch.threads, lch.smem_bytes)
            for lch in lc.launches))
        if (lc.body is None or key in seen
                or _operand_bytes(lc) > CARD_CASE_BYTES):
            continue
        seen.add(key)
        yield where, lc


def _variant(lc: LaunchContract) -> tuple:
    """What makes two cases reach different kernel instances: the entry
    point, the kernels, the operands' formats and widths."""
    return (lc.entry, tuple(lch.kernel for lch in lc.launches),
            tuple(sorted({(b.name, b.quant or "", b.dtype_bytes)
                          for lch in lc.launches for b in lch.blocks})))


def sanitizer_cases(reg: Optional[KernelRegistry] = None):
    """The smallest card case (fewest blocks) of each kernel variant."""
    best = {}
    for where, lc in card_cases(reg):
        blocks = sum(math.prod(lch.grid) for lch in lc.launches)
        key = _variant(lc)
        if key not in best or blocks < best[key][0]:
            best[key] = (blocks, where, lc)
    return [(where, lc) for _, where, lc in best.values()]


def _sanitizer() -> Optional[str]:
    try:
        path = Path(common._nvcc()).parent / "compute-sanitizer"
    except RuntimeError:
        return None
    return str(path) if path.exists() else None


def run_sanitizers(rep: Report, tools=SANITIZER_TOOLS) -> None:
    """The sanitizer subprocesses over `sanitizer_cases()`."""
    tool_path = _sanitizer()
    if tool_path is None:
        rep.add("KB433", "warning", CHECKER, "compute-sanitizer",
                "compute-sanitizer is not beside nvcc in this CUDA toolkit: "
                "the launches were checked by the redzones alone")
        return
    kernels = sorted({lch.kernel for _, lc in sanitizer_cases()
                      for lch in lc.launches})
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in os.environ.get("PYTHONPATH", "")
                            .split(os.pathsep) if p]))
    for tool in tools:
        cmd = [tool_path, "--tool", tool, "--error-exitcode",
               str(SANITIZER_EXIT), "--kernel-name",
               f"regex={'|'.join(kernels)}",
               sys.executable, "-m", "repro_torch.analysis.card", "--bodies"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                               timeout=SANITIZER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rep.add("KB433", "warning", CHECKER, f"compute-sanitizer {tool}",
                    f"timed out after {SANITIZER_TIMEOUT_S} s")
            continue
        lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                 if ln.startswith("=========")]
        refused = [ln for ln in lines if "not supported" in ln.lower()]
        if refused:
            rest = tools[tools.index(tool) + 1:]
            rep.add("KB433", "warning", CHECKER, f"compute-sanitizer {tool}",
                    f"the tool refused the device: "
                    f"{refused[0].strip('= ').strip()!r}; not run: "
                    f"{', '.join(rest) or 'none'} (the same device); the "
                    f"launches were checked by the redzones alone")
            return
        if r.returncode == 0:
            continue
        errors = [ln.strip("= ").strip() for ln in lines
                  if re.search(r"(Invalid|Race|Error|Uninitialized|Barrier|"
                               r"hazard)", ln)][:4]
        summary = [ln.strip("= ").strip() for ln in lines
                   if "SUMMARY" in ln][-1:]
        said = " | ".join(errors + summary) or (r.stdout + r.stderr)[-500:]
        code = "KB410" if tool == "racecheck" else "KB400"
        rep.add(code, "error", CHECKER, f"compute-sanitizer {tool}",
                f"exit {r.returncode}: {said}")


def check_on_card(reg: Optional[KernelRegistry] = None,
                  sweep_values: Optional[dict] = None,
                  report: Optional[Report] = None) -> Report:
    """Every card case's body under redzones and the profiler, then the
    compute-sanitizer subprocesses."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel-body card checks need a CUDA card; "
                           "none is visible")
    rep = report if report is not None else Report()
    common.build_kernels()
    for where, lc in card_cases(reg, sweep_values):
        for code, msg in run_body(lc):
            rep.add(code, "error", CHECKER, where, msg)
    run_sanitizers(rep)
    return rep


def _run_bodies() -> int:
    cases = sanitizer_cases()
    for _, lc in cases:
        lc.body()
    torch.cuda.synchronize()
    print(f"launched {len(cases)} sanitizer case(s)")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--bodies"]:
        sys.exit("usage: python -m repro_torch.analysis.card --bodies")
    sys.exit(_run_bodies())
