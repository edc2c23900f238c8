"""Hot-loop auditor: the serving engine's step program, inspected.

The engine's whole life is one step program (`ServingEngine._step_program`)
run at two token widths; a host sync, a rebound cache buffer, or a
materialized dequant inside it taxes EVERY decoded token, and every one of
them stands in the way of capturing the step in a CUDA graph. This checker
runs the step once at each lifetime width with every row idle, recording
its ATen ops (`StepRecorder`, a TorchDispatchMode, inside
`engine.step_trace`: the port's
counterpart of the reference's jaxpr), and audits them:

  HL201  a host-syncing op in the step: `_local_scalar_dense`, `nonzero`,
         `is_nonzero`, `equal`, a device-to-host copy or a host-to-device
         copy; on a card also every synchronizing CUDA call the step makes
         under `torch.cuda.set_sync_debug_mode`             (error)
  HL202  a cache field whose storage changes across one step (a rebound
         buffer: a captured step would read a stale address)  (error)
  HL203  an int8/uint8 -> f32 upcast of >= 65,536 elements at step level
         (a materialized dequant)                            (warning)
  HL204  the widths the step has run at != `step_widths()`   (error)
  HL205  the (slots,) bool health output of `isfinite` + `all` is missing
         from the step                                       (error)
  HL206  a rank >= 4 tensor copied to the host inside the step (cache
         bytes leaving the hot loop; swap belongs at the scheduler
         boundary)                                           (error)

Ops that run inside a kernel impl (tagged with its registry key) stand for
the kernel and are not counted by HL203: on the CPU the kernel wrappers run
their plain versions, which dequantize whole caches by design. A dispatch
mode sees ATen ops only: on CPU tensors a host transfer makes no ATen call
(`.numpy()`, `.tolist()`), so HL201 and HL206 are decided on a card.

The sync-debug mode is "warn" while the step runs (restored in a
`finally`), with the warnings recorded: "error" would stop the step at its
first sync and hide the rest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import traceback
import warnings
from typing import Dict, Iterable, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..api.registry import registry
from .findings import Report

__all__ = ["check_hot_loop", "check_engine", "StepRecorder",
           "audit_step_ops",
           "audit_rebinding", "audit_trace_count", "audit_health_guard",
           "audit_swap_hygiene", "sync_points", "SYNC_OPS", "SYNC_WARNING",
           "CODES"]

CHECKER = "hot-loop"

CODES = {
    "HL201": ("error", "host-syncing op / transfer in the step"),
    "HL202": ("error", "cache buffer rebound across one step"),
    "HL203": ("warning", "large quantized->f32 upcast (materialized "
                         "dequant)"),
    "HL204": ("error", "step widths launched != the engine's width "
                       "invariant"),
    "HL205": ("error", "numeric-health guard missing from the step"),
    "HL206": ("error", "rank >= 4 tensor copied to the host inside the "
                       "step — swap transfers belong at the scheduler "
                       "boundary"),
}

# what the sync-debug mode says at a synchronizing call (and not in its
# one-time notice that the mode "does not yet detect all synchronizing
# operations", raised by the first switch to "warn" in a process)
SYNC_WARNING = "called a synchronizing CUDA operation"
# ATen ops that wait for the device (or read a value to the host)
SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::nonzero",
                      "aten::is_nonzero", "aten::equal"})
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_", "aten::to"})
UPCAST_ELEMENT_THRESHOLD = 1 << 16
_QUANT_DTYPES = (torch.int8, torch.uint8)


class StepRecorder(TorchDispatchMode):
    """Records every ATen op run inside it ("aten::name.overload") and,
    through a function mode, every torch function call ("torch.name": the
    level at which a composite such as `isfinite` is still itself), in
    order, as {"op": name, "inputs" / "outputs": [(dtype, shape, device)
    of each tensor], "impl": the registry (op, impl) of the kernel route it
    ran under, or None}. The non-ref impls are wrapped while the mode is
    on, since the registry's dispatch hook fires only before an impl, not
    around it. A CUDA kernel's ctypes launch is not an ATen op and does not
    show: the ops of a kernel impl are its wrapper's (and, on CPU tensors,
    its plain version's)."""

    def __init__(self):
        super().__init__()
        self.ops: List[dict] = []
        self._route: List[tuple] = []
        self._saved: Dict[tuple, object] = {}
        self._functions = _FunctionRecorder(self)

    def __enter__(self):
        try:
            for key in registry.kernel_impls():
                self._saved[key] = registry._impls[key]
                registry._impls[key] = self._tagged(key, self._saved[key])
            self._functions.__enter__()
            try:
                return super().__enter__()
            except BaseException:
                self._functions.__exit__(None, None, None)
                raise
        except BaseException:
            registry._impls.update(self._saved)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            try:
                self._functions.__exit__(*exc)
            finally:
                registry._impls.update(self._saved)

    def record(self, name: str, args, kwargs, out):
        self.ops.append({"op": name,
                         "inputs": self._tensors((args, kwargs)),
                         "outputs": self._tensors(out),
                         "impl": self._route[-1] if self._route else None})

    def _tagged(self, key, fn):
        def impl(*args, **kwargs):
            self._route.append(key)
            try:
                return fn(*args, **kwargs)
            finally:
                self._route.pop()
        return impl

    @staticmethod
    def _tensors(tree) -> List[tuple]:
        return [(t.dtype, tuple(t.shape), t.device.type)
                for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record(func.name(), args, kwargs, out)
        return out


class _FunctionRecorder(TorchFunctionMode):
    def __init__(self, rec: StepRecorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec.record(f"torch.{getattr(func, '__name__', func)}", args,
                        kwargs, out)
        return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _transfer(op: dict) -> Optional[str]:
    """'d2h' / 'h2d' when `op` copies between the host and a device."""
    if op["op"] not in _COPY_OPS:
        return None
    src = {d for _, _, d in op["inputs"]}
    dst = {d for _, _, d in op["outputs"]}
    if "cpu" in dst and src - {"cpu"}:
        return "d2h"
    if "cpu" in src and dst - {"cpu"}:
        return "h2d"
    return None


def audit_step_ops(ops: List[dict], where: str,
                   report: Optional[Report] = None, *,
                   quantized: bool = True) -> Report:
    """HL201 + HL203 over one step's recorded ops."""
    rep = report if report is not None else Report()
    seen = set()
    for op in ops:
        name = op["op"]
        kind = _transfer(op)
        if name in SYNC_OPS or kind is not None:
            label = f"{name} ({kind})" if kind else name
            if label not in seen:
                seen.add(label)
                rep.add("HL201", "error", CHECKER, where,
                        f"host-syncing op {label} inside the step — the "
                        f"host waits for the device every token")
        elif (quantized and op["impl"] is None and name in _COPY_OPS
              and op["inputs"] and op["outputs"]):
            dt, shape, _ = op["inputs"][0]
            odt = op["outputs"][0][0]
            n = _numel(shape)
            if (dt in _QUANT_DTYPES and odt in (torch.float32, torch.float64)
                    and n >= UPCAST_ELEMENT_THRESHOLD):
                rep.add("HL203", "warning", CHECKER, where,
                        f"{dt}->{odt} upcast of a {shape} tensor ({n} "
                        f"elements) outside any kernel: looks like a "
                        f"materialized dequant in the quantized path")
    return rep


def audit_rebinding(before: List[tuple], after: List[tuple], where: str,
                    report: Optional[Report] = None) -> Report:
    """HL202: every cache buffer must keep its storage across a step.
    `before` / `after` are `engine.cache_buffers()` around it (with the
    old tensors held alive, so an address cannot be reused)."""
    rep = report if report is not None else Report()
    now = {name: ptr for name, ptr, _, _ in after}
    moved = [name for name, ptr, _, _ in before if now.get(name) != ptr]
    fields = sorted({n.split(".", 1)[1] for n in moved})
    for field in fields:
        layers = [n.split(".", 1)[0] for n in moved
                  if n.split(".", 1)[1] == field]
        rep.add("HL202", "error", CHECKER, where,
                f"cache field {field!r} is rebound to new storage by the "
                f"step in {len(layers)} layer(s) ({', '.join(layers[:4])}"
                f"{', ...' if len(layers) > 4 else ''}) — a captured step "
                f"would read the old buffer; write it in place")
    return rep


def audit_trace_count(actual: int, expected: int, where: str,
                      report: Optional[Report] = None) -> Report:
    """HL204: after warmup the step must have run at exactly as many widths
    as the engine's lifetime widths (warmup runs each of them, so any
    other width makes the count larger)."""
    rep = report if report is not None else Report()
    if actual != expected:
        rep.add("HL204", "error", CHECKER, where,
                f"step program ran at {actual} width(s), expected "
                f"{expected} (one per lifetime width) — a shape leak "
                f"launches the hot loop at other widths")
    return rep


def audit_health_guard(ops: List[dict], slots: int, where: str,
                       report: Optional[Report] = None) -> Report:
    """HL205: the step must compute the (slots,) bool health from
    `isfinite` + `all` over the logits on the device."""
    rep = report if report is not None else Report()
    finite = any(op["op"] in ("torch.isfinite", "aten::isfinite")
                 for op in ops)
    health = any(op["op"] in ("torch.all", "aten::all.dim")
                 and any(dt == torch.bool and shape == (slots,)
                         for dt, shape, _ in op["outputs"]) for op in ops)
    if not (finite and health):
        rep.add("HL205", "error", CHECKER, where,
                f"step has no (slots,) bool health output of isfinite + "
                f"all (isfinite: {finite}, a (slots,) all: {health}) — "
                f"poisoned logits could only be caught by an extra "
                f"host-side pass")
    return rep


def audit_swap_hygiene(ops: List[dict], where: str,
                       report: Optional[Report] = None) -> Report:
    """HL206: no rank >= 4 tensor (cache or pool bytes) may be copied to
    the host inside the step."""
    rep = report if report is not None else Report()
    for op in ops:
        if _transfer(op) != "d2h":
            continue
        for dt, shape, _ in op["inputs"]:
            if len(shape) >= 4:
                rep.add("HL206", "error", CHECKER, where,
                        f"{op['op']} copies a {shape} {dt} tensor to the "
                        f"host inside the step — cache bytes leave the hot "
                        f"loop; swap transfers run at the scheduler "
                        f"boundary (serving.swap)")
    return rep


_TORCH_DIR = os.path.dirname(torch.__file__)
# frames of the recording machinery, never the caller of a sync
_RECORDER = {"__torch_function__", "__torch_dispatch__", "record", "impl",
             "watched"}


def _caller() -> str:
    """"file:line (function)" of the innermost frame that is neither
    PyTorch's nor the audit's own: the code that made the sync."""
    for fr in reversed(traceback.extract_stack()[:-1]):
        if (fr.filename.startswith(_TORCH_DIR) or fr.name in _RECORDER
                or fr.filename in (__file__, warnings.__file__)):
            continue
        path = fr.filename.split(os.sep + "src" + os.sep)[-1]
        return f"{path}:{fr.lineno} ({fr.name})"
    return "unknown"


@contextlib.contextmanager
def sync_points(device: torch.device):
    """Record the synchronizing CUDA calls made inside (a list of "file:line
    (function)" of their callers): `set_sync_debug_mode("warn")` with the
    warnings intercepted where they are raised, so the caller's frame is on
    the stack; the previous mode is restored in a `finally`, other
    warnings pass on. Nothing on the CPU."""
    found: List[str] = []
    if device.type != "cuda":
        yield found
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        passed_on = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                found.append(_caller())
            else:
                passed_on(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _report_syncs(found: Iterable[str], where: str, rep: Report):
    for loc in dict.fromkeys(found):
        rep.add("HL201", "error", CHECKER, where,
                f"synchronizing CUDA operation at {loc} inside the step "
                f"(sync-debug mode)")


def check_engine(engine, report: Optional[Report] = None, *,
                 warmup: bool = True, label: str = "",
                 live_steps: int = 0) -> Report:
    """Run every hot-loop audit against one live ServingEngine: the idle
    step at each lifetime width; then, with `live_steps`, that many real
    `engine.step()`s of whatever the engine holds (submit requests first),
    their step programs under the sync-debug mode."""
    rep = report if report is not None else Report()
    name = label or f"engine[{engine.cfg.name}]"
    quantized = bool(engine.cfg.kv_quant) or \
        engine.weight_route().startswith("resident")
    for w in engine.step_widths():
        where = f"{name} step(width={w})"
        held = [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
                for c in engine.caches]      # no address is reused
        before = engine.cache_buffers()
        with sync_points(engine.device) as found:
            ops = engine.step_trace(w, StepRecorder()).ops
        after = engine.cache_buffers()
        del held
        audit_step_ops(ops, where, rep, quantized=quantized)
        _report_syncs(found, where, rep)
        audit_rebinding(before, after, where, rep)
        audit_health_guard(ops, engine.slots, where, rep)
        audit_swap_hygiene(ops, where, rep)
    if live_steps:
        program = engine._step_program
        found: List[str] = []

        def watched(*args, **kwargs):
            with sync_points(engine.device) as f:
                out = program(*args, **kwargs)
            found.extend(f)
            return out
        engine._step_program = watched
        try:
            for _ in range(live_steps):
                engine.step()
        finally:
            del engine._step_program
        _report_syncs(found, f"{name} live steps", rep)
    if warmup:
        engine.warmup()
        audit_trace_count(engine.step_trace_count(),
                          len(engine.step_widths()), name, rep)
    return rep


def _default_engines():
    """The representative serving configs the default audit covers, on the
    card when there is one: the kernel-routed smoke engine with an int8 KV
    cache and int8-resident weights (the quantized hot path), the dense
    engine, and the paged block-pool engine with host swap armed (the
    HL206 subject)."""
    from ..api import ExecutionPolicy
    from ..configs import get_smoke
    from ..models import init_params
    from ..serving import ServingEngine

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    pol = ExecutionPolicy(backend="auto", format="int8")
    cfg = get_smoke("qwen2_1p5b")
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    yield ("quantized-kernels",
           ServingEngine(qcfg, init_params(qcfg, seed=0, device=dev),
                         slots=2, max_len=64, policy=pol, prefill_chunk=8,
                         weight_format="int8"))
    model = init_params(cfg, seed=0, device=dev)
    yield ("dense-kernels",
           ServingEngine(cfg, model, slots=2, max_len=64, policy=pol,
                         prefill_chunk=8))
    yield ("paged-swap",
           ServingEngine(cfg, model, slots=2, max_len=64, prefill_chunk=8,
                         paged=True, block_size=16, pool_blocks=12,
                         swap_watermark=0.75))


def check_hot_loop(report: Optional[Report] = None, *,
                   warmup: bool = True) -> Report:
    """Audit the default engine set (small smoke engines)."""
    rep = report if report is not None else Report()
    for label, engine in _default_engines():
        check_engine(engine, rep, warmup=warmup, label=label)
    return rep
