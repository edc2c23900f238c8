"""repro_torch.analysis kernel-body checks on the CPU: the write-race
detector (KB410/411) and the quant/scale declarations (KB421) on seeded
contracts, the redzone harness's bookkeeping on plain functions that read
or write one element past an operand, the comparison and profiled-geometry
logic the card part uses, the compute-sanitizer report parsing on a
stand-in tool, and the current tree: the strict pass of kernel-contracts
and format-matrix, and the `cpu` section of the committed baseline
reproduced exactly. The card part itself runs in the `cuda` tests
(tests/test_torch_cuda.py) and chip_smoke.py phase 3f."""
import json
import pathlib
import re

import pytest
import torch

from repro_torch.analysis import card, kernel_body, run
from repro_torch.analysis.findings import Report
from repro_torch.analysis.kernel_body import check_body, check_kernel_bodies
from repro_torch.api import ExecutionPolicy
from repro_torch.api.registry import (BlockContract, KernelLaunch,
                                      KernelRegistry, LaunchContract,
                                      registry)

import _xdist_threads  # noqa: F401  (one torch thread a worker)

BASELINE = (pathlib.Path(__file__).resolve().parent.parent / "src"
            / "repro_torch" / "analysis" / "baseline.json")


def _lc(*blocks, grid=(4, 2), scalars=()):
    return LaunchContract(launches=(KernelLaunch("k", grid, tuple(blocks)),),
                          scalars=scalars, num_scalars=len(scalars))


def _out(index_map, revisits=(), array=(4, 32), block=(1, 32)):
    return BlockContract("out", array, block, index_map, is_output=True,
                         revisits=revisits)


# ============================================================ KB410 / KB411
def test_undeclared_revisit_fires_kb410():
    """Both blocks of a row write its tile, along a dim not declared."""
    rep = check_body(_lc(_out(lambda i, j: (i, 0))), "t")
    assert [f.code for f in rep.errors] == ["KB410"]


def test_declared_split_revisit_passes():
    rep = check_body(_lc(_out(lambda i, j: (i, 0), revisits=(1,))), "t")
    assert rep.ok() and not rep.findings


def test_overlapping_element_ranges_fire_kb410():
    """Unequal but overlapping element ranges are a race too: block j of a
    row writes [8j, 8j + 12), so neighbours share 4 elements."""
    rep = check_body(_lc(_out(lambda i, j: (i, range(8 * j, 8 * j + 12)),
                              block=(1, 1))), "t")
    assert [f.code for f in rep.errors] == ["KB410"]


def test_disjoint_element_ranges_pass():
    rep = check_body(_lc(_out(lambda i, j: (i, range(16 * j, 16 * j + 16)),
                              block=(1, 1))), "t")
    assert not rep.findings


def test_stale_revisit_declaration_fires_kb411_warning():
    rep = check_body(_lc(_out(lambda i, j: (i, j), revisits=(1,),
                              block=(1, 16))), "t")
    assert [f.code for f in rep.findings] == ["KB411"] and rep.ok()


def test_blocks_that_touch_nothing_do_not_race():
    """A split past a row's frontier exits at once (index map None)."""
    rep = check_body(_lc(_out(lambda i, j: (i, 0) if j == 0 else None)),
                     "t")
    assert not rep.findings


def test_inputs_before_outputs_or_kb431():
    lc = _lc(_out(lambda i, j: (i, 0), revisits=(1,)),
             BlockContract("x", (4, 32), (1, 32), lambda i, j: (i, 0)))
    assert [f.code for f in check_body(lc, "t").errors] == ["KB431"]


# ==================================================================== KB421
def _codes(**kw):
    return BlockContract("codes", (4, 32), (1, 32), lambda i, j: (i, 0),
                         dtype_bytes=1, **kw)


def _scale(**kw):
    return BlockContract("scale", (4, 1), (1, 1), lambda i, j: (i, 0), **kw)


@pytest.mark.parametrize("blocks,why", [
    ((_codes(quant="int7"), _scale(scale_for="codes")), "not a FORMAT"),
    ((_codes(quant="int8"),), "no scale operand"),
    ((_codes(quant="int8"), _scale(scale_for="codez")), "no such operand"),
    ((_codes(), _scale(scale_for="codes")), "declares no quant"),
    ((_codes(quant="int8"),
      BlockContract("scale", (4, 2), (1, 2), lambda i, j: (i, 0),
                    scale_for="codes")), "axis mismatch"),
], ids=["format", "no-scale", "dangling", "unquantized", "plane"])
def test_inconsistent_quant_declarations_fire_kb421(blocks, why):
    rep = check_body(_lc(*blocks, _out(lambda i, j: (i, 0),
                                       revisits=(1,))), "t")
    assert {f.code for f in rep.errors} == {"KB421"}, rep.render()
    assert any(why in f.message for f in rep.errors)


def test_consistent_quant_declarations_pass():
    rep = check_body(_lc(_codes(quant="int8"), _scale(scale_for="codes"),
                         _out(lambda i, j: (i, 0), revisits=(1,))), "t")
    assert not rep.findings


# ============================================================ KB430 / KB432
def test_contract_without_body_fires_kb430_and_no_card_is_kb432():
    reg = KernelRegistry()
    reg._loaded = True

    @reg.register("op", "cuda")
    def impl(*, policy):
        pass

    @reg.register_contract("op", "cuda", cases=({},))
    def contract(case, policy):
        return _lc(_out(lambda i, j: (i, 0), revisits=(1,)))

    rep = check_kernel_bodies(reg, card=False)
    assert [f.code for f in rep.findings] == ["KB430", "KB432"]
    assert rep.ok()


def test_check_kernel_body_refuses_to_pass_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run.main(["--check", "kernel-body"])
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        card.check_on_card()


def test_current_tree_bodies_declare_bodies_and_race_free():
    rep = check_kernel_bodies(card=False)
    assert [f.code for f in rep.findings] == ["KB432"], rep.render()


# ================================================================ redzones
def _fill(args, launch):
    """A plain 'kernel': out[:] = 2 * x."""
    x, out = args
    out.copy_(2 * x)


def _redzone_run(kernel, x):
    out = torch.empty_like(x)
    with card.Redzones(guard=256) as rz:
        card.common._launch_hook(
            "plain", (x, out), lambda *a: kernel(a, None))
    return out, rz.problems()


def test_redzones_stay_quiet_on_an_in_bounds_function():
    x = torch.arange(6, dtype=torch.float32)
    out, problems = _redzone_run(_fill, x)
    assert problems == [] and torch.equal(out, 2 * x)


def test_redzones_catch_one_element_written_past_the_output():
    def overrun(args, _):
        x, out = args
        torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 1.0
        out.copy_(2 * x)
    out, problems = _redzone_run(overrun, torch.ones(6))
    assert len(problems) == 1, problems
    assert "argument 1" in problems[0] and "after" in problems[0]
    # the first element past the end: 1.0 differs from the NaN pattern in
    # its upper two bytes
    assert int(re.search(r"nearest at \+(\d+) bytes from its end",
                         problems[0]).group(1)) < 4


def test_redzones_catch_one_element_written_before_an_operand():
    def underrun(args, _):
        x, out = args
        out.copy_(2 * x)
        torch.as_strided(out, (1,), (1,), out.storage_offset() - 1)[0] = 1
    _, problems = _redzone_run(underrun, torch.ones(6))
    assert len(problems) == 1 and "before" in problems[0], problems


def test_a_read_past_an_input_reaches_the_output_as_nan():
    def overread(args, _):
        x, out = args
        out.copy_(torch.as_strided(x, (x.numel(),), (1,), 1))
    x = torch.ones(6)
    out, problems = _redzone_run(overread, x)
    assert problems == []                       # nothing written out of place
    oob, diff = card.compare(out, x, 0.0)
    assert oob is not None and "redzone" in oob and diff is None


def test_redzone_patterns_are_nan_or_max_codes():
    assert torch.frombuffer(bytearray(card._pattern(torch.float32)),
                            dtype=torch.float32).isnan().all()
    assert torch.frombuffer(bytearray(card._pattern(torch.bfloat16)),
                            dtype=torch.bfloat16).isnan().all()
    assert card._pattern(torch.int8) == b"\x7f"


def test_compare_tolerance_and_bitwise():
    want = torch.tensor([1.0, 2.0, float("nan")])
    assert card.compare(want.clone(), want, 0.0) == (None, None)
    near = want + torch.tensor([0.0, 1e-5, 0.0])
    assert card.compare(near, want, 1e-4) == (None, None)
    oob, diff = card.compare(near, want, 0.0)
    assert oob is None and "max |kernel - plain|" in diff
    pair = (torch.zeros(2, dtype=torch.int8), torch.ones(2, 1))
    assert card.compare(pair, pair, 0.0) == (None, None)


# ===================================================== profiled geometry
def _record(name, grid, block, smem, ts):
    return {"cat": "kernel", "name": name, "ts": ts,
            "args": {"grid": grid, "block": block, "shared memory": smem}}


def test_geometry_drift_reads_the_profilers_kernel_records():
    lc = LaunchContract(launches=(
        KernelLaunch("split_kv_kernel", (75,), (), threads=256),
        KernelLaunch("flash_full_kernel", (2, 4), (), threads=256,
                     smem_bytes=110592)))
    events = [
        _record("void repro::full::flash_full_kernel<float, 3>(Args)",
                [2, 4, 1], [256, 1, 1], 110592, 20),
        _record("void at::native::vectorized_elementwise_kernel<4>(...)",
                [9, 1, 1], [128, 1, 1], 0, 5),
        _record("void repro::full::split_kv_kernel<float, 3>(Args)",
                [75, 1, 1], [256, 1, 1], 0, 10),
        {"cat": "cpu_op", "name": "flash_full_kernel(", "ts": 1}]
    recs = card.profiled_launches(events, {"split_kv_kernel",
                                           "flash_full_kernel"})
    assert [r["ts"] for r in recs] == [10, 20]
    assert card.geometry_drift(lc, recs) == []
    recs[1]["args"]["grid"] = [2, 5, 1]
    recs[1]["args"]["shared memory"] = 110608
    drift = card.geometry_drift(lc, recs)
    assert len(drift) == 2 and "grid" in drift[0] and "shared" in drift[1]
    assert "1 kernel record" in card.geometry_drift(lc, recs[:1])[0]


_SPLIT_KV = LaunchContract(launches=(
    KernelLaunch("split_kv_kernel", (75,), (), threads=256),))
_SPLIT_KV_RECORD = _record("void repro::full::split_kv_kernel<float, 3>(Args)",
                           [75, 1, 1], [256, 1, 1], 0, 10)
_COPY_RECORD = {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 5}


def _sessions(monkeypatch, traces, problems=()):
    """run_body on the CPU with each profiler session's trace taken in turn
    from `traces`; returns its findings and the sessions it opened."""
    class Zones:
        def problems(self):
            return list(problems)
    opened = []

    def session(lc):
        opened.append(len(opened))
        out = torch.ones(3)
        return Zones(), out, out.clone(), traces[len(opened) - 1]
    monkeypatch.setattr(card, "profiled_body", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return card.run_body(_SPLIT_KV), len(opened)


@pytest.mark.parametrize("traces,sessions", [
    ([[_SPLIT_KV_RECORD]], 1),
    ([[], [_COPY_RECORD, _SPLIT_KV_RECORD]], 2),
    ([[_COPY_RECORD], [], [_SPLIT_KV_RECORD]], 3),
], ids=["first", "after-one-short", "after-two-short"])
def test_a_session_short_of_kernel_records_is_profiled_again(
        monkeypatch, traces, sessions):
    assert _sessions(monkeypatch, traces) == ([], sessions)


def test_a_launch_missing_from_every_session_is_a_finding(monkeypatch):
    found, opened = _sessions(monkeypatch,
                              [[_COPY_RECORD]] * card.PROFILE_ATTEMPTS)
    assert opened == card.PROFILE_ATTEMPTS
    assert [code for code, _ in found] == ["KB431"]
    assert "0 kernel record" in found[0][1]
    assert "in each of 3 profiler sessions" in found[0][1]


@pytest.mark.parametrize("trace", [
    [_COPY_RECORD, _SPLIT_KV_RECORD, dict(_SPLIT_KV_RECORD, ts=20)],
    [dict(_SPLIT_KV_RECORD, args={"grid": [76, 1, 1], "block": [256, 1, 1],
                                  "shared memory": 0})],
    [dict(_SPLIT_KV_RECORD, args={"grid": [75, 1, 1], "block": [128, 1, 1],
                                  "shared memory": 0})],
], ids=["extra", "grid", "block"])
def test_a_drifted_launch_is_a_finding_at_once(monkeypatch, trace):
    """Every launch recorded but one that differs: drift, no second
    session."""
    found, opened = _sessions(monkeypatch, [trace, [_SPLIT_KV_RECORD]])
    assert opened == 1
    assert [code for code, _ in found] == ["KB431"]
    assert "profiler sessions" not in found[0][1]


def test_a_redzone_problem_of_a_short_session_is_kept(monkeypatch):
    found, opened = _sessions(monkeypatch, [[], [_SPLIT_KV_RECORD]],
                              problems=["guard changed"])
    assert (found, opened) == ([("KB400", "guard changed")], 2)


def test_static_shared_memory_is_part_of_the_contract():
    """The profiler reports dynamic plus static shared memory; the split-K
    arrival's `s_last` is 16 bytes as ptxas lays it out."""
    lc = registry.contract("matmul", "cuda")(
        {"m": 8, "k": 1536, "n": 256, "mode": "int8"}, ExecutionPolicy())
    (lch,) = lc.launches
    assert (lch.smem_bytes, lch.static_smem) == (93184, 16)


# ===================================================== compute-sanitizer
def _fake_tool(tmp_path, monkeypatch, text, code):
    tool = tmp_path / "compute-sanitizer"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + text + "\nEOF\nexit "
                    f"{code}\n")
    tool.chmod(0o755)
    monkeypatch.setattr(card, "_sanitizer", lambda: str(tool))


def test_a_tool_that_refuses_the_device_is_kb433_with_its_words(
        tmp_path, monkeypatch):
    _fake_tool(tmp_path, monkeypatch,
               "========= COMPUTE-SANITIZER\n========= Error: Device not "
               "supported. Please refer to the documentation", 86)
    rep = Report()
    card.run_sanitizers(rep)
    assert [f.code for f in rep.findings] == ["KB433"] and rep.ok()
    msg = rep.findings[0].message
    assert "Device not supported" in msg
    assert "synccheck, racecheck, initcheck" in msg


@pytest.mark.parametrize("tool,code", [("memcheck", "KB400"),
                                       ("racecheck", "KB410")])
def test_sanitizer_reports_are_errors(tmp_path, monkeypatch, tool, code):
    _fake_tool(tmp_path, monkeypatch,
               "========= Invalid __global__ write of size 4 bytes\n"
               "=========     at flash_decode_kernel+0x1f0\n"
               "========= ERROR SUMMARY: 1 error", 86)
    rep = Report()
    card.run_sanitizers(rep, tools=(tool,))
    assert [f.code for f in rep.errors] == [code]
    assert "Invalid __global__ write" in rep.errors[0].message


def test_clean_sanitizer_runs_add_nothing(tmp_path, monkeypatch):
    _fake_tool(tmp_path, monkeypatch, "========= ERROR SUMMARY: 0 errors", 0)
    rep = Report()
    card.run_sanitizers(rep)
    assert not rep.findings


def test_a_missing_sanitizer_is_kb433(monkeypatch):
    monkeypatch.setattr(card, "_sanitizer", lambda: None)
    rep = Report()
    card.run_sanitizers(rep)
    assert [f.code for f in rep.findings] == ["KB433"]


def test_sanitizer_cases_cover_every_c_entry_point_once_a_variant():
    cases = card.sanitizer_cases()
    entries = {lc.entry for _, lc in cases}
    assert entries == {"flash_decode", "flash_decode_paged", "flash_prefill",
                       "flash_prefill_paged", "flash_attention_full",
                       "aio_matmul", "aio_quant", "grouped_matmul",
                       "depthwise_conv"}
    assert len({card._variant(lc) for _, lc in cases}) == len(cases)


# ============================================================ current tree
def test_strict_kernel_contracts_and_format_matrix_pass(capsys):
    assert run.main(["--strict", "--check", "kernel-contracts",
                     "--check", "format-matrix"]) == 0
    out = capsys.readouterr().out
    assert "KC100" not in out and "0 error" in out


def test_cpu_section_of_the_committed_baseline_is_reproduced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = run.run_all()
    data = json.loads(BASELINE.read_text())
    assert run.counts_by_code(rep) == data["cpu"]["counts_by_code"]
    assert run.compare_baseline(rep, run.baseline_section(data, "cpu")) == []


def test_kernel_body_module_lists_its_codes():
    assert set(kernel_body.CODES) == {
        "KB400", "KB402", "KB410", "KB411", "KB421", "KB430", "KB431",
        "KB432", "KB433"}
