"""repro_torch.analysis: every checker must fire on seeded violations and
stay quiet on the current tree (the --strict gate); the counterpart of
tests/test_analysis.py, test for test, plus parity with the reference's
analysis package (`repro.analysis`, imported alone: no JAX engine is
built here)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.analysis as jan
from repro.analysis import format_matrix as jfm
from repro.analysis import hotloop as jhl
from repro.analysis import kernel_body as jkb
from repro.analysis import kernel_contracts as jkc
from repro.analysis import run as jrun
from repro.kernels.aio_matmul import contract as jmm
from repro.kernels.aio_quant import contract as jq
from repro.kernels.depthwise import contract as jdw
from repro.kernels.flash_attention import contract as jfa
from repro.kernels.grouped_matmul import contract as jgm
from repro_torch.analysis import (check_engine, check_format_matrix,
                                  check_kernel_contracts, check_launch)
from repro_torch.analysis import format_matrix, hotloop, kernel_body
from repro_torch.analysis import kernel_contracts, run
from repro_torch.analysis.format_matrix import FormatClaim
from repro_torch.analysis.hotloop import (StepRecorder, audit_health_guard,
                                          audit_rebinding, audit_step_ops,
                                          audit_swap_hygiene,
                                          audit_trace_count)
from repro_torch.api import ExecutionPolicy
from repro_torch.api.registry import (BlockContract, KernelLaunch,
                                      KernelRegistry, LaunchContract,
                                      registry)
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import contract as fa
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

BASELINE = (pathlib.Path(__file__).resolve().parent.parent / "src"
            / "repro_torch" / "analysis" / "baseline.json")


# ========================================================== kernel contracts
def _launch(index_map, *, grid=(4,), array=(128,), block=(32,), nsp=0,
            scalars=(), masked=False, **launch_kw):
    return LaunchContract(
        launches=(KernelLaunch("k", grid, (
            BlockContract("x", array, block, index_map,
                          masked_tail=masked),), **launch_kw),),
        num_scalars=nsp, scalars=scalars)


def test_clean_identity_launch_passes():
    rep = check_launch(_launch(lambda i: (i,)), "t")
    assert rep.ok() and not rep.findings


def test_oob_index_fires_kc102():
    rep = check_launch(_launch(lambda i: (i + 1,)), "t")
    assert [f.code for f in rep.errors] == ["KC102"]


def test_arity_mismatch_fires_kc101():
    rep = check_launch(_launch(lambda i, j: (i,)), "t")
    assert rep.by_code("KC101")


def test_scalar_count_mismatch_fires_kc101():
    rep = check_launch(_launch(lambda i, s: (i,), nsp=2,
                               scalars=(np.zeros(2, np.int32),)), "t")
    assert rep.by_code("KC101")


def test_nondividing_block_without_mask_fires_kc103():
    rep = check_launch(_launch(lambda i: (i,), array=(100,)), "t")
    assert rep.by_code("KC103")


def test_nondividing_block_with_masked_tail_passes():
    rep = check_launch(_launch(lambda i: (i,), array=(100,), masked=True),
                       "t")
    assert not rep.by_code("KC103")


@pytest.mark.parametrize("launch_kw", [
    dict(smem_bytes=232448 - 16, static_smem=32),      # 227 KB a block
    dict(threads=1025),
    dict(grid=(4, 65536)),
    dict(cluster=16, grid=(16,)),
    dict(cluster=4, grid=(6,)),                       # x not a multiple
], ids=["smem", "threads", "grid-y", "cluster", "cluster-grid"])
def test_h100_limit_overcommit_fires_kc104(launch_kw):
    grid = launch_kw.pop("grid", (4,))
    rep = check_launch(_launch(lambda *p: (p[0] % 4,), grid=grid,
                               **launch_kw), "t")
    assert [f.code for f in rep.errors] == ["KC104"], rep.render()


def test_decode_workspace_one_block_short_fires_kc102(monkeypatch):
    """The REAL decode contract with the wrapper's plan sizing the split
    workspace one block short (the counterpart of the reference's
    one-block-short cache clamp): the last row group's partial lands past
    the buffer, an out-of-bounds write on the card that no comparison at
    the tests' shapes need show. The sweep must catch it as KC102."""
    real = fa.dec.decode_plan

    def short(*a, **kw):
        plan = real(*a, **kw)
        d = a[5]
        return dataclasses.replace(
            plan, workspace=plan.workspace - fa.RW * (d + 2))
    case = fa._DECODE_CASES[0]                 # a row at Lk - 1: 5 splits
    assert not check_launch(fa.decode_contract(case, ExecutionPolicy()),
                            "t").findings
    monkeypatch.setattr(fa.dec, "decode_plan", short)
    rep = check_launch(fa.decode_contract(case, ExecutionPolicy()), "t")
    assert [f.code for f in rep.errors] == ["KC102"], rep.render()
    assert "work_ml" in rep.errors[0].message


def test_int32_offset_past_range_fires_kc102():
    """An operand the kernel indexes in 32 bits: a tile whose last element
    lies past 2^31 - 1 is out of bounds however large the buffer."""
    def lc(bits):
        return LaunchContract(launches=(KernelLaunch("k", (3,), (
            BlockContract("big", (3, 2 ** 30), (1, 2 ** 30),
                          lambda i: (i, 0), index_bits=bits),)),))
    assert not check_launch(lc(64), "t").findings
    rep = check_launch(lc(32), "t")
    assert [f.code for f in rep.errors] == ["KC102"]
    assert "32-bit" in rep.errors[0].message


def test_rank_mismatch_does_not_suppress_oob_dedup_regression():
    rep = check_launch(
        _launch(lambda i: (i, i) if i == 0 else (99,)), "t")
    codes = sorted(f.code for f in rep.errors)
    assert codes == ["KC101", "KC102"], rep.render()


def test_stratified_sweep_reaches_far_corner_oob():
    g = 100000                                 # > MAX_GRID_POINTS
    rep = check_launch(
        _launch(lambda i: (i,) if i < g - 1 else (g,),
                grid=(g,), array=(32 * g,)), "t")
    assert [f.code for f in rep.errors] == ["KC102"], rep.render()
    assert rep.by_code("KC105")
    assert not any(f.code == "KC105" for f in rep.errors)


def _fake_reg():
    reg = KernelRegistry()
    reg._loaded = True                         # no kernel autoload
    return reg


def test_kernel_impl_without_contract_fires_kc100():
    reg = _fake_reg()

    @reg.register("op", "cuda")
    def impl(*, policy):
        pass

    rep = check_kernel_contracts(reg)
    assert [f.code for f in rep.findings] == ["KC100"]
    assert not rep.errors


def test_contract_builder_error_fires_kc105():
    reg = _fake_reg()

    @reg.register("op", "cuda")
    def impl(*, policy):
        pass

    @reg.register_contract("op", "cuda", cases=({},))
    def contract(case, policy):
        raise RuntimeError("boom")

    rep = check_kernel_contracts(reg)
    assert [f.code for f in rep.errors] == ["KC105"]


def test_checker_crosses_cases_with_policy_tile_sweep():
    reg = _fake_reg()
    seen = []

    @reg.register("op", "cuda")
    def impl(*, policy):
        pass

    @reg.register_contract("op", "cuda", cases=({"m": 128},),
                           sweep_fields=("bm",))
    def contract(case, policy):
        seen.append((case["m"], policy.bm))
        return LaunchContract(launches=(KernelLaunch(
            "k", (case["m"] // policy.bm,),
            (BlockContract("x", (case["m"],), (policy.bm,),
                           lambda i: (i,)),)),))

    rep = check_kernel_contracts(reg)
    assert rep.ok(), rep.render()
    assert seen == [(128, 128), (128, 64)]     # REPRESENTATIVE_TILES["bm"]


def test_current_tree_contracts_cover_all_kernel_impls_and_pass():
    rep = check_kernel_contracts()
    assert rep.ok(), rep.render()
    assert not rep.by_code("KC100")
    assert len(registry.kernel_impls()) == 8
    assert set(registry.contracts()) == set(registry.kernel_impls())


def test_contracts_reach_every_c_entry_point_flat_paged_and_int8():
    """The same impl key reaches four C entry points of decode and of
    prefill (flat and paged, each dense and int8); every other impl one."""
    reached = set()
    for key, fn in registry.contracts().items():
        for case in fn.cases:
            lc = fn(case, ExecutionPolicy())
            quant = any(b.quant == "int8" and b.name.startswith("k")
                        for lch in lc.launches for b in lch.blocks)
            reached.add((lc.entry, quant))
    for entry in ("flash_decode", "flash_decode_paged", "flash_prefill",
                  "flash_prefill_paged"):
        assert {(entry, False), (entry, True)} <= reached, entry
    assert {e for e, _ in reached} >= {"flash_attention_full", "aio_matmul",
                                       "aio_quant", "grouped_matmul",
                                       "depthwise_conv"}


@pytest.mark.parametrize("port_key,ref_cases", [
    (("attention", "cuda"), jfa._FLASH_CASES),
    (("attention", "cuda-decode"), jfa._DECODE_CASES),
    (("attention", "cuda-prefill"), jfa._PREFILL_CASES),
    (("matmul", "cuda"), jmm._CASES),
    # bf16 is no residency format in either package (the reference's
    # contract shares one case list between its two matmul impls)
    (("matmul_codes", "cuda"), tuple(c for c in jmm._CASES
                                     if c["mode"] != "bf16")),
    (("quantize", "cuda"), jq._CASES),
    (("grouped_matmul", "cuda"), jgm._CASES),
    (("depthwise_conv", "cuda"), jdw._CASES),
], ids=lambda v: "/".join(v) if isinstance(v[0], str) else "")
def test_port_contracts_include_the_reference_cases(port_key, ref_cases):
    cases = registry.contract(*port_key).cases
    for case in ref_cases:
        assert case in cases, case


# ================================================================= hot loop
def _record(fn, *args):
    with StepRecorder() as rec:
        fn(*args)
    return rec.ops


def test_step_recorder_restores_the_registry_when_entering_fails(
        monkeypatch):
    registry.kernel_impls()               # every kernel module registered
    saved = dict(registry._impls)

    def fail(self):
        raise RuntimeError("enter failed")
    monkeypatch.setattr(hotloop._FunctionRecorder, "__enter__", fail)
    with pytest.raises(RuntimeError, match="enter failed"):
        with StepRecorder():
            pass
    assert registry._impls == saved


def test_host_sync_in_step_fires_hl201():
    ops = _record(lambda x: torch.full((2,), x.sum().item()), torch.ones(4))
    rep = audit_step_ops(ops, "t")
    assert [f.code for f in rep.errors] == ["HL201"]
    assert "_local_scalar_dense" in rep.errors[0].message


@pytest.mark.parametrize("op", ["aten::nonzero", "aten::equal",
                                "aten::is_nonzero"])
def test_other_syncing_ops_fire_hl201(op):
    ops = [{"op": op, "inputs": [(torch.float32, (4,), "cuda")],
            "outputs": [], "impl": None}]
    assert [f.code for f in audit_step_ops(ops, "t").errors] == ["HL201"]


def test_host_to_device_copy_of_a_python_value_fires_hl201():
    """What `as_row_vector` does with an int on the card: a CPU tensor
    copied to the device (a synchronous copy from pageable memory)."""
    ops = [{"op": "aten::_to_copy", "inputs": [(torch.int32, (), "cpu")],
            "outputs": [(torch.int32, (), "cuda")], "impl": None}]
    rep = audit_step_ops(ops, "t")
    assert [f.code for f in rep.errors] == ["HL201"]
    assert "h2d" in rep.errors[0].message


def test_a_sync_is_attributed_to_the_code_that_made_it():
    """`sync_points` names the innermost frame outside PyTorch and the
    audit: here, this test."""
    assert "(test_a_sync_is_attributed_to_the_code_that_made_it)" in \
        hotloop._caller()


@pytest.mark.parametrize("message,is_sync", [
    ("called a synchronizing CUDA operation", True),
    ("Synchronization debug mode is a prototype feature and does not yet "
     "detect all synchronizing operations", False)])
def test_only_the_sync_warning_counts_as_a_sync(message, is_sync):
    """The first switch to the sync-debug mode in a process raises a notice
    that mentions synchronizing operations; it is not a sync of the step."""
    assert (hotloop.SYNC_WARNING in message) == is_sync


def test_pure_math_step_is_quiet():
    ops = _record(lambda x: torch.cumsum(x, 0) * 2.0, torch.zeros(4))
    assert not audit_step_ops(ops, "t").findings


def test_materialized_dequant_fires_hl203_warning():
    codes = torch.zeros((512, 512), dtype=torch.int8)
    ops = _record(lambda c: c.to(torch.float32) * 2.0, codes)
    rep = audit_step_ops(ops, "t", quantized=True)
    assert rep.by_code("HL203") and rep.ok()


def test_block_sized_dequant_is_quiet():
    codes = torch.zeros((16, 64), dtype=torch.int8)
    ops = _record(lambda c: c.to(torch.float32) * 2.0, codes)
    assert not audit_step_ops(ops, "t", quantized=True).findings


def test_dequant_inside_a_kernel_impl_is_not_counted():
    codes = torch.zeros((512, 512), dtype=torch.int8)
    ops = _record(lambda c: c.to(torch.float32) * 2.0, codes)
    ops = [dict(op, impl=("attention", "cuda-decode")) for op in ops]
    assert not audit_step_ops(ops, "t", quantized=True).findings


def test_rebound_cache_buffer_fires_hl202():
    before = [("0.k", 100, (2, 8), torch.float32),
              ("0.pos", 200, (2,), torch.int32)]
    after = [("0.k", 100, (2, 8), torch.float32),
             ("0.pos", 300, (2,), torch.int32)]
    rep = audit_rebinding(before, after, "t")
    assert [f.code for f in rep.errors] == ["HL202"]
    assert "'pos'" in rep.errors[0].message


def test_buffers_kept_in_place_pass():
    bufs = [("0.k", 100, (2, 8), torch.float32)] * 2
    assert not audit_rebinding(bufs, bufs, "t").findings


def test_trace_count_mismatch_fires_hl204():
    rep = audit_trace_count(3, 2, "t")
    assert [f.code for f in rep.errors] == ["HL204"]


def test_missing_health_output_fires_hl205():
    ops = _record(lambda x: (x * 2.0, x + 1.0), torch.zeros((2, 4)))
    rep = audit_health_guard(ops, 2, "t")
    assert [f.code for f in rep.errors] == ["HL205"]


def test_unfused_health_output_fires_hl205():
    ops = _record(lambda x: (x * 2.0, x.amax(1) > 0.0), torch.zeros((2, 4)))
    rep = audit_health_guard(ops, 2, "t")
    assert [f.code for f in rep.errors] == ["HL205"]


def test_cache_copied_to_host_in_step_fires_hl206():
    """A step that copies gathered pool slabs (rank 5) to the host: every
    token would ship whole KV blocks device->host."""
    ops = [{"op": "aten::_to_copy",
            "inputs": [(torch.float32, (2, 8, 4, 16, 8), "cuda")],
            "outputs": [(torch.float32, (2, 8, 4, 16, 8), "cpu")],
            "impl": None}]
    rep = audit_swap_hygiene(ops, "t")
    assert [f.code for f in rep.errors] == ["HL206"]


def test_small_host_results_pass_hl206():
    ops = [{"op": "aten::_to_copy",
            "inputs": [(torch.int64, (2, 8), "cuda")],
            "outputs": [(torch.int64, (2, 8), "cpu")], "impl": None}]
    assert not audit_swap_hygiene(ops, "t").findings


def test_fused_health_guard_passes_hl205():
    ops = _record(lambda x: (x * 2.0, torch.isfinite(x).all(1)),
                  torch.zeros((2, 4)))
    assert not audit_health_guard(ops, 2, "t").findings


def _engine(**kw):
    cfg = get_smoke("qwen2_1p5b")
    if kw.pop("kv_quant", False):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                         slots=2, max_len=32, prefill_chunk=4, **kw)


def test_engine_step_trace_carries_health_guard():
    eng = _engine()
    assert eng.step_widths() == (1, 4)
    for w in eng.step_widths():
        ops = eng.step_trace(w, StepRecorder()).ops
        assert audit_health_guard(ops, eng.slots, "t").ok()


def test_quantized_kernel_engine_hot_loop_finds_only_the_rebound_positions():
    """The configuration the audit exists to protect: kernel-routed, int8
    KV cache, int8-resident weights. On the CPU the only findings are the
    KV positions rebound each step (`cache.pos = ...`, A4b's list), every
    other buffer kept in place, and the step ran at exactly its two
    widths."""
    eng = _engine(kv_quant=True, weight_format="int8",
                  policy=ExecutionPolicy(backend="auto", format="int8"))
    rep = check_engine(eng)
    assert {f.code for f in rep.findings} == {"HL202"}, rep.render()
    assert all("'pos'" in f.message for f in rep.findings)
    assert eng.step_trace_count() == len(eng.step_widths()) == 2


def test_step_trace_tags_kernel_routes_and_leaves_the_caches_alone():
    eng = _engine()

    def fields():
        return [getattr(c, f.name) for c in eng.caches
                for f in dataclasses.fields(c)]
    before = [t.clone() for t in fields()]
    ops = eng.step_trace(1, StepRecorder()).ops
    assert all(torch.equal(a, b) for a, b in zip(before, fields()))
    routes = {op["impl"] for op in ops}
    assert ("attention", "cuda-decode") in routes and None in routes
    assert registry._impls[("attention", "cuda-decode")].__name__ != "impl"


# ============================================================ format matrix
def test_format_matrix_matches_current_tree():
    rep = check_format_matrix()
    assert rep.ok(), rep.render()
    assert {f.code for f in rep.findings} == {"FM306"}


def test_registry_format_missing_from_matrix_fires_fm301():
    from repro_torch.core import formats
    rep = check_format_matrix(
        registry_names=set(formats.REGISTRY) | {"fp6"})
    assert any(f.code == "FM301" and "fp6" in f.where for f in rep.errors)


def test_unclaimed_matmul_mode_fires_fm303():
    from repro_torch.kernels.aio_matmul import MODES
    rep = check_format_matrix(matmul_modes=set(MODES) | {"fp16"})
    assert any(f.code == "FM303" and "fp16" in f.where for f in rep.errors)


def test_residency_without_mode_fires_fm308():
    matrix = (FormatClaim("xx", paper=False, matmul_mode=False,
                          residency=True, perf_model=False, routable=False),)
    rep = check_format_matrix(
        matrix, registry_names={"xx"}, routable_names=set(),
        matmul_modes=set(), resident_names={"xx"}, perf_names=set())
    assert [f.code for f in rep.errors] == ["FM308"]


# ==================================================================== CLI
def test_cli_json_artifact_and_zero_exit(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = run.main(["--check", "format-matrix", "--strict", "--json",
                   str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["counts"]["error"] == 0
    assert any(f["code"] == "FM306" for f in data["findings"])


def test_cli_strict_exits_nonzero_on_seeded_error(monkeypatch):
    def seeded(report):
        report.add("XX999", "error", "test", "t", "seeded failure")
        return report

    monkeypatch.setitem(run.CHECKERS, "format-matrix", seeded)
    assert run.main(["--check", "format-matrix", "--strict"]) == 1
    assert run.main(["--check", "format-matrix"]) == 0


def test_cli_list_codes_prints_every_family(capsys):
    assert run.main(["--list-codes"]) == 0
    out = capsys.readouterr().out
    for checker, table in run.CODE_TABLES:
        for code, (severity, _) in table.items():
            assert code in out and checker in out
            assert severity in out
    assert out.index("KC100") < out.index("KB400") < out.index("HL201") \
        < out.index("FM301")


def test_cli_baseline_ratchet_roundtrip(tmp_path, capsys):
    base = tmp_path / "base.json"
    assert run.main(["--check", "format-matrix",
                     "--write-baseline", str(base)]) == 0
    data = json.loads(base.read_text())
    assert data[run.platform()]["counts_by_code"] == {"FM306": 2}
    assert run.main(["--check", "format-matrix", "--baseline",
                     str(base)]) == 0


def test_cli_write_baseline_keeps_the_other_platform(tmp_path):
    base = tmp_path / "base.json"
    other = "cuda" if run.platform() == "cpu" else "cpu"
    base.write_text(json.dumps({other: {"counts_by_code": {"KB433": 1}}}))
    assert run.main(["--check", "format-matrix",
                     "--write-baseline", str(base)]) == 0
    data = json.loads(base.read_text())
    assert data[other] == {"counts_by_code": {"KB433": 1}}
    assert data[run.platform()]["counts_by_code"] == {"FM306": 2}


def test_cli_baseline_fails_on_new_finding(tmp_path, monkeypatch, capsys):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"counts_by_code": {"FM306": 2}}))

    def noisier(report):
        check_format_matrix(report=report)
        report.add("FM306", "info", "format-matrix", "t", "one extra")
        return report

    monkeypatch.setitem(run.CHECKERS, "format-matrix", noisier)
    assert run.main(["--check", "format-matrix",
                     "--baseline", str(base)]) == 1
    assert "baseline allows 2" in capsys.readouterr().out


def test_cli_baseline_fails_on_fixed_finding_until_regenerated(tmp_path,
                                                               capsys):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({run.platform(): {
        "counts_by_code": {"FM306": 3}}}))
    assert run.main(["--check", "format-matrix", "--baseline",
                     str(base)]) == 1
    assert "regenerating" in capsys.readouterr().out


def test_committed_baseline_is_well_formed():
    data = json.loads(BASELINE.read_text())
    for section in ("cpu", "cuda"):
        counts = data[section]["counts_by_code"]
        assert isinstance(counts, dict)
        for code, n in counts.items():
            assert isinstance(n, int) and n > 0, (section, code, n)
    for label, sec in data["cuda"].get("engines", {}).items():
        assert all(isinstance(n, int) and n > 0
                   for n in sec["counts_by_code"].values()), label


# ============================================== parity with repro.analysis
def test_format_matrix_is_the_reference_table():
    assert format_matrix.FORMAT_MATRIX == tuple(
        FormatClaim(**dataclasses.asdict(c)) for c in jfm.FORMAT_MATRIX)
    assert [dataclasses.asdict(c) for c in format_matrix.FORMAT_MATRIX] == \
        [dataclasses.asdict(c) for c in jan.FORMAT_MATRIX]


@pytest.mark.parametrize("grid,cap", [((4, 3, 5), 1000), ((7,), 3),
                                      ((100000,), 65536),
                                      ((300, 300, 3), 4096), ((1, 9), 2)])
def test_stratified_grid_points_match_the_reference(grid, cap):
    pts, trunc = kernel_body.stratified_grid_points(grid, cap)
    jpts, jtrunc = jkb.stratified_grid_points(grid, cap)
    assert (list(pts), trunc) == (list(jpts), jtrunc)


@pytest.mark.parametrize("counts,base", [
    ({"FM306": 2}, {"counts_by_code": {"FM306": 2}}),
    ({"FM306": 3, "HL202": 1}, {"counts_by_code": {"FM306": 2}}),
    ({}, {"counts_by_code": {"KB433": 1}}),
])
def test_compare_baseline_matches_the_reference(counts, base):
    rep, jrep = run.Report(), jan.Report()
    for code, n in counts.items():
        for _ in range(n):
            rep.add(code, "info", "t", "t", "m")
            jrep.add(code, "info", "t", "t", "m")
    assert run.compare_baseline(rep, base) == \
        jrun.compare_baseline(jrep, base)
    assert rep.render() == jrep.render() and rep.to_json() == jrep.to_json()


@pytest.mark.parametrize("port,ref", [
    (kernel_contracts.CODES, jkc.CODES), (hotloop.CODES, jhl.CODES),
    (format_matrix.CODES, jfm.CODES), (kernel_body.CODES, jkb.CODES)],
    ids=["KC", "HL", "FM", "KB"])
def test_codes_keep_the_reference_severities(port, ref):
    shared = set(port) & set(ref)
    assert {code: port[code][0] for code in shared} == \
        {code: ref[code][0] for code in shared}
    if port is not kernel_body.CODES:            # KB has card-only codes
        assert set(port) == set(ref)
    else:
        assert shared >= {"KB400", "KB410", "KB411", "KB421", "KB430",
                          "KB431"}
