"""Static analysis of the port: four checkers, one report (the port of
`repro.analysis`).

  * kernel-contracts — every kernel impl's declared CUDA launches (grid,
    threads, shared memory, cluster) against the H100's limits, and every
    operand's tile evaluated at every grid point over a (case x policy
    tile) sweep: bounds, masked tails, 32-bit offsets;
  * kernel-body — the contracts' output maps checked for write races and
    their quant/scale declarations; on a card, each contract's body
    launched inside redzones, under the profiler (geometry) and under
    compute-sanitizer;
  * hot-loop — the serving engine's step program, recorded op by op:
    host syncs, rebound cache buffers, materialized dequants, the width
    invariant, the health guard, swap hygiene;
  * format-matrix — the AIO format grid cross-checked against the format
    registry, the policy plane, the MAC-array modes, weight residency,
    and the perf model.

CLI: ``python -m repro_torch.analysis [--strict] [--json PATH] [--check
NAME] [--list-codes] [--baseline PATH] [--write-baseline PATH]``.
"""
from .findings import Finding, Report, SEVERITIES  # noqa: F401
from .format_matrix import (FORMAT_MATRIX, FormatClaim,  # noqa: F401
                            check_format_matrix)
from .hotloop import (audit_health_guard, audit_rebinding,  # noqa: F401
                      audit_step_ops, audit_swap_hygiene, audit_trace_count,
                      check_engine, check_hot_loop)
from .kernel_body import (check_body, check_kernel_bodies,  # noqa: F401
                          stratified_grid_points)
from .kernel_contracts import (check_kernel_contracts,  # noqa: F401
                               check_launch)
from .run import compare_baseline, run_all  # noqa: F401
