"""Host helpers: contract checks, the ragged `Table`, and the typed health
errors, guards and SDC configuration of the resilience layer."""
from .health import (
    ControllerLostError, DeadlineInfeasible, ExchangeTimeoutError, LoweringConflictError, NonFiniteError,
    PartLossError, PlanSoundnessError, RollbackRing, SDCConfig, SilentCorruptionError, SolveDeadlineError,
    SolverBreakdownError, SolverHealthError, SolverStagnationError, StagnationDetector, abft_tolerance,
    audit_tolerance, check_finite_pvector, check_finite_scalar, nonfinite_part_diagnostics, retry_with_backoff,
)
from .helpers import check, checks_enabled, notimplemented, notimplementedif, unreachable
from .table import (
    INDEX_DTYPE, Table, counts_to_ptrs, empty_table, get_data, get_ptrs, length_to_ptrs, ptrs_to_counts,
    rewind_ptrs,
)

__all__ = [
    "ControllerLostError", "DeadlineInfeasible", "ExchangeTimeoutError", "LoweringConflictError", "NonFiniteError",
    "PartLossError", "PlanSoundnessError", "RollbackRing", "SDCConfig", "SilentCorruptionError",
    "SolveDeadlineError", "SolverBreakdownError", "SolverHealthError", "SolverStagnationError",
    "StagnationDetector", "abft_tolerance", "audit_tolerance", "check_finite_pvector", "check_finite_scalar",
    "nonfinite_part_diagnostics", "retry_with_backoff",
    "INDEX_DTYPE", "Table", "check", "checks_enabled", "counts_to_ptrs", "empty_table", "get_data", "get_ptrs",
    "length_to_ptrs", "notimplemented", "notimplementedif", "ptrs_to_counts", "rewind_ptrs", "unreachable",
]
