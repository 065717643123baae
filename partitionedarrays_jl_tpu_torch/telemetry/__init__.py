"""Runtime solver telemetry (telemetry/ of the JAX package, its core half).

* `telemetry.record` — typed `SolveRecord`s: configuration snapshot,
  residual and α/β trajectories, the structured event log; solvers return
  ``InfoDict`` (a dict with the record at ``info.record``).
* `telemetry.registry` / `telemetry.metrics` / `telemetry.histogram` — the
  typed counters, gauges and fixed-bucket latency histograms behind one
  lock, with JSON and Prometheus exports.
* `telemetry.tracing` — request spans with W3C ``traceparent``
  propagation; `telemetry.trace` — Chrome-trace export and `annotate`
  (`torch.profiler.record_function`, NVTX on a CUDA device).
* `telemetry.throughput` — the per-RHS throughput model of the service;
  `telemetry.spectrum` — CG–Lanczos spectral estimates from the α/β trace,
  forecasts and deadline admission.
* `telemetry.comms` — the model-against-counted comms accounting of the CG
  programs: `cg_comms_profile` (the plan-level model, stamped into every
  CG record as ``rec.comms``), the counted program each solve function
  keeps (``fn.comms_counted``, tallied while its loop runs its first
  block; the record carries it as ``rec.comms_counted``) and
  `reconcile`; the lowering cases (`comms.lowering_cases`, the JAX
  package's names) and their probe solves.
* `telemetry.commsmatrix` — the per-edge, per-round exchange cost matrix:
  `static_matrix` from the plan, `measure_comms_matrix` timing each round
  (each box direction) as its own chain.
* `telemetry.profile` — the phase profile of a CG iteration
  (`capture_phase_profile`: spmv_local, halo_exchange, dot_allgather,
  axpy_sweep; by a `torch.profiler` trace or the split-timer's chains),
  `reconcile_phases`, and `tracing.mount_phase_spans` lays a profile
  under the recorded slab spans.
* `telemetry.config` — the switches, one frozen `TelemetryConfig` set by
  `configure` (the JAX package reads them from ``PA_*`` environment
  variables; the port reads no environment).

Telemetry off costs the device nothing: every switch is host-side, and the
α/β trace ring of the CG loops is the solvers' ``trace_iters=`` keyword
(0, the default, launches exactly what the loop launched without it); the
comms tally is host arithmetic in the eager blocks only, and the profile
runs its own chains (``prof=False``: nothing). The ledger of the JAX
package's ``telemetry/`` (``ledger.py``) comes with the port's benchmark.
"""
from .artifacts import ARTIFACT_SCHEMA_VERSION, stamp, write  # noqa: F401
from .config import TelemetryConfig, config, config_snapshot, configure  # noqa: F401
from .histogram import (  # noqa: F401
    HISTOGRAM_SCHEMA_VERSION,
    LatencyHistogram,
    apply_delta,
)
from .registry import (  # noqa: F401
    CATALOG,
    REGISTRY_SCHEMA_VERSION,
    MetricSpec,
    Registry,
    mon_ewma,
    monitoring_enabled,
    registry,
)
from .throughput import (  # noqa: F401
    THROUGHPUT_SCHEMA_VERSION,
    ThroughputModel,
    operator_fingerprint,
    reset_model,
)
from .throughput import model as throughput_model  # noqa: F401
from . import comms, commsmatrix, profile  # noqa: F401
from .comms import (  # noqa: F401
    COMM_KINDS,
    case_probe_solve,
    cg_comms_profile,
    lowering_cases,
    observed_comms,
    reconcile,
)
from .profile import (  # noqa: F401
    PHASE_BOUNDARY,
    PHASE_SCHEMA_VERSION,
    PHASE_SUM_BAND,
    PHASE_SUM_BAND_WIDE,
    PHASES,
    capture_phase_profile,
    lowering_descriptor,
    phase_case_name,
    phase_case_of,
    phase_trace_events,
    profile_phases,
    reconcile_phases,
    render_phase_profile,
)
from .commsmatrix import (  # noqa: F401
    COMMS_MATRIX_SCHEMA_VERSION,
    classify_edge,
    fabric_summary,
    fit_fabric_model,
    measure_comms_matrix,
    reconcile_matrix,
    render_comms_matrix,
    static_matrix,
)
from .metrics import bump  # noqa: F401
from .metrics import get as counter  # noqa: F401
from .metrics import reset as reset_counters  # noqa: F401
from .metrics import snapshot as counters  # noqa: F401
from .record import (  # noqa: F401
    RECORD_SCHEMA_VERSION,
    InfoDict,
    SolveRecord,
    TelemetryEvent,
    begin_record,
    clear_history,
    current_record,
    emit_event,
    last_record,
    list_persisted_records,
    load_record,
    metrics_dir,
    record_history,
    solve_scope,
    telemetry_enabled,
)
from .trace import (  # noqa: F401
    TRACE_SCHEMA_VERSION,
    annotate,
    chrome_trace,
    record_trace_events,
    write_chrome_trace,
)
from . import spectrum  # noqa: F401
from .spectrum import (  # noqa: F401
    ANOMALY_KINDS,
    SPECTRUM_SCHEMA_VERSION,
    SSTEP_MAX,
    SpectrumStore,
    check_deadline_feasible,
    detect_anomalies,
    estimate_solve,
    lanczos_tridiagonal,
    measured_rate,
    observe_solve,
    poisson_fdm_analytic_extremes,
    predict_iters,
    reset_store,
    residual_norm,
    ritz_values,
    spec_admit_enabled,
    spec_enabled,
    spectrum_fingerprint,
    sstep_stability_limit,
    suggest_s,
)
from .spectrum import store as spectrum_store  # noqa: F401
from . import tracing  # noqa: F401
from .tracing import (  # noqa: F401
    SPAN_KINDS,
    TX_SCHEMA_VERSION,
    Span,
    TraceContext,
    mint_trace,
    mount_phase_spans,
    parse_traceparent,
    start_span,
    tracing_enabled,
    verify_trace,
)


def reset_state() -> None:
    """Drop every piece of process-wide telemetry state: the registry's
    metrics, the finished-record ring, the recorded spans, the throughput
    model and the spectrum store (tests scope a run with it and
    `configure`)."""
    registry().reset()
    clear_history()
    tracing.clear_spans()
    reset_model()
    reset_store()


__all__ = [
    "COMM_KINDS", "COMMS_MATRIX_SCHEMA_VERSION", "PHASES", "PHASE_BOUNDARY", "PHASE_SCHEMA_VERSION",
    "PHASE_SUM_BAND", "PHASE_SUM_BAND_WIDE", "capture_phase_profile", "case_probe_solve", "cg_comms_profile",
    "classify_edge", "comms", "commsmatrix", "fabric_summary", "fit_fabric_model", "lowering_cases",
    "lowering_descriptor", "measure_comms_matrix", "mount_phase_spans", "observed_comms", "phase_case_name",
    "phase_case_of", "phase_trace_events", "profile", "profile_phases", "reconcile", "reconcile_matrix",
    "reconcile_phases", "render_comms_matrix", "render_phase_profile", "static_matrix",
    "ANOMALY_KINDS", "ARTIFACT_SCHEMA_VERSION", "CATALOG", "HISTOGRAM_SCHEMA_VERSION", "InfoDict",
    "LatencyHistogram", "MetricSpec", "RECORD_SCHEMA_VERSION", "REGISTRY_SCHEMA_VERSION", "Registry",
    "SPAN_KINDS", "SPECTRUM_SCHEMA_VERSION", "SSTEP_MAX", "SolveRecord", "Span", "SpectrumStore",
    "THROUGHPUT_SCHEMA_VERSION", "TRACE_SCHEMA_VERSION", "TX_SCHEMA_VERSION", "TelemetryConfig",
    "TelemetryEvent", "ThroughputModel", "TraceContext", "annotate", "apply_delta", "begin_record", "bump",
    "check_deadline_feasible", "chrome_trace", "clear_history", "config", "config_snapshot", "configure",
    "counter", "counters", "current_record", "detect_anomalies", "emit_event", "estimate_solve",
    "lanczos_tridiagonal", "last_record", "list_persisted_records", "load_record", "measured_rate",
    "metrics_dir", "mint_trace", "mon_ewma", "monitoring_enabled", "observe_solve", "operator_fingerprint",
    "parse_traceparent", "poisson_fdm_analytic_extremes", "predict_iters", "record_history",
    "record_trace_events", "registry", "reset_counters", "reset_model", "reset_state", "reset_store",
    "residual_norm", "ritz_values", "solve_scope", "spec_admit_enabled", "spec_enabled", "spectrum",
    "spectrum_fingerprint", "spectrum_store", "sstep_stability_limit", "stamp", "start_span", "suggest_s",
    "telemetry_enabled", "throughput_model", "tracing", "tracing_enabled", "verify_trace", "write",
    "write_chrome_trace",
]
