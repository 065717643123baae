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
* `telemetry.config` — the switches, one frozen `TelemetryConfig` set by
  `configure` (the JAX package reads them from ``PA_*`` environment
  variables; the port reads no environment).

Telemetry off costs the device nothing: every switch is host-side, and the
α/β trace ring of the CG loops is the solvers' ``trace_iters=`` keyword
(0, the default, launches exactly what the loop launched without it). The
comms accounting, the phase profile and the ledger of the JAX package's
``telemetry/`` are still to port.
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
