"""The telemetry layer's switches: one frozen config object, set through one
function.

The JAX package reads its telemetry switches from the environment at every
call (``PA_METRICS``, ``PA_METRICS_DIR``, ``PA_METRICS_HISTORY``,
``PA_MON``, ``PA_MON_EWMA``, ``PA_TX``, ``PA_TX_DIR``, ``PA_SPEC``,
``PA_SPEC_ADMIT``, ``PA_LOCK_CHECK``, ``PA_PROF``, ``PA_PROF_REPS``,
``PA_PROF_TRACE``); the port reads no environment. They
are the fields of `TelemetryConfig`, with the JAX package's defaults, and
`configure` replaces the process's config:

    prev = telemetry.configure(metrics=False)   # returns the previous config
    with telemetry.configure(spec_admit=True):  # ... or scopes the change
        ...

A config is a context manager whose exit makes it current again, so the
config `configure` returns restores itself when a ``with`` block ends.
``drift_factor`` is the κ̂ drift factor of `spectrum.detect_anomalies`
(the JAX package's module constant ``KAPPA_DRIFT_FACTOR``). The trace-ring
depth (``PA_TRACE_ITERS``) is the ``trace_iters=`` keyword of the solvers,
and the service's ``PA_SERVE_*`` knobs are `SolveService` arguments.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

__all__ = ["TelemetryConfig", "configure", "config", "config_snapshot"]


@dataclass(frozen=True)
class TelemetryConfig:
    """The telemetry switches (see the module docstring for the JAX
    package's names)."""

    metrics: bool = True  # record keeping and event emission (PA_METRICS)
    metrics_dir: Optional[str] = None  # persist finished records here (PA_METRICS_DIR)
    history: int = 16  # depth of the finished-record ring (PA_METRICS_HISTORY)
    mon: bool = True  # histograms, gauges, throughput updates (PA_MON)
    mon_ewma: float = 0.25  # EWMA factor of the throughput and spectrum models (PA_MON_EWMA)
    tracing: bool = True  # span capture (PA_TX)
    tracing_dir: Optional[str] = None  # span JSONL directory (PA_TX_DIR)
    spec: bool = True  # host-side spectral estimation (PA_SPEC)
    spec_admit: bool = False  # deadline-feasibility admission (PA_SPEC_ADMIT)
    drift_factor: float = 4.0  # κ̂ drift flagged as precond_degradation (KAPPA_DRIFT_FACTOR)
    lock_check: bool = False  # the lock-order sanitizer (PA_LOCK_CHECK)
    prof: bool = True  # phase-profile capture (PA_PROF)
    prof_reps: int = 5  # timed repetitions a chain measurement (PA_PROF_REPS)
    prof_trace: object = "auto"  # the profiler trace: True, False or "auto" (PA_PROF_TRACE 1, 0, auto)

    def __post_init__(self):
        if int(self.history) < 1:
            raise ValueError("TelemetryConfig: history must be >= 1")
        if not 0.0 < float(self.mon_ewma) <= 1.0:
            raise ValueError("TelemetryConfig: mon_ewma must lie in (0, 1]")
        if int(self.prof_reps) < 3:
            raise ValueError("TelemetryConfig: prof_reps must be >= 3 (a chain takes the least of its repetitions)")
        if self.prof_trace not in (True, False, "auto"):
            raise ValueError("TelemetryConfig: prof_trace is True, False or 'auto'")

    def __enter__(self) -> "TelemetryConfig":
        return self

    def __exit__(self, *exc) -> bool:
        _set(self)
        return False


_lock = threading.Lock()
_current = TelemetryConfig()


def _set(cfg: TelemetryConfig) -> None:
    global _current
    with _lock:
        _current = cfg


def config() -> TelemetryConfig:
    """The process's current telemetry config."""
    return _current


def configure(**fields) -> TelemetryConfig:
    """Replace the named fields of the current config; returns the previous
    config, which as a context manager restores itself on exit."""
    global _current
    with _lock:
        prev = _current
        _current = dataclasses.replace(prev, **fields)
    return prev


def config_snapshot() -> dict:
    """The current config as a JSON-safe dict (a record's configuration
    snapshot, the JAX package's ``PA_*`` environment snapshot)."""
    return dataclasses.asdict(_current)
