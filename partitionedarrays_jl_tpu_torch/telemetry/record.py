"""Typed solve records: the structured successor of the ``info`` dict
(telemetry/record.py of the JAX package, on its JSON schema: a record
persisted by either package loads in the other).

Every solve (host or device loop) runs inside a `SolveRecord`: a config
snapshot (the solve's keywords and the telemetry config), the residual
trajectory, the α/β trace of the CG recurrence (the device trace ring,
``trace_iters=``, or the host loop's own), a structured event log (health
guards, fault injections, SDC detections and rollbacks, checkpoint save
and restore, lowering and solve-function cache hits and misses, recovery
restarts), per-section timings.

The ``info`` dict stays the return contract: solvers return
``InfoDict(info, record=rec)``, a plain ``dict`` subclass with the typed
record one attribute away (``info.record``).

Scoping: records nest (``solve_with_recovery`` wraps the records of its
attempts) and `emit_event` appends to every active record, so the outer
record sees the whole story. A record is finalized once: on `finish`
(success) or by `solve_scope` on an exception (the aborted record keeps
its events in the history ring).

The solve service (`service.SolveService`) opens one ``"service-request"``
record per admitted request, active from admission to its terminal state,
so the queue, slab and ejection events (``request_queued``,
``slab_formed``, ``column_verdict``, ``column_ejected``,
``deadline_expired``, ``request_done`` / ``request_failed`` /
``request_checkpointed`` / ``request_suspended``) and the slab solves' own
events all land in it.

Switches (`telemetry.configure`; none reaches a device loop): ``metrics``
(the JAX package's ``PA_METRICS``: off, records are inert and nothing is
kept), ``metrics_dir`` (``PA_METRICS_DIR``: persist every finished record
there as one JSON file) and ``history`` (``PA_METRICS_HISTORY``, the depth
of the finished-record ring).
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import metrics, tracing
from .config import config, config_snapshot
from .registry import registry

__all__ = [
    "RECORD_SCHEMA_VERSION",
    "TelemetryEvent",
    "SolveRecord",
    "InfoDict",
    "telemetry_enabled",
    "metrics_dir",
    "history_depth",
    "begin_record",
    "emit_event",
    "current_record",
    "last_record",
    "record_history",
    "clear_history",
    "solve_scope",
    "load_record",
    "list_persisted_records",
]

#: Schema version of the persisted SolveRecord JSON (bumped on any
#: backward-incompatible field change; `tools/patrace.py` checks it).
RECORD_SCHEMA_VERSION = 1


def telemetry_enabled() -> bool:
    return bool(config().metrics)


def metrics_dir() -> Optional[str]:
    return config().metrics_dir or None


def history_depth() -> int:
    return max(1, int(config().history))


def _jsonable(v: Any) -> Any:
    """Best-effort conversion to JSON-serializable values (numpy
    scalars/arrays, tuples, sets); unknown objects become repr strings —
    a record write must never fail a solve."""
    import numpy as np

    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    return repr(v)


@dataclass
class TelemetryEvent:
    """One structured event in a solve's life: ``kind`` is the stable
    machine key (``fault_injected``, ``health_error``, ``sdc_detection``,
    ``sdc_rollback``, ``checkpoint_save``, ``checkpoint_restore``,
    ``compile_cache``, ``restart``, ...), ``label`` a short human tag,
    ``iteration`` the solver iteration when known, ``t`` seconds since
    the record began, ``details`` free-form JSON-safe payload."""

    kind: str
    label: str = ""
    iteration: Optional[int] = None
    t: float = 0.0
    details: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "label": self.label,
            "iteration": self.iteration,
            "t": self.t,
            "details": _jsonable(self.details),
        }


class InfoDict(dict):
    """The backward-compat view: a plain dict (every legacy consumer
    keeps indexing/mutating it) carrying its typed record."""

    def __init__(self, data: dict, record: "SolveRecord"):
        super().__init__(data)
        self.record = record


class SolveRecord:
    """One solve's telemetry. Create via `begin_record` / `solve_scope`
    so the active-record stack stays consistent."""

    def __init__(self, solver: str, config: Optional[dict] = None,
                 enabled: Optional[bool] = None):
        self.schema_version = RECORD_SCHEMA_VERSION
        self.solver = solver
        self.enabled = telemetry_enabled() if enabled is None else enabled
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self.config: Dict[str, Any] = {
            "telemetry_config": config_snapshot() if self.enabled else {},
        }
        if config:
            self.config.update(config)
        self.events: List[TelemetryEvent] = []
        #: Tracing context (``{"trace_id", "span_id"}``) stamped from the
        #: thread's ambient span (`telemetry.tracing`): the join key
        #: between this record and the span tree.
        self.trace: Optional[Dict[str, str]] = None
        if self.enabled:
            ctx = tracing.current_ctx()
            if ctx is not None:
                self.trace = {
                    "trace_id": ctx.trace_id, "span_id": ctx.span_id,
                }
        self.iterations: Optional[int] = None
        self.converged: Optional[bool] = None
        self.status: Optional[str] = None
        self.residuals: Optional[List[float]] = None
        # scalar solves: flat List[float]; block solves: one
        # List[float] per column. The device ring keeps the LAST
        # trace_iters iterations: alpha[j]/beta[j] belong to absolute
        # iteration trace_start + j.
        self.alpha: Optional[List[Any]] = None
        self.beta: Optional[List[Any]] = None
        self.trace_start: int = 0
        self.comms: Optional[dict] = None
        # the counted program of the solve function that ran
        # (``fn.comms_counted``), beside the model in ``comms``: the pair
        # `telemetry.comms.reconcile` compares; in memory only
        self.comms_counted: Optional[dict] = None
        self.timings: Dict[str, float] = {}
        self.error: Optional[dict] = None
        self.wall_s: Optional[float] = None
        self.finished = False

    # -- event log -------------------------------------------------------
    def event(self, kind: str, label: str = "",
              iteration: Optional[int] = None, **details) -> None:
        # enabled is immutable after construction: keep the inert-record
        # path free (no allocation, no clock read, no lock)
        if not self.enabled or self.finished:
            return
        ev = TelemetryEvent(
            kind=kind, label=label,
            iteration=None if iteration is None else int(iteration),
            t=time.perf_counter() - self._t0, details=details,
        )
        # append under the shared registry lock: the service worker and
        # the submitting thread both emit into the same active records
        # (finished re-checked — a race with finish() must not append
        # to a retired record)
        with registry().lock:
            if self.finished:
                return
            self.events.append(ev)

    def events_of(self, kind: str) -> List[TelemetryEvent]:
        # snapshot under the registry lock: the worker may still be
        # appending while a reader filters
        with registry().lock:
            events = list(self.events)
        return [e for e in events if e.kind == kind]

    # -- finalization ----------------------------------------------------
    def _absorb_info(self, info: Optional[dict]) -> None:
        if not info:
            return
        import numpy as np

        if "iterations" in info:
            self.iterations = int(info["iterations"])
        if "converged" in info:
            self.converged = bool(info["converged"])
        if "status" in info:
            self.status = str(info["status"])
        res = info.get("residuals")
        if res is not None:
            self.residuals = [float(v) for v in np.asarray(res).ravel()[:4096]]

    def finish(self, info: Optional[dict] = None) -> InfoDict:
        """Finalize: absorb the legacy info dict, close the clock,
        archive into the history ring (and ``metrics_dir``), and
        return the `InfoDict` view. Idempotent-safe: a second finish
        only re-wraps."""
        if not self.finished:
            self._absorb_info(info)
            self.wall_s = time.perf_counter() - self._t0
            self.finished = True
            _retire(self)
        return InfoDict(dict(info or {}), record=self)

    def finish_error(self, exc: BaseException) -> None:
        """Finalize an aborted solve (typed failure propagating out):
        the record survives — with its event log — for post-mortems."""
        if self.finished:
            return
        self.status = "raised"
        self.error = {
            "type": type(exc).__name__,
            "message": str(exc),
            "diagnostics": _jsonable(getattr(exc, "diagnostics", {})),
        }
        self.wall_s = time.perf_counter() - self._t0
        self.finished = True
        _retire(self)

    # -- serialization ---------------------------------------------------
    def as_dict(self) -> dict:
        # events snapshot under the registry lock (same race class as
        # events_of: serializing a live record mid-append)
        with registry().lock:
            events = list(self.events)
        return {
            "schema_version": self.schema_version,
            "solver": self.solver,
            "started_at": self.started_at,
            "wall_s": self.wall_s,
            "config": _jsonable(self.config),
            "trace": self.trace,
            "iterations": self.iterations,
            "converged": self.converged,
            "status": self.status,
            "residuals": self.residuals,
            "alpha": self.alpha,
            "beta": self.beta,
            "trace_start": self.trace_start,
            "comms": _jsonable(self.comms),
            "timings": _jsonable(self.timings),
            "error": self.error,
            "events": [e.as_dict() for e in events],
        }

    def __repr__(self):
        return (
            f"SolveRecord({self.solver!r}, it={self.iterations}, "
            f"status={self.status!r}, events={len(self.events)})"
        )


# ---------------------------------------------------------------------------
# active-record stack + finished-record ring
# ---------------------------------------------------------------------------

#: The stack and ring share the registry lock (an RLock): the service's
#: worker mutates counters, records and the ring from its thread while
#: the submitting thread does the same; one lock means one ordering.
_lock = registry().lock
_stack: List[SolveRecord] = []
_history: List[SolveRecord] = []
_seq = 0


def begin_record(solver: str, **config) -> SolveRecord:
    """Open a record and push it onto the active stack. Always returns
    a record object (inert with ``metrics`` off) so call sites never
    branch."""
    rec = SolveRecord(solver, config=config)
    if rec.enabled:
        with _lock:
            _stack.append(rec)
    return rec


def _retire(rec: SolveRecord) -> None:
    with _lock:
        if rec in _stack:
            _stack.remove(rec)
        if rec.enabled:
            _history.append(rec)
            del _history[: max(0, len(_history) - history_depth())]
    if rec.enabled:
        _persist(rec)


def emit_event(kind: str, label: str = "", iteration: Optional[int] = None,
               **details) -> None:
    """Append an event to EVERY active record (outer recovery scopes see
    their inner attempts' events) and bump ``events.<kind>``. Never
    raises — telemetry must not break a solve."""
    try:
        metrics.bump(f"events.{kind}")
        if not telemetry_enabled():
            return
        # attach the ambient span context: an event fired while a span
        # is current carries its trace (the record/span join)
        ctx = tracing.current_ctx()
        if ctx is not None:
            details.setdefault("trace_id", ctx.trace_id)
            details.setdefault("span_id", ctx.span_id)
        with _lock:
            recs = list(_stack)
        for rec in recs:
            rec.event(kind, label=label, iteration=iteration, **details)
    except Exception:
        pass


def current_record() -> Optional[SolveRecord]:
    with _lock:
        return _stack[-1] if _stack else None


def last_record(solver: Optional[str] = None) -> Optional[SolveRecord]:
    """The most recent FINISHED record (optionally of one solver)."""
    with _lock:
        for rec in reversed(_history):
            if solver is None or rec.solver == solver:
                return rec
    return None


def record_history() -> List[SolveRecord]:
    with _lock:
        return list(_history)


def clear_history() -> None:
    with _lock:
        _history.clear()


@contextmanager
def solve_scope(solver: str, **config):
    """``with solve_scope("cg", tol=...) as rec:`` — opens a record; a
    raising body finalizes it as an aborted record (events retained), a
    clean body is expected to call ``rec.finish(info)`` itself (the
    scope closes it empty otherwise)."""
    rec = begin_record(solver, **config)
    try:
        yield rec
    except BaseException as e:
        emit_event(
            "solve_aborted", label=type(e).__name__,
            solver=solver, message=str(e)[:500],
        )
        rec.finish_error(e)
        raise
    else:
        if not rec.finished:
            rec.finish(None)


# ---------------------------------------------------------------------------
# persistence (metrics_dir)
# ---------------------------------------------------------------------------


def _persist(rec: SolveRecord) -> None:
    global _seq
    d = metrics_dir()
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        with _lock:
            _seq += 1
            seq = _seq
        name = f"rec-{time.time_ns():020d}-{os.getpid()}-{seq:05d}.json"
        tmp = os.path.join(d, "." + name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec.as_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(d, name))
    except Exception:
        pass  # persistence is best-effort by contract


def list_persisted_records(directory: Optional[str] = None) -> List[str]:
    """Record files in ``directory`` (default ``metrics_dir``),
    oldest first (the name embeds a monotone timestamp)."""
    d = directory or metrics_dir()
    if not d or not os.path.isdir(d):
        return []
    return sorted(
        os.path.join(d, f)
        for f in os.listdir(d)
        if f.startswith("rec-") and f.endswith(".json")
    )


def load_record(path: str) -> dict:
    """One persisted record as a dict (schema-checked loosely: a record
    from a NEWER schema loads but callers should surface the version)."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)
