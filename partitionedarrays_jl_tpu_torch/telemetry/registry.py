"""The typed process-wide metric registry (telemetry/registry.py of the JAX
package).

Counters (monotonic), gauges (set/inc/dec) and histograms
(`telemetry.histogram.LatencyHistogram`: fixed buckets, mergeable,
deterministic), all behind ONE lock, with JSON and Prometheus-text
exporters and the declared `CATALOG` of every metric the package bumps
(the JAX package's names, descriptions, kinds and labels; ``where`` names
the port's module).

* **One lock.** `Registry.lock` serializes every mutation: counters,
  gauges, histogram observations and the finished-record ring of
  `record.py` (the service's worker thread and the submitting thread both
  mutate them).
* **Counters are always on.** Histograms and gauges of the service path
  are gated by the config's ``mon`` (the JAX package's ``PA_MON``);
  ``metrics`` (``PA_METRICS``) switches the record and event layer only.
* **Nothing reaches the device.** The registry is host-side Python: a
  solve launches the same kernels with it on or off.

The front door (``gate.*``, ``journal.*``, ``fleet.*``) counts into the
catalog's rows; the elastic layer's rows (``elastic.*``) wait for its
port.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, Optional, Tuple

from ..utils.locksan import sanitized
from .config import config
from .histogram import LatencyHistogram

__all__ = [
    "REGISTRY_SCHEMA_VERSION",
    "CATALOG",
    "MetricSpec",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry",
    "monitoring_enabled",
    "mon_ewma",
]

REGISTRY_SCHEMA_VERSION = 1


def monitoring_enabled() -> bool:
    """The config's ``mon``: gates histogram and gauge instrumentation and
    throughput-model updates (not counters, not the record layer)."""
    return bool(config().mon)


def mon_ewma() -> float:
    """The config's ``mon_ewma``, in (0, 1]."""
    return float(config().mon_ewma)


class MetricSpec:
    """One catalog row: the reviewed identity of a declared metric."""

    __slots__ = ("name", "kind", "unit", "labels", "where", "desc")

    def __init__(self, name: str, kind: str, unit: str, where: str,
                 desc: str, labels: Tuple[str, ...] = ()):
        assert kind in ("counter", "gauge", "histogram"), kind
        self.name = name
        self.kind = kind
        self.unit = unit
        self.labels = tuple(labels)
        self.where = where
        self.desc = desc


def _spec(name, kind, unit, where, desc, labels=()):
    return MetricSpec(name, kind, unit, where, desc, labels)


#: The declared metric surface (the JAX package's catalog). ``events.*``
#: is the one wildcard family: one counter per telemetry event kind.
CATALOG: Dict[str, MetricSpec] = {
    s.name: s
    for s in [
        # -- cache/event counters ------------------------------------
        _spec("lowering_cache.hit", "counter", "1",
              "parallel/gpu.py:device_matrix",
              "per-matrix staging cache hit"),
        _spec("lowering_cache.miss", "counter", "1",
              "parallel/gpu.py:device_matrix",
              "first staging of a matrix onto a backend"),
        _spec("lowering_cache.stale_rekey", "counter", "1",
              "parallel/gpu.py:device_matrix",
              "staging re-run because a lowering env flag flipped"),
        _spec("program_cache.hit", "counter", "1",
              "parallel/gpu.py:_krylov_fn_for",
              "compiled-program cache hit on a DeviceMatrix"),
        _spec("program_cache.miss", "counter", "1",
              "parallel/gpu.py:_krylov_fn_for",
              "compiled-program cache miss (build + compile)"),
        _spec("persistent_cache.hit", "counter", "1",
              "not ported: no persistent compilation cache",
              "JAX on-disk XLA executable cache hit (jax.monitoring)"),
        _spec("persistent_cache.miss", "counter", "1",
              "not ported: no persistent compilation cache",
              "JAX on-disk XLA executable cache miss"),
        _spec("events.*", "counter", "1",
              "telemetry/record.py:emit_event",
              "one counter per telemetry event kind emitted"),
        # -- service lifecycle counters -------------------------------
        _spec("service.admitted", "counter", "1",
              "service/service.py:submit",
              "requests admitted past the bounded queue"),
        _spec("service.rejected", "counter", "1",
              "service/admission.py:AdmissionRejected",
              "typed admission backpressure, split by reason "
              "(queue_full or draining) — load shedding counts under "
              "gate.shed, never here",
              labels=("reason",)),
        _spec("service.completed", "counter", "1",
              "service/service.py:_finish",
              "requests resolved with a result"),
        _spec("service.failed", "counter", "1",
              "service/service.py:_fail",
              "requests terminated with a typed error"),
        _spec("service.ejected", "counter", "1",
              "service/service.py:_eject",
              "poisoned columns ejected from a shared slab"),
        _spec("service.retried_solo", "counter", "1",
              "service/service.py:_eject",
              "ejected requests healed by a solo retry"),
        _spec("service.deadline_expired", "counter", "1",
              "service/service.py:_expire",
              "requests failed typed at a chunk boundary past deadline"),
        _spec("service.checkpointed", "counter", "1",
              "service/service.py:_checkpoint",
              "in-flight iterates checkpointed by a non-drain shutdown"),
        _spec("service.suspended", "counter", "1",
              "service/service.py:_suspend",
              "never-started requests suspended by a non-drain shutdown"),
        _spec("service.slabs", "counter", "1",
              "service/service.py:_run_slab",
              "slabs formed (top-up re-formations extend an existing "
              "slab and are not re-counted)"),
        _spec("service.slabs_ragged", "counter", "1",
              "service/service.py:_run_slab",
              "slabs narrower than kmax (ragged leftovers)"),
        # -- service gauges (PA_MON-gated) ----------------------------
        _spec("service.queue_depth", "gauge", "requests",
              "service/service.py:submit/_pop_slab",
              "queued requests right now"),
        _spec("service.inflight_slabs", "gauge", "slabs",
              "service/service.py:_run_slab",
              "slabs currently executing"),
        _spec("service.slab_utilization", "gauge", "fraction",
              "service/service.py:_run_slab",
              "K-used / kmax of the most recent slab"),
        _spec("service.ragged_fraction", "gauge", "fraction",
              "service/service.py:_run_slab",
              "cumulative slabs_ragged / slabs"),
        # -- service latency histograms (PA_MON-gated) ----------------
        _spec("service.queue_wait_s", "histogram", "s",
              "service/service.py:_run_slab",
              "submit -> slab formation wait per request"),
        _spec("service.slab_wait_s", "histogram", "s",
              "service/service.py:_run_slab",
              "slab formation -> block-solve dispatch per slab"),
        _spec("service.solve_s", "histogram", "s",
              "service/service.py:_run_slab",
              "block-solve wall per slab chunk"),
        _spec("service.total_s", "histogram", "s",
              "service/service.py:_finish/_fail",
              "submit -> terminal state per request"),
        _spec("service.deadline_slack_s", "histogram", "s",
              "service/service.py:_slo_account",
              "deadline minus elapsed at terminal state (met deadlines; "
              "clamped at 0 for missed ones)"),
        # -- SLO accounting (labeled by tolerance class) --------------
        _spec("service.slo.requests", "counter", "1",
              "service/service.py:_slo_account",
              "deadline-carrying requests reaching a terminal state",
              labels=("tol_class",)),
        _spec("service.slo.hits", "counter", "1",
              "service/service.py:_slo_account",
              "deadline-carrying requests that finished within deadline",
              labels=("tol_class",)),
        # -- the front door (pagate) ----------------------------------
        _spec("gate.shed", "counter", "1",
              "frontdoor/scheduler.py:LoadShedded",
              "requests refused by SLO-class load shedding (typed "
              "LoadShedded with Retry-After — distinct from the "
              "queue-full/draining service.rejected reasons)",
              labels=("slo_class",)),
        _spec("gate.budget_rejected", "counter", "1",
              "frontdoor/tenancy.py:TenantBudgetError",
              "operator registrations refused because the footprint "
              "exceeds PA_GATE_MEM_BUDGET outright"),
        _spec("gate.evictions", "counter", "1",
              "frontdoor/tenancy.py:evict",
              "tenants paged out (in-flight slabs drained via the "
              "checkpoint path, device buffers dropped)"),
        _spec("gate.page_ins", "counter", "1",
              "frontdoor/tenancy.py:_page_in",
              "tenants made resident (registration or re-stage after "
              "an eviction)"),
        _spec("gate.slo.requests", "counter", "1",
              "frontdoor/scheduler.py:account",
              "gate requests reaching a terminal state, per SLO class",
              labels=("slo_class",)),
        _spec("gate.slo.hits", "counter", "1",
              "frontdoor/scheduler.py:account",
              "gate requests that resolved (done — deadline misses "
              "fail typed and do not count), per SLO class",
              labels=("slo_class",)),
        _spec("gate.queue_depth", "gauge", "requests",
              "frontdoor/scheduler.py:submit/pump",
              "requests in the cross-tenant EDF queue right now"),
        _spec("gate.resident_bytes", "gauge", "bytes",
              "frontdoor/tenancy.py:_update_gauges",
              "sum of resident tenants' static footprints"),
        _spec("gate.mem_budget_bytes", "gauge", "bytes",
              "frontdoor/tenancy.py:_update_gauges",
              "the PA_GATE_MEM_BUDGET bound (0 = unbounded)"),
        _spec("gate.tenant_resident", "gauge", "1",
              "frontdoor/tenancy.py:_update_gauges",
              "1 while the tenant is resident, 0 while evicted",
              labels=("tenant",)),
        _spec("gate.tenant_footprint_bytes", "gauge", "bytes",
              "frontdoor/tenancy.py:_update_gauges",
              "the tenant's declared static footprint",
              labels=("tenant",)),
        # -- durability: write-ahead journal + recovery ----------------
        _spec("journal.appends", "counter", "1",
              "frontdoor/journal.py:append",
              "request lifecycle records appended (fsync'd before the "
              "transition is acknowledged to the client)"),
        _spec("journal.rotations", "counter", "1",
              "frontdoor/journal.py:_rotate",
              "journal segments rotated (close + fsync + publish)"),
        _spec("journal.truncated", "counter", "1",
              "frontdoor/journal.py:_truncate_tail",
              "torn tail records truncated at replay (the expected "
              "crash artifact — mid-file corruption raises typed "
              "JournalCorruptError instead)"),
        _spec("gate.idempotent_hits", "counter", "1",
              "frontdoor/scheduler.py:submit",
              "submits answered from an existing idempotency key — "
              "the original id/result served, no second solve"),
        _spec("gate.recovered", "counter", "1",
              "frontdoor/scheduler.py:recover",
              "journaled requests replayed at recovery, by outcome "
              "(completed/failed served from the record, resumed from "
              "a checkpointed iterate, requeued from the original "
              "payload, expired typed)",
              labels=("outcome",)),
        # -- distributed tracing --------------------------------------
        _spec("tx.spans", "counter", "1",
              "telemetry/tracing.py:start_span",
              "spans captured by the patx tracing plane (PA_TX=0 "
              "stops capture and this counter with it)"),
        _spec("gate.traceparent_invalid", "counter", "1",
              "frontdoor/rpc.py:do_POST",
              "malformed W3C traceparent headers on POST /v1/solve — "
              "refused at parse, a fresh trace minted instead (a "
              "hostile header can never 500 a submit)"),
        # -- convergence observatory ----------------------------------
        _spec("spec.predictions", "counter", "1",
              "service/service.py:submit",
              "requests admitted with an iterations-to-tolerance "
              "forecast stamped on their record (the operator was "
              "spectrally measured at submit)"),
        _spec("spec.infeasible", "counter", "1",
              "telemetry/spectrum.py:check_deadline_feasible",
              "deadline-carrying requests refused typed at admission "
              "because the forecast cost exceeds the deadline "
              "(PA_SPEC_ADMIT=1; DeadlineInfeasible — distinct from "
              "deadline expiry, queue-full, and load shedding)"),
        _spec("spec.anomalies", "counter", "1",
              "telemetry/spectrum.py:observe_solve",
              "convergence anomalies detected post-solve over the "
              "residual trajectory and Ritz drift",
              labels=("kind",)),
        _spec("spec.iters_rel_error", "histogram", "fraction",
              "service/service.py:_slo_account",
              "per-request |predicted - actual| / actual iteration "
              "forecast error, labeled by tenant (operator fingerprint "
              "for unnamed services) — the pamon --conv feed",
              labels=("tenant",)),
        # -- gate fleet -----------------------------------------------
        _spec("fleet.forwarded", "counter", "1",
              "frontdoor/rpc.py:do_POST",
              "shed submits 307-redirected to a peer replica with "
              "headroom instead of 429 backoff (the peer admits the "
              "identical body: same idempotency key, same trace)"),
        _spec("fleet.adopted", "counter", "1",
              "frontdoor/scheduler.py:adopt",
              "a dead peer's journaled requests adopted by this "
              "survivor, by outcome (same keys as gate.recovered, "
              "plus skipped for already-adopted/unservable rids)",
              labels=("outcome",)),
        _spec("fleet.lease_missed", "counter", "1",
              "frontdoor/fleet.py:check_peers",
              "peer replicas declared dead after a stale lease "
              "(> 3x PA_FLEET_LEASE_S) — each increments once and "
              "triggers journal adoption by the ranked survivor"),
        _spec("journal.pruned", "counter", "1",
              "frontdoor/journal.py:prune",
              "journal segment files unlinked by retention "
              "(PA_GATE_JOURNAL_KEEP) — only epochs at or behind the "
              "recovered frontier; otherwise typed "
              "JournalRetentionError and nothing is dropped"),
        _spec("elastic.shrink", "counter", "1",
              "parallel/elastic.py:shrink_system",
              "elastic degraded-mode shrinks: the system was migrated "
              "onto a smaller survivor part grid (PA_ELASTIC=1) — one "
              "increment per shrink, labelled by what forced it",
              labels=("reason",)),
        _spec("elastic.crosspart_restores", "counter", "1",
              "parallel/checkpoint.py:load_solver_state",
              "solver-state checkpoints restored onto a DIFFERENT part "
              "count than they were written at (allowed only under "
              "PA_ELASTIC=1; otherwise typed CheckpointShapeError)"),
    ]
}


def _labels_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic named counter (one label set)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self.value += int(n)
            return self.value


class Gauge:
    """Last-value gauge with inc/dec."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> float:
        with self._lock:
            self.value += float(n)
            return self.value

    def dec(self, n: float = 1.0) -> float:
        return self.inc(-n)


class Histogram:
    """A registry-held `LatencyHistogram` (shared lock)."""

    __slots__ = ("_lock", "hist")

    def __init__(self, lock):
        self._lock = lock
        self.hist = LatencyHistogram()

    def observe(self, v: float) -> None:
        with self._lock:
            self.hist.observe(v)

    @property
    def count(self) -> int:
        return self.hist.total

    def quantile(self, q: float):
        with self._lock:
            return self.hist.quantile(q)

    def snapshot(self) -> dict:
        with self._lock:
            return self.hist.snapshot()


class Registry:
    """The typed metric registry (see module docstring). Metrics are
    created on first touch; a declared name must be touched with its
    declared kind (a `lowering_cache.hit` gauge is a bug, not a new
    metric)."""

    def __init__(self):
        #: THE lock: every registry mutation AND the telemetry history
        #: ring (record.py) serialize on it.
        self.lock = sanitized(threading.RLock(), "Registry.lock")
        self._metrics: Dict[Tuple[str, tuple], object] = {}

    # -- creation / access ----------------------------------------------
    def _get(self, name: str, labels: Optional[dict], cls):
        kind = {Counter: "counter", Gauge: "gauge",
                Histogram: "histogram"}[cls]
        spec = CATALOG.get(name) or (
            CATALOG.get("events.*") if name.startswith("events.") else None
        )
        if spec is not None and spec.kind != kind:
            raise TypeError(
                f"metric {name!r} is declared a {spec.kind}, not a {kind}"
            )
        key = (name, _labels_key(labels))
        with self.lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(self.lock)
            return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get(name, labels, Histogram)

    # -- reading ---------------------------------------------------------
    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> int:
        with self.lock:
            m = self._metrics.get((name, _labels_key(labels)))
        return m.value if isinstance(m, Counter) else 0

    def snapshot(self, prefix: Optional[str] = None) -> dict:
        """One JSON-safe dict of everything (optionally name-filtered).
        Deterministic ordering, no wall-clock fields."""
        with self.lock:
            items = sorted(
                (k, m) for k, m in self._metrics.items()
                if prefix is None or k[0].startswith(prefix)
            )
            out: dict = {
                "registry_schema_version": REGISTRY_SCHEMA_VERSION,
                "counters": {},
                "gauges": {},
                "histograms": {},
            }
            for (name, lk), m in items:
                full = name if not lk else (
                    name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"
                )
                if isinstance(m, Counter):
                    out["counters"][full] = m.value
                elif isinstance(m, Gauge):
                    out["gauges"][full] = m.value
                else:
                    out["histograms"][full] = m.hist.snapshot()
            return out

    def to_json(self, prefix: Optional[str] = None) -> str:
        return json.dumps(self.snapshot(prefix), sort_keys=True, indent=1)

    def to_prometheus(self) -> str:
        """Prometheus text exposition: dotted names become
        ``pa_``-prefixed underscore names; histograms render cumulative
        ``le`` buckets + ``_sum``/``_count`` per convention (every
        series of one labeled histogram carries the IDENTICAL escaped
        label set). Label values are escaped per the exposition format
        (backslash, double quote, newline) — a hostile tol-class or
        request tag can no longer corrupt the scrape."""
        from .histogram import BUCKET_BOUNDS

        lines = []
        typed = set()

        def pname(name):
            return "pa_" + name.replace(".", "_").replace("*", "all")

        def esc(v):
            return (
                str(v)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def plabels(lk, extra=None):
            parts = [f'{k}="{esc(v)}"' for k, v in lk]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        # render UNDER the lock: a histogram observed mid-scrape must
        # not emit le-buckets disagreeing with its _count/_sum (the
        # torn-read class the one-lock contract exists to close)
        with self.lock:
            for (name, lk), m in sorted(self._metrics.items()):
                pn = pname(name)
                kind = (
                    "counter" if isinstance(m, Counter)
                    else "gauge" if isinstance(m, Gauge)
                    else "histogram"
                )
                if pn not in typed:
                    spec = CATALOG.get(name)
                    if spec is not None:
                        desc = spec.desc.replace("\\", "\\\\").replace(
                            "\n", "\\n"
                        )
                        lines.append(f"# HELP {pn} {desc}")
                    lines.append(f"# TYPE {pn} {kind}")
                    typed.add(pn)
                if isinstance(m, Counter):
                    lines.append(f"{pn}{plabels(lk)} {m.value}")
                elif isinstance(m, Gauge):
                    lines.append(f"{pn}{plabels(lk)} {m.value:g}")
                else:
                    cum = 0
                    for i, edge in enumerate(BUCKET_BOUNDS):
                        cum += m.hist.counts[i]
                        le = 'le="%g"' % edge
                        lines.append(
                            f"{pn}_bucket{plabels(lk, le)} {cum}"
                        )
                    cum += m.hist.counts[len(BUCKET_BOUNDS)]
                    inf = 'le="+Inf"'
                    lines.append(f"{pn}_bucket{plabels(lk, inf)} {cum}")
                    lines.append(f"{pn}_sum{plabels(lk)} {m.hist.sum:g}")
                    lines.append(
                        f"{pn}_count{plabels(lk)} {m.hist.total}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    # -- maintenance -----------------------------------------------------
    def reset(self, prefix: Optional[str] = None) -> None:
        with self.lock:
            if prefix is None:
                self._metrics.clear()
            else:
                for k in [k for k in self._metrics
                          if k[0].startswith(prefix)]:
                    del self._metrics[k]

    def names(self) -> Iterable[str]:
        with self.lock:
            return sorted({k[0] for k in self._metrics})


#: THE process-wide registry instance.
_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY
