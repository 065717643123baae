"""EDF deadline scheduling and SLO-class load shedding: the gate's
cross-tenant queue (frontdoor/scheduler.py of the JAX package).

The in-process `SolveService` coalesces FIFO within ONE operator; the gate
sits above N tenants and decides which tenant's batcher gets fed next. Two
policies compose here:

* **EDF admission ordering.** The gate holds one cross-tenant queue sorted
  by absolute deadline (submission clock + the request's relative
  deadline; deadline-free requests sort last, FIFO among themselves) and
  dispatches the earliest deadline first into its tenant's service. The
  measured feed is the service's deadline-slack histogram
  (``service.deadline_slack_s``) and the per-class attainment counters;
  `Gate` asserts at construction that the feed is declared in the metric
  CATALOG, so the policy can never outlive its measurement. The EDF
  invariant: completed-request order never inverts two same-tenant
  deadlines by more than one chunk boundary (exact at slab width 1).

* **SLO-class load shedding.** Requests declare a class from the config's
  ``classes`` (best-protected first; default ``interactive, batch,
  besteffort``). When the gate queue depth reaches the shed watermark
  (``shed_depth``, default 32), the LOWEST class is refused with the typed
  `LoadShedded`, carrying a measured ``retry_after_s`` (scaled from the
  live ``service.total_s`` distribution) that the HTTP surface forwards as
  ``Retry-After``, while every higher class keeps its SLO and falls through
  to the tenant's bounded-queue `AdmissionRejected`; the two overload
  behaviors stay typed and separable (``gate.shed{class=…}`` against
  ``service.rejected{reason=queue_full}``).

* **Crash durability.** With a ``journal_dir`` (or the config's
  ``journal_dir``), every lifecycle transition is written ahead to the
  `frontdoor.journal.RequestJournal` BEFORE it is acknowledged: admitted
  (with the request payload), dispatched, chunk-checkpointed (the iterate
  in the checkpoint layer's CRC'd format under the journal dir), completed
  (with the exact result), failed, shed. ``Gate.recover()`` replays the
  journal after a crash: completed requests serve their recorded results,
  in-flight requests resume from their checkpointed iterates as
  resubmissions (x0 = saved iterate, deadline clock RESUMED against wall
  time), queued-but-never-dispatched requests re-enter EDF in their
  original deadline order, and a torn tail record truncates with a typed
  event. **Idempotency keys** (``submit(idempotency_key=...)``) make
  retried submits safe: the same key returns the original request id and,
  once done, the original result bit for bit, never a second solve.
  Request ids are epoch-qualified (``r<epoch>-<n>``), so a restarted gate
  never reissues an id an old client still polls.

On the card, every device operation of a gate runs on its tenants' service
threads (or the thread that drives ``pump``/``drain`` synchronously), one
slab at a time through the card's `service.device_lock`: `submit`, the
queue, the journal and the HTTP surface keep host arrays only.
"""
from __future__ import annotations

import os
import secrets
import threading
import time as _walltime
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry import spectrum, tracing
from ..telemetry.registry import CATALOG, monitoring_enabled, registry
from ..utils.helpers import check
from ..utils.locksan import sanitized
from .journal import (
    RecoveredError,
    RequestJournal,
    journal_enabled,
    journal_env_dir,
    journal_keep,
)
from .tenancy import OperatorRegistry

__all__ = [
    "LoadShedded",
    "Gate",
    "GateHandle",
    "gate_classes",
    "shed_depth",
    "shed_classes",
]

#: Terminal handles retained for poll/idempotency lookup before the
#: oldest accounted ones are pruned (live handles are never dropped).
_MAX_HANDLES = 4096

#: The service metrics the EDF policy schedules against: their CATALOG
#: declarations are asserted at Gate construction (the measured feed
#: may not silently vanish from under the policy).
_MEASURED_FEED = (
    "service.deadline_slack_s", "service.slo.requests",
    "service.slo.hits", "service.total_s",
)


def gate_classes() -> Tuple[str, ...]:
    """The config's SLO ``classes``, best-protected first; an empty tuple
    falls back to the default triple."""
    from .config import config

    classes = tuple(c.strip() for c in config().classes if str(c).strip())
    return classes or ("interactive", "batch", "besteffort")


def shed_depth() -> int:
    """The config's ``shed_depth`` watermark (floor 1)."""
    from .config import config

    return max(1, int(config().shed_depth))


def shed_classes(depth: int, classes: Tuple[str, ...],
                 watermark: int) -> Tuple[str, ...]:
    """The classes shed at gate queue ``depth``: the LOWEST class once
    the watermark is crossed, nothing above it — higher classes keep
    their SLO and fall through to the per-tenant bounded queue's
    typed backpressure instead. A single-class configuration never
    sheds (there is no lower class to sacrifice)."""
    if depth < watermark or len(classes) < 2:
        return ()
    return (classes[-1],)


class LoadShedded(RuntimeError):
    """The gate refused a request because its SLO class is being shed
    under overload. DISTINCT from `AdmissionRejected` (queue-full /
    draining backpressure): shedding is a POLICY decision that
    sacrifices the lowest class so higher classes keep their SLO, and
    it carries a measured ``retry_after_s`` (the HTTP surface forwards
    it as ``Retry-After``). ``diagnostics``: class, queue depth,
    watermark, shed set."""

    def __init__(self, message: str, retry_after_s: float,
                 diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.diagnostics = dict(diagnostics or {})
        from ..telemetry import emit_event

        registry().counter(
            "gate.shed",
            labels={"slo_class": str(self.diagnostics.get("slo_class"))},
        ).inc()
        emit_event(
            "load_shedded",
            label=str(self.diagnostics.get("slo_class", "")),
            tag=self.diagnostics.get("tag"),
            depth=self.diagnostics.get("depth"),
            watermark=self.diagnostics.get("watermark"),
            retry_after_s=self.retry_after_s,
        )


def _edf_key(h: "GateHandle"):
    """THE queue order: absolute deadline first, deadline-free last,
    FIFO (seq) among equals — shared by fresh submissions and
    eviction requeues so the two paths can never diverge."""
    return (
        h.deadline_abs is None,
        h.deadline_abs if h.deadline_abs is not None else 0.0,
        h.seq,
    )


class GateHandle:
    """The gate-level result handle: wraps the queued entry until EDF
    dispatch assigns the tenant-level `SolveRequest`, then delegates to
    it (same vocabulary: ``state``/``done``/``result``). A handle
    recovered TERMINAL from the journal carries its recorded result
    (``_result`` — a global ndarray, not a PVector) or its replayed
    typed error instead of a live request."""

    __slots__ = ("tenant", "tag", "slo_class", "deadline_abs", "seq",
                 "kwargs", "request", "_error", "accounted", "rid",
                 "idempotency_key", "submitted_wall", "_result",
                 "journal_pending", "span_root", "span_queue", "trace")

    def __init__(self, tenant, tag, slo_class, deadline_abs, seq, kwargs,
                 rid: Optional[str] = None):
        self.tenant = tenant
        self.tag = tag
        self.slo_class = slo_class
        #: Absolute service-clock deadline (None = no deadline) — the
        #: EDF sort key.
        self.deadline_abs = deadline_abs
        self.seq = seq
        self.kwargs = kwargs
        self.request = None  # SolveRequest once dispatched
        self._error: Optional[BaseException] = None
        self.accounted = False
        #: Epoch-qualified request id (``r<epoch>-<n>``): collision-safe
        #: across gate restarts — the RPC store keys polls by it.
        self.rid = rid
        self.idempotency_key: Optional[str] = None
        self.submitted_wall: float = 0.0
        self._result = None  # journal-recovered (x, info)
        #: Tracing: the request's ROOT span (``rpc.request``, opened at
        #: submit, ended at terminal accounting), the live
        #: ``gate.queue`` span, and the root's `TraceContext` (what the
        #: service's slab/chunk spans and the RPC surface propagate).
        self.span_root = None
        self.span_queue = None
        self.trace = None
        #: True on a journaling gate until the terminal record is
        #: durably appended: `state` masks an unjournaled done/failed
        #: as still running, so a client can never observe (and act
        #: on) a terminal outcome a crash could then contradict — the
        #: write-ahead-before-ack invariant applied to completion.
        self.journal_pending = False

    def _raw_state(self) -> str:
        if self._result is not None:
            return "done"
        if self._error is not None:
            return "failed"
        if self.request is None:
            return "gate-queued"
        # an eviction's drained states are TRANSIENT at the gate level
        # (the requeue hook puts the request back in the EDF queue and
        # it resumes after the next page-in) — reporting them terminal
        # would let a concurrent account() or HTTP poll consume the
        # request in the shutdown->requeue window and lose it
        if self.request.state in ("checkpointed", "suspended"):
            return "gate-queued"
        return self.request.state

    @property
    def state(self) -> str:
        raw = self._raw_state()
        if self.journal_pending and raw in ("done", "failed"):
            # terminal but not yet journaled: not acknowledged yet
            return "running"
        return raw

    def done(self) -> bool:
        return self.state in ("done", "failed")

    @property
    def error(self) -> Optional[BaseException]:
        if self._error is not None:
            return self._error
        return self.request.error if self.request is not None else None

    def result(self):
        if self.journal_pending and self._raw_state() in (
            "done", "failed"
        ):
            raise RuntimeError(
                f"request {self.tag!r} finished but its terminal "
                "journal record has not landed yet — pump the gate "
                "(pump()/drain()) so the outcome is durable before it "
                "is served"
            )
        if self._result is not None:
            return self._result
        if self._error is not None:
            raise self._error
        if self.request is None:
            raise RuntimeError(
                f"request {self.tag!r} is still gate-queued — pump the "
                "gate (Gate.pump()/drain()) before asking for the result"
            )
        return self.request.result()

    def __repr__(self):
        return (
            f"GateHandle(tenant={self.tenant!r}, tag={self.tag!r}, "
            f"class={self.slo_class!r}, state={self.state!r})"
        )


class Gate:
    """The multi-tenant front door: an `OperatorRegistry` (tenancy +
    LRU paging) under an EDF cross-tenant queue with SLO-class load
    shedding. Composes OVER the service layer — every per-request
    behavior (bounded admission, coalescing, containment, chunked
    deadlines) stays the tenant `SolveService`'s.

    Drive it synchronously (``pump()``/``drain()``) or construct with
    ``start_workers=True`` (each paged-in tenant runs its background
    worker; ``pump`` then only dispatches and accounts) — the mode the
    RPC server uses.
    """

    def __init__(
        self,
        mem_budget_bytes: Optional[int] = None,
        shed_watermark: Optional[int] = None,
        classes: Optional[Tuple[str, ...]] = None,
        checkpoint_dir: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        start_workers: bool = False,
        journal_dir: Optional[str] = None,
        rid_namespace: Optional[str] = None,
    ):
        self.registry = OperatorRegistry(
            mem_budget_bytes=mem_budget_bytes,
            checkpoint_dir=checkpoint_dir,
            clock=clock, start_workers=start_workers,
        )
        self.clock = self.registry.clock
        self.classes = tuple(classes) if classes else gate_classes()
        check(len(self.classes) >= 1, "gate: need at least one SLO class")
        self.watermark = (
            shed_depth() if shed_watermark is None
            else max(1, int(shed_watermark))
        )
        # the measured feed the EDF/SLO policy reads must stay declared
        for name in _MEASURED_FEED:
            check(
                name in CATALOG,
                f"gate: measured feed {name!r} missing from the metric "
                "CATALOG — the service instrumentation is the scheduling "
                "input, not an optional extra",
            )
        self._queue: List[GateHandle] = []
        self._inflight: List[GateHandle] = []
        #: requests a `pump` has taken off the queue and not yet put in
        #: `_inflight` (it submits them outside the lock): `drain` counts
        #: them pending, or it could return while another thread's pump
        #: (the HTTP server's) still holds one
        self._dispatching = 0
        self._lock = sanitized(threading.RLock(), "Gate._lock")
        self._seq = 0
        #: While True, `pump` dispatches nothing — demos and tests use
        #: it to build a deterministic backlog (shedding is a function
        #: of queue depth, which a fast drain would race away).
        self.paused = False
        # -- durability -------------------------------------------------
        jd = journal_dir if journal_dir is not None else journal_env_dir()
        self.journal: Optional[RequestJournal] = (
            RequestJournal(jd) if (jd and journal_enabled()) else None
        )
        #: Journal-off gates still mint collision-safe ids: a random
        #: epoch token keeps a restarted gate from reissuing an id an
        #: old client still polls (journaled gates use the journal's
        #: monotonic epoch instead, so recovered ids stay resolvable).
        self._epoch_token = secrets.token_hex(3)
        #: Fleet replicas prefix their rids (``<ns>-r<epoch>-<n>``) so
        #: ids stay collision-safe when a survivor ADOPTS a dead peer's
        #: handles next to its own (two solo gates both mint ``r1-0``).
        self.rid_namespace = (
            str(rid_namespace) if rid_namespace else None
        )
        self._handles: Dict[str, GateHandle] = {}  # rid -> handle
        self._idem: Dict[str, str] = {}  # idempotency key -> rid
        self._recovered = False  # recover() is one-shot
        self._adopted_dirs: set = set()  # adopt() is per-dir idempotent
        if self.journal is not None:
            self.registry.on_page_in = self._install_chunk_hook
        # an eviction's drained requests re-enter the EDF queue and
        # resume (checkpointed iterates become the resubmission's x0)
        self.registry.on_evict = self._requeue_evicted

    def _mint_rid(self, seq: int) -> str:
        epoch = (
            self.journal.epoch if self.journal is not None
            else self._epoch_token
        )
        rid = f"r{epoch}-{seq}"
        return f"{self.rid_namespace}-{rid}" if self.rid_namespace else rid

    def handle(self, rid: str) -> Optional[GateHandle]:
        """The handle for a (possibly pre-restart) request id, or None
        once pruned/never issued — the RPC poll surface."""
        with self._lock:
            return self._handles.get(rid)

    def handles_snapshot(self) -> List[Tuple[str, GateHandle]]:
        """(rid, handle) pairs in submission order (recovered first) —
        what `GateServer` seeds its poll store from."""
        with self._lock:
            return list(self._handles.items())

    # -- tenancy passthrough ---------------------------------------------
    def register(self, name, A, **kwargs):
        return self.registry.register(name, A, **kwargs)

    def evict(self, name):
        return self.registry.evict(name)

    def service(self, name):
        return self.registry.service(name)

    def residency(self):
        return self.registry.residency()

    # -- admission ---------------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def retry_after(self, depth: int) -> float:
        """Measured backoff hint for a shed request: the live p50
        request latency (``service.total_s``) times the queue depth in
        watermark units — how long until the backlog plausibly clears.
        Falls back to 1 s while unmeasured."""
        h = registry().histogram("service.total_s")
        p50 = h.quantile(0.5) if h.count else None
        base = p50 if p50 else 1.0
        return round(base * max(1.0, depth / self.watermark), 6)

    def submit(self, tenant: str, b, slo_class: Optional[str] = None,
               tag: str = "", idempotency_key: Optional[str] = None,
               replay_out: Optional[dict] = None,
               trace=None,
               **kwargs) -> GateHandle:
        """Admit one request into the gate queue (EDF-ordered), or
        raise: `LoadShedded` when the request's class is being shed at
        the current depth, `UnknownTenantError` for an unregistered
        tenant. ``kwargs`` pass through to `SolveService.submit`
        (x0/tol/maxiter/deadline/retries).

        ``idempotency_key`` makes retried submits safe: a second call
        with the same key returns the ORIGINAL handle (and, once done,
        the original bitwise result) instead of admitting a second
        solve — the key->id map survives restarts when the gate
        journals, so an HTTP client retrying a timed-out submit against
        a recovered gate still cannot double-solve. ``replay_out``
        (a dict) gets ``replay_out["replayed"] = True/False`` set
        AUTHORITATIVELY — the RPC surface reads it instead of guessing
        from a pre-submit snapshot that a concurrent duplicate can
        race past.

        ``trace`` propagates distributed-tracing context: a
        `telemetry.tracing.TraceContext` (the RPC surface parses the
        client's W3C ``traceparent`` into one) becomes the REMOTE
        parent of this request's ``rpc.request`` root span; None mints
        a fresh trace. The root's context rides ``h.trace`` through
        dispatch into the tenant service's slab/chunk spans."""
        cls = slo_class if slo_class is not None else self.classes[-1]
        check(
            cls in self.classes,
            f"gate: unknown SLO class {cls!r} "
            f"(classes={','.join(self.classes)})",
        )
        if replay_out is not None:
            replay_out["replayed"] = False
        if isinstance(trace, str):
            trace = tracing.parse_traceparent(trace)
        try:
            with self._lock:
                h0 = self._idem_hit(idempotency_key)
                if h0 is not None:
                    if replay_out is not None:
                        replay_out["replayed"] = True
                    return h0
                # shedding must stay CHEAP refusal: decide it before
                # any payload gathering (re-checked at admission below)
                self._check_shed(cls, tag)
        except LoadShedded as e:
            # the shed span's file write happens OUTSIDE the gate lock
            # — refusal under overload must not serialize span I/O
            # through the submit critical section
            self._shed_span(e, tag, cls, trace)
            raise
        t = self.registry.tenant(tenant)  # raise UnknownTenantError early
        # spectrum deadline-feasibility (telemetry spec_admit): a measured
        # operator whose forecast cost exceeds the request's deadline
        # is refused typed DeadlineInfeasible AT THE GATE DOOR — never
        # enqueued, never dispatched, zero iterations spent (the RPC
        # surface maps it to 422). Distinct from shed (policy under
        # overload) and queue-full (backpressure): this is a
        # prediction. Unmeasured operators always pass.
        self._check_feasible(t, b, tag, kwargs)
        # the EXPENSIVE part of the admitted record — gathering the
        # global vectors and converting to floats — happens before the
        # gate lock (b/x0 are immutable inputs); only the append itself
        # serializes under it, so polls/dispatch don't stall behind
        # per-submit serialization work
        payload = (
            self._admitted_payload(b, kwargs)
            if self.journal is not None else None
        )
        try:
            return self._admit(
                tenant, b, cls, tag, idempotency_key, replay_out,
                trace, payload, kwargs,
            )
        except LoadShedded as e:
            self._shed_span(e, tag, cls, trace)
            raise

    def _admit(self, tenant, b, cls, tag, idempotency_key, replay_out,
               trace, payload, kwargs) -> GateHandle:
        """The locked admission half of `submit` (split out so the
        shed span can be emitted outside the lock)."""
        with self._lock:
            # re-check under the admission lock: a concurrent same-key
            # submit (or a backlog crossing the watermark) that won the
            # race since the first look must still win here
            h0 = self._idem_hit(idempotency_key)
            if h0 is not None:
                if replay_out is not None:
                    replay_out["replayed"] = True
                return h0
            self._check_shed(cls, tag)
            deadline = kwargs.get("deadline")
            now = self.clock()
            h = GateHandle(
                tenant=tenant,
                tag=tag or f"gate-{self._seq}",
                slo_class=cls,
                deadline_abs=(
                    None if deadline is None else now + float(deadline)
                ),
                seq=self._seq,
                kwargs=dict(kwargs, b=b, tag=tag or f"gate-{self._seq}"),
                rid=self._mint_rid(self._seq),
            )
            h.idempotency_key = idempotency_key
            h.submitted_wall = _walltime.time()
            h.journal_pending = self.journal is not None
            # tracing: the request-level root span — an HTTP client's
            # traceparent becomes its remote parent, an in-process
            # submit mints a fresh trace; gate-queue wait starts now.
            # Unlike the shed path (no fsync — _shed_span runs outside
            # the lock), admission already holds an fsync'd journal
            # append in this critical section by design; two buffered
            # span writes are noise next to it, and creating the spans
            # here keeps the admitted record's trace ids and the
            # handle's spans atomic with the idem/shed re-checks.
            h.span_root = tracing.start_span(
                "rpc.request", name=h.tag, parent=trace,
                remote=trace is not None,
                tenant=h.tenant, slo_class=h.slo_class, rid=h.rid,
            )
            h.trace = (
                h.span_root.ctx if h.span_root.recording else None
            )
            h.span_queue = tracing.start_span(
                "gate.queue", name=h.tag, parent=h.span_root,
            )
            self._seq += 1
            if self.journal is not None:
                self.journal.append(
                    "admitted",
                    rid=h.rid,
                    tenant=h.tenant,
                    tag=h.tag,
                    slo_class=h.slo_class,
                    idempotency_key=h.idempotency_key,
                    submitted_wall=h.submitted_wall,
                    trace_id=(
                        h.trace.trace_id
                        if h.span_root.recording else None
                    ),
                    root_span_id=(
                        h.trace.span_id
                        if h.span_root.recording else None
                    ),
                    **payload,
                )
            self._handles[h.rid] = h
            if idempotency_key is not None:
                self._idem[idempotency_key] = h.rid
            # EDF: sorted by absolute deadline, deadline-free last,
            # FIFO among equals (stable by seq)
            self._queue.append(h)
            self._queue.sort(key=_edf_key)
            if monitoring_enabled():
                registry().gauge("gate.queue_depth").set(
                    len(self._queue)
                )
            return h

    def _idem_hit(self, key: Optional[str]) -> Optional[GateHandle]:
        """The ONE idempotency-replay path (callers hold the gate
        lock): the live handle for a known key, counted and evented —
        or None for a fresh key/pruned handle."""
        from .. import telemetry

        if key is None:
            return None
        rid = self._idem.get(key)
        h = self._handles.get(rid) if rid is not None else None
        if h is not None:
            registry().counter("gate.idempotent_hits").inc()
            telemetry.emit_event(
                "idempotent_replay", label=key, rid=h.rid, state=h.state,
            )
        return h

    def _shed_span(self, e: LoadShedded, tag: str, cls: str,
                   trace) -> None:
        """A shed request's whole trace is one ``gate.shed`` span
        (under the client's remote context when one came in) — emitted
        OUTSIDE the gate lock by `submit`, so refusal never serializes
        span file I/O through the admission critical section."""
        sp = tracing.start_span(
            "gate.shed", name=tag, parent=trace,
            remote=trace is not None, slo_class=cls,
            depth=e.diagnostics.get("depth"),
        )
        sp.end(status="shed")

    def _check_shed(self, cls: str, tag: str) -> None:
        """Raise `LoadShedded` when ``cls`` is being shed at the
        current depth (callers hold the gate lock). The shed record is
        appended WITHOUT an fsync — nothing acknowledges against it,
        so refusal stays cheap under exactly the overload that
        triggers it."""
        depth = len(self._queue)
        shed = shed_classes(depth, self.classes, self.watermark)
        if cls not in shed:
            return
        if self.journal is not None:
            self.journal.append(
                "shed", tag=tag, slo_class=cls, depth=depth,
                _sync=False,
            )
        raise LoadShedded(
            f"gate: class {cls!r} is shedding at queue depth "
            f"{depth} (watermark shed_depth="
            f"{self.watermark}; shed classes: {', '.join(shed)})"
            " — retry after the backlog clears",
            retry_after_s=self.retry_after(depth),
            diagnostics={
                "slo_class": cls, "tag": tag, "depth": depth,
                "watermark": self.watermark, "shed": list(shed),
            },
        )

    def _check_feasible(self, tenant, b, tag: str, kwargs: dict) -> None:
        """The gate half of spectrum admission: forecast the request's
        cost against the tenant operator's measured spectrum +
        throughput and refuse an infeasible deadline typed
        (`DeadlineInfeasible`) before it enters the EDF queue. No-op
        without a deadline or with the telemetry config's ``spec_admit``
        off (the default).
        A computed ``‖b‖`` is stamped into ``kwargs["r0_norm"]`` so
        the tenant service's dispatch-time re-check (against the
        REMAINING deadline — gate-queue time is charged) reuses it
        instead of paying the O(n) reduction twice."""
        deadline = kwargs.get("deadline")
        if deadline is None or not spectrum.spec_admit_enabled():
            return
        import numpy as np

        from ..service.admission import DEFAULT_TOL
        from ..telemetry.throughput import operator_fingerprint

        fp = spectrum.spectrum_fingerprint(tenant.A)
        dt = str(np.dtype(b.dtype))
        mc = spectrum.minv_class_of(tenant.minv)
        # unmeasured operators always pass — and must not pay the O(n)
        # norm the forecast needs
        if not spectrum.has_spec(fp, dt, mc):
            return
        # warm starts (x0) forecast their REMAINING work
        r0 = spectrum.residual_norm(tenant.A, b, kwargs.get("x0"))
        if r0 is not None:
            kwargs["r0_norm"] = r0
        spectrum.check_deadline_feasible(
            fp, dt, mc, float(kwargs.get("tol", DEFAULT_TOL)),
            float(deadline), r0_norm=r0, tag=tag, where="gate",
            cost_fingerprint=operator_fingerprint(tenant.A),
        )

    def _admitted_payload(self, b, kwargs) -> dict:
        """The data half of the ``admitted`` record — the full request
        payload (global vectors via JSON's exact float round-trip), so
        a never-dispatched request is resubmittable from the journal
        alone after a crash. Built OUTSIDE the gate lock."""
        from ..models.solvers import gather_pvector

        x0 = kwargs.get("x0")
        return {
            "dtype": str(b.dtype),
            "b": [float(v) for v in gather_pvector(b)],
            "x0": (
                None if x0 is None
                else [float(v) for v in gather_pvector(x0)]
            ),
            "tol": kwargs.get("tol"),
            "maxiter": kwargs.get("maxiter"),
            "deadline": kwargs.get("deadline"),
            "retries": kwargs.get("retries"),
        }

    # -- dispatch / drive --------------------------------------------------
    def _requeue_evicted(self, name: str, tenant) -> None:
        """The eviction hook (`OperatorRegistry.on_evict`): every
        dispatched-but-unfinished request the page-out drained —
        SUSPENDED (never started) or CHECKPOINTED (iterate saved at the
        chunk boundary, the service's checkpoint path) — re-enters the gate's EDF queue
        and resumes after the next page-in. A checkpointed request
        resubmits FROM its saved iterate (``x0``; its spent iterations
        come off the maxiter budget), so eviction costs a chunk
        restart, never progress."""
        from .. import telemetry

        requeued = 0
        with self._lock:
            for h in self._inflight:
                req = h.request
                if h.tenant != name or req is None or h.accounted:
                    continue
                if req.state not in ("suspended", "checkpointed"):
                    continue
                if req.state == "checkpointed" and req.checkpoint_path:
                    from ..parallel.checkpoint import load_solver_state

                    st = load_solver_state(
                        req.checkpoint_path, {"x": tenant.A.cols}
                    )
                    if st is not None:
                        h.kwargs["x0"] = st["x"]
                        # the admission-time ‖r0‖ is stale for the
                        # resumed iterate: drop it so the dispatch-time
                        # forecast recomputes the REMAINING work
                        h.kwargs.pop("r0_norm", None)
                        if h.kwargs.get("maxiter") is not None:
                            h.kwargs["maxiter"] = max(
                                1, int(h.kwargs["maxiter"])
                                - req.iterations
                            )
                        if self.journal is not None:
                            # a crash after the eviction must not lose
                            # the checkpointed progress: record where
                            # the iterate lives and how far it got
                            self.journal.append(
                                "chunk", rid=h.rid,
                                iterations=req.iterations,
                                checkpoint=req.checkpoint_path,
                            )
                h.request = None
                # the requeue re-enters gate-queue wait: a fresh
                # gate.queue span under the SAME root narrates it
                h.span_queue = tracing.start_span(
                    "gate.queue", name=h.tag, parent=h.trace,
                    requeued=True, evicted_tenant=name,
                )
                self._queue.append(h)
                requeued += 1
            if requeued:
                self._inflight = [
                    h for h in self._inflight if h.request is not None
                    or h._error is not None
                ]
                self._queue.sort(key=_edf_key)
                if monitoring_enabled():
                    registry().gauge("gate.queue_depth").set(
                        len(self._queue)
                    )
        if requeued:
            telemetry.emit_event(
                "tenant_requeued", label=name, requests=requeued
            )

    def _busy_residents(self) -> bool:
        """Any resident tenant still holding queued OR in-flight gate
        work? The pump defers a tenant SWITCH (a page-in, hence an
        eviction) until then — paging per request would thrash the
        budget, and a worker-mode slab is in flight precisely while its
        service queue reads empty, so the gate's own dispatched-but-
        unfinished handles are part of the busy test (without them the
        5 ms pump would evict every slab mid-solve — a livelock where
        nothing ever completes)."""
        busy = {
            h.tenant
            for h in self._inflight
            if h.request is not None
            and h.request.state in ("queued", "running")
        }
        return any(
            t.resident and (
                t.name in busy
                or (t.svc is not None and t.svc.pending() > 0)
            )
            for t in self.registry._tenants.values()
        )

    def pump(self, dispatch_only: bool = False) -> int:
        """One scheduling round: take the EDF head, dispatch EVERY
        gate-queued request of the head's tenant (in EDF order — the
        same-tenant deadline order is preserved exactly; the service's
        FIFO batcher consumes it in that order) into its service,
        paging the tenant in if needed, then — unless the tenants run
        their own workers or ``dispatch_only`` — drive that service to
        completion and account finished requests. A switch to a
        NON-resident tenant is deferred while resident tenants still
        hold queued work (one page-in per quiescent switch, not per
        request). Returns the number of requests dispatched."""
        if self.paused:
            self.account()
            return 0
        with self._lock:
            if not self._queue:
                batch = []
            else:
                target = self._queue[0].tenant
                t = self.registry._tenants.get(target)
                if (
                    t is not None and not t.resident
                    and self._busy_residents()
                ):
                    batch = []  # defer the page-in until quiescence
                    if not self.registry.start_workers and not (
                        dispatch_only
                    ):
                        # synchronous tenants have no worker to reach
                        # quiescence on their own — drive them here
                        for v in self.registry._tenants.values():
                            if v.resident and v.svc is not None:
                                v.svc.drain()
                else:
                    batch = [
                        h for h in self._queue if h.tenant == target
                    ]
                    self._queue = [
                        h for h in self._queue if h.tenant != target
                    ]
            self._dispatching += len(batch)
            if monitoring_enabled():
                registry().gauge("gate.queue_depth").set(
                    len(self._queue)
                )
        # what is still left of the batch when the loop raises leaves the
        # count in the finally, or `drain` would wait on it for ever
        left = len(batch)
        try:
            for h in batch:
                kwargs = dict(h.kwargs)
                if h.deadline_abs is not None:
                    # the service measures deadlines from ITS submission;
                    # charge the time spent in the gate queue against the
                    # request's budget so EDF cannot mint extra slack
                    kwargs["deadline"] = max(
                        1e-9, h.deadline_abs - self.clock()
                    )
                kwargs["trace"] = h.trace
                # gate-queue wait ends HERE, before dispatch: queue-wait /
                # page-in / solve stay disjoint spans, so the per-kind
                # breakdown sums to within the root span's duration
                if h.span_queue is not None:
                    h.span_queue.end()
                    h.span_queue = None
                try:
                    # ambient ctx: a page-in this dispatch triggers parents
                    # its tenant.page_in span to THIS request's trace
                    with tracing.ambient(h.trace):
                        h.request = self.registry.submit(h.tenant, **kwargs)
                    if self.journal is not None:
                        self.journal.append(
                            "dispatched", rid=h.rid, tenant=h.tenant,
                        )
                except Exception as e:  # typed AdmissionRejected etc.
                    h._error = e
                with self._lock:  # account() rebinds _inflight under it
                    self._inflight.append(h)
                    self._dispatching -= 1
                    left -= 1
        finally:
            if left:
                with self._lock:
                    self._dispatching -= left
        if batch and not dispatch_only and not (
            self.registry.start_workers
        ):
            svc = self.registry.tenant(batch[0].tenant).svc
            if svc is not None:
                svc.drain()
        self.account()
        return len(batch)

    def drain(self) -> None:
        """Pump until the gate queue is empty and every dispatched
        request is terminal (worker-mode tenants finish on their own
        threads; synchronous tenants are driven here)."""
        import time as _time

        check(not self.paused, "gate: resume() before drain()")

        while True:
            self.pump()
            with self._lock:
                pending = bool(self._queue) or self._dispatching > 0 or any(
                    not h.done() for h in self._inflight
                )
            if not pending:
                return
            # worker-mode tenants finish on their own threads; the
            # tiny sleep also keeps a pathological sync-mode wait (an
            # inflight request owned by an un-driven service) from
            # busy-spinning
            _time.sleep(0.005 if self.registry.start_workers else 0.001)

    def account(self) -> None:
        """Fold terminal requests into the per-class SLO counters:
        every finished gate request ticks ``gate.slo.requests`` for its
        class; a request that resolved (``done``) ticks
        ``gate.slo.hits`` too — a deadline miss fails typed at the
        service layer, so hits/requests IS the per-class attainment.
        Journaling gates also write the terminal record here (the
        completed record carries the bitwise result, so a recovered
        gate serves it without re-solving)."""
        reg = registry()
        with self._lock:
            for h in self._inflight:
                # the RAW state: the public `state` masks unjournaled
                # terminals as running, and this is the very place
                # that journals them
                raw = h._raw_state()
                if h.accounted or raw not in ("done", "failed"):
                    continue
                if self.journal is not None and h.journal_pending:
                    self._journal_terminal(h)
                h.journal_pending = False
                labels = {"slo_class": h.slo_class}
                reg.counter("gate.slo.requests", labels=labels).inc()
                if raw == "done":
                    reg.counter("gate.slo.hits", labels=labels).inc()
                if h.span_queue is not None:  # failed while queued
                    h.span_queue.end(status=raw)
                    h.span_queue = None
                if h.span_root is not None:
                    h.span_root.end(status=raw)
                    h.span_root = None
                h.accounted = True
            self._inflight = [
                h for h in self._inflight if not h.accounted
            ]
            if len(self._handles) > _MAX_HANDLES:
                for rid in list(self._handles):
                    if len(self._handles) <= _MAX_HANDLES:
                        break
                    old = self._handles[rid]
                    if old.accounted and old.done():
                        del self._handles[rid]
                        # the idempotency window is the handle
                        # retention window: a pruned key must not
                        # linger as a dangling entry (memory leak) —
                        # journaling gates rebuild pruned keys from
                        # the journal at the next recovery
                        key = old.idempotency_key
                        if key is not None and self._idem.get(key) == rid:
                            del self._idem[key]

    def _journal_terminal(self, h: GateHandle) -> None:
        """One ``completed``/``failed`` record per terminal handle
        (callers hold the gate lock and have checked the raw state)."""
        from ..models.solvers import gather_pvector

        import numpy as np

        if h._raw_state() == "done":
            x, info = (
                h._result if h._result is not None
                else h.request.result()
            )
            xg = x if isinstance(x, np.ndarray) else gather_pvector(x)
            self.journal.append(
                "completed", rid=h.rid,
                x=[float(v) for v in xg],
                converged=bool(info.get("converged")),
                iterations=int(info.get("iterations", 0)),
                status=str(info.get("status")),
            )
        else:
            err = h.error
            self.journal.append(
                "failed", rid=h.rid,
                error=getattr(
                    err, "error_type", type(err).__name__
                ),
                message=str(err)[:500],
            )

    # -- durability: chunk checkpoints + recovery --------------------------
    def _install_chunk_hook(self, name: str, tenant) -> None:
        """`OperatorRegistry.on_page_in` hook (journal mode): every
        paged-in tenant service checkpoints its in-flight iterates at
        each chunk boundary through `_journal_chunk`, so a kill -9
        mid-slab costs at most one chunk of a chunked solve."""
        if tenant.svc is not None:
            tenant.svc.on_chunk = self._journal_chunk

    def _journal_chunk(self, req, x) -> None:
        """Called by a tenant service at a chunk boundary (worker
        thread): save the live iterate in the checkpoint layer's CRC'd
        format under the journal dir and journal the transition —
        recovery resumes from here (x0 = saved iterate)."""
        from ..parallel.checkpoint import SolverCheckpointer

        with self._lock:
            h = next(
                (h for h in self._inflight if h.request is req), None
            )
        if h is None or self.journal is None:
            return
        d = os.path.join(self.journal.directory, "ckpt", h.rid)
        ck = SolverCheckpointer(d, every=1, async_write=False)
        ck.save_state(
            {"x": x},
            {"rid": h.rid, "it": req.iterations, "request": req.tag},
        )
        ck.wait()
        self.journal.append(
            "chunk", rid=h.rid, iterations=req.iterations, checkpoint=d,
        )

    def recover(self, journal_dir: Optional[str] = None) -> dict:
        """Replay the journal into THIS gate (tenants must already be
        registered — operators are code + data, not journal payload):

        * ``completed`` requests become terminal handles serving their
          RECORDED results (bitwise — JSON floats round-trip exactly);
        * ``failed`` requests become terminal handles re-raising the
          replayed typed error (`RecoveredError` keeps the original
          class name on the wire);
        * in-flight requests (dispatched, possibly chunk-checkpointed)
          are RESUBMITTED: x0 = the newest checkpointed iterate when
          one exists (spent iterations charged against maxiter), the
          original x0 otherwise; the deadline clock RESUMES against
          wall time (a request whose deadline passed during the outage
          fails typed `SolveDeadlineError` instead of solving late);
        * queued-but-never-dispatched requests re-enter the EDF queue
          in their original deadline order;
        * the idempotency key map is rebuilt, so retried submits from
          before the crash still return their original ids.

        Returns the outcome summary (also evented as ``gate_recovered``
        and counted per-outcome under ``gate.recovered``). One-shot:
        a second call would re-enqueue every non-terminal request
        (double-solving acknowledged work), so it refuses."""
        from .. import telemetry

        check(
            not self._recovered,
            "gate: recover() already replayed this journal — a second "
            "replay would resubmit (and double-solve) every "
            "non-terminal request",
        )
        self._recovered = True
        if self.journal is None:
            check(
                journal_dir is not None,
                "gate: recover() needs a journal (pass journal_dir or "
                "construct the gate with one)",
            )
            self.journal = RequestJournal(journal_dir)
            self.registry.on_page_in = self._install_chunk_hook
            for name, t in self.registry._tenants.items():
                self._install_chunk_hook(name, t)
        keep = journal_keep()
        states, order = self._fold_records(self.journal.prior_records)
        summary = {
            "completed": 0, "failed": 0, "resumed": 0,
            "requeued": 0, "expired": 0, "adopted_away": 0,
        }
        if keep is not None:
            # Retention compaction: every still-live rid (no terminal,
            # no adoption marker) gets its ``admitted`` record COPIED
            # into the current epoch BEFORE replay, so pruning the
            # prior epochs cannot orphan a request the gate still owes.
            # Copies precede any terminal this replay writes (fold
            # order: admitted must come first). Terminal history in
            # pruned epochs ages out with them — that is the
            # documented idempotency-replay horizon.
            for rid in order:
                if not ({"completed", "failed", "adopted"}
                        & states[rid].keys()):
                    self._rejournal_admitted(states[rid]["admitted"])
        for rid in order:
            outcome = self._recover_one(rid, states[rid])
            summary[outcome] += 1
            registry().counter(
                "gate.recovered", labels={"outcome": outcome}
            ).inc()
            telemetry.emit_event(
                "request_recovered", label=rid, outcome=outcome,
            )
        self.journal.append("recovered", **summary)
        telemetry.emit_event(
            "gate_recovered", label=self.journal.directory, **summary
        )
        if keep is not None:
            self.journal.prune(keep)
        return summary

    @staticmethod
    def _fold_records(records) -> tuple:
        """Fold a journal's record stream into per-rid state dicts
        (admission-ordered). Lifecycle records whose ``admitted`` lives
        in a pruned epoch are orphans and are skipped — retention
        compaction re-copies live admissions forward precisely so this
        never drops an owed request."""
        states: Dict[str, dict] = {}
        order: List[str] = []
        for rec in records:
            kind, rid = rec.get("kind"), rec.get("rid")
            if kind == "admitted":
                if rid not in states:
                    order.append(rid)
                states[rid] = {"admitted": rec}
            elif rid in states and kind in (
                "dispatched", "chunk", "completed", "failed", "adopted"
            ):
                states[rid][kind] = rec
        return states, order

    def _rejournal_admitted(self, adm: dict) -> None:
        """Append a copy of an ``admitted`` record into THIS gate's
        current epoch (journal bookkeeping keys are re-minted)."""
        payload = {
            k: v for k, v in adm.items()
            if k not in ("kind", "seq", "crc", "wall")
        }
        self.journal.append("admitted", **payload)

    def adopt(self, journal_dir: str, source: str = "peer") -> dict:
        """Adopt a DEAD peer replica's journal into this live gate —
        the fleet failover half of `recover()` (frontdoor.fleet decides
        WHEN via lease staleness; this method is the mechanism):

        * terminal requests (completed/failed) become poll-servable
          handles replaying the peer's recorded results — NOT
          re-journaled (the peer journal stays their durable home, so
          the journal union keeps one terminal record per rid);
        * live requests (queued/dispatched/chunk-checkpointed) are
          first re-journaled ``admitted`` into THIS gate's journal
          (write-ahead: if the survivor also dies, ITS recovery re-owns
          them), then marked ``adopted`` in the PEER's journal (a
          restarted peer folds the marker into a typed
          ``AdoptedByPeer`` refusal instead of double-solving), then
          resubmitted exactly as `recover()` would — same checkpoint
          resume, deadline-clock, and trace-stitching rules (the
          admitted record carries trace_id/root_span_id, so the
          adopting replica's spans join the client's original trace);
        * live requests whose tenant is not registered HERE are
          skipped, not failed — they stay un-adopted in the peer
          journal for a replica that can serve them.

        Per-dir idempotent (a repeat adopt of the same journal dir is a
        no-op) and rid-idempotent (a rid already held here — e.g. a
        previous partial adoption — is skipped). Counted per-outcome
        under ``fleet.adopted`` and evented ``request_adopted`` /
        ``fleet_adopted``. Requires a journaling gate with a distinct
        journal dir (adopting your OWN journal is `recover()`'s job and
        refuses here)."""
        from .. import telemetry

        check(
            self.journal is not None,
            "gate: adopt() needs this gate to journal — a non-durable "
            "survivor could lose the adopted requests it acknowledged",
        )
        peer_dir = os.path.abspath(journal_dir)
        check(
            peer_dir != os.path.abspath(self.journal.directory),
            "gate: adopt() got this gate's OWN journal dir — replaying "
            "your own journal is recover(), not adoption",
        )
        if peer_dir in self._adopted_dirs:
            return {"skipped_dir": peer_dir}
        self._adopted_dirs.add(peer_dir)
        peer = RequestJournal(peer_dir)
        try:
            states, order = self._fold_records(peer.prior_records)
            summary = {
                "completed": 0, "failed": 0, "resumed": 0,
                "requeued": 0, "expired": 0, "skipped": 0,
            }
            for rid in order:
                st = states[rid]
                live = not (
                    {"completed", "failed", "adopted"} & st.keys()
                )
                with self._lock:
                    known = rid in self._handles
                if "adopted" in st or known:
                    summary["skipped"] += 1
                    continue
                if live:
                    tenant = st["admitted"].get("tenant")
                    if tenant not in self.registry._tenants:
                        summary["skipped"] += 1
                        continue
                    self._rejournal_admitted(st["admitted"])
                    peer.append(
                        "adopted", rid=rid,
                        by=self.rid_namespace or "survivor",
                        source=source,
                    )
                outcome = self._recover_one(
                    rid, st, adopted_from=peer_dir
                )
                summary[outcome] += 1
                registry().counter(
                    "fleet.adopted", labels={"outcome": outcome}
                ).inc()
                telemetry.emit_event(
                    "request_adopted", label=rid, outcome=outcome,
                    source=peer_dir,
                )
        finally:
            peer.close()
        telemetry.emit_event(
            "fleet_adopted", label=peer_dir, **summary
        )
        return summary

    def _recover_one(self, rid: str, st: dict,
                     adopted_from: Optional[str] = None) -> str:
        """Recover one journaled request; returns its outcome key.
        ``adopted_from`` tags the fleet-failover path (`adopt()`)."""
        import numpy as np

        from ..models.solvers import scatter_pvector_values
        from ..parallel.checkpoint import load_solver_state
        from ..utils.health import SolveDeadlineError

        adm = st["admitted"]
        key = adm.get("idempotency_key")
        if key:
            # under the gate lock: adopt() runs on fleet watch threads
            # while HTTP submits race the same idempotency map
            with self._lock:
                self._idem[key] = rid
        if "adopted" in st:
            # a peer replica took this request while we were down —
            # refuse typed instead of double-solving it (the adopter's
            # journal is its durable home now)
            rec = st["adopted"]
            h = self._terminal_handle(adm, rid, outcome="adopted_away")
            h._error = RecoveredError(
                "AdoptedByPeer",
                f"request {rid}: replica {rec.get('by')!r} adopted "
                "this request after a missed lease — poll the "
                "adopting replica (or resubmit with the same "
                "idempotency key through the fleet router)",
            )
            return "adopted_away"
        if "completed" in st:
            rec = st["completed"]
            h = self._terminal_handle(adm, rid, outcome="completed")
            h._result = (
                np.asarray(rec["x"], dtype=adm.get("dtype", "float64")),
                {
                    "converged": bool(rec.get("converged")),
                    "iterations": int(rec.get("iterations", 0)),
                    "status": str(rec.get("status")),
                    "recovered": True,
                },
            )
            return "completed"
        if "failed" in st:
            rec = st["failed"]
            h = self._terminal_handle(adm, rid, outcome="failed")
            h._error = RecoveredError(
                rec.get("error", "RuntimeError"), rec.get("message", "")
            )
            return "failed"
        # in-flight or queued: resubmit. Unknown tenant (the operator
        # was not re-registered before recover()) fails typed instead
        # of silently dropping an acknowledged request.
        tenant = self.registry._tenants.get(adm["tenant"])
        if tenant is None:
            h = self._terminal_handle(adm, rid, outcome="failed")
            h._error = RecoveredError(
                "UnknownTenant",
                f"request {rid}: tenant {adm['tenant']!r} was not "
                "re-registered before recover()",
            )
            return "failed"
        dtype = np.dtype(adm.get("dtype", "float64"))
        kwargs = {
            "b": scatter_pvector_values(
                np.asarray(adm["b"], dtype=dtype), tenant.A.cols
            ),
            "tag": adm.get("tag") or rid,
        }
        for k in ("tol", "maxiter", "retries"):
            if adm.get(k) is not None:
                kwargs[k] = adm[k]
        if adm.get("x0") is not None:
            kwargs["x0"] = scatter_pvector_values(
                np.asarray(adm["x0"], dtype=dtype), tenant.A.cols
            )
        outcome = "requeued"
        chunk = st.get("chunk")
        if chunk is not None:
            saved = load_solver_state(
                chunk["checkpoint"], {"x": tenant.A.cols}
            )
            if saved is not None:
                kwargs["x0"] = saved["x"]
                if kwargs.get("maxiter") is not None:
                    kwargs["maxiter"] = max(
                        1, int(kwargs["maxiter"])
                        - int(chunk.get("iterations", 0))
                    )
                outcome = "resumed"
        deadline_abs = None
        if adm.get("deadline") is not None:
            # the deadline clock RESUMES: the outage consumed budget
            remaining = float(adm["deadline"]) - (
                _walltime.time() - float(adm.get("submitted_wall", 0.0))
            )
            if remaining <= 0.0:
                h = self._terminal_handle(adm, rid, outcome="expired")
                err = SolveDeadlineError(
                    f"request {rid}: deadline of {adm['deadline']}s "
                    "expired during the outage — recovery fails it "
                    "typed instead of solving late",
                    diagnostics={
                        "context": "gate-recovery", "request": rid,
                        "deadline_s": adm["deadline"],
                    },
                )
                h._error = err
                if self.journal is not None:
                    self._journal_terminal(h)
                    h.accounted = True
                return "expired"
            kwargs["deadline"] = remaining
            deadline_abs = self.clock() + remaining
        with self._lock:
            h = GateHandle(
                tenant=adm["tenant"], tag=kwargs["tag"],
                slo_class=adm.get("slo_class") or self.classes[-1],
                deadline_abs=deadline_abs, seq=self._seq,
                kwargs=kwargs, rid=rid,
            )
            h.idempotency_key = key
            h.submitted_wall = float(adm.get("submitted_wall", 0.0))
            h.journal_pending = True  # its terminal must journal too
            # crash stitching: the resumption keeps the ORIGINAL
            # trace_id and parents its new root to the pre-crash root
            # span — one tree across the kill, zero orphans (the old
            # root survives as an interrupted span in the tracing dir)
            h.span_root = self._recovered_root(
                adm, rid, outcome, adopted_from=adopted_from
            )
            h.trace = (
                h.span_root.ctx if h.span_root.recording else None
            )
            h.span_queue = tracing.start_span(
                "gate.queue", name=h.tag, parent=h.span_root,
                recovered=True,
            )
            self._seq += 1
            self._handles[rid] = h
            self._queue.append(h)
            self._queue.sort(key=_edf_key)
        return outcome

    def _recovered_root(self, adm: dict, rid: str, outcome: str,
                        adopted_from: Optional[str] = None):
        """A post-recovery root span continuing the journaled trace
        (fresh trace when the pre-crash gate ran with tracing off). With a
        shared tracing dir across a fleet, an adopted request's new root
        lands in the SAME trace as the dead replica's spans — one tree
        across the replica hop."""
        tid = adm.get("trace_id") or None
        extra = (
            {"adopted_from": adopted_from} if adopted_from else {}
        )
        return tracing.start_span(
            "rpc.request", name=adm.get("tag") or rid,
            trace_id=tid,
            parent_id=adm.get("root_span_id") if tid else None,
            recovered=outcome, rid=rid, tenant=adm.get("tenant"),
            **extra,
        )

    def _terminal_handle(self, adm: dict, rid: str,
                         outcome: str = "completed") -> GateHandle:
        """A journal-recovered terminal handle, registered for polls
        (it never enters the queue or the SLO accounting — its life
        was accounted by the gate generation that served it). Its
        trace gets one closing span (same trace_id, parented to the
        pre-crash root) narrating the journal-served outcome."""
        with self._lock:
            h = GateHandle(
                tenant=adm.get("tenant"), tag=adm.get("tag") or rid,
                slo_class=adm.get("slo_class") or self.classes[-1],
                deadline_abs=None, seq=self._seq, kwargs={}, rid=rid,
            )
            h.idempotency_key = adm.get("idempotency_key")
            h.accounted = True
            sp = self._recovered_root(adm, rid, outcome)
            sp.end(status=outcome)
            h.trace = sp.ctx if sp.recording else None
            self._seq += 1
            self._handles[rid] = h
            return h

    def shutdown(self, drain: bool = True):
        from .. import telemetry

        if drain:
            self.drain()
        stats = self.registry.shutdown(drain=drain)
        telemetry.emit_event(
            "gate_shutdown", label="drain" if drain else "checkpoint",
            tenants=sorted(stats),
        )
        if self.journal is not None:
            self.journal.append("shutdown", drain=bool(drain))
        return stats

    def __repr__(self):
        return (
            f"Gate(classes={self.classes}, watermark={self.watermark}, "
            f"depth={self.depth()}, {self.registry!r})"
        )
