"""Operator tenancy: N named operators admitted against a memory budget,
with LRU paging (frontdoor/tenancy.py of the JAX package).

One `SolveService` serves one operator: its device staging, cached block
solve functions and their CUDA graphs are all per ``A``. Many operators sit
behind one front door, and this registry keeps that safe: every registered
operator declares a static footprint (`operator_footprint_bytes`, the JAX
package's ``operands + 2 x carry`` shape sum, so admission decisions are
the same in both packages), and the sum of RESIDENT footprints never
exceeds the budget. When admitting or paging an operator in would break
the bound, the least-recently-used resident tenant is EVICTED:

1. its in-flight slabs are drained through the service's checkpoint path
   (``SolveService.shutdown(drain=False)``: running requests checkpoint
   their iterates under the tenant's checkpoint dir, never-started ones
   suspend; both resume by resubmission);
2. its device state is dropped: the `DeviceMatrix` objects cached on
   ``A._device``, their cached solve functions (`gpu._krylov_fn_for`) and
   their CUDA graphs, whose memory goes back to the driver under the
   card's `service.device_lock` (`_drop_device_state`);
3. the tenant is marked evicted; the NEXT request pages it back in (a
   fresh `SolveService`; staging and capture run again at its first slab,
   and the solve reproduces the evicted one's bit for bit).

An operator whose footprint exceeds the whole budget can never be served
and is refused at registration with the typed `TenantBudgetError`, which
is not per-request backpressure. Evictions and page-ins are counted
(``gate.evictions`` / ``gate.page_ins``) and evented (``tenant_evicted`` /
``tenant_paged_in``); `OperatorRegistry.residency` is the table
``/v1/tenants`` serves.

The budget is the front-door config's ``mem_budget`` (the JAX package's
``PA_GATE_MEM_BUDGET``; 0, the default, is unbounded) or the registry's
``mem_budget_bytes``. The structural footprint is not what a tenant holds
on the card (the coded streams' real layout and the graphs' private pools
are not in it): ``chip_smoke.py`` prints both, side by side.
"""
from __future__ import annotations

import gc
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..service.service import SolveService, _cuda_index, device_lock
from ..telemetry.registry import monitoring_enabled, registry
from ..utils.helpers import check
from ..utils.locksan import sanitized

__all__ = [
    "TenantBudgetError",
    "UnknownTenantError",
    "Tenant",
    "OperatorRegistry",
    "mem_budget",
    "operator_footprint_bytes",
]


def mem_budget() -> int:
    """The config's ``mem_budget`` in bytes; 0 (the default) = unbounded."""
    from .config import config

    return max(0, int(config().mem_budget))


class TenantBudgetError(RuntimeError):
    """Registering (or paging in) an operator would exceed the memory
    budget even after every other tenant is evicted: the operator can never
    be served under this budget. ``diagnostics`` carries the tenant name,
    its footprint and the bound. Not an `AdmissionRejected`: the refusal is
    per-operator capacity planning, not per-request backpressure."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})
        from ..telemetry import emit_event

        registry().counter("gate.budget_rejected").inc()
        emit_event(
            "tenant_budget_rejected",
            label=str(self.diagnostics.get("tenant", "")),
            footprint_bytes=self.diagnostics.get("footprint_bytes"),
            budget_bytes=self.diagnostics.get("budget_bytes"),
        )


class UnknownTenantError(KeyError):
    """A request named a tenant the registry never admitted."""


def operator_footprint_bytes(A, kmax: int, dtype=None) -> int:
    """Conservative static footprint of serving ``A`` at slab width
    ``kmax``: the local matrix value streams plus 2 x the block-CG carry
    (3 state vectors of (local rows, K) in and out of the loop), at
    ``dtype``'s item size (float64 by default, whatever ``A``'s dtype).
    Structural and cheap: admission needs a bound before anything stages.
    The JAX package's count (tenancy.py:101-119), kept so that both
    packages admit and evict alike."""
    itemsize = np.dtype(dtype or np.float64).itemsize
    operand = 0
    rows_local = 0
    for vals in A.values.part_values():
        arr = np.asarray(getattr(vals, "data", vals))
        operand += arr.size * itemsize
    for iset in A.rows.partition.part_values():
        rows_local += int(iset.num_lids)
    carry = 3 * rows_local * max(1, int(kmax)) * itemsize
    return int(operand + 2 * carry)


def _drop_device_state(A) -> None:
    """Page-out on the card: drop ``A``'s device staging (the `DeviceMatrix`
    objects, their cached solve functions and CUDA graphs), collect the
    reference cycles a cached solve function sits in, and give the freed
    blocks back to the driver, all under the card's `device_lock`, so no
    other thread is capturing meanwhile. Off CUDA only the cache is
    cleared."""
    idx = _cuda_index(A)
    with device_lock(idx):
        getattr(A, "_device", {}).clear()
        if idx is not None:
            import torch

            gc.collect()
            torch.cuda.synchronize(idx)
            torch.cuda.empty_cache()


class Tenant:
    """One registered operator and its serving state."""

    __slots__ = (
        "name", "A", "minv", "footprint_bytes", "svc", "resident",
        "last_used", "svc_kwargs", "checkpoint_dir", "evictions",
        "page_ins",
    )

    def __init__(self, name, A, minv, footprint_bytes, checkpoint_dir,
                 svc_kwargs):
        self.name = name
        self.A = A
        self.minv = minv
        self.footprint_bytes = int(footprint_bytes)
        self.svc: Optional[SolveService] = None
        self.resident = False
        self.last_used = 0.0
        self.svc_kwargs = dict(svc_kwargs)
        self.checkpoint_dir = checkpoint_dir
        self.evictions = 0
        self.page_ins = 0


class OperatorRegistry:
    """The multi-operator admission layer (see the module docstring).

    ``mem_budget_bytes`` overrides the config's ``mem_budget``; ``clock`` is
    the LRU/latency time source (injectable, like the service's);
    ``checkpoint_dir`` roots each tenant's eviction checkpoints at
    ``<dir>/<tenant>``; ``start_workers=True`` starts each paged-in
    service's worker thread (the live-server mode; synchronous ``drain``
    callers keep it off). Tenants on one card take turns on it through the
    card's `service.device_lock`."""

    def __init__(
        self,
        mem_budget_bytes: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        start_workers: bool = False,
    ):
        self.budget = (
            mem_budget() if mem_budget_bytes is None
            else max(0, int(mem_budget_bytes))
        )
        self.checkpoint_dir = checkpoint_dir
        self.clock = clock if clock is not None else time.monotonic
        self.start_workers = bool(start_workers)
        #: Optional hook called AFTER a tenant is paged out (the gate
        #: requeues the eviction's suspended and checkpointed requests
        #: here, so they resume after the next page-in). Called holding
        #: the registry lock; the hook may take the gate lock (`Gate`
        #: never takes the registry lock inside its own).
        self.on_evict: Optional[Callable[[str, "Tenant"], None]] = None
        #: Optional hook called AFTER a tenant is paged in (a fresh
        #: `SolveService` built): the journaling gate installs its
        #: chunk-boundary checkpoint hook here, so paging never makes an
        #: unjournaled service. Same lock discipline as ``on_evict``.
        self.on_page_in: Optional[Callable[[str, "Tenant"], None]] = None
        self._tenants: Dict[str, Tenant] = {}
        self._lock = sanitized(threading.RLock(), "OperatorRegistry._lock")
        if monitoring_enabled():
            registry().gauge("gate.mem_budget_bytes").set(self.budget)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def register(self, name: str, A, minv=None,
                 footprint_bytes: Optional[int] = None,
                 **svc_kwargs) -> Tenant:
        """Admit one named operator. ``footprint_bytes`` defaults to the
        `operator_footprint_bytes` shape sum at the service's slab width.
        Raises `TenantBudgetError` when the operator alone exceeds the
        budget; otherwise admits it and pages it in (evicting LRU
        residents as needed). ``svc_kwargs`` go to each `SolveService`."""
        from .. import telemetry

        kmax = svc_kwargs.get("kmax")
        fp = (
            operator_footprint_bytes(A, kmax if kmax else 8)
            if footprint_bytes is None
            else int(footprint_bytes)
        )
        ckpt = (
            os.path.join(self.checkpoint_dir, name)
            if self.checkpoint_dir is not None else None
        )
        with self._lock:
            # the whole admit decision runs under the lock: a racing
            # duplicate register must lose here, not double-insert
            check(name not in self._tenants,
                  f"gate: tenant {name!r} already registered")
            if self.budget and fp > self.budget:
                raise TenantBudgetError(
                    f"gate: operator {name!r} needs {fp} bytes but the "
                    f"budget is mem_budget={self.budget}: it can never "
                    "be served; raise the budget or shrink the slab",
                    diagnostics={
                        "tenant": name, "footprint_bytes": fp,
                        "budget_bytes": self.budget,
                    },
                )
            t = Tenant(name, A, minv, fp, ckpt, svc_kwargs)
            self._tenants[name] = t
            telemetry.emit_event(
                "tenant_registered", label=name, footprint_bytes=fp,
                budget_bytes=self.budget,
            )
            self._page_in(t)
            return t

    # ------------------------------------------------------------------
    # routing / paging
    # ------------------------------------------------------------------

    def tenant(self, name: str) -> Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise UnknownTenantError(
                f"gate: unknown tenant {name!r} (registered: "
                f"{sorted(self._tenants)})"
            )
        return t

    def service(self, name: str) -> SolveService:
        """The tenant's live service, paging it back in (and evicting LRU
        residents) when it was evicted. Touches the LRU clock."""
        with self._lock:
            t = self.tenant(name)
            if not t.resident:
                self._page_in(t)
            t.last_used = self.clock()
            return t.svc

    def submit(self, name: str, b, **kwargs):
        """Route one request to its tenant's service (the request-level
        admission, bounded queue and typed backpressure, stay the
        service's)."""
        return self.service(name).submit(b, **kwargs)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(
                t.footprint_bytes for t in self._tenants.values()
                if t.resident
            )

    def residency(self) -> List[dict]:
        """The tenancy table ``/v1/tenants`` serves."""
        with self._lock:
            return [
                {
                    "tenant": t.name,
                    "resident": t.resident,
                    "footprint_bytes": t.footprint_bytes,
                    "evictions": t.evictions,
                    "page_ins": t.page_ins,
                    "pending": t.svc.pending() if t.svc else 0,
                    "ngids": t.A.rows.ngids,
                }
                for _, t in sorted(self._tenants.items())
            ]

    def _page_in(self, t: Tenant) -> None:
        """Make ``t`` resident: evict LRU residents until it fits, then
        build a fresh `SolveService` (staging runs at its first slab).
        When a request's dispatch triggered this (the gate holds its trace
        context ambient), the page-in records a ``tenant.page_in`` span in
        that request's trace."""
        from ..telemetry import tracing

        page_span = None
        ctx = tracing.current_ctx()
        if ctx is not None:
            page_span = tracing.start_span(
                "tenant.page_in", name=t.name, parent=ctx,
            )
        try:
            self._page_in_body(t)
        except BaseException as e:
            # a failed page-in must not leak a live span
            if page_span is not None:
                page_span.end(status="error", error=type(e).__name__)
            raise
        if page_span is not None:
            page_span.end(footprint_bytes=t.footprint_bytes)
        self._update_gauges()

    def _page_in_body(self, t: Tenant) -> None:
        from .. import telemetry
        from .config import config

        if self.budget:
            # evict the least-recently-used resident until t fits;
            # register() guarantees t alone fits, so this terminates
            while self.resident_bytes() + t.footprint_bytes > self.budget:
                victims = [
                    v for v in self._tenants.values()
                    if v.resident and v is not t
                ]
                assert victims, "budget invariant broken"
                self.evict(min(victims, key=lambda v: v.last_used).name)
        kwargs = dict(t.svc_kwargs)
        kwargs.setdefault("retry_jitter", config().retry_jitter)
        t.svc = SolveService(
            t.A, minv=t.minv, checkpoint_dir=t.checkpoint_dir,
            clock=self.clock, **kwargs,
        )
        # the tenant name labels the service's forecast-error histogram
        # (spec.iters_rel_error{tenant=…})
        t.svc.name = t.name
        if self.start_workers:
            t.svc.start()
        t.resident = True
        t.page_ins += 1
        t.last_used = self.clock()
        if self.on_page_in is not None:
            self.on_page_in(t.name, t)
        registry().counter("gate.page_ins").inc()
        telemetry.emit_event(
            "tenant_paged_in", label=t.name,
            footprint_bytes=t.footprint_bytes,
            resident_bytes=self.resident_bytes(),
        )

    def evict(self, name: str) -> dict:
        """Page one tenant out: drain its in-flight slabs through the
        service's checkpoint path, drop its device state, mark it evicted.
        Returns the drained service's stats snapshot."""
        from .. import telemetry

        with self._lock:
            t = self.tenant(name)
            check(t.resident, f"gate: tenant {name!r} is not resident")
            stats = t.svc.shutdown(drain=False)
            # drop the device staging (DeviceMatrix, its solve functions
            # and their CUDA graphs all hang off A._device): the next
            # page-in stages and captures again
            _drop_device_state(t.A)
            t.svc = None
            t.resident = False
            t.evictions += 1
            registry().counter("gate.evictions").inc()
            telemetry.emit_event(
                "tenant_evicted", label=name,
                footprint_bytes=t.footprint_bytes,
                checkpointed=stats.get("checkpointed", 0),
                suspended=stats.get("suspended", 0),
                resident_bytes=self.resident_bytes(),
            )
            self._update_gauges()
            if self.on_evict is not None:
                self.on_evict(name, t)
            return stats

    def _update_gauges(self) -> None:
        if not monitoring_enabled():
            return
        reg = registry()
        reg.gauge("gate.resident_bytes").set(self.resident_bytes())
        reg.gauge("gate.mem_budget_bytes").set(self.budget)
        for t in self._tenants.values():
            labels = {"tenant": t.name}
            reg.gauge("gate.tenant_resident", labels=labels).set(
                1.0 if t.resident else 0.0
            )
            reg.gauge(
                "gate.tenant_footprint_bytes", labels=labels
            ).set(t.footprint_bytes)

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def shutdown(self, drain: bool = True) -> Dict[str, dict]:
        """Shut every resident tenant's service down (the ``drain``
        semantics of `SolveService.shutdown`); returns per-tenant stats."""
        out = {}
        with self._lock:
            for name, t in sorted(self._tenants.items()):
                if t.resident and t.svc is not None:
                    out[name] = t.svc.shutdown(drain=drain)
        return out

    def __repr__(self):
        with self._lock:
            res = sum(1 for t in self._tenants.values() if t.resident)
            return (
                f"OperatorRegistry(tenants={len(self._tenants)}, "
                f"resident={res}, bytes={self.resident_bytes()}/"
                f"{self.budget or 'inf'})"
            )
