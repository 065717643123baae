"""`SolveService`: the long-lived in-process request layer over one operator
(service/service.py of the JAX package).

One service serves one operator ``A``: the device staging, the cached
block solve functions and their CUDA graphs are all per ``A``. A request's
life:

1. **submit** — admission control (`service.admission`): bounded queue
   and draining check, typed `AdmissionRejected` backpressure. An admitted
   request gets a `SolveRecord` and a ``request_queued`` event.
2. **coalesce** — `service.batcher.next_slab` groups FIFO-compatible
   requests (same tol/maxiter/dtype) into one (P, W, K) slab, K ≤
   ``kmax``; ragged leftovers run as they are and are topped back up with
   compatible late arrivals at chunk boundaries.
3. **solve** — one ``cg``/``pcg`` block call with
   ``column_errors="report"``: on a `GPUBackend` one device loop
   (`gpu_block_cg`, the block kernels `dia_coded_spmm`, `cg_sweep_block`
   and `block_products` on a band operator) from the operator's cached
   solve functions; on the host backend the solo-loop oracle. The service
   adds no work an iteration: containment rides the block loop's
   per-column freeze.
4. **verdict** — at each chunk boundary the per-column verdicts are read:
   converged columns resolve, poisoned columns are ejected (failed, or
   retried solo through `retry_with_backoff`; with a ``checkpoint_dir``
   the solo path is `solve_with_recovery`), expired deadlines fail typed
   (`SolveDeadlineError`), everyone else continues into the next chunk.
   Slabs with no deadline run unchunked, one solve, so co-batched
   survivors finish bitwise equal to their solo solves.
5. **drain/shutdown** — `shutdown(drain=True)` refuses new admissions and
   finishes the queue; ``drain=False`` also stops at the next chunk
   boundary, checkpointing in-flight iterates and suspending never-started
   requests.

Drive it synchronously (``step()`` / ``drain()``) or start the background
worker (``start()``). Threads and the card: a request keeps its host
`PVector`s until its slab runs, and the slab stages them, so every device
operation of a service (staging, the block solve, a CUDA-graph capture)
runs on the thread that runs its slabs; a submitting thread never touches
the card, and a capture in the worker sees no other thread's work on the
device (torch's global capture mode, and `dia.LAUNCHES`, rely on that).
Several services on one card (the front door's tenants, each with its own
worker) take turns: a slab runs holding the card's process-wide
`device_lock`, so one service's capture never sees another's work. The
worker sets the operator's CUDA device before its first slab.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional

from ..telemetry import spectrum, tracing
from ..telemetry.registry import monitoring_enabled, registry
from ..telemetry.throughput import model as throughput_model
from ..telemetry.throughput import operator_fingerprint
from ..utils.helpers import check
from ..utils.locksan import sanitized
from .admission import (
    DEFAULT_CHUNK,
    DEFAULT_KMAX,
    DEFAULT_RETRIES,
    DEFAULT_TOL,
    AdmissionController,
)
from .batcher import compat_key, effective_kmax, next_slab, top_up
from .request import SolveRequest

__all__ = ["SolveService", "device_lock"]

_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(index: Optional[int]):
    """The process-wide lock of CUDA device ``index``: every slab of every
    `SolveService` on that card runs holding it, and so does the front
    door's page-out, so that a CUDA-graph capture on one thread never sees
    another thread's work on the card. ``None`` (a host operator) gives a
    context that locks nothing."""
    if index is None:
        return contextlib.nullcontext()
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(index)
        if lock is None:
            lock = _DEVICE_LOCKS[index] = sanitized(threading.RLock(), f"device_lock[{index}]")
        return lock


def _cuda_index(A) -> Optional[int]:
    """The CUDA device index of ``A``'s backend (its current device where
    the backend names ``cuda`` without one), or None off CUDA."""
    dev = getattr(A.values.backend, "device", None)
    if dev is None or dev.type != "cuda":
        return None
    if dev.index is not None:
        return int(dev.index)
    import torch

    return int(torch.cuda.current_device())


def _tol_class(tol: float) -> str:
    """The SLO tolerance class of a request: its convergence target in
    one-significant-digit scientific form (1e-08, 1e-06, ...) — the
    label `service.slo.*` attainment is accounted per."""
    return f"{float(tol):.0e}"


class SolveService:
    """A long-lived in-process solve service over one operator ``A``
    (see module docstring for the request lifecycle).

    Parameters (the JAX package's ``PA_SERVE_*`` knobs are the first
    five, with its defaults): ``minv`` — optional shared preconditioner
    (diagonal PVector or callable; slabs then run ``pcg``); ``kmax``
    (widest slab, 8), ``queue_depth`` (admission bound, 64), ``chunk``
    (iterations a chunk of a deadline-carrying slab, 25), ``retries``
    (solo retries of an ejected column, 1), ``adaptive_k`` (cap slab
    widths at the throughput model's `suggest_k`, off);
    ``retry_backoff`` — the solo retry backoff seconds (default 0.0);
    ``retry_jitter`` — a seed that draws each retry delay at random
    (``PA_RETRY_JITTER``; None: no jitter); ``strict`` — strict-bits mode
    for every solve (``PA_TPU_STRICT_BITS``);
    ``checkpoint_dir`` — when set, solo retries run under
    `solve_with_recovery` rooted there and a non-drain shutdown
    checkpoints in-flight iterates there; ``clock`` / ``sleep`` —
    injectable time sources (deadlines are measured in ``clock`` units
    from submission).
    """

    def __init__(
        self,
        A,
        minv=None,
        kmax: Optional[int] = None,
        queue_depth: Optional[int] = None,
        chunk: Optional[int] = None,
        retries: Optional[int] = None,
        adaptive_k: bool = False,
        retry_backoff: float = 0.0,
        retry_jitter: Optional[int] = None,
        strict: bool = False,
        checkpoint_dir: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self.A = A
        self.minv = minv
        self.kmax = DEFAULT_KMAX if kmax is None else max(1, int(kmax))
        self.chunk = DEFAULT_CHUNK if chunk is None else max(1, int(chunk))
        self.retries = (
            DEFAULT_RETRIES if retries is None else max(0, int(retries))
        )
        self.adaptive_k = bool(adaptive_k)
        self.retry_backoff = max(0.0, float(retry_backoff))
        self.retry_jitter = retry_jitter
        self.strict = bool(strict)
        self.checkpoint_dir = checkpoint_dir
        self.clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self.admission = AdmissionController(queue_depth)
        #: Structural operator identity: the throughput-model key this
        #: service's finished slabs report their measured s_per_it under.
        self.fingerprint = operator_fingerprint(A)
        #: Tenant name (the front door stamps it at page-in) — the
        #: ``spec.iters_rel_error{tenant=…}`` label; falls back to the
        #: fingerprint for unnamed in-process services.
        self.name: Optional[str] = None
        #: The spectrum-store preconditioner-class axis of this
        #: service's solves (the spectrum forecasts read the same key). The
        #: VALUE-sensitive spectral identity itself is resolved lazily
        #: in `_forecast` (spectrum_fingerprint caches its one O(nnz)
        #: digest on the matrix), so a service with ``spec`` off never
        #: pays it.
        self._minv_class = spectrum.minv_class_of(minv)
        #: Per-instance token qualifying request checkpoint paths:
        #: request ids are process-local monotonic, so a re-built
        #: service (an evicted tenant paged back in) would otherwise
        #: reuse ``req-0`` and `solve_with_recovery` could resume a
        #: DIFFERENT request's stale iterate from the shared dir.
        import secrets as _secrets

        self._uid = _secrets.token_hex(3)
        #: Optional chunk-boundary hook ``(request, iterate) -> None``,
        #: called for every still-running request of a CHUNKED slab
        #: after each chunk's verdicts (a journaling front door
        #: checkpoints in-flight iterates here); the unchunked path has
        #: no boundaries and never calls it.
        self.on_chunk: Optional[Callable] = None
        self._queue: list = []
        self._lock = sanitized(threading.RLock(), "SolveService._lock")
        self._cv = threading.Condition(self._lock)
        self._draining = False
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        #: what ended the worker thread abnormally; `shutdown` re-raises it
        #: instead of finishing the queue on the calling thread
        self._worker_error: Optional[BaseException] = None
        #: the operator's CUDA device index, resolved on the constructing
        #: thread (a device named without an index is that thread's
        #: current device); None off CUDA
        self._cuda_index = _cuda_index(A)
        self._next_id = 0
        self.stats = {
            "admitted": 0,
            "rejected": 0,
            "infeasible": 0,
            "predicted": 0,
            "slabs": 0,
            "completed": 0,
            "failed": 0,
            "ejected": 0,
            "retried_solo": 0,
            "deadline_expired": 0,
            "checkpointed": 0,
            "suspended": 0,
        }

    # ------------------------------------------------------------------
    # the front door
    # ------------------------------------------------------------------

    def submit(
        self,
        b,
        x0=None,
        tol: float = DEFAULT_TOL,
        maxiter: Optional[int] = None,
        deadline: Optional[float] = None,
        retries: Optional[int] = None,
        tag: str = "",
        trace=None,
        r0_norm: Optional[float] = None,
    ) -> SolveRequest:
        """Admit one request (or raise `AdmissionRejected`); returns the
        request, which doubles as the result handle. ``deadline`` is a
        relative wall-clock budget in seconds (service clock units).
        ``trace`` is an optional `telemetry.tracing.TraceContext` the
        submitter propagates; the service then opens its slab/chunk
        spans under it and stamps the request record (untraced submits
        stay span-free). ``r0_norm`` is an optional precomputed ``‖b‖``
        for the spectrum forecast. ``b`` and ``x0`` are host PVectors:
        nothing here runs on the device."""
        from .. import telemetry

        check(tol > 0.0, "service: tol must be positive")
        check(
            maxiter is None or int(maxiter) >= 1,
            "service: maxiter must be >= 1",
        )
        check(
            deadline is None or float(deadline) > 0.0,
            "service: deadline must be positive seconds",
        )
        # spectrum admission: forecast the request's cost from the
        # spectrum store and the throughput model (host-side). With
        # spec_admit on an infeasible deadline is refused typed HERE,
        # before any iteration runs; otherwise the forecast only stamps
        # the record. Unmeasured operators always pass.
        forecast = self._forecast(
            b, x0, tol, deadline, tag, r0_norm=r0_norm
        )
        with self._lock:
            tag = tag or f"req-{self._next_id}"
            try:
                self.admission.admit(len(self._queue), self._draining, tag)
            except Exception:
                self.stats["rejected"] += 1
                raise
            req = SolveRequest(
                self._next_id, b, x0=x0, tol=tol, maxiter=maxiter,
                deadline=deadline,
                retries=self.retries if retries is None else int(retries),
                tag=tag,
            )
            self._next_id += 1
            req.submitted_at = self.clock()
            req.trace = trace
            req.forecast = forecast
            with tracing.ambient(trace):
                req.record = telemetry.begin_record(
                    "service-request", request=req.tag, tol=float(tol),
                    maxiter=maxiter, deadline=deadline,
                )
                if forecast is not None:
                    # the prediction rides the record: realized error
                    # is stamped at the terminal state (_slo_account)
                    req.record.config["forecast"] = dict(forecast)
                    self.stats["predicted"] += 1
                    registry().counter("spec.predictions").inc()
                self.stats["admitted"] += 1
                registry().counter("service.admitted").inc()
                telemetry.emit_event(
                    "request_queued", label=req.tag, tol=float(tol),
                    deadline=deadline, queued=len(self._queue) + 1,
                )
            self._queue.append(req)
            if monitoring_enabled():
                registry().gauge("service.queue_depth").set(
                    len(self._queue)
                )
            self._cv.notify_all()
            return req

    def _forecast(self, b, x0, tol, deadline, tag,
                  r0_norm: Optional[float] = None) -> Optional[dict]:
        """The spectrum admission forecast for one request (host-side):
        predicted iterations and seconds from the spectrum store and the
        throughput model, or ``None`` while the operator is unmeasured
        (or ``spec`` is off). Warm starts forecast their remaining work
        (``‖b − A·x0‖``). With ``spec_admit`` on a deadline-carrying
        request whose predicted cost exceeds its deadline raises the
        typed `DeadlineInfeasible`, counted in ``stats["infeasible"]``
        and ``spec.infeasible``, never dispatched."""
        from ..utils.health import DeadlineInfeasible

        if not spectrum.spec_enabled():
            return None
        import numpy as _np

        dt = str(_np.dtype(b.dtype))
        # lazy: one cached O(nnz) digest per operator, paid at the
        # first forecast rather than at service construction
        spec_fp = spectrum.spectrum_fingerprint(self.A)
        # the common case — an unmeasured operator — must cost nothing:
        # only a measured spec is worth the O(n) norm below
        if not spectrum.has_spec(spec_fp, dt, self._minv_class):
            return None
        r0 = (
            float(r0_norm) if r0_norm is not None
            else spectrum.residual_norm(self.A, b, x0)
        )
        if deadline is not None and spectrum.spec_admit_enabled():
            try:
                return spectrum.check_deadline_feasible(
                    spec_fp, dt, self._minv_class, tol,
                    float(deadline), r0_norm=r0, tag=tag,
                    where="service",
                    cost_fingerprint=self.fingerprint,
                )
            except DeadlineInfeasible:
                with self._lock:
                    self.stats["infeasible"] += 1
                raise
        return spectrum.admission_prediction(
            spec_fp, dt, self._minv_class, tol,
            r0_norm=r0, cost_fingerprint=self.fingerprint,
        )

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def queue_profile(self) -> list:
        """Per-compat-key composition of the current queue (see
        `batcher.queue_compat_profile`): the coalescing-efficiency
        view."""
        from .batcher import queue_compat_profile

        with self._lock:
            return queue_compat_profile(self._queue)

    def _bump(self, key: str, n: int = 1) -> None:
        """Tick ``self.stats`` under the service lock: the worker thread
        and a synchronous driver both land terminal stats, so a bare
        ``+= 1`` (read-modify-write) could lose ticks."""
        with self._lock:
            self.stats[key] += n

    # ------------------------------------------------------------------
    # synchronous drivers
    # ------------------------------------------------------------------

    def _pop_slab(self) -> list:
        """`next_slab` plus the queue-depth gauge update (callers hold
        ``self._lock``). With ``adaptive_k`` the width cap comes from the
        measured per-RHS curve (`batcher.effective_kmax` ->
        `throughput.suggest_k`) instead of the static kmax."""
        slab = next_slab(
            self._queue,
            effective_kmax(self._queue, self.kmax, self.fingerprint,
                           adaptive=self.adaptive_k),
        )
        if slab and monitoring_enabled():
            registry().gauge("service.queue_depth").set(len(self._queue))
        return slab

    def step(self) -> int:
        """Coalesce and run ONE slab; returns the number of requests it
        terminated (0 = queue empty)."""
        with self._lock:
            slab = self._pop_slab()
        if not slab:
            return 0
        with device_lock(self._cuda_index):
            return self._run_slab(slab)

    def drain(self) -> None:
        """Run slabs until the queue is empty."""
        while self.step():
            pass

    # ------------------------------------------------------------------
    # the worker thread (live-server mode)
    # ------------------------------------------------------------------

    def start(self) -> "SolveService":
        """Start the background worker; returns self. Synchronous
        ``step``/``drain`` must not race it — pick one driving mode."""
        check(
            self._worker is None or not self._worker.is_alive(),
            "service: worker already running",
        )
        with self._lock:
            self._stop = False
        self._worker = threading.Thread(
            target=self._work, daemon=True, name="pa-solve-service"
        )
        self._worker.start()
        return self

    def _work(self) -> None:
        try:
            if self._cuda_index is not None:
                # the worker runs every device operation of the service
                import torch

                torch.cuda.set_device(self._cuda_index)
            while True:
                with self._lock:
                    while not self._queue and not self._stop and not (
                        self._draining
                    ):
                        self._cv.wait(timeout=0.05)
                    if self._stop or (self._draining and not self._queue):
                        return
                    slab = self._pop_slab()
                if slab:
                    with device_lock(self._cuda_index):
                        self._run_slab(slab)
        except BaseException as e:  # the thread's boundary: shutdown re-raises
            self._worker_error = e

    def shutdown(self, drain: bool = True) -> dict:
        """Refuse new admissions; ``drain=True`` finishes every queued
        request first, ``drain=False`` stops at the next chunk boundary
        (checkpointing in-flight iterates when the service has a
        ``checkpoint_dir``) and SUSPENDS never-started requests.
        Returns a snapshot of ``stats``."""
        from .. import telemetry

        with self._lock:
            self._draining = True
            if not drain:
                self._stop = True
            self._cv.notify_all()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join()
        if self._worker_error is not None:
            # a failed slab (a failed capture included) is not rerun on
            # this thread: nothing falls back
            raise RuntimeError(
                "service: the worker thread failed; queued requests were "
                "not run"
            ) from self._worker_error
        if drain:
            self.drain()
        else:
            with self._lock:
                leftover, self._queue = list(self._queue), []
            for req in leftover:
                self._suspend(req)
        with self._lock:
            stats = dict(self.stats)
        telemetry.emit_event(
            "service_shutdown", label="drain" if drain else "stop",
            **stats,
        )
        return stats

    # ------------------------------------------------------------------
    # slab execution
    # ------------------------------------------------------------------

    def _block_solve(self, B, X0, tol, maxiter):
        from ..models.solvers import cg, pcg

        if self.minv is not None:
            return pcg(
                self.A, B=B, X0=X0, minv=self.minv, tol=tol,
                maxiter=maxiter, column_errors="report", strict=self.strict,
            )
        return cg(
            self.A, B=B, X0=X0, tol=tol, maxiter=maxiter,
            column_errors="report", strict=self.strict,
        )

    def _run_slab(self, slab) -> int:
        from .. import telemetry

        key = compat_key(slab[0])
        tol, key_maxiter, _ = key
        budget = (
            key_maxiter
            if key_maxiter is not None
            else 4 * self.A.rows.ngids
        )
        self._bump("slabs")
        reg = registry()
        slabs = reg.counter("service.slabs").inc()
        ragged = reg.counter_value("service.slabs_ragged")
        if len(slab) < self.kmax:
            ragged = reg.counter("service.slabs_ragged").inc()
        mon = monitoring_enabled()
        formed = self.clock()
        if mon:
            reg.gauge("service.slab_utilization").set(
                len(slab) / self.kmax
            )
            reg.gauge("service.ragged_fraction").set(ragged / slabs)
            qw = reg.histogram("service.queue_wait_s")
            for r in slab:
                qw.observe(max(0.0, formed - r.submitted_at))
        telemetry.emit_event(
            "slab_formed", label=f"K={len(slab)}",
            requests=[r.tag for r in slab], tol=tol, maxiter=key_maxiter,
        )
        active = list(slab)
        X = {r.id: r.x0 for r in active}
        for r in active:
            r._set_state("running")
            self._open_solve_span(r, len(slab))
        # deadline-free slabs run UNCHUNKED: one device solve, which
        # is the bitwise-containment mode (chunk continuation restarts
        # conjugacy — a different trajectory, and worth it only for
        # deadline enforcement). Chunk verdicts are re-derived against
        # the request's ORIGINAL convergence target (`_chunk_verdict`):
        # each chunk is a fresh cg call whose relative test would
        # otherwise re-baseline to the chunk-start residual.
        chunked = any(r.deadline is not None for r in active)
        targets: dict = {}
        done = 0
        first_dispatch = True
        if mon:
            reg.gauge("service.inflight_slabs").inc()
        try:
            done = self._slab_loop(
                active, X, tol, key, budget, chunked, targets,
                formed, first_dispatch, mon, reg, done,
            )
        finally:
            if mon:
                reg.gauge("service.inflight_slabs").dec()
        return done

    def _slab_loop(self, active, X, tol, key, budget, chunked, targets,
                   formed, first_dispatch, mon, reg, done):
        from .. import telemetry
        from ..parallel.pvector import PVector

        _, key_maxiter, key_dtype = key
        while active:
            remaining = min(budget - r.iterations for r in active)
            step = min(self.chunk, remaining) if chunked else remaining
            X0 = [X[r.id] for r in active]
            if any(x is not None for x in X0):
                X0 = [
                    x
                    if x is not None
                    else PVector.full(0.0, self.A.cols, dtype=r.b.dtype)
                    for x, r in zip(X0, active)
                ]
            else:
                X0 = None
            if mon and first_dispatch:
                reg.histogram("service.slab_wait_s").observe(
                    max(0.0, self.clock() - formed)
                )
            first_dispatch = False
            chunk_spans = {
                r.id: tracing.start_span(
                    "chunk", name=r.tag, parent=r._span_solve,
                )
                for r in active if r._span_solve is not None
            }
            # the block solve's own nested record joins the trace of
            # the slab's first traced member (K co-batched traces, one
            # block call — the per-request story stays in the spans)
            slab_ctx = next(
                (r.trace for r in active if r.trace is not None), None
            )
            t_solve = time.perf_counter()
            with tracing.ambient(slab_ctx):
                xs, info = self._block_solve(
                    [r.b for r in active], X0, tol, max(1, step)
                )
            solve_wall = time.perf_counter() - t_solve
            for k, r in enumerate(active):
                sp = chunk_spans.get(r.id)
                if sp is not None:
                    sp.end(
                        iterations=int(info["columns"][k]["iterations"])
                    )
            trips = max(
                (int(c["iterations"]) for c in info["columns"]),
                default=0,
            )
            if mon:
                reg.histogram("service.solve_s").observe(solve_wall)
                if trips > 0:
                    # the adaptive-K input: measured s_per_it at THIS
                    # slab width, EWMAed into the throughput model
                    throughput_model().observe_slab(
                        self.fingerprint, key_dtype, len(active),
                        solve_wall / trips, trips,
                    )
            now = self.clock()
            still = []
            for k, r in enumerate(active):
                col = info["columns"][k]
                verdict = info["column_health"][k]
                r.iterations += int(col["iterations"])
                if chunked:
                    col = self._chunk_verdict(r, col, tol, targets)
                if verdict["status"] != "ok":
                    self._eject(r, verdict, now)
                    done += 1
                elif col["converged"]:
                    self._finish(r, xs[k], col)
                    done += 1
                elif (
                    r.deadline is not None
                    and now - r.submitted_at > r.deadline
                ):
                    self._expire(r, now)
                    done += 1
                elif r.iterations >= budget or int(col["iterations"]) == 0:
                    # budget exhausted, or the chunk made no progress
                    # (a frozen breakdown column, a stalled host loop):
                    # terminal — the solver contract is a returned
                    # converged=False info, not an error, and spinning
                    # on a frozen column forever is not an option
                    self._finish(r, xs[k], col)
                    done += 1
                else:
                    X[r.id] = xs[k]
                    still.append(r)
            active = still
            if chunked and active and self.on_chunk is not None:
                # chunk-boundary durability hook (a journaling front door
                # checkpoints the live iterates) — BEFORE the stop
                # check, so even the final pre-shutdown chunk is saved
                for r in active:
                    self.on_chunk(r, X[r.id])
            if not active:
                break
            with self._lock:
                stopping = self._stop
            if stopping:
                # non-drain shutdown: checkpoint the in-flight iterates
                # at this chunk boundary and stop
                for r in active:
                    self._checkpoint(r, X[r.id])
                    done += 1
                break
            # re-batch ragged leftovers: compatible late arrivals join
            # the running slab at the chunk boundary — under the SAME
            # adaptive cap the slab was formed with (effective_kmax
            # anchored on the running slab), not the static kmax
            with self._lock:
                added = top_up(
                    self._queue, active,
                    effective_kmax(
                        self._queue, self.kmax, self.fingerprint,
                        anchor=active[0], base=len(active),
                        adaptive=self.adaptive_k,
                    ),
                )
                if added and mon:
                    reg.gauge("service.queue_depth").set(len(self._queue))
            for r in added:
                r._set_state("running")
                self._open_solve_span(r, len(active) + len(added))
                X[r.id] = r.x0
            if added:
                if mon:
                    join = self.clock()
                    qw = reg.histogram("service.queue_wait_s")
                    for r in added:
                        qw.observe(max(0.0, join - r.submitted_at))
                    reg.gauge("service.slab_utilization").set(
                        (len(active) + len(added)) / self.kmax
                    )
                telemetry.emit_event(
                    "slab_formed", label=f"K={len(active) + len(added)}",
                    requests=[r.tag for r in active + added],
                    tol=tol, maxiter=key_maxiter, topped_up=True,
                )
            active = active + added
        return done

    def _chunk_verdict(self, req, col, tol, targets):
        """Chunk continuation must NOT re-baseline the convergence
        criterion: each chunk is a fresh ``cg`` call whose relative
        test runs against the CHUNK-start residual, which re-baselines
        the request's contract as the solve progresses (usually
        tightening it — burning extra iterations against the deadline —
        and, when a chunk boundary lands on a residual spike, loosening
        it into a false ``converged``). The request's true target is
        fixed at its FIRST chunk — ``tol·max(1, ‖r0‖)`` with ``r0 =
        b − A·x0`` of the original start — and every chunk's converged
        flag is re-derived against that target here."""
        hist = [float(v) for v in col.get("residuals", [])]
        if not hist:
            return col
        if req.id not in targets:
            targets[req.id] = tol * max(1.0, hist[0])
        converged = hist[-1] <= targets[req.id]
        if bool(col.get("converged")) == converged:
            return col
        col = dict(col)
        col["converged"] = converged
        # keep the _host_block_solve invariant: status never reads
        # 'converged' while converged is False (and vice versa)
        col["status"] = "converged" if converged else "maxiter"
        return col

    # ------------------------------------------------------------------
    # per-request terminal transitions
    # ------------------------------------------------------------------

    def _open_solve_span(self, req, k: int) -> None:
        """One per-REQUEST ``slab.solve`` span (K co-batched requests
        get K parallel spans over the same wall window — each request's
        tree stays single-parented). Untraced requests stay span-free."""
        if req.trace is not None and req._span_solve is None:
            req._span_solve = tracing.start_span(
                "slab.solve", name=req.tag, parent=req.trace, k=int(k),
            )

    def _close_solve_span(self, req, status: str) -> None:
        sp = req._span_solve
        if sp is not None:
            sp.end(status=status, iterations=req.iterations)
            req._span_solve = None

    def _slo_account(self, req, succeeded: bool) -> None:
        """Terminal-state SLO bookkeeping: the total-latency histogram
        for every request, plus — for deadline-carrying requests — the
        per-tolerance-class attainment counters and the deadline-slack
        histogram (slack clamps at 0 for missed deadlines so the
        distribution stays nonnegative; the miss itself is the
        requests-vs-hits counter gap). The attainment COUNTERS are
        always on like every other counter; ``mon`` gates only the
        two histograms here."""
        req.finished_at = self.clock()
        reg = registry()
        elapsed = max(0.0, req.finished_at - req.submitted_at)
        self._forecast_account(req, reg)
        slack = None
        if req.deadline is not None:
            labels = {"tol_class": _tol_class(req.tol)}
            reg.counter("service.slo.requests", labels=labels).inc()
            slack = req.deadline - elapsed
            if succeeded and slack >= 0.0:
                reg.counter("service.slo.hits", labels=labels).inc()
        if not monitoring_enabled():
            return
        reg.histogram("service.total_s").observe(elapsed)
        if slack is not None:
            reg.histogram("service.deadline_slack_s").observe(
                max(0.0, slack)
            )

    def _forecast_account(self, req, reg) -> None:
        """Close the forecast loop at the terminal state: realized
        |predicted − actual| / actual iteration error, observed into
        the ``spec.iters_rel_error{tenant=…}`` histogram and evented on
        the request record. No-op for unforecast requests or
        zero-iteration outcomes."""
        from .. import telemetry

        forecast = getattr(req, "forecast", None)
        if forecast is None or req.iterations <= 0:
            return
        predicted = int(forecast["predicted_iters"])
        rel = abs(predicted - req.iterations) / max(1, req.iterations)
        if monitoring_enabled():
            reg.histogram(
                "spec.iters_rel_error",
                labels={"tenant": self.name or self.fingerprint},
            ).observe(rel)
        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "forecast_checked", label=req.tag,
                iteration=req.iterations, predicted=predicted,
                rel_error=rel,
                predicted_s=forecast.get("predicted_s"),
            )

    def _finish(self, req, x, col_info, via: Optional[str] = None) -> None:
        from .. import telemetry

        info = dict(col_info)
        info["iterations"] = req.iterations
        info["request_id"] = req.id
        if via:
            info["resolved_via"] = via
        self._close_solve_span(req, "ok")
        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "request_done", label=req.tag,
                iteration=req.iterations,
                converged=bool(info.get("converged")),
                status=str(info.get("status")), via=via,
            )
        self._bump("completed")
        registry().counter("service.completed").inc()
        self._slo_account(req, succeeded=True)
        req._resolve(x, req.record.finish(info))

    def _fail(self, req, error) -> None:
        from .. import telemetry

        self._close_solve_span(req, "failed")
        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "request_failed", label=req.tag,
                iteration=req.iterations,
                error=type(error).__name__,
            )
        self._bump("failed")
        registry().counter("service.failed").inc()
        self._slo_account(req, succeeded=False)
        req.record.finish_error(error)
        req._fail(error)

    def _expire(self, req, now: float) -> None:
        from ..utils.health import SolveDeadlineError
        from .. import telemetry

        telemetry.emit_event(
            "deadline_expired", label=req.tag, iteration=req.iterations,
            deadline=req.deadline, elapsed=now - req.submitted_at,
        )
        self._bump("deadline_expired")
        registry().counter("service.deadline_expired").inc()
        self._fail(
            req,
            SolveDeadlineError(
                f"request {req.tag}: deadline of {req.deadline}s expired "
                f"after {now - req.submitted_at:.3f}s at the chunk "
                f"boundary ({req.iterations} iterations completed)",
                diagnostics={
                    "context": "service",
                    "request": req.tag,
                    "deadline_s": req.deadline,
                    "elapsed_s": now - req.submitted_at,
                    "iteration": req.iterations,
                },
            ),
        )

    def _eject(self, req, verdict, now: float) -> None:
        """A column the slab's verdict export flagged: fail it typed,
        or retry it SOLO (`retry_with_backoff`; `solve_with_recovery`
        when the service checkpoints) — its co-batched neighbors never
        see any of this."""
        from ..utils.health import (
            NonFiniteError,
            SolverHealthError,
            retry_with_backoff,
        )
        from .. import telemetry

        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "column_ejected", label=str(verdict.get("status")),
                iteration=req.iterations, request=req.tag,
            )
        self._bump("ejected")
        registry().counter("service.ejected").inc()
        error = verdict.get("error")
        if error is None:
            error = NonFiniteError(
                f"request {req.tag}: ejected from its slab with verdict "
                f"{verdict.get('status')!r} after {req.iterations} "
                "iterations (co-batched requests were unaffected)",
                diagnostics={
                    "context": "service",
                    "request": req.tag,
                    "verdict": dict(
                        (k, v) for k, v in verdict.items() if k != "error"
                    ),
                },
            )
        expired = (
            req.deadline is not None
            and now - req.submitted_at > req.deadline
        )
        if req.retries <= 0 or expired:
            self._fail(req, error)
            return
        from contextlib import nullcontext

        retry_span = (
            tracing.span(
                "chunk", name=req.tag, parent=req._span_solve,
                solo_retry=True,
            )
            if req._span_solve is not None else nullcontext()
        )
        try:
            with retry_span:
                if self.checkpoint_dir is not None:
                    # solve_with_recovery owns the WHOLE retry budget
                    # (its checkpoint-tier restarts ARE the attempts) —
                    # wrapping it in retry_with_backoff would multiply
                    # the budgets into retries × (1 + restarts) solves
                    x, info = self._solo(req)
                else:
                    x, info = retry_with_backoff(
                        lambda: self._solo(req),
                        attempts=req.retries,
                        backoff=self.retry_backoff,
                        exceptions=(SolverHealthError,),
                        describe=f"solve-service {req.tag} solo retry",
                        sleep=self._sleep,
                        jitter_seed=self.retry_jitter,
                        give_up=(
                            (
                                lambda: self.clock() - req.submitted_at
                                > req.deadline
                            )
                            if req.deadline is not None
                            else None
                        ),
                    )
        except SolverHealthError as e:
            self._fail(req, e)
            return
        self._bump("retried_solo")
        registry().counter("service.retried_solo").inc()
        req.iterations += int(info["iterations"])
        self._finish(req, x, info, via="solo_retry")

    def _solo(self, req):
        """One solo attempt for an ejected request: the per-request
        fault boundary. With a service ``checkpoint_dir`` this is
        `solve_with_recovery` carrying the request's ENTIRE retry
        budget as checkpoint-tier restarts (``req.retries`` solver
        invocations total — the caller must not wrap it in another
        retry loop); without one it is a bare solo solve (the caller's
        `retry_with_backoff` provides the attempts)."""
        from ..models.solvers import cg, pcg, solve_with_recovery

        if self.checkpoint_dir is not None:
            return solve_with_recovery(
                self.A, req.b,
                method="pcg" if self.minv is not None else "cg",
                checkpoint_dir=os.path.join(
                    self.checkpoint_dir, f"req-{self._uid}-{req.id}"
                ),
                every=self.chunk, max_restarts=max(0, req.retries - 1),
                minv=self.minv, x0=req.x0, tol=req.tol,
                maxiter=req.maxiter,
            )
        if self.minv is not None:
            return pcg(
                self.A, req.b, x0=req.x0, minv=self.minv, tol=req.tol,
                maxiter=req.maxiter, strict=self.strict,
            )
        return cg(
            self.A, req.b, x0=req.x0, tol=req.tol, maxiter=req.maxiter,
            strict=self.strict,
        )

    def _checkpoint(self, req, x) -> None:
        from .. import telemetry

        if x is None or self.checkpoint_dir is None:
            self._suspend(req)
            return
        from ..parallel.checkpoint import SolverCheckpointer

        d = os.path.join(
            self.checkpoint_dir, f"req-{self._uid}-{req.id}"
        )
        ck = SolverCheckpointer(d, every=1, async_write=False)
        ck.save_state(
            {"x": x},
            {
                "method": "pcg" if self.minv is not None else "cg",
                "it": req.iterations, "tol": req.tol,
                "request": req.tag,
            },
        )
        ck.wait()
        req.checkpoint_path = d
        self._close_solve_span(req, "checkpointed")
        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "request_checkpointed", label=req.tag,
                iteration=req.iterations, directory=d,
            )
        self._bump("checkpointed")
        registry().counter("service.checkpointed").inc()
        req.finished_at = self.clock()
        req.record.finish(
            {"status": "checkpointed", "iterations": req.iterations}
        )
        req._set_state("checkpointed")

    def _suspend(self, req) -> None:
        from .. import telemetry

        self._close_solve_span(req, "suspended")
        with tracing.ambient(req.trace):
            telemetry.emit_event(
                "request_suspended", label=req.tag,
                iteration=req.iterations,
            )
        self._bump("suspended")
        registry().counter("service.suspended").inc()
        req.finished_at = self.clock()
        req.record.finish({"status": "suspended"})
        req._set_state("suspended")

    def __repr__(self):
        return (
            f"SolveService(pending={self.pending()}, kmax={self.kmax}, "
            f"chunk={self.chunk}, stats={self.stats})"
        )
