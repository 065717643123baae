"""The queued unit of the solve service: one request, its lifecycle,
and its future-style result surface (service/request.py of the JAX
package).

A request moves through::

    queued -> running -> done
                      -> failed        (typed error retained)
                      -> checkpointed  (non-drain shutdown: iterate saved)
    queued ----------> suspended       (non-drain shutdown before it ran)

`SolveService.submit` returns the `SolveRequest` itself — it doubles as
the handle: ``req.result()`` returns ``(x, info)`` for a finished
request and re-raises the retained TYPED error for a failed one (the
same `SolverHealthError` subclass a solo solve would have raised, so
callers keep one error vocabulary whether they batched or not). Every
request carries its own `SolveRecord` (``req.record``): the queue /
admission / slab / ejection events of its life, plus everything the
slab solves emitted while it was active.

``b`` and ``x0`` stay host `PVector`s: the service stages them on the
device in the thread that runs the slabs, so a submitting thread never
touches the card.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["SolveRequest"]

#: Lifecycle states (strings, not an enum: they serialize into events
#: and records as-is).
_STATES = (
    "queued", "running", "done", "failed", "checkpointed", "suspended",
)


class SolveRequest:
    """One admitted solve request. Constructed by `SolveService.submit`
    only — the service assigns the id, opens the record, and stamps the
    submission clock reading (deadlines are measured from it)."""

    def __init__(
        self,
        rid: int,
        b,
        x0=None,
        tol: float = 1e-8,
        maxiter: Optional[int] = None,
        deadline: Optional[float] = None,
        retries: int = 1,
        tag: str = "",
    ):
        self.id = int(rid)
        self.b = b
        self.x0 = x0
        self.tol = float(tol)
        self.maxiter = None if maxiter is None else int(maxiter)
        #: Relative wall-clock budget in seconds (service clock units),
        #: measured from submission; None = no deadline.
        self.deadline = None if deadline is None else float(deadline)
        self.retries = int(retries)
        self.tag = tag or f"req-{rid}"
        self.state = "queued"
        self.submitted_at: float = 0.0  # stamped by the service
        #: Service-clock reading at the terminal transition (None while
        #: queued/running) — submitted_at..finished_at is the request's
        #: total latency, the `service.total_s` histogram's unit of
        #: account.
        self.finished_at: Optional[float] = None
        self.iterations = 0  # committed across chunks
        self.record = None  # SolveRecord, opened by the service
        #: Tracing context (`telemetry.tracing.TraceContext`) propagated by
        #: the submitter; None = untraced request. The service opens
        #: its ``slab.solve``/``chunk`` spans under it.
        self.trace = None
        self._span_solve = None  # live slab.solve Span while running
        self.checkpoint_path: Optional[str] = None
        self._x = None
        self._info = None
        self._error: Optional[BaseException] = None
        self.forecast: Optional[dict] = None  # the spectrum forecast, if any

    # -- state transitions (service-internal) ----------------------------
    def _set_state(self, state: str) -> None:
        assert state in _STATES, state
        self.state = state

    def _resolve(self, x, info) -> None:
        self._x, self._info = x, info
        self._set_state("done")

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._set_state("failed")

    # -- the handle surface ----------------------------------------------
    def done(self) -> bool:
        """Terminal in any way: a result, a failure, or a shutdown."""
        return self.state not in ("queued", "running")

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self):
        """``(x, info)`` of a finished request; re-raises the retained
        typed error for a failed one. Raises `RuntimeError` while the
        request is still queued/running (the service is pull-driven:
        call `SolveService.drain` / `step`, or run the worker thread)
        and for shutdown-terminated requests (checkpointed/suspended —
        resubmit from the checkpointed iterate instead)."""
        if self.state == "done":
            return self._x, self._info
        if self.state == "failed":
            raise self._error
        if self.state == "checkpointed":
            raise RuntimeError(
                f"request {self.id}: service shut down mid-solve; the "
                f"iterate was checkpointed at {self.checkpoint_path!r} "
                f"(iteration {self.iterations}) — load it and resubmit"
            )
        if self.state == "suspended":
            raise RuntimeError(
                f"request {self.id}: service shut down before the "
                "request ran — resubmit to a live service"
            )
        raise RuntimeError(
            f"request {self.id} is still {self.state} — drive the "
            "service (drain()/step()) before asking for the result"
        )

    def __repr__(self):
        return (
            f"SolveRequest(id={self.id}, tag={self.tag!r}, "
            f"state={self.state!r}, it={self.iterations})"
        )
