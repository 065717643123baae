"""Admission control: the bounded front door of the solve service
(service/admission.py of the JAX package).

The service admits a request only while its queue holds fewer than
``queue_depth`` requests and it is not draining; anything else raises the
typed `AdmissionRejected` (machine-readable ``diagnostics``, mirrored as an
``admission_rejected`` event), so callers shed load or retry with backoff
(`utils.health.retry_with_backoff`).

The JAX package's ``PA_SERVE_*`` knobs are `SolveService` arguments here,
with the JAX package's defaults: ``queue_depth`` (``PA_SERVE_QUEUE_DEPTH``,
`DEFAULT_QUEUE_DEPTH`), ``kmax`` (``PA_SERVE_KMAX``, `DEFAULT_KMAX`, the
widest slab), ``chunk`` (``PA_SERVE_CHUNK``, `DEFAULT_CHUNK`, iterations a
chunk of a deadline-carrying slab) and ``retries`` (``PA_SERVE_RETRIES``,
`DEFAULT_RETRIES`, solo retries of an ejected column).
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "AdmissionRejected",
    "AdmissionController",
    "DEFAULT_TOL",
    "DEFAULT_QUEUE_DEPTH",
    "DEFAULT_KMAX",
    "DEFAULT_CHUNK",
    "DEFAULT_RETRIES",
]

#: The service-wide default convergence tolerance.
DEFAULT_TOL = 1e-8
#: Queued requests allowed before `AdmissionRejected` backpressure.
DEFAULT_QUEUE_DEPTH = 64
#: The widest slab the batcher coalesces.
DEFAULT_KMAX = 8
#: Iterations a chunk of a deadline-carrying slab: a device loop cannot stop
#: mid-solve, so deadlines are enforced at chunk boundaries; slabs with no
#: deadline run unchunked (one solve, which keeps co-batched trajectories
#: bitwise equal to solo solves).
DEFAULT_CHUNK = 25
#: Solo retry attempts for a column ejected from a shared slab.
DEFAULT_RETRIES = 1


class AdmissionRejected(RuntimeError):
    """The service refused to queue a request: bounded-queue backpressure
    (``reason="queue_full"``) or a draining/shut-down service
    (``reason="draining"``). ``diagnostics`` carries the reason, the queue
    depth and bound, and the request tag. Not a `SolverHealthError`:
    nothing about the solve is unhealthy, and recovery drivers must not
    burn restart budget on it."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})
        from ..telemetry import emit_event
        from ..telemetry.registry import registry

        # always on, labeled by reason: queue-full backpressure and a
        # draining service stay separable in the registry
        registry().counter(
            "service.rejected",
            labels={"reason": str(self.diagnostics.get("reason", ""))},
        ).inc()
        emit_event(
            "admission_rejected",
            label=str(self.diagnostics.get("reason", "")),
            tag=self.diagnostics.get("tag"),
            queued=self.diagnostics.get("queued"),
            depth=self.diagnostics.get("depth"),
        )


class AdmissionController:
    """The admit/refuse decision, factored out of the service so its
    policy is testable without a live queue."""

    def __init__(self, depth: Optional[int] = None):
        self.depth = DEFAULT_QUEUE_DEPTH if depth is None else max(1, int(depth))

    def admit(self, queued: int, draining: bool, tag: str = "") -> None:
        """Raise `AdmissionRejected` unless a request may join a queue
        currently holding ``queued`` entries."""
        if draining:
            raise AdmissionRejected(
                f"admission rejected ({tag or 'request'}): the service "
                "is draining/shut down and accepts no new requests",
                diagnostics={
                    "reason": "draining", "tag": tag,
                    "queued": int(queued), "depth": self.depth,
                },
            )
        if queued >= self.depth:
            raise AdmissionRejected(
                f"admission rejected ({tag or 'request'}): queue holds "
                f"{queued} requests (bound queue_depth={self.depth}) — "
                "shed load or retry with backoff",
                diagnostics={
                    "reason": "queue_full", "tag": tag,
                    "queued": int(queued), "depth": self.depth,
                },
            )
