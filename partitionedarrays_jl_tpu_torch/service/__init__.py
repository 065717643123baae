"""The fault-isolating solve service (service/ of the JAX package).

A long-lived in-process service (`SolveService`) over one operator: many
concurrent requests (same ``A``, different ``b``, per-request
tol/maxiter/deadline) queued under bounded admission (`AdmissionRejected`
backpressure), coalesced into (P, W, K) slabs for the block CG device loop
(`parallel/gpu.py:gpu_block_cg`) and re-batched at chunk boundaries. A
poisoned column is ejected from its slab (failed typed, or retried solo)
while every co-batched request finishes bitwise equal to its solo solve:
the block loop freezes each column where its solo loop would stop, and no
reduction or stopping flag carries one column into another.

Modules: `service.request` (`SolveRequest`, its lifecycle and result
surface), `service.admission` (the bounded queue, `AdmissionRejected`,
the defaults of the service's knobs), `service.batcher` (FIFO coalescing
by ``(tol, maxiter, dtype)``), `service.service` (`SolveService`: submit,
drain, the worker thread, shutdown, chunked deadlines, ejection and solo
retry, checkpointing, telemetry; `device_lock`, the card's lock every slab
holds, so services on one card take turns).
"""
from .admission import (  # noqa: F401
    DEFAULT_CHUNK,
    DEFAULT_KMAX,
    DEFAULT_QUEUE_DEPTH,
    DEFAULT_RETRIES,
    DEFAULT_TOL,
    AdmissionController,
    AdmissionRejected,
)
from .batcher import (  # noqa: F401
    compat_key,
    effective_kmax,
    next_slab,
    queue_compat_profile,
    top_up,
)
from .request import SolveRequest  # noqa: F401
from .service import SolveService, device_lock  # noqa: F401

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "DEFAULT_CHUNK",
    "DEFAULT_KMAX",
    "DEFAULT_QUEUE_DEPTH",
    "DEFAULT_RETRIES",
    "DEFAULT_TOL",
    "SolveRequest",
    "SolveService",
    "compat_key",
    "device_lock",
    "effective_kmax",
    "next_slab",
    "queue_compat_profile",
    "top_up",
]
