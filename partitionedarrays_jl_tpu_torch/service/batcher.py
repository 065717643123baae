"""Slab coalescing: which queued requests may share one block solve
(service/batcher.py of the JAX package).

A block solve function bakes ``tol`` and ``maxiter`` into its device loop
(`parallel/gpu.py:_krylov_fn_for` keys both), and a (P, W, K) slab has one
dtype, so the compatibility key is exactly ``(tol, maxiter, dtype)``.
Coalescing is FIFO-anchored: the oldest queued request fixes the key, then
up to ``kmax`` FIFO-ordered compatible requests join it (incompatible ones
keep their place: every slab removes the current queue head). A slab
narrower than ``kmax`` is a ragged leftover and runs anyway; the service
tops chunked slabs back up with compatible late arrivals at chunk
boundaries.

``adaptive=True`` (the service's ``adaptive_k``, the JAX package's
``PA_SERVE_ADAPTIVE_K``; default off) caps the slab width at
`telemetry.throughput.suggest_k`'s per-RHS optimum for the queue head's
class: queue depth × the measured per-RHS curve.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = [
    "compat_key",
    "effective_kmax",
    "next_slab",
    "top_up",
    "queue_compat_profile",
]


def effective_kmax(queue: List, kmax: int, fingerprint: str,
                   anchor=None, base: int = 0, adaptive: bool = False) -> int:
    """The slab-width cap `next_slab` / `top_up` should run under:
    ``kmax`` verbatim while ``adaptive`` is off (or nothing anchors a
    compatibility class), else `suggest_k` over the anchor's class —
    the widest slab is feasible only up to the number of columns that
    could actually ride it, and the measured per-RHS curve picks the
    best width at or below that. ``anchor`` fixes the class (default:
    the queue head; a chunk-boundary `top_up` passes the RUNNING
    slab's head so the refill honors the same adaptive cap the slab
    was formed under) and ``base`` counts columns already riding
    (the running slab's width). An unmeasured operator falls back to
    the static ``min(depth, kmax)`` inside `suggest_k` itself."""
    if not adaptive:
        return int(kmax)
    head = anchor if anchor is not None else (queue[0] if queue else None)
    if head is None:
        return int(kmax)
    from ..telemetry.throughput import model

    key = compat_key(head)
    depth = int(base) + sum(
        1 for req in queue if compat_key(req) == key
    )
    return model().suggest_k(fingerprint, key[2], depth, int(kmax))


def compat_key(req) -> Tuple[float, object, str]:
    """The slab-compatibility key of a request: requests coalesce iff
    their keys are equal (see module docstring for why exactly these
    three)."""
    return (
        float(req.tol),
        None if req.maxiter is None else int(req.maxiter),
        str(np.dtype(req.b.dtype)),
    )


def next_slab(queue: List, kmax: int) -> List:
    """Pop the next slab off ``queue`` (mutated in place): the FIFO
    head plus up to ``kmax - 1`` later compatible requests, queue order
    preserved. Empty queue -> empty slab."""
    if not queue:
        return []
    key = compat_key(queue[0])
    picked, kept = [], []
    for req in queue:
        if len(picked) < int(kmax) and compat_key(req) == key:
            picked.append(req)
        else:
            kept.append(req)
    queue[:] = kept
    return picked


def queue_compat_profile(queue: List) -> List[dict]:
    """The coalescing view of a queue: one row per compatibility key,
    FIFO-ordered by each key's oldest request, with the count of
    requests that could ride one slab. A fragmented profile (many keys,
    small counts) means the batcher cannot amortize — the signal
    `SolveService.queue_profile` exposes."""
    order: List[Tuple[float, object, str]] = []
    counts: dict = {}
    for req in queue:
        key = compat_key(req)
        if key not in counts:
            counts[key] = 0
            order.append(key)
        counts[key] += 1
    return [
        {
            "tol": key[0],
            "maxiter": key[1],
            "dtype": key[2],
            "requests": counts[key],
        }
        for key in order
    ]


def top_up(queue: List, slab: List, kmax: int) -> List:
    """Re-batching at a chunk boundary: move queued requests compatible
    with the (non-empty) running ``slab`` into it, up to ``kmax`` total
    columns. Returns the requests added (already removed from
    ``queue``)."""
    if not slab or len(slab) >= int(kmax) or not queue:
        return []
    key = compat_key(slab[0])
    added, kept = [], []
    for req in queue:
        if len(slab) + len(added) < int(kmax) and compat_key(req) == key:
            added.append(req)
        else:
            kept.append(req)
    queue[:] = kept
    return added
