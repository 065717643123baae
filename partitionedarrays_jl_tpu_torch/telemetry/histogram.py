"""Deterministic fixed-log-bucket latency histograms (telemetry/histogram.py
of the JAX package, with its bucket layout: the same observations give the
same JSON from either package).

The service observability plane needs latency DISTRIBUTIONS (queue
wait, solve time, deadline slack), not just counters — but a histogram
whose bucket layout depends on the data it saw cannot be merged across
workers, diffed across snapshots, or byte-compared in tests. This one
is deterministic by construction:

* **Fixed boundaries.** The bucket edges are a pure function of the
  module constants (`10^(DECADES[0] + i/STEPS_PER_DECADE)` seconds,
  spanning 0.1 µs to ~10 000 s), never of the observations. Two
  histograms fed the same values are byte-identical; histograms fed
  different values are ALWAYS mergeable (`merge` is associative and
  commutative — the property that lets per-slab observations roll up
  into service-level and process-level views).
* **Conservative quantiles.** `quantile(q)` returns the UPPER edge of
  the bucket holding rank ⌈q·count⌉ (`quantile_bounds` returns both
  edges), so the estimate brackets the true quantile — an SLO check
  against the upper edge can over-alarm by one bucket width (≤ one
  `10^(1/STEPS_PER_DECADE)` factor) but never under-alarm.
* **Snapshot / delta.** `snapshot()` is a JSON-safe dict with NO
  wall-clock fields; `delta(prev)` subtracts an earlier snapshot (the
  watch-mode view of "what happened since"), and `apply_delta`
  reconstructs the later snapshot exactly — the round-trip is pinned in
  tests/test_torch_telemetry.py.

Values are nonnegative seconds by convention but the buckets are
unit-agnostic; negative observations clamp into the underflow bucket
(deadline slack of an already-late request) and are counted in `count`
but excluded from `sum`'s usefulness claim — callers that care clamp
first.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_right
from typing import Dict, List, Optional

__all__ = [
    "HISTOGRAM_SCHEMA_VERSION",
    "BUCKET_BOUNDS",
    "LatencyHistogram",
    "apply_delta",
]

HISTOGRAM_SCHEMA_VERSION = 1

#: The fixed layout: 4 buckets per decade from 1e-7 s to 1e4 s. These
#: constants ARE the schema — changing them bumps
#: HISTOGRAM_SCHEMA_VERSION (old snapshots stop merging).
DECADES = (-7, 4)
STEPS_PER_DECADE = 4

#: Upper bucket edges (ascending). Bucket i covers
#: [BUCKET_BOUNDS[i-1], BUCKET_BOUNDS[i]); bucket 0 is the underflow
#: [-inf, BUCKET_BOUNDS[0]); one extra overflow bucket catches
#: v >= BUCKET_BOUNDS[-1].
BUCKET_BOUNDS: tuple = tuple(
    10.0 ** (DECADES[0] + i / STEPS_PER_DECADE)
    for i in range((DECADES[1] - DECADES[0]) * STEPS_PER_DECADE + 1)
)

_NBUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow


class LatencyHistogram:
    """One fixed-layout histogram (see module docstring). Not
    internally locked — the registry serializes access for shared
    instances; standalone use is single-threaded by convention."""

    __slots__ = ("counts", "total", "sum", "min", "max")

    def __init__(self):
        self.counts: List[int] = [0] * _NBUCKETS
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- recording -------------------------------------------------------
    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_right(BUCKET_BOUNDS, v)] += 1
        self.total += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    # -- aggregation -----------------------------------------------------
    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (associative + commutative up to
        float addition order of ``sum``; the bucket COUNTS — everything
        quantiles read — are exactly associative)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram()
        h.merge(self)
        return h

    # -- quantiles -------------------------------------------------------
    def quantile_bounds(self, q: float) -> Optional[tuple]:
        """(lower_edge, upper_edge) of the bucket holding the q-th
        quantile; None on an empty histogram. The true quantile lies in
        [lower, upper] (edges saturate to observed min/max where those
        are tighter)."""
        if self.total == 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        rank = max(1, math.ceil(q * self.total))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else float("-inf")
                hi = (
                    BUCKET_BOUNDS[i]
                    if i < len(BUCKET_BOUNDS)
                    else float("inf")
                )
                lo = max(lo, self.min) if self.min is not None else lo
                hi = min(hi, self.max) if self.max is not None else hi
                return (lo, hi)
        return None  # unreachable: total > 0

    def quantile(self, q: float) -> Optional[float]:
        """Conservative (upper-edge) quantile estimate — brackets the
        true quantile from above, never below."""
        b = self.quantile_bounds(q)
        return None if b is None else b[1]

    def mean(self) -> Optional[float]:
        return self.sum / self.total if self.total else None

    # -- snapshot / delta ------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe state: counts sparse by bucket index, no
        wall-clock fields — byte-stable for identical observations."""
        return {
            "histogram_schema_version": HISTOGRAM_SCHEMA_VERSION,
            "count": self.total,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    @classmethod
    def from_snapshot(cls, snap: dict) -> "LatencyHistogram":
        if snap.get("histogram_schema_version") != HISTOGRAM_SCHEMA_VERSION:
            raise ValueError(
                "histogram snapshot schema "
                f"{snap.get('histogram_schema_version')!r} != "
                f"{HISTOGRAM_SCHEMA_VERSION} (bucket layouts differ — "
                "snapshots across schema versions do not merge)"
            )
        h = cls()
        for i, c in (snap.get("buckets") or {}).items():
            h.counts[int(i)] = int(c)
        h.total = int(snap["count"])
        h.sum = float(snap["sum"])
        h.min = snap["min"]
        h.max = snap["max"]
        return h

    def delta(self, prev: dict) -> dict:
        """This snapshot minus an earlier one of the SAME histogram.
        ``count``/``buckets`` subtract exactly (integers); ``sum`` is
        the float difference for DISPLAY, while ``sum_after`` (and
        min/max) carry the current state verbatim — IEEE rounding makes
        ``prev + (cur − prev)`` inexact, so `apply_delta` reconstructs
        from the verbatim fields and the round-trip is exact for ANY
        data."""
        cur = self.snapshot()
        prev_b: Dict[str, int] = dict(prev.get("buckets") or {})
        buckets = {}
        for i, c in cur["buckets"].items():
            d = c - int(prev_b.get(i, 0))
            if d:
                buckets[i] = d
        return {
            "histogram_schema_version": HISTOGRAM_SCHEMA_VERSION,
            "count": cur["count"] - int(prev["count"]),
            "sum": cur["sum"] - float(prev["sum"]),
            "sum_after": cur["sum"],
            "min": cur["min"],
            "max": cur["max"],
            "buckets": buckets,
        }

    def __repr__(self):
        return (
            f"LatencyHistogram(count={self.total}, mean={self.mean()}, "
            f"p99<={self.quantile(0.99)})"
        )


def apply_delta(prev: dict, delta: dict) -> dict:
    """Reconstruct the later snapshot from an earlier one plus a
    `LatencyHistogram.delta` — the watch-mode round-trip
    (`apply_delta(A, B.delta(A)) == B`, pinned in tests)."""
    buckets: Dict[str, int] = dict(prev.get("buckets") or {})
    for i, d in (delta.get("buckets") or {}).items():
        buckets[i] = buckets.get(i, 0) + int(d)
    buckets = {i: c for i, c in sorted(buckets.items()) if c}
    out = {
        "histogram_schema_version": HISTOGRAM_SCHEMA_VERSION,
        "count": int(prev["count"]) + int(delta["count"]),
        # the verbatim current sum, NOT prev+diff: float addition does
        # not invert float subtraction, and the round-trip is pinned
        # exact
        "sum": float(delta["sum_after"]),
        "min": delta["min"] if delta["count"] else prev["min"],
        "max": delta["max"] if delta["count"] else prev["max"],
        "buckets": buckets,
    }
    return out
