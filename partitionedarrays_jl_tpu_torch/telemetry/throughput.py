"""The online per-RHS throughput model, the measured input of adaptive K
(telemetry/throughput.py of the JAX package, on its ``THROUGHPUT_MODEL.json``
format).

Every finished service slab reports its measured seconds per iteration,
and the model EWMAs them into a table keyed by ``(operator fingerprint,
dtype, K)``:

* ``s_per_it(fp, dtype, K)`` — the smoothed wall seconds one block-CG
  iteration of a width-K slab costs in this process, on this device;
* ``per_rhs(fp, dtype, K) = s_per_it / K`` — the amortized per-column
  cost, whose argmin over feasible K is the adaptive-K decision;
* ``suggest_k(fp, dtype, queue_depth, kmax)`` — among measured widths ≤
  min(queue_depth, kmax), the K with the best per-RHS cost (ties to the
  wider slab; min(queue_depth, kmax) while unmeasured). A service built
  with ``adaptive_k=True`` acts on it (`service.batcher.effective_kmax`).

Updates are EWMA (the config's ``mon_ewma``, default 0.25) and gated by
its ``mon``, like the rest of the instrumentation. ``export()`` emits the
schema-versioned table; ``load()`` reads it back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .registry import mon_ewma, monitoring_enabled, registry

__all__ = [
    "THROUGHPUT_SCHEMA_VERSION",
    "ThroughputModel",
    "operator_fingerprint",
    "model",
    "reset_model",
]

THROUGHPUT_SCHEMA_VERSION = 1


def operator_fingerprint(A) -> str:
    """A cheap stable identity for an operator: global size × part
    count. Deliberately structural (no value hash — the model tracks
    cost, which is shape/sparsity-bound, and a value update must not
    orphan the measured curve)."""
    from ..parallel.backends import num_parts

    return f"g{A.rows.ngids}-p{num_parts(A.rows.partition)}"


_Key = Tuple[str, str, int]


class ThroughputModel:
    """EWMA table of measured s_per_it keyed (fingerprint, dtype, K);
    thread-safe on the shared registry lock (slabs finish on the
    service worker thread while readers use the main thread)."""

    def __init__(self, alpha: Optional[float] = None):
        #: None -> the config's mon_ewma at each observation.
        self.alpha = alpha
        self._entries: Dict[_Key, Dict[str, float]] = {}

    # -- updates ---------------------------------------------------------
    def observe_slab(self, fingerprint: str, dtype: str, K: int,
                     s_per_it: float, iterations: int = 1) -> None:
        """One finished slab chunk's measurement. ``iterations`` is the
        trip count behind the measurement (recorded as sample weight
        context; the EWMA itself is per-observation)."""
        if not monitoring_enabled():
            return
        if not (s_per_it > 0.0) or iterations < 1:
            return  # a zero-trip chunk measures nothing
        key = (str(fingerprint), str(dtype), int(K))
        a = self.alpha if self.alpha is not None else mon_ewma()
        with registry().lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = {
                    "s_per_it": float(s_per_it),
                    "samples": 1,
                    "iterations": int(iterations),
                }
            else:
                e["s_per_it"] = (
                    (1.0 - a) * e["s_per_it"] + a * float(s_per_it)
                )
                e["samples"] += 1
                e["iterations"] += int(iterations)

    # -- queries ---------------------------------------------------------
    def s_per_it(self, fingerprint: str, dtype: str,
                 K: int) -> Optional[float]:
        with registry().lock:
            e = self._entries.get((str(fingerprint), str(dtype), int(K)))
            return None if e is None else e["s_per_it"]

    def per_rhs(self, fingerprint: str, dtype: str,
                K: int) -> Optional[float]:
        v = self.s_per_it(fingerprint, dtype, K)
        return None if v is None else v / int(K)

    def curve(self, fingerprint: str, dtype: str) -> Dict[int, float]:
        """Measured per-RHS curve {K: per_rhs_s_per_it} of one
        operator."""
        with registry().lock:
            return {
                k[2]: e["s_per_it"] / k[2]
                for k, e in sorted(self._entries.items())
                if k[0] == str(fingerprint) and k[1] == str(dtype)
            }

    def suggest_k(self, fingerprint: str, dtype: str, queue_depth: int,
                  kmax: int) -> int:
        """The adaptive-K input: best measured per-RHS width feasible
        for the CURRENT queue (never wider than the queue — idle
        columns cost like busy ones — nor than kmax). Unmeasured ->
        min(queue_depth, kmax), today's static policy."""
        feasible = max(1, min(int(queue_depth), int(kmax)))
        curve = self.curve(fingerprint, dtype)
        candidates = [(v, k) for k, v in curve.items() if k <= feasible]
        if not candidates:
            return feasible
        best = min(candidates, key=lambda t: (t[0], -t[1]))
        return best[1]

    # -- export / import -------------------------------------------------
    def export(self) -> dict:
        """The schema-versioned table (deterministic ordering, no
        wall-clock fields — the artifacts writer stamps provenance)."""
        with registry().lock:
            entries: List[dict] = [
                {
                    "fingerprint": k[0],
                    "dtype": k[1],
                    "K": k[2],
                    "s_per_it": round(e["s_per_it"], 9),
                    "per_rhs_s_per_it": round(e["s_per_it"] / k[2], 9),
                    "samples": int(e["samples"]),
                    "iterations": int(e["iterations"]),
                }
                for k, e in sorted(self._entries.items())
            ]
        return {
            "throughput_schema_version": THROUGHPUT_SCHEMA_VERSION,
            "ewma_alpha": (
                self.alpha if self.alpha is not None else mon_ewma()
            ),
            "entries": entries,
        }

    @classmethod
    def load(cls, rec: dict) -> "ThroughputModel":
        if rec.get("throughput_schema_version") != THROUGHPUT_SCHEMA_VERSION:
            raise ValueError(
                "throughput model schema "
                f"{rec.get('throughput_schema_version')!r} != "
                f"{THROUGHPUT_SCHEMA_VERSION}"
            )
        m = cls(alpha=rec.get("ewma_alpha"))
        for e in rec.get("entries", []):
            m._entries[(str(e["fingerprint"]), str(e["dtype"]),
                        int(e["K"]))] = {
                "s_per_it": float(e["s_per_it"]),
                "samples": int(e.get("samples", 1)),
                "iterations": int(e.get("iterations", 1)),
            }
        return m

    def __repr__(self):
        return f"ThroughputModel(entries={len(self._entries)})"


#: THE process-wide model instance (what the service feeds and readers
#: read).
_MODEL = ThroughputModel()


def model() -> ThroughputModel:
    return _MODEL


def reset_model() -> None:
    """Tests only: drop every measured entry."""
    with registry().lock:
        _MODEL._entries.clear()
