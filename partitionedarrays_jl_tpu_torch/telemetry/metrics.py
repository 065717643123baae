"""Process-wide counters: the flat view of the typed registry's counters
(telemetry/metrics.py of the JAX package).

``bump``/``get``/``snapshot``/``reset`` operate on `Registry` counters
(``snapshot`` returns the flat name -> int dict of the unlabeled ones;
labeled counters are read through ``registry().snapshot()``). Counters are
always on: the config's ``metrics`` gates the record and event layer, its
``mon`` the histograms and gauges, neither these. The JAX package's bridge
from ``jax.monitoring`` (``install_jax_cache_listeners``) has no
counterpart: the port has no persistent compilation cache.
"""
from __future__ import annotations

from typing import Dict, Optional

from .registry import registry

__all__ = [
    "bump",
    "get",
    "snapshot",
    "reset",
]


def bump(name: str, n: int = 1) -> int:
    """Increment counter ``name`` by ``n`` and return the new value."""
    return registry().counter(name).inc(n)


def get(name: str) -> int:
    return registry().counter_value(name)


def snapshot(prefix: Optional[str] = None) -> Dict[str, int]:
    """A copy of the current (unlabeled) counters, optionally filtered
    by prefix (the flat view)."""
    snap = registry().snapshot(prefix)
    return {k: v for k, v in snap["counters"].items() if "{" not in k}


def reset(prefix: Optional[str] = None) -> None:
    """Zero the registry (tests); with ``prefix``, only that namespace.
    Resets EVERY metric kind under the prefix, not just counters."""
    registry().reset(prefix)
