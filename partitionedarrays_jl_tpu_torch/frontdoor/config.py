"""The front door's switches: one frozen config object, set through one
function (the pattern of `telemetry.config`).

The JAX package reads its front-door switches from the environment at every
call; the port reads no environment. They are the fields of `GateConfig`,
with the JAX package's defaults:

=====================  ===========================  ==========================
field                  JAX package's variable       default
=====================  ===========================  ==========================
``mem_budget``         ``PA_GATE_MEM_BUDGET``       0 (unbounded), bytes
``classes``            ``PA_GATE_CLASSES``          interactive, batch,
                                                    besteffort
``shed_depth``         ``PA_GATE_SHED_DEPTH``       32
``journal``            ``PA_GATE_JOURNAL``          True
``journal_dir``        ``PA_GATE_JOURNAL_DIR``      None
``journal_fsync``      ``PA_GATE_JOURNAL_FSYNC``    True
``journal_keep``       ``PA_GATE_JOURNAL_KEEP``     None (keep every epoch)
``port``               ``PA_GATE_PORT``             8642 (0: ephemeral)
``fleet_replicas``     ``PA_FLEET_REPLICAS``        2
``fleet_lease_s``      ``PA_FLEET_LEASE_S``         2.0
``retry_jitter``       ``PA_RETRY_JITTER``          None (no jitter)
=====================  ===========================  ==========================

Constructor arguments (``Gate(mem_budget_bytes=, shed_watermark=, classes=,
journal_dir=)``, ``RequestJournal(fsync=)``, ``GateServer(port=)``,
``FleetMember(lease_s=)``, ``http_solve(jitter_seed=)``) override the config
for one object. `configure` replaces the process's config and returns the
previous one, which as a context manager restores itself::

    with frontdoor.configure(journal_keep=1):
        ...
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["GateConfig", "configure", "config"]


@dataclass(frozen=True)
class GateConfig:
    """The front door's switches (see the module docstring for the JAX
    package's names)."""

    mem_budget: int = 0
    classes: Tuple[str, ...] = ("interactive", "batch", "besteffort")
    shed_depth: int = 32
    journal: bool = True
    journal_dir: Optional[str] = None
    journal_fsync: bool = True
    journal_keep: Optional[int] = None
    port: int = 8642
    fleet_replicas: int = 2
    fleet_lease_s: float = 2.0
    retry_jitter: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.classes, str):
            raise ValueError("GateConfig: classes is a tuple of class names, best-protected first")
        object.__setattr__(self, "classes", tuple(str(c) for c in self.classes))

    def __enter__(self) -> "GateConfig":
        return self

    def __exit__(self, *exc) -> bool:
        _set(self)
        return False


_lock = threading.Lock()
_current = GateConfig()


def _set(cfg: GateConfig) -> None:
    global _current
    with _lock:
        _current = cfg


def config() -> GateConfig:
    """The process's current front-door config."""
    return _current


def configure(**fields) -> GateConfig:
    """Replace the named fields of the current config; returns the previous
    config, which as a context manager restores itself on exit."""
    global _current
    with _lock:
        prev = _current
        _current = dataclasses.replace(prev, **fields)
    return prev
