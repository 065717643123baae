"""PTimer: named-section wall timing over the execution model (L7).

The port's copy of `partitionedarrays_jl_tpu/parallel/ptimers.py`
(reference: src/PTimers.jl):

* `tic(barrier=True)` synchronizes all parts first so a section measures
  the slowest part (the reference inserts `MPI.Barrier`,
  src/PTimers.jl:69-74). Under a `GPUBackend` on a card the barrier
  synchronizes the card, as the JAX timer blocks on its arrays: without
  it a section would time the host's queueing of kernels, not their run;
* `toc(name)` synchronizes the same way and stores one Δt per part
  (PData), optionally printing on MAIN (src/PTimers.jl:76-87);
* `.data` gathers every section to MAIN and reduces to (min, max, avg)
  (src/PTimers.jl:40-59);
* `print_timer()` renders a max-sorted table on MAIN (src/PTimers.jl:93-148).

All parts share one host clock, so per-part times are equal unless the
caller times per-part work; the PData of times is kept for API parity.
"""
from __future__ import annotations

import time
from typing import Optional

from .backends import AbstractPData, get_part_ids, i_am_main, map_parts
from .collectives import gather
from ..utils.helpers import check


def _device_barrier(backend) -> None:
    """Wait for the card's queued work where the backend runs on one (the
    single-controller analog of a rank barrier); nothing otherwise."""
    from .gpu import GPUBackend

    if isinstance(backend, GPUBackend):
        dev = backend.device
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)


class PTimer:
    def __init__(self, parts: AbstractPData, verbose: bool = False):
        self.parts = get_part_ids(parts)
        self.verbose = verbose
        self.timings = {}  # name -> PData of seconds
        #: machine-readable span log (telemetry bridge): one entry per
        #: toc, with absolute wall start, duration, and the measured
        #: cost of the preceding `tic(barrier=True)` drain — the
        #: barrier is a real, otherwise-invisible line item.
        self.spans = []  # [{"name", "t0", "dur", "barrier_s"}]
        self._t0: Optional[float] = None
        self._t0_wall: Optional[float] = None
        self._barrier_s: float = 0.0
        self._current: Optional[str] = None

    # -- reference API: tic!/toc! ---------------------------------------
    def tic(self, barrier: bool = True) -> "PTimer":
        self._barrier_s = 0.0
        if barrier:
            b0 = time.perf_counter()
            _device_barrier(self.parts.backend)
            self._barrier_s = time.perf_counter() - b0
        self._t0 = time.perf_counter()
        self._t0_wall = time.time()
        return self

    def toc(self, name: str) -> "PTimer":
        check(self._t0 is not None, "toc without tic")
        _device_barrier(self.parts.backend)
        dt = time.perf_counter() - self._t0
        self.timings[name] = map_parts(lambda _p: dt, self.parts)
        self.spans.append(
            {
                "name": name,
                "t0": self._t0_wall,
                "dur": dt,
                "barrier_s": self._barrier_s,
            }
        )
        self._t0 = None
        if self.verbose and i_am_main(self.parts):
            print(f"[ptimer] {name}: {dt:.6f} s")
        return self

    def section(self, name: str):
        """Context-manager sugar: `with t.section("assembly"): ...`"""
        timer = self

        class _Section:
            def __enter__(self):
                timer.tic()
                return timer

            def __exit__(self, exc_type, exc, tb):
                if exc_type is None:
                    timer.toc(name)
                return False

        return _Section()

    # -- reference API: t.data ------------------------------------------
    @property
    def data(self):
        """(min, max, avg) per section, on MAIN (reference: src/PTimers.jl:40-59)."""
        out = {}
        for name, times in self.timings.items():
            g = gather(times)

            def _stats(ts):
                ts = list(ts)
                if not ts:
                    return None
                return {
                    "min": min(ts),
                    "max": max(ts),
                    "avg": sum(ts) / len(ts),
                }

            stats = map_parts(lambda t: _stats(t) if len(t) else None, g)
            out[name] = stats.get_part(0)
        return out

    def print_timer(self, json_path: Optional[str] = None) -> None:
        """Max-sorted section table, printed on MAIN only. With
        ``json_path`` the machine-readable form (`data_json`) is also
        written there — the same stats plus the span log, so the table
        is never the only record of a measurement."""
        if not i_am_main(self.parts):
            return
        data = self.data
        rows = sorted(data.items(), key=lambda kv: -kv[1]["max"])
        namew = max([len("section")] + [len(k) for k in data])
        print(f"{'section'.ljust(namew)}  {'max':>12}  {'min':>12}  {'avg':>12}")
        print("-" * (namew + 44))
        for name, st in rows:
            print(
                f"{name.ljust(namew)}  {st['max']:>12.6f}  {st['min']:>12.6f}  "
                f"{st['avg']:>12.6f}"
            )
        if json_path is not None:
            import json

            with open(json_path, "w", encoding="utf-8") as f:
                json.dump(self.data_json(), f, indent=1, sort_keys=True)

    # -- machine-readable forms -------------------------------------------
    def data_json(self) -> dict:
        """Machine-readable export: the (min, max, avg) stats plus the
        raw span log (absolute wall starts, durations, barrier costs)."""
        return {
            "schema_version": 1,
            "sections": {k: dict(v) for k, v in self.data.items()},
            "spans": [dict(s) for s in self.spans],
        }

    def trace_events(self, pid: int = 2, tid: int = 0) -> list:
        """Chrome-trace spans of every section — and of every nonzero
        `tic(barrier=True)` drain, as its own ``<name>:tic_barrier``
        span immediately preceding the section (Chrome trace "X" events,
        readable by Perfetto)."""
        out = []
        for s in self.spans:
            if s["barrier_s"] > 0.0:
                out.append(
                    {
                        "name": f"{s['name']}:tic_barrier",
                        "ph": "X",
                        "ts": (s["t0"] - s["barrier_s"]) * 1e6,
                        "dur": s["barrier_s"] * 1e6,
                        "pid": pid,
                        "tid": tid,
                        "cat": "ptimer.barrier",
                    }
                )
            out.append(
                {
                    "name": s["name"],
                    "ph": "X",
                    "ts": s["t0"] * 1e6,
                    "dur": s["dur"] * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "cat": "ptimer",
                }
            )
        return out

    def __repr__(self):
        return f"PTimer(sections={list(self.timings)})"


def tic(t: PTimer, barrier: bool = True) -> PTimer:
    """Reference export parity (src/PTimers.jl:69-74)."""
    return t.tic(barrier)


def toc(t: PTimer, name: str) -> PTimer:
    """Reference export parity (src/PTimers.jl:76-87)."""
    return t.toc(name)


def print_timer(t: PTimer, json_path: Optional[str] = None) -> None:
    return t.print_timer(json_path=json_path)
