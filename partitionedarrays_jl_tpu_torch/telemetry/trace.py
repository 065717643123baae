"""Chrome-trace / Perfetto export of solve records and PTimer sections, and
`annotate`, the bridge to the profiler (telemetry/trace.py of the JAX
package).

The exported file is the plain Chrome ``traceEvents`` JSON: every
`SolveRecord` one complete span (``ph: "X"``) carrying its config, each of
its events an instant at its offset inside the span, every `PTimer`
section a span on its own track. Timestamps are absolute wall-clock
microseconds, so records and timer sections of one process share one
timeline.

`annotate` wraps `torch.profiler.record_function` (the JAX package's
``jax.profiler.TraceAnnotation``), so a staging or solve phase shows in a
`torch.profiler` trace, and on a CUDA device also pushes an NVTX range;
it never raises.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Iterable, List, Optional

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "annotate",
    "chrome_trace",
    "record_trace_events",
    "write_chrome_trace",
]

TRACE_SCHEMA_VERSION = 1


@contextmanager
def annotate(name: str, device=None):
    """``with annotate("pa:cg:solve", device): ...`` — a
    `torch.profiler.record_function` range, plus an NVTX range when
    ``device`` is a CUDA device. Never raises."""
    import torch

    ctx = None
    nvtx = False
    try:
        ctx = torch.profiler.record_function(name)
        ctx.__enter__()
    except Exception:
        ctx = None
    if device is not None and torch.device(device).type == "cuda":
        try:
            torch.cuda.nvtx.range_push(name)
            nvtx = True
        except Exception:
            nvtx = False
    try:
        yield
    finally:
        if nvtx:
            try:
                torch.cuda.nvtx.range_pop()
            except Exception:
                pass
        if ctx is not None:
            try:
                ctx.__exit__(None, None, None)
            except Exception:
                pass


def record_trace_events(rec, tid: int = 0) -> List[dict]:
    """Chrome events of one `SolveRecord`: the solve span plus one
    instant per telemetry event."""
    d = rec.as_dict() if hasattr(rec, "as_dict") else dict(rec)
    t0_us = float(d.get("started_at") or 0.0) * 1e6
    dur_us = float(d.get("wall_s") or 0.0) * 1e6
    out = [
        {
            "name": f"solve:{d.get('solver')}",
            "ph": "X",
            "ts": t0_us,
            "dur": max(dur_us, 1.0),
            "pid": 1,
            "tid": tid,
            "cat": "solve",
            "args": {
                "solver": d.get("solver"),
                "iterations": d.get("iterations"),
                "status": d.get("status"),
                "config": d.get("config"),
                "comms": d.get("comms"),
            },
        }
    ]
    for ev in d.get("events") or []:
        out.append(
            {
                "name": f"{ev['kind']}:{ev.get('label') or ''}".rstrip(":"),
                "ph": "i",
                "s": "t",
                "ts": t0_us + float(ev.get("t") or 0.0) * 1e6,
                "pid": 1,
                "tid": tid,
                "cat": "event",
                "args": {
                    "iteration": ev.get("iteration"),
                    **(ev.get("details") or {}),
                },
            }
        )
    return out


def chrome_trace(
    records: Optional[Iterable] = None, timers: Optional[Iterable] = None
) -> dict:
    """The full Chrome-trace object for a set of records and PTimers
    (each timer contributes `PTimer.trace_events` spans)."""
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "partitionedarrays_jl_tpu_torch solves"}},
        {"name": "process_name", "ph": "M", "pid": 2,
         "args": {"name": "partitionedarrays_jl_tpu_torch ptimers"}},
    ]
    for tid, rec in enumerate(records or []):
        events.extend(record_trace_events(rec, tid=tid))
    for timer in timers or []:
        events.extend(timer.trace_events(pid=2))
    return {
        "displayTimeUnit": "ms",
        "metadata": {"schema_version": TRACE_SCHEMA_VERSION,
                     "generated_by": "partitionedarrays_jl_tpu_torch.telemetry"},
        "traceEvents": events,
    }


def write_chrome_trace(path: str, records=None, timers=None,
                       extra_events=None) -> str:
    """The ONE trace serializer. ``extra_events`` appends pre-built
    Chrome events onto
    the same timeline — callers never hand-roll the file format."""
    trace = chrome_trace(records=records, timers=timers)
    if extra_events:
        trace["traceEvents"].extend(extra_events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, indent=1)
    return path
