"""End-to-end request tracing: the span plane (telemetry/tracing.py of the
JAX package).

A deterministic span model (``trace_id``/``span_id``/``parent_id``,
monotonic-clock durations, typed span kinds) with strict W3C
``traceparent`` propagation, so one span tree runs from a request's root
through the service's slab and its chunks.

Span kinds (`SPAN_KINDS`, the JAX package's vocabulary; the service opens
``slab.solve`` and ``chunk``, the front door ``rpc.request``,
``gate.queue``, ``gate.shed`` and ``tenant.page_in``):

* ``rpc.request`` — a request-level root;
* ``slab.solve`` — one request's ride through its slab, per request (K
  co-batched requests get K parallel spans over the same wall window, so
  every tree stays single-parented);
* ``chunk`` — one block-solve call, or one solo retry (``solo_retry``),
  inside ``slab.solve``;
* ``gate.queue``, ``gate.shed``, ``tenant.page_in`` — the front door's;
* ``solver.phase`` — the phase profile's synthetic children of a
  ``slab.solve`` (`mount_phase_spans`); ``tenant.repartition`` — the
  elastic layer's (not ported yet).

Persistence: with ``tracing_dir`` set, every span appends a begin record
to ``tracing_dir/spans-<pid>-<token>.jsonl`` when it starts and an end
record when it finishes; a span alive at a crash survives as an
``interrupted`` span. Host-side only, flushed, not fsync'd.

Switches (`telemetry.configure`): ``tracing`` (the JAX package's ``PA_TX``,
default on; off, `start_span` returns one inert span: no ids, no clock
reads, no files) and ``tracing_dir`` (``tracing_dir``). No solve reads
either: a traced solve launches what an untraced one launches.
`mount_phase_spans` lays a phase profile (`telemetry/profile.py`) under
the recorded slab spans.
"""
from __future__ import annotations

import json
import os
import re
import secrets
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .config import config

__all__ = [
    "TX_SCHEMA_VERSION",
    "SPAN_KINDS",
    "TraceContext",
    "Span",
    "tracing_enabled",
    "tracing_dir",
    "parse_traceparent",
    "mint_trace",
    "start_span",
    "span",
    "ambient",
    "current_ctx",
    "recorded_spans",
    "clear_spans",
    "load_spans",
    "spans_for",
    "trace_ids",
    "span_tree",
    "verify_trace",
    "mount_phase_spans",
    "trace_summary",
    "render_trace",
    "trace_chrome_events",
]

TX_SCHEMA_VERSION = 1

#: The typed span vocabulary (the JAX package's).
SPAN_KINDS = (
    "rpc.request", "gate.queue", "gate.shed", "tenant.page_in",
    "slab.solve", "chunk", "solver.phase", "tenant.repartition",
)

#: In-memory retention of finished spans (the cross-process story lives
#: in ``tracing_dir``; the ring serves in-process readers).
_RING_DEPTH = 8192


def tracing_enabled() -> bool:
    return bool(config().tracing)


def tracing_dir() -> Optional[str]:
    return config().tracing_dir or None


# ---------------------------------------------------------------------------
# W3C traceparent
# ---------------------------------------------------------------------------

#: Strict W3C shape: version-traceid-spanid-flags, lowercase hex only.
_TRACEPARENT_RE = re.compile(
    r"\A([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})\Z"
)


class TraceContext:
    """One propagated (trace_id, span_id) pair — what rides the
    ``traceparent`` header and the request/handle objects."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self):
        return f"TraceContext({self.traceparent()!r})"


def parse_traceparent(header) -> Optional[TraceContext]:
    """Strict W3C ``traceparent`` parse; None for ANYTHING malformed —
    wrong type, truncated/overlong, non-hex or uppercase hex, the
    forbidden ``ff`` version, all-zero trace or span id. The RPC
    surface maps None to a freshly minted trace (plus the
    ``gate.traceparent_invalid`` counter when a header was present):
    a hostile header can never 500 a submit."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":  # forbidden by the spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def mint_trace() -> TraceContext:
    """A fresh trace root context (random ids, the W3C id widths)."""
    return TraceContext(secrets.token_hex(16), secrets.token_hex(8))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One recorded span. Construct via `start_span` (or the `span`
    context manager); `end` is idempotent. ``recording`` is False for
    the inert tracing off singleton — every method stays a cheap no-op."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "kind", "name", "remote",
        "t0_wall", "_t0", "dur_s", "status", "attrs", "finished",
        "recording",
    )

    def __init__(self, trace_id, span_id, parent_id, kind, name,
                 remote=False, attrs=None, recording=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.name = name
        self.remote = bool(remote)
        self.recording = recording
        self.t0_wall = time.time() if recording else 0.0
        self._t0 = time.perf_counter() if recording else 0.0
        self.dur_s: Optional[float] = None
        self.status = "open"
        self.attrs: Dict = dict(attrs or {})
        self.finished = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def end(self, status: str = "ok", **attrs) -> None:
        if not self.recording or self.finished:
            return
        self.finished = True
        self.dur_s = time.perf_counter() - self._t0
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        _record_end(self)

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "kind": self.kind,
            "name": self.name,
            "remote": self.remote,
            "t0_wall": self.t0_wall,
            "dur_s": self.dur_s,
            "status": self.status if self.finished else "interrupted",
            "attrs": dict(self.attrs),
        }

    def __repr__(self):
        return (
            f"Span({self.kind}:{self.name}, trace={self.trace_id[:8]}…, "
            f"status={self.status})"
        )


#: The one inert span: tracing off callers get it back from `start_span`
#: with zero allocation, zero clock reads, zero lock traffic.
_INERT = Span("0" * 32, "0" * 16, None, "rpc.request", "",
              recording=False)

_lock = threading.Lock()
_spans: List[Span] = []  # finished ring
_active: Dict[str, Span] = {}  # span_id -> live span
_file = None  # lazily opened tracing_dir writer
_file_dir: Optional[str] = None
_tls = threading.local()


def _writer():
    """The per-process span file under tracing_dir (reopened when the
    directory changes — tests point tracing_dir at fresh tmpdirs)."""
    global _file, _file_dir
    d = tracing_dir()
    if d is None:
        return None
    if _file is None or _file_dir != d or _file.closed:
        if _file is not None and not _file.closed:
            _file.close()  # a dir change must not leak the old fd
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"spans-{os.getpid()}-{secrets.token_hex(3)}.jsonl"
        )
        _file = open(path, "a", encoding="utf-8")
        _file_dir = d
    return _file


def _emit_line(rec: dict) -> None:
    # under _lock: the HTTP threads, the gate pump, and the service
    # worker all emit — an unserialized write could interleave lines
    try:
        with _lock:
            f = _writer()
            if f is None:
                return
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()  # into the page cache: survives SIGKILL of us
    except Exception:
        pass  # span persistence must never fail a request


def start_span(kind: str, name: str = "", parent=None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               remote: bool = False, **attrs) -> Span:
    """Open one span. ``parent`` may be a `Span`, a `TraceContext`, or
    None; ``trace_id``/``parent_id`` override explicitly (journal
    recovery reopens the ORIGINAL trace with them). No parent at all
    mints a fresh root trace. Inert (the shared no-op span) under
    ``tracing off``."""
    assert kind in SPAN_KINDS, kind
    if not tracing_enabled():
        return _INERT
    if parent is not None:
        pctx = parent.ctx if isinstance(parent, Span) else parent
        trace_id = pctx.trace_id
        parent_id = pctx.span_id
    elif trace_id is None:
        ctx = mint_trace()
        trace_id, parent_id = ctx.trace_id, None
    s = Span(trace_id, secrets.token_hex(8), parent_id, kind, name,
             remote=remote, attrs=attrs)
    from .registry import registry

    registry().counter("tx.spans").inc()
    with _lock:
        _active[s.span_id] = s
    _emit_line({
        "ev": "B", "trace_id": s.trace_id, "span_id": s.span_id,
        "parent_id": s.parent_id, "kind": s.kind, "name": s.name,
        "remote": s.remote, "t0_wall": s.t0_wall,
        "attrs": s.attrs, "tx_schema_version": TX_SCHEMA_VERSION,
    })
    return s


def _record_end(s: Span) -> None:
    with _lock:
        _active.pop(s.span_id, None)
        _spans.append(s)
        del _spans[: max(0, len(_spans) - _RING_DEPTH)]
    _emit_line({
        "ev": "E", "span_id": s.span_id, "dur_s": s.dur_s,
        "status": s.status, "attrs": s.attrs,
    })


@contextmanager
def span(kind: str, name: str = "", parent=None, **attrs):
    """``with span("chunk", parent=solve_span) as s:`` — opens the
    span, pushes its context AMBIENT for the body (nested records and
    events stamp it), ends it on exit (``status="error"`` + the
    exception type on a raising body)."""
    s = start_span(kind, name=name, parent=parent, **attrs)
    with ambient(s.ctx if s.recording else None):
        try:
            yield s
        except BaseException as e:
            s.end(status="error", error=type(e).__name__)
            raise
        else:
            s.end()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextmanager
def ambient(ctx: Optional[TraceContext]):
    """Make ``ctx`` the thread's current trace context: `SolveRecord`s
    opened inside stamp it (``record.trace``) and `emit_event` attaches
    it to every event's details. None is a no-op."""
    if ctx is None:
        yield
        return
    st = _stack()
    st.append(ctx)
    try:
        yield
    finally:
        st.pop()


def current_ctx() -> Optional[TraceContext]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def recorded_spans() -> List[dict]:
    """Every span this process holds — finished ring plus still-open
    spans (as ``interrupted``) — newest-last. The in-process
    counterpart of `load_spans`."""
    with _lock:
        return [s.as_dict() for s in _spans] + [
            s.as_dict() for s in _active.values()
        ]


def clear_spans() -> None:
    with _lock:
        _spans.clear()
        _active.clear()


# ---------------------------------------------------------------------------
# reconstruction (tracing_dir readers + tree algebra)
# ---------------------------------------------------------------------------


def load_spans(directory: Optional[str] = None) -> List[dict]:
    """Every span persisted under ``directory`` (default tracing_dir),
    begin/end records joined: a begin without an end is an
    ``interrupted`` span (the process died holding it open — exactly
    the crash-stitching input). Torn trailing lines are skipped."""
    d = directory or tracing_dir()
    if not d or not os.path.isdir(d):
        return []
    begins: Dict[str, dict] = {}
    order: List[str] = []
    for fname in sorted(os.listdir(d)):
        if not (fname.startswith("spans-") and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(d, fname), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed process
                if rec.get("ev") == "B":
                    sid = rec["span_id"]
                    if sid not in begins:
                        order.append(sid)
                    begins[sid] = {
                        "trace_id": rec.get("trace_id"),
                        "span_id": sid,
                        "parent_id": rec.get("parent_id"),
                        "kind": rec.get("kind"),
                        "name": rec.get("name", ""),
                        "remote": bool(rec.get("remote")),
                        "t0_wall": rec.get("t0_wall", 0.0),
                        "dur_s": None,
                        "status": "interrupted",
                        "attrs": dict(rec.get("attrs") or {}),
                    }
                elif rec.get("ev") == "E":
                    s = begins.get(rec.get("span_id"))
                    if s is not None:
                        s["dur_s"] = rec.get("dur_s")
                        s["status"] = rec.get("status", "ok")
                        s["attrs"].update(rec.get("attrs") or {})
    return [begins[sid] for sid in order]


def spans_for(trace_id: str, spans: Optional[List[dict]] = None,
              directory: Optional[str] = None) -> List[dict]:
    """The spans of one trace (from ``spans`` if given, else the
    in-memory ring + active set, else tracing_dir via ``directory``)."""
    if spans is None:
        spans = (
            load_spans(directory) if directory is not None
            else recorded_spans()
        )
    return [s for s in spans if s.get("trace_id") == trace_id]


def trace_ids(spans: List[dict]) -> List[str]:
    """Distinct trace ids, in first-appearance order."""
    seen, out = set(), []
    for s in spans:
        t = s.get("trace_id")
        if t and t not in seen:
            seen.add(t)
            out.append(t)
    return out


def span_tree(spans: List[dict]) -> Tuple[List[dict], List[dict]]:
    """``(roots, orphans)`` of one trace's spans. A root has no parent
    OR a remote parent (the HTTP client's unrecorded call site). An
    orphan names a parent that is neither recorded nor remote — the
    defect `verify_trace` and the padur drill assert never happens."""
    ids = {s["span_id"] for s in spans}
    roots, orphans = [], []
    for s in spans:
        pid = s.get("parent_id")
        if pid is None or s.get("remote"):
            roots.append(s)
        elif pid not in ids:
            orphans.append(s)
    return roots, orphans


def _children_map(spans: List[dict]) -> Dict[str, List[dict]]:
    ch: Dict[str, List[dict]] = {}
    for s in spans:
        pid = s.get("parent_id")
        if pid is not None and not s.get("remote"):
            ch.setdefault(pid, []).append(s)
    for v in ch.values():
        v.sort(key=lambda s: s.get("t0_wall", 0.0))
    return ch


def verify_trace(spans: List[dict], trace_id: str,
                 slack: float = 0.05) -> List[str]:
    """The span-tree invariants `patx --check`, the chaos matrix, and
    the padur drill all assert. Returns human-readable problems
    (empty = sound):

    * at least one span, every span carrying this trace_id;
    * zero orphan spans (every parent recorded or remote);
    * SEQUENTIAL children fit inside their parent: for each finished
      parent, the summed durations of its finished non-overlapping
      children stay within ``(1 + slack)`` of the parent duration plus
      a small absolute tolerance (interrupted spans are exempt — the
      crash ate their clock).

    The child-sum check runs per kind-group (parallel K-slab spans of
    OTHER requests never share a parent, so within one tree children
    are sequential by construction)."""
    mine = [s for s in spans if s.get("trace_id") == trace_id]
    problems = []
    if not mine:
        return [f"trace {trace_id}: no spans recorded"]
    roots, orphans = span_tree(mine)
    if not roots:
        problems.append(f"trace {trace_id}: no root span")
    for o in orphans:
        problems.append(
            f"trace {trace_id}: ORPHAN span {o['kind']}:{o['name']} "
            f"({o['span_id']}) names unrecorded parent {o['parent_id']}"
        )
    ch = _children_map(mine)
    for s in mine:
        if s.get("dur_s") is None:
            continue
        kids = [
            c for c in ch.get(s["span_id"], [])
            if c.get("dur_s") is not None
        ]
        by_kind: Dict[str, List[dict]] = {}
        for c in kids:
            by_kind.setdefault(c["kind"], []).append(c)
        for kind, group in by_kind.items():
            total = sum(c["dur_s"] for c in group)
            if total > s["dur_s"] * (1.0 + slack) + 5e-3:
                problems.append(
                    f"trace {trace_id}: {kind} children of "
                    f"{s['kind']} sum to {total:.4f}s > parent "
                    f"{s['dur_s']:.4f}s"
                )
    return problems


def trace_summary(spans: List[dict], trace_id: str) -> dict:
    """The per-kind wall-time breakdown of one trace: total latency
    (root span), summed seconds per span kind, and the dominant kind —
    the queue-wait vs page-in vs solve answer."""
    mine = [s for s in spans if s.get("trace_id") == trace_id]
    roots, _ = span_tree(mine)
    total = max(
        (r.get("dur_s") or 0.0 for r in roots), default=0.0
    )
    kinds: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for s in mine:
        kinds[s["kind"]] = kinds.get(s["kind"], 0.0) + (
            s.get("dur_s") or 0.0
        )
        counts[s["kind"]] = counts.get(s["kind"], 0) + 1
    dominant = None
    breakdown = {
        k: v for k, v in kinds.items() if k != "rpc.request"
    }
    if breakdown:
        dominant = max(breakdown, key=lambda k: breakdown[k])
    return {
        "trace_id": trace_id,
        "spans": len(mine),
        "total_s": total,
        "by_kind_s": kinds,
        "by_kind_n": counts,
        "dominant": dominant,
        "interrupted": sum(
            1 for s in mine if s.get("status") == "interrupted"
        ),
    }


def render_trace(spans: List[dict], trace_id: str) -> str:
    """The ASCII span tree `patx <trace_id>` prints."""
    mine = [s for s in spans if s.get("trace_id") == trace_id]
    if not mine:
        return f"trace {trace_id}: no spans"
    roots, orphans = span_tree(mine)
    ch = _children_map(mine)
    t0 = min(s.get("t0_wall", 0.0) for s in mine)
    lines = [f"trace {trace_id}"]

    def _fmt(s):
        dur = (
            f"{s['dur_s'] * 1e3:9.3f} ms" if s.get("dur_s") is not None
            else "  INTERRUPTED"
        )
        extra = ""
        if s.get("attrs"):
            shown = {
                k: v for k, v in sorted(s["attrs"].items())
                if k not in ("trace_id",)
            }
            if shown:
                extra = "  " + json.dumps(shown, sort_keys=True,
                                          default=str)
        mark = " [remote parent]" if s.get("remote") else ""
        status = "" if s.get("status") in ("ok", "interrupted") else (
            f" status={s['status']}"
        )
        return (
            f"[+{s.get('t0_wall', 0.0) - t0:8.4f}s] {dur}  "
            f"{s['kind']}:{s.get('name') or ''}{status}{mark}{extra}"
        )

    def _walk(s, depth):
        lines.append("  " * depth + "  " + _fmt(s))
        for c in ch.get(s["span_id"], []):
            _walk(c, depth + 1)

    for r in sorted(roots, key=lambda s: s.get("t0_wall", 0.0)):
        _walk(r, 0)
    for o in orphans:
        lines.append("  ORPHAN " + _fmt(o))
    summ = trace_summary(mine, trace_id)
    parts = ", ".join(
        f"{k}={v * 1e3:.2f}ms" for k, v in sorted(
            summ["by_kind_s"].items()
        )
    )
    lines.append(
        f"  total={summ['total_s'] * 1e3:.2f}ms  dominant="
        f"{summ['dominant']}  ({parts})"
    )
    return "\n".join(lines)


def mount_phase_spans(spans: List[dict], profile: dict) -> List[dict]:
    """A phase profile under every finished ``slab.solve`` span
    (tracing.py:640 of the JAX package): synthetic ``solver.phase``
    children, one a phase, in sorted name order, whose durations split the
    slab span's wall time by the profile's per-iteration shares, laid end
    to end from the slab's start. A container ``{"profiles": {case:
    profile}}`` mounts its ``standard`` profile (a slab span names no
    body). Returns the ADDED spans."""
    cases = profile.get("profiles")
    if isinstance(cases, dict) and cases:
        profile = cases.get("standard") or next(iter(cases.values()))
    per_it = {p: float(v.get("s_per_it") or 0.0) for p, v in (profile.get("phases") or {}).items()}
    total = sum(per_it.values())
    if total <= 0.0:
        return []
    out = []
    for s in spans:
        if s.get("kind") != "slab.solve" or s.get("dur_s") is None:
            continue
        t = s.get("t0_wall", 0.0)
        for name, v in sorted(per_it.items()):
            dur = s["dur_s"] * (v / total)
            out.append({
                "trace_id": s["trace_id"],
                "span_id": secrets.token_hex(8),
                "parent_id": s["span_id"],
                "kind": "solver.phase",
                "name": name,
                "remote": False,
                "t0_wall": t,
                "dur_s": dur,
                "status": "ok",
                "attrs": {"s_per_it": v, "share": round(v / total, 6), "source": profile.get("case", "PHASE_PROFILE"),
                          "synthetic": True},
            })
            t += dur
    return out


def trace_chrome_events(spans: List[dict],
                        trace_id: Optional[str] = None) -> List[dict]:
    """Chrome-trace events for `telemetry.trace.write_chrome_trace`'s
    ``extra_events``: one complete span ("X") per recorded span on a
    per-trace track, plus FLOW events ("s"/"f") along every
    parent→child edge so Perfetto draws the rpc→gate→slab→chunk arrows
    across tracks and processes."""
    chosen = (
        [s for s in spans if s.get("trace_id") == trace_id]
        if trace_id is not None else list(spans)
    )
    tids = {t: i for i, t in enumerate(trace_ids(chosen))}
    by_id = {s["span_id"]: s for s in chosen}
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 3,
        "args": {"name": "patx request traces"},
    }]
    for t, i in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 3, "tid": i,
            "args": {"name": f"trace {t[:12]}…"},
        })
    for s in chosen:
        ts = s.get("t0_wall", 0.0) * 1e6
        dur = max((s.get("dur_s") or 0.0) * 1e6, 1.0)
        tid = tids[s["trace_id"]]
        events.append({
            "name": f"{s['kind']}:{s.get('name') or ''}".rstrip(":"),
            "ph": "X", "ts": ts, "dur": dur, "pid": 3, "tid": tid,
            "cat": "span",
            "args": {
                "trace_id": s["trace_id"], "span_id": s["span_id"],
                "status": s.get("status"), **(s.get("attrs") or {}),
            },
        })
        pid = s.get("parent_id")
        if pid in by_id and not s.get("remote"):
            flow = int(
                (hash((s["trace_id"], pid, s["span_id"])) & 0x7FFFFFFF)
            )
            parent = by_id[pid]
            events.append({
                "name": "patx-edge", "ph": "s", "id": flow, "pid": 3,
                "tid": tids[parent["trace_id"]], "cat": "flow",
                "ts": parent.get("t0_wall", 0.0) * 1e6 + 1.0,
            })
            events.append({
                "name": "patx-edge", "ph": "f", "bp": "e", "id": flow,
                "pid": 3, "tid": tid, "cat": "flow", "ts": ts + 1.0,
            })
    return events
