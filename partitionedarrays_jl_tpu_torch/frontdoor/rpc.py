"""The out-of-process HTTP/JSON surface of the gate, stdlib only
(frontdoor/rpc.py of the JAX package).

A thin shim (`http.server.ThreadingHTTPServer`, no new dependencies) that
makes the in-process `Gate` reachable from other processes. Request bodies
deserialize to the exact host `PVector`s an in-process caller would build
(`scatter_pvector_values`); handler threads never touch the card (the
tenant's service stages the vectors when its slab runs), and results
serialize through JSON's exact float round trip: every value of the stored
dtype, float32 included (a float32 value is a float64 exactly, and
``repr`` keeps every float64 bit), goes out and comes back bit for bit, so
a request submitted over HTTP returns bit for bit the iterate of the same
request submitted in-process.

Endpoints (the request-handle lifecycle is submit-poll-fetch):

* ``POST /v1/solve`` — body ``{tenant, b, x0?, tol?, maxiter?, deadline?,
  slo_class?, tag?, dtype?, idempotency_key?}`` (``b``/``x0`` are the
  global vectors as JSON arrays); 202 with ``{id, state}``, or 200 with
  the ORIGINAL id (``replayed: true``) when the ``idempotency_key`` was
  seen before. Overload maps to typed statuses: 429 + ``Retry-After`` for
  `LoadShedded`, 503 for `AdmissionRejected`, 422 for
  `DeadlineInfeasible`, 404 for an unknown tenant.
* ``GET /v1/solve/<id>`` — poll the handle: ``{id, state}``, plus ``{x,
  info}`` once done or ``{error, message}`` once failed.
* ``GET /v1/tenants`` — the residency table.
* ``GET /healthz`` — liveness, queue depth and shed watermark (fleet peers
  read headroom here before forwarding).
* ``GET /metrics`` — the Prometheus text exposition; ``GET
  /metrics.json`` — the registry snapshot as JSON.

Fleet (`frontdoor.fleet`): with a ``peer_picker`` installed on the server,
a `LoadShedded` overload becomes an HTTP 307 redirect to a peer replica
with headroom instead of a 429; `http_solve` follows it with the same
body, idempotency key and traceparent.

`serve_gate` runs a pump thread (EDF dispatch and SLO accounting) next to
the HTTP threads. The port's default port is the config's ``port`` (the
JAX package's ``PA_GATE_PORT``, 8642; 0 = ephemeral).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import error as _urlerror
from urllib import request as _urlrequest

import numpy as np

from ..service.admission import AdmissionRejected
from ..telemetry import tracing
from ..telemetry.registry import registry
from ..utils.health import DeadlineInfeasible
from ..utils.locksan import sanitized
from .scheduler import Gate, LoadShedded
from .tenancy import UnknownTenantError

__all__ = [
    "GateServer",
    "serve_gate",
    "serve_until_signalled",
    "gate_port",
    "http_solve",
]


def gate_port() -> int:
    """The config's ``port`` (default 8642; 0 = ephemeral)."""
    from .config import config

    return int(config().port)


def _vector(gate: Gate, tenant: str, values, dtype) -> object:
    """One global JSON array -> the tenant-shaped PVector an in-process
    caller would hold (ghosts filled from the same global data)."""
    from ..models.solvers import scatter_pvector_values

    A = gate.registry.tenant(tenant).A
    arr = np.asarray(values, dtype=dtype)
    if arr.shape != (A.rows.ngids,):
        raise ValueError(
            f"tenant {tenant!r} expects a global vector of length "
            f"{A.rows.ngids}, got shape {arr.shape}"
        )
    return scatter_pvector_values(arr, A.cols)


class _Handler(BaseHTTPRequestHandler):
    """One request handler bound to the server's gate (the server
    instance carries ``gate`` and the handle store)."""

    server_version = "pagate/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    # -- plumbing ---------------------------------------------------------
    def _json(self, status: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, status: int, text: str, ctype: str) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routes -----------------------------------------------------------
    def do_GET(self):
        gate = self.server.gate
        if self.path == "/healthz":
            # readiness-probe grade: depth, residency, journal epoch,
            # uptime — everything a probe needs to decide "serving"
            self._json(200, {
                "ok": True,
                "tenants": len(gate.registry._tenants),
                "queue_depth": gate.depth(),
                # fleet peers forward shed traffic only to a replica
                # with advertised headroom (depth < its OWN watermark)
                "shed_watermark": gate.watermark,
                "classes": list(gate.classes),
                "resident": sorted(
                    r["tenant"] for r in gate.residency()
                    if r["resident"]
                ),
                "journal_epoch": (
                    gate.journal.epoch
                    if gate.journal is not None else None
                ),
                "uptime_s": round(
                    time.monotonic() - self.server.started_at, 6
                ),
            })
        elif self.path == "/metrics":
            self._text(200, registry().to_prometheus(),
                       "text/plain; version=0.0.4")
        elif self.path == "/metrics.json":
            # the machine-readable registry snapshot (each replica
            # process has its OWN registry)
            self._json(200, registry().snapshot())
        elif self.path == "/v1/tenants":
            self._json(200, {
                "tenants": gate.residency(),
                "budget_bytes": gate.registry.budget,
                "resident_bytes": gate.registry.resident_bytes(),
            })
        elif self.path.startswith("/v1/solve/"):
            rid = self.path.rsplit("/", 1)[-1]
            h = self.server.handles.get(rid)
            if h is None:
                self._json(404, {"error": "UnknownRequest", "id": rid})
                return
            out = {"id": rid, "state": h.state,
                   "tenant": h.tenant, "slo_class": h.slo_class}
            if h.trace is not None:
                out["trace_id"] = h.trace.trace_id
            if h.state == "done":
                from ..models.solvers import gather_pvector

                x, info = h.result()
                # journal-recovered results are already global arrays
                out["x"] = (
                    np.asarray(x).tolist()
                    if isinstance(x, np.ndarray)
                    else gather_pvector(x).tolist()
                )
                out["info"] = {
                    "converged": bool(info.get("converged")),
                    "iterations": int(info.get("iterations", 0)),
                    "status": str(info.get("status")),
                }
                if info.get("recovered"):
                    out["info"]["recovered"] = True
            elif h.state == "failed":
                # a journal-replayed failure keeps its ORIGINAL typed
                # class name on the wire (pre-restart id pin)
                out["error"] = getattr(
                    h.error, "error_type", type(h.error).__name__
                )
                out["message"] = str(h.error)
            self._json(200, out)
        else:
            self._json(404, {"error": "NotFound", "path": self.path})

    def do_POST(self):
        if self.path != "/v1/solve":
            self._json(404, {"error": "NotFound", "path": self.path})
            return
        gate = self.server.gate
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            tenant = body["tenant"]
            dtype = np.dtype(body.get("dtype", "float64"))
            kwargs = {"b": _vector(gate, tenant, body["b"], dtype)}
            if body.get("x0") is not None:
                kwargs["x0"] = _vector(gate, tenant, body["x0"], dtype)
            for k in ("tol", "deadline"):
                if body.get(k) is not None:
                    kwargs[k] = float(body[k])
            if body.get("maxiter") is not None:
                kwargs["maxiter"] = int(body["maxiter"])
        except UnknownTenantError as e:
            self._json(404, {"error": "UnknownTenant", "message": str(e)})
            return
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._json(400, {"error": "BadRequest", "message": str(e)})
            return
        idem = body.get("idempotency_key")
        # distributed tracing: a W3C traceparent header joins the
        # client's trace; ANY malformed header — bad version, length,
        # hex, zero ids — is counted and replaced by a fresh minted
        # trace, never a 500
        raw_tp = self.headers.get("traceparent")
        ctx = tracing.parse_traceparent(raw_tp)
        if raw_tp is not None and ctx is None:
            registry().counter("gate.traceparent_invalid").inc()
        # replay detection is the GATE's call (its key map is the
        # source of truth, reported from inside the submit lock — a
        # pre-submit snapshot would race a concurrent duplicate)
        replay = {}
        try:
            h = gate.submit(
                tenant,
                slo_class=body.get("slo_class"),
                tag=str(body.get("tag", "")),
                idempotency_key=(
                    str(idem) if idem is not None else None
                ),
                replay_out=replay,
                trace=ctx,
                **kwargs,
            )
        except LoadShedded as e:
            # fleet shed-forwarding: before telling the client to back
            # off, ask the fleet for a peer with headroom (the picker
            # reads peer /healthz depths) and redirect the SUBMIT there
            # — 307 preserves the POST method + body, so the peer sees
            # the identical request (same idempotency key, same
            # traceparent: one stitched trace across the hop) and a
            # forwarded duplicate can never double-solve
            peer = None
            picker = getattr(self.server, "peer_picker", None)
            if picker is not None:
                try:
                    peer = picker()
                except Exception:
                    peer = None  # a broken picker degrades to 429
            if peer:
                from .. import telemetry

                registry().counter("fleet.forwarded").inc()
                telemetry.emit_event(
                    "fleet_forwarded", label=peer,
                    slo_class=body.get("slo_class"),
                )
                self._json(
                    307,
                    {"error": "LoadShedded", "message": str(e),
                     "forwarded_to": peer,
                     "retry_after_s": e.retry_after_s,
                     "diagnostics": e.diagnostics},
                    headers={
                        "Location": peer.rstrip("/") + "/v1/solve",
                        "Retry-After": max(
                            1, int(round(e.retry_after_s))
                        ),
                    },
                )
                return
            self._json(
                429,
                {"error": "LoadShedded", "message": str(e),
                 "retry_after_s": e.retry_after_s,
                 "diagnostics": e.diagnostics},
                headers={
                    "Retry-After": max(1, int(round(e.retry_after_s)))
                },
            )
            return
        except AdmissionRejected as e:
            self._json(503, {
                "error": "AdmissionRejected", "message": str(e),
                "diagnostics": e.diagnostics,
            })
            return
        except DeadlineInfeasible as e:
            # spectrum admission (spec_admit on): the forecast says the
            # deadline cannot be met — 422, refused before any solver
            # work, with the predicted_s/available_s diagnostics on the
            # wire (distinct from 429 shed and 503 backpressure)
            self._json(422, {
                "error": "DeadlineInfeasible", "message": str(e),
                "diagnostics": e.diagnostics,
            })
            return
        except UnknownTenantError as e:
            self._json(404, {"error": "UnknownTenant", "message": str(e)})
            return
        # an idempotency-key replay returns the ORIGINAL id (200, not
        # 202 — nothing new was admitted); a fresh submit stores + 202
        replayed = bool(replay.get("replayed"))
        rid = self.server.store(h)
        out = {"id": rid, "state": h.state, "tenant": h.tenant,
               "slo_class": h.slo_class, "replayed": replayed}
        headers = {}
        if h.trace is not None:
            # echo the request's SERVER-side context (root span): the
            # client learns the trace_id its traceparent joined — or
            # the fresh one minted for it
            out["trace_id"] = h.trace.trace_id
            headers["traceparent"] = h.trace.traceparent()
        self._json(200 if replayed else 202, out, headers=headers)


class GateServer(ThreadingHTTPServer):
    """The HTTP front of one `Gate` + the pump thread that keeps EDF
    dispatch and SLO accounting moving while HTTP threads only enqueue
    and poll."""

    daemon_threads = True

    def __init__(self, gate: Gate, host: str = "127.0.0.1",
                 port: Optional[int] = None, verbose: bool = False,
                 max_handles: int = 4096):
        super().__init__((host, gate_port() if port is None else port),
                         _Handler)
        self.gate = gate
        self.verbose = verbose
        self.started_at = time.monotonic()  # /healthz uptime_s
        self.handles = {}
        # pre-restart ids stay pollable: a recovered gate's journal
        # handles (completed results, replayed failures, resumed
        # requests) seed the store under their ORIGINAL ids
        for rid, h in gate.handles_snapshot():
            self.handles[rid] = h
        #: Retention bound: a long-lived server would otherwise grow
        #: one handle (holding full b/x0 vectors) per request forever —
        #: the OLDEST terminal handles are pruned past this; live
        #: handles are never dropped.
        self.max_handles = max(1, int(max_handles))
        #: Fleet hook (frontdoor.fleet.FleetMember.pick_peer): a
        #: zero-arg callable returning a peer base URL with headroom,
        #: or None — consulted on `LoadShedded` to 307-forward instead
        #: of 429. Solo gates leave it None (behavior unchanged).
        self.peer_picker = None
        self._hlock = sanitized(threading.Lock(), "GateServer._hlock")
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._http: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def store(self, handle) -> str:
        with self._hlock:
            # the GATE mints the id (epoch-qualified, collision-safe
            # across restarts) — the server only indexes it for polls
            rid = handle.rid
            self.handles[rid] = handle
            if len(self.handles) > self.max_handles:
                # dict preserves insertion order: scan oldest-first and
                # drop finished handles (a poll after pruning gets the
                # explicit UnknownRequest 404, not a silent hang)
                for old in list(self.handles):
                    if len(self.handles) <= self.max_handles:
                        break
                    if self.handles[old].done():
                        del self.handles[old]
            return rid

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "GateServer":
        self._pump = threading.Thread(
            target=self._pump_loop, daemon=True, name="pagate-pump"
        )
        self._pump.start()
        self._http = threading.Thread(
            target=self.serve_forever, daemon=True, name="pagate-http"
        )
        self._http.start()
        return self

    def _pump_loop(self) -> None:
        while not self._stop.wait(0.005):
            self.gate.pump()

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.join()
        self.shutdown()
        if self._http is not None:
            self._http.join()
        self.server_close()
        self.gate.shutdown(drain=drain)


def serve_gate(gate: Gate, host: str = "127.0.0.1",
               port: Optional[int] = None,
               verbose: bool = False) -> GateServer:
    """Start the HTTP surface (and its pump thread) over ``gate``;
    returns the running server (``.url``, ``.stop()``)."""
    return GateServer(gate, host=host, port=port, verbose=verbose).start()


def serve_until_signalled(srv: GateServer, drain: bool = False) -> int:
    """Block the MAIN thread until SIGTERM/SIGINT, then shut the gate
    down gracefully instead of dying mid-slab: ``drain=False`` (the
    default) takes the service's checkpoint path — in-flight slabs save
    their iterates at the next chunk boundary and queued requests
    suspend (all resumable; a journaling gate recovers them on the
    next start) — while ``drain=True`` finishes the queue first.

    The exit-code contract: returns 0 after a clean signalled shutdown — the `Gate.shutdown`
    path (reached through ``srv.stop``) emits the ONE
    ``gate_shutdown`` event and, when journaling, the ``shutdown``
    journal record. Signal handlers are installed here (main thread
    only) and restored on exit."""
    import signal

    stop = threading.Event()
    got = {"sig": None}

    def _handler(signum, frame):
        got["sig"] = signum
        stop.set()

    previous = {
        s: signal.signal(s, _handler)
        for s in (signal.SIGTERM, signal.SIGINT)
    }
    try:
        while not stop.wait(0.2):
            pass
    finally:
        for s, old in previous.items():
            signal.signal(s, old)
    srv.stop(drain=drain)
    return 0


# ---------------------------------------------------------------------------
# the stdlib client
# ---------------------------------------------------------------------------


def http_solve(base_url: str, tenant: str, b, x0=None,
               tol: Optional[float] = None,
               maxiter: Optional[int] = None,
               deadline: Optional[float] = None,
               slo_class: Optional[str] = None, tag: str = "",
               idempotency_key: Optional[str] = None,
               dtype: str = "float64", poll_s: float = 0.01,
               timeout_s: float = 120.0, retries: int = 0,
               retry_cap_s: float = 5.0, opener=None,
               sleep=None, traceparent: Optional[str] = None,
               jitter_seed: Optional[int] = None) -> dict:
    """Submit-poll-fetch one solve over HTTP; returns the final poll
    payload (state ``done`` with ``x``/``info``, or the typed error
    payload with its HTTP status under ``"http_status"``).

    Resilience (``retries`` > 0; the default 0 keeps the one-shot
    behavior benches depend on):

    * transient CONNECTION failures (refused/reset/timeout — the
      server restarting) retry through `retry_with_backoff` (seeded
      jitter from ``jitter_seed``, by default the front-door config's
      ``retry_jitter``, the JAX package's ``PA_RETRY_JITTER``; delays
      capped at
      ``retry_cap_s``, ``give_up`` once the overall ``timeout_s``
      budget is spent);
    * a 429 `LoadShedded` honors the server's measured ``Retry-After``
      (capped at ``retry_cap_s``) before resubmitting, up to
      ``retries`` times — no hand-rolled sleeps in callers;
    * a 503 `AdmissionRejected` (queue-full/draining backpressure) is
      retried the same way — exponential backoff (no server hint)
      under the same ``timeout_s`` budget;
    * a 307 fleet shed-forward is FOLLOWED (always, independent of
      ``retries``; hop cap 4): the submit reposts the identical body
      to the peer in ``Location`` and subsequent polls go to the peer
      — carrying the same idempotency key and traceparent, so a
      forwarded duplicate never double-solves and the trace stays one
      tree across the hop;
    * pair ``retries`` with ``idempotency_key`` and a retried submit
      can NEVER double-solve: the gate returns the original id (and
      bitwise result) for a replayed key.

    ``opener``/``sleep`` are injectable for tests (default
    ``urllib.request.urlopen`` / ``time.sleep``). A poll that gets an
    HTTP error payload (e.g. 404 after handle pruning) returns it
    typed instead of raising.

    Tracing: the submit carries a W3C ``traceparent`` header — the one
    passed in, or a freshly minted client trace — so the request's whole
    server-side span tree (gate queue, page-in, slab, chunks) joins ONE
    trace; the returned payload surfaces the server-confirmed
    ``trace_id``."""
    from ..telemetry import tracing as _tracing
    from ..utils.health import retry_with_backoff
    from .config import config

    if jitter_seed is None:
        jitter_seed = config().retry_jitter

    opener = opener if opener is not None else _urlrequest.urlopen
    sleep = sleep if sleep is not None else time.sleep
    if traceparent is None:
        traceparent = _tracing.mint_trace().traceparent()

    body = {
        "tenant": tenant, "b": list(map(float, b)), "tag": tag,
        "dtype": dtype,
    }
    if x0 is not None:
        body["x0"] = list(map(float, x0))
    if tol is not None:
        body["tol"] = tol
    if maxiter is not None:
        body["maxiter"] = maxiter
    if deadline is not None:
        body["deadline"] = deadline
    if slo_class is not None:
        body["slo_class"] = slo_class
    if idempotency_key is not None:
        body["idempotency_key"] = idempotency_key
    deadline_at = time.monotonic() + timeout_s

    def _request(url, data=None):
        """One HTTP exchange -> (status, payload, headers); an HTTP
        error STATUS is a response (typed payload), not a transient
        failure — only connection-level errors propagate for retry."""
        headers = {"Content-Type": "application/json"}
        if data is not None and traceparent:
            headers["traceparent"] = traceparent
        req = _urlrequest.Request(
            url, data=data, headers=headers,
            method="POST" if data is not None else "GET",
        )
        try:
            with opener(req) as resp:
                return resp.status, json.loads(resp.read()), {}
        except _urlerror.HTTPError as e:
            out = json.loads(e.read())
            return e.code, out, dict(e.headers)

    def _post():
        return retry_with_backoff(
            lambda: _request(
                base_url + "/v1/solve", json.dumps(body).encode()
            ),
            attempts=max(1, retries + 1),
            max_backoff=retry_cap_s,
            exceptions=(_urlerror.URLError, ConnectionError, OSError),
            describe=f"http_solve submit {tag or tenant}",
            sleep=sleep, jitter_seed=jitter_seed,
            give_up=lambda: time.monotonic() >= deadline_at,
        )

    status, sub, headers = _post()
    shed_tries = 0
    hops = 0
    while True:
        if (
            status == 307 and headers.get("Location")
            and hops < 4 and time.monotonic() < deadline_at
        ):
            # fleet shed-forward: the replica redirected this SUBMIT
            # to a peer with headroom — rebase and repost the SAME
            # body (same idempotency key + traceparent, so the hop
            # cannot double-solve and the trace stays one tree). The
            # polls follow the new base too: the peer owns the handle.
            # Hop cap 4 bounds redirect ping-pong in a thrashing fleet.
            loc = headers["Location"]
            base_url = (
                loc[: -len("/v1/solve")]
                if loc.endswith("/v1/solve") else loc
            )
            hops += 1
            status, sub, headers = _post()
            continue
        if (
            status in (429, 503) and shed_tries < retries
            and time.monotonic() < deadline_at
        ):
            # 429 LoadShedded carries the server's measured
            # Retry-After; 503 AdmissionRejected (queue-full/draining
            # backpressure) is equally transient but unhinted —
            # exponential backoff under the same timeout_s budget
            ra = (
                sub.get("retry_after_s")
                or headers.get("Retry-After")
                or 0.05 * 2 ** shed_tries
            )
            sleep(min(max(0.0, float(ra)), retry_cap_s))
            shed_tries += 1
            status, sub, headers = _post()
            continue
        break
    if status not in (200, 202):
        sub["http_status"] = status
        if headers.get("Retry-After"):
            sub["retry_after"] = headers["Retry-After"]
        return sub
    sub["http_status"] = status

    def _get():
        return retry_with_backoff(
            lambda: _request(f"{base_url}/v1/solve/{sub['id']}"),
            attempts=max(1, retries + 1),
            max_backoff=retry_cap_s,
            exceptions=(_urlerror.URLError, ConnectionError, OSError),
            describe=f"http_solve poll {sub['id']}",
            sleep=sleep, jitter_seed=jitter_seed,
            give_up=lambda: time.monotonic() >= deadline_at,
        )

    poll = sub  # the submit retries may have spent the whole budget
    while time.monotonic() < deadline_at:
        pstatus, poll, _ = _get()
        if pstatus != 200:
            poll["http_status"] = pstatus
            return poll
        if poll["state"] not in ("gate-queued", "queued", "running"):
            poll["http_status"] = status
            # surface the submit-time replay verdict (the poll payload
            # itself cannot know it)
            poll["replayed"] = bool(sub.get("replayed", False))
            poll.setdefault("trace_id", sub.get("trace_id"))
            return poll
        sleep(poll_s)
    raise TimeoutError(
        f"request {sub['id']} still "
        f"{poll.get('state', 'unpolled')} after {timeout_s}s"
    )
