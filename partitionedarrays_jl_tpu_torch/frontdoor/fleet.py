"""Replicated gate fleet: tenant-affinity routing, lease heartbeats,
journal-backed peer failover and shed-forward peer picking
(frontdoor/fleet.py of the JAX package). Host code only: nothing here
touches the card.

N `Gate` replicas (separate processes, or gates of one process) share one
``fleet_dir``; everything cross-replica flows through that directory and
plain HTTP, with no coordinator process. ``fleet_dir/<replica>/`` IS the
replica's journal dir, beside its ``url``, ``pid`` and ``lease.json``
files; ``fleet_dir/tx/`` is a shared tracing dir.

**Routing** is rendezvous (highest-random-weight) hashing: `route(tenant,
replicas)` ranks replicas by ``sha256(tenant|replica)`` and picks the top:
deterministic from any client with no shared state, and minimally
disruptive (when a replica joins or leaves, only the tenants whose
top-ranked replica changed move). The same ranking chooses a dead
replica's ADOPTER: ``rendezvous_rank(dead_replica, survivors)[0]``.

**Leases**: each replica's heartbeat thread rewrites ``lease.json`` every
``lease_s / 3`` (CRC'd canonical JSON via atomic tmp + rename; a torn or
flipped lease is the typed `LeaseCorruptError`, which REFUSES takeover
rather than triggering a false one). A lease older than ``3 * lease_s``
wall-clock marks its replica dead; the ranked adopter counts
``fleet.lease_missed``, events ``fleet_lease_missed`` and runs
`Gate.adopt` on the dead peer's journal dir.

**Shed-forwarding**: `FleetMember.pick_peer` is the `GateServer.peer_picker`
hook: on `LoadShedded` it reads live-leased peers' ``/healthz`` (cached
``lease_s / 2``) and returns the shallowest peer still under its own
advertised ``shed_watermark``, or None (fall back to 429).

The switches are fields of the front-door config: ``fleet_replicas`` (the
JAX package's ``PA_FLEET_REPLICAS``, default 2) and ``fleet_lease_s``
(``PA_FLEET_LEASE_S``, default 2.0 s).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional
from urllib import request as _urlrequest

from ..telemetry.registry import registry
from ..utils.helpers import check

__all__ = [
    "LeaseCorruptError",
    "fleet_replicas",
    "fleet_lease_s",
    "write_lease",
    "read_lease",
    "rendezvous_rank",
    "route",
    "FleetMap",
    "FleetMember",
]

LEASE_NAME = "lease.json"


def fleet_replicas() -> int:
    """The config's ``fleet_replicas`` (default 2, floor 1)."""
    from .config import config

    return max(1, int(config().fleet_replicas))


def fleet_lease_s() -> float:
    """The config's ``fleet_lease_s`` (default 2.0 s, floor 0.05 s)."""
    from .config import config

    return max(0.05, float(config().fleet_lease_s))


class LeaseCorruptError(RuntimeError):
    """A lease file failed its CRC/JSON check — the one reading it
    must treat the replica's state as UNKNOWN and refuse takeover
    (a corrupt lease is evidence of a torn write or disk fault, not
    of a dead replica)."""


def _canonical(rec: dict) -> str:
    return json.dumps(
        rec, sort_keys=True, separators=(",", ":"), allow_nan=False
    )


def write_lease(path: str, replica: str, **extra) -> dict:
    """Atomically publish a heartbeat lease (tmp + rename; CRC over
    the canonical JSON body, journal-style)."""
    rec = dict(extra, replica=replica, wall=time.time())
    rec["crc"] = zlib.crc32(_canonical(rec).encode()) & 0xFFFFFFFF
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(_canonical(rec))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return rec


def read_lease(path: str) -> Optional[dict]:
    """The verified lease dict, None when absent, typed
    `LeaseCorruptError` on torn/corrupt content."""
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        rec = json.loads(raw)
        crc = rec.pop("crc")
    except (json.JSONDecodeError, ValueError, KeyError, TypeError,
            AttributeError) as e:
        raise LeaseCorruptError(
            f"lease {path}: unparseable ({e}) — torn write or disk "
            "fault; refusing to treat the replica as dead"
        ) from None
    want = zlib.crc32(_canonical(rec).encode()) & 0xFFFFFFFF
    if crc != want:
        raise LeaseCorruptError(
            f"lease {path}: CRC mismatch (recorded {crc}, computed "
            f"{want}) — refusing to treat the replica as dead"
        )
    return rec


def rendezvous_rank(key: str, replicas) -> List[str]:
    """Replicas ranked by highest-random-weight for ``key`` —
    deterministic everywhere, minimal movement on membership change."""
    return sorted(
        replicas,
        key=lambda r: hashlib.sha256(
            f"{key}|{r}".encode()
        ).hexdigest(),
        reverse=True,
    )


def route(tenant: str, replicas) -> str:
    """The replica that owns ``tenant`` (its device residency stays
    warm there) — rank[0] of the rendezvous ordering."""
    ranked = rendezvous_rank(tenant, replicas)
    check(ranked, "fleet: route() needs at least one replica")
    return ranked[0]


class FleetMap:
    """The read side of a fleet dir: replica discovery + url/lease/
    journal-dir lookups (no caching — every call re-reads disk, the
    source of truth)."""

    def __init__(self, fleet_dir: str):
        self.fleet_dir = os.path.abspath(fleet_dir)

    def replicas(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.fleet_dir))
        except FileNotFoundError:
            return []
        return [
            n for n in names
            if n != "tx"
            and os.path.isdir(os.path.join(self.fleet_dir, n))
        ]

    def journal_dir(self, replica: str) -> str:
        return os.path.join(self.fleet_dir, replica)

    def url(self, replica: str) -> Optional[str]:
        try:
            with open(os.path.join(self.fleet_dir, replica, "url"),
                      encoding="utf-8") as f:
                return f.read().strip() or None
        except FileNotFoundError:
            return None

    def write_url(self, replica: str, url: str) -> None:
        d = os.path.join(self.fleet_dir, replica)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "url.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(url)
        os.replace(tmp, os.path.join(d, "url"))

    def lease(self, replica: str) -> Optional[dict]:
        return read_lease(
            os.path.join(self.fleet_dir, replica, LEASE_NAME)
        )

    def __repr__(self):
        return (
            f"FleetMap({self.fleet_dir!r}, "
            f"replicas={self.replicas()})"
        )


class FleetMember:
    """One replica's fleet participation: the heartbeat that keeps its
    own lease fresh, the peer picker the HTTP server consults on shed,
    and the watcher that adopts a dead peer's journal.

    Wire-up::

        member = FleetMember(fleet_dir, "g0", gate, server=srv)
        srv.peer_picker = member.pick_peer
        member.start()

    `check_peers` is also callable manually (tests, drills); unlike
    the watcher loop it PROPAGATES `LeaseCorruptError`, so the typed
    refusal is directly assertable."""

    def __init__(self, fleet_dir: str, replica: str, gate,
                 server=None, lease_s: Optional[float] = None,
                 healthz=None):
        self.map = FleetMap(fleet_dir)
        self.replica = replica
        self.gate = gate
        self.server = server
        self.lease_s = (
            fleet_lease_s() if lease_s is None else max(0.05, lease_s)
        )
        #: injectable /healthz fetch for tests: url -> dict (or raise)
        self._healthz = (
            healthz if healthz is not None else self._healthz_http
        )
        self._hz_cache: Dict[str, tuple] = {}
        self._missed: set = set()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        os.makedirs(self.map.journal_dir(replica), exist_ok=True)

    # -- own lease ---------------------------------------------------------
    @property
    def lease_path(self) -> str:
        return os.path.join(
            self.map.journal_dir(self.replica), LEASE_NAME
        )

    def heartbeat(self) -> dict:
        """One lease refresh (the thread calls this every
        ``lease_s / 3``; exposed for deterministic tests)."""
        return write_lease(
            self.lease_path, self.replica,
            depth=self.gate.depth(),
            pid=os.getpid(),
        )

    # -- shed-forward peer picking ----------------------------------------
    def _healthz_http(self, url: str) -> dict:
        with _urlrequest.urlopen(
            url + "/healthz", timeout=1.0
        ) as resp:
            return json.loads(resp.read())

    def _peer_health(self, replica: str, url: str) -> Optional[dict]:
        now = time.monotonic()
        hit = self._hz_cache.get(replica)
        if hit is not None and now - hit[0] < self.lease_s / 2:
            return hit[1]
        try:
            hz = self._healthz(url)
        except Exception:
            hz = None  # unreachable peer: not a forward target
        self._hz_cache[replica] = (now, hz)
        return hz

    def live_peers(self) -> List[str]:
        """Peers (not self) with a fresh, verified lease. Corrupt
        leases propagate typed — refusal, not guesswork."""
        out = []
        for r in self.map.replicas():
            if r == self.replica:
                continue
            lease = self.map.lease(r)
            if lease is None:
                continue
            if time.time() - float(lease.get("wall", 0.0)) \
                    <= 3.0 * self.lease_s:
                out.append(r)
        return out

    def pick_peer(self) -> Optional[str]:
        """The `GateServer.peer_picker` hook: the shallowest
        live-leased peer still under its OWN shed watermark, or None
        (the server falls back to 429). Lease corruption here degrades
        to None — forwarding is an optimization, never worth a 500."""
        best = None
        try:
            peers = self.live_peers()
        except LeaseCorruptError:
            return None
        for r in peers:
            url = self.map.url(r)
            if not url:
                continue
            hz = self._peer_health(r, url)
            if hz is None or not hz.get("ok"):
                continue
            depth = int(hz.get("queue_depth", 0))
            mark = hz.get("shed_watermark")
            if mark is not None and depth >= int(mark):
                continue  # the peer would shed it right back
            if best is None or depth < best[0]:
                best = (depth, url)
        return best[1] if best else None

    # -- failover ----------------------------------------------------------
    def check_peers(self) -> Dict[str, dict]:
        """One failover sweep: find peers whose lease is STALE
        (present but older than ``3 * lease_s``), and — when THIS
        replica is the rendezvous-ranked adopter among survivors —
        adopt their journals. Returns ``{replica: adopt_summary}``
        for the peers adopted this sweep.

        Raises `LeaseCorruptError` when a peer's lease fails its CRC:
        a torn lease means the peer's state is unknown, and a false
        takeover (two replicas solving the same journal) is the one
        unrecoverable outcome — so this path refuses loudly. The
        lease is RE-READ immediately before adoption so a heartbeat
        that lands mid-sweep cancels the takeover."""
        from .. import telemetry

        adopted = {}
        replicas = self.map.replicas()
        stale, fresh = [], [self.replica]
        for r in replicas:
            if r == self.replica:
                continue
            lease = self.map.lease(r)  # may raise LeaseCorruptError
            if lease is None:
                continue  # never heartbeat: not ours to judge
            age = time.time() - float(lease.get("wall", 0.0))
            if age > 3.0 * self.lease_s:
                stale.append(r)
            else:
                fresh.append(r)
        for r in stale:
            if r in self._missed:
                continue  # already adopted (or ceded) this death
            adopter = rendezvous_rank(r, fresh)[0]
            if adopter != self.replica:
                continue  # a better-ranked survivor owns this one
            # re-check just before takeover: a recovering peer's
            # heartbeat between the sweep and here cancels adoption
            lease = self.map.lease(r)
            if lease is not None and time.time() - float(
                lease.get("wall", 0.0)
            ) <= 3.0 * self.lease_s:
                continue
            self._missed.add(r)
            registry().counter("fleet.lease_missed").inc()
            telemetry.emit_event(
                "fleet_lease_missed", label=r,
                age_s=round(
                    time.time() - float((lease or {}).get("wall", 0.0)),
                    3,
                ),
                adopter=self.replica,
            )
            summary = self.gate.adopt(self.map.journal_dir(r))
            adopted[r] = summary
            if self.server is not None:
                # adopted handles must be pollable HERE (clients are
                # redirected or retry against the survivor)
                for rid, h in self.gate.handles_snapshot():
                    self.server.handles.setdefault(rid, h)
        return adopted

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetMember":
        self.heartbeat()  # publish before serving: no false-dead start

        def _beat():
            while not self._stop.wait(self.lease_s / 3.0):
                try:
                    self.heartbeat()
                except OSError:
                    pass  # a full disk must not kill the serving loop

        def _watch():
            from .. import telemetry

            while not self._stop.wait(self.lease_s):
                try:
                    self.check_peers()
                except LeaseCorruptError as e:
                    # typed refusal, evented — NOT a takeover
                    telemetry.emit_event(
                        "fleet_lease_missed", label=self.replica,
                        refused="lease-corrupt", detail=str(e)[:200],
                    )
                except Exception:
                    pass  # watcher survives transient fs/peer errors

        for name, target in (("beat", _beat), ("watch", _watch)):
            t = threading.Thread(
                target=target, daemon=True,
                name=f"pafleet-{name}-{self.replica}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def __repr__(self):
        return (
            f"FleetMember({self.replica!r}, lease_s={self.lease_s}, "
            f"{self.map!r})"
        )
