"""The front door's write-ahead request journal: crash durability
(frontdoor/journal.py of the JAX package).

Every piece of the gate's state (the EDF queue, tenant residency, in-flight
slab membership) lives in process memory. This journal is the durability
layer under `Gate`: every request lifecycle transition (admitted,
dispatched, chunk-checkpointed, completed, failed, shed) is appended, CRC'd
and fsync'd, BEFORE it is acknowledged to the client, so `Gate.recover()`
can replay it after a kill -9 with zero requests lost and zero duplicated.

The format is the JAX package's, record for record, so each package's
`read_journal` reads a journal the other wrote: append-only JSONL segments
with the checkpoint layer's conventions (per-record CRC32, atomic rotation):

* one record per line: the payload dict serialized canonically
  (``sort_keys``, compact separators) with a ``crc`` field holding the
  CRC32 of the record WITHOUT that field; a reader re-serializes and
  compares, so a torn or bit-rotted line never parses as clean;
* segments are named ``journal-<epoch:06d>-<n:06d>.jsonl``; every journal
  OPEN starts a fresh epoch (monotonic, recorded as an ``epoch`` record)
  and a fresh segment, and an append that grows the current segment past
  ``segment_bytes`` rotates to the next one (close and fsync the old file,
  fsync the directory so the new name is durable);
* ``seq`` is monotonic across epochs: the total order recovery replays in.

Torn tails against corruption: a crash mid-append can tear exactly the
LAST record of the LAST segment; replay truncates it (``journal.truncated``
counter, ``journal_truncated`` event) and continues, the WAL convention. A
bad record anywhere ELSE is real corruption and raises the typed
`JournalCorruptError` instead of silently dropping acknowledged history.

The switches are fields of the front-door config (`frontdoor.configure`;
the JAX package reads them from the environment):

* ``journal`` (``PA_GATE_JOURNAL``, default True): the master switch; off
  disables journaling even when a journal directory is configured.
* ``journal_dir`` (``PA_GATE_JOURNAL_DIR``, default None): the journal
  directory of ``Gate(journal_dir=None)``.
* ``journal_fsync`` (``PA_GATE_JOURNAL_FSYNC``, default True): fsync every
  appended record before the caller proceeds; off trades the power-loss
  guarantee for speed (tests, tmpfs).
* ``journal_keep`` (``PA_GATE_JOURNAL_KEEP``, default None = keep
  everything): after a recovery, prune the segment files of
  fully-recovered prior epochs down to the newest ``keep`` epochs. Pruning
  an epoch that no later recovery has replayed would drop acknowledged
  live state, so `RequestJournal.prune` refuses that typed
  (`JournalRetentionError`).
"""
from __future__ import annotations

import json
import os
import threading
import zlib

from ..utils.locksan import sanitized
from typing import List, Optional, Tuple

__all__ = [
    "JOURNAL_SCHEMA_VERSION",
    "JournalCorruptError",
    "JournalRetentionError",
    "RecoveredError",
    "RequestJournal",
    "journal_enabled",
    "journal_env_dir",
    "journal_fsync",
    "journal_keep",
    "read_journal",
]

JOURNAL_SCHEMA_VERSION = 1

#: Record kinds the gate appends. ``adopted`` is the fleet hop: per-rid
#: markers a surviving replica writes INTO a dead peer's journal when it
#: takes the peer's live requests over; a restarted peer's recovery sees
#: the marker and refuses to re-solve.
RECORD_KINDS = (
    "epoch", "admitted", "dispatched", "chunk", "completed", "failed",
    "shed", "shutdown", "recovered", "adopted",
)


def journal_enabled() -> bool:
    """The config's ``journal`` master switch (default on; journaling
    still needs a configured directory to activate)."""
    from .config import config

    return bool(config().journal)


def journal_env_dir() -> Optional[str]:
    """The config's ``journal_dir`` or None (the name keeps the JAX
    package's, which reads ``PA_GATE_JOURNAL_DIR``)."""
    from .config import config

    return config().journal_dir or None


def journal_fsync() -> bool:
    """The config's ``journal_fsync`` (default on): fsync each append."""
    from .config import config

    return bool(config().journal_fsync)


def journal_keep() -> Optional[int]:
    """The config's ``journal_keep``: how many journal epochs to retain at
    a post-recovery prune, the current one included. None, 0 or a
    negative count = None = keep everything."""
    from .config import config

    n = config().journal_keep
    if n is None:
        return None
    n = int(n)
    return n if n > 0 else None


class JournalCorruptError(RuntimeError):
    """A journal record that is NOT the torn tail failed its CRC or
    would not parse — acknowledged history has been damaged (bit rot,
    a concurrent writer, manual editing). Deliberately distinct from
    the torn-tail case, which is the expected crash artifact and is
    truncated with an event instead of raised."""


class JournalRetentionError(RuntimeError):
    """A prune would drop segment files of an epoch NO later recovery
    has replayed — acknowledged live state (queued/in-flight requests,
    unserved results) would be lost. Retention only ages out history
    that a ``recovered`` record in a LATER epoch proves was folded into
    a live gate; everything younger is refused typed."""


class RecoveredError(RuntimeError):
    """A typed failure replayed from the journal: the original error
    class no longer exists as a live exception object, so recovery
    serves this wrapper carrying the original class name
    (``error_type``) and message — the RPC surface reports
    ``error_type`` for pre-restart ids, keeping the wire contract."""

    def __init__(self, error_type: str, message: str):
        super().__init__(message)
        self.error_type = str(error_type)


def _canonical(body: dict) -> str:
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _verify_line(line: bytes) -> dict:
    """Parse + CRC-verify one journal line; ValueError on any defect
    (the caller decides torn-tail vs corruption)."""
    rec = json.loads(line.decode("utf-8"))
    if not isinstance(rec, dict):
        raise ValueError("journal record is not an object")
    crc = rec.pop("crc", None)
    if crc is None:
        raise ValueError("journal record has no crc")
    if (zlib.crc32(_canonical(rec).encode()) & 0xFFFFFFFF) != int(crc):
        raise ValueError("journal record fails its CRC32")
    return rec


def _segments(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("journal-") and f.endswith(".jsonl")
    )


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # platforms without directory fsync


def _scan(directory: str, truncate: bool,
          strict: bool = True) -> Tuple[List[dict], int]:
    """Replay every segment in order. Returns ``(records,
    truncated_records)``. A defective record that is the tail of the
    LAST segment is the torn-tail case: with ``truncate`` the file is
    cut back to the last clean record (counted + evented), otherwise it
    is skipped. A defective record anywhere else raises
    `JournalCorruptError` when ``strict`` (read-only monitors pass
    ``strict=False`` and simply stop at the first defect — a live
    writer may be mid-append)."""
    records: List[dict] = []
    dropped = 0
    segs = _segments(directory)
    for i, seg in enumerate(segs):
        with open(seg, "rb") as f:
            raw = f.read()
        pos = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            line = raw[pos:] if nl < 0 else raw[pos:nl]
            end = len(raw) if nl < 0 else nl + 1
            if line.strip():
                try:
                    records.append(_verify_line(line))
                except ValueError as e:
                    tail_rest = raw[end:].strip()
                    is_tail = i == len(segs) - 1 and not tail_rest
                    if not is_tail:
                        if strict:
                            raise JournalCorruptError(
                                f"journal {directory}: defective record "
                                f"in {os.path.basename(seg)} at byte "
                                f"{pos} is NOT the torn tail ({e}) — "
                                "acknowledged history is damaged"
                            )
                        return records, dropped
                    dropped += 1
                    if truncate:
                        _truncate_tail(seg, pos, len(raw) - pos)
                    break
            pos = end
    return records, dropped


def _truncate_tail(seg: str, pos: int, nbytes: int) -> None:
    """Cut the torn tail off ``seg`` at byte ``pos`` — counted and
    evented so an operator learns the crash ate an unacknowledged
    record (never an acknowledged one: the ack happens after fsync)."""
    from ..telemetry import emit_event
    from ..telemetry.registry import registry

    with open(seg, "rb+") as f:
        f.truncate(pos)
        f.flush()
        os.fsync(f.fileno())
    registry().counter("journal.truncated").inc()
    emit_event(
        "journal_truncated", label=os.path.basename(seg),
        offset=pos, dropped_bytes=nbytes,
    )


def read_journal(directory: str, truncate: bool = False,
                 strict: bool = False) -> List[dict]:
    """Read-only replay (tools, drills, tests): returns the clean
    records without mutating the journal by default."""
    return _scan(directory, truncate=truncate, strict=strict)[0]


class RequestJournal:
    """One gate's append-only request journal (see module docstring).

    Opening replays every prior segment (truncating a torn tail),
    exposes the clean history as ``prior_records``, allocates the next
    ``epoch``, and starts a fresh segment with an ``epoch`` record —
    so a journal directory narrates every gate generation that ever
    served it, in one total ``seq`` order."""

    def __init__(self, directory: str, fsync: Optional[bool] = None,
                 segment_bytes: int = 1 << 20):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fsync = journal_fsync() if fsync is None else bool(fsync)
        self.segment_bytes = max(4096, int(segment_bytes))
        self._lock = sanitized(threading.Lock(), "RequestJournal._lock")
        self.prior_records, _ = _scan(self.directory, truncate=True)
        self.epoch = 1 + max(
            (int(r["epoch"]) for r in self.prior_records
             if r.get("kind") == "epoch"),
            default=0,
        )
        self._seq = 1 + max(
            (int(r.get("seq", -1)) for r in self.prior_records),
            default=-1,
        )
        self._segment_n = 0
        #: True once THIS epoch appended a ``recovered`` record — the
        #: retention frontier extends to the current epoch then.
        self._recovered_marked = False
        self._fh = open(self._segment_path(), "ab")
        _fsync_dir(self.directory)
        self.append("epoch", epoch=self.epoch,
                    journal_schema_version=JOURNAL_SCHEMA_VERSION)

    def _segment_path(self) -> str:
        return os.path.join(
            self.directory,
            f"journal-{self.epoch:06d}-{self._segment_n:06d}.jsonl",
        )

    def append(self, kind: str, _sync: Optional[bool] = None,
               **payload) -> dict:
        """Durably append one lifecycle record; returns it (with its
        ``seq``). The write is flushed (and fsync'd unless disabled)
        BEFORE returning — the caller may acknowledge the transition
        to a client the moment this returns. ``_sync=False`` skips the
        per-record fsync for records nothing acknowledges against
        (e.g. ``shed`` refusals under overload — cheap refusal must
        stay cheap); the next synced append or rotation flushes them
        too."""
        from ..telemetry.registry import registry

        assert kind in RECORD_KINDS, kind
        import time as _time

        with self._lock:
            rec = dict(payload)
            rec["kind"] = kind
            rec["seq"] = self._seq
            rec["wall"] = _time.time()
            self._seq += 1
            body = _canonical(rec)
            rec_crc = dict(rec)
            rec_crc["crc"] = zlib.crc32(body.encode()) & 0xFFFFFFFF
            self._fh.write((_canonical(rec_crc) + "\n").encode())
            self._fh.flush()
            if self.fsync and (_sync is None or _sync):
                os.fsync(self._fh.fileno())
            registry().counter("journal.appends").inc()
            if kind == "recovered":
                self._recovered_marked = True
            if self._fh.tell() >= self.segment_bytes:
                self._rotate()
            return rec

    def _rotate(self) -> None:
        """Close the full segment (fsync'd) and open the next one —
        the directory fsync publishes the new name durably (callers
        hold ``self._lock``)."""
        from ..telemetry.registry import registry

        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._segment_n += 1
        self._fh = open(self._segment_path(), "ab")
        _fsync_dir(self.directory)
        registry().counter("journal.rotations").inc()

    def segments(self) -> List[str]:
        return _segments(self.directory)

    def _recovered_frontier(self) -> int:
        """The newest epoch proven replayed-from: the max epoch holding
        a ``recovered`` record (every epoch BELOW it was folded into a
        live gate by that recovery). 0 = no recovery ever ran."""
        frontier = 0
        cur = 0
        for rec in self.prior_records:
            kind = rec.get("kind")
            if kind == "epoch":
                cur = int(rec.get("epoch", cur))
            elif kind == "recovered":
                frontier = max(frontier, cur)
        if self._recovered_marked:
            frontier = max(frontier, self.epoch)
        return frontier

    def prune(self, keep: Optional[int] = None) -> List[str]:
        """Retention (the config's ``journal_keep``): drop the segment files
        of the OLDEST epochs until at most ``keep`` epochs (including
        the current one) remain on disk — mirroring the checkpoint
        layer's ``KEEP_GENERATIONS`` convention. Only fully-recovered
        epochs (strictly below the `_recovered_frontier`) may be
        dropped; an epoch no later recovery has replayed still holds
        acknowledged live state, so dropping it raises the typed
        `JournalRetentionError` and NOTHING is unlinked. Returns the
        pruned file paths (counted under ``journal.pruned`` and evented
        ``journal_pruned``). ``keep=None`` reads the config's
        ``journal_keep``; None there means retention is off and this is a
        no-op."""
        from ..telemetry import emit_event
        from ..telemetry.registry import registry

        keep = journal_keep() if keep is None else max(1, int(keep))
        if keep is None:
            return []
        with self._lock:
            by_epoch: dict = {}
            for seg in _segments(self.directory):
                name = os.path.basename(seg)
                try:
                    epoch = int(name.split("-")[1])
                except (IndexError, ValueError):
                    continue  # not a segment file we own
                by_epoch.setdefault(epoch, []).append(seg)
            epochs = sorted(by_epoch)
            drop = epochs[:-keep] if len(epochs) > keep else []
            if not drop:
                return []
            frontier = self._recovered_frontier()
            unrecovered = [e for e in drop if e >= frontier]
            if unrecovered:
                raise JournalRetentionError(
                    f"journal {self.directory}: pruning to KEEP={keep} "
                    f"would drop epoch(s) {unrecovered} that no later "
                    "recovery has replayed (recovered frontier: "
                    f"{frontier or 'none'}) — their admitted requests "
                    "and results are still live state; run recover() "
                    "first or raise journal_keep"
                )
            pruned: List[str] = []
            for epoch in drop:
                for seg in by_epoch[epoch]:
                    os.unlink(seg)
                    pruned.append(seg)
            _fsync_dir(self.directory)
        registry().counter("journal.pruned").inc(len(pruned))
        emit_event(
            "journal_pruned", label=self.directory,
            epochs=[int(e) for e in drop], files=len(pruned), keep=keep,
        )
        return pruned

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self._fh.close()

    def __repr__(self):
        return (
            f"RequestJournal({self.directory!r}, epoch={self.epoch}, "
            f"seq={self._seq}, segments={len(self.segments())})"
        )
