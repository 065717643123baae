"""Deterministic fault injection (the chaos harness).

The port's own copy of `partitionedarrays_jl_tpu/parallel/faults.py`: a
seeded spec injects failures into the one choke point every host halo
update, ghost assembly and planning exchange funnels through,
`collectives.async_exchange_into`. The detection and recovery half lives
in `utils/health.py` and `models/solvers.py` (`solve_with_recovery`).

Activation: ``with inject_faults("nan@part=1,call=3", seed=42) as st: ...``
(nestable; the innermost spec wins; ``st.events`` records what fired). The
JAX package's ``PA_FAULT_SPEC``/``PA_FAULT_SEED`` are not read.

Spec grammar: ``;``-separated clauses, each ``kind@key=val,key=val``.

    kind    nan        overwrite selected send-payload entries with NaN
            bitflip    XOR one mantissa bit of selected entries
            drop       the part's contribution never completes: waiting on
                       the exchange raises ExchangeTimeoutError
            delay      sleep ``seconds`` at the matched call
            controller the controller dies: ControllerLostError
            part_loss  part ``part`` is dead: every matched exchange raises
                       PartLossError (a part id is required)
    part    sending part id, or ``*`` (any part, the default); an id outside
            the run's part grid matches nothing
    call    exchange-call index the clause fires at (``*`` every call, the
            default); the counter starts at 0 when the spec becomes active
    after   fire at every call index >= this value
    prob    per-entry corruption probability (default 1.0; at least one
            entry of a nonempty payload is hit)
    bit     the exact bit to flip, counted from the mantissa's LSB, modulo
            the word width (default a random bit of the low 20)
    seconds the delay's duration (default 0.01)

Determinism: one NumPy Generator seeded from the spec seed draws every
selection, and the parts run in order, so a (spec, seed, program) corrupts
the same bits on every run, and the same bits as the JAX package's harness:
the draws are the same calls on the same Generator. Selection runs over the
leading (wire slot) axis of a payload, so an ``(L, K)`` block slab takes
the draws of its ``(L,)`` payload and corrupts column 0 of each slot.

The device loops cannot be reached through the host hook; their chaos seam
is `SDCConfig.device_fault` (the JAX package's ``PA_FAULT_DEVICE``), parsed
by `parse_device_fault`: ``spmv@trip=N[,part=P][,factor=F]`` perturbs the
SpMV product's first owned slot of part P (default 0) by a finite relative
error F (default 1e3) at loop trip N, a counter that never rewinds.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils.health import ControllerLostError, PartLossError
from ..utils.table import Table

__all__ = [
    "FaultClause", "FaultSpec", "FaultState", "inject_faults", "faults_active", "active_fault_state",
    "parse_device_fault",
]

_KINDS = ("nan", "bitflip", "drop", "delay", "controller", "part_loss")


@dataclass(frozen=True)
class FaultClause:
    kind: str
    part: Optional[int] = None  # None = any part
    call: Optional[int] = None  # None = every call (unless `after` set)
    after: Optional[int] = None  # fire at every call >= after
    prob: float = 1.0
    bit: Optional[int] = None  # exact mantissa bit for bitflip
    seconds: float = 0.01

    def matches(self, call: int, part: Optional[int] = None) -> bool:
        if self.after is not None:
            if call < self.after:
                return False
        elif self.call is not None and call != self.call:
            return False
        if part is not None and self.part is not None and part != self.part:
            return False
        return True


class FaultSpec:
    """A parsed set of fault clauses (see the module docstring's grammar)."""

    def __init__(self, clauses: List[FaultClause]):
        self.clauses = list(clauses)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        clauses = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, _, rest = raw.partition("@")
            kind = kind.strip().lower()
            if kind not in _KINDS:
                raise ValueError(f"fault spec: unknown kind {kind!r} in {raw!r} (expected one of {_KINDS})")
            kw = {}
            for item in filter(None, (s.strip() for s in rest.split(","))):
                key, eq, val = item.partition("=")
                if not eq:
                    raise ValueError(f"fault spec: expected key=value, got {item!r}")
                key = key.strip().lower()
                val = val.strip()
                if key in ("part", "call", "after", "bit"):
                    kw[key] = None if val == "*" else int(val)
                elif key in ("prob", "seconds"):
                    kw[key] = float(val)
                else:
                    raise ValueError(f"fault spec: unknown key {key!r}")
            if kind == "part_loss" and kw.get("part") is None:
                raise ValueError(
                    f"fault spec: part_loss needs an explicit part id in {raw!r}; 'any part died' is not a fault model"
                )
            clauses.append(FaultClause(kind=kind, **kw))
        return cls(clauses)

    def __repr__(self):
        return f"FaultSpec({self.clauses!r})"


@dataclass
class FaultState:
    """One active injection session: the spec, the seeded generator, the
    exchange-call counter and ``events``, the record of every fault that
    fired."""

    spec: FaultSpec
    seed: int = 0
    call_index: int = 0
    events: List[dict] = field(default_factory=list)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def record(self, **ev) -> None:
        self.events.append(ev)


_lock = threading.Lock()
_stack: List[FaultState] = []


@contextmanager
def inject_faults(spec, seed: int = 0):
    """Activate a fault spec (a `FaultSpec` or a grammar string) for the
    dynamic extent of the block; yields the `FaultState`."""
    if isinstance(spec, str):
        spec = FaultSpec.parse(spec)
    state = FaultState(spec=spec, seed=seed)
    with _lock:
        _stack.append(state)
    try:
        yield state
    finally:
        with _lock:
            _stack.remove(state)


def active_fault_state() -> Optional[FaultState]:
    """The innermost active `FaultState`, or None."""
    return _stack[-1] if _stack else None


def faults_active() -> bool:
    return bool(_stack)


# ---------------------------------------------------------------------------
# the exchange hook (called from collectives.async_exchange_into)
# ---------------------------------------------------------------------------


def _corrupt_array(a: np.ndarray, kind: str, prob: float, rng, bit: Optional[int] = None) -> int:
    """Corrupt a float payload in place; returns the slots hit. The draws
    run over the leading axis only, so an ``(L, K)`` slab takes the draws of
    the ``(L,)`` payload and corrupts each selected slot's first word
    (faults.py:257, the same draws in the same order)."""
    if a.size == 0 or a.dtype.kind != "f":
        return 0
    nslots = a.shape[0]
    mask = rng.random(nslots) < prob
    if not mask.any():
        mask[int(rng.integers(nslots))] = True  # a nonempty payload: >= 1 hit
    idx = np.nonzero(mask)[0]
    flat = a.reshape(nslots, -1)
    if kind == "nan":
        flat[idx, 0] = np.nan
        return int(len(idx))
    wide = a.dtype.itemsize == 8
    bits = flat[:, 0].copy().view(np.uint64 if wide else np.uint32)
    if bit is not None:
        # modulo the word width: an out-of-range bit would flip nothing
        shift = np.full(len(idx), int(bit) % (8 * a.dtype.itemsize), dtype=np.int64)
    else:
        shift = rng.integers(0, 20, size=len(idx))
    bits[idx] ^= (np.uint64(1) << shift.astype(np.uint64)) if wide else (np.uint32(1) << shift.astype(np.uint32))
    flat[:, 0] = bits.view(a.dtype)
    return int(len(idx))


def exchange_faults_hook(data_snd, parts_snd):
    """Apply the active spec to one exchange: returns ``(data_snd,
    dropped_parts)``, a corrupted copy of the send payloads and the parts
    whose contribution is lost (None when none). Raises `PartLossError` or
    `ControllerLostError` for a matched clause of those kinds."""
    state = active_fault_state()
    if state is None:
        return data_snd, None
    call = state.call_index
    state.call_index += 1
    live = [c for c in state.spec.clauses if c.matches(call)]
    if not live:
        return data_snd, None

    nparts = data_snd.num_parts
    for c in live:
        if c.kind == "part_loss":
            # an id outside the grid matches nothing: a shrunken survivor
            # grid no longer holds the dead part
            if not (0 <= c.part < nparts):
                continue
            state.record(kind="part_loss", call=call, part=c.part)
            raise PartLossError(
                f"part {c.part} lost at exchange call {call}: its contribution will never arrive "
                "(persistent, unlike a timeout)",
                diagnostics={"call": call, "part": c.part, "nparts": nparts, "injected": True},
            )
        if c.kind == "controller":
            if c.part is not None and not (0 <= c.part < nparts):
                continue
            state.record(kind="controller", call=call, part=c.part)
            raise ControllerLostError(
                f"injected controller failure at exchange call {call}"
                + (f" (part {c.part})" if c.part is not None else ""),
                diagnostics={"call": call, "part": c.part, "injected": True},
            )

    from .backends import get_part_ids, map_parts

    corrupt = [c for c in live if c.kind in ("nan", "bitflip")]
    dropped: List[int] = []
    for c in live:
        if c.part is not None and not (0 <= c.part < nparts):
            continue
        if c.kind == "drop":
            for p in [c.part] if c.part is not None else list(range(nparts)):
                if p not in dropped:
                    dropped.append(p)
                    state.record(kind="drop", call=call, part=p)
        elif c.kind == "delay":
            state.record(kind="delay", call=call, part=c.part, seconds=c.seconds)
            time.sleep(c.seconds)

    if corrupt:
        rng, rec = state.rng, state.record

        def _corrupt_part(p, payload):
            hits = [c for c in corrupt if c.matches(call, int(p))]
            if not hits:
                return payload
            if isinstance(payload, Table):
                out = Table(np.array(payload.data, copy=True), payload.ptrs)
                arr = out.data
            else:
                arr = np.array(payload, copy=True)
                out = arr
            for c in hits:
                n = _corrupt_array(arr, c.kind, c.prob, rng, bit=c.bit)
                if n:
                    rec(kind=c.kind, call=call, part=int(p), entries=n)
            return out

        data_snd = map_parts(_corrupt_part, get_part_ids(data_snd), data_snd)

    return data_snd, (dropped or None)


# ---------------------------------------------------------------------------
# the device loops' seam
# ---------------------------------------------------------------------------


def parse_device_fault(text: Optional[str]) -> Optional[dict]:
    """Parse the device loops' fault clause ``spmv@trip=N[,part=P][,factor=F]``
    (faults.py:403's grammar): ``{"trip", "part", "factor"}``, or None for
    no clause. At loop trip N (a counter that never rewinds, so the clause
    fires once even across rollbacks) the SpMV product's first owned slot of
    part P (default 0) is perturbed by ``F·(1 + |q|)`` (default F = 1e3)."""
    if not text:
        return None
    kind, _, rest = text.strip().partition("@")
    if kind.strip().lower() != "spmv":
        raise ValueError(f"device fault: unknown kind {kind!r} (expected 'spmv')")
    out = {"trip": None, "part": 0, "factor": 1e3}
    for item in filter(None, (s.strip() for s in rest.split(","))):
        key, eq, val = item.partition("=")
        if not eq:
            raise ValueError(f"device fault: expected key=value, got {item!r}")
        key = key.strip().lower()
        if key == "trip":
            out["trip"] = int(val)
        elif key == "part":
            out["part"] = int(val)
        elif key == "factor":
            out["factor"] = float(val)
        else:
            raise ValueError(f"device fault: unknown key {key!r}")
    if out["trip"] is None:
        raise ValueError("device fault: a trip=N index is required")
    return out
