"""Backend-generic collective / communication primitives (L2).

The port's copy of `partitionedarrays_jl_tpu/parallel/collectives.py`
(reference: src/Interfaces.jl:127-564), with its fault-injection and
checksum seams at the one exchange choke point, `async_exchange_into`
(collectives.py:193-355). Everything is derived from four
backend-abstract primitives implemented by each PData class:
`_gather`, `_scatter`, `_emit`, `_async_exchange`. These run on the
host during planning; the card's halo exchange lives in `parallel/gpu.py`.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional, Tuple

import numpy as np

from ..utils.table import Table
from .backends import (
    MAIN,
    AbstractPData,
    Token,
    get_main_part,
    map_parts,
    schedule_and_wait,
)

# ---------------------------------------------------------------------------
# gather / scatter / emit
# ---------------------------------------------------------------------------


def gather(snd: AbstractPData) -> AbstractPData:
    """All parts' values -> one vector (or Table for vector payloads) on
    MAIN; other parts receive an empty container
    (reference: src/Interfaces.jl:127-168)."""
    return snd._gather()


def gather_all(snd: AbstractPData) -> AbstractPData:
    """Allgather: every part receives the full vector/Table
    (reference: src/Interfaces.jl:170-196)."""
    return snd._gather(to_all=True)


def scatter(snd: AbstractPData) -> AbstractPData:
    """MAIN's n-entry value -> one entry per part
    (reference: src/Interfaces.jl:200-202)."""
    return snd._scatter()


def emit(snd: AbstractPData) -> AbstractPData:
    """Broadcast MAIN's value to all parts ("AKA broadcast",
    reference: src/Interfaces.jl:205-219)."""
    return snd._emit()


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _local_reduce(op: Callable, xs, init):
    acc = init
    for x in xs:
        acc = op(acc, x)
    return acc


def reduce_main(op: Callable, a: AbstractPData, init) -> AbstractPData:
    """Reduction available on MAIN only (others hold the reduction of an
    empty sequence, i.e. `init`). Reference: src/Interfaces.jl:221-224."""
    g = gather(a)
    return map_parts(lambda xs: _local_reduce(op, np.asarray(xs), init), g)


def reduce_all(op: Callable, a: AbstractPData, init) -> AbstractPData:
    """Reference: src/Interfaces.jl:226-229."""
    return emit(reduce_main(op, a, init))


def preduce(op: Callable, a: AbstractPData, init):
    """Scalar result of reducing one value per part (Base.reduce analog,
    reference: src/Interfaces.jl:231-234). Deterministic left-fold in part
    order — the reduction order the GPU backend's dots follow."""
    return get_main_part(reduce_main(op, a, init))


def sum_parts(a: AbstractPData):
    """Base.sum analog (reference: src/Interfaces.jl:236-238)."""
    import operator

    return preduce(operator.add, a, _zero_like(a))


def _zero_like(a: AbstractPData):
    v = get_main_part(a)
    if isinstance(v, np.ndarray):
        return np.zeros_like(v)
    return type(v)(0)


# ---------------------------------------------------------------------------
# prefix scans
# ---------------------------------------------------------------------------


def _iscan_local(op, b, init):
    b = np.array(b, copy=True)
    if len(b):
        b[0] = op(init, b[0])
    for i in range(len(b) - 1):
        b[i + 1] = op(b[i], b[i + 1])
    return b


def _xscan_local(op, b, init):
    b = np.array(b, copy=True)
    if len(b):
        b[1:] = b[:-1]
        b[0] = init
    for i in range(len(b) - 1):
        b[i + 1] = op(b[i], b[i + 1])
    return b


def _scan_main(local: Callable, op, a, init, with_total):
    b = gather(a)
    if with_total:
        n = map_parts(lambda xs: _local_reduce(op, np.asarray(xs), init), b)
        scanned = map_parts(lambda xs: local(op, np.asarray(xs), init), b)
        return scanned, get_main_part(n)
    return map_parts(lambda xs: local(op, np.asarray(xs), init), b)


def iscan_main(op, a: AbstractPData, init, with_total: bool = False):
    """Inclusive prefix scan; full scan vector lands on MAIN
    (reference: src/Interfaces.jl:260-284)."""
    return _scan_main(_iscan_local, op, a, init, with_total)


def iscan(op, a: AbstractPData, init, with_total: bool = False):
    """Inclusive prefix scan, part p receives entry p
    (reference: src/Interfaces.jl:240-248). With `with_total=True` also
    returns the grand total."""
    if with_total:
        b, n = iscan_main(op, a, init, with_total=True)
        return scatter(b), n
    return scatter(iscan_main(op, a, init))


def iscan_all(op, a: AbstractPData, init, with_total: bool = False):
    """Reference: src/Interfaces.jl:250-258."""
    if with_total:
        b, n = iscan_main(op, a, init, with_total=True)
        return emit(b), n
    return emit(iscan_main(op, a, init))


def xscan_main(op, a: AbstractPData, init, with_total: bool = False):
    """Exclusive prefix scan on MAIN (reference: src/Interfaces.jl:309-333)."""
    return _scan_main(_xscan_local, op, a, init, with_total)


def xscan(op, a: AbstractPData, init, with_total: bool = False):
    """Exclusive prefix scan (reference: src/Interfaces.jl:289-297). Used to
    compute `part_to_firstgid` from per-part owned counts."""
    if with_total:
        b, n = xscan_main(op, a, init, with_total=True)
        return scatter(b), n
    return scatter(xscan_main(op, a, init))


def xscan_all(op, a: AbstractPData, init, with_total: bool = False):
    """Reference: src/Interfaces.jl:299-307."""
    if with_total:
        b, n = xscan_main(op, a, init, with_total=True)
        return emit(b), n
    return emit(xscan_main(op, a, init))


# ---------------------------------------------------------------------------
# sparse point-to-point exchange
# ---------------------------------------------------------------------------


#: the checksummed-exchange scopes open now (`abft_exchanges`), innermost
#: last: each holds its tolerance override (None: the dtype's default)
_ABFT_SCOPES: list = []


@contextmanager
def abft_exchanges(tol: Optional[float] = None):
    """Checksum every float Table exchange in the dynamic extent of the
    block (the JAX package's ``PA_TPU_ABFT=1`` on the host path): the host
    solvers open it under ``sdc=SDCConfig(abft=True)``. ``tol`` overrides
    `utils.health.abft_tolerance`."""
    _ABFT_SCOPES.append(tol)
    try:
        yield
    finally:
        _ABFT_SCOPES.pop()


def _slab_checksums(data_snd: AbstractPData):
    """Sender-side ABFT checksums: per part, the (sum, abs-sum) of every
    per-neighbour slab about to go on the wire, taken before the fault hook
    so any wire corruption shows at the receiver (collectives.py:193).
    None for non-float or non-Table payloads (plan and count exchanges are
    exact integers). A trailing multi-RHS axis folds into its slot's total;
    row totals come from a cumulative sum, which an empty last slab cannot
    misindex (``np.add.reduceat`` does)."""
    vals = data_snd.part_values()
    if not vals or not isinstance(vals[0], Table):
        return None
    sums = []
    for t in vals:
        data = np.asarray(t.data)
        if data.dtype.kind != "f":
            return None
        ptrs = np.asarray(t.ptrs, dtype=np.int64)
        acc = np.asarray(data, dtype=np.float64)
        if acc.ndim > 1:
            # axis sums, not a reshape: an empty slab has no (0, -1) shape
            tail_axes = tuple(range(1, acc.ndim))
            per_slot = acc.sum(axis=tail_axes)
            per_slot_abs = np.abs(acc).sum(axis=tail_axes)
        else:
            per_slot = acc
            per_slot_abs = np.abs(acc)
        c = np.concatenate([[0.0], np.cumsum(per_slot)])
        ca = np.concatenate([[0.0], np.cumsum(per_slot_abs)])
        sums.append((c[ptrs[1:]] - c[ptrs[:-1]], ca[ptrs[1:]] - ca[ptrs[:-1]]))
    return sums


def _verify_slab_checksums(data_rcv, parts_rcv, parts_snd, sums, tol):
    """Receiver-side verify (collectives.py:232): every received slab's sum
    must match its sender's to ``tol`` relative to the slab's abs-sum;
    raises `SilentCorruptionError` naming receiver, sender and both sums
    (a NaN slab fails the comparison too)."""
    from ..utils.health import SilentCorruptionError

    sent = {}
    for q, nbrs in enumerate(parts_snd.part_values()):
        for i, p in enumerate(np.asarray(nbrs)):
            sent[(q, int(p))] = (sums[q][0][i], sums[q][1][i])
    bad = []
    for p, (buf, nbrs) in enumerate(zip(data_rcv.part_values(), parts_rcv.part_values())):
        if not isinstance(buf, Table):
            continue
        ptrs = np.asarray(buf.ptrs, dtype=np.int64)
        data = np.asarray(buf.data, dtype=np.float64)
        for j, q in enumerate(np.asarray(nbrs)):
            expect, scale = sent.get((int(q), p), (None, None))
            if expect is None:
                continue
            got = float(data[ptrs[j] : ptrs[j + 1]].sum())
            thresh = tol * max(1.0, float(scale))
            if not (abs(got - expect) <= thresh):  # NaN fails <=
                bad.append({"part": int(p), "from_part": int(q), "sent_checksum": float(expect),
                            "received_checksum": got, "threshold": thresh})
    if bad:
        raise SilentCorruptionError(
            f"exchange: ABFT slab checksum mismatch on {len(bad)} received slab(s) (first: part "
            f"{bad[0]['part']} from part {bad[0]['from_part']}): the payload was corrupted between "
            "sender pack and receiver unpack",
            diagnostics={"slabs": bad, "detector": "exchange_checksum"},
        )


def async_exchange_into(
    data_rcv: AbstractPData,
    data_snd: AbstractPData,
    parts_rcv: AbstractPData,
    parts_snd: AbstractPData,
) -> AbstractPData:
    """Non-blocking in-place sparse exchange: per part, one value (or one
    Table row) per neighbor (reference async_exchange!:
    src/Interfaces.jl:349-367 and the Table variant :393-450). Returns a
    PData of Tokens.

    The one choke point of every host exchange, and so the seam of the
    chaos harness (`parallel/faults.py`: corrupted payloads are swapped in
    before the wire copy; a ``drop`` clause makes waiting on the tokens
    raise `ExchangeTimeoutError` naming the missing senders) and of the
    host ABFT (inside `abft_exchanges`: each float slab's checksum is taken
    before the hook and verified at the first wait, raising
    `SilentCorruptionError`). With neither active it is one list test
    each."""
    from .faults import exchange_faults_hook, faults_active

    checksums = _slab_checksums(data_snd) if _ABFT_SCOPES else None
    dropped = None
    if faults_active():
        data_snd, dropped = exchange_faults_hook(data_snd, parts_snd)
    t = data_snd._async_exchange(data_rcv, parts_rcv, parts_snd)
    if checksums is not None:
        from ..utils.health import abft_tolerance

        tol = _ABFT_SCOPES[-1]
        tol = abft_tolerance(np.asarray(get_main_part(data_snd).data).dtype) if tol is None else float(tol)
        done = [False]  # verify once, at the first token waited on

        def _verified(tok: Token):
            def _wait():
                tok.wait()
                if not done[0]:
                    done[0] = True
                    _verify_slab_checksums(data_rcv, parts_rcv, parts_snd, checksums, tol)

            return Token(wait_fn=_wait)

        t = map_parts(_verified, t)
    if dropped:
        from ..utils.health import ExchangeTimeoutError

        def _timeout(tok: Token):
            def _wait():
                tok.wait()
                raise ExchangeTimeoutError(
                    f"exchange deadline expired: no contribution from part(s) {dropped} (injected drop); "
                    "received buffers are in an unspecified partial state",
                    diagnostics={"missing_parts": list(dropped), "injected": True},
                )

            return Token(wait_fn=_wait)

        t = map_parts(_timeout, t)
    return t


def exchange_into(data_rcv, data_snd, parts_rcv, parts_snd) -> AbstractPData:
    """Blocking wrapper (reference exchange!: src/Interfaces.jl:453-458)."""
    t = async_exchange_into(data_rcv, data_snd, parts_rcv, parts_snd)
    schedule_and_wait(t)
    return data_rcv


def async_exchange(
    data_snd: AbstractPData,
    parts_rcv: AbstractPData,
    parts_snd: AbstractPData,
) -> Tuple[AbstractPData, AbstractPData]:
    """Allocating variant (reference: src/Interfaces.jl:377-390; Table
    2-phase protocol :404-450): allocates `data_rcv`, for Table payloads by
    first exchanging per-neighbor counts."""
    payload_is_table = isinstance(get_main_part(data_snd), Table)
    if payload_is_table:
        counts_snd = map_parts(lambda t: t.counts().astype(np.int64), data_snd)
        counts_rcv = map_parts(
            lambda pr: np.zeros(len(np.asarray(pr)), dtype=np.int64), parts_rcv
        )
        t = async_exchange_into(counts_rcv, counts_snd, parts_rcv, parts_snd)
        schedule_and_wait(t)
        dtype = get_main_part(data_snd).data.dtype
        # a part with NO senders must still allocate in the exchange
        # dtype — Table.from_rows([]) would default to f64 and poison
        # downstream concatenations (an f32 COO migration used to come
        # back f64 on such parts)
        data_rcv = map_parts(
            lambda c: (
                Table.from_rows([np.zeros(int(k), dtype=dtype) for k in c])
                if len(c)
                else Table.empty(dtype)
            ),
            counts_rcv,
        )
    else:
        # The payload dtype is a global property of the exchange: a part with
        # an empty snd list may still receive, so resolve the dtype across
        # all parts (host metadata in both backends).
        dtypes = [
            np.asarray(d).dtype for d in data_snd.part_values() if np.asarray(d).size
        ]
        dtype = np.result_type(*dtypes) if dtypes else np.float64
        data_rcv = map_parts(
            lambda pr: np.zeros(len(np.asarray(pr)), dtype=dtype), parts_rcv
        )
    t = async_exchange_into(data_rcv, data_snd, parts_rcv, parts_snd)
    return data_rcv, t


def exchange(data_snd, parts_rcv, parts_snd) -> AbstractPData:
    """Blocking allocating wrapper (reference: src/Interfaces.jl:460-466)."""
    data_rcv, t = async_exchange(data_snd, parts_rcv, parts_snd)
    schedule_and_wait(t)
    return data_rcv


# ---------------------------------------------------------------------------
# neighbor discovery
# ---------------------------------------------------------------------------

#: the reference's runtime scalability guard (ERROR_DISCOVER_PARTS_SND,
#: src/Interfaces.jl:498-512; collectives.py:418-421 of the JAX package):
#: when its one entry is True, `discover_parts_snd`'s gather-everything
#: fallback raises. The keyword ``error_discover_parts_snd`` of
#: `discover_parts_snd` sets it for one call.
ERROR_DISCOVER_PARTS_SND = [False]


def discover_parts_snd(
    parts_rcv: AbstractPData, neighbors: Optional[AbstractPData] = None,
    error_discover_parts_snd: Optional[bool] = None,
) -> AbstractPData:
    """Compute who-must-I-send-to from who-do-I-receive-from.

    Scalable path (reference: src/Interfaces.jl:471-496): given a symmetric
    superset neighbor graph, exchange one flag per neighbor edge. Fallback
    (reference: :515-552): gather all rcv lists on MAIN, transpose, scatter —
    O(P^2) metadata on MAIN, refused (RuntimeError) when
    ``error_discover_parts_snd`` is True, or, with None, when the module's
    `ERROR_DISCOVER_PARTS_SND` is set.
    """
    if neighbors is not None:
        def _flags(nbors, rcv):
            nbors = np.asarray(nbors)
            rcv_set = set(int(q) for q in np.asarray(rcv))
            return np.array([1 if int(q) in rcv_set else 0 for q in nbors], dtype=np.int8)

        flags_snd = map_parts(_flags, neighbors, parts_rcv)
        flags_rcv = exchange(flags_snd, neighbors, neighbors)

        def _select(nbors, fl):
            nbors = np.asarray(nbors)
            fl = np.asarray(fl)
            return nbors[fl != 0].astype(np.int32)

        return map_parts(_select, neighbors, flags_rcv)

    guard = ERROR_DISCOVER_PARTS_SND[0] if error_discover_parts_snd is None else error_discover_parts_snd
    if guard:
        raise RuntimeError(
            "discover_parts_snd called without a neighbor superset while ERROR_DISCOVER_PARTS_SND is set: "
            "the all-gather fallback does not scale; provide `neighbors` at PRange/Exchanger build time"
        )

    nparts = parts_rcv.num_parts
    g = gather(map_parts(lambda r: np.asarray(r, dtype=np.int32), parts_rcv))

    def _transpose(rcv_table):
        if len(rcv_table) == 0:
            return Table.empty(np.int32)
        snd_lists = [[] for _ in range(nparts)]
        for p in range(nparts):
            for q in rcv_table[p]:
                snd_lists[int(q)].append(p)
        return Table.from_rows([np.asarray(l, dtype=np.int32) for l in snd_lists])

    table_main = map_parts(
        lambda t: _transpose(t) if isinstance(t, Table) else Table.empty(np.int32), g
    )
    return scatter(table_main)
