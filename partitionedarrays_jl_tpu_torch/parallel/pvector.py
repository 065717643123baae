"""PVector: the distributed vector (L5).

The port's copy of `partitionedarrays_jl_tpu/parallel/pvector.py`
(reference: src/Interfaces.jl:1576-2106): per-part host storage (`values`,
one array per part, length = that part's num_lids) keyed by a
`rows::PRange`. Owned and ghost entries are slices of the local array
(owned-first layout) or index views in the general case.

* no global random access — scalar indexing is deliberately refused;
* elementwise algebra touches ghosts only when both operands share the
  same partition, otherwise ghosts of the result are zeros;
* reductions (`dot`, `norm`, `sum`, ...) run over **owned** entries only,
  folded across parts in fixed part order;
* `exchange` = owner->ghost halo update; `assemble` = ghost->owner
  combine-and-zero (reference: src/Interfaces.jl:2071-2106);
* `local_view` / `global_view` re-index a part's values by another
  range's lids or by gids, and the distances (`euclidean`, ...) reduce
  owned partials across parts (pvector.py:400-557 of the JAX package).

The card's form of a PVector is `parallel/gpu.py:DeviceVector`.
"""
from __future__ import annotations

import operator
from typing import Callable, Optional

import numpy as np

from ..utils.helpers import check, pairwise_sum
from .backends import AbstractPData, Token, map_parts
from .collectives import preduce
from .exchanger import async_exchange_values
from .index_sets import AbstractIndexSet
from .prange import PRange, add_gids_inplace, oids_are_equal, to_lids, uniform_partition


def _owned(iset: AbstractIndexSet, vals: np.ndarray) -> np.ndarray:
    """Owned entries; a zero-copy slice under owned-first layout."""
    return vals[: iset.num_oids] if iset.owned_first else vals[iset.oid_to_lid]


def _ghost(iset: AbstractIndexSet, vals: np.ndarray) -> np.ndarray:
    return vals[iset.num_oids :] if iset.owned_first else vals[iset.hid_to_lid]


class PVector:
    __slots__ = ("values", "rows")

    def __init__(self, values: AbstractPData, rows: PRange):
        self.values = values
        self.rows = rows

    # ------------------------------------------------------------------
    # constructors (reference: src/Interfaces.jl:1869-1932)
    # ------------------------------------------------------------------

    @classmethod
    def undef(cls, rows: PRange, dtype=np.float64) -> "PVector":
        vals = map_parts(lambda i: np.empty(i.num_lids, dtype=dtype), rows.partition)
        return cls(vals, rows)

    @classmethod
    def full(cls, value, rows: PRange, dtype=None) -> "PVector":
        dtype = dtype or np.asarray(value).dtype
        vals = map_parts(
            lambda i: np.full(i.num_lids, value, dtype=dtype), rows.partition
        )
        return cls(vals, rows)

    @classmethod
    def from_coo(
        cls,
        I: AbstractPData,
        V: AbstractPData,
        rows,
        ids: str = "global",
        combine=np.add,
        dtype=None,
    ) -> "PVector":
        """COO-style build: duplicate indices are combine-accumulated
        (default +). With ``ids='global'`` the id arrays are renumbered to
        lids **in place**; with an integer `rows`, builds a uniform PRange
        and adds the off-part gids as ghosts first
        (reference: src/Interfaces.jl:1887-1932)."""
        check(ids in ("global", "local"), "ids must be 'global' or 'local'")
        if isinstance(rows, (int, np.integer)):
            check(ids == "global", "building rows from n requires global ids")
            parts = _parts_of(I)
            rows = uniform_partition(parts, int(rows))
            add_gids_inplace(rows, I)
        if ids == "global":
            to_lids(rows, I)
        if dtype is None:
            dtype = np.asarray(V.part_values()[0]).dtype

        def _fill(iset, lids, vals):
            out = np.zeros(iset.num_lids, dtype=dtype)
            combine.at(out, np.asarray(lids, dtype=np.int64), np.asarray(vals))
            return out

        values = map_parts(_fill, rows.partition, I, V)
        return cls(values, rows)

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------

    @property
    def owned_values(self) -> AbstractPData:
        """Reference: src/Interfaces.jl:1589-1597."""
        return map_parts(_owned, self.rows.partition, self.values)

    @property
    def ghost_values(self) -> AbstractPData:
        """Reference: src/Interfaces.jl:1599-1605."""
        return map_parts(_ghost, self.rows.partition, self.values)

    @property
    def dtype(self):
        return np.asarray(self.values.part_values()[0]).dtype

    def __len__(self) -> int:
        return self.rows.ngids

    def __getitem__(self, gid):
        # Reference parity: src/Interfaces.jl:1610-1613 — a distributed
        # vector has no cheap random access; use local_view/global_view.
        raise NotImplementedError(
            "scalar indexing of a PVector is deliberately not implemented; "
            "use owned_values / local_view / global_view"
        )

    def similar(self, dtype=None) -> "PVector":
        return PVector.undef(self.rows, dtype or self.dtype)

    def copy(self) -> "PVector":
        vals = map_parts(lambda v: np.array(v, copy=True), self.values)
        return PVector(vals, self.rows)

    def copy_into(self, dest: "PVector") -> "PVector":
        """Axis-aware copy: full when partitions coincide, owned-only when
        they differ (reference: src/Interfaces.jl:1615-1673)."""
        if dest.rows is self.rows:
            map_parts(lambda d, s: _assign_full(d, s), dest.values, self.values)
        else:
            check(oids_are_equal(dest.rows, self.rows), "copy: incompatible rows")
            map_parts(
                lambda di, d, si, s: _assign_owned(di, d, si, s),
                dest.rows.partition,
                dest.values,
                self.rows.partition,
                self.values,
            )
        return dest

    # ------------------------------------------------------------------
    # elementwise algebra (reference broadcasting + arithmetic,
    # src/Interfaces.jl:1688-1765, :1934-1964)
    # ------------------------------------------------------------------

    def zip_map(self, f: Callable, *others: "PVector") -> "PVector":
        """Apply f elementwise. Ghost entries are computed only when all
        operands share this vector's partition; otherwise they are zeros."""
        same = all(o.rows is self.rows for o in others)
        if same:
            vals = map_parts(
                lambda *vs: np.asarray(f(*vs)), self.values, *[o.values for o in others]
            )
        else:
            for o in others:
                check(oids_are_equal(self.rows, o.rows), "zip_map: incompatible rows")

            def _owned_op(iset, v, *pairs):
                out = np.zeros(iset.num_lids, dtype=np.result_type(v, *pairs[1::2]))
                args = [_owned(iset, v)] + [
                    _owned(oi, ov) for oi, ov in zip(pairs[0::2], pairs[1::2])
                ]
                return _write_owned(iset, out, f(*args))

            flat = []
            for o in others:
                flat += [o.rows.partition, o.values]
            vals = map_parts(_owned_op, self.rows.partition, self.values, *flat)
        return PVector(vals, self.rows)

    def zip_map_into(self, f: Callable, *others: "PVector") -> "PVector":
        """In-place variant writing into self (full local arrays)."""
        for o in others:
            check(o.rows is self.rows, "zip_map_into requires identical rows")
        map_parts(
            lambda v, *vs: _assign_full(v, f(v, *vs)),
            self.values,
            *[o.values for o in others],
        )
        return self

    def __add__(self, other):
        return self.zip_map(operator.add, other)

    def __sub__(self, other):
        return self.zip_map(operator.sub, other)

    def __neg__(self):
        return self.map_values(operator.neg)

    def __pos__(self):
        return self

    def __mul__(self, a):
        check(np.isscalar(a), "PVector * non-scalar")
        return self.map_values(lambda v: v * a)

    __rmul__ = __mul__

    def scale(self, a) -> "PVector":
        """In-place scalar scaling (the `rmul!` analog)."""
        check(np.isscalar(a), "PVector.scale needs a scalar")
        for v in self.values.part_values():
            np.multiply(v, a, out=v)
        return self

    def __truediv__(self, a):
        check(np.isscalar(a), "PVector / non-scalar")
        return self.map_values(lambda v: v / a)

    def map_values(self, f: Callable) -> "PVector":
        return PVector(map_parts(lambda v: np.asarray(f(v)), self.values), self.rows)

    def axpy(self, alpha, x: "PVector") -> "PVector":
        """self += alpha * x (in place, full local arrays)."""
        return self.zip_map_into(lambda v, xv: v + alpha * xv, x)

    def fill(self, value) -> "PVector":
        map_parts(lambda v: _assign_full(v, value), self.values)
        return self

    # ------------------------------------------------------------------
    # reductions (owned-only, deterministic part-order fold)
    # ------------------------------------------------------------------

    def dot(self, other: "PVector", strict: bool = False):
        """Reference: src/Interfaces.jl:1985-1992. With ``strict``
        (pvector.py:240-256 of the JAX package) each part's partial is the
        fixed-tree `pairwise_sum` of the products, which the card's strict
        dot reproduces bit for bit (np.dot's BLAS order is unspecified);
        the parts fold left to right either way."""
        if strict:
            part_dot = lambda i, a, oi, b: pairwise_sum(_owned(i, a) * _owned(oi, b))  # noqa: E731
        else:
            part_dot = lambda i, a, oi, b: np.dot(_owned(i, a), _owned(oi, b))  # noqa: E731
        partials = map_parts(
            part_dot,
            self.rows.partition,
            self.values,
            other.rows.partition,
            other.values,
        )
        return preduce(operator.add, partials, 0.0)

    def norm(self, p=2):
        """Owned-only p-norm (reference: src/Interfaces.jl:1767-1772)."""
        if p == 2:
            return np.sqrt(self.dot(self))
        partials = map_parts(
            lambda i, a: np.sum(np.abs(_owned(i, a)) ** p),
            self.rows.partition,
            self.values,
        )
        return preduce(operator.add, partials, 0.0) ** (1.0 / p)

    def sum(self):
        partials = map_parts(
            lambda i, a: np.sum(_owned(i, a)), self.rows.partition, self.values
        )
        return preduce(operator.add, partials, 0.0)

    def reduce_owned(self, f_local: Callable, f_across: Callable, init):
        partials = map_parts(
            lambda i, a: f_local(_owned(i, a)), self.rows.partition, self.values
        )
        return preduce(f_across, partials, init)

    def maximum(self, f: Callable = None):
        g = (lambda v: np.max(f(v)) if len(v) else -np.inf) if f else (
            lambda v: np.max(v) if len(v) else -np.inf
        )
        return self.reduce_owned(g, max, -np.inf)

    def minimum(self, f: Callable = None):
        g = (lambda v: np.min(f(v)) if len(v) else np.inf) if f else (
            lambda v: np.min(v) if len(v) else np.inf
        )
        return self.reduce_owned(g, min, np.inf)

    def any(self, f: Callable):
        return bool(
            self.reduce_owned(lambda v: bool(np.any(f(v))), operator.or_, False)
        )

    def all(self, f: Callable):
        return bool(
            self.reduce_owned(lambda v: bool(np.all(f(v))), operator.and_, True)
        )

    __hash__ = object.__hash__  # __eq__ is a value check; hash by identity

    def __eq__(self, other):
        if not isinstance(other, PVector):
            return NotImplemented
        if not oids_are_equal(self.rows, other.rows):
            return False
        flags = map_parts(
            lambda i, a, oi, b: bool(np.array_equal(_owned(i, a), _owned(oi, b))),
            self.rows.partition,
            self.values,
            other.rows.partition,
            other.values,
        )
        return bool(preduce(operator.and_, flags, True))

    # ------------------------------------------------------------------
    # halo update / assembly (reference: src/Interfaces.jl:2071-2106)
    # ------------------------------------------------------------------

    def async_exchange(self) -> Token:
        """Owner -> ghost halo update through rows.exchanger."""
        return async_exchange_values(self.values, self.values, self.rows.exchanger)

    def exchange(self) -> "PVector":
        self.async_exchange().wait()
        return self

    def async_assemble(self, combine_op=np.add) -> Token:
        """Ghost contributions sent to owners and combined (default +),
        then local ghost entries zeroed."""
        inner = async_exchange_values(
            self.values, self.values, self.rows.exchanger.reverse(), combine_op
        )

        def _finish():
            inner.wait()
            map_parts(_zero_ghosts, self.rows.partition, self.values)
            return self.values

        return Token(wait_fn=_finish)

    def assemble(self, combine_op=np.add) -> "PVector":
        self.async_assemble(combine_op).wait()
        return self

    def __repr__(self):
        return (
            f"PVector(ngids={self.rows.ngids}, nparts={self.rows.num_parts}, "
            f"dtype={self.dtype})"
        )


def _assign_full(dest: np.ndarray, src) -> np.ndarray:
    dest[...] = src
    return dest


def _write_owned(iset: AbstractIndexSet, vals: np.ndarray, new_owned) -> np.ndarray:
    """Write `new_owned` into the owned entries of `vals`, in place — the
    single write-branch for both lid layouts (slice when owned-first,
    indexed assignment otherwise)."""
    if iset.owned_first:
        vals[: iset.num_oids] = new_owned
    else:
        vals[iset.oid_to_lid] = new_owned
    return vals


def _assign_owned(di, d, si, s):
    return _write_owned(di, d, _owned(si, s))


def _zero_ghosts(iset: AbstractIndexSet, vals: np.ndarray):
    if iset.owned_first:
        vals[iset.num_oids :] = 0
    else:
        vals[iset.hid_to_lid] = 0
    return vals


def _parts_of(a: AbstractPData):
    from .backends import get_part_ids

    return get_part_ids(a)


# ---------------------------------------------------------------------------
# views (reference: src/Interfaces.jl:1994-2069)
# ---------------------------------------------------------------------------


class LocalViewPart:
    """One part's data of a PVector re-indexed by *another* PRange's lids.
    Missing entries read as 0; writing a missing entry is a contract error
    (reference LocalView incl. write-guard: src/Interfaces.jl:1994-2035)."""

    __slots__ = ("parent_values", "lid_map")

    def __init__(self, parent_values: np.ndarray, lid_map: np.ndarray):
        self.parent_values = parent_values
        self.lid_map = lid_map  # view lid -> parent lid, -1 if missing

    def __len__(self):
        return len(self.lid_map)

    def __getitem__(self, lids):
        m = self.lid_map[lids]
        vals = np.where(m >= 0, self.parent_values[np.maximum(m, 0)], 0)
        return vals

    def __setitem__(self, lids, v):
        m = self.lid_map[lids]
        check((np.asarray(m) >= 0).all(), "local_view write to an entry not stored in parent")
        self.parent_values[m] = v

    def add_at(self, lids, v):
        m = self.lid_map[lids]
        check((np.asarray(m) >= 0).all(), "local_view write to an entry not stored in parent")
        np.add.at(self.parent_values, m, v)


class GlobalViewPart:
    """One part's data of a PVector indexed directly by global ids
    (reference GlobalView: src/Interfaces.jl:2037-2069)."""

    __slots__ = ("parent_values", "iset")

    def __init__(self, parent_values: np.ndarray, iset: AbstractIndexSet):
        self.parent_values = parent_values
        self.iset = iset

    def __getitem__(self, gids):
        lids = self.iset.gids_to_lids(np.atleast_1d(gids))
        check((lids >= 0).all(), "global_view read of a non-local gid")
        out = self.parent_values[lids]
        return out if np.ndim(gids) else out[0]

    def __setitem__(self, gids, v):
        lids = self.iset.gids_to_lids(np.atleast_1d(gids))
        check((lids >= 0).all(), "global_view write of a non-local gid")
        self.parent_values[lids] = v

    def add_at(self, gids, v):
        lids = self.iset.gids_to_lids(np.atleast_1d(gids))
        check((lids >= 0).all(), "global_view write of a non-local gid")
        np.add.at(self.parent_values, lids, np.asarray(v))


def local_view(v, rows: Optional[PRange] = None, cols: Optional[PRange] = None) -> AbstractPData:
    """PData of per-part LocalViewPart re-indexing v by `rows`' lids.
    For a PSparseMatrix, `local_view(A[, rows, cols])` re-indexes by both
    axes (reference: src/Interfaces.jl:2277-2287)."""
    if not isinstance(v, PVector):
        from .psparse import psparse_local_view

        return psparse_local_view(v, rows, cols)
    check(cols is None, "local_view of a PVector takes no cols axis")
    rows = rows if rows is not None else v.rows

    def _mk(view_iset, parent_iset, vals):
        m = parent_iset.gids_to_lids(view_iset.lid_to_gid)
        return LocalViewPart(vals, m)

    return map_parts(_mk, rows.partition, v.rows.partition, v.values)


def global_view(v, rows: Optional[PRange] = None, cols: Optional[PRange] = None) -> AbstractPData:
    if not isinstance(v, PVector):
        from .psparse import psparse_global_view

        return psparse_global_view(v, rows, cols)
    check(cols is None, "global_view of a PVector takes no cols axis")
    rows = rows or v.rows
    return map_parts(
        lambda i, vals: GlobalViewPart(vals, i), rows.partition, v.values
    )


# ---------------------------------------------------------------------------
# distance metrics (reference L8: Distances.jl metrics on PVector via
# owned-only partial evaluation + cross-part reduce, src/Interfaces.jl:1776-1825)
# ---------------------------------------------------------------------------


def _metric_reduce(a: PVector, b: PVector, local, across, post, init):
    partials = map_parts(
        lambda ai, av, bi, bv: local(_owned(ai, av), _owned(bi, bv)),
        a.rows.partition,
        a.values,
        b.rows.partition,
        b.values,
    )
    return post(preduce(across, partials, init))


def sqeuclidean(a: PVector, b: PVector):
    return _metric_reduce(
        a, b, lambda x, y: float(np.sum((x - y) ** 2)), operator.add, lambda s: s, 0.0
    )


def euclidean(a: PVector, b: PVector):
    return float(np.sqrt(sqeuclidean(a, b)))


def cityblock(a: PVector, b: PVector):
    return _metric_reduce(
        a, b, lambda x, y: float(np.sum(np.abs(x - y))), operator.add, lambda s: s, 0.0
    )


def chebyshev(a: PVector, b: PVector):
    return _metric_reduce(
        a,
        b,
        lambda x, y: float(np.max(np.abs(x - y))) if len(x) else 0.0,
        max,
        lambda s: s,
        0.0,
    )


def minkowski(a: PVector, b: PVector, p: float = 2.0):
    """Order-p Minkowski distance (reference: the generic Distances.jl
    partial-eval + eval_reduce mechanism, src/Interfaces.jl:1776-1825;
    p=1 cityblock, p=2 euclidean)."""
    s = _metric_reduce(
        a,
        b,
        lambda x, y: float(np.sum(np.abs(x - y) ** p)),
        operator.add,
        lambda t: t,
        0.0,
    )
    return float(s ** (1.0 / p))


# free-function parity helpers
def assemble(v: PVector, combine_op=np.add) -> PVector:
    return v.assemble(combine_op)


def async_assemble(v: PVector, combine_op=np.add) -> Token:
    return v.async_assemble(combine_op)


def exchange_pvector(v: PVector) -> PVector:
    return v.exchange()
