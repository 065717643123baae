"""PVector: the distributed vector (L5).

The port's copy of `partitionedarrays_jl_tpu/parallel/pvector.py`
(reference: src/Interfaces.jl:1576-2106): per-part host storage (`values`,
one array per part, length = that part's num_lids) keyed by a
`rows::PRange`. Owned and ghost entries are slices of the local array
(owned-first layout) or index views in the general case.

* no global random access — scalar indexing is deliberately refused;
* elementwise algebra touches ghosts only when both operands share the
  same partition, otherwise ghosts of the result are zeros;
* reductions run over **owned** entries only, folded across parts in
  fixed part order;
* `exchange` = owner->ghost halo update.

The card's form of a PVector is `parallel/gpu.py:DeviceVector`.
"""
from __future__ import annotations

import operator
from typing import Callable

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

    def copy(self) -> "PVector":
        vals = map_parts(lambda v: np.array(v, copy=True), self.values)
        return PVector(vals, self.rows)

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

    def __truediv__(self, a):
        check(np.isscalar(a), "PVector / non-scalar")
        return self.map_values(lambda v: v / a)

    def map_values(self, f: Callable) -> "PVector":
        return PVector(map_parts(lambda v: np.asarray(f(v)), self.values), self.rows)

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

    def __repr__(self):
        return (
            f"PVector(ngids={self.rows.ngids}, nparts={self.rows.num_parts}, "
            f"dtype={self.dtype})"
        )


def _write_owned(iset: AbstractIndexSet, vals: np.ndarray, new_owned) -> np.ndarray:
    """Write `new_owned` into the owned entries of `vals`, in place — the
    single write-branch for both lid layouts (slice when owned-first,
    indexed assignment otherwise)."""
    if iset.owned_first:
        vals[: iset.num_oids] = new_owned
    else:
        vals[iset.oid_to_lid] = new_owned
    return vals


def _parts_of(a: AbstractPData):
    from .backends import get_part_ids

    return get_part_ids(a)
