"""Sequential backend: all N parts in one process, executed one after another.

The port's copy of `partitionedarrays_jl_tpu/parallel/sequential.py`, the
reference's SequentialBackend
(reference: src/SequentialBackend.jl:1-200). This is a first-class product
feature, not a mock: it is the development/debugging oracle with arbitrary
part counts, and the oracle the GPU backend is checked against.

Values are host objects (NumPy arrays, scalars, index sets...). The GPU
backend inherits these planning collectives unchanged.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

from ..utils.helpers import check, checks_enabled
from ..utils.table import Table
from .backends import (
    MAIN,
    AbstractBackend,
    AbstractPData,
    PartShape,
    Token,
    _as_shape,
)


class SequentialBackend(AbstractBackend):
    def get_part_ids(self, nparts: PartShape) -> "SequentialData":
        shape = _as_shape(nparts)
        n = math.prod(shape)
        return SequentialData(list(range(n)), shape)

    def __repr__(self):
        return "SequentialBackend()"


#: Singleton, mirroring the reference's `sequential` (src/SequentialBackend.jl:4)
sequential = SequentialBackend()


class SequentialData(AbstractPData):
    """`parts`: one host value per part, linear C-order over the part grid.

    Reference: src/SequentialBackend.jl:20-58 (`SequentialData`, `map_parts`).
    """

    __slots__ = ("parts", "_shape")

    def __init__(self, parts: list, shape: Tuple[int, ...] = None):
        self.parts = list(parts)
        self._shape = _as_shape(shape if shape is not None else len(self.parts))
        check(math.prod(self._shape) == len(self.parts), "shape/parts mismatch")

    @property
    def backend(self) -> AbstractBackend:
        return sequential

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    def _like(self, parts: list) -> "SequentialData":
        """Same-type, same-grid PData over new values (subclass hook so
        derived backends keep their identity through map_parts/collectives)."""
        return SequentialData(parts, self._shape)

    def map_parts(self, task: Callable, *args) -> "SequentialData":
        n = self.num_parts
        cols = []
        for a in args:
            if isinstance(a, AbstractPData):
                check(a.num_parts == n, "map_parts: mismatched part counts")
                cols.append(a.part_values())
            else:
                cols.append([a] * n)
        out = [task(*vals) for vals in zip(*cols)]
        return self._like(out)

    def get_part(self, part: int = None):
        if part is None:
            # Reference parity (src/SequentialBackend.jl:30-36): there is no
            # single "local" part when one process holds them all.
            check(self.num_parts == 1, "get_part(a) without a part id is only defined for 1 part")
            return self.parts[0]
        return self.parts[part]

    def i_am_main(self) -> bool:
        # The single process holds MAIN (reference: src/SequentialBackend.jl:26)
        return True

    def part_values(self) -> list:
        return self.parts

    def __repr__(self):
        body = ", ".join(f"{i}: {v!r}" for i, v in enumerate(self.parts[:4]))
        suffix = ", ..." if self.num_parts > 4 else ""
        return f"SequentialData({self.num_parts} parts; {body}{suffix})"

    # ------------------------------------------------------------------
    # Backend-abstract collective primitives (consumed by collectives.py).
    # Reference: src/SequentialBackend.jl:73-124.
    # ------------------------------------------------------------------

    def _gather(self, to_all: bool = False) -> "SequentialData":
        vals = self.parts
        if _is_vector_payload(vals):
            full = Table.from_rows([np.asarray(v) for v in vals])
            empty = Table.empty(full.data.dtype)
        else:
            full = np.asarray(vals)
            empty = full[:0]
        if to_all:
            return self._like([_copy_payload(full) for _ in range(self.num_parts)])
        return self._like([full if p == MAIN else _copy_payload(empty) for p in range(self.num_parts)])

    def _scatter(self) -> "SequentialData":
        n = self.num_parts
        src = self.parts[MAIN]
        if isinstance(src, Table):
            check(len(src) == n, "scatter: MAIN must hold one row per part")
            out = [src[p].copy() for p in range(n)]
        else:
            src = np.asarray(src)
            check(len(src) == n, "scatter: MAIN must hold one entry per part")
            out = [src[p] for p in range(n)]
        return self._like(out)

    def _emit(self) -> "SequentialData":
        n = self.num_parts
        src = self.parts[MAIN]
        return self._like([_copy_payload(src) for _ in range(n)])

    def _async_exchange(
        self,
        data_rcv: "SequentialData",
        parts_rcv: "SequentialData",
        parts_snd: "SequentialData",
    ) -> "SequentialData":
        """Sparse point-to-point exchange; `self` is data_snd.

        Per part p, entry j of data_snd goes to part q = parts_snd[p][j],
        landing at the position i where parts_rcv[q][i] == p
        (reference: src/SequentialBackend.jl:126-200). Values may be scalars
        per neighbor (NumPy 1-D) or Tables (one row per neighbor).
        """
        if checks_enabled():
            _check_rcv_and_snd_match(parts_rcv, parts_snd)
        n = self.num_parts
        for p in range(n):
            snd_ids = np.asarray(parts_snd.parts[p])
            payload = self.parts[p]
            for j, q in enumerate(snd_ids):
                q = int(q)
                rcv_ids = np.asarray(parts_rcv.parts[q])
                hits = np.nonzero(rcv_ids == p)[0]
                check(len(hits) == 1, "exchange: snd/rcv neighbor graphs inconsistent")
                i = int(hits[0])
                dst = data_rcv.parts[q]
                if isinstance(payload, Table):
                    row = payload[j]
                    drow = dst[i]
                    check(len(drow) == len(row), "exchange: row size mismatch")
                    drow[:] = row
                else:
                    dst[i] = payload[j]
        return self._like([Token() for _ in range(n)])


def _is_vector_payload(vals) -> bool:
    v = vals[MAIN]
    return (isinstance(v, np.ndarray) and v.ndim >= 1) or isinstance(v, (list, Table))


def _copy_payload(v):
    if isinstance(v, Table):
        return Table(v.data.copy(), v.ptrs.copy())
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def _check_rcv_and_snd_match(parts_rcv: SequentialData, parts_snd: SequentialData):
    """Debug net: rcv and snd neighbor graphs must be mutually consistent
    (reference: src/SequentialBackend.jl:140,154-165)."""
    n = parts_rcv.num_parts
    edges_rcv = {(int(q), p) for p in range(n) for q in np.asarray(parts_rcv.parts[p])}
    edges_snd = {(p, int(q)) for p in range(n) for q in np.asarray(parts_snd.parts[p])}
    check(edges_rcv == edges_snd, "exchange: snd/rcv graphs are not transposes of each other")
