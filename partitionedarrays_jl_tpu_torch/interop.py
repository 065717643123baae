"""Carrying partitioned state across from plain NumPy arrays.

Builds the port's `PRange` / `PVector` / `PSparseMatrix` from per-part
arrays, so an operator and vectors made elsewhere (for example by the JAX
package, exported to NumPy) can be computed on here. Nothing of another
package is imported: the inputs are plain arrays.

* index sets: per part ``lid_to_gid`` and ``lid_to_part`` (owned-first
  lids), or the owned box ``(lo, hi)`` of a Cartesian grid plus the ghost
  tail, which keeps owned lookups arithmetic;
* matrices: per part local CSR ``(indptr, indices, data, shape)`` over
  (row lids x col lids);
* vectors: per part values over the lids.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .parallel.backends import AbstractPData, map_parts
from .parallel.index_sets import CartesianIndexSet, IndexSet
from .parallel.prange import PRange
from .parallel.psparse import PSparseMatrix
from .parallel.pvector import PVector
from .ops.sparse import CSRMatrix
from .utils.helpers import check


def prange_from_arrays(
    parts: AbstractPData,
    ngids: int,
    lid_to_gid: Sequence[np.ndarray],
    lid_to_part: Sequence[np.ndarray],
    grid_shape: Optional[Sequence[int]] = None,
    boxes: Optional[Sequence[tuple]] = None,
) -> PRange:
    """A PRange over `parts` from per-part lid maps. With `grid_shape` and
    per-part owned ``boxes`` ``(lo, hi)``, each part gets a Cartesian index
    set (its owned lids must be the box in C order)."""
    n = parts.num_parts
    check(len(lid_to_gid) == len(lid_to_part) == n, "one lid map per part")

    def _mk(p):
        g = np.asarray(lid_to_gid[p], dtype=np.int64)
        o = np.asarray(lid_to_part[p], dtype=np.int32)
        if boxes is None:
            return IndexSet(p, g, o)
        lo, hi = boxes[p]
        return CartesianIndexSet(p, grid_shape, lo, hi, g, o)

    partition = map_parts(_mk, parts)
    ghost = any(s.num_hids for s in partition.part_values())
    return PRange(int(ngids), partition, ghost=ghost)


def psparse_from_csr(rows: PRange, cols: PRange, csr: Sequence[tuple]) -> PSparseMatrix:
    """A PSparseMatrix from per-part local CSR ``(indptr, indices, data,
    shape)`` over (rows lids x cols lids)."""
    check(len(csr) == rows.num_parts, "one local CSR per part")
    values = rows.partition._like(
        [CSRMatrix(*(np.asarray(a) for a in c[:3]), c[3]) for c in csr]
    )
    return PSparseMatrix(values, rows, cols)


def pvector_from_values(rows: PRange, values: Sequence[np.ndarray]) -> PVector:
    """A PVector over `rows` from per-part values over the lids."""
    check(len(values) == rows.num_parts, "one value array per part")
    vals = rows.partition._like([np.array(v, copy=True) for v in values])
    return PVector(vals, rows)
