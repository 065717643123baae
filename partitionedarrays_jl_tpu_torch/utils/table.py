"""Ragged (CSR-style) storage: the central metadata structure.

The port's own copy of `partitionedarrays_jl_tpu/utils/table.py` (the
reference's `Table`, src/Helpers.jl:63-156). Everything here is host-side
NumPy and 0-based: a `Table` is a flat ``data`` array plus a ``ptrs`` array
of length ``n+1`` with ``ptrs[0] == 0``; row ``i`` is
``data[ptrs[i]:ptrs[i+1]]``.

Tables describe all variable-length communication metadata (who-talks-to-whom
lists, halo id lists, COO triplet batches). On the card they appear only as
padded index tensors built by `parallel/gpu.py` — a Table itself never
crosses the host/device boundary.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .helpers import check

INDEX_DTYPE = np.int32


def length_to_ptrs(counts: np.ndarray) -> np.ndarray:
    """Row lengths -> 0-based ptrs array of length ``len(counts)+1``.

    Reference: src/Helpers.jl:116-123 (`length_to_ptrs!`), reshaped for
    0-based indexing: returns a fresh array instead of shifting in place.
    """
    counts = np.asarray(counts)
    ptrs = np.zeros(len(counts) + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=ptrs[1:])
    return ptrs


#: the reference's export name (the "!" dropped: 0-based ptrs need no shift)
counts_to_ptrs = length_to_ptrs


def rewind_ptrs(ptrs: np.ndarray) -> np.ndarray:
    """Undo one round of fill-advancing, in place: ``ptrs[i+1] = ptrs[i]``,
    ``ptrs[0] = 0`` (reference: src/Helpers.jl:148-156)."""
    ptrs[1:] = ptrs[:-1]
    ptrs[0] = 0
    return ptrs


def ptrs_to_counts(ptrs: np.ndarray) -> np.ndarray:
    """Inverse of :func:`length_to_ptrs`. Reference: src/Helpers.jl:139-146."""
    return np.diff(ptrs).astype(INDEX_DTYPE)


def generate_data_and_ptrs(rows: Sequence[np.ndarray]):
    """Flatten a list of variable-length rows into (data, ptrs).

    Reference: src/Helpers.jl:96-114.
    """
    rows = [np.asarray(r) for r in rows]
    counts = np.fromiter((len(r) for r in rows), dtype=INDEX_DTYPE, count=len(rows))
    ptrs = length_to_ptrs(counts)
    if int(ptrs[-1]) == 0:
        dtype = rows[0].dtype if rows else np.float64
        data = np.empty(0, dtype=dtype)
    else:
        data = np.concatenate([r for r in rows if len(r)])
    return data, ptrs


class Table:
    """CSR-style ragged array of rows; ``table[i]`` is a zero-copy row view.

    Reference: src/Helpers.jl:63-94 (`Table`, `get_data`, `get_ptrs`). The
    reference's ``getindex`` materializes a copy; here rows are NumPy views
    (cheaper, and all consumers treat them as read-mostly).
    """

    __slots__ = ("data", "ptrs")

    def __init__(self, data: np.ndarray, ptrs: np.ndarray):
        data = np.asarray(data)
        ptrs = np.asarray(ptrs, dtype=INDEX_DTYPE)
        check(ptrs.ndim == 1 and len(ptrs) >= 1 and ptrs[0] == 0, "bad ptrs")
        check(len(data) >= ptrs[-1], "data shorter than ptrs[-1]")
        self.data = data
        self.ptrs = ptrs

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence]) -> "Table":
        data, ptrs = generate_data_and_ptrs(list(rows))
        return cls(data, ptrs)

    @classmethod
    def empty(cls, dtype=np.float64) -> "Table":
        return cls(np.empty(0, dtype=dtype), np.zeros(1, dtype=INDEX_DTYPE))

    def __len__(self) -> int:
        return len(self.ptrs) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.data[self.ptrs[i] : self.ptrs[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def counts(self) -> np.ndarray:
        return ptrs_to_counts(self.ptrs)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Table):
            return NotImplemented
        return (
            np.array_equal(self.ptrs, other.ptrs)
            and np.array_equal(self.data[: self.ptrs[-1]], other.data[: other.ptrs[-1]])
        )

    def __repr__(self) -> str:
        rows = ", ".join(repr(list(self[i])) for i in range(min(len(self), 8)))
        suffix = ", ..." if len(self) > 8 else ""
        return f"Table([{rows}{suffix}])"


def get_data(t: Table) -> np.ndarray:
    """Reference export parity: src/Helpers.jl:70."""
    return t.data


def get_ptrs(t: Table) -> np.ndarray:
    """Reference export parity: src/Helpers.jl:71."""
    return t.ptrs


def empty_table(dtype=np.float64) -> Table:
    return Table.empty(dtype)
