"""Local sparse kernels (L6), host side.

The port's copy of `partitionedarrays_jl_tpu/ops/sparse.py` (reference:
src/SparseUtils.jl): the host planning format is **CSR**, compressed and
multiplied by the port's native layer (`native/planning.cpp`) where it is
on, by the NumPy paths below where it is off (`native.ENABLED`); **ELL** (rows padded to a uniform count) is the form the boundary
block A_oh takes on the card, the owned block of the ELL lowering, and the
order of strict mode's host SpMV (`csr_spmv(strict=True)`). The banded
owned block runs as the coded-DIA kernels of `ops/dia.py`, the others as
those of `ops/irregular.py`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .. import native
from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE


class CSRMatrix:
    """Host CSR with sorted, deduplicated column indices per row."""

    __slots__ = ("indptr", "indices", "data", "shape", "_ell", "_keys")

    def __init__(self, indptr, indices, data, shape: Tuple[int, int]):
        self.indptr = np.asarray(indptr, dtype=INDEX_DTYPE)
        self.indices = np.asarray(indices, dtype=INDEX_DTYPE)
        self.data = np.asarray(data)
        self.shape = (int(shape[0]), int(shape[1]))
        self._ell = None  # the ELL form strict csr_spmv folds over, built at first use
        self._keys = None  # row-major entry keys for `nzindex`, built at first use
        check(len(self.indptr) == self.shape[0] + 1, "bad indptr length")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row_of_nz(self) -> np.ndarray:
        """Row index of each stored entry (the CSR 'expand')."""
        return np.repeat(
            np.arange(self.shape[0], dtype=INDEX_DTYPE), self.row_lengths()
        )

    def _sorted_keys(self) -> np.ndarray:
        if self._keys is None:
            self._keys = self.row_of_nz().astype(np.int64) * self.shape[1] + self.indices
        return self._keys

    def __matmul__(self, x: np.ndarray) -> np.ndarray:
        return csr_spmv(self, x)

    def __repr__(self):
        return f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"


def indextype(A: CSRMatrix):
    """Reference export parity (src/SparseUtils.jl:44-49)."""
    return A.indices.dtype


def nzindex(A: CSRMatrix, i, j) -> np.ndarray:
    """Vectorized storage-position query: position k of entry (i, j), or -1
    when not stored (reference: src/SparseUtils.jl:59-62, :90-103, CSR
    :206-214, generalized from scalar to arrays)."""
    i = np.atleast_1d(np.asarray(i, dtype=np.int64))
    j = np.atleast_1d(np.asarray(j, dtype=np.int64))
    keys = A._sorted_keys()
    q = i * A.shape[1] + j
    pos = np.searchsorted(keys, q)
    out = np.full(len(q), -1, dtype=np.int64)
    if len(keys):
        pos_c = np.clip(pos, 0, len(keys) - 1)
        hit = keys[pos_c] == q
        out[hit] = pos_c[hit]
    return out


def nz_triplets(A: CSRMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All stored entries as (I, J, V) arrays, the vectorized analog of the
    reference's `nziterator` (src/SparseUtils.jl:64-69, :105-155)."""
    return A.row_of_nz(), A.indices.copy(), A.data.copy()


def nziterator(A: CSRMatrix):
    """Generator API parity: yields (i, j, v) per stored entry."""
    I, J, V = nz_triplets(A)
    for t in range(len(V)):
        yield int(I[t]), int(J[t]), V[t]


def _fold_groups(V: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The sum of each group ``V[starts[g]:starts[g + 1]]`` folded left to
    right from its first value, each add rounded (Julia's `sparse`, and
    the JAX package's native `coo_to_csr`), vectorised by rank within the
    group: rank r adds into every group longer than r."""
    data = V[starts].copy()
    lens = np.diff(np.append(starts, len(V)))
    live = np.nonzero(lens > 1)[0]
    r = 1
    while live.size:
        data[live] += V[starts[live] + r]
        r += 1
        live = live[lens[live] > r]
    return data


def compresscoo(
    I, J, V, m: int, n: int, combine: Optional[Callable] = None
) -> CSRMatrix:
    """COO triplets -> CSR, accumulating duplicates with `combine`
    (default +), each group folded left to right in input order from its
    first value (the reference's `sparse`; the JAX package's native
    `coo_to_csr`, bit for bit). Vectorized (a stable sort, then the fold
    by rank within a group) rather than the reference's
    `sparse`/`sparsecsr` calls
    (reference: src/SparseUtils.jl:51-57, :80-88, :193-204)."""
    # keep the caller's integer width: int32 lid batches (any local size
    # < 2^31) need no conversion copies
    I = np.asarray(I)
    J = np.asarray(J)
    if I.dtype != np.int32 or J.dtype != np.int32:
        I = np.asarray(I, dtype=np.int64)
        J = np.asarray(J, dtype=np.int64)
    V = np.asarray(V)
    check(len(I) == len(J) == len(V), "COO arrays must have equal length")
    if len(I):
        check(I.min() >= 0 and I.max() < m, "row index out of bounds")
        check(J.min() >= 0 and J.max() < n, "col index out of bounds")
    if combine is None or combine is np.add:
        # the native compression: one counting pass, one scatter and a
        # stable sort a row, each duplicate group folded left to right
        # (sparse.py:103 of the JAX package); the NumPy path below is
        # its plain version, the same bits
        res = native.coo_to_csr(I, J, V, m, n)
        if res is not None:
            indptr, cols, vals = res
            return CSRMatrix(indptr, cols, vals, (m, n))
    if len(I) and I.max() < (2**62) // max(n, 1):
        # single fused key, sorted with NumPy's run-adaptive stable sort:
        # assembled COO batches arrive as concatenated pre-sorted stencil
        # arms, which merge in near-linear time. The key is widened
        # to int64 FIRST: int32 triplets (the planning fast path) would
        # wrap I*n+J at m*n > 2^31 and silently corrupt the merge groups
        keys_full = I.astype(np.int64, copy=False) * n + J
        order = np.argsort(keys_full, kind="stable")
        keys = keys_full[order]
    else:
        order = np.lexsort((J, I))
        keys = None
    I, J, V = I[order], J[order], V[order]
    if len(I):
        if keys is None:
            keys = I.astype(np.int64, copy=False) * n + J
        boundary = np.empty(len(keys), dtype=bool)
        boundary[0] = True
        np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
        if boundary.all():  # no duplicates: compression is the identity
            uI, uJ, data = I, J, V
            starts = None
        else:
            starts = np.nonzero(boundary)[0]
            uI, uJ = I[starts], J[starts]
        if starts is None:
            pass
        elif combine is None or combine is np.add:
            data = _fold_groups(V, starts)
        else:
            # general combine: left-fold within each duplicate group
            data = np.empty(len(starts), dtype=V.dtype)
            ends = np.append(starts[1:], len(V))
            for k, (s, e) in enumerate(zip(starts, ends)):
                acc = V[s]
                for t in range(s + 1, e):
                    acc = combine(acc, V[t])
                data[k] = acc
    else:
        uI = uJ = np.empty(0, dtype=np.int64)
        data = np.empty(0, dtype=V.dtype)
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(uI, minlength=m), out=indptr[1:])
    return CSRMatrix(indptr, uJ.astype(INDEX_DTYPE), data, (m, n))


def csr_spmv(A: CSRMatrix, x: np.ndarray, y: Optional[np.ndarray] = None,
             alpha: float = 1.0, beta: float = 0.0, strict: bool = False) -> np.ndarray:
    """Host CSR SpMV: y = beta*y + alpha*A@x. Deterministic per-row
    accumulation (column-sorted rows + reduceat). With ``strict``
    (sparse.py:191-215 of the JAX package) a row's sum is instead an
    explicit left-to-right fold over its ELL-padded slots, the order of the
    card's E1 kernel (`ops/irregular.ell_spmv`); reduceat's order is a
    NumPy implementation detail no kernel reproduces."""
    check(len(x) >= A.shape[1], "x too short for A")
    xv = np.asarray(x)
    if strict and A.nnz:
        rowsum = _strict_native(A, xv)
        if rowsum is not None:
            if y is None:
                return alpha * rowsum
            y *= beta
            y += alpha * rowsum
            return y
    if strict:
        if A._ell is None:
            A._ell = ELLMatrix.from_csr(A)
        E = A._ell
        if E.vals.shape[1] == 0 or E.vals.shape[0] == 0:
            rowsum = np.zeros(A.shape[0], dtype=A.dtype)
        else:
            # pad slots carry value 0 at column 0: +-0.0 terms, rounding-neutral
            rowsum = E.vals[:, 0] * xv[E.cols[:, 0]]
            for l in range(1, E.vals.shape[1]):
                rowsum = rowsum + E.vals[:, l] * xv[E.cols[:, l]]
    else:
        prod = A.data * xv[A.indices]
        rowsum = np.zeros(A.shape[0], dtype=prod.dtype if prod.size else A.dtype)
        nonempty = A.indptr[:-1] < A.indptr[1:]
        if prod.size:
            rowsum[nonempty] = np.add.reduceat(prod, A.indptr[:-1][nonempty]) if nonempty.any() else prod[:0]
    if y is None:
        return alpha * rowsum
    y *= beta
    y += alpha * rowsum
    return y


def _strict_native(A: CSRMatrix, xv: np.ndarray) -> Optional[np.ndarray]:
    """`csr_spmv(strict=True)`'s row sums by the native fold
    (planning.cpp `csr_spmv_impl`, sparse.py:223 of the JAX package), or
    None where the layer is off or the dtypes differ. The native fold
    starts from 0 and stops at a row's last entry; the ELL fold starts from
    the first product and adds ``0 * x[0]`` for every pad slot. The two
    agree wherever a row's sum is nonzero and x[0] is finite; rows whose
    sum is zero (a signed zero may differ) take the ELL fold, and a
    non-finite x[0] makes every padded row NaN, as the ELL fold does."""
    if xv.dtype != A.data.dtype:
        return None
    rowsum = np.empty(A.shape[0], dtype=A.dtype)
    if not native.csr_spmv(A.indptr, A.indices, A.data, xv, rowsum):
        return None
    lengths = np.diff(A.indptr)
    pad = np.zeros(1, dtype=A.dtype)[0] * xv[0] if len(xv) else A.dtype.type(0)
    if np.isnan(pad):
        rowsum[lengths < lengths.max()] = np.nan
    zero = np.flatnonzero(rowsum == 0)
    if len(zero):
        if A._ell is None:
            A._ell = ELLMatrix.from_csr(A)
        V, C = A._ell.vals[zero], A._ell.cols[zero]
        acc = V[:, 0] * xv[C[:, 0]]
        for l in range(1, V.shape[1]):
            acc = acc + V[:, l] * xv[C[:, l]]
        rowsum[zero] = acc
    return rowsum


class ELLMatrix:
    """Padded-row sparse format: `cols`/`vals` of shape (nrows, L) with
    L = max row nnz; padding has val 0 and col 0. The card's A_oh boundary
    block is staged in this form (parallel/gpu.py)."""

    __slots__ = ("cols", "vals", "shape")

    def __init__(self, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int]):
        self.cols = cols
        self.vals = vals
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_csr(cls, A: CSRMatrix, row_width: Optional[int] = None) -> "ELLMatrix":
        lengths = A.row_lengths()
        L = int(lengths.max()) if len(lengths) else 0
        if row_width is not None:
            check(row_width >= L, "row_width below max row nnz")
            L = int(row_width)
        m = A.shape[0]
        cols = np.zeros((m, L), dtype=INDEX_DTYPE)
        vals = np.zeros((m, L), dtype=A.data.dtype)
        if A.nnz:
            rows = A.row_of_nz()
            offs = (np.arange(A.nnz) - A.indptr[:-1][rows]).astype(INDEX_DTYPE)
            cols[rows, offs] = A.indices
            vals[rows, offs] = A.data
        return cls(cols, vals, A.shape)

    @property
    def row_width(self) -> int:
        return self.vals.shape[1] if self.vals.ndim == 2 else 0

    def spmv(self, x):
        return (self.vals * np.take(x, self.cols, axis=0)).sum(axis=1)

    def __repr__(self):
        return f"ELLMatrix(shape={self.shape}, row_width={self.row_width})"


def csr_block(
    A: CSRMatrix, row_sel: np.ndarray, col_threshold: int, want_upper: bool,
    col_offset: int = 0,
) -> CSRMatrix:
    """Extract the submatrix A[row_sel, cols] where cols are < (or >=)
    `col_threshold`, remapping kept columns by -`col_offset`.

    This realizes the reference's lazy (owned|ghost)x(owned|ghost) block
    views (`SubSparseMatrix`, src/SparseUtils.jl:5-29 and the virtual
    properties of src/Interfaces.jl:2142-2183) by *materializing* cheap CSR
    blocks: with owned-first lid numbering the owned/ghost split is a plain
    column threshold, not a filtered iteration.
    """
    row_sel = np.asarray(row_sel, dtype=INDEX_DTYPE)
    lengths = A.row_lengths()[row_sel]
    starts = A.indptr[:-1][row_sel]
    # gather the selected rows' entries
    idx = _expand_ranges(starts, lengths)
    cols = A.indices[idx]
    vals = A.data[idx]
    rows = np.repeat(np.arange(len(row_sel), dtype=INDEX_DTYPE), lengths)
    keep = (cols >= col_threshold) if want_upper else (cols < col_threshold)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    ncols_new = col_threshold if not want_upper else A.shape[1] - col_threshold
    indptr = np.zeros(len(row_sel) + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(rows, minlength=len(row_sel)), out=indptr[1:])
    return CSRMatrix(
        indptr, (cols - col_offset).astype(INDEX_DTYPE), vals, (len(row_sel), ncols_new)
    )


def _expand_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate arange(s, s+l) for each (s, l) — vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    reps = np.repeat(np.asarray(starts, dtype=np.int64), lengths)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lengths) - lengths, lengths
    )
    return reps + offs
