"""PSparseMatrix: the row-partitioned distributed sparse matrix (L5).

The port's copy of `partitionedarrays_jl_tpu/parallel/psparse.py`
(reference: src/Interfaces.jl:2108-2757): COO construction, the owned/ghost
block split, the host SpMV, the COO assembly migration (`assemble_coo`,
`assemble_matrix_from_coo`) that builds the FE operators, the multigrid
transfers and Galerkin operators, its inverse (`exchange_coo`), the
nonzero-value exchanger of ghost rows (`matrix_exchanger`), the local and
global matrix views and the triplet exports.
Per part: a local CSR over (row lids x col lids) keyed by `rows`/`cols`
PRanges. The host SpMV starts the halo update of b, computes
``c_o = A_oo b_o`` while the exchange is pending, then adds ``A_oh b_h``
(reference: src/Interfaces.jl:2246-2275). `parallel/gpu.py:DeviceMatrix`
is its form on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.sparse import CSRMatrix, compresscoo, csr_block, csr_spmv, nzindex
from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE, Table
from .backends import AbstractPData, map_parts
from .collectives import exchange
from .exchanger import Exchanger
from .index_sets import AbstractIndexSet, GID_DTYPE
from .prange import (
    PRange, add_gids, add_gids_inplace, oids_are_equal, lids_are_equal, to_lids,
    uniform_partition,
)
from .pvector import PVector, _owned, _ghost


class PSparseMatrix:
    # _spec_fingerprint: the lazily cached value-sensitive identity of
    # telemetry.spectrum.spectrum_fingerprint (one O(nnz) digest an operator)
    __slots__ = ("values", "rows", "cols", "_exchanger", "_blocks", "_device", "_spec_fingerprint")

    def __init__(
        self,
        values: AbstractPData,
        rows: PRange,
        cols: PRange,
        exchanger: Optional[Exchanger] = None,
    ):
        self.values = values
        self.rows = rows
        self.cols = cols
        #: the nonzero-value exchanger of ghost rows, built on first use
        #: (`exchanger`) unless the caller hands one in
        self._exchanger = exchanger
        self._blocks = None
        self._device = {}  # (GPUBackend, box) -> lowered DeviceMatrix (gpu.py)

    # ------------------------------------------------------------------
    # constructors (reference: src/Interfaces.jl:2194-2244)
    # ------------------------------------------------------------------

    @classmethod
    def from_coo(
        cls,
        I: AbstractPData,
        J: AbstractPData,
        V: AbstractPData,
        rows,
        cols,
        ids: str = "global",
    ) -> "PSparseMatrix":
        """Build from per-part COO triplets. ``ids='global'`` renumbers I, J
        to lids in place. Integer `rows`/`cols` build uniform PRanges and
        add the touched off-part gids as ghosts (reference:
        src/Interfaces.jl:2220-2244)."""
        check(ids in ("global", "local"), "ids must be 'global' or 'local'")
        if isinstance(rows, (int, np.integer)):
            check(ids == "global", "building rows from n requires global ids")
            from .backends import get_part_ids

            parts = get_part_ids(I)
            rows = uniform_partition(parts, int(rows))
            add_gids_inplace(rows, I)
        if isinstance(cols, (int, np.integer)):
            check(ids == "global", "building cols from n requires global ids")
            from .backends import get_part_ids

            parts = get_part_ids(J)
            cols = uniform_partition(parts, int(cols))
            add_gids_inplace(cols, J)
        if ids == "global":
            to_lids(rows, I)
            to_lids(cols, J)

        def _compress(ri, ci, i, j, v):
            return compresscoo(i, j, v, ri.num_lids, ci.num_lids)

        values = map_parts(_compress, rows.partition, cols.partition, I, J, V)
        return cls(values, rows, cols)

    # ------------------------------------------------------------------
    # block views (reference: src/Interfaces.jl:2142-2183)
    # ------------------------------------------------------------------

    def _block_cache(self):
        if self._blocks is None:
            def _split(ri: AbstractIndexSet, ci: AbstractIndexSet, A: CSRMatrix):
                check(
                    ri.owned_first and ci.owned_first,
                    "PSparseMatrix blocks require owned-first lid layouts",
                )
                no_r, no_c = ri.num_oids, ci.num_oids
                o_rows = np.arange(no_r, dtype=INDEX_DTYPE)
                h_rows = np.arange(no_r, A.shape[0], dtype=INDEX_DTYPE)
                return {
                    "oo": csr_block(A, o_rows, no_c, want_upper=False),
                    "oh": csr_block(A, o_rows, no_c, want_upper=True, col_offset=no_c),
                    "ho": csr_block(A, h_rows, no_c, want_upper=False),
                    "hh": csr_block(A, h_rows, no_c, want_upper=True, col_offset=no_c),
                }

            self._blocks = map_parts(
                _split, self.rows.partition, self.cols.partition, self.values
            )
        return self._blocks

    @property
    def owned_owned_values(self) -> AbstractPData:
        return map_parts(lambda b: b["oo"], self._block_cache())

    @property
    def owned_ghost_values(self) -> AbstractPData:
        return map_parts(lambda b: b["oh"], self._block_cache())

    @property
    def dtype(self):
        return self.values.part_values()[0].dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows.ngids, self.cols.ngids)

    def __repr__(self):
        return (
            f"PSparseMatrix(shape={self.shape}, nparts={self.rows.num_parts}, "
            f"dtype={self.dtype})"
        )

    # ------------------------------------------------------------------
    # SpMV (reference: src/Interfaces.jl:2246-2275)
    # ------------------------------------------------------------------

    def mul_into(
        self, c: PVector, b: PVector, alpha: float = 1.0, beta: float = 0.0, strict: bool = False
    ) -> PVector:
        """c = beta*c + alpha*A@b with communication/compute overlap.
        Ghost rows of c are not touched. Axis contract: c.rows ~ A.rows on
        owned ids; A.cols ~ b.rows on owned AND ghost ids (b must carry A's
        column ghost layer). ``strict`` folds each block's rows left to
        right (`csr_spmv(strict=True)`): the A_oo fold, then the A_oh
        fold added, the order of the card's strict (ELL) lowering."""
        check(oids_are_equal(c.rows, self.rows), "mul: c.rows incompatible with A.rows")
        check(
            lids_are_equal(self.cols, b.rows),
            "mul: b.rows must match A.cols incl. the ghost layer",
        )
        t = b.async_exchange()  # start halo update of b (non-blocking)
        blocks = self._block_cache()

        def _phase1(ri, cv, bi, bv, blk):
            # in-place owned update needs the slice view, not a fancy copy
            check(ri.owned_first, "mul: c.rows must use the owned-first lid layout")
            co = _owned(ri, cv)
            bo = _owned(bi, bv)
            if beta == 0.0:
                co[...] = 0.0
            elif beta != 1.0:
                co *= beta
            co += alpha * csr_spmv(blk["oo"], bo, strict=strict)
            return None

        map_parts(_phase1, self.rows.partition, c.values, b.rows.partition, b.values, blocks)
        t.wait()  # ghosts of b are now current

        def _phase2(ri, cv, bi, bv, blk):
            if blk["oh"].nnz:
                check(ri.owned_first, "mul: c.rows must use the owned-first lid layout")
                co = _owned(ri, cv)
                bh = _ghost(bi, bv)
                co += alpha * csr_spmv(blk["oh"], bh, strict=strict)
            return None

        map_parts(_phase2, self.rows.partition, c.values, b.rows.partition, b.values, blocks)
        return c

    def __matmul__(self, b: PVector) -> PVector:
        c = PVector.full(0.0, self.rows, dtype=np.result_type(self.dtype, b.dtype))
        return self.mul_into(c, b)

    def __mul__(self, a):
        check(np.isscalar(a), "PSparseMatrix * non-scalar (use @ for SpMV)")
        vals = map_parts(
            lambda A: CSRMatrix(A.indptr, A.indices, A.data * a, A.shape), self.values
        )
        return PSparseMatrix(vals, self.rows, self.cols, self._exchanger)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    @property
    def exchanger(self) -> Exchanger:
        """The nonzero-value exchanger of ghost rows (`matrix_exchanger`),
        built once and kept."""
        if self._exchanger is None:
            self._exchanger = matrix_exchanger(self.values, self.rows, self.cols)
        return self._exchanger


def matrix_exchanger(values: AbstractPData, rows: PRange, cols: PRange) -> Exchanger:
    """Build the nonzero-value exchanger for ghost-row halo/assembly
    (reference: src/Interfaces.jl:2300-2372): for each stored entry in a
    ghost row, record its nz index and (gi, gj); ship the (gi, gj) pairs to
    the row owner along the row-halo graph; the owner looks up its own nz
    index via `nzindex` (consistent sparsity pattern required — checked)."""
    rex = rows.exchanger  # row-halo neighbor graph

    def _collect(ri: AbstractIndexSet, ci: AbstractIndexSet, A: CSRMatrix, prcv):
        rows_of_nz = A.row_of_nz()
        ohid = ri.lid_to_ohid[rows_of_nz]
        mask = ohid < 0
        k = np.nonzero(mask)[0].astype(INDEX_DTYPE)
        gi = ri.lid_to_gid[rows_of_nz[mask]]
        gj = ci.lid_to_gid[A.indices[mask]]
        owner = ri.lid_to_part[rows_of_nz[mask]]
        prcv = np.asarray(prcv)
        rows_k, rows_gi, rows_gj = [], [], []
        for q in prcv:
            sel = owner == q
            rows_k.append(k[sel])
            rows_gi.append(gi[sel])
            rows_gj.append(gj[sel])
        return (
            Table.from_rows(rows_k) if rows_k else Table.empty(INDEX_DTYPE),
            Table.from_rows(rows_gi) if rows_gi else Table.empty(GID_DTYPE),
            Table.from_rows(rows_gj) if rows_gj else Table.empty(GID_DTYPE),
        )

    col = map_parts(_collect, rows.partition, cols.partition, values, rex.parts_rcv)
    k_rcv = map_parts(lambda c: c[0], col)
    gi_rcv = map_parts(lambda c: c[1], col)
    gj_rcv = map_parts(lambda c: c[2], col)

    # ship wanted (gi, gj) to the owners along the reversed halo graph
    gi_snd = exchange(gi_rcv, rex.parts_snd, rex.parts_rcv)
    gj_snd = exchange(gj_rcv, rex.parts_snd, rex.parts_rcv)

    def _lookup(ri, ci, A, git, gjt):
        li = ri.gids_to_lids(git.data)
        lj = ci.gids_to_lids(gjt.data)
        check((li >= 0).all() and (lj >= 0).all(), "matrix_exchanger: unknown gid on owner")
        k = nzindex(A, li, lj)
        check(
            (k >= 0).all(),
            "matrix_exchanger: ghost entry absent from owner sparsity pattern",
        )
        return Table(k.astype(INDEX_DTYPE), git.ptrs)

    k_snd = map_parts(
        _lookup, rows.partition, cols.partition, values, gi_snd, gj_snd
    )
    return Exchanger(rex.parts_rcv, rex.parts_snd, k_rcv, k_snd)


# ---------------------------------------------------------------------------
# COO-level assembly (reference: src/Interfaces.jl:2406-2492)
# ---------------------------------------------------------------------------


def assemble_coo(
    I: AbstractPData, J: AbstractPData, V: AbstractPData, rows: PRange
) -> Tuple[AbstractPData, AbstractPData, AbstractPData]:
    """Migrate raw COO triplets (global ids) to their row owners before
    compression (reference async_assemble!(I,J,V,rows)): triplets whose
    row this part owns stay; the rest ship along the row-halo graph and
    are appended on the owner, with the shipped local copies zeroed.
    Returns new (I, J, V) PDatas in global numbering."""
    rex = rows.exchanger

    def _split(ri: AbstractIndexSet, prcv, i, j, v):
        i = np.asarray(i, dtype=GID_DTYPE)
        j = np.asarray(j, dtype=GID_DTYPE)
        v = np.asarray(v)
        lids = ri.gids_to_lids(i)
        check((lids >= 0).all(), "assemble_coo: triplet row is not a local row")
        owner = ri.lid_to_part[lids]
        keep = owner == ri.part
        rows_i, rows_j, rows_v = [], [], []
        for q in np.asarray(prcv):
            sel = owner == q
            rows_i.append(i[sel])
            rows_j.append(j[sel])
            rows_v.append(v[sel])
        return (
            Table.from_rows(rows_i) if rows_i else Table.empty(GID_DTYPE),
            Table.from_rows(rows_j) if rows_j else Table.empty(GID_DTYPE),
            Table.from_rows(rows_v) if rows_v else Table.empty(v.dtype),
            i, j, np.where(keep, v, 0),
        )

    stay = map_parts(_split, rows.partition, rex.parts_rcv, I, J, V)
    rcv = [
        exchange(map_parts(lambda s, k=k: s[k], stay), rex.parts_snd, rex.parts_rcv)
        for k in range(3)
    ]

    def _append(s, rit, rjt, rvt):
        n = int(rit.ptrs[-1])
        return (
            np.concatenate([s[3], rit.data[:n]]),
            np.concatenate([s[4], rjt.data[:n]]),
            np.concatenate([s[5], rvt.data[:n]]),
        )

    out = map_parts(_append, stay, *rcv)
    return tuple(map_parts(lambda o, k=k: o[k], out) for k in range(3))


def assemble_matrix_from_coo(
    I: AbstractPData, J: AbstractPData, V: AbstractPData, rows0: PRange,
    cols0: Optional[PRange] = None,
) -> PSparseMatrix:
    """The FE/FD assembly pipeline: migrate off-owner triplets to their row
    owners (`assemble_coo`), keep those on owned rows, discover the column
    ghost layer from the kept column gids, and compress. ``rows0`` must be
    ghost-free; the result's cols are ``cols0`` (rectangular operators) or
    ``rows0``, extended by the discovered ghosts."""
    rows = add_gids(rows0, I)
    I2, J2, V2 = assemble_coo(I, J, V, rows)

    def _keep_owned(iset, i, j, v):
        own = iset.gids_to_lids(np.asarray(i)) >= 0
        return np.asarray(i)[own], np.asarray(j)[own], np.asarray(v)[own]

    kept = map_parts(_keep_owned, rows0.partition, I2, J2, V2)
    I2, J2, V2 = (map_parts(lambda k_, k=k: k_[k], kept) for k in range(3))
    cols = add_gids(rows0 if cols0 is None else cols0, J2)
    return PSparseMatrix.from_coo(I2, J2, V2, rows0, cols, ids="global")


def exchange_coo(
    I: AbstractPData, J: AbstractPData, V: AbstractPData, rows: PRange
) -> Tuple[AbstractPData, AbstractPData, AbstractPData]:
    """Inverse direction (reference async_exchange!(I,J,V,rows):
    src/Interfaces.jl:2494-2592): owners *replicate* the triplets of rows
    that other parts hold as ghosts, appending to those parts' COO lists —
    used to set up overlapping/ghosted matrices."""
    rex = rows.exchanger

    def _select(ri: AbstractIndexSet, lids_snd: Table, i, j, v):
        i = np.asarray(i, dtype=GID_DTYPE)
        j = np.asarray(j, dtype=GID_DTYPE)
        v = np.asarray(v)
        lids = ri.gids_to_lids(i)
        rows_i, rows_j, rows_v = [], [], []
        for nb in range(len(lids_snd)):
            wanted = lids_snd[nb]
            sel = np.isin(lids, wanted)
            rows_i.append(i[sel])
            rows_j.append(j[sel])
            rows_v.append(v[sel])
        return (
            Table.from_rows(rows_i) if rows_i else Table.empty(GID_DTYPE),
            Table.from_rows(rows_j) if rows_j else Table.empty(GID_DTYPE),
            Table.from_rows(rows_v) if rows_v else Table.empty(v.dtype),
        )

    sel = map_parts(_select, rows.partition, rex.lids_snd, I, J, V)
    ti = map_parts(lambda s: s[0], sel)
    tj = map_parts(lambda s: s[1], sel)
    tv = map_parts(lambda s: s[2], sel)

    # owners send to the parts ghosting their rows: the forward halo graph
    ri_rcv = exchange(ti, rex.parts_rcv, rex.parts_snd)
    rj_rcv = exchange(tj, rex.parts_rcv, rex.parts_snd)
    rv_rcv = exchange(tv, rex.parts_rcv, rex.parts_snd)

    def _append(i, j, v, rit, rjt, rvt):
        n = int(rit.ptrs[-1])
        return (
            np.concatenate([np.asarray(i, dtype=GID_DTYPE), rit.data[:n]]),
            np.concatenate([np.asarray(j, dtype=GID_DTYPE), rjt.data[:n]]),
            np.concatenate([np.asarray(v), rvt.data[:n]]),
        )

    out = map_parts(_append, I, J, V, ri_rcv, rj_rcv, rv_rcv)
    return (
        map_parts(lambda o: o[0], out),
        map_parts(lambda o: o[1], out),
        map_parts(lambda o: o[2], out),
    )


# ---------------------------------------------------------------------------
# views (reference: src/Interfaces.jl:2277-2298)
# ---------------------------------------------------------------------------


class _MatrixViewPart:
    """Shared read/write/accumulate semantics of the matrix views: reads of
    entries absent from the sparsity pattern return 0; writes to them raise.
    Subclasses supply `_nz` (index-space mapping -> nz storage position)
    and `_kind` for diagnostics."""

    _kind = "matrix_view"

    def _nz(self, i, j):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, ij):
        i, j = ij
        k = self._nz(i, j)
        out = np.where(k >= 0, self.values.data[np.maximum(k, 0)], 0.0)
        if np.isscalar(i) and np.isscalar(j):
            return out.reshape(-1)[0]
        return out

    def __setitem__(self, ij, v):
        k = self._nz(*ij)
        check(bool((np.asarray(k) >= 0).all()),
              f"{self._kind} write to an entry not stored in parent")
        self.values.data[k] = v

    def add(self, i, j, v):
        """Scatter-accumulate (the FEM assembly primitive)."""
        k = self._nz(i, j)
        check(bool((np.asarray(k) >= 0).all()),
              f"{self._kind} add to an entry not stored in parent")
        np.add.at(self.values.data, np.asarray(k), np.asarray(v))


class LocalMatrixViewPart(_MatrixViewPart):
    """One part of `local_view(A, rows, cols)`: A's local matrix re-indexed
    by another (rows, cols) pair's lids
    (reference LocalView semantics: src/Interfaces.jl:1994-2035)."""

    __slots__ = ("values", "row_map", "col_map")
    _kind = "local_view"

    def __init__(self, values: CSRMatrix, row_map: np.ndarray, col_map: np.ndarray):
        self.values = values
        self.row_map = np.asarray(row_map)
        self.col_map = np.asarray(col_map)

    @property
    def shape(self):
        return (len(self.row_map), len(self.col_map))

    def _nz(self, i, j):
        li = self.row_map[np.asarray(i)]
        lj = self.col_map[np.asarray(j)]
        check(
            bool((li >= 0).all()) and bool((lj >= 0).all()),
            "local_view: index not present in the parent matrix's lids",
        )
        return nzindex(self.values, li, lj)


class GlobalMatrixViewPart(_MatrixViewPart):
    """One part of `global_view(A)`: entries addressed by (gi, gj) global
    ids (reference GlobalView: src/Interfaces.jl:2037-2069)."""

    __slots__ = ("values", "rows_iset", "cols_iset", "shape")
    _kind = "global_view"

    def __init__(self, values: CSRMatrix, rows_iset, cols_iset, shape):
        self.values = values
        self.rows_iset = rows_iset
        self.cols_iset = cols_iset
        self.shape = shape

    def _nz(self, gi, gj):
        li = self.rows_iset.gids_to_lids(np.asarray(gi))
        lj = self.cols_iset.gids_to_lids(np.asarray(gj))
        check(
            bool((li >= 0).all()) and bool((lj >= 0).all()),
            "global_view: gid not local on this part",
        )
        return nzindex(self.values, li, lj)


def psparse_local_view(A: PSparseMatrix, rows: PRange = None, cols: PRange = None):
    rows = rows if rows is not None else A.rows
    cols = cols if cols is not None else A.cols

    def _mk(vri, vci, ri, ci, M):
        rm = ri.gids_to_lids(vri.lid_to_gid)
        cm = ci.gids_to_lids(vci.lid_to_gid)
        return LocalMatrixViewPart(M, rm, cm)

    return map_parts(
        _mk, rows.partition, cols.partition,
        A.rows.partition, A.cols.partition, A.values,
    )


def psparse_global_view(A: PSparseMatrix, rows: PRange = None, cols: PRange = None):
    rows = rows if rows is not None else A.rows
    cols = cols if cols is not None else A.cols
    shape = (rows.ngids, cols.ngids)
    return map_parts(
        lambda ri, ci, M: GlobalMatrixViewPart(M, ri, ci, shape),
        rows.partition, cols.partition, A.values,
    )


def psparse_local_values(A: PSparseMatrix) -> AbstractPData:
    """The raw per-part local CSR matrices (lid x lid)."""
    return A.values


def psparse_owned_triplets(A: PSparseMatrix) -> AbstractPData:
    """Per-part (gi, gj, v) of the entries stored on OWNED rows, global
    numbering — the redistribution/serialization form. Nonzero entries on
    ghost rows indicate unassembled contributions that would silently
    vanish; that is rejected (assemble them into their owners first, e.g.
    through `matrix_exchanger`'s reverse plan)."""

    def _own(iset, t):
        gi, gj, v = t
        owned = iset.lid_to_ohid[iset.gids_to_lids(np.asarray(gi))] >= 0
        check(
            bool(np.all(np.asarray(v)[~owned] == 0)),
            "matrix holds nonzero unassembled ghost-row entries; assemble "
            "them into their owners before redistributing/serializing",
        )
        return gi[owned], gj[owned], v[owned]

    return map_parts(_own, A.rows.partition, psparse_global_triplets(A))


def psparse_global_triplets(A: PSparseMatrix) -> AbstractPData:
    """Per-part (gi, gj, v) of all stored entries, in global numbering."""

    def _mk(ri, ci, M: CSRMatrix):
        return ri.lid_to_gid[M.row_of_nz()], ci.lid_to_gid[M.indices], M.data.copy()

    return map_parts(_mk, A.rows.partition, A.cols.partition, A.values)
