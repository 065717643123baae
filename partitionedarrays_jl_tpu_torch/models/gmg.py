"""Distributed geometric multigrid (variational V-cycle) on Cartesian
partitions: the host hierarchy.

The port's copy of `partitionedarrays_jl_tpu/models/gmg.py`. The
interpolation P is an ordinary rectangular `PSparseMatrix` (fine rows x
coarse cols), R = Pᵀ, and the Galerkin coarse operator A_c = Pᵀ A P is
collapsed per part by the port's native layer (planning.cpp `galerkin3`,
`galerkin_classify`) and emitted COO-free (`galerkin_emit`), or, where
those decline or the layer is off, the exact triple product of per-part
local SciPy products whose off-owner triplets ride the COO assembly
migration (`assemble_matrix_from_coo`). ``cycle="w"`` gives the W-cycle (a
second, warm-started coarse pass below every level but the last), and
``agg_threshold > 0`` coarse-level agglomeration onto strided sub-grids
of parts.

The hierarchy is variational, so for SPD fine operators every coarse
operator is SPD and the V-cycle with symmetric smoothing (pre == post) is
a valid CG preconditioner (`pcg(..., minv=hierarchy)`). Coarsening is
vertex-based per dimension (coarse point k sits on fine point 2k,
nc = ceil(nf/2)); interpolation is the d-linear tensor product. The
coarsest level is solved on MAIN by the dense `PLU`.

On the GPU backend, `pcg(A, b, minv=hierarchy)`, `gmg_solve` and
`fgmres(..., minv=hierarchy)` run the whole cycle on the card
(`parallel/gpu_gmg.py`); the host cycle below is the sequential backend's
oracle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..ops.sparse import CSRMatrix
from ..parallel.backends import AbstractPData, map_parts
from ..parallel.collectives import gather_all
from ..parallel.prange import PRange, _block_firsts, add_gids, cartesian_partition, no_ghost
from ..parallel.psparse import PSparseMatrix, assemble_coo, assemble_matrix_from_coo
from ..parallel.pvector import PVector
from ..utils.helpers import check
from .solvers import PLU, _owned_update, _owned_zip, jacobi_preconditioner


def _interp_1d(f: np.ndarray, nc: int):
    """Per-dimension interpolation stencil at fine indices `f`: returns
    (k0, w0, k1, w1) with fine value = w0*coarse[k0] + w1*coarse[k1].
    Even fine points coincide with coarse point f/2 (w1 = 0); odd points
    average their two coarse neighbors; the trailing odd point of an
    even-sized dimension drops the out-of-range weight, which keeps P equal
    to the factored form P = S·E the device transfers apply."""
    even = (f % 2) == 0
    k0 = np.where(even, f // 2, (f - 1) // 2)
    k1 = np.where(even, k0, (f + 1) // 2)
    w0 = np.where(even, 1.0, 0.5)
    w1 = np.where(even, 0.0, 0.5)
    clamp = k1 > nc - 1
    k1 = np.where(clamp, k0, k1)
    w1 = np.where(clamp, 0.0, w1)
    return k0, w0, k1, w1


def _interp_rows(row_labels: np.ndarray, fine_gids: np.ndarray, nfs: Sequence[int],
                 ncs: Sequence[int]):
    """d-linear interpolation rows for a batch of fine points: COO arrays
    (row label repeated, coarse gid, weight), up to 2^d entries per fine
    point, zero weights dropped. `row_labels` carries the caller's row
    identity (fine gids or fine lids), parallel to `fine_gids`."""
    dim = len(nfs)
    coords = np.unravel_index(np.asarray(fine_gids, dtype=np.int64), tuple(nfs))
    per_dim = [_interp_1d(c, ncs[d]) for d, c in enumerate(coords)]
    I_out, J_out, W_out = [], [], []
    labels = np.asarray(row_labels)
    for mask in range(1 << dim):
        kk, ww = [], None
        for d in range(dim):
            k0, w0, k1, w1 = per_dim[d]
            k = k1 if (mask >> d) & 1 else k0
            w = w1 if (mask >> d) & 1 else w0
            kk.append(k)
            ww = w if ww is None else ww * w
        gj = np.ravel_multi_index(tuple(kk), tuple(ncs))
        keep = ww > 0
        I_out.append(labels[keep])
        J_out.append(gj[keep])
        W_out.append(ww[keep])
    return np.concatenate(I_out), np.concatenate(J_out), np.concatenate(W_out)


def interpolation_cartesian(nfs: Sequence[int], ncs: Sequence[int], fine_rows: PRange,
                            coarse_rows: PRange, dtype=None) -> PSparseMatrix:
    """The prolongation P as a rectangular PSparseMatrix: rows
    ``fine_rows`` (ghost-free), cols ``coarse_rows`` extended by the
    interpolation ghost layer; weights in ``dtype`` (float64 default)."""
    nfs = tuple(int(n) for n in nfs)
    ncs = tuple(int(n) for n in ncs)
    dtype = np.float64 if dtype is None else dtype

    def _local(iset):
        g = np.asarray(iset.oid_to_gid, dtype=np.int64)
        i, j, w = _interp_rows(g, g, nfs, ncs)
        return i, j, w.astype(dtype, copy=False)

    coo = map_parts(_local, fine_rows.partition)
    I, J, V = (map_parts(lambda c, k=k: c[k], coo) for k in range(3))
    cols = add_gids(coarse_rows, J)
    return PSparseMatrix.from_coo(I, J, V, fine_rows, cols, ids="global")


def _scipy_csr(M):
    from scipy.sparse import csr_matrix

    return csr_matrix((M.data, M.indices, M.indptr), shape=M.shape)


def _decode_offset(e: int, dim: int):
    """Base-3 decode of a 3^d diagonal index into per-dim offsets in
    {-1, 0, 1}, most-significant dim first (the accumulation order of
    planning.cpp:galerkin3_dim)."""
    de, m = [], e
    for _ in range(dim):
        de.append(m % 3 - 1)
        m //= 3
    de.reverse()
    return de


def _galerkin_fused(accs, ncs, coarse_rows: PRange) -> PSparseMatrix:
    """COO-free Galerkin assembly from per-part accumulators
    (gmg.py:155-348 of the JAX package): only the O(surface) SHELL of each part's extended-box
    accumulator — contributions to coarse rows owned elsewhere — rides
    the classic COO migration (`assemble_coo`); received triplets are
    scattered back into the accumulator, and the owned interior is then
    emitted straight to column-sorted per-part CSR with local column
    ids by planning.cpp:galerkin_emit_dim. The O(volume) extraction /
    dedup / add_gids / to_lids / compresscoo passes of the generic path
    never run. Cross-part sums happen at the accumulator's f64
    precision (the generic path sums after the cast to the operator
    dtype; both round to the same values to operator-dtype accuracy).
    Reference anchor: the assembly migration this specializes,
    src/Interfaces.jl:2406-2492."""
    ncs = tuple(int(n) for n in ncs)
    dim = len(ncs)

    def _empty_coo():
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0, dtype=np.float64)

    # ---- 1) shell COO: rows of the extended box outside the owned box
    def _shell(ci, a):
        out, elo, ehi, _dt = a
        clo, chi = ci.box_lo, ci.box_hi
        ebox = tuple(h - l for l, h in zip(elo, ehi))
        if int(np.prod(ebox)) == 0:
            return _empty_coo()
        mask = np.zeros(ebox, dtype=bool)
        mask[
            tuple(
                slice(cl - el, ch - el)
                for cl, ch, el in zip(clo, chi, elo)
            )
        ] = True
        shell = np.nonzero(~mask.ravel())[0]
        if not len(shell):
            return _empty_coo()
        cc = np.unravel_index(shell, ebox)
        I_out, J_out, V_out = [], [], []
        for e in range(3**dim):
            v = out[shell, e]
            nz = np.nonzero(v)[0]
            if not len(nz):
                continue
            de = _decode_offset(e, dim)
            c1 = [c[nz] + l for c, l in zip(cc, elo)]
            c2 = [c + d for c, d in zip(c1, de)]
            I_out.append(np.ravel_multi_index(tuple(c1), ncs))
            J_out.append(np.ravel_multi_index(tuple(c2), ncs))
            V_out.append(v[nz])
        if not I_out:
            return _empty_coo()
        return (
            np.concatenate(I_out),
            np.concatenate(J_out),
            np.concatenate(V_out),
        )

    shell = map_parts(_shell, coarse_rows.partition, accs)
    sizes = gather_all(map_parts(lambda s: len(s[0]), shell))
    if int(np.sum(np.asarray(sizes.part_values()[0]))) > 0:
        I = map_parts(lambda s: s[0], shell)
        J = map_parts(lambda s: s[1], shell)
        V = map_parts(lambda s: s[2], shell)
        rows_g = add_gids(coarse_rows, I)
        I2, J2, V2 = assemble_coo(I, J, V, rows_g)

        def _scatter(ci, a, i, j, v):
            out, elo, ehi, _dt = a
            i = np.asarray(i)
            j = np.asarray(j)
            v = np.asarray(v)
            # our zeroed sent copies target rows owned elsewhere; what
            # remains nonzero on owned rows is neighbor contributions
            keep = (ci.gids_to_lids(i) >= 0) & (v != 0)
            if not keep.any():
                return None
            i, j, v = i[keep], j[keep], v[keep]
            ebox = tuple(h - l for l, h in zip(elo, ehi))
            c1 = np.unravel_index(i, ncs)
            c2 = np.unravel_index(j, ncs)
            pos = np.ravel_multi_index(
                tuple(c - l for c, l in zip(c1, elo)), ebox
            )
            e = np.zeros(len(v), dtype=np.int64)
            for d in range(dim):
                de_d = c2[d].astype(np.int64) - c1[d]
                check(
                    bool(((de_d >= -1) & (de_d <= 1)).all()),
                    "galerkin shell triplet outside the 3^d closure",
                )
                e = e * 3 + (de_d + 1)
            np.add.at(out, (pos, e), v)
            return None

        map_parts(_scatter, coarse_rows.partition, accs, I2, J2, V2)

    # ---- 2) geometric-shell column ghosts (sorted gids: add_gids then
    # appends them in exactly the rank order the emission kernel uses)
    def _ghosts(ci):
        clo, chi = ci.box_lo, ci.box_hi
        xlo = [max(0, c - 1) for c in clo]
        xhi = [min(n, c + 1) for c, n in zip(chi, ncs)]
        slabs = []
        for d in range(dim):
            for lo_d, hi_d in ((xlo[d], clo[d]), (chi[d], xhi[d])):
                if lo_d >= hi_d:
                    continue
                ranges = [np.arange(xlo[k], xhi[k]) for k in range(dim)]
                ranges[d] = np.arange(lo_d, hi_d)
                mg = np.meshgrid(*ranges, indexing="ij")
                slabs.append(
                    np.ravel_multi_index(
                        tuple(m.ravel() for m in mg), ncs
                    )
                )
        if not slabs:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(slabs))

    ghosts = map_parts(_ghosts, coarse_rows.partition)
    cols = add_gids(coarse_rows, ghosts)

    # ---- 3) fused CSR emission over the owned box
    def _emit(ci, a, gg):
        out, elo, ehi, dt = a
        clo, chi = ci.box_lo, ci.box_hi
        res = native.galerkin_emit(out, ncs, elo, ehi, clo, chi, gg, dt)
        check(
            res is not None,
            "galerkin_emit declined after the eligibility check",
        )
        indptr, cols_l, vals = res
        no = int(np.prod([h - l for l, h in zip(clo, chi)]))
        return CSRMatrix(indptr, cols_l, vals, (no, no + len(gg)))

    values = map_parts(_emit, coarse_rows.partition, accs, ghosts)
    return PSparseMatrix(values, coarse_rows, cols)


#: Boundary-distance margin of the classed collapse: rows/coarse points
#: further than this from every grid edge are treated as one zone. The
#: induction bound for the d-linear Galerkin family is ~ceil(M/2)+3,
#: whose fixed point is 6 — 8 adds safety without changing the rep
#: count meaningfully.
_CLASSED_MARGIN = 8


def _classed_collapse(ri, ci, M, nfs, ncs, flo, fhi, elo, ehi):
    """O(reps + volume-copy) Galerkin collapse for boundary-classed
    operators (gmg.py:358-476 of the JAX package). Precondition, VERIFIED exactly per
    part: every owned fine row's 3^d grid-offset value signature is a
    function of its per-dim boundary-distance zones
    (planning.cpp:galerkin_classify_dim + the rep-gather compare below).
    Given that, the accumulator row at coarse point c is determined by
    the per-dim tuple (distance to grid lo/hi capped at _CLASSED_MARGIN,
    distance to the part's ext-box lo/hi capped at 2): all fine rows a
    coarse point draws on (support [2c-2, 2c+2]) then sit in identical
    zones with identical interpolation parity/clamp and identical
    part-ownership partiality. So only one REPRESENTATIVE coarse row per
    zone tuple is collapsed (planning.cpp row-subset mode, rows in
    ascending order — bit-identical partial sums to the full pass) and
    the rest of the accumulator is a broadcast gather. Returns the
    (esize, 3^d) accumulator or None (caller runs the full collapse)."""
    dim = len(nfs)
    fbox = [fhi[d] - flo[d] for d in range(dim)]
    no = int(np.prod(fbox))
    ebox = [ehi[d] - elo[d] for d in range(dim)]
    esize = int(np.prod(ebox))
    if no < 4096 or esize == 0:
        return None  # rep machinery wouldn't beat the direct pass
    if not (
        hasattr(ci, "gids_to_lids")
        and ci.num_oids == ri.num_oids
    ):
        return None
    Mf = _CLASSED_MARGIN

    # --- 1) per-row grid-offset classes + zone-uniformity verification
    nh = M.shape[1] - no
    if nh:
        gg = np.asarray(ci.lid_to_gid[no:], dtype=np.int64)
        gcoords = np.unravel_index(gg, tuple(nfs))
        ghost_rel = np.stack(
            [c - l for c, l in zip(gcoords, flo)], axis=1
        )
    else:
        ghost_rel = np.zeros((0, dim), dtype=np.int64)
    table, codes, ok = native.galerkin_classify(
        M.indptr, M.indices, M.data, no, fbox, ghost_rel, 64
    )
    if not ok:
        return None

    def _zone_reps(coords_lo, coords_hi, n_glob, part_margin_lo,
                   part_margin_hi):
        """Per-coordinate zone ids over [coords_lo, coords_hi) plus the
        first coordinate of each distinct zone: (rep_index_per_coord,
        rep_coords). Zones: global-edge distances capped at Mf, part
        (box) distances capped at the given margins."""
        x = np.arange(coords_lo, coords_hi, dtype=np.int64)
        z = (
            np.minimum(x, Mf) * (4 * (Mf + 1) * 4)
            + np.minimum(n_glob - 1 - x, Mf) * 16
            + np.minimum(x - coords_lo, part_margin_lo) * 4
            + np.minimum(coords_hi - 1 - x, part_margin_hi)
        )
        _, first, inv = np.unique(z, return_index=True, return_inverse=True)
        return first[inv], x[np.sort(first)], first

    # fine zone maps (values depend on global distance only)
    fmaps = []
    for d in range(dim):
        rep_idx_of, _, _ = _zone_reps(flo[d], fhi[d], nfs[d], 0, 0)
        fmaps.append(rep_idx_of)
    C = codes.reshape(fbox)
    if not np.array_equal(C, C[np.ix_(*fmaps)]):
        return None  # not boundary-classed (e.g. variable coefficients)

    # --- 2) coarse reps (global margins + part-partiality margins)
    cmaps, creps = [], []
    for d in range(dim):
        rep_idx_of, reps, _ = _zone_reps(elo[d], ehi[d], ncs[d], 2, 2)
        cmaps.append(rep_idx_of)
        creps.append(reps)
    n_rep = int(np.prod([len(r) for r in creps]))
    if n_rep * 4 > esize:
        return None  # too few repeated rows to pay for the gather

    # --- 3) collapse the rep support only, then expand
    sups = []
    for d in range(dim):
        f = np.unique(
            np.concatenate([2 * creps[d] - 1, 2 * creps[d], 2 * creps[d] + 1])
        )
        sups.append(f[(f >= flo[d]) & (f < fhi[d])])
    acc = native.galerkin3(
        M.indptr, M.indices, M.data, no,
        np.asarray(ci.lid_to_gid, dtype=np.int64),
        nfs, flo, fhi, ncs, elo, ehi, sub_coords=sups,
    )
    if acc is None:
        return None
    ne = 3**dim
    A_full = acc.reshape(tuple(ebox) + (ne,))
    # cmaps[d] already holds, per coarse coordinate, the ext-box
    # POSITION of its zone's representative (first occurrence)
    out = np.ascontiguousarray(A_full[np.ix_(*cmaps)])
    return out.reshape(esize, ne)


def galerkin_cartesian(A: PSparseMatrix, nfs: Sequence[int], ncs: Sequence[int],
                       coarse_rows: PRange) -> PSparseMatrix:
    """Exact distributed A_c = Pᵀ A P for the Cartesian d-linear P
    (gmg.py:479-645 of the JAX package). Where every part has box metadata
    and the native stencil collapse (planning.cpp `galerkin3`, or the
    classed collapse where the part's rows are boundary-classed) succeeds
    everywhere, the coarse operator is
    emitted without a COO (`_galerkin_fused`): only the O(surface) shell of
    each part's extended-box accumulator rides the assembly exchange.
    Parts the fused path declines take the accumulator's COO, and parts
    without an accumulator the generic route: P rows for every fine lid of
    A's column range (owned and ghost) recomputed locally from grid
    arithmetic, so no P rows are exchanged; each part's
    Σ_{owned fine rows i} P[i,:]ᵀ (A P)[i,:] sums to the exact product
    because fine rows are disjointly owned, and the coarse triplets then
    migrate to their row owners. With `native.ENABLED` off every part
    takes the generic route."""
    from scipy.sparse import csr_matrix

    nfs = tuple(int(n) for n in nfs)
    ncs = tuple(int(n) for n in ncs)
    dim = len(nfs)
    check(
        int(np.prod(ncs)) == coarse_rows.ngids,
        "galerkin_cartesian: coarse grid does not match coarse_rows",
    )

    def _acc_part(ri, ci, M):
        """The native collapse's accumulator over the part's extended
        coarse box, or None where the part lacks box metadata or the
        operator leaves the 3^d closure (the classed collapse's
        accumulator is the full pass's bit for bit)."""
        if not native.available() or not (hasattr(ri, "box_lo") and ri.grid_shape == nfs):
            return None
        flo, fhi = ri.box_lo, ri.box_hi
        elo = [max(0, (flo[d] - 1) // 2) for d in range(dim)]
        ehi = [min(ncs[d], fhi[d] // 2 + 1) for d in range(dim)]
        out = _classed_collapse(ri, ci, M, nfs, ncs, flo, fhi, elo, ehi)
        if out is None:
            out = native.galerkin3(
                M.indptr, M.indices, M.data, ri.num_oids, np.asarray(ci.lid_to_gid, dtype=np.int64),
                nfs, flo, fhi, ncs, elo, ehi,
            )
        if out is None:
            return None
        return out, tuple(elo), tuple(ehi), M.data.dtype

    accs = map_parts(_acc_part, A.rows.partition, A.cols.partition, A.values)

    def _fusable(a, ci):
        # the coarse partition must be a box too, its owned box inside the
        # part's extended box (emission walks owned rows; shell rows migrate)
        if a is None or not (hasattr(ci, "box_lo") and ci.grid_shape == ncs):
            return 0
        _, elo, ehi, _ = a
        no = int(np.prod([h - l for l, h in zip(ci.box_lo, ci.box_hi)]))
        if no * 3**dim >= 2**31:  # the emission kernel's int32 capacity
            return 0
        return int(all(el <= cl and ch <= eh for el, eh, cl, ch in zip(elo, ehi, ci.box_lo, ci.box_hi)))

    flags = map_parts(_fusable, accs, coarse_rows.partition)
    if bool(np.all(np.asarray(gather_all(flags).part_values()[0]))):
        return _galerkin_fused(accs, ncs, coarse_rows)

    def _local_box(M, a):
        """The accumulator's COO, for parts the fused path declines (mixed
        eligibility, agglomerated coarse partitions)."""
        out, elo, ehi, _dt = a
        ebox = tuple(h - l for l, h in zip(elo, ehi))
        # int32 coarse gids where they fit: the COO pipeline runs copy-free
        gdt = np.int32 if int(np.prod(ncs)) < 2**31 else np.int64
        I_out, J_out, V_out = [], [], []
        for e in range(3**dim):
            v = out[:, e]
            nz = np.nonzero(v)[0]
            if not len(nz):
                continue
            cc = np.unravel_index(nz, ebox)
            de = _decode_offset(e, dim)
            c1 = [c + l for c, l in zip(cc, elo)]
            c2 = [c + d for c, d in zip(c1, de)]
            I_out.append(np.ravel_multi_index(tuple(c1), ncs).astype(gdt))
            J_out.append(np.ravel_multi_index(tuple(c2), ncs).astype(gdt))
            V_out.append(v[nz])
        if not I_out:
            z = np.empty(0, dtype=gdt)
            return z, z.copy(), np.empty(0, dtype=M.data.dtype)
        # the fine operator's dtype (the f64 accumulator is internal)
        return np.concatenate(I_out), np.concatenate(J_out), np.concatenate(V_out).astype(M.data.dtype, copy=False)

    def _local(ri, ci, M, a):
        if a is not None:
            return _local_box(M, a)
        fg = np.asarray(ci.lid_to_gid, dtype=np.int64)
        lid = np.arange(len(fg), dtype=np.int64)
        li, pj, pv = _interp_rows(lid, fg, nfs, ncs)
        cgid, cinv = np.unique(pj, return_inverse=True)
        P_ext = csr_matrix((pv, (li, cinv)), shape=(len(fg), len(cgid)))
        Q = _scipy_csr(M) @ P_ext  # owned fine rows x local coarse
        T = (P_ext[: ri.num_oids].T @ Q).tocoo()  # local coarse x local coarse
        return cgid[T.row], cgid[T.col], T.data.astype(M.data.dtype, copy=False)

    coo = map_parts(_local, A.rows.partition, A.cols.partition, A.values, accs)
    I, J, V = (map_parts(lambda c, k=k: np.asarray(c[k]), coo) for k in range(3))
    return assemble_matrix_from_coo(I, J, V, coarse_rows)


def restriction_from(P: PSparseMatrix, coarse_rows: PRange) -> PSparseMatrix:
    """R = Pᵀ as its own PSparseMatrix (coarse rows x fine cols): each part
    transposes its owned-fine-row block of P into coarse-row triplets,
    which migrate to their coarse row owners."""

    def _local(ri, ci, M):
        T = _scipy_csr(M)[: ri.num_oids].tocoo()
        gi = np.asarray(ri.lid_to_gid, dtype=np.int64)[T.row]
        gj = np.asarray(ci.lid_to_gid, dtype=np.int64)[T.col]
        return gj, gi, T.data  # transposed: coarse row, fine col

    coo = map_parts(_local, P.rows.partition, P.cols.partition, P.values)
    I, J, V = (map_parts(lambda c, k=k: c[k], coo) for k in range(3))
    return assemble_matrix_from_coo(I, J, V, coarse_rows, cols0=P.rows)


def interp_stencil_cartesian(nfs: Sequence[int], fine_rows: PRange, dtype=None) -> PSparseMatrix:
    """The square fine-grid interpolation stencil S of the factorization
    P = S·E: S[f, g] = Π_d w(g_d − f_d) with w(0) = 1, w(±1) = 1/2,
    truncated at the grid boundary. Constant coefficients per offset, so
    the lowering takes the coded-DIA path; w is symmetric, so Sᵀ = S
    serves prolongation (S·embed) and restriction (extract·S)."""
    nfs = tuple(int(n) for n in nfs)
    dim = len(nfs)
    dtype = np.float64 if dtype is None else dtype

    def _local(iset):
        g = np.asarray(iset.oid_to_gid, dtype=np.int64)
        coords = np.unravel_index(g, nfs)
        I_out, J_out, V_out = [], [], []
        for mask in range(3**dim):
            m, deltas = mask, []
            for _ in range(dim):
                deltas.append(m % 3 - 1)
                m //= 3
            w = 0.5 ** sum(1 for d in deltas if d != 0)
            nb = [c + d for c, d in zip(coords, deltas)]
            ok = np.ones(len(g), dtype=bool)
            for d in range(dim):
                ok &= (nb[d] >= 0) & (nb[d] < nfs[d])
            gj = np.ravel_multi_index(tuple(np.where(ok, nbd, 0) for nbd in nb), nfs)
            I_out.append(g[ok])
            J_out.append(gj[ok])
            V_out.append(np.full(int(ok.sum()), w, dtype=dtype))
        return np.concatenate(I_out), np.concatenate(J_out), np.concatenate(V_out)

    coo = map_parts(_local, fine_rows.partition)
    I, J, V = (map_parts(lambda c, k=k: c[k], coo) for k in range(3))
    cols = add_gids(fine_rows, J)
    return PSparseMatrix.from_coo(I, J, V, fine_rows, cols, ids="global")


class GMGLevel:
    """One fine level: its operator, the transfers to the next (coarser)
    level (built on first use: the device transfers never read them), the
    grid dims, and the inverse diagonal for Jacobi smoothing. ``P`` and
    ``R`` hand the transfers in directly (the JAX package's keywords) in
    place of the builder ``mk_transfers``."""

    __slots__ = ("A", "_P", "_R", "_mk_transfers", "dinv", "nfs", "ncs", "_S")

    def __init__(self, A: PSparseMatrix, nfs: Optional[Sequence[int]] = None, ncs: Optional[Sequence[int]] = None,
                 mk_transfers=None, *, P: Optional[PSparseMatrix] = None, R: Optional[PSparseMatrix] = None):
        self.A = A
        self._P, self._R = P, R
        self._S = None  # the interpolation stencil the structured device transfers stage (`S`)
        self._mk_transfers = mk_transfers
        self.nfs = tuple(int(n) for n in nfs) if nfs is not None else None
        self.ncs = tuple(int(n) for n in ncs) if ncs is not None else None
        self.dinv = jacobi_preconditioner(A)

    def _build_transfers(self):
        if self._P is None:
            check(self._mk_transfers is not None, "GMGLevel: no transfers and no builder")
            self._P, self._R = self._mk_transfers()

    @property
    def P(self) -> PSparseMatrix:
        self._build_transfers()
        return self._P

    @property
    def S(self) -> PSparseMatrix:
        """The square interpolation stencil of the factored transfer P = S·E
        (`interp_stencil_cartesian`), assembled on first use and kept, so
        every staging of the structured route (per backend, plan and
        strict mode) lowers the same S."""
        if self._S is None:
            self._S = interp_stencil_cartesian(self.nfs, self.A.rows, dtype=self.A.dtype)
        return self._S

    @property
    def R(self) -> PSparseMatrix:
        self._build_transfers()
        return self._R


class GMGHierarchy:
    """The multigrid hierarchy: `levels[k]` holds the level-k operator and
    transfers; the coarsest operator is solved directly by `PLU`. Calling
    the hierarchy applies one V-cycle to a residual (the callable
    preconditioner contract of `pcg`)."""

    def __init__(self, levels: List[GMGLevel], coarse_A: PSparseMatrix, omega: float = 0.8,
                 pre: int = 1, post: int = 1, cycle: str = "v"):
        check(len(levels) >= 1, "hierarchy needs at least one fine level")
        check(cycle in ("v", "w"), "cycle is 'v' or 'w'")
        self.levels = levels
        self.coarse_A = coarse_A
        self.coarse_solver = PLU(coarse_A)
        self.omega = float(omega)
        self.pre = int(pre)
        self.post = int(post)
        self.cycle = cycle

    def _smooth(self, lvl: GMGLevel, b: PVector, x: PVector, sweeps: int):
        """Weighted Jacobi, all owned-region algebra."""
        om = self.omega
        for _ in range(sweeps):
            q = lvl.A @ x
            _owned_zip(x, lambda xv, bv, qv, dv: xv + om * dv * (bv - qv), b, q, lvl.dinv)

    def with_cycle(self, cycle: str) -> "GMGHierarchy":
        """The same levels, coarse operator and smoother under another
        cycle: nothing is assembled again, and the device staging
        (`gpu_gmg.device_hierarchy`, which no cycle changes) is shared;
        the solve functions are the new hierarchy's own."""
        other = GMGHierarchy(self.levels, self.coarse_A, self.omega, self.pre, self.post, cycle)
        other.coarse_solver = self.coarse_solver
        if getattr(self, "_device_cache", None) is None:
            self._device_cache = {}
        other._device_cache = self._device_cache
        return other

    def vcycle(self, b: PVector, x: Optional[PVector] = None, level: int = 0) -> PVector:
        """One multigrid cycle (V or W per ``self.cycle``; pre/post
        smoothing sweeps) for A_level x = b, x defaulting to zero. b lives
        on the level's row range (or anything owned-compatible); the result
        lives on the level's column range. The W-cycle runs a second,
        warm-started pass on the next level wherever that level is not the
        coarsest (models/gmg.py:739-752 of the JAX package)."""
        if level == len(self.levels):
            return self.coarse_solver.solve(b)
        lvl = self.levels[level]
        if x is None:
            x = PVector.full(0.0, lvl.A.cols, dtype=b.dtype)
        self._smooth(lvl, b, x, self.pre)
        # residual on R's column range, so restriction can halo-update it
        q = lvl.A @ x
        r = PVector.full(0.0, lvl.R.cols, dtype=b.dtype)
        _owned_zip(r, lambda _r, bv, qv: bv - qv, b, q)
        rc = lvl.R @ r
        ec = self.vcycle(rc, None, level + 1)
        if self.cycle == "w" and level + 1 < len(self.levels):
            ec = self.vcycle(rc, ec, level + 1)
        # lift the coarse correction onto P's column range and prolongate
        ec_p = PVector.full(0.0, lvl.P.cols, dtype=b.dtype)
        _owned_zip(ec_p, lambda _e, ev: ev, ec)
        _owned_update(x, lambda xv, ev: xv + ev, lvl.P @ ec_p)
        self._smooth(lvl, b, x, self.post)
        return x

    def __call__(self, r: PVector) -> PVector:
        return self.vcycle(r)


def gmg_hierarchy(parts: AbstractPData, A: PSparseMatrix, dims: Sequence[int],
                  coarse_threshold: int = 1000, max_levels: int = 32, omega: float = 0.8,
                  pre: int = 1, post: int = 1, cycle: str = "v",
                  agg_threshold: int = 0) -> GMGHierarchy:
    """Build the variational hierarchy for a Cartesian-grid operator ``A``
    over ``dims`` (A.rows must be the ghost-free Cartesian partition of
    dims, as `assemble_poisson` makes): per level the Galerkin coarse
    operator on the aligned coarse partition (cuts ceil(fine_cut / 2)),
    and the d-linear P and R = Pᵀ built on first use. Coarsening stops once
    the grid has at most ``coarse_threshold`` points or no dimension can
    halve.

    ``agg_threshold`` > 0 agglomerates coarse levels (models/gmg.py:768-830
    of the JAX package): once a level's points per active part drop below
    the threshold, the next coarse partition lives on a 2x-strided
    sub-grid of parts (doubled per level as needed, down to one part), the
    other parts owning empty boxes. The iterations are unchanged; only the
    placement moves."""
    dims = tuple(int(n) for n in dims)
    check(A.rows.ngids == int(np.prod(dims)), "gmg_hierarchy: dims do not match A.rows")
    levels: List[GMGLevel] = []
    A_l, nfs = A, dims
    pshape = parts.shape
    stride = tuple(1 for _ in pshape)
    # per-dim block cuts of the current level's partition: coarse cuts are
    # ceil(fine_cut / 2), so every coarse point's even fine position lies
    # inside its own part's fine box
    firsts = [_block_firsts(n, k).tolist() for n, k in zip(dims, pshape)]
    for _ in range(max_levels):
        if int(np.prod(nfs)) <= coarse_threshold:
            break
        ncs = tuple((n + 1) // 2 for n in nfs)
        if ncs == nfs or min(ncs) < 3:
            break
        if agg_threshold > 0:
            active = tuple(-(-k // s) for k, s in zip(pshape, stride))
            per_part = int(np.prod(ncs)) / max(int(np.prod(active)), 1)
            if per_part < agg_threshold and max(active) > 1:
                # double while more than one active part remains in a dim
                stride = tuple(min(s * 2, k) if k > s else s for s, k in zip(stride, pshape))
        firsts = [[(f + 1) // 2 for f in fd] for fd in firsts]
        coarse_rows = cartesian_partition(
            parts, ncs, no_ghost, part_stride=stride if max(stride) > 1 else None,
            dim_firsts=None if max(stride) > 1 else firsts,
        )
        A_c = galerkin_cartesian(A_l, nfs, ncs, coarse_rows)

        def _mk(nfs=nfs, ncs=ncs, fine_rows=A_l.rows, coarse_rows=coarse_rows, dt=A_l.dtype):
            P = interpolation_cartesian(nfs, ncs, fine_rows, coarse_rows, dtype=dt)
            return P, restriction_from(P, coarse_rows)

        levels.append(GMGLevel(A_l, nfs, ncs, _mk))
        A_l, nfs = A_c, ncs
    check(len(levels) >= 1, "gmg_hierarchy: grid too small to coarsen — use a direct solver")
    return GMGHierarchy(levels, A_l, omega=omega, pre=pre, post=post, cycle=cycle)


def gmg_solve(hierarchy: GMGHierarchy, b: PVector, x0: Optional[PVector] = None,
              tol: float = 1e-8, maxiter: int = 100, verbose: bool = False) -> Tuple[PVector, dict]:
    """Stationary cycle iteration x <- x + cycle(b − A x) (V or W, per the
    hierarchy) until the residual drops by `tol`. On the GPU backend the
    whole iteration runs on the card as one device-resident loop
    (`parallel/gpu_gmg.py:gpu_gmg_solve`, tpu_gmg.py:807-883); on any other
    backend the host loop below."""
    from ..parallel.gpu import GPUBackend

    if isinstance(b.values.backend, GPUBackend):
        from ..parallel.gpu_gmg import gpu_gmg_solve

        return gpu_gmg_solve(hierarchy, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    A = hierarchy.levels[0].A
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    r = PVector.full(0.0, A.cols, dtype=b.dtype)

    def _residual():
        _owned_zip(r, lambda _r, bv, qv: bv - qv, b, A @ x)
        return r.norm()

    rn = _residual()
    rs0 = rn
    history = [rn]
    it = 0
    while rn > tol * max(1.0, rs0) and it < maxiter:
        _owned_update(x, lambda xv, ev: xv + ev, hierarchy.vcycle(r))
        rn = _residual()
        history.append(rn)
        it += 1
        if verbose:
            print(f"gmg it={it} residual={rn:.3e}")
    return x, {
        "iterations": it,
        "residuals": np.array(history),
        "converged": rn <= tol * max(1.0, rs0),
    }
