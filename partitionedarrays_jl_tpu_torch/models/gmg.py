"""Distributed geometric multigrid (variational V-cycle) on Cartesian
partitions: the host hierarchy.

The port's copy of `partitionedarrays_jl_tpu/models/gmg.py`. The
interpolation P is an ordinary rectangular `PSparseMatrix` (fine rows x
coarse cols), R = Pᵀ, and the Galerkin coarse operator A_c = Pᵀ A P is the
exact triple product of per-part local SciPy products whose off-owner
triplets ride the COO assembly migration (`assemble_matrix_from_coo`). The
JAX package's native Galerkin fast paths (planning.cpp `galerkin3`,
`galerkin_emit`, `galerkin_classify`) are not ported (ROADMAP Queue 1 item 8):
every part takes the generic route. ``cycle="w"`` gives the W-cycle (a
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

from ..parallel.backends import AbstractPData, map_parts
from ..parallel.prange import PRange, _block_firsts, add_gids, cartesian_partition, no_ghost
from ..parallel.psparse import PSparseMatrix, assemble_matrix_from_coo
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


def galerkin_cartesian(A: PSparseMatrix, nfs: Sequence[int], ncs: Sequence[int],
                       coarse_rows: PRange) -> PSparseMatrix:
    """Exact distributed A_c = Pᵀ A P for the Cartesian d-linear P
    (gmg.py:530-560 of the JAX package, its generic route). P rows for
    every fine lid of A's column range (owned and ghost) are recomputed
    locally from grid arithmetic, so no P rows are exchanged; each part's
    Σ_{owned fine rows i} P[i,:]ᵀ (A P)[i,:] sums to the exact product
    because fine rows are disjointly owned, and the coarse triplets then
    migrate to their row owners."""
    nfs = tuple(int(n) for n in nfs)
    ncs = tuple(int(n) for n in ncs)
    check(
        int(np.prod(ncs)) == coarse_rows.ngids,
        "galerkin_cartesian: coarse grid does not match coarse_rows",
    )

    def _local(ri, ci, M):
        from scipy.sparse import csr_matrix

        fg = np.asarray(ci.lid_to_gid, dtype=np.int64)
        lid = np.arange(len(fg), dtype=np.int64)
        li, pj, pv = _interp_rows(lid, fg, nfs, ncs)
        cgid, cinv = np.unique(pj, return_inverse=True)
        P_ext = csr_matrix((pv, (li, cinv)), shape=(len(fg), len(cgid)))
        Q = _scipy_csr(M) @ P_ext  # owned fine rows x local coarse
        T = (P_ext[: ri.num_oids].T @ Q).tocoo()  # local coarse x local coarse
        return cgid[T.row], cgid[T.col], T.data.astype(M.data.dtype, copy=False)

    coo = map_parts(_local, A.rows.partition, A.cols.partition, A.values)
    I, J, V = (map_parts(lambda c, k=k: c[k], coo) for k in range(3))
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
