"""3-D (or N-D) Poisson finite-difference driver.

The port's copy of `partitionedarrays_jl_tpu/models/poisson_fdm.py`
through its generic COO assembly (`_assemble_stencil_coo`, poisson_fdm.py:352;
the native structured fast path is not part of the port): a 7-point
Laplacian on an N-D Cartesian grid, Dirichlet boundary conditions imposed as
identity rows, assembled into a PSparseMatrix from per-part COO batches and
solved with CG against a manufactured solution; and the shifted torus
Laplacian of `assemble_poisson_periodic` (poisson_fdm.py:445), whose column
ghosts are the wrapped face slabs. On the GPU backend the
operator lowers to the coded-DIA kernels and the CG loop runs on the card.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ..parallel.backends import AbstractPData, map_parts
from ..parallel.prange import add_gids, cartesian_partition, no_ghost, p_cartesian_indices
from ..parallel.psparse import PSparseMatrix
from ..parallel.pvector import PVector
from ..utils.helpers import check
from .solvers import cg


def manufactured_rhs(A: PSparseMatrix, x: PVector) -> PVector:
    """b = A @ x with every block row folded left to right (the A_oo fold,
    then the A_oh fold added: `mul_into(strict=True)`), the order of the
    JAX package's native host SpMV (planning.cpp `csr_spmv_impl`, built
    without FMA contraction), which its drivers take for b; NumPy's
    `reduceat` (the plain host product) sums in another order. So the
    models' systems are the JAX package's bit for bit."""
    return A.mul_into(PVector.full(0.0, A.rows, dtype=np.result_type(A.dtype, x.dtype)), x, strict=True)


def manufactured_solution(gids: np.ndarray, ngids: Sequence[int]) -> np.ndarray:
    """A smooth deterministic field evaluated at cells: the target x̂ the
    solve must reproduce (the reference manufactures x̂ the same way —
    test/test_fdm.jl:52-81 — with a different formula). The field is
    separable-additive (one sin per dimension), so each dimension's
    contribution is evaluated once per COORDINATE (n_d sins) and gathered
    — bit-identical to the elementwise form (same scalar ops on the same
    inputs, same per-element addition order), ~20x cheaper at 1e8 cells."""
    coords = np.unravel_index(np.asarray(gids, dtype=np.int64), tuple(ngids))
    val = np.zeros(np.shape(gids), dtype=np.float64)
    for d, c in enumerate(coords):
        table = np.sin(
            0.5 + (d + 1.0) * np.arange(ngids[d], dtype=np.int64) / (ngids[d] + 1.0)
        )
        val += table[c]
    return val


def _manufactured_on_iset(iset, ns) -> np.ndarray:
    """x̂ over one part's lids. Box partitions skip the volume-sized
    `unravel_index` divmods: the additive-separable field is evaluated
    per COORDINATE RANGE and broadcast-summed over the owned box (same
    scalar ops, same per-element addition order — bit-identical to the
    gid path, which still serves the O(surface) ghost tail)."""
    ns = tuple(ns)
    if not (
        hasattr(iset, "box_lo") and getattr(iset, "grid_shape", None) == ns
    ):
        return manufactured_solution(iset.lid_to_gid, ns)
    dim = len(ns)
    per = [
        np.sin(
            0.5
            + (d + 1.0)
            * np.arange(iset.box_lo[d], iset.box_hi[d], dtype=np.int64)
            / (ns[d] + 1.0)
        )
        for d in range(dim)
    ]
    shape = [1] * dim
    shape[0] = -1
    out = per[0].reshape(shape)
    for d in range(1, dim):
        shape = [1] * dim
        shape[d] = -1
        out = out + per[d].reshape(shape)
    owned = np.ascontiguousarray(out).ravel()
    ghost = manufactured_solution(iset.lid_to_gid[iset.num_oids :], ns)
    return np.concatenate([owned, ghost]) if len(ghost) else owned


def _boundary_mask_on_iset(iset, ns) -> np.ndarray:
    """Per-lid grid-boundary mask, with the same box broadcast shortcut
    as `_manufactured_on_iset`."""
    ns = tuple(ns)
    dim = len(ns)
    if not (
        hasattr(iset, "box_lo") and getattr(iset, "grid_shape", None) == ns
    ):
        coords = np.unravel_index(iset.lid_to_gid, ns)
        mask = np.zeros(iset.num_lids, dtype=bool)
        for d in range(dim):
            mask |= (coords[d] == 0) | (coords[d] == ns[d] - 1)
        return mask
    out = np.zeros((1,) * dim, dtype=bool)
    for d in range(dim):
        c = np.arange(iset.box_lo[d], iset.box_hi[d], dtype=np.int64)
        shape = [1] * dim
        shape[d] = -1
        out = out | ((c == 0) | (c == ns[d] - 1)).reshape(shape)
    owned = np.broadcast_to(out, iset.box_shape).ravel()
    g = iset.lid_to_gid[iset.num_oids :]
    if not len(g):
        return owned
    coords = np.unravel_index(np.asarray(g, dtype=np.int64), ns)
    gm = np.zeros(len(g), dtype=bool)
    for d in range(dim):
        gm |= (coords[d] == 0) | (coords[d] == ns[d] - 1)
    return np.concatenate([owned, gm])


def assemble_cartesian_stencil(
    parts: AbstractPData,
    ns: Sequence[int],
    center: float,
    arm_coefs: Sequence[Sequence[float]],
    dtype=np.float64,
    decoupled: bool = False,
):
    """Assemble the Dirichlet-identity Cartesian stencil operator whose
    interior rows carry `center` on the diagonal and, per dimension d,
    ``arm_coefs[d] = (coef_minus, coef_plus)`` on the -+1 neighbors;
    boundary cells are identity rows. Returns (A, b, x̂, x0) with
    b = A @ x̂ and x0 carrying the exact boundary values. ``dtype``
    assembles directly in the target precision. ``decoupled`` returns the
    `decouple_dirichlet`'d system instead (interior -> boundary couplings
    zeroed, pattern kept, b made consistent): the JAX package's COO path."""
    ns = tuple(int(n) for n in ns)
    check(len(arm_coefs) == len(ns), "one (minus, plus) coefficient pair per dim")
    rows = cartesian_partition(parts, ns, no_ghost)
    A = _assemble_stencil_coo(parts, rows, ns, center, arm_coefs, dtype)
    cols = A.cols
    xe_vals = map_parts(
        lambda i: _manufactured_on_iset(i, ns).astype(dtype, copy=False),
        cols.partition,
    )
    x_exact = PVector(xe_vals, cols)
    b = manufactured_rhs(A, x_exact)
    if decoupled:
        from .solvers import decouple_dirichlet

        A, b = decouple_dirichlet(A, b)
    # start vector with the Dirichlet values imposed exactly: identity rows
    # then keep a zero residual throughout the iteration
    x0 = PVector(
        map_parts(
            lambda i, xv: np.where(_boundary_mask_on_iset(i, ns), xv, 0).astype(dtype, copy=False),
            cols.partition,
            xe_vals,
        ),
        cols,
    )
    return A, b, x_exact, x0


def _assemble_stencil_coo(parts, rows, ns, center, arm_coefs, dtype):
    """The generic COO assembly pipeline (any partition shape): generate
    per-part triplet batches, discover ghosts from J, compress."""
    dim = len(ns)
    cis = p_cartesian_indices(parts, ns, no_ghost)

    def _local_coo(ci):
        grid = ci.grid()  # per-dim global coords of owned cells, ij order
        coords = [g.ravel() for g in grid]
        gid = np.ravel_multi_index(coords, ns)
        interior = np.ones(len(gid), dtype=bool)
        for d in range(dim):
            interior &= (coords[d] > 0) & (coords[d] < ns[d] - 1)
        # preallocate the full triplet batch and fill arm by arm: at 1e8
        # DOFs the concatenate-of-arms version spends half the assembly
        # copying (2*dim+2 growing temporaries of up to nnz elements)
        gb = gid[~interior]
        gi = gid[interior]
        nb_, ni = len(gb), len(gi)
        total = nb_ + ni * (2 * dim + 1)
        # int32 triplets whenever the grid fits: halves COO memory and
        # lets every planning kernel (box lookup, dedup, compresscoo)
        # run conversion-copy-free at 1e8 DOFs
        idt = np.int32 if math.prod(ns) < 2**31 else np.int64
        I = np.empty(total, dtype=idt)
        J = np.empty(total, dtype=idt)
        V = np.empty(total, dtype=dtype)
        # boundary: identity rows (Dirichlet)
        I[:nb_] = gb
        J[:nb_] = gb
        V[:nb_] = 1.0
        I[nb_:] = np.tile(gi, 2 * dim + 1)
        pos = nb_
        J[pos : pos + ni] = gi
        V[pos : pos + ni] = center
        pos += ni
        # interior rows never wrap, so the ±1 neighbor in dim d is a flat
        # C-order stride add — no per-arm ravel_multi_index pass
        strides = [int(np.prod(ns[d + 1 :], dtype=np.int64)) for d in range(dim)]
        for d in range(dim):
            for off, coef in zip((-1, 1), arm_coefs[d]):
                np.add(gi, off * strides[d], out=J[pos : pos + ni])
                V[pos : pos + ni] = coef
                pos += ni
        return I, J, V

    coo = map_parts(_local_coo, cis)
    I = map_parts(lambda c: c[0], coo)
    J = map_parts(lambda c: c[1], coo)
    V = map_parts(lambda c: c[2], coo)

    cols = add_gids(rows, J)  # discover the stencil's column ghost layer
    return PSparseMatrix.from_coo(I, J, V, rows, cols, ids="global")


def assemble_poisson(parts: AbstractPData, ns: Sequence[int], dtype=np.float64, decoupled: bool = False):
    """Build the N-D Laplacian PSparseMatrix + manufactured (x̂, b).

    Returns (A, b, x_exact, x0) with rows a ghost-free Cartesian partition
    of cells, cols the rows plus the stencil's column ghost layer
    (`add_gids`), and b = A @ x̂, so `cg` must return x̂. ``decoupled`` as
    in `assemble_cartesian_stencil`."""
    ns = tuple(int(n) for n in ns)
    dim = len(ns)
    return assemble_cartesian_stencil(
        parts, ns, 2.0 * dim, [(-1.0, -1.0)] * dim, dtype=dtype, decoupled=decoupled
    )


def _periodic_field_on_iset(iset, ns):
    """Smooth periodic manufactured field on every lid of an index set:
    x̂(c) = Σ_d sin(2π(d+1)(c_d + 0.5)/ns[d]) — continuous across the
    wrap, so b = A @ x̂ exercises the torus couplings."""
    g = np.asarray(iset.lid_to_gid, dtype=np.int64)
    coords = np.unravel_index(g, ns)
    out = np.zeros(len(g), dtype=np.float64)
    for d, c in enumerate(coords):
        out += np.sin(2.0 * np.pi * (d + 1.0) * (c + 0.5) / ns[d])
    return out


def assemble_poisson_periodic(
    parts: AbstractPData,
    ns: Sequence[int],
    shift: float = 1.0,
    dtype=np.float64,
):
    """Shifted TORUS Laplacian: (2·dim + shift) on the diagonal, −1 arms
    wrapping in EVERY dimension — no boundary, no identity rows
    (``shift`` > 0 keeps the operator SPD and nonsingular; the pure torus
    Laplacian has the constant nullspace). Returns (A, b, x̂, x0) with
    b = A @ x̂ for the periodic manufactured field and x0 = 0.

    The §5.7 long-context analog at the OPERATOR level (the halo side is
    the periodic PRange): the column ghosts are the wrapped face slabs,
    so every device plan built on A.cols carries torus segments.
    Reference wrap machinery: src/Interfaces.jl:1195-1223."""
    ns = tuple(int(n) for n in ns)
    dim = len(ns)
    check(shift > 0, "assemble_poisson_periodic: shift must be > 0 (SPD)")
    check(
        all(n >= 3 for n in ns),
        "assemble_poisson_periodic: each dim needs >= 3 cells (a ±1 wrap "
        "on 2 cells would duplicate COO entries)",
    )
    rows = cartesian_partition(parts, ns, no_ghost)
    cis = p_cartesian_indices(parts, ns, no_ghost)
    center = 2.0 * dim + float(shift)

    def _local_coo(ci):
        grid = ci.grid()
        coords = [g.ravel() for g in grid]
        gid = np.ravel_multi_index(coords, ns)
        n_own = len(gid)
        idt = np.int32 if math.prod(ns) < 2**31 else np.int64
        total = n_own * (2 * dim + 1)
        I = np.empty(total, dtype=idt)
        J = np.empty(total, dtype=idt)
        V = np.empty(total, dtype=dtype)
        I[:] = np.tile(gid.astype(idt), 2 * dim + 1)
        J[:n_own] = gid
        V[:n_own] = center
        pos = n_own
        for d in range(dim):
            for off in (-1, 1):
                nb = list(coords)
                nb[d] = (coords[d] + off) % ns[d]  # the wrap
                J[pos : pos + n_own] = np.ravel_multi_index(nb, ns)
                V[pos : pos + n_own] = -1.0
                pos += n_own
        return I, J, V

    coo = map_parts(_local_coo, cis)
    I = map_parts(lambda c: c[0], coo)
    J = map_parts(lambda c: c[1], coo)
    V = map_parts(lambda c: c[2], coo)
    cols = add_gids(rows, J)
    A = PSparseMatrix.from_coo(I, J, V, rows, cols, ids="global")
    xe_vals = map_parts(
        lambda i: _periodic_field_on_iset(i, ns).astype(dtype, copy=False),
        A.cols.partition,
    )
    xe = PVector(xe_vals, A.cols)
    b = manufactured_rhs(A, xe)
    x0 = PVector.full(0.0, A.cols, dtype=dtype)
    return A, b, xe, x0


def poisson_fdm_driver(
    parts: AbstractPData,
    ns: Sequence[int] = (10, 10, 10),
    tol: float = 1e-10,
    maxiter: int = 2000,
    verbose: bool = False,
) -> Tuple[float, dict]:
    """End-to-end: assemble, CG-solve, return (error vs x̂, cg info).
    The correctness gate is error < 1e-5 (reference: test/test_fdm.jl:118)."""
    A, b, x_exact, x0 = assemble_poisson(parts, ns)
    x, info = cg(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    err = (x - x_exact).norm()
    return float(err), info
