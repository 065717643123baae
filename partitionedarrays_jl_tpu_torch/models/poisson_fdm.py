"""3-D (or N-D) Poisson finite-difference driver.

The port's copy of `partitionedarrays_jl_tpu/models/poisson_fdm.py`: a
7-point Laplacian on an N-D Cartesian grid, Dirichlet boundary conditions
imposed as identity rows, solved with CG against a manufactured solution.
Box partitions assemble COO-free (`_try_stencil_fast`, poisson_fdm.py:150
of the JAX package): each part's CSR straight from its box geometry and
b = A x̂ in the same pass, by the port's native layer
(`native.stencil_emit`), with the geometric ghost slabs as the column
ghost layer; the generic COO assembly (`_assemble_stencil_coo`) takes the
rest and every system with `native.STENCIL_FAST` off. And the shifted torus
Laplacian of `assemble_poisson_periodic` (poisson_fdm.py:445), whose column
ghosts are the wrapped face slabs. On the GPU backend the
operator lowers to the coded-DIA kernels and the CG loop runs on the card.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from .. import native
from ..ops.sparse import CSRMatrix
from ..parallel.backends import AbstractPData, map_parts
from ..parallel.collectives import gather_all
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


def stencil_ghost_slabs(lo, hi, ns) -> np.ndarray:
    """Sorted gids of the column ghost layer a Dirichlet-identity +-1
    stencil touches from an owned box [lo, hi): per dimension d, the face
    slab one cell outside the box, restricted to the coordinates where the
    adjacent owned cell is grid-interior (boundary rows are identity: they
    reach nobody). Slabs of different dimensions are disjoint (each lies
    outside the box in its own dimension only), so a plain sort of their
    concatenation is the sorted ghost set."""
    dim = len(ns)
    inter = [(max(l, 1), min(h, n - 1)) for l, h, n in zip(lo, hi, ns)]
    slabs = []
    for d in range(dim):
        sides = []
        if 1 <= lo[d] <= ns[d] - 2:  # the owned cell at lo[d] can be interior
            sides.append(lo[d] - 1)
        if 2 <= hi[d] <= ns[d] - 1:  # the owned cell at hi[d]-1 can be interior
            sides.append(hi[d])
        for coord in sides:
            ranges = [np.arange(a, b) for a, b in inter]
            ranges[d] = np.array([coord])
            if any(len(rg) == 0 for rg in ranges):
                continue
            mg = np.meshgrid(*ranges, indexing="ij")
            slabs.append(np.ravel_multi_index(tuple(m.ravel() for m in mg), ns))
    if not slabs:
        return np.empty(0, dtype=np.int64)
    return np.sort(np.concatenate(slabs))


def _try_stencil_fast(rows, ns, center, arm_coefs, dtype, decoupled, want_b=False):
    """COO-free structured assembly (poisson_fdm.py:150-266 of the JAX
    package): where every part is a Cartesian box within the int32
    envelope, emit each part's owned-row CSR with local column ids
    straight from the box geometry (planning.cpp `stencil_emit_dim`) and
    build the column PRange from the geometric ghost slabs: no
    volume-sized triplets, no gid -> lid passes, no compression. With
    ``want_b`` the same pass evaluates b = A x̂ against the manufactured
    field's per-dimension tables (the host's two-phase product's bits).
    ``decoupled`` emits the `decouple_dirichlet`'d operator (couplings of
    interior rows to boundary columns zeroed, pattern kept), whose b̂ is
    then Â x̂ exactly. Returns ``(A, b_owned)`` (b_owned None without
    ``want_b``), or None where ineligible: `native.STENCIL_FAST` or the
    native layer off, more than 3 dimensions, another dtype than f32/f64,
    a part without box metadata or past ``no * (2 dim + 1) < 2^31``.

    ``native.PLAN_PROCS`` > 1 emits each part with that many spawned
    workers over row slabs (`native/parallel_emit.py`, byte-identical);
    a failure there raises (the JAX package warns and plans serially)."""
    dim = len(ns)
    if (
        not native.STENCIL_FAST
        or not native.available()
        or dim > 3
        or np.dtype(dtype).name not in ("float64", "float32")
    ):
        return None

    def _ok(iset):
        if not (hasattr(iset, "box_lo") and getattr(iset, "grid_shape", None) == ns):
            return 0
        return int(math.prod(iset.box_shape) * (2 * dim + 1) < 2**31)

    flags = gather_all(map_parts(_ok, rows.partition))
    if not bool(np.all(np.asarray(flags.part_values()[0]))):
        return None
    ghosts = map_parts(lambda i: stencil_ghost_slabs(i.box_lo, i.box_hi, ns), rows.partition)
    cols = add_gids(rows, ghosts)
    arm_vals = np.array([c for pair in arm_coefs for c in pair], dtype=np.float64)
    xtab = (
        np.concatenate([
            np.sin(0.5 + (d + 1.0) * np.arange(ns[d], dtype=np.int64) / (ns[d] + 1.0))
            for d in range(dim)
        ])
        if want_b
        else None
    )
    procs = int(native.PLAN_PROCS)

    def _emit(iset, gg):
        res = None
        if procs > 1:
            from ..native.parallel_emit import stencil_emit_parallel

            res = stencil_emit_parallel(
                ns, iset.box_lo, iset.box_hi, center, arm_vals, gg, dtype, procs,
                decouple=decoupled, xtab=xtab,
            )
        if res is None:
            res = native.stencil_emit(
                ns, iset.box_lo, iset.box_hi, center, arm_vals, gg, dtype, decouple=decoupled, xtab=xtab
            )
        check(res is not None, "stencil_emit declined after the eligibility check")
        no = math.prod(iset.box_shape)
        M = CSRMatrix(res[0], res[1], res[2], (no, no + len(gg)))
        return M, (res[3] if want_b else None)

    out = map_parts(_emit, rows.partition, ghosts)
    values = map_parts(lambda o: o[0], out)
    b_owned = map_parts(lambda o: o[1], out) if want_b else None
    return PSparseMatrix(values, rows, cols), b_owned


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
    zeroed, pattern kept, b made consistent).

    Box partitions take the COO-free assembly (`_try_stencil_fast`), which
    emits A and b (Â and b̂ = Â x̂ when decoupled) in one pass and numbers
    each part's ghost columns in gid order; the COO route
    (`_assemble_stencil_coo`, then b by `manufactured_rhs` and
    `decouple_dirichlet`) numbers them in first-touch order and takes
    every other partition, and every system with `native.STENCIL_FAST`
    off. The two routes' global triplets, b and x̂ are the same values."""
    ns = tuple(int(n) for n in ns)
    check(len(arm_coefs) == len(ns), "one (minus, plus) coefficient pair per dim")
    rows = cartesian_partition(parts, ns, no_ghost)
    fast = _try_stencil_fast(rows, ns, center, arm_coefs, dtype, decoupled, want_b=True)
    if fast is not None:
        A, b_owned = fast
    else:
        A = _assemble_stencil_coo(parts, rows, ns, center, arm_coefs, dtype)
    cols = A.cols
    xe_vals = map_parts(
        lambda i: _manufactured_on_iset(i, ns).astype(dtype, copy=False),
        cols.partition,
    )
    x_exact = PVector(xe_vals, cols)
    if fast is not None:
        # b from the emission, on the (ghost-free) rows as the COO route's
        # product puts it (the JAX package's lives on the cols, its ghost
        # slots 0: the same owned values)
        b = PVector(b_owned, rows)
    else:
        b = manufactured_rhs(A, x_exact)
    if decoupled and fast is None:
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
