"""The port's host direct and incomplete-factorisation preconditioners
(`lu`/`PLU`, `direct_solve`, `block_jacobi_ilu`, `block_jacobi_ic0`,
`additive_schwarz` in both modes and with both factors) against the JAX
package (tests/test_solvers.py:174, :366-507, :636-760).

Each scenario is written once against a package namespace and run on the
JAX package's sequential backend and on the port's sequential backend and
``GPUBackend(device="cpu")`` (a callable preconditioner runs the host loop
on every backend). The operators are the JAX package's bit for bit (the
elasticity and Poisson assemblies), the factorisations the same SciPy
`spilu` and the same IC(0) algorithm, so the gates are the JAX tests' own
(convergence, errors, iteration orderings) and iterations equal to the
JAX package's, solutions to atol 1e-10 of its.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")
BACKENDS = {"sequential": pt.sequential, "gpu": CPU}


def _err(m, x, xe):
    return float(np.abs(m.gather_pvector(x) - m.gather_pvector(xe)).max())


def _both(driver, grid):
    """driver(m, parts) on the JAX package's sequential backend and the
    port's two backends."""
    out = {"jax": pa.prun(lambda p: driver(pa, p), pa.sequential, grid)}
    for k, be in BACKENDS.items():
        out[k] = pt.prun(lambda p: driver(pt, p), be, grid)
    return out


def test_plu_and_direct_solve():
    """tests/test_solvers.py:174: `lu` factors once and solves many
    right-hand sides; `refactorize` takes a rescaled operator; `direct_solve`
    is the dense solve. Solutions within 1e-9 of the exact ones and of the
    JAX package's to 1e-12."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (5, 5, 5))
        F = m.lu(A)
        x1 = F.solve(b)
        b2 = A @ (xe * 2.0)
        x2 = F.solve(b2)
        F.refactorize(m.PSparseMatrix(m.map_parts(lambda M: type(M)(M.indptr, M.indices, 2.0 * M.data, M.shape),
                                                  A.values), A.rows, A.cols))
        x3 = F.solve(b2)
        x4 = m.direct_solve(A, b)
        assert isinstance(F, m.PLU)
        return [m.gather_pvector(v) for v in (x1, x2, x3, x4, xe)]

    r = _both(driver, (2, 2, 2))
    for k in ("sequential", "gpu"):
        x1, x2, x3, x4, xe = r[k]
        for got, want in ((x1, xe), (x2, 2 * xe), (x3, xe), (x4, xe)):
            assert np.linalg.norm(got - want) < 1e-9
        for got, want in zip(r[k], r["jax"]):
            np.testing.assert_allclose(got, want, atol=1e-12)


def test_block_jacobi_ilu():
    """tests/test_solvers.py:366: ILUT blocks on the 5^3 tet-elasticity
    fixture, 4 parts, tol 1e-10: converged, no more iterations than
    point-Jacobi PCG, max error < 1e-6; the JAX package's iterations."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_elasticity_tet(parts, (5, 5, 5))
        x, info = m.pcg(A, b, x0=x0, minv=m.block_jacobi_ilu(A), tol=1e-10)
        _, ij = m.pcg(A, b, x0=x0, tol=1e-10)
        return info["iterations"], info["converged"], ij["iterations"], _err(m, x, xe), m.gather_pvector(x)

    r = _both(driver, 4)
    for k in ("sequential", "gpu"):
        it, conv, itj, err, x = r[k]
        assert conv and it <= itj and err < 1e-6, (k, it, itj, err)
        assert it == r["jax"][0]
        np.testing.assert_allclose(x, r["jax"][4], atol=1e-10)


def test_additive_schwarz_modes():
    """tests/test_solvers.py:432: 6^3 tet elasticity on 8 parts. ASM (ILUT)
    PCG converges within 5 iterations of block-Jacobi ILU, max error <
    1e-7; RAS GMRES(30) converges in fewer iterations than block-Jacobi
    GMRES, max error < 1e-6; the JAX package's iterations."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_elasticity_tet(parts, (6, 6, 6))
        asm = m.additive_schwarz(A)
        ras = m.additive_schwarz(A, mode="ras")
        bj = m.block_jacobi_ilu(A)
        xa, ia = m.pcg(A, b, x0=x0, minv=asm, tol=1e-10)
        _, ib = m.pcg(A, b, x0=x0, minv=bj, tol=1e-10)
        xr, ir = m.gmres(A, b, x0=x0, restart=30, tol=1e-10, minv=ras)
        _, ig = m.gmres(A, b, x0=x0, restart=30, tol=1e-10, minv=bj)
        return (ia["iterations"], ia["converged"], ib["iterations"], _err(m, xa, xe),
                ir["iterations"], ir["converged"], ig["iterations"], _err(m, xr, xe))

    r = _both(driver, 8)
    for k in ("sequential", "gpu"):
        ita, ca, itb, ea, itr, cr, itg, er = r[k]
        assert ca and ita <= itb + 5 and ea < 1e-7, (k, r[k])
        assert cr and itr < itg and er < 1e-6, (k, r[k])
        assert (ita, itb, itr, itg) == tuple(r["jax"][i] for i in (0, 2, 4, 6)), (k, r[k], r["jax"])


def test_additive_schwarz_single_part_degenerates_to_exact():
    """tests/test_solvers.py:468: one part, fill factor 50: PCG converges in
    at most 3 iterations."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (6, 6, 6))
        x, info = m.pcg(A, b, x0=x0, minv=m.additive_schwarz(A, fill_factor=50), tol=1e-10)
        return info["iterations"], info["converged"]

    r = _both(driver, (1, 1, 1))
    for k in ("sequential", "gpu"):
        assert r[k][1] and r[k][0] <= 3 and r[k][0] == r["jax"][0]


def test_block_jacobi_ic0():
    """tests/test_solvers.py:636: IC(0) blocks on the decoupled 8^3 Poisson,
    (2,2,1), tol 1e-10: converged, no more iterations than point-Jacobi,
    max error < 1e-6; the factor equals the JAX package's native IC(0) and
    the iterations its."""
    from partitionedarrays_jl_tpu import native
    from partitionedarrays_jl_tpu_torch.models.solvers import ic0_lower

    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (8, 8, 8))
        Ah, bh = m.decouple_dirichlet(A, b)
        x, info = m.pcg(Ah, bh, minv=m.block_jacobi_ic0(Ah), tol=1e-10)
        _, ij = m.pcg(Ah, bh, minv=m.jacobi_preconditioner(Ah), tol=1e-10)
        M = Ah.owned_owned_values.part_values()[0]
        return info["iterations"], info["converged"], ij["iterations"], _err(m, x, xe), m.gather_pvector(x), M

    r = _both(driver, (2, 2, 1))
    for k in ("sequential", "gpu"):
        it, conv, itj, err, x, _ = r[k]
        assert conv and it <= itj and err < 1e-6, (k, r[k][:4])
        assert it == r["jax"][0]
        np.testing.assert_allclose(x, r["jax"][4], atol=1e-10)
    M = r["jax"][5]
    rr = M.row_of_nz()
    keep = M.indices <= rr
    from partitionedarrays_jl_tpu.ops.sparse import compresscoo

    L = compresscoo(rr[keep], M.indices[keep], M.data[keep].astype(np.float64), M.shape[0], M.shape[0])
    lv, fail = ic0_lower(L.indptr, L.indices, L.data, M.shape[0])
    jv, jfail = native.ic0(L.indptr, L.indices, L.data, M.shape[0])
    assert fail == jfail == -1
    np.testing.assert_allclose(lv, jv, rtol=1e-14)


def test_ic0_refusals_and_exact_factor():
    """tests/test_solvers.py:660, :674, :707: IC(0) refuses a nonsymmetric
    block (ValueError) and an indefinite one (LinAlgError), and on a dense
    SPD pattern is the Cholesky factor (PCG in at most 2 iterations)."""
    def nonsym(parts):
        A = pt.assemble_elasticity_tet(parts, (4, 4, 4))[0]
        with pytest.raises(ValueError, match="not symmetric"):
            pt.block_jacobi_ic0(A)
        return True

    def dense(parts):
        n = 12
        rows = pt.uniform_partition(parts, n)
        rng = np.random.default_rng(3)
        C = rng.standard_normal((n, n))
        S = C @ C.T + n * np.eye(n)
        coo = pt.map_parts(lambda i: (np.repeat(np.asarray(i.oid_to_gid), n),
                                      np.tile(np.arange(n, dtype=np.int64), i.num_oids),
                                      S[np.asarray(i.oid_to_gid)].ravel()), rows.partition)
        J = pt.map_parts(lambda c: c[1], coo)
        A = pt.PSparseMatrix.from_coo(pt.map_parts(lambda c: c[0], coo), J, pt.map_parts(lambda c: c[2], coo),
                                      rows, pt.add_gids(rows, J), ids="global")
        x, info = pt.pcg(A, pt.PVector.full(1.0, rows), minv=pt.block_jacobi_ic0(A), tol=1e-10)
        assert info["converged"] and info["iterations"] <= 2, info
        return True

    def indefinite(parts):
        n = 8
        rows = pt.uniform_partition(parts, n)
        coo = pt.map_parts(lambda i: (np.asarray(i.oid_to_gid), np.asarray(i.oid_to_gid),
                                      np.where(np.asarray(i.oid_to_gid) == n - 1, -1.0, 1.0)), rows.partition)
        J = pt.map_parts(lambda c: c[1], coo)
        A = pt.PSparseMatrix.from_coo(pt.map_parts(lambda c: c[0], coo), J, pt.map_parts(lambda c: c[2], coo),
                                      rows, pt.add_gids(rows, J), ids="global")
        with pytest.raises(np.linalg.LinAlgError):
            pt.block_jacobi_ic0(A)
        return True

    for be in BACKENDS.values():
        assert pt.prun(nonsym, be, 2)
        assert pt.prun(dense, be, 1)
        assert pt.prun(indefinite, be, 2)


def test_additive_schwarz_ic0_symmetric_for_pcg():
    """tests/test_solvers.py:729: ASM with IC(0) blocks on the decoupled
    16^2 Poisson, (2,2): PCG converges in no more iterations than
    point-Jacobi, max error < 1e-6; the JAX package's iterations. The
    knob checks refuse a drop_tol with IC(0) and a shift with ILUT."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (16, 16))
        Ah, bh = m.decouple_dirichlet(A, b)
        x, info = m.pcg(Ah, bh, minv=m.additive_schwarz(Ah, mode="asm", factor="ic0"), tol=1e-10)
        _, ic = m.pcg(Ah, bh, minv=m.jacobi_preconditioner(Ah), tol=1e-10)
        if m is pt:
            with pytest.raises(AssertionError):
                m.additive_schwarz(Ah, factor="ic0", drop_tol=1e-3)
            with pytest.raises(AssertionError):
                m.additive_schwarz(Ah, shift=0.1)
        return info["iterations"], info["converged"], ic["iterations"], _err(m, x, xe)

    r = _both(driver, (2, 2))
    for k in ("sequential", "gpu"):
        it, conv, itj, err = r[k]
        assert conv and it <= itj and err < 1e-6 and it == r["jax"][0], (k, r[k], r["jax"])
