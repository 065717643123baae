"""The port's LOBPCG (the device loop `parallel/gpu_lobpcg.py` and the host
loop `models/solvers.py:lobpcg`) against the JAX package
(tests/test_solvers.py:509, :566, :824) on ``GPUBackend(device="cpu")``
and the port's sequential backend.

Gates: the 1-D Laplacian's closed-form eigenvalues to rtol 1e-7, the
device eigenvalues against the host loop's and the JAX package's (device
and host) to rtol 1e-8, the residual of the first pair below 1e-5, a
callable preconditioner (ILU blocks) in fewer than half the iterations, and
the GMG-preconditioned solve converged, within rtol 1e-5 of a Jacobi host
solve at tol 1e-9 and in no more iterations than the unpreconditioned one.
The host loop is the JAX package's host loop step for step: its
iterations equal.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import STATS, GPUBackend

CPU = GPUBackend(device="cpu")
N = 40
TH = np.pi / (N + 1)


def _stencil_1d(m, parts, n, diag, off_val=-1.0):
    """tridiag(off_val, diag, off_val) over a 1-D block partition
    (tests/test_solvers.py:_stencil_1d), written against a package
    namespace."""
    rows = m.prange(parts, n)

    def coo(i):
        g = np.asarray(i.oid_to_gid)
        I, J, V = [g], [g], [np.full(len(g), diag)]
        for off in (-1, 1):
            gj = g + off
            k = (gj >= 0) & (gj < n)
            I.append(g[k])
            J.append(gj[k])
            V.append(np.full(int(k.sum()), off_val))
        return np.concatenate(I), np.concatenate(J), np.concatenate(V)

    c = m.map_parts(coo, rows.partition)
    cols = m.add_gids(rows, m.map_parts(lambda t: t[1], c))
    return m.PSparseMatrix.from_coo(m.map_parts(lambda t: t[0], c), m.map_parts(lambda t: t[1], c),
                                    m.map_parts(lambda t: t[2], c), rows, cols, ids="global")


def _pairs(m, parts, **kw):
    A = _stencil_1d(m, parts, N, 2.0)
    lam, X, info = m.lobpcg(A, tol=1e-6, maxiter=300, **kw)
    r0 = np.linalg.norm(m.gather_pvector(A @ X[0]) - lam[0] * m.gather_pvector(X[0]))
    return lam, info["iterations"], info["converged"], r0


@pytest.mark.parametrize("backend", ["sequential", "gpu"])
def test_lobpcg_known_spectrum(backend):
    """tests/test_solvers.py:509: the 3 smallest and 2 largest eigenvalues
    of tridiag(-1, 2, -1), N = 40 on 4 parts, to rtol 1e-7; an ILU-block
    preconditioner (a callable: the host loop on every backend) in fewer
    than half the iterations."""
    be = pt.sequential if backend == "sequential" else CPU
    small = np.array([2 - 2 * np.cos(k * TH) for k in (1, 2, 3)])
    large = np.array([2 - 2 * np.cos(k * TH) for k in (N, N - 1)])

    def driver(parts):
        lam, it, conv, r0 = _pairs(pt, parts, nev=3)
        lamL, _, convL, _ = _pairs(pt, parts, nev=2, largest=True)
        A = _stencil_1d(pt, parts, N, 2.0)
        lam2, _, info2 = pt.lobpcg(A, nev=3, minv=pt.block_jacobi_ilu(A, fill_factor=20), tol=1e-6, maxiter=300)
        return lam, it, conv, r0, lamL, convL, lam2, info2["iterations"], info2["converged"]

    lam, it, conv, r0, lamL, convL, lam2, it2, conv2 = pt.prun(driver, be, 4)
    assert conv and convL and conv2 and r0 < 1e-5
    np.testing.assert_allclose(lam, small, rtol=1e-7)
    np.testing.assert_allclose(lamL, large, rtol=1e-7)
    np.testing.assert_allclose(lam2, small, rtol=1e-7)
    assert it2 < it // 2, (it2, it)


def test_lobpcg_device_matches_host_and_jax():
    """tests/test_solvers.py:566: the device loop's eigenvalues against the
    port's host loop and both JAX paths to rtol 1e-8, residuals < 1e-5; the
    host loops take the same iterations; Jacobi-preconditioned largest
    modes on the device to rtol 1e-7 of the closed form; a second solve
    builds nothing."""
    lam_s, it_s, _, r_s = pt.prun(lambda p: _pairs(pt, p, nev=3), pt.sequential, 4)
    lam_d, _, conv_d, r_d = pt.prun(lambda p: _pairs(pt, p, nev=3), CPU, 4)
    lam_js, it_js, _, _ = pa.prun(lambda p: _pairs(pa, p, nev=3), pa.sequential, 4)
    lam_jt, _, _, _ = pa.prun(lambda p: _pairs(pa, p, nev=3), pa.tpu, 4)
    assert conv_d and r_s < 1e-5 and r_d < 1e-5
    assert it_s == it_js
    for want in (lam_s, lam_js, lam_jt):
        np.testing.assert_allclose(lam_d, want, rtol=1e-8)

    def driver2(parts):
        A = _stencil_1d(pt, parts, N, 2.0)
        kw = dict(nev=2, minv=pt.jacobi_preconditioner(A), largest=True, tol=1e-6, maxiter=300)
        lam, _, info = pt.lobpcg(A, **kw)
        built = STATS["solve_fns"]
        lam2, _, _ = pt.lobpcg(A, **kw)
        assert STATS["solve_fns"] == built and np.array_equal(lam, lam2)
        assert info["converged"] and info["device_loop"]["loop"] == "eager"
        assert info["residual_norms"].shape == (info["iterations"], 2)
        return lam

    np.testing.assert_allclose(pt.prun(driver2, CPU, 4), [2 - 2 * np.cos(N * TH), 2 - 2 * np.cos((N - 1) * TH)],
                               rtol=1e-7)


def test_lobpcg_gmg_preconditioned():
    """tests/test_solvers.py:824: the decoupled 16^2 Poisson on (2,2) with
    its hierarchy (coarse_threshold 20) as minv, nev 2, tol 1e-7: converged,
    within rtol 1e-5 of the Jacobi host solve at tol 1e-9, no more
    iterations than the unpreconditioned device solve; the same eigenvalues
    as the JAX package's compiled GMG-preconditioned solve to rtol 1e-8."""
    def driver(m, parts):
        n = 16
        A, b, _, _ = m.assemble_poisson(parts, (n, n))
        Ah, _ = m.decouple_dirichlet(A, b)
        h = m.gmg_hierarchy(parts, Ah, (n, n), coarse_threshold=20)
        lam, X, info = m.lobpcg(Ah, nev=2, minv=h, tol=1e-7, maxiter=200)
        lam0, _, info0 = m.lobpcg(Ah, nev=2, tol=1e-7, maxiter=200)
        # the host loop with a callable Jacobi (a PVector minv would take the device loop)
        jac = m.jacobi_preconditioner(Ah)
        mv = lambda r: r.zip_map(lambda rv, jv: jv * rv, jac) if m is pt else None  # noqa: E731
        lam_h, _, info_h = (pt.lobpcg(Ah, nev=2, minv=mv, tol=1e-9, maxiter=500) if m is pt
                            else m.lobpcg(Ah, nev=2, minv=jac, tol=1e-9, maxiter=500))
        return lam, info, lam0, info0, lam_h, info_h

    lam, info, lam0, info0, lam_h, info_h = pt.prun(lambda p: driver(pt, p), CPU, (2, 2))
    assert info["converged"] and info_h["converged"]
    np.testing.assert_allclose(lam, lam_h, rtol=1e-5)
    if info0["converged"]:
        assert info["iterations"] <= info0["iterations"], (info["iterations"], info0["iterations"])
    jlam = pa.prun(lambda p: driver(pa, p), pa.tpu, (2, 2))[0]
    np.testing.assert_allclose(lam, jlam, rtol=1e-8)
