"""The rest of the Krylov family of the port (BiCGStab, GMRES, FGMRES,
MINRES, Chebyshev, the spectral bounds, FGMRES with the V-cycle on the
card) against the JAX package, at small sizes on the CPU.

Each test drives one scenario through the JAX package (``pa.sequential``
and, where the JAX test does, ``pa.tpu`` on the 8-device CPU mesh) and the
port (``pt.sequential`` and ``GPUBackend(device="cpu")``: the device loops
with the kernels' plain versions) and holds the port to the gate of the
JAX package's own test: `tests/test_solvers.py:104` (BiCGStab, +-2
iterations), `:242` and `:292` (GMRES restarts; a history monotone inside a
cycle), `:308` and `:322` (MINRES), `:196` and `:220` (Chebyshev), `:388`
and `:482` (Lanczos bounds), `:412`, `:605` (right Jacobi and RAS), `:754`
and `:805` (callable, right and GMG preconditioners) and `tests/test_gmg.py:360` (FGMRES with
the V-cycle on the device against the host loop, +-1 iteration). The
bounds are compared with the JAX package's to 1e-12 (the same seeded
start, dots that agree to rounding). A second solve on the same operator
builds and captures nothing (`gpu._krylov_fn_for`, `gpu_gmg.fgmres_gmg_fn`).
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel import gpu_loop
from partitionedarrays_jl_tpu_torch.parallel.gpu import STATS as GPU_STATS
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, _krylov_fn_for, device_matrix

CPU = GPUBackend(device="cpu")
N1 = 40  # the 1-D stencil of the JAX tests (known spectrum)


def _err(m, x, xe):
    return float(np.linalg.norm(m.gather_pvector(x) - m.gather_pvector(xe)))


def _stencil_1d(m, parts, N, diag, off_val=-1.0):
    """tridiag(off_val, diag, off_val) over a 1-D block partition (the JAX
    tests' `_stencil_1d`), written once against a package namespace."""
    rows = m.prange(parts, N)

    def coo(i):
        g = np.asarray(i.oid_to_gid)
        I, J, V = [g], [g], [np.full(len(g), diag)]
        for off in (-1, 1):
            gj = g + off
            k = (gj >= 0) & (gj < N)
            I.append(g[k])
            J.append(gj[k])
            V.append(np.full(int(k.sum()), off_val))
        return np.concatenate(I), np.concatenate(J), np.concatenate(V)

    c = m.map_parts(coo, rows.partition)
    cols = m.add_gids(rows, m.map_parts(lambda t: t[1], c))
    return m.PSparseMatrix.from_coo(m.map_parts(lambda t: t[0], c), m.map_parts(lambda t: t[1], c),
                                    m.map_parts(lambda t: t[2], c), rows, cols, ids="global")


def _perturbed(m, A):
    """A[i, i+1] *= 1.5 on the owned rows: the JAX tests' nonsymmetric
    perturbation of the Poisson operator."""
    def perturb(M):
        data = M.data.copy()
        data[M.indices == M.row_of_nz() + 1] *= 1.5
        return type(M)(M.indptr, M.indices, data, M.shape)

    return m.PSparseMatrix(m.map_parts(perturb, A.values), A.rows, A.cols)


def _runs(driver, grid, jax_tpu=True):
    """driver(m, parts) on the JAX package's backends and the port's."""
    out = {"jax_seq": pa.prun(lambda parts: driver(pa, parts), pa.sequential, grid)}
    if jax_tpu:
        out["jax_tpu"] = pa.prun(lambda parts: driver(pa, parts), pa.tpu, grid)
    out["seq"] = pt.prun(lambda parts: driver(pt, parts), pt.sequential, grid)
    out["gpu"] = pt.prun(lambda parts: driver(pt, parts), CPU, grid)
    return out


def test_bicgstab_near_parity():
    """test_solvers.py:104: Poisson 12^2 on (2,2), tol 1e-8: both converge,
    errors < 1e-6, iterations within 2 of the JAX package's."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (12, 12))
        x, info = m.bicgstab(A, b, x0=x0, tol=1e-8)
        return info["iterations"], info["converged"], _err(m, x, xe)

    r = _runs(driver, (2, 2))
    for k, (it, conv, err) in r.items():
        assert conv and err < 1e-6, (k, it, err)
    for k in ("seq", "gpu"):
        assert abs(r[k][0] - r["jax_seq"][0]) <= 2 and abs(r[k][0] - r["jax_tpu"][0]) <= 2, r


def test_bicgstab_nonsymmetric_and_spd():
    """test_solvers.py:89 and :125: BiCGStab on the 10^3 Poisson (tol 1e-9,
    error < 1e-5) and on the perturbed nonsymmetric 8^3 operator (tol 1e-10,
    ||A x - b|| < 1e-6), (2,2,2) parts; iterations within 2 of the JAX
    package's sequential loop."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (10, 10, 10))
        x, info = m.bicgstab(A, b, x0=x0, tol=1e-9)
        An = _perturbed(m, m.assemble_poisson(parts, (8, 8, 8))[0])
        bn = An @ m.PVector.full(1.0, An.cols)
        xn, infon = m.bicgstab(An, bn, tol=1e-10)
        res = np.linalg.norm(m.gather_pvector(An @ xn) - m.gather_pvector(bn))
        return info["iterations"], info["converged"], _err(m, x, xe), infon["iterations"], infon["converged"], res

    r = _runs(driver, (2, 2, 2), jax_tpu=False)
    for k, (it, conv, err, itn, convn, res) in r.items():
        assert conv and err < 1e-5 and convn and res < 1e-6, (k, r[k])
        assert abs(it - r["jax_seq"][0]) <= 2 and abs(itn - r["jax_seq"][3]) <= 2, r


def test_gmres_restarts_near_parity():
    """test_solvers.py:242: the perturbed 8^3 operator on (2,2,2), restart 8,
    tol 1e-10: ||A x - b|| < 1e-6 on every side, the port's device loop
    within max(4, it/4) iterations of the JAX sequential loop, the port's
    host loop within 2 (the same MGS loop, SpMVs equal to rounding)."""
    def driver(m, parts):
        A = _perturbed(m, m.assemble_poisson(parts, (8, 8, 8))[0])
        bn = A @ m.PVector.full(1.0, A.cols)
        x, info = m.gmres(A, bn, restart=8, tol=1e-10)
        res = np.linalg.norm(m.gather_pvector(A @ x) - m.gather_pvector(bn))
        return info["iterations"], info["converged"], res

    r = _runs(driver, (2, 2, 2))
    it_s = r["jax_seq"][0]
    for k, (it, conv, res) in r.items():
        assert conv and res < 1e-6, (k, r[k])
    assert abs(r["gpu"][0] - it_s) <= max(4, it_s // 4), r
    assert abs(r["seq"][0] - it_s) <= 2, r


def test_gmres_history_monotone_within_cycle():
    """test_solvers.py:292: restart 50 > iterations on the 8^3 Poisson,
    (2,2,2): a single cycle, the history non-increasing, on the port's host
    and device loops; the device loop's Givens estimates end in the true
    residual, and both take the JAX sequential loop's iterations +-2."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (8, 8, 8))
        x, info = m.gmres(A, b, x0=x0, restart=50, tol=1e-9)
        return info["iterations"], np.asarray(info["residuals"]), info["converged"], _err(m, x, xe)

    r = _runs(driver, (2, 2, 2), jax_tpu=False)
    for k, (it, res, conv, err) in r.items():
        assert conv and it < 50 and err < 1e-5, (k, it, err)
        assert len(res) == it + 1
        assert np.all(np.diff(res) <= 1e-12 * res[0]), k
        assert abs(it - r["jax_seq"][0]) <= 2
    assert r["gpu"][3] < 1e-5


def test_gmres_jacobi_left_preconditioned():
    """test_solvers.py:258: left Jacobi GMRES(20) on the 10^3 Poisson,
    (2,2,2): converged, no slower than plain + 2, error < 1e-5, on the
    port's host and device loops, iterations within 2 of the JAX
    package's."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (10, 10, 10))
        mv = m.jacobi_preconditioner(A)
        x, info = m.gmres(A, b, x0=x0, restart=20, tol=1e-9, minv=mv)
        _, plain = m.gmres(A, b, x0=x0, restart=20, tol=1e-9)
        return info["iterations"], info["converged"], plain["iterations"], _err(m, x, xe)

    r = _runs(driver, (2, 2, 2), jax_tpu=False)
    for k, (it, conv, it_plain, err) in r.items():
        assert conv and it <= it_plain + 2 and err < 1e-5, (k, r[k])
        assert abs(it - r["jax_seq"][0]) <= 2, r


def test_minres_spd_parity():
    """test_solvers.py:308: MINRES on the 10^3 Poisson, (2,2,2), tol 1e-9:
    converged, error < 1e-5, iterations within 2 of both JAX backends."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (10, 10, 10))
        x, info = m.minres(A, b, x0=x0, tol=1e-9)
        return info["iterations"], info["converged"], _err(m, x, xe)

    r = _runs(driver, (2, 2, 2))
    for k, (it, conv, err) in r.items():
        assert conv and err < 1e-5, (k, r[k])
        assert abs(it - r["jax_seq"][0]) <= 2 and abs(it - r["jax_tpu"][0]) <= 2, r


def test_minres_symmetric_indefinite():
    """test_solvers.py:322: the 1-D stencil shifted inside its spectrum
    (N = 40, 4 parts): Gershgorin straddles 0 (the JAX package's bounds
    exactly), MINRES converges to ||A x - b|| < 1e-6, iterations within 2 of
    the JAX package's."""
    def driver(m, parts):
        A = _stencil_1d(m, parts, N1, 1.0)
        lo, hi = m.gershgorin_bounds(A)
        bs = A @ m.PVector.full(1.0, A.cols)
        x, info = m.minres(A, bs, tol=1e-10)
        res = np.linalg.norm(m.gather_pvector(A @ x) - m.gather_pvector(bs))
        return lo, hi, info["iterations"], info["converged"], res

    r = _runs(driver, 4)
    for k, (lo, hi, it, conv, res) in r.items():
        assert (lo, hi) == r["jax_seq"][:2] and lo < 0 < hi
        assert conv and res < 1e-6, (k, r[k])
        assert abs(it - r["jax_seq"][2]) <= 2, r


def test_minres_hard_breakdown_is_a_noop():
    """A zero operator: rho == 0 on the first step. Host and device loops
    leave x at its start, count no iteration and report converged=False,
    as the JAX package's do."""
    def driver(m, parts):
        A = _stencil_1d(m, parts, 12, 0.0, off_val=0.0)
        b = m.PVector.full(1.0, A.cols)
        x, info = m.minres(A, b, tol=1e-10)
        return info["iterations"], info["converged"], float(np.abs(m.gather_pvector(x)).max())

    r = _runs(driver, 2, jax_tpu=False)
    assert all(v == (0, False, 0.0) for v in r.values()), r


@pytest.fixture(scope="module")
def chebyshev_runs():
    """test_solvers.py:196 and :388 on the 1-D stencil, N = 40, 4 parts:
    the Gershgorin and Lanczos bounds, Chebyshev with the exact and the
    Lanczos bounds (tol 1e-10), and CG (tol 1e-12) for the solution."""
    lmin = 2 - 2 * np.cos(np.pi / (N1 + 1))
    lmax = 2 - 2 * np.cos(N1 * np.pi / (N1 + 1))

    def driver(m, parts):
        A = _stencil_1d(m, parts, N1, 2.0)
        b = m.PVector.full(1.0, A.cols)
        g = m.gershgorin_bounds(A)
        lz = m.lanczos_bounds(A, iters=30)
        x, info = m.chebyshev_solve(A, b, lmin, lmax, tol=1e-10, maxiter=5000)
        xl, infol = m.chebyshev_solve(A, b, lz[0], lz[1], tol=1e-10, maxiter=5000)
        xc, _ = m.cg(A, b, tol=1e-12)
        xc = m.gather_pvector(xc)
        return (g, lz, info["iterations"], info["converged"], float(np.abs(m.gather_pvector(x) - xc).max()),
                infol["converged"], float(np.abs(m.gather_pvector(xl) - xc).max()), np.asarray(info["residuals"]),
                info.get("residuals_every"))

    return _runs(driver, 4), (lmin, lmax)


def test_chebyshev_against_cg(chebyshev_runs):
    """test_solvers.py:196: the Gershgorin interval brackets the spectrum
    (the JAX package's bounds exactly), Chebyshev converges within 1e-7 of
    CG's solution; the device loop takes the JAX device loop's iterations
    (whole legs of 16) and history (one entry a leg, to 1e-8), the host
    loop the JAX host loop's +-2."""
    r, (lmin, lmax) = chebyshev_runs
    for k, (g, _lz, it, conv, d, _cl, _dl, res, every) in r.items():
        assert g == r["jax_seq"][0] and g[0] <= lmin and g[1] >= lmax, (k, g)
        assert conv and d < 1e-7, (k, it, d)
    assert r["gpu"][2] == r["jax_tpu"][2] and r["gpu"][2] % 16 == 0
    assert r["gpu"][8] == r["jax_tpu"][8] == 16
    np.testing.assert_allclose(r["gpu"][7], r["jax_tpu"][7], rtol=1e-8)
    assert abs(r["seq"][2] - r["jax_seq"][2]) <= 2


def test_lanczos_bounds_bracket_and_match(chebyshev_runs):
    """test_solvers.py:388: the Lanczos interval brackets both extremes, hi
    <= 1.1 lmax, equals the JAX package's to 1e-12 (the same per-part
    seeded start), and drives Chebyshev to CG's solution within 1e-7."""
    r, (lmin, lmax) = chebyshev_runs
    for k, (_g, (lo, hi), _it, _c, _d, conv_l, d_l, _res, _e) in r.items():
        assert lo <= lmin <= hi and lo <= lmax <= hi and hi <= 1.1 * lmax, (k, lo, hi)
        np.testing.assert_allclose((lo, hi), r["jax_seq"][1], rtol=1e-12)
        assert conv_l and d_l < 1e-7, (k, d_l)


def test_lanczos_bounds_negative_and_indefinite():
    """test_solvers.py:482: the margins widen the interval outward for a
    negative-definite and an indefinite spectrum; equal to the JAX
    package's to 1e-12."""
    th = np.pi / (N1 + 1)

    def driver(m, parts):
        neg = m.lanczos_bounds(_stencil_1d(m, parts, N1, -2.0, off_val=1.0), iters=30)
        ind = m.lanczos_bounds(_stencil_1d(m, parts, N1, 1.0), iters=30)
        return neg, ind

    want = pa.prun(lambda parts: driver(pa, parts), pa.sequential, 4)
    for be in (pt.sequential, CPU):
        (nlo, nhi), (ilo, ihi) = pt.prun(lambda parts: driver(pt, parts), be, 4)
        assert nlo <= -(2 - 2 * np.cos(N1 * th)) and nhi >= -(2 - 2 * np.cos(th))
        assert ilo <= 1 - 2 * np.cos(th) and ihi >= 1 - 2 * np.cos(N1 * th) and ilo < 0 < ihi
        np.testing.assert_allclose([nlo, nhi, ilo, ihi], np.ravel(want), rtol=1e-12)


def test_chebyshev_rejects_bad_bounds():
    """test_solvers.py:220."""
    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (4, 4, 4))
        with pytest.raises(AssertionError):
            pt.chebyshev_solve(A, b, lmin=2.0, lmax=1.0)
        return True

    assert pt.prun(driver, CPU, (2, 2, 2))


def test_gmres_with_gmg_preconditioner():
    """test_solvers.py:412: GMRES(20) left-preconditioned by a GMG hierarchy
    (a callable: the host loop on every backend) on the decoupled 10^3
    Poisson, (2,2,2), ct 100: converged, fewer iterations than plain GMRES,
    error < 1e-6; the JAX package's iterations +-1."""
    def driver(m, parts):
        A, b, xe, _ = m.assemble_poisson(parts, (10, 10, 10))
        Ah, bh = m.decouple_dirichlet(A, b)
        h = m.gmg_hierarchy(parts, Ah, (10, 10, 10), coarse_threshold=100)
        x, info = m.gmres(Ah, bh, restart=20, tol=1e-10, minv=h)
        _, plain = m.gmres(Ah, bh, restart=20, tol=1e-10)
        return info["iterations"], info["converged"], plain["iterations"], float(
            np.abs(m.gather_pvector(x) - m.gather_pvector(xe)).max())

    r = _runs(driver, (2, 2, 2), jax_tpu=False)
    for k, (it, conv, it_plain, err) in r.items():
        assert conv and it < it_plain and err < 1e-6, (k, r[k])
        assert abs(it - r["jax_seq"][0]) <= 1, r


def test_bicgstab_right_preconditioned():
    """test_solvers.py:605: right-Jacobi BiCGStab on the advection operator
    (14^2, (2,2), tol 1e-10): converged, max error < 1e-7, the port's
    device loop within 2 iterations of both JAX backends. The RAS callable
    (`additive_schwarz(mode="ras")`, the host loop on every backend) must
    beat plain BiCGStab, max error < 1e-7, in the JAX package's sequential
    iterations."""
    def driver(m, parts):
        A, b, xe, x0 = m.assemble_advection_fv(parts, (14, 14))
        mv = m.jacobi_preconditioner(A)
        x, info = m.bicgstab(A, b, x0=x0, minv=mv, tol=1e-10)
        err = float(np.abs(m.gather_pvector(x) - m.gather_pvector(xe)).max())
        return info["iterations"], info["converged"], err

    r = _runs(driver, (2, 2))
    for k, (it, conv, err) in r.items():
        assert conv and err < 1e-7, (k, it, err)
    assert abs(r["gpu"][0] - r["jax_seq"][0]) <= 2 and abs(r["gpu"][0] - r["jax_tpu"][0]) <= 2, r

    def ras(m, parts):
        A, b, xe, x0 = m.assemble_advection_fv(parts, (14, 14))
        xr, ir = m.bicgstab(A, b, x0=x0, minv=m.additive_schwarz(A, mode="ras"), tol=1e-10)
        _, ip = m.bicgstab(A, b, x0=x0, tol=1e-10)
        return ir["iterations"], ir["converged"], ip["iterations"], float(
            np.abs(m.gather_pvector(xr) - m.gather_pvector(xe)).max())

    want = pa.prun(lambda parts: ras(pa, parts), pa.sequential, (2, 2))
    for backend in (pt.sequential, CPU):
        it_r, conv_r, it_p, err_r = pt.prun(lambda parts: ras(pt, parts), backend, (2, 2))
        assert conv_r and it_r < it_p and err_r < 1e-7, (backend, it_r, it_p, err_r)
        assert it_r == want[0], (backend, it_r, want)


def test_fgmres_with_inner_iterative_preconditioner():
    """test_solvers.py:754: FGMRES(20) whose preconditioner is an inner CG
    of alternating tolerance on the decoupled 10^2 Poisson, (2,2): converged,
    fewer iterations than unpreconditioned, max error < 1e-5, the JAX
    package's iterations +-1; on the GPU backend the inner CG runs the
    device loop."""
    def driver(m, parts):
        A, b, xe, _ = m.assemble_poisson(parts, (10, 10))
        Ah, bh = m.decouple_dirichlet(A, b)
        calls = {"n": 0}

        def inner(r):
            calls["n"] += 1
            z, _ = m.cg(Ah, r, tol=1e-2 if calls["n"] % 2 else 1e-1, maxiter=50)
            return z

        x, info = m.fgmres(Ah, bh, minv=inner, tol=1e-8, restart=20)
        _, i0 = m.fgmres(Ah, bh, tol=1e-8, restart=20)
        err = float(np.abs(m.gather_pvector(x) - m.gather_pvector(xe)).max())
        return info["iterations"], info["converged"], i0["iterations"], err, calls["n"]

    r = _runs(driver, (2, 2), jax_tpu=False)
    for k, (it, conv, it0, err, n) in r.items():
        assert conv and n >= 2 and it < it0 and err < 1e-5, (k, r[k])
        assert abs(it - r["jax_seq"][0]) <= 1, r


def test_fgmres_matches_gmres_with_constant_preconditioner():
    """test_solvers.py:731: with the constant Jacobi preconditioner FGMRES and
    GMRES reach the same solution (max difference < 1e-7) on the advection
    operator 10^2, velocity (8, 3), (2,2), on both port backends."""
    def driver(parts):
        A, b, _, _ = pt.assemble_advection_fv(parts, (10, 10), velocity=(8.0, 3.0))
        mv = pt.jacobi_preconditioner(A)
        xf, inf_f = pt.fgmres(A, b, minv=mv, tol=1e-10, restart=20)
        xg, inf_g = pt.gmres(A, b, minv=mv, tol=1e-10, restart=20)
        return inf_f["converged"], inf_g["converged"], float(
            np.abs(pt.gather_pvector(xf) - pt.gather_pvector(xg)).max())

    for be in (pt.sequential, CPU):
        cf, cg_, d = pt.prun(driver, be, (2, 2))
        assert cf and cg_ and d < 1e-7, (be, d)


@pytest.fixture(scope="module")
def fgmres_gmg_jax():
    """test_gmg.py:360: the JAX package's host fgmres(minv=h) and
    tpu_fgmres_gmg on the decoupled 12^3 Poisson, (2,2,2), ct 100, restart
    10, tol 1e-9 (iterations, max error)."""
    def driver(parts):
        A, b, xe, _ = pa.assemble_poisson(parts, (12, 12, 12))
        Ah, bh = pa.decouple_dirichlet(A, b)
        h = pa.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=100)
        out = []
        for x, info in (pa.fgmres(Ah, bh, minv=h, tol=1e-9, restart=10),
                        pa.tpu_fgmres_gmg(h, bh, tol=1e-9, restart=10)):
            out.append((info["iterations"], info["converged"],
                        float(np.abs(pa.gather_pvector(x) - pa.gather_pvector(xe)).max())))
        return out

    return pa.prun(driver, pa.tpu, (2, 2, 2))


def test_fgmres_gmg_device_matches_host(fgmres_gmg_jax):
    """test_gmg.py:360: the port's `gpu_fgmres_gmg` against its host
    fgmres(minv=h) on the same hierarchy: both converged, max errors < 1e-7,
    iterations within 1 of each other and of the JAX package's two paths;
    the default routes and the structured ones (``stencil=False``) take the
    same iterations."""
    def driver(parts):
        A, b, xe, _ = pt.assemble_poisson(parts, (12, 12, 12))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=100)
        out = []
        for x, info in (pt.fgmres(Ah, bh, minv=h, tol=1e-9, restart=10),
                        pt.gpu_fgmres_gmg(h, bh, tol=1e-9, restart=10),
                        pt.gpu_fgmres_gmg(h, bh, tol=1e-9, restart=10, stencil=False)):
            out.append((info["iterations"], info["converged"],
                        float(np.abs(pt.gather_pvector(x) - pt.gather_pvector(xe)).max())))
        return out

    host, dev, structured = pt.prun(driver, CPU, (2, 2, 2))
    (jh_it, *_), (jt_it, *_) = fgmres_gmg_jax
    for it, conv, err in (host, dev, structured):
        assert conv and err < 1e-7, (host, dev, structured)
        assert abs(it - jh_it) <= 1 and abs(it - jt_it) <= 1, (host, dev, fgmres_gmg_jax)
    assert abs(host[0] - dev[0]) <= 1 and abs(structured[0] - dev[0]) <= 1


def test_fgmres_gmg_restart_cycles():
    """test_gmg.py:386: restart 3 forces several cycles through the device
    loop (one cycle a step; the 2-D 12^2 Poisson, (2,2), ct 30, tol 1e-10):
    converged, max error < 1e-7, the loop ran as many cycles as the
    iterations take; the host loop's iterations +-1."""
    def driver(parts):
        A, b, xe, _ = pt.assemble_poisson(parts, (12, 12))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12), coarse_threshold=30)
        x, info = pt.gpu_fgmres_gmg(h, bh, tol=1e-10, restart=3)
        _, host = pt.fgmres(Ah, bh, minv=h, tol=1e-10, restart=3)
        err = float(np.abs(pt.gather_pvector(x) - pt.gather_pvector(xe)).max())
        return info["iterations"], info["converged"], err, info["device_loop"]["device_iterations"], host["iterations"]

    it, conv, err, cycles, it_host = pt.prun(driver, CPU, (2, 2))
    assert conv and err < 1e-7 and it > 3
    assert cycles == -(-it // 3) and abs(it - it_host) <= 1


def test_second_solve_reuses_matrix_and_function():
    """A second `cg`/`bicgstab`/`gmres`/`minres`/`chebyshev_solve` (and
    `gpu_fgmres_gmg` on its hierarchy) with the same key takes the solve
    function cached on the DeviceMatrix (the hierarchy): the same lowering
    and function object, no function built and no graph captured, and the
    result of the first call on the same right-hand side, bit for bit.
    Another tol is another function."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_advection_fv(parts, (8, 8, 6))
        As, bs, _, x0s = pt.assemble_poisson(parts, (8, 8, 6))
        Ah, bh = pt.decouple_dirichlet(As, bs)
        h = pt.gmg_hierarchy(parts, Ah, (8, 8, 6), coarse_threshold=60)
        calls = [
            lambda: pt.bicgstab(A, b, x0=x0, tol=1e-10),
            lambda: pt.gmres(A, b, x0=x0, restart=10, tol=1e-10),
            lambda: pt.cg(As, bs, x0=x0s, tol=1e-10),
            lambda: pt.minres(As, bs, x0=x0s, tol=1e-10),
            lambda: pt.chebyshev_solve(Ah, bh, 0.5, 12.5, tol=1e-8),
            lambda: pt.gpu_fgmres_gmg(h, bh, tol=1e-9, restart=5),
        ]
        out = []
        for call in calls:
            x1, i1 = call()
            before = (dict(GPU_STATS), dict(gpu_loop.STATS))
            mats = (A, As, Ah)
            fns = [dict(M._device) for M in mats]
            caches = {id(dA): dict(dA._fn_cache) for M in mats for dA in M._device.values()}
            caches[id(h)] = dict(getattr(h, "_fn_cache", {}))
            x2, i2 = call()
            after = (dict(GPU_STATS), dict(gpu_loop.STATS))
            same_dA = [dict(M._device) for M in mats] == fns
            now = {id(dA): dict(dA._fn_cache) for M in mats for dA in M._device.values()}
            now[id(h)] = dict(getattr(h, "_fn_cache", {}))
            same_fn = now == caches
            out.append((before == after, same_dA, same_fn, i1["iterations"] == i2["iterations"],
                        np.array_equal(pt.gather_pvector(x1), pt.gather_pvector(x2)), i1["converged"]))
        n0 = GPU_STATS["solve_fns"]
        dA = next(iter(A._device.values()))
        k0 = len(dA._fn_cache)
        pt.bicgstab(A, b, x0=x0, tol=1e-9)
        out.append((GPU_STATS["solve_fns"] - n0, len(dA._fn_cache) - k0))
        return out

    out = pt.prun(driver, CPU, (2, 2, 2))
    assert out[:-1] == [(True,) * 6] * 6, out
    assert out[-1] == (1, 1)


def test_solve_function_cache_key():
    """`_krylov_fn_for` keys the concrete body: fused=None resolves to the
    fused body (a hit for fused=True), pipelined and the block width K are
    other keys, and gpu_cg/gpu_block_cg take their function from it."""
    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        dA = device_matrix(A, parts.backend)
        f1 = _krylov_fn_for(dA, "cg", 1e-8, 100)
        f2 = _krylov_fn_for(dA, "cg", 1e-8, 100, fused=True)
        f3 = _krylov_fn_for(dA, "cg", 1e-8, 100, pipelined=True)
        f4 = _krylov_fn_for(dA, "cg", 1e-8, 100, rhs_batch=2)
        pt.cg(A, b, x0=x0, tol=1e-8, maxiter=100)
        pt.cg(A, B=[b, b * 2.0], X0=[x0, x0], tol=1e-8, maxiter=100)
        return (f1 is f2, f3 is not f1, f4.rhs_batch, f1.cg_body, f3.cg_body, len(dA._fn_cache))

    assert pt.prun(driver, CPU, (1, 1, 1)) == (True, True, 2, "fused", "pipelined", 3)
