"""The differentiable solve of the port (`gpu_krylov.make_diff_solve_fn`)
against the JAX package's (`tests/test_diff_solve.py`), on the CPU.

* The gradient of a quadratic loss of the solution through
  `torch.autograd` equals central finite differences at five seeded
  entries to 1e-6 relative (test_diff_solve.py:44), and the JAX package's
  `jax.grad` of the same loss to 1e-9 relative.
* The solution equals the host CG's to 1e-10 (test_diff_solve.py:86) and
  the JAX package's differentiable solve's to 1e-12.
* Backward is the forward solve of the cotangent: the vector-Jacobian
  product is torch.equal to a second forward call on x̄, both on the one
  solve function cached on the DeviceMatrix (no second function built).
* It runs on a node-block (SD/BSR) lowering (test_diff_solve.py:103) and
  warns when the solve does not converge.
"""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import STATS as GPU_STATS
from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, GPUBackend, _b_on_cols_layout, device_matrix
from partitionedarrays_jl_tpu_torch.parallel.gpu_krylov import make_diff_solve_fn

CPU = GPUBackend(device="cpu")
N = 40


def _spd_tridiag(m, parts):
    """The eliminated-boundary 1-D Laplacian (truly SPD) of the JAX test."""
    rows = m.prange(parts, N)

    def coo(i):
        g = np.asarray(i.oid_to_gid)
        I, J, V = [g], [g], [np.full(len(g), 2.0)]
        for off in (-1, 1):
            gj = g + off
            k = (gj >= 0) & (gj < N)
            I.append(g[k])
            J.append(gj[k])
            V.append(np.full(int(k.sum()), -1.0))
        return np.concatenate(I), np.concatenate(J), np.concatenate(V)

    c = m.map_parts(coo, rows.partition)
    cols = m.add_gids(rows, m.map_parts(lambda t: t[1], c))
    return m.PSparseMatrix.from_coo(m.map_parts(lambda t: t[0], c), m.map_parts(lambda t: t[1], c),
                                    m.map_parts(lambda t: t[2], c), rows, cols, ids="global")


def _b_of(m, A):
    return m.PVector(m.map_parts(lambda i: np.sin(np.asarray(i.lid_to_gid, float)), A.cols.partition), A.cols)


def _weights(P, W):
    return np.tile(np.cos(np.arange(W) * 0.1), (P, 1))


@pytest.fixture(scope="module")
def jax_grad():
    """The JAX package's gradient and solution on the 4-part mesh."""
    import jax
    import jax.numpy as jnp
    from partitionedarrays_jl_tpu.parallel.tpu import DeviceVector as JDeviceVector
    from partitionedarrays_jl_tpu.parallel.tpu import device_matrix as jdevice_matrix
    from partitionedarrays_jl_tpu.parallel.tpu import make_diff_solve_fn as jmake_diff_solve_fn

    def driver(parts):
        A = _spd_tridiag(pa, parts)
        dA = jdevice_matrix(A, parts.backend)
        f = jmake_diff_solve_fn(dA, tol=1e-13)
        db = JDeviceVector.from_pvector(_b_of(pa, A), parts.backend, dA.col_layout)
        L = dA.col_layout
        wj = jnp.asarray(_weights(L.P, L.W))
        g = jax.grad(lambda bv: jnp.sum((f(bv) * wj) ** 2))(db.data)
        return np.asarray(g), np.asarray(f(db.data)), np.asarray(db.data)

    return pa.prun(driver, pa.tpu, 4)


def _port(parts, tol=1e-13, maxiter=None):
    A = _spd_tridiag(pt, parts)
    dA = device_matrix(A, parts.backend)
    f = make_diff_solve_fn(dA, tol=tol, maxiter=maxiter)
    b = DeviceVector.from_pvector(_b_of(pt, A), parts.backend, dA.col_layout).data
    w = torch.from_numpy(_weights(dA.col_layout.P, dA.col_layout.W))
    return A, dA, f, b, w


def test_grad_matches_fd_and_jax(jax_grad):
    g_jax, x_jax, b_jax = jax_grad

    def driver(parts):
        A, dA, f, b0, w = _port(parts)

        def loss(bv):
            return torch.sum((f(bv) * w) ** 2)

        b = b0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(b), b)
        rng = np.random.default_rng(0)
        L = dA.col_layout
        fd_pairs = []
        with torch.no_grad():
            for _ in range(5):
                p = int(rng.integers(0, L.P))
                i = L.o0 + int(rng.integers(0, int(L.noids[p])))
                eps = 1e-6
                bp, bm = b0.clone(), b0.clone()
                bp[p, i] += eps
                bm[p, i] -= eps
                fd = (float(loss(bp)) - float(loss(bm))) / (2 * eps)
                fd_pairs.append((fd, float(g[p, i])))
        return g.numpy(), f(b0).numpy(), b0.numpy(), fd_pairs

    g, x, b0, fd_pairs = pt.prun(driver, CPU, 4)
    for fd, an in fd_pairs:
        assert abs(fd - an) / max(abs(an), 1e-10) < 1e-6, (fd, an)
    np.testing.assert_array_equal(b0, b_jax)  # the same layout and b
    np.testing.assert_allclose(g, g_jax, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(x, x_jax, rtol=1e-12, atol=1e-14)


def test_solution_matches_host_cg():
    def driver(parts):
        A = _spd_tridiag(pt, parts)
        b = pt.PVector.full(1.0, A.cols)
        x_host, _ = pt.cg(A, b, tol=1e-13, maxiter=400)
        dA = device_matrix(A, parts.backend)
        f = make_diff_solve_fn(dA, tol=1e-13, maxiter=400)
        db = DeviceVector.from_pvector(b, parts.backend, dA.col_layout)
        x_dev = DeviceVector(f(db.data), A.rows, dA.col_layout, parts.backend).to_pvector()
        return pt.gather_pvector(x_dev), pt.gather_pvector(x_host)

    got, want = pt.prun(driver, CPU, 4)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_vjp_is_a_second_forward_solve_on_one_function():
    """backward(x̄) torch.equal f(x̄): both run the solve function cached on
    the DeviceMatrix; forward and backward build one function between them."""
    def driver(parts):
        n0 = GPU_STATS["solve_fns"]
        A, dA, f, b0, w = _port(parts)
        b = b0.clone().requires_grad_(True)
        x = f(b)
        xbar = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(x.shape)))
        (vjp,) = torch.autograd.grad(x, b, grad_outputs=xbar)
        with torch.no_grad():
            again = f(xbar)
        fns = len(dA._fn_cache)
        f2 = make_diff_solve_fn(dA, tol=1e-13)
        return (torch.equal(vjp, again), GPU_STATS["solve_fns"] - n0, fns, f2.solve is f.solve,
                bool((again[:, dA.col_layout.o0 + int(dA.col_layout.noids.max()):] == 0).all()))

    assert pt.prun(driver, CPU, 4) == (True, 1, 1, True, True)


def test_diff_solve_on_node_block_lowering():
    """test_diff_solve.py:103: a multi-part elasticity system lowers A_oh to
    node blocks (no boundary ELL); the differentiable solve builds and runs
    there, on the decoupled (symmetric) system, and agrees with the host
    CG to 1e-8."""
    def driver(parts):
        A, b, _, _ = pt.assemble_elasticity_tet(parts, (4, 4, 4))
        Ah, bh = pt.decouple_dirichlet(A, b)
        dA = device_matrix(Ah, parts.backend)
        f = make_diff_solve_fn(dA, tol=1e-12, maxiter=400)
        x = DeviceVector(f(_b_on_cols_layout(bh, dA)), Ah.cols, dA.col_layout, parts.backend).to_pvector()
        xh, _ = pt.cg(Ah, bh, tol=1e-12, maxiter=400)
        return dA.ohb_bs, dA.oh_vals is None, float(np.abs(pt.gather_pvector(x) - pt.gather_pvector(xh)).max())

    bs, no_ell, d = pt.prun(driver, CPU, 4)
    assert bs == 3 and no_ell and d < 1e-8, (bs, no_ell, d)


def test_unconverged_solve_warns():
    def driver(parts):
        _, _, f, b0, _ = _port(parts, maxiter=3)
        with pytest.warns(UserWarning, match="the value AND its gradient are inaccurate"):
            f(b0)
        return True

    assert pt.prun(driver, CPU, 4)
