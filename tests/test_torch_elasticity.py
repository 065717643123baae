"""The port's unstructured tet-elasticity model (`models/elasticity_tet.py`)
against the JAX package's.

* the mesh, the Morton permutation and the element stiffness matrices are
  the same NumPy arithmetic: bitwise;
* the assembled system on 4 parts: index sets and CSR structure exactly,
  values to 1e-14 relative to the largest entry, b, x̂ and x0 likewise;
  and bit for bit on 1 and 4 parts, b taken in strict mode on both sides
  (``strict=True``; the JAX package under ``PA_TPU_STRICT_BITS=1``): both
  fold duplicate triplets left to right in input order;
* strict Jacobi PCG on the port's own elasticity system
  (``GPUBackend(device="cpu")``, the ELL lowering) bit for bit the JAX
  package's sequential strict PCG on its own system: iterations, residual
  history and solution;
* Jacobi PCG at (5,5,5) nodes on ``GPUBackend(device="cpu")`` in each
  lowering (supernode-dense, node blocks, ELL) against the JAX package's
  ``pa.pcg`` on its TPU backend (the CPU mesh): equal iterations,
  solutions to 1e-10; the driver's error gate (1e-5, test_fem_sa.jl:137);
* the block (multi-RHS) Jacobi PCG in each lowering: each column its solo
  solve (tests/test_torch_block_irregular.py holds it against the JAX
  package).
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import elasticity_tet as jax_el
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.models import elasticity_tet as pt_el
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")


@pytest.mark.parametrize("ns", [(3, 3, 3), (5, 4, 6)], ids=["3x3x3", "5x4x6"])
def test_mesh_permutation_and_element_matrices_bitwise(ns):
    c0, t0, b0 = pt_el.tet_mesh(ns, jitter=0.2, seed=3)
    c1, t1, b1 = jax_el.tet_mesh(ns, jitter=0.2, seed=3)
    assert c0.tobytes() == c1.tobytes() and np.array_equal(t0, t1) and np.array_equal(b0, b1)
    perm = pt_el.morton_permutation(c0)
    np.testing.assert_array_equal(perm, jax_el.morton_permutation(c1))
    assert pt_el.p1_elasticity_ke(c0, t0).tobytes() == jax_el.p1_elasticity_ke(c1, t1).tobytes()
    s = np.array(ns, dtype=float)
    assert pt_el._exact_disp(c0, s).tobytes() == jax_el._exact_disp(c1, s).tobytes()


def _system(module, prun, backend, ns, nparts, **kw):
    def driver(parts):
        A, b, xh, x0 = module.assemble_elasticity_tet(parts, ns, **kw)
        rows = [np.asarray(i.lid_to_gid) for i in A.rows.partition.part_values()]
        cols = [np.asarray(i.lid_to_gid) for i in A.cols.partition.part_values()]
        csr = [(M.indptr.copy(), M.indices.copy(), M.data.copy()) for M in A.values.part_values()]
        vecs = [[np.asarray(v) for v in w.values.part_values()] for w in (b, xh, x0)]
        return rows, cols, csr, vecs

    return prun(driver, backend, nparts)


@pytest.mark.parametrize("nparts", [1, 4])
def test_assembly_matches_jax(nparts):
    ns = (5, 4, 6)
    rows, cols, csr, vecs = _system(pt_el, pt.prun, pt.sequential, ns, nparts)
    jrows, jcols, jcsr, jvecs = _system(jax_el, pa.prun, pa.sequential, ns, nparts)
    for a, b in zip(rows + cols, jrows + jcols):
        np.testing.assert_array_equal(a, b)
    scale = max(np.abs(c[2]).max() for c in jcsr)
    for (ip, ix, v), (jip, jix, jv) in zip(csr, jcsr):
        np.testing.assert_array_equal(ip, jip)
        np.testing.assert_array_equal(ix, jix)
        np.testing.assert_allclose(v, jv, rtol=0, atol=1e-14 * scale)
    for w, jw in zip(vecs, jvecs):
        for a, b in zip(w, jw):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * max(1.0, np.abs(b).max()))


@pytest.fixture
def strict_env(monkeypatch):
    """The JAX package in strict mode (PA_TPU_STRICT_BITS=1)."""
    monkeypatch.setenv("PA_TPU_STRICT_BITS", "1")
    yield


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("nparts", [1, 4])
def test_assembly_bitwise_matches_jax(strict_env, nparts):
    """The assembled A, b (strict), x̂ and x0 bit for bit the JAX package's,
    index sets and CSR structure exactly."""
    ns = (5, 4, 6)
    rows, cols, csr, vecs = _system(pt_el, pt.prun, pt.sequential, ns, nparts, strict=True)
    jrows, jcols, jcsr, jvecs = _system(jax_el, pa.prun, pa.sequential, ns, nparts)
    for a, b in zip(rows + cols, jrows + jcols):
        np.testing.assert_array_equal(a, b)
    for (ip, ix, v), (jip, jix, jv) in zip(csr, jcsr):
        np.testing.assert_array_equal(ip, jip)
        np.testing.assert_array_equal(ix, jix)
        assert v.dtype == jv.dtype and _bits(v) == _bits(jv)
    for w, jw in zip(vecs, jvecs):
        for a, b in zip(w, jw):
            assert _bits(a) == _bits(b)


@pytest.mark.parametrize("ns,nparts", [((4, 4, 4), 4), ((5, 4, 6), 3)], ids=["4x4x4-4", "5x4x6-3"])
def test_strict_pcg_bitwise_matches_jax(strict_env, ns, nparts):
    """Strict Jacobi PCG, each package on its own assembled system: the
    port's GPU backend (the CPU; ELL, E1's and E3's plain versions) against
    the JAX package's sequential strict PCG, bit for bit."""

    def port(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, ns, strict=True)
        x, info = pt.pcg(A, b, x0=x0, tol=1e-12, maxiter=500, strict=True)
        return pt.gather_pvector(x), info

    def jax(parts):
        A, b, xh, x0 = jax_el.assemble_elasticity_tet(parts, ns)
        x, info = pa.pcg(A, b, x0=x0, tol=1e-12, maxiter=500)
        return pa.gather_pvector(x), info

    x, info = pt.prun(port, CPU, nparts)
    jx, jinfo = pa.prun(jax, pa.sequential, nparts)
    assert info["lowering"] == "ell" and info["strict"] and info["converged"]
    assert info["iterations"] == jinfo["iterations"]
    assert _bits(info["residuals"]) == _bits(jinfo["residuals"])
    assert _bits(x) == _bits(jx)


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX package's Jacobi PCG of the (5,5,5) system on its TPU backend
    (the CPU mesh, 4 parts), tol 1e-12 as the driver's."""

    def driver(parts):
        A, b, xh, x0 = jax_el.assemble_elasticity_tet(parts, (5, 5, 5))
        x, info = pa.pcg(A, b, x0=x0, tol=1e-12, maxiter=500)
        return pa.gather_pvector(x), info["iterations"]

    return pa.prun(driver, pa.tpu, 4)


@pytest.mark.parametrize("lowering", ["auto", "bsr", "ell"])
def test_jacobi_pcg_matches_jax(jax_solve, lowering):
    """Jacobi PCG on the port's GPU backend (plain versions on the CPU) in
    each lowering: the JAX package's iterations and solution to 1e-10; the
    fused body; the lowering recorded in the info."""

    def driver(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (5, 5, 5))
        x, info = pt.pcg(A, b, x0=x0, tol=1e-12, maxiter=500, lowering=lowering)
        return pt.gather_pvector(x), info

    x, info = pt.prun(driver, CPU, 4)
    want_x, want_it = jax_solve
    assert info["lowering"] == {"auto": "sd"}.get(lowering, lowering)
    assert info["cg_body"] == "fused" and info["converged"]
    assert info["iterations"] == want_it
    np.testing.assert_allclose(x, want_x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("body", ["standard", "pipelined"])
def test_other_cg_bodies_on_irregular_lowering(body):
    """The standard and the pipelined CG bodies on the SD lowering (the
    pipelined body's lagged x update an eager op before the product) take
    the fused body's iterations on the (4,4,4) system, on 2 parts."""

    def driver(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (4, 4, 4))
        kw = {"fused": False} if body == "standard" else {"pipelined": True}
        x1, i1 = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=800)
        x2, i2 = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=800, **kw)
        return i1, i2, float((x1 - x2).norm())

    i1, i2, diff = pt.prun(driver, CPU, 2)
    assert i1["lowering"] == i2["lowering"] == "sd" and i2["cg_body"] == body
    assert i1["iterations"] == i2["iterations"] and diff <= 1e-9


@pytest.mark.parametrize("backend", ["sequential", "gpu"])
def test_driver_meets_the_gate(backend):
    """The driver end to end: error against x̂ under the model's gate."""
    be = pt.sequential if backend == "sequential" else CPU
    err, info = pt.prun(pt.elasticity_tet_driver, be, 3, (5, 5, 5))
    assert info["converged"] and err < 1e-5


@pytest.mark.parametrize("lowering", ["auto", "bsr", "ell"])
def test_block_solve_on_irregular_lowering(lowering):
    """The device block (multi-RHS) Jacobi PCG on the SD, BSR and ELL
    lowerings (their slab products): the model's b and A x̂/2 from the
    start x0, each column the iterations of its solo solve, its solution to
    1e-12 of it (bit for bit on BSR and ELL) and under the model's error
    gate."""

    def driver(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (4, 4, 4))
        B = [b, A @ (xh * 0.5)]
        xs, info = pt.pcg(A, B=B, X0=[x0, x0], tol=1e-12, maxiter=500, lowering=lowering)
        solo = [pt.pcg(A, bk, x0=x0, tol=1e-12, maxiter=500, lowering=lowering) for bk in B]
        err = float((xs[0] - xh).norm())
        return info, [pt.gather_pvector(x) for x in xs], [(pt.gather_pvector(x), i) for x, i in solo], err

    info, xs, solo, err = pt.prun(driver, CPU, 2)
    assert info["lowering"] == {"auto": "sd"}.get(lowering, lowering) and info["converged"] and err < 1e-5
    for k, (xk, ik) in enumerate(solo):
        assert info["iterations_per_column"][k] == ik["iterations"]
        if lowering == "auto":
            np.testing.assert_allclose(xs[k], xk, rtol=0, atol=1e-12)
        else:
            assert xs[k].tobytes() == xk.tobytes()
