"""The upwind advection-diffusion FV model of the port
(`models/advection_fv.py`) against the JAX package's, and its BiCGStab
solve on both port backends (the JAX package's `tests/test_advection_fv.py`).

* `assemble_advection_fv` bit for bit: the gathered CSR (indptr, indices,
  values), b, x̂ and x0 on (8,8)/(2,2) with velocity (2, -1) and on
  (10,10,6)/(2,2,2) with the default velocity, on both routes: the port's
  COO route (``native.STENCIL_FAST`` off) against the JAX package's
  (``PA_TPU_STENCIL_FAST=0``), and the port's COO-free box route against
  the JAX package's (``-fast``). The two routes number the ghost columns
  in other orders, which reorders the A_oh terms each row of b folds.
* The operator is nonsymmetric and weakly diagonally dominant.
* `advection_fv_driver` at 12^2 on (2,2) and (4,1): converged, error <
  1e-5 (test_advection_fv.py:23-31), on the port's sequential backend and
  ``GPUBackend(device="cpu")``, iterations within 2 of the JAX package's.
* At (10,10,6)/(2,2,2), velocity (1, -0.5, 0.25), against the sequential
  backends (test_advection_fv.py:33-47): both converged, both errors < 1e-5,
  |Δ error| < 1e-8, |Δ iterations| <= 2, on the box and the generic plan.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.models import advection_fv as jax_adv
from partitionedarrays_jl_tpu_torch import native
from partitionedarrays_jl_tpu_torch.models.solvers import _dense
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes()


def _assembled(parts, m, assemble, ns, velocity):
    A, b, xe, x0 = assemble(parts, ns, velocity)
    M = m.gather_psparse(A)
    return [_bits(M.indptr), _bits(M.indices), _bits(M.data)] + [_bits(m.gather_pvector(v)) for v in (b, xe, x0)]


_CASES = [((8, 8), (2, 2), (2.0, -1.0), "8x8/2x2"), ((10, 10, 6), (2, 2, 2), None, "10x10x6/2^3")]


@pytest.mark.parametrize("ns,grid,velocity,fast",
                         [pytest.param(n, g, v, False, id=i) for n, g, v, i in _CASES]
                         + [pytest.param(n, g, v, True, id=f"{i}-fast") for n, g, v, i in _CASES])
def test_assemble_advection_fv_bitwise(monkeypatch, ns, grid, velocity, fast):
    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "1" if fast else "0")
    monkeypatch.setattr(native, "STENCIL_FAST", fast)
    want = pa.prun(_assembled, pa.sequential, grid, pa, jax_adv.assemble_advection_fv, ns, velocity)
    for be in (pt.sequential, CPU):
        assert pt.prun(_assembled, be, grid, pt, pt.assemble_advection_fv, ns, velocity) == want


def test_operator_is_nonsymmetric_and_diagonally_dominant():
    def driver(parts):
        A, _, _, _ = pt.assemble_advection_fv(parts, (8, 8), velocity=(2.0, -1.0))
        d = _dense(pt.gather_psparse(A))
        off = np.abs(d).sum(1) - np.abs(np.diag(d))
        return not np.allclose(d, d.T), bool((np.diag(d) >= off - 1e-12).all())

    assert pt.prun(driver, pt.sequential, (2, 2)) == (True, True)


@pytest.mark.parametrize("nparts", [(2, 2), (4, 1)])
def test_fv_bicgstab_both_backends(nparts):
    def run(m, be):
        return m.prun(lambda parts: m.advection_fv_driver(parts, (12, 12)), be, nparts)

    _, info_j = run(pa, pa.sequential)
    for be in (pt.sequential, CPU):
        err, info = run(pt, be)
        assert info["converged"] and err < 1e-5, (be, err)
        assert abs(info["iterations"] - info_j["iterations"]) <= 2, (be, info["iterations"], info_j["iterations"])


@pytest.fixture(scope="module")
def jax_3d():
    def run(be):
        return pa.prun(lambda parts: pa.advection_fv_driver(parts, (10, 10, 6), velocity=(1.0, -0.5, 0.25)),
                       be, (2, 2, 2))

    return run(pa.sequential), run(pa.tpu)


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_fv_bicgstab_device_matches_sequential(jax_3d, box):
    """test_advection_fv.py:33-47, the device loop on the box and the generic
    plan against the port's and the JAX package's sequential backends and
    the JAX package's device program."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_advection_fv(parts, (10, 10, 6), velocity=(1.0, -0.5, 0.25))
        x, info = pt.gpu_bicgstab(A, b, x0=x0, tol=1e-12, maxiter=4000, box=box)
        return float((x - xe).norm()), info

    err_s, info_s = pt.prun(lambda parts: pt.advection_fv_driver(parts, (10, 10, 6), velocity=(1.0, -0.5, 0.25)),
                            pt.sequential, (2, 2, 2))
    err_g, info_g = pt.prun(driver, CPU, (2, 2, 2))
    (err_js, info_js), (err_jt, info_jt) = jax_3d
    assert info_s["converged"] and info_g["converged"]
    assert err_s < 1e-5 and err_g < 1e-5
    assert abs(err_g - err_s) < 1e-8 and abs(err_g - err_js) < 1e-8 and abs(err_g - err_jt) < 1e-8
    for it in (info_s["iterations"], info_js["iterations"], info_jt["iterations"]):
        assert abs(info_g["iterations"] - it) <= 2, (info_g["iterations"], it)
    assert info_g["device_loop"]["loop"] == "eager"


def test_velocity_dimension_validated():
    def driver(parts):
        with pytest.raises(AssertionError):
            pt.assemble_advection_fv(parts, (8, 8), velocity=(1.0, 1.0, 1.0))
        return True

    assert pt.prun(driver, pt.sequential, (2, 2))
