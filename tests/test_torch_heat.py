"""The transient heat model of the port (`models/heat_transient.py`)
against the JAX package's.

* `assemble_heat` bit for bit: the gathered step operator B, the
  decoupled steady rhs, the interior mask, the start and the steady
  solution, on (6,6)/(2,2) and (8,8,8)/(2,2,2), on both routes of the
  Poisson fixture: the port's COO route (``native.STENCIL_FAST`` off)
  against the JAX package's (``PA_TPU_STENCIL_FAST=0``), and the port's
  COO-free box route against the JAX package's (``-fast``). The two routes
  number the ghost columns in other orders, which reorders the A_oh terms
  each row of b folds.
* The march at (8,8,8)/(2,2,2), dt 0.5, 30 steps: the per-step GMG-PCG
  iterations of the JAX package's on the sequential backends and on the
  device paths (``GPUBackend(device="cpu")`` against ``pa.tpu``); the
  error against the steady solution to rtol=1e-6.
* On ``GPUBackend(device="cpu")`` the march stages the hierarchy once and
  builds one solve function (`gpu_gmg.STATS`); every later step's `pcg`
  reuses both (the loop's buffers are reloaded, nothing is rebuilt).
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.models import heat_transient as jax_heat
from partitionedarrays_jl_tpu_torch import native
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")
MARCH = {"ns": (8, 8, 8), "dt": 0.5, "nsteps": 30}


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes()


def _assembled(parts, m, assemble, ns):
    B, bh, mask, u0, xs = assemble(parts, ns, 0.5)
    M = m.gather_psparse(B)
    return [_bits(M.indptr), _bits(M.indices), _bits(M.data)] + [
        _bits(m.gather_pvector(v)) for v in (bh, mask, u0, xs)
    ]


_CASES = [((6, 6), (2, 2), "6x6/2x2"), ((8, 8, 8), (2, 2, 2), "8^3/2^3")]


@pytest.mark.parametrize("ns,grid,fast", [pytest.param(n, g, False, id=i) for n, g, i in _CASES]
                         + [pytest.param(n, g, True, id=f"{i}-fast") for n, g, i in _CASES])
def test_assemble_heat_bitwise(monkeypatch, ns, grid, fast):
    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "1" if fast else "0")
    monkeypatch.setattr(native, "STENCIL_FAST", fast)
    want = pa.prun(_assembled, pa.sequential, grid, pa, jax_heat.assemble_heat, ns)
    got = pt.prun(_assembled, pt.sequential, grid, pt, pt.assemble_heat, ns)
    assert got == want


@pytest.fixture(scope="module")
def jax_march():
    def drive(be):
        return pa.prun(lambda parts: jax_heat.heat_transient_driver(parts, MARCH["ns"], dt=MARCH["dt"],
                                                                    nsteps=MARCH["nsteps"]), be, (2, 2, 2))

    return {"seq": drive(pa.sequential), "gpu_cpu": drive(pa.tpu)}


@pytest.mark.parametrize("backend", ["seq", "gpu_cpu"])
def test_heat_march_matches_jax(jax_march, backend):
    """Per-step iterations equal to the JAX package's (sequential against
    sequential, the device path against ``pa.tpu``), the error against the
    steady solution to rtol=1e-6; on the device path one staging and one
    solve function over the march."""
    before = dict(gpu_gmg.STATS)
    err, its = pt.prun(
        lambda parts: pt.heat_transient_driver(parts, MARCH["ns"], dt=MARCH["dt"], nsteps=MARCH["nsteps"]),
        {"seq": pt.sequential, "gpu_cpu": CPU}[backend], (2, 2, 2),
    )
    err_j, its_j = jax_march[backend]
    assert its == its_j and len(its) == MARCH["nsteps"]
    np.testing.assert_allclose(err, err_j, rtol=1e-6)
    built = {k: gpu_gmg.STATS[k] - before[k] for k in before}
    assert built == ({"stagings": 1, "pcg_fns": 1} if backend == "gpu_cpu" else {"stagings": 0, "pcg_fns": 0})


def test_second_gmg_pcg_reuses_staging_and_loop():
    """A second ``pcg(A, b, minv=h)`` with the same key takes the cached
    solve function: no staging, no new function, the same `DeviceLoop`
    (its buffers reloaded with the new b and x0) and the same result as a
    fresh hierarchy's first solve; another tol is another function."""
    before = dict(gpu_gmg.STATS)

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (10, 9, 8))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (10, 9, 8), coarse_threshold=60)
        x1, i1 = pt.pcg(Ah, bh, minv=h, tol=1e-9)
        fn = next(iter(h._fn_cache.values()))
        b2 = bh * 0.5
        x2, i2 = pt.pcg(Ah, b2, minv=h, tol=1e-9)
        same = len(h._fn_cache) == 1 and next(iter(h._fn_cache.values())) is fn
        h_fresh = pt.gmg_hierarchy(parts, Ah, (10, 9, 8), coarse_threshold=60)
        x3, i3 = pt.pcg(Ah, b2, minv=h_fresh, tol=1e-9)
        pt.pcg(Ah, bh, minv=h, tol=1e-8)
        return (same, len(h._fn_cache), len(h._device_cache), i2["iterations"] == i3["iterations"],
                np.array_equal(pt.gather_pvector(x2), pt.gather_pvector(x3)), i1["converged"])

    assert pt.prun(drive, CPU, (2, 2, 2)) == (True, 2, 1, True, True, True)
    assert {k: gpu_gmg.STATS[k] - before[k] for k in before} == {"stagings": 2, "pcg_fns": 3}
