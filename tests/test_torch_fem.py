"""The 2-D Q1 FE model of the port (`models/fem_q1.py`) against the JAX
package's (BASELINE.md's Q1 leg, reference test/test_fem_sa.jl).

* `assemble_fem_q1` bit for bit: the gathered A (CSR arrays), b, x̂ and x0,
  and each part's column layout, on the port's sequential backend and on
  ``GPUBackend(device="cpu")`` (the assembly is host work on both) against
  the JAX package's sequential backend. Both sides run the same NumPy
  arithmetic in the same order (b by the left-to-right row fold of the JAX
  package's native host SpMV), so the comparison is exact.
* `fem_q1_driver`: the JAX package's CG iterations on the sequential
  backends, and on the device paths (``GPUBackend(device="cpu")``, the
  coded-DIA lowering's plain versions, against ``pa.tpu`` on the 8-device
  CPU mesh); the reference's gate err < 1e-5 on both.
* `fem_q1_rhs_via_global_view`: the assembled PVector bit for bit the JAX
  package's, ghosts zero.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.models import fem_q1 as jax_fem
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")
CASES = {"8x8/2x2": ((8, 8), (2, 2)), "9x7/2x2": ((9, 7), (2, 2)), "8x8/1x1": ((8, 8), (1, 1)),
         "13x11/2x4": ((13, 11), (2, 4))}


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes()


def _assembled(parts, m, ns):
    A, b, xe, x0 = m.assemble_fem_q1(parts, ns)
    M = m.gather_psparse(A)
    return {
        "A": [_bits(M.indptr), _bits(M.indices), _bits(M.data), M.shape],
        "vecs": [_bits(m.gather_pvector(v)) for v in (b, xe, x0)],
        "cols": [_bits(i.lid_to_gid) for i in A.cols.partition.part_values()],
        "ghost_vals": [_bits(np.asarray(v)[i.num_oids:]) for v, i in zip(xe.values.part_values(),
                                                                         xe.rows.partition.part_values())],
    }


@pytest.mark.parametrize("backend", ["seq", "gpu_cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_fem_q1_bitwise(case, backend):
    ns, grid = CASES[case]
    want = pa.prun(_assembled, pa.sequential, grid, pa, ns)
    got = pt.prun(_assembled, {"seq": pt.sequential, "gpu_cpu": CPU}[backend], grid, pt, ns)
    assert got == want


def _drive(parts, m, ns):
    err, info = m.fem_q1_driver(parts, ns)
    return err, info["iterations"], info["converged"], info.get("lowering")


@pytest.mark.parametrize("case", ["8x8/2x2", "9x7/2x2", "13x11/2x4"])
def test_fem_q1_driver_iterations_sequential(case):
    """Host CG on both sequential backends: the same iterations (the
    tolerance is the gate err < 1e-5, and the errors agree to 1e-9)."""
    ns, grid = CASES[case]
    err_j, it_j, conv_j, _ = pa.prun(_drive, pa.sequential, grid, pa, ns)
    err, it, conv, _ = pt.prun(_drive, pt.sequential, grid, pt, ns)
    assert conv and conv_j and it == it_j
    assert err < 1e-5 and err_j < 1e-5
    assert abs(err - err_j) < 1e-9


@pytest.mark.parametrize("case", ["8x8/2x2", "13x11/2x4"])
def test_fem_q1_driver_iterations_device(case):
    """The device CG (`gpu_cg`, the 9-point operator on the coded
    lowering) against the JAX package's ``pa.tpu``: the same iterations,
    err < 1e-5 on both, errors within 1e-9."""
    ns, grid = CASES[case]
    err_j, it_j, conv_j, _ = pa.prun(_drive, pa.tpu, grid, pa, ns)
    err, it, conv, lowering = pt.prun(_drive, CPU, grid, pt, ns)
    assert lowering == "coded"
    assert conv and conv_j and it == it_j
    assert err < 1e-5 and err_j < 1e-5
    assert abs(err - err_j) < 1e-9


@pytest.mark.parametrize("backend", ["seq", "gpu_cpu"])
@pytest.mark.parametrize("case", ["8x8/2x2", "13x11/2x4"])
def test_rhs_via_global_view_bitwise(case, backend):
    ns, grid = CASES[case]

    def run(parts, m, f):
        v = f(parts, ns)
        ghosts = [np.asarray(x)[i.hid_to_lid] for x, i in zip(v.values.part_values(), v.rows.partition.part_values())]
        return _bits(m.gather_pvector(v)), [_bits(x) for x in v.values.part_values()], ghosts

    gv_j, vals_j, _ = pa.prun(run, pa.sequential, grid, pa, jax_fem.fem_q1_rhs_via_global_view)
    gv, vals, ghosts = pt.prun(run, {"seq": pt.sequential, "gpu_cpu": CPU}[backend], grid, pt,
                               pt.fem_q1_rhs_via_global_view)
    assert gv == gv_j and vals == vals_j
    assert all((g == 0).all() for g in ghosts) and sum(len(g) for g in ghosts) > 0
    # every interior node touches 4 elements, an edge node 2, a corner 1
    total = np.frombuffer(gv[2], dtype=np.float64)
    assert total.sum() == 4.0 * (ns[0] - 1) * (ns[1] - 1)


# --- the periodic Poisson operator (models/poisson_fdm.py) --------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ns,grid", [((6, 5, 4), (2, 2, 1)), ((8, 8, 8), (2, 2, 2))], ids=["6x5x4/2x2x1", "8^3/2^3"])
def test_assemble_poisson_periodic_bitwise(ns, grid, dtype):
    """`assemble_poisson_periodic` bit for bit the JAX package's: each
    part's local CSR and column layout, and A, b, x̂ and x0 gathered."""
    from partitionedarrays_jl_tpu.models.poisson_fdm import assemble_poisson_periodic as jax_periodic

    def run(parts, m, f):
        A, b, xe, x0 = f(parts, ns, shift=1.0, dtype=dtype)
        M = m.gather_psparse(A)
        local = [[_bits(a) for a in (L.indptr, L.indices, L.data)] for L in A.values.part_values()]
        return ([_bits(M.indptr), _bits(M.indices), _bits(M.data)], local,
                [_bits(i.lid_to_gid) for i in A.cols.partition.part_values()],
                [_bits(m.gather_pvector(v)) for v in (b, xe, x0)])

    want = pa.prun(run, pa.sequential, grid, pa, jax_periodic)
    got = pt.prun(run, pt.sequential, grid, pt, pt.assemble_poisson_periodic)
    assert got == want
    assert got[0][2][0] == np.dtype(dtype).str
