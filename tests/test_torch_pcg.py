"""Jacobi PCG on the port's device loop and the repaired fused and pipelined
CG bodies on a streaming-DIA operator, against the JAX package.

The systems, made by the JAX package on the 8-device CPU mesh (f64, (2,2,2)
parts) and carried to the port as plain arrays (`interop`):

* the decoupled 7-point Poisson operator on 8^3 (the coded-DIA lowering);
* the variable-coefficient 7-point operator of
  tools/bench_multirhs.py:assemble_varcoef_poisson on (10, 9, 8) after
  `decouple_dirichlet`, b = A x̂ for a seeded x̂ (every diagonal holds many
  values: the streaming-DIA lowering).

Held on `GPUBackend(device="cpu")`, on the box and the generic exchange
plans, against the JAX package's solves of the same inputs:

* the repair: `cg` on the streaming operator runs the fused body by
  default and the pipelined body on request, with the JAX package's
  iterations (`pa.cg`, fused and pipelined); solutions to 1e-10;
* Jacobi PCG (`pt.pcg(A, b)`, the default diagonal minv) in the fused and
  the standard body, on both operators: the iterations of `pa.pcg` (fused
  and standard), the residual histories to rtol 1e-12, the solutions to
  1e-10;
* the plain versions of K2 with minv and of the sweep's precond form
  against the eager expressions they stand for (f32 and f64).
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import sweep as sw
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, device_matrix

CPU = GPUBackend(device="cpu")
ROOT = Path(__file__).resolve().parents[1]
PARTS = (2, 2, 2)
POISSON_NS = (8, 8, 8)
VARCOEF_NS = (10, 9, 8)
TOL = 1e-8


def assemble_varcoef(parts, ns):
    """tools/bench_multirhs.py:assemble_varcoef_poisson (f64) on any parts:
    the tool builds its column range as a copy of the rows, which holds on
    one part only, so its call of `PSparseMatrix.from_coo` is given the
    column ghost layer of the stencil (`add_gids`, as `assemble_poisson`
    discovers it); the entries are the tool's."""
    spec = importlib.util.spec_from_file_location("bench_multirhs", ROOT / "tools" / "bench_multirhs.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    class _PSparse:
        @staticmethod
        def from_coo(I, J, V, rows, _cols, ids):
            return pa.PSparseMatrix.from_coo(I, J, V, rows, pa.add_gids(rows, J), ids=ids)

    shim = types.SimpleNamespace(**{k: getattr(pa, k) for k in dir(pa) if not k.startswith("__")})
    shim.PSparseMatrix = _PSparse
    return tool.assemble_varcoef_poisson(parts, ns, shim, dtype=np.float64)


def _iset_arrays(r):
    isets = r.partition.part_values()
    return {
        "lid_to_gid": [np.asarray(i.lid_to_gid) for i in isets],
        "lid_to_part": [np.asarray(i.lid_to_part) for i in isets],
        "grid_shape": isets[0].grid_shape,
        "boxes": [(i.box_lo, i.box_hi) for i in isets],
    }


def export_system(A, b):
    """A JAX-package operator and right-hand side as plain arrays."""
    return {
        "ngids": A.rows.ngids, "rows": _iset_arrays(A.rows), "cols": _iset_arrays(A.cols),
        "csr": [(M.indptr, M.indices, M.data, M.shape) for M in A.values.part_values()],
        "b": [np.asarray(v) for v in b.values.part_values()],
    }


def carry_system(parts, e):
    """The exported system as port objects (rows and cols from the lid
    maps, Cartesian boxes kept, so the box plan is detected)."""

    def prange(r):
        return interop.prange_from_arrays(parts, e["ngids"], r["lid_to_gid"], r["lid_to_part"],
                                          grid_shape=r["grid_shape"], boxes=r["boxes"])

    rows, cols = prange(e["rows"]), prange(e["cols"])
    return interop.psparse_from_csr(rows, cols, e["csr"]), interop.pvector_from_values(rows, e["b"])


def jax_systems(parts):
    """The decoupled Poisson and varcoef systems in the JAX package."""
    A, b, _, _ = pa.assemble_poisson(parts, POISSON_NS)
    Ap, bp = pa.decouple_dirichlet(A, b)
    Av = assemble_varcoef(parts, VARCOEF_NS)
    rng = np.random.default_rng(5)
    xg = rng.standard_normal(Av.cols.ngids)
    xh = pa.PVector(pa.map_parts(lambda i: xg[np.asarray(i.lid_to_gid)], Av.cols.partition), Av.cols)
    Av2, bv = pa.decouple_dirichlet(Av, Av @ xh)
    return {"poisson": (Ap, bp), "varcoef": (Av2, bv)}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's solves of both systems, and the systems exported."""

    def driver(parts):
        out = {}
        for name, (A, b) in jax_systems(parts).items():
            res = {"system": export_system(A, b)}
            for body, kw in (("fused", {"fused": True}), ("pipelined", {"pipelined": True})):
                x, info = pa.cg(A, b, tol=TOL, **kw)
                res["cg_" + body] = (pa.gather_pvector(x), info["iterations"], np.asarray(info["residuals"]))
            for body, fused in (("fused", True), ("standard", False)):
                x, info = pa.pcg(A, b, tol=TOL, fused=fused)
                assert info["cg_body"] == body
                res["pcg_" + body] = (pa.gather_pvector(x), info["iterations"], np.asarray(info["residuals"]))
            out[name] = res
        return out

    return pa.prun(driver, pa.tpu, PARTS)


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
@pytest.mark.parametrize("body", ["fused", "pipelined", "standard"])
def test_cg_on_streaming_operator_matches_jax(reference, body, box):
    """The repaired fault: the port's `cg` on a streaming-DIA operator ran
    only the standard body (the fused and pipelined bodies asserted a coded
    operator). Each body now runs there, with the JAX package's
    iterations (its fused and pipelined solves; the standard body follows
    the same recurrence) and its solution to 1e-10."""
    ref = reference["varcoef"]

    def driver(parts):
        A, b = carry_system(parts, ref["system"])
        assert device_matrix(A, parts.backend, box).dia_mode == "stream"
        kw = {"pipelined": {"pipelined": True}, "standard": {"fused": False}}.get(body, {})
        x, info = pt.cg(A, b, tol=TOL, box=box, **kw)
        return pt.gather_pvector(x), info

    x, info = pt.prun(driver, CPU, PARTS)
    assert info["cg_body"] == body and info["converged"]
    want_x, want_it, _ = ref["cg_pipelined" if body == "pipelined" else "cg_fused"]
    assert info["iterations"] == want_it
    np.testing.assert_allclose(x, want_x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
@pytest.mark.parametrize("body", ["fused", "standard"])
@pytest.mark.parametrize("system", ["poisson", "varcoef"], ids=["coded", "stream"])
def test_jacobi_pcg_matches_jax(reference, system, body, box):
    """`pt.pcg(A, b)` with its default Jacobi minv runs the device loop
    (no longer NotImplementedError) in the fused and the standard body:
    `pa.pcg`'s iterations, its residual history to rtol 1e-12 and its
    solution to 1e-10."""
    ref = reference[system]

    def driver(parts):
        A, b = carry_system(parts, ref["system"])
        mode = device_matrix(A, parts.backend, box).dia_mode
        x, info = pt.pcg(A, b, tol=TOL, fused=body == "fused", box=box)
        return pt.gather_pvector(x), info, mode

    x, info, mode = pt.prun(driver, CPU, PARTS)
    assert mode == ("coded" if system == "poisson" else "stream")
    assert info["cg_body"] == body and info["converged"] and info["device_loop"]["loop"] == "eager"
    want_x, want_it, want_h = ref["pcg_" + body]
    assert info["iterations"] == want_it
    np.testing.assert_allclose(info["residuals"], want_h, rtol=1e-12, atol=0)
    np.testing.assert_allclose(x, want_x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("decode", ["row_class", "select_chain"])
def test_pfold_minv_plain_is_the_eager_fold(decode, dtype):
    """K2's plain version with minv: p = minv*r + beta*pprev on the owned
    band (each product rounded, then the add), 0 elsewhere, and y the
    plain SpMV of that p; without minv it is the fold it was."""
    dia.reset_launches()
    nparts = (1, 1, 1) if decode == "row_class" else (2, 2, 2)
    op = pt.prun(lambda parts: device_matrix(pt.assemble_poisson(parts, (9, 8, 7))[0], parts.backend).coded,
                 CPU, nparts)
    assert (op.cls_pattern is not None) == (decode == "row_class")
    op = dia.CodedOperator(cb=op.cb.to(dtype), no=op.no, codes=op.codes, offsets=op.offsets, kk=op.kk,
                           code_row=op.code_row, cls_pattern=op.cls_pattern, o0=op.o0)
    rng = np.random.default_rng(3)
    P, w = op.cb.shape[0], op.n + 11
    r, pprev, minv = (torch.from_numpy(rng.standard_normal((P, w))).to(dtype) for _ in range(3))
    beta = torch.tensor(0.375, dtype=dtype)
    y, p = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 2, minv=minv)
    own = torch.arange(op.n)[None, :] < op.no[:, None]
    band = slice(op.o0, op.o0 + op.n)
    want = torch.zeros_like(r)
    want[:, band] = torch.where(own, minv[:, band] * r[:, band] + beta * pprev[:, band], 0)
    assert torch.equal(p, want)
    assert torch.equal(y, dia.dia_coded_spmv_plain(op, want, w + 2))
    y0, p0 = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 2)
    want[:, band] = torch.where(own, r[:, band] + beta * pprev[:, band], 0)
    assert torch.equal(p0, want) and torch.equal(y0, dia.dia_coded_spmv_plain(op, want, w + 2))
    assert dia.LAUNCHES["dia_coded_spmv_pfold_minv"] == 0  # the plain version launches nothing


@pytest.mark.parametrize("live", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_precond_sweep_plain_is_the_eager_update(dtype, live):
    """The sweep's precond form (plain version): x and r as the eager
    update of the PCG body, the r.r partials as the solo sweep's, the r.z
    partials those of r*(minv*r) in the same order, rz and rs their folds;
    a float64 sum agrees; the flag 0 writes nothing."""
    rng = np.random.default_rng(9)
    P, o0, n = 3, 4, 5000
    x, r, p, minv, q = (torch.from_numpy(rng.standard_normal((P, o0 + n + 6))).to(dtype) for _ in range(5))
    alpha = torch.tensor(-0.4375, dtype=dtype)
    flag = torch.tensor(live, dtype=torch.int32)
    part = sw.sweep_partials(r, n, 2)
    xk, rk = x.clone(), r.clone()
    rz, rs = sw.cg_sweep(rk, q, alpha, flag, part, o0, n, x=xk, p=p, minv=minv)
    band = slice(o0, o0 + n)
    if not live:
        assert torch.equal(xk, x) and torch.equal(rk, r) and not part.any()
        return
    rn = r[:, band] + (-alpha) * q[:, band]
    assert torch.equal(rk[:, band], rn) and torch.equal(xk[:, band], x[:, band] + alpha * p[:, band])
    part1 = sw.sweep_partials(r, n)
    rs1 = sw.cg_sweep_plain(r.clone(), q, alpha, flag, part1, o0, n)
    assert torch.equal(part[:, 1], part1) and torch.equal(rs, rs1)
    assert torch.equal(part[:, 0], sw._partials(rn, minv[:, band] * rn))
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    want = float((rn.double() * (minv[:, band].double() * rn.double())).sum())
    assert abs(float(rz) - want) <= tol * float((rn.double() ** 2 * minv[:, band].double().abs()).sum())
