"""Block (multi-RHS) CG and PCG on the port's device loop against the JAX
package, and the block kernels' plain versions against the single-vector
ones.

The systems are test_torch_pcg.py's: the decoupled 8^3 Poisson operator
(coded-DIA) and the decoupled (10, 9, 8) variable-coefficient operator
(streaming DIA), made by the JAX package on the 8-device CPU mesh (f64,
(2,2,2) parts) and carried over as plain arrays. The block is the ragged
one of tests/test_block_cg.py:_ragged_block: the assembled b, a seeded
random vector and a 1e-3 constant, three right-hand sides whose solo
solves take different iterations.

On `GPUBackend(device="cpu")`, both exchange plans:

* `pt.cg(A, B=...)` / `pt.pcg(A, B=..., minv=jacobi)` in the fused and the
  standard body, on both operators: per-column iterations equal to the
  JAX package's block solve (`pa.cg(A, B=...)`, `pa.pcg(A, B=...)` on
  ``pa.tpu``, i.e. `tpu_block_cg`) and to the port's solo solves of each
  column, not all equal; histories to rtol 1e-12 of the JAX package's
  (atol 1e-15 of the initial residual: a column that converges to the
  rounding floor ends where the two packages' dot orders differ),
  nothing logged past a column's freeze; solutions to 1e-10; each column
  bit for bit the port's solo solve (K = 1 blocks too); the info keys;
* the host backend runs the solo loops column by column;
* ``column_errors``: a NaN column is reported ``"nonfinite"`` while the
  others reach their solo results bit for bit, or raises `NonFiniteError`
  (the JAX package's type name); ``pipelined=True`` with ``B`` raises;
* plain versions, K = 1, 3, 5, 8, f32 and f64: `dia_coded_spmm_plain` and
  `dia_stream_spmm_plain` column k torch.equal to K1's and K4's plain
  versions on column k (the pfold form to K2's with and without minv),
  the block sweep's column k torch.equal to the solo sweep (its partials
  and folds too), and the slab exchange column by column;
* the import scan (tests/test_torch_slice.py) takes the new modules.
"""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.parallel.health import NonFiniteError as JaxNonFiniteError
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import sweep as sw
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    GPUBackend,
    device_exchange_plan,
    device_layout,
    device_matrix,
    exchange_,
    gpu_cg,
)
from partitionedarrays_jl_tpu_torch.utils.health import NonFiniteError
from test_torch_pcg import PARTS, carry_system, export_system, jax_systems

CPU = GPUBackend(device="cpu")
TOL = 1e-8
MAXITER = 400
CASES = [(s, b, m) for s in ("poisson", "varcoef") for b in ("fused", "standard") for m in (False, True)]
CASE_IDS = [f"{'coded' if s == 'poisson' else 'stream'}-{b}-{'jacobi' if m else 'cg'}" for s, b, m in CASES]


def ragged_block(A, b, pkg):
    """tests/test_block_cg.py:_ragged_block: b, a random vector (seed 11)
    and a 1e-3 constant, over A.rows."""
    rng = np.random.default_rng(11)
    xg = rng.standard_normal(A.rows.ngids)

    def vec(f):
        return pkg.PVector(pkg.map_parts(f, A.rows.partition), A.rows)

    return [b, vec(lambda i: xg[np.asarray(i.lid_to_gid)]), vec(lambda i: np.full(i.num_lids, 1e-3))]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's block solves of the ragged block on both systems,
    every body, with and without Jacobi; the systems and blocks exported."""

    def driver(parts):
        out = {}
        for name, (A, b) in jax_systems(parts).items():
            B = ragged_block(A, b, pa)
            res = {"system": export_system(A, b), "B": [[np.asarray(v) for v in bk.values.part_values()] for bk in B]}
            for body in ("fused", "standard"):
                for jacobi in (False, True):
                    kw = dict(B=B, tol=TOL, maxiter=MAXITER, fused=body == "fused")
                    xs, info = pa.pcg(A, **kw) if jacobi else pa.cg(A, **kw)
                    assert info["cg_body"] == body and info["rhs_batch"] == 3
                    res[body, jacobi] = {
                        "x": [pa.gather_pvector(x) for x in xs], "its": info["iterations_per_column"],
                        "hist": [np.asarray(c["residuals"]) for c in info["columns"]],
                    }
            out[name] = res
        return out

    return pa.prun(driver, pa.tpu, PARTS)


def carry_block(parts, ref):
    A, b = carry_system(parts, ref["system"])
    B = [pt.interop.pvector_from_values(A.rows, vals) for vals in ref["B"]]
    return A, B


def _flat(x):
    return np.concatenate([np.asarray(v) for v in x.values.part_values()])


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
@pytest.mark.parametrize("system,body,jacobi", CASES, ids=CASE_IDS)
def test_block_matches_jax_and_solo(reference, system, body, jacobi, box):
    ref = reference[system]
    want = ref[body, jacobi]

    def driver(parts):
        A, B = carry_block(parts, ref)
        mode = device_matrix(A, parts.backend, box).dia_mode
        kw = dict(B=B, tol=TOL, maxiter=MAXITER, fused=body == "fused", box=box)
        xs, info = pt.pcg(A, **kw) if jacobi else pt.cg(A, **kw)
        minv = pt.jacobi_preconditioner(A) if jacobi else None
        solo = [gpu_cg(A, bk, tol=TOL, maxiter=MAXITER, fused=body == "fused", box=box, minv=minv) for bk in B]
        return mode, [pt.gather_pvector(x) for x in xs], [_flat(x) for x in xs], info, [
            (_flat(x), i) for x, i in solo]

    mode, xs, flat, info, solo = pt.prun(driver, CPU, PARTS)
    assert mode == ("coded" if system == "poisson" else "stream")
    assert {"columns", "iterations_per_column", "rhs_batch", "cg_body", "column_health"} <= set(info)
    assert info["cg_body"] == body and info["rhs_batch"] == 3 and info["converged"]
    its = info["iterations_per_column"]
    assert its == want["its"] and len(set(its)) > 1 and info["iterations"] == max(its)
    for k in range(3):
        assert solo[k][1]["iterations"] == its[k]
        assert np.array_equal(flat[k], solo[k][0])  # the column is its solo solve, bit for bit
        hist = np.asarray(info["columns"][k]["residuals"])
        assert len(hist) == its[k] + 1  # nothing logged past the column's freeze
        assert np.array_equal(hist, np.asarray(solo[k][1]["residuals"]))
        # rtol 1e-12, and 1e-15 of the initial residual for entries at the
        # rounding floor (the 1e-3 column ends near 1e-16 of its start,
        # where the two packages' dot orders differ in the last bits)
        np.testing.assert_allclose(hist, want["hist"][k], rtol=1e-12, atol=1e-15 * want["hist"][k][0])
        np.testing.assert_allclose(xs[k], want["x"][k], rtol=0, atol=1e-10)
        assert info["column_health"][k] == {"status": "ok", "converged": True, "iterations": its[k]}


@pytest.mark.parametrize("system,body,jacobi", CASES, ids=CASE_IDS)
def test_block_of_one_is_the_solo_solve(reference, system, body, jacobi):
    """A K = 1 block equals the port's solo solve bit for bit: solution,
    iterations and history."""
    ref = reference[system]

    def driver(parts):
        A, B = carry_block(parts, ref)
        minv = pt.jacobi_preconditioner(A) if jacobi else None
        kw = dict(tol=TOL, maxiter=MAXITER, fused=body == "fused")
        xs, info = pt.pcg(A, B=B[1:2], **kw) if jacobi else pt.cg(A, B=B[1:2], **kw)
        x, solo = gpu_cg(A, B[1], minv=minv, **kw)
        return _flat(xs[0]), info, _flat(x), solo

    xb, info, xs, solo = pt.prun(driver, CPU, PARTS)
    assert info["rhs_batch"] == 1 and info["iterations_per_column"] == [solo["iterations"]]
    assert np.array_equal(xb, xs)
    assert np.array_equal(info["columns"][0]["residuals"], solo["residuals"])


@pytest.mark.parametrize("jacobi", [False, True], ids=["cg", "jacobi"])
def test_host_backend_runs_solo_loops(reference, jacobi):
    """On the sequential backend a block runs the host loop column by
    column: per-column iterations and solutions those of the solo host
    solves, ``cg_body`` "host"."""
    ref = reference["poisson"]

    def driver(parts):
        A, B = carry_block(parts, ref)
        solve = pt.pcg if jacobi else pt.cg
        xs, info = solve(A, B=B, tol=TOL, maxiter=MAXITER)
        solo = [solve(A, bk, tol=TOL, maxiter=MAXITER) for bk in B]
        return [_flat(x) for x in xs], info, [(_flat(x), i["iterations"]) for x, i in solo]

    xs, info, solo = pt.prun(driver, pt.sequential, PARTS)
    assert info["cg_body"] == "host" and info["rhs_batch"] == 3
    assert info["iterations_per_column"] == [it for _, it in solo]
    assert len(set(info["iterations_per_column"])) > 1
    for x, (xk, _) in zip(xs, solo):
        assert np.array_equal(x, xk)


@pytest.mark.parametrize("body", ["fused", "standard"])
def test_column_errors(reference, body):
    """One NaN column in a block: with ``column_errors="report"`` its
    verdict is "nonfinite" and the other columns reach their solo results
    bit for bit; with "raise" (the default) the solve raises
    `NonFiniteError`, the JAX package's type name."""
    ref = reference["varcoef"]

    def driver(parts):
        A, B = carry_block(parts, ref)
        vals = [np.array(v) for v in B[1].values.part_values()]
        vals[3][0] = np.nan
        B[1] = pt.interop.pvector_from_values(A.rows, vals)
        kw = dict(tol=TOL, maxiter=MAXITER, fused=body == "fused")
        xs, info = pt.cg(A, B=B, column_errors="report", **kw)
        with pytest.raises(NonFiniteError) as err:
            pt.cg(A, B=B, **kw)
        solo = [gpu_cg(A, B[k], **kw) for k in (0, 2)]
        return [_flat(x) for x in xs], info, [(_flat(x), i["iterations"]) for x, i in solo], err.value

    xs, info, solo, err = pt.prun(driver, CPU, PARTS)
    assert type(err).__name__ == JaxNonFiniteError.__name__ and err.diagnostics["columns"] == [1]
    health = info["column_health"]
    assert health[1]["status"] == "nonfinite" and not health[1]["converged"]
    assert info["columns"][1]["status"] == "nonfinite" and not info["converged"]
    for k, (x, it) in zip((0, 2), solo):
        assert health[k] == {"status": "ok", "converged": True, "iterations": it}
        assert np.array_equal(xs[k], x)


def test_pipelined_block_raises(reference):
    def driver(parts):
        A, B = carry_block(parts, reference["poisson"])
        with pytest.raises(ValueError, match="single-RHS"):
            pt.cg(A, B=B, pipelined=True)
        with pytest.raises(AssertionError, match="not both"):
            pt.cg(A, B[0], B=B)
        return True

    assert pt.prun(driver, CPU, PARTS)


# ---------------------------------------------------------------------------
# plain versions of the block kernels against the single-vector ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def operators(reference):
    """The port's lowerings of both systems (coded and streaming)."""

    def driver(parts):
        return {name: device_matrix(carry_block(parts, reference[name])[0], parts.backend)
                for name in ("poisson", "varcoef")}

    return pt.prun(driver, CPU, PARTS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 3, 5, 8])
@pytest.mark.parametrize("system", ["poisson", "varcoef"], ids=["coded", "stream"])
def test_spmm_plain_columns_are_the_spmv(operators, system, K, dtype):
    dia.reset_launches()
    dA = operators[system]
    rng = np.random.default_rng(K)
    P, wx, wy = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W
    x, pprev = (torch.from_numpy(rng.standard_normal((P, wx, K))).to(dtype) for _ in range(2))
    if system == "varcoef":
        vals = dA.stream_vals.to(dtype)
        y = dia.dia_stream_spmm(vals, x, dA.dia_offsets, dA.stream_no, dA.row_layout.o0, wy)
        for k in range(K):
            assert torch.equal(y[..., k], dia.dia_stream_spmv_plain(vals, x[..., k], dA.dia_offsets, dA.stream_no,
                                                                    dA.row_layout.o0, wy))
        assert dia.LAUNCHES["dia_stream_spmm"] == 0
        return
    c = dA.coded
    op = dia.CodedOperator(cb=c.cb.to(dtype), no=c.no, codes=c.codes, offsets=c.offsets, kk=c.kk,
                           code_row=c.code_row, cls_pattern=c.cls_pattern, o0=c.o0)
    beta = torch.from_numpy(rng.standard_normal(K)).to(dtype)
    minv = torch.from_numpy(rng.standard_normal((P, wx))).to(dtype)
    y = dia.dia_coded_spmm(op, x, wy)
    yf, pf = dia.dia_coded_spmm_pfold(op, x, pprev, beta, wy)
    ym, pm = dia.dia_coded_spmm_pfold(op, x, pprev, beta, wy, minv=minv)
    for k in range(K):
        xk, pk = x[..., k].contiguous(), pprev[..., k].contiguous()
        assert torch.equal(y[..., k], dia.dia_coded_spmv_plain(op, xk, wy))
        y1, p1 = dia.dia_coded_spmv_pfold_plain(op, xk, pk, beta[k], wy)
        assert torch.equal(yf[..., k], y1) and torch.equal(pf[..., k], p1)
        y1, p1 = dia.dia_coded_spmv_pfold_plain(op, xk, pk, beta[k], wy, minv=minv)
        assert torch.equal(ym[..., k], y1) and torch.equal(pm[..., k], p1)
    assert dia.LAUNCHES["dia_coded_spmm"] == 0


@pytest.mark.parametrize("with_minv", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 3, 5, 8])
def test_block_sweep_plain_columns_are_the_solo_sweep(K, dtype, with_minv):
    """The block sweep (plain version) on three stacked parts, every third
    column frozen: an active column's x, r, partials and fold torch.equal
    to the solo sweep of that column; a frozen column untouched."""
    dia.reset_launches()
    rng = np.random.default_rng(K + 20)
    P, o0, n = 3, 5, 5000

    def mk(w, k=K):
        return torch.from_numpy(rng.standard_normal((P, w, k))).to(dtype)

    x, r, p, q = mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 2)
    minv = mk(o0 + n + 7, 1)[..., 0].contiguous() if with_minv else None
    S = 2 * K if with_minv else K
    part = torch.from_numpy(rng.standard_normal((P, S, sw.chunks(n))) ** 2).to(dtype)
    alpha = torch.from_numpy(rng.standard_normal(K)).to(dtype)
    act = torch.tensor([int(k % 3 != 2) for k in range(K)], dtype=torch.int32)
    xb, rb, pb = x.clone(), r.clone(), part.clone()
    got = sw.cg_sweep_block(rb, q, alpha, act, pb, o0, n, x=xb, p=p, minv=minv)
    one = torch.ones((), dtype=torch.int32)
    for k in range(K):
        if not act[k]:
            assert torch.equal(xb[..., k], x[..., k]) and torch.equal(rb[..., k], r[..., k])
            assert torch.equal(pb[:, 2 * k : 2 * k + 2] if with_minv else pb[:, k],
                               part[:, 2 * k : 2 * k + 2] if with_minv else part[:, k])
            continue
        xs, rs_ = x[..., k].contiguous(), r[..., k].contiguous()
        ps = (part[:, 2 * k : 2 * k + 2] if with_minv else part[:, k]).contiguous()
        solo = sw.cg_sweep(rs_, q[..., k].contiguous(), alpha[k], one, ps, o0, n, x=xs, p=p[..., k].contiguous(),
                           minv=minv)
        assert torch.equal(xs, xb[..., k]) and torch.equal(rs_, rb[..., k])
        assert torch.equal(ps, pb[:, 2 * k : 2 * k + 2] if with_minv else pb[:, k])
        if with_minv:
            assert torch.equal(solo[0], got[0][k]) and torch.equal(solo[1], got[1][k])
        else:
            assert torch.equal(solo, got[k])
    assert dia.LAUNCHES["cg_sweep_block"] == 0


@pytest.mark.parametrize("combine", ["set", "add"])
@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_slab_exchange_is_the_exchange_of_each_column(operators, box, combine):
    """The exchange of a (P, W, K) slab on both plans: column k torch.equal
    to the exchange of column k, for set and add."""
    rows = operators["poisson"].cols
    lay = device_layout(rows, box)
    plan = device_exchange_plan(rows, CPU, reverse=combine == "add", box=box)
    rng = np.random.default_rng(4)
    slab = torch.from_numpy(rng.standard_normal((lay.P, lay.W, 5)))
    slab[:, lay.trash] = 0
    cols = [exchange_(plan, slab[..., k].clone(), combine) for k in range(5)]
    exchange_(plan, slab, combine)
    for k in range(5):
        assert torch.equal(slab[..., k], cols[k])


def test_new_modules_in_the_import_scan():
    """tests/test_torch_slice.py's scan globs the package: the modules and
    wrappers of this slice are under it."""
    from test_torch_slice import ROOT, _port_sources

    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for path in ("partitionedarrays_jl_tpu_torch/utils/health.py", "partitionedarrays_jl_tpu_torch/ops/dia.py",
                 "partitionedarrays_jl_tpu_torch/ops/sweep.py", "partitionedarrays_jl_tpu_torch/parallel/gpu.py",
                 "chip_smoke.py"):
        assert path in names


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_block_products_are_the_solo_products(K, dtype):
    """The block dot's products (plain version): column k's block is the
    solo dot's product of column k, laid out (P, n) from a 64-element
    boundary; the block dot equals the solo dot column by column."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _block_pdot_factory, _pdot_factory

    dia.reset_launches()
    rng = np.random.default_rng(K)
    P, o0, n = 3, 4, 1001
    a = torch.from_numpy(rng.standard_normal((P, o0 + n + 5, K))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((P, o0 + n + 2, K))).to(dtype)
    buf = sw.block_products(a, b, o0, n)
    S = sw.block_product_stride(P, n)
    assert S % 64 == 0 and buf.numel() == K * S
    dots = _block_pdot_factory(o0, n)(a, b)
    for k in range(K):
        want = a[:, o0 : o0 + n, k] * b[:, o0 : o0 + n, k]
        assert torch.equal(buf[k * S : k * S + P * n].view(P, n), want)
        assert torch.equal(dots[k], _pdot_factory(o0, n)(a[..., k], b[..., k]))
    assert dia.LAUNCHES["block_products"] == 0
