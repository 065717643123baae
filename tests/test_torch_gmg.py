"""The port's geometric multigrid (`models/gmg.py`, `parallel/gpu_gmg.py`)
and what it stands on (`decouple_dirichlet`, `pcg`, the `add` exchange,
aligned coarse partitions) against the JAX package.

Setup of tests/test_gmg.py:161: the 16^3 Dirichlet Poisson operator on
(2,2,2) parts in f64, decoupled, hierarchy with coarse_threshold=100 and
pre = post = 2. The fine operator reaches the port through
`interop.psparse_from_csr` from the JAX package's assembled arrays. The
port runs on ``GPUBackend(device="cpu")`` (the kernels' plain versions)
and on its sequential backend; the JAX package on ``pa.tpu`` over the
8-device CPU mesh. Tolerances: every level's operator entry by entry to
rtol=1e-12, solutions to atol=1e-8, iteration counts equal."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import epilogue as ep
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel.gpu_loop import GMG_BLOCK
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    device_exchange_plan,
    exchange_,
)

CPU = GPUBackend(device="cpu")
NS = (16, 16, 16)
TOL = 1e-9


def _csr_arrays(M):
    return (np.asarray(M.indptr), np.asarray(M.indices), np.asarray(M.data), tuple(M.shape))


def _iset_arrays(r):
    isets = r.partition.part_values()
    return {
        "lid_to_gid": [np.asarray(i.lid_to_gid) for i in isets],
        "lid_to_part": [np.asarray(i.lid_to_part) for i in isets],
        "grid_shape": isets[0].grid_shape,
        "boxes": [(i.box_lo, i.box_hi) for i in isets],
    }


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's operator (exported as arrays), its decoupled
    system, hierarchy levels (gathered), and its device GMG-PCG and
    stationary V-cycle solves."""

    def driver(parts):
        A, b, x_exact, _ = pa.assemble_poisson(parts, NS)
        exported = {
            "rows": _iset_arrays(A.rows), "cols": _iset_arrays(A.cols),
            "csr": [_csr_arrays(M) for M in A.values.part_values()],
            "b": [np.asarray(v) for v in b.values.part_values()],
        }
        Ah, bh = pa.decouple_dirichlet(A, b)
        h = pa.gmg_hierarchy(parts, Ah, NS, coarse_threshold=100, pre=2, post=2)
        levels = [_csr_arrays(pa.gather_psparse(l.A)) for l in h.levels]
        levels.append(_csr_arrays(pa.gather_psparse(h.coarse_A)))
        x, info = pa.pcg(Ah, bh, minv=h, tol=TOL)
        xs, info_s = pa.gmg_solve(h, bh, tol=TOL)
        return {
            "exported": exported, "Ah": _csr_arrays(pa.gather_psparse(Ah)),
            "bh": pa.gather_pvector(bh), "levels": levels, "x_exact": pa.gather_pvector(x_exact),
            "pcg": (pa.gather_pvector(x), info["iterations"]),
            "gmg_solve": (pa.gather_pvector(xs), info_s["iterations"]),
        }

    return pa.prun(driver, pa.tpu, (2, 2, 2))


def _carry(parts, exported):
    """The JAX package's operator and rhs as port objects: rows are the
    port's own Cartesian partition (same lids), cols come from the lid
    maps."""
    rows = pt.cartesian_partition(parts, NS, pt.no_ghost)
    for iset, g in zip(rows.partition.part_values(), exported["rows"]["lid_to_gid"]):
        assert np.array_equal(iset.lid_to_gid, g)
    e = exported["cols"]
    cols = interop.prange_from_arrays(
        parts, rows.ngids, e["lid_to_gid"], e["lid_to_part"], grid_shape=e["grid_shape"],
        boxes=e["boxes"],
    )
    A = interop.psparse_from_csr(rows, cols, exported["csr"])
    return A, interop.pvector_from_values(rows, exported["b"])


def _scipy(arrs):
    from scipy.sparse import csr_matrix

    indptr, indices, data, shape = arrs
    return csr_matrix((data, indices, indptr), shape=shape)


def _assert_entrywise(got, want, rtol):
    """Equal values on the union of both patterns (explicit zeros count as
    absent): rtol relative to each entry, atol at rounding of the largest."""
    g, w = _scipy(got), _scipy(want)
    assert g.shape == w.shape
    rows, cols = (g + w).nonzero()
    a, b = np.asarray(g[rows, cols]).ravel(), np.asarray(w[rows, cols]).ravel()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-15 * np.abs(b).max())


@pytest.fixture(scope="module")
def port_run(jax_run):
    def driver(parts):
        A, b = _carry(parts, jax_run["exported"])
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, NS, coarse_threshold=100, pre=2, post=2)
        out = {
            "Ah": _csr_arrays(pt.gather_psparse(Ah)), "bh": pt.gather_pvector(bh),
            "levels": [_csr_arrays(pt.gather_psparse(l.A)) for l in h.levels]
            + [_csr_arrays(pt.gather_psparse(h.coarse_A))],
        }
        x, info = pt.pcg(Ah, bh, minv=h, tol=TOL)
        out["pcg"] = (pt.gather_pvector(x), info["iterations"], info)
        if isinstance(parts.backend, GPUBackend):
            # the lowering of every S (the structured routes stage it)
            dh = gpu_gmg.device_hierarchy(h, parts.backend, stencil=False)
            out["modes"] = [(l["dA"].dia_mode, l["dS"].dia_mode) for l in dh["levels"]]
        else:
            xs, info_s = pt.gmg_solve(h, bh, tol=TOL)
            out["gmg_solve"] = (pt.gather_pvector(xs), info_s["iterations"])
        return out

    return {"gpu": pt.prun(driver, CPU, (2, 2, 2)), "seq": pt.prun(driver, pt.sequential, (2, 2, 2))}


def test_decouple_dirichlet_matches_jax(jax_run, port_run):
    for run in port_run.values():
        _assert_entrywise(run["Ah"], jax_run["Ah"], rtol=1e-15)
        np.testing.assert_allclose(run["bh"], jax_run["bh"], rtol=1e-15, atol=1e-15)
    M = _scipy(port_run["gpu"]["Ah"])
    assert abs(M - M.T).max() == 0.0  # symmetric
    assert M.nnz == sum(len(c[2]) for c in jax_run["exported"]["csr"])  # pattern kept


def test_hierarchy_matches_jax(jax_run, port_run):
    want = jax_run["levels"]
    for run in port_run.values():
        got = run["levels"]
        assert len(got) == len(want) == 3  # 16^3, 8^3 and the 4^3 coarse grid
        assert got[-1][3] == want[-1][3] == (64, 64)
        for g, w in zip(got, want):
            _assert_entrywise(g, w, rtol=1e-12)
    # level 0 is the 7-point operator (coded), the Galerkin level has 27
    # variable-coefficient diagonals (stream); every S is coded
    assert port_run["gpu"]["modes"] == [("coded", "coded"), ("stream", "coded")]


def test_gmg_pcg_matches_jax(jax_run, port_run):
    x_jax, it_jax = jax_run["pcg"]
    x, it, info = port_run["gpu"]["pcg"]
    assert info["converged"] and it == it_jax
    np.testing.assert_allclose(x, x_jax, atol=1e-8)
    x_seq, it_seq, info_seq = port_run["seq"]["pcg"]
    assert info_seq["converged"] and it_seq == it
    np.testing.assert_allclose(x, x_seq, atol=1e-8)
    assert np.abs(x - jax_run["x_exact"]).max() < 1e-6


def test_gmg_solve_matches_jax(jax_run, port_run):
    """The host stationary V-cycle iteration against the JAX package's
    device loop (the port's device loop is not ported yet)."""
    x_jax, it_jax = jax_run["gmg_solve"]
    x, it = port_run["seq"]["gmg_solve"]
    assert it == it_jax
    np.testing.assert_allclose(x, x_jax, atol=1e-8)


def test_vcycle_launch_counts(monkeypatch):
    """On the structured routes (``stencil=False``), with pre = post = 1,
    one V-cycle makes 2 SpMVs with each level's operator and 2 with each
    level's S (the zero-start pre-smoothing sweep needs none) and 3
    epilogues a level (init, residual, smooth), and each PCG iteration one
    more SpMV with the fine operator: counted here through the wrappers
    the device loop calls, per iteration the device ran (the frozen ones
    after the stop included). The stencil route's count is in
    tests/test_torch_box.py."""
    calls = {"coded": 0, "stream": 0, "epilogue": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(dia, "dia_coded_spmv", counting("coded", dia.dia_coded_spmv))
    monkeypatch.setattr(dia, "dia_stream_spmv", counting("stream", dia.dia_stream_spmv))
    monkeypatch.setattr(ep, "vcycle_epilogue", counting("epilogue", ep.vcycle_epilogue))

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, NS)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, NS, coarse_threshold=100)
        gpu_gmg.device_hierarchy(h, parts.backend, stencil=False)
        calls.update(coded=0, stream=0, epilogue=0)
        info = pt.pcg(Ah, bh, minv=h, tol=TOL, stencil=False)[1]
        return len(h.levels), info["iterations"], info["device_loop"]["device_iterations"]

    L, it, dev_it = pt.prun(driver, CPU, (2, 2, 2))
    assert L == 2 and it > 0
    # blocks of GMG_BLOCK iterations, the last holding the stop
    assert dev_it == GMG_BLOCK * (it // GMG_BLOCK + 1)
    assert calls["coded"] == 1 + dev_it * (1 + 2 + 2 * L)  # level-0 A and every S
    assert calls["stream"] == dev_it * 2 * (L - 1)  # the Galerkin levels' A
    assert calls["epilogue"] == dev_it * 3 * L


def test_unported_options_raise():
    """Jacobi PCG on the card, and the GMG options that raised until the
    solver family was ported (the W-cycle, agglomeration, the stationary
    solve on the card): each now runs in the host loop's iterations."""
    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (8, 8, 8))
        Ah, bh = pt.decouple_dirichlet(A, b)
        # Jacobi PCG on the card runs since the Jacobi slice (the device
        # loop's fused body); its iterations are the host loop's, below
        jacobi = pt.pcg(Ah, bh, tol=1e-8)[1]
        assert jacobi["cg_body"] == "fused" and jacobi["converged"]
        # the options that once raised (W-cycle, agglomeration, the
        # stationary iteration on the card) run: each converges in the host
        # loop's iterations
        its = []
        for kw in ({"cycle": "w"}, {"agg_threshold": 10}, {}):
            h = pt.gmg_hierarchy(parts, Ah, (8, 8, 8), coarse_threshold=50, **kw)
            x, info = pt.gmg_solve(h, bh, tol=1e-8)
            assert info["converged"]
            its.append(info["iterations"])
        return jacobi["iterations"], its

    it_dev, its_dev = pt.prun(driver, CPU, (2, 2, 2))
    # the host loop keeps Jacobi PCG
    info = pt.prun(
        lambda parts: pt.pcg(*pt.decouple_dirichlet(*pt.assemble_poisson(parts, (8, 8, 8))[:2]), tol=1e-8)[1],
        pt.sequential, (2, 2, 2),
    )
    assert info["converged"] and info["iterations"] == it_dev

    def host(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (8, 8, 8))
        Ah, bh = pt.decouple_dirichlet(A, b)
        return [pt.gmg_solve(pt.gmg_hierarchy(parts, Ah, (8, 8, 8), coarse_threshold=50, **kw), bh, tol=1e-8)[1]
                ["iterations"] for kw in ({"cycle": "w"}, {"agg_threshold": 10}, {})]

    assert pt.prun(host, pt.sequential, (2, 2, 2)) == its_dev


def test_add_exchange_assembles_ghosts_into_owners():
    """Combine `add` over the reversed plan: every owned slot gains the
    ghost copies of its gid held by other parts; ghosts and the trash slot
    end at 0."""

    def driver(parts):
        r = pt.prange(parts, (6, 6, 6), pt.with_ghost)
        rng = np.random.default_rng(31)
        vals = [rng.standard_normal(i.num_lids) for i in r.partition.part_values()]
        want = np.zeros(r.ngids)
        for iset, v in zip(r.partition.part_values(), vals):
            np.add.at(want, np.asarray(iset.lid_to_gid), v)
        dv = DeviceVector.from_pvector(pt.PVector(parts._like([v.copy() for v in vals]), r), parts.backend)
        exchange_(device_exchange_plan(r, parts.backend, reverse=True), dv.data, combine="add")
        assert not dv.data[:, dv.layout.g0 :].any()
        return pt.gather_pvector(dv.to_pvector()), want

    got, want = pt.prun(driver, CPU, (2, 2, 2))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def test_exchanger_reverse_swaps_sides():
    def driver(parts):
        ex = pt.prange(parts, (6, 6, 6), pt.with_ghost).exchanger
        rev = ex.reverse()
        assert rev.reverse() is ex and ex.reverse() is rev
        assert rev.parts_snd is ex.parts_rcv and rev.parts_rcv is ex.parts_snd
        assert rev.lids_snd is ex.lids_rcv and rev.lids_rcv is ex.lids_snd
        return True

    assert pt.prun(driver, pt.sequential, (2, 2, 2))


@pytest.mark.parametrize(
    "kw",
    [
        {"dim_firsts": [[0, 5], [0, 4], [0, 6]]},
        {"dim_firsts": [[0, 3], [0, 3], [0, 9]]},
        {"part_stride": (2, 1, 2)},
    ],
    ids=["aligned", "skewed", "strided"],
)
def test_cartesian_partition_cuts_match_jax(kw):
    ns = (9, 8, 11)

    def boxes(mod, be):
        def driver(parts):
            r = mod.cartesian_partition(parts, ns, mod.no_ghost, **kw)
            owners = r.gid_to_part(np.arange(r.ngids))
            return [np.asarray(i.lid_to_gid) for i in r.partition.part_values()], owners

        return mod.prun(driver, be, (2, 2, 2))

    (g_port, o_port), (g_jax, o_jax) = boxes(pt, pt.sequential), boxes(pa, pa.sequential)
    for a, b in zip(g_port, g_jax):
        assert np.array_equal(a, b)
    assert np.array_equal(o_port, o_jax)


def test_device_hierarchy_lives_on_the_backend_device():
    """The staged hierarchy lives on the backend's device: all tensors on
    the CPU here, in the operator's dtype, on both transfer routes."""

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (8, 8, 8), dtype=np.float32)
        Ah = pt.decouple_dirichlet(A)
        h = pt.gmg_hierarchy(parts, Ah, (8, 8, 8), coarse_threshold=50)
        return gpu_gmg.device_hierarchy(h, parts.backend), gpu_gmg.device_hierarchy(h, parts.backend, stencil=False)

    dh, dh_s = pt.prun(driver, CPU, (1, 1, 1))
    for d in (dh, dh_s):
        assert d["cinv"].dtype == torch.float32 and d["cinv"].device.type == "cpu"
        for l in d["levels"]:
            assert l["dinv"].dtype == torch.float32
    for l in dh["levels"]:
        assert l["stencil"].table.device.type == "cpu" and "dS" not in l
    for l in dh_s["levels"]:
        assert l["emb"].device.type == "cpu" and l["dS"].coded.cb.dtype == torch.float32


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)], ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 1)], ids=["1x1x1", "2x2x1"])
def test_interp_stencil_lowering_matches_jax(grid, dtype, tol):
    """The port's interpolation stencil S at 12^3, lowered (coded, the
    select-chain sum the launcher specialises for 27 diagonals) and applied
    through the SpMV body, against the JAX package's S product on its
    sequential backend; the same global operand."""
    from partitionedarrays_jl_tpu.models.gmg import interp_stencil_cartesian as jax_stencil
    from partitionedarrays_jl_tpu_torch.models.gmg import interp_stencil_cartesian
    from partitionedarrays_jl_tpu_torch.parallel.gpu import device_matrix, make_spmv_fn

    ns = (12, 12, 12)
    xg = np.random.default_rng(41).standard_normal(int(np.prod(ns))).astype(dtype)

    def jax_driver(parts):
        S = jax_stencil(ns, pa.assemble_poisson(parts, ns)[0].rows, dtype=dtype)
        vals = pa.map_parts(lambda i: xg[np.asarray(i.lid_to_gid)], S.cols.partition)
        return pa.gather_pvector(S @ pa.PVector(vals, S.cols))

    def port_driver(parts):
        S = interp_stencil_cartesian(ns, pt.assemble_poisson(parts, ns)[0].rows, dtype=dtype)
        dS = device_matrix(S, parts.backend)
        assert dS.dia_mode == "coded" and dia.select_chain_instance(dS.coded) == 27
        xv = interop.pvector_from_values(S.cols, [xg[np.asarray(i.lid_to_gid)] for i in S.cols.partition.part_values()])
        dx = DeviceVector.from_pvector(xv, parts.backend, dS.col_layout)
        y = DeviceVector(make_spmv_fn(dS)(dx.data), S.rows, dS.row_layout, parts.backend)
        return pt.gather_pvector(y.to_pvector())

    want = pa.prun(jax_driver, pa.sequential, grid)
    got = pt.prun(port_driver, CPU, grid)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_gmg_operators_take_the_specialised_select_sums():
    """On one part (as the 192^3 GMG-PCG of chip_smoke.py, here at 24^3) the
    level-0 operator is a 7-diagonal select-chain operator and every
    stencil S of the structured route a 27-diagonal one, both of the
    shapes the coded kernel's select-chain sum is specialised for."""

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (24, 24, 24), dtype=np.float32)
        Ah = pt.decouple_dirichlet(A)
        h = pt.gmg_hierarchy(parts, Ah, (24, 24, 24), coarse_threshold=500)
        return gpu_gmg.device_hierarchy(h, parts.backend, stencil=False)

    dh = pt.prun(driver, CPU, (1, 1, 1))
    picks = [(dia.select_chain_instance(l["dA"].coded) if l["dA"].dia_mode == "coded" else None,
              dia.select_chain_instance(l["dS"].coded)) for l in dh["levels"]]
    assert picks == [(7, 27)] + [(None, 27)] * (len(picks) - 1) and len(picks) == 2
