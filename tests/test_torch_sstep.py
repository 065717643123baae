"""The port's s-step (communication-avoiding) CG body, its exchange of the
pair slab and the interior/boundary overlap tail, against the JAX package
(tests/test_sstep.py), on ``GPUBackend(device="cpu")`` (the kernels' plain
versions) at small sizes.

Contracts and tolerances:

* ``sstep=1`` (and 0) builds the body that no ``sstep`` builds: the same
  cached solve function, and in strict mode the textbook body, the host's
  strict loop bit for bit (tests/test_sstep.py:83's program identity);
* ``sstep=2`` converges in at most twice the textbook iterations and its
  solution is within 1e-7 of the textbook body's (tests/test_sstep.py:143),
  in the JAX package's s-step iterations (``PA_TPU_SSTEP=2``) and within
  1e-10 of its solution; s = 3, 4 and 5 converge to a finite x within 1e-7
  of the textbook body's (a Gram residual of exactly 0 inside a trip
  freezes the trip, it does not divide 0 by 0);
* the overlap tail is ``torch.equal`` to the standard tail on every CG
  body, s-step included (tests/test_sstep.py:99 pins it bit for bit); on
  the coded fused body, which has no tail to overlap, it is the same solve
  function;
* an explicit ``sstep`` >= 2 with ``fused=True``, a block, ``pipelined``,
  ``precond`` or a strict lowering raises `LoweringConflictError`
  (tests/test_sstep.py:175-205; the JAX package's environment fallback has
  no counterpart: the port reads no environment);
* the operator's own plans (generic and box), which the s-step body
  exchanges its pair slab through, move exactly the values the JAX
  package's depth-2 widened plans move, on (2,2,2) and (4,2,1) partitions,
  for a frame and for the (P, W, 2) pair slab of an s-step level.
"""
import importlib

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.parallel.tpu_box import WidenedBoxExchangePlan as JWideBox
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    _b_on_cols_layout,
    _can_overlap,
    _krylov_fn_for,
    device_exchange_plan,
    device_layout,
    device_matrix,
    exchange_,
    gpu_block_cg,
    make_cg_fn,
)
from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan
from partitionedarrays_jl_tpu_torch.utils.health import LoweringConflictError

jtpu = importlib.import_module("partitionedarrays_jl_tpu.parallel.tpu")
CPU = GPUBackend(device="cpu")


def _jax_cg(monkeypatch, ns, grid, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def driver(parts):
        A, b, xe, x0 = pa.assemble_poisson(parts, ns)
        x, info = pa.tpu_cg(A, b, x0=x0, tol=1e-9, maxiter=400)
        return pa.gather_pvector(x), info

    try:
        return pa.prun(driver, pa.tpu, grid)
    finally:
        for k in env:
            monkeypatch.delenv(k)


def _port_cg(ns, grid, **kw):
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        x, info = pt.cg(A, b, x0=x0, tol=1e-9, maxiter=400, **kw)
        return pt.gather_pvector(x), info

    return pt.prun(driver, CPU, grid)


def test_sstep1_is_the_textbook_body():
    """sstep=1 (and 0) builds the function no sstep builds: the same cache
    entry, and in strict mode the textbook body, the host's strict loop bit
    for bit."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        dA = device_matrix(A, parts.backend)
        std = _krylov_fn_for(dA, "cg", 1e-9, 100, fused=False)
        assert _krylov_fn_for(dA, "cg", 1e-9, 100, fused=False, sstep=1) is std
        assert _krylov_fn_for(dA, "cg", 1e-9, 100, fused=False, sstep=0) is std
        assert _krylov_fn_for(dA, "cg", 1e-9, 100, sstep=1) is _krylov_fn_for(dA, "cg", 1e-9, 100)
        xs, infs = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=200, strict=True, sstep=1)
        return pt.gather_pvector(xs), infs

    x1, i1 = pt.prun(driver, CPU, (2, 2))

    def host(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        x, info = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=200, strict=True)
        return pt.gather_pvector(x), info

    xh, ih = pt.prun(host, pt.sequential, (2, 2))
    assert i1["cg_body"] == "standard" and i1["iterations"] == ih["iterations"]
    assert np.asarray(i1["residuals"]).tobytes() == np.asarray(ih["residuals"]).tobytes()
    assert x1.tobytes() == xh.tobytes()


@pytest.mark.parametrize("ns,grid", [((8, 8), (2, 2)), ((8, 8, 8), (2, 2, 2))], ids=["8x8-2x2", "8x8x8-2x2x2"])
def test_sstep2_converges_and_matches_standard(monkeypatch, ns, grid):
    x_std, i_std = _port_cg(ns, grid, fused=False)
    x_ca, i_ca = _port_cg(ns, grid, sstep=2)
    assert i_std["cg_body"] == "standard" and i_ca["cg_body"] == "sstep2"
    assert i_std["converged"] and i_ca["converged"]
    assert i_ca["iterations"] <= 2 * i_std["iterations"]
    np.testing.assert_allclose(x_ca, x_std, atol=1e-7)
    jx_ca, ji_ca = _jax_cg(monkeypatch, ns, grid, {"PA_TPU_SSTEP": "2", "PA_TPU_FUSED_CG": "0"})
    assert ji_ca["cg_body"] == "sstep2"
    assert i_ca["iterations"] == ji_ca["iterations"], (i_ca["iterations"], ji_ca["iterations"])
    np.testing.assert_allclose(x_ca, np.asarray(jx_ca), atol=1e-10)


@pytest.mark.parametrize("s", [3, 4, 5])
@pytest.mark.parametrize("ns,grid", [((8, 8), (2, 2)), ((8, 8, 8), (2, 2, 2))], ids=["8x8-2x2", "8x8x8-2x2x2"])
def test_sstep_deep_converges_finite(ns, grid, s):
    """s = 3, 4, 5: on the 8x8 f64 system a Gram residual reaches exactly 0
    inside a trip at s = 4; the trip freezes there, and the solve returns a
    finite, converged x within 1e-7 of the textbook body's, in at most twice
    its iterations."""
    x_std, i_std = _port_cg(ns, grid, fused=False)
    x_ca, i_ca = _port_cg(ns, grid, sstep=s)
    assert i_ca["cg_body"] == f"sstep{s}" and i_ca["converged"]
    assert np.all(np.isfinite(x_ca)) and i_ca["iterations"] <= 2 * i_std["iterations"]
    np.testing.assert_allclose(x_ca, x_std, atol=1e-7)


def test_sstep_widened_staging_and_history():
    """gpu_cg(sstep=s) runs on the operator's one staging (its box plan
    carries the pair slab), its solve function cached there beside the
    textbook one; the history holds one entry an inner iteration, and the
    device loop counts whole trips."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        x, info = pt.cg(A, b, x0=x0, tol=1e-9, maxiter=400, sstep=2)
        dA = device_matrix(A, parts.backend)
        assert list(A._device.values()) == [dA] and isinstance(dA.col_plan, BoxExchangePlan)
        assert _krylov_fn_for(dA, "cg", 1e-9, 400, sstep=2).cg_body == "sstep2"
        assert len(dA._fn_cache) == 1
        return info

    info = pt.prun(driver, CPU, (2, 2, 2))
    it = info["iterations"]
    assert it % 2 == 0 and len(info["residuals"]) == it + 1
    assert np.all(np.isfinite(info["residuals"]))
    assert info["device_loop"]["device_iterations"] == 4 * (it // 2 // 4 + 1)


BODIES = {
    "fused": dict(fused=True),
    "standard": dict(fused=False),
    "pipelined": dict(pipelined=True),
    "sstep2": dict(sstep=2),
    "sstep3": dict(sstep=3),
}


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_overlap_tail_is_bitwise_the_standard_tail(body, box):
    """overlap=True on every CG body: x, rs and the history torch.equal to
    overlap=False, on the box and the generic plan."""
    kw = BODIES[body]

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        dA = device_matrix(A, parts.backend, box)
        db = _b_on_cols_layout(b, dA)
        dx0 = DeviceVector.from_pvector(x0, parts.backend, dA.col_layout).data
        out = []
        for overlap in (False, True):
            fn = make_cg_fn(dA, 1e-9, 300, overlap=overlap, **kw)
            # the coded fused body has no tail to overlap (`_can_overlap`)
            assert fn.overlap == (overlap and body != "fused")
            out.append(fn(db, dx0))
        fused = body == "fused"
        assert _can_overlap(dA, fused) == (not fused)
        same = _krylov_fn_for(dA, "cg", 1e-9, 300, overlap=True, **kw) is _krylov_fn_for(dA, "cg", 1e-9, 300, **kw)
        assert same == fused
        return out

    (x0_, rs0, _, it0, h0), (x1, rs1, _, it1, h1) = pt.prun(driver, CPU, (2, 2, 2))
    assert it0 == it1 and torch.equal(x0_, x1) and torch.equal(rs0, rs1)
    assert np.array_equal(h0, h1, equal_nan=True)


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "jacobi"])
def test_overlap_tail_block_and_precond(precond):
    """The block body and Jacobi PCG (fused and standard) with the overlap
    tail, torch.equal to the standard tail."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        Ah, bh = pt.decouple_dirichlet(A, b)
        mv = pt.jacobi_preconditioner(Ah) if precond else None
        res = []
        for overlap in (False, True):
            sol = []
            for fused in (True, False):
                x, info = pt.gpu_cg(Ah, bh, tol=1e-9, minv=mv, fused=fused, overlap=overlap)
                sol.append((pt.gather_pvector(x), info["iterations"], np.asarray(info["residuals"])))
            xs, ib = gpu_block_cg(Ah, [bh, bh * 2.0], tol=1e-9, minv=mv, overlap=overlap)
            sol.append((np.stack([pt.gather_pvector(x) for x in xs]), ib["iterations"], ib["iterations_per_column"]))
            res.append(sol)
        return res

    off, on = pt.prun(driver, CPU, (2, 2, 2))
    for a, b in zip(off, on):
        assert a[0].tobytes() == b[0].tobytes() and a[1] == b[1]
        assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]), equal_nan=True)


@pytest.mark.parametrize(
    "kwargs", [{"fused": True}, {"rhs_batch": 2}, {"pipelined": True}, {"precond": True}],
    ids=["fused", "rhs_batch", "pipelined", "precond"],
)
def test_explicit_sstep_conflicts_refuse_typed(kwargs):
    def driver(parts):
        A = pt.assemble_poisson(parts, (8, 8))[0]
        dA = device_matrix(A, parts.backend)
        if "rhs_batch" not in kwargs:
            with pytest.raises(LoweringConflictError) as ei:
                make_cg_fn(dA, tol=1e-9, maxiter=50, sstep=2, **kwargs)
            assert ei.value.diagnostics["conflict"][0] == "sstep"
        with pytest.raises(LoweringConflictError) as ej:
            _krylov_fn_for(dA, "cg", 1e-9, 50, sstep=2, **kwargs)
        assert ej.value.diagnostics["conflict"][0] == "sstep"
        return True

    assert pt.prun(driver, CPU, (2, 2))


def test_explicit_sstep_refuses_strict_and_block_entry_points():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        with pytest.raises(LoweringConflictError) as ei:
            pt.cg(A, b, x0=x0, strict=True, sstep=2)
        assert "strict" in ei.value.diagnostics["conflict"][1]
        with pytest.raises(LoweringConflictError):
            make_cg_fn(device_matrix(A, parts.backend, strict=True), 1e-9, 50, sstep=2)
        for backend_b in (b,):
            with pytest.raises(LoweringConflictError) as ej:
                pt.cg(A, B=[backend_b, backend_b], sstep=2)
            assert ej.value.diagnostics["conflict"] == ("sstep", "rhs_batch")
        return True

    assert pt.prun(driver, CPU, (2, 2))


# ---------------------------------------------------------------------------
# the operator's plans against the JAX package's widened plans
# ---------------------------------------------------------------------------


def _ramp(mod, rows):
    vals = mod.map_parts(
        lambda i: np.asarray(i.lid_to_gid, dtype=np.float64) * 2.0 + 1.0 + 0.001 * i.part, rows.partition
    )
    return mod.PVector(vals, rows)


def _jax_widened_exchange(parts, rows, box):
    """The JAX package's depth-2 plan (box or generic) run on a ramp through
    its own shard_map exchange body; returns the frame and the per-lid
    values."""
    import jax

    backend = parts.backend
    if not box:
        rows._device_plan = {}
        for attr in ("_device_layout", "_box_info"):
            if hasattr(rows, attr):
                delattr(rows, attr)
    plan = jtpu.device_exchange_plan(rows, False, depth=2)
    base = jtpu.device_exchange_plan(rows, False)
    if box:
        assert isinstance(plan, JWideBox)
    else:
        assert isinstance(plan, jtpu.WidenedDeviceExchangePlan)
    assert plan.ghost_depth == 2 and base is not plan
    dv = jtpu.DeviceVector.from_pvector(_ramp(pa, rows), backend, plan.layout)
    body = jtpu._shard_exchange(plan, "set")
    P = plan.layout.P
    if box:
        ops = jtpu._box_dummy_operands(backend, P)
    else:
        ops = tuple(jtpu._stage(backend, a, P) for a in (plan.snd_idx, plan.snd_mask, plan.rcv_idx))
    mesh, spec = backend.mesh(P), backend.parts_spec()
    shard_map = jtpu._shard_map()

    @jax.jit
    def fn(x, a, b, c):
        return shard_map(lambda xs, as_, bs, cs: body(xs[0], as_[0], bs[0], cs[0])[None], mesh=mesh,
                         in_specs=(spec,) * 4, out_specs=spec, check_vma=False)(x, a, b, c)

    out = fn(dv.data, *ops)
    return np.asarray(out), _by_gid(rows, jtpu.DeviceVector(out, rows, plan.layout, backend).to_pvector())


def _by_gid(rows, v):
    """Each part's values keyed by gid (the packages may number a part's
    ghosts in another order)."""
    out = []
    for iset, vals in zip(rows.partition.part_values(), v.values.part_values()):
        g = np.asarray(iset.lid_to_gid)
        order = np.argsort(g)
        out.append((g[order], np.asarray(vals)[order]))
    return out


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 2, 1)], ids=["2x2x2", "4x2x1"])
@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_widened_plans_move_the_jax_values(monkeypatch, grid, box):
    ns = (8, 8, 8)
    if not box:
        monkeypatch.setenv("PA_TPU_BOX", "0")

    def jdriver(parts):
        rows = pa.assemble_poisson(parts, ns)[0].cols
        return _jax_widened_exchange(parts, rows, box)

    def pdriver(parts):
        A = pt.assemble_poisson(parts, ns)[0]
        rows = A.cols
        wide = device_exchange_plan(rows, parts.backend, box=box)
        # the plan the s-step body exchanges its pair slab through
        assert device_matrix(A, parts.backend, box).col_plan is wide
        assert isinstance(wide, BoxExchangePlan) == box
        layout = device_layout(rows, box)
        dv = DeviceVector.from_pvector(_ramp(pt, rows), parts.backend, layout)
        pair = torch.stack([dv.data, 3.0 * dv.data], dim=-1).contiguous()
        exchange_(wide, dv.data)
        exchange_(wide, pair)
        assert torch.equal(pair[..., 0], dv.data) and torch.equal(pair[..., 1], 3.0 * dv.data)
        return dv.data.numpy().copy(), _by_gid(rows, dv.to_pvector())

    jframe, jlids = pa.prun(jdriver, pa.tpu, grid)
    pframe, plids = pt.prun(pdriver, CPU, grid)
    for (ga, a), (gb, b) in zip(plids, jlids):
        assert np.array_equal(ga, gb) and np.array_equal(a, b)
    if box:
        assert np.array_equal(pframe, jframe)


@pytest.mark.parametrize("n", [100, 8192, 25093])
def test_gram_reduction_chunks(n):
    """`_pgram_factory`: the chunked per-part Gram products folded in part
    order equal the direct product V Vᵀ summed over the parts (rtol 1e-13,
    f64), for rows fewer than a chunk, exactly one, and chunks and a tail."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import GRAM_CHUNK, _pgram_factory

    assert GRAM_CHUNK == 8192
    V = torch.from_numpy(np.random.default_rng(n).standard_normal((3, 5, n)))
    G = _pgram_factory(0, n)(V)
    want = sum(V[p] @ V[p].T for p in range(3))
    np.testing.assert_allclose(G.numpy(), want.numpy(), rtol=1e-13)
    assert torch.equal(G, G.T)
