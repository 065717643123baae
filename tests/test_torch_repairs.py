"""The keywords the port lacked against the JAX package, each held to it on
the CPU:

* ``make_exchange_fn(rows, backend, combine=)`` — ``"add"`` runs the reverse
  plan (assemble!), on the four ranges of ``tests/test_box_exchange.py``,
  against the JAX package's function on ``pa.tpu`` (the 8-device CPU mesh):
  exact on the 2-D and 1-D ranges, within 1e-12 relative on the 3-D ones,
  where the box plan sums in direction order and the generic plan in colour
  round order;
* ``assemble_poisson`` / ``assemble_cartesian_stencil(decoupled=True)`` —
  bit for bit the JAX package's COO path (``PA_TPU_STENCIL_FAST=0``);
* ``PSparseMatrix(exchanger=)``, ``make_chebyshev_fn(leg=)``,
  ``GMGLevel(P=, R=)`` and ``make_cg_fn(rhs_batch=)``;
* ``gpu.EXCHANGES["rounds"]`` — a box exchange adds one round a direction
  (``len(plan.info.dirs)``, ``plan.R``; it added 1), a generic one its
  colour rounds, as the JAX package's comms model counts one ``ppermute``
  a direction;
* ``Gate.drain`` — it waits for a request that another thread's ``pump``
  (the HTTP server's) has taken off the queue and is still submitting; it
  returned with that request unfinished.
"""
import importlib

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel import gpu_krylov
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    _b_on_cols_layout,
    device_matrix,
    make_block_cg_fn,
    make_cg_fn,
    make_exchange_fn,
)

CPU = GPUBackend(device="cpu")
tgpu = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
jtpu = importlib.import_module("partitionedarrays_jl_tpu.parallel.tpu")

EXCHANGE_CASES = [((8, 8, 8), (2, 2, 2)), ((9, 7, 8), (2, 2, 2)), ((12, 12), (2, 4)), ((16,), (4,))]


def _ramp(mod, rows):
    """gid-derived values per part: a misrouted element changes a value."""
    vals = mod.map_parts(
        lambda i: np.asarray(i.lid_to_gid, dtype=np.float64) * 2.0 + 1.0 + 0.001 * i.part, rows.partition
    )
    return mod.PVector(vals, rows)


def _exchanged(parts, mod, dev, ns, combine):
    rows = mod.prange(parts, ns, mod.with_ghost)
    dv = dev.DeviceVector.from_pvector(_ramp(mod, rows), parts.backend)
    out = dev.make_exchange_fn(rows, parts.backend, combine=combine)(dv.data)
    vals = dev.DeviceVector(out, rows, dv.layout, parts.backend).to_pvector().values.part_values()
    return [np.asarray(v) for v in vals]


@pytest.mark.parametrize("combine", ["set", "add"])
@pytest.mark.parametrize("ns,grid", EXCHANGE_CASES, ids=lambda v: "x".join(map(str, v)))
def test_make_exchange_fn_combine_matches_jax(ns, grid, combine):
    want = pa.prun(_exchanged, pa.tpu, grid, pa, jtpu, ns, combine)
    got = pt.prun(_exchanged, CPU, grid, pt, tgpu, ns, combine)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if len(ns) == 3 and combine == "add":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(g, w)
    # the host assemble!/exchange! agrees with the device form
    def host(parts):
        v = _ramp(pt, pt.prange(parts, ns, pt.with_ghost))
        v.assemble() if combine == "add" else v.exchange()
        return [np.asarray(a) for a in v.values.part_values()]

    for g, h in zip(got, pt.prun(host, pt.sequential, grid)):
        np.testing.assert_allclose(g, h, rtol=1e-12, atol=0)


def test_make_exchange_fn_refuses_unknown_combine():
    rows = pt.prun(lambda parts: pt.prange(parts, (8,), pt.with_ghost), CPU, (2,))
    with pytest.raises(AssertionError, match="combine"):
        make_exchange_fn(rows, CPU, combine="max")


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes()


def _assembled(parts, m, ns, dtype, stencil):
    if stencil:
        A, b, xe, x0 = m.assemble_cartesian_stencil(parts, ns, 5.0, [(-1.0, -1.5), (-0.5, -2.0)], dtype=dtype,
                                                    decoupled=True)
    else:
        A, b, xe, x0 = m.assemble_poisson(parts, ns, dtype=dtype, decoupled=True)
    M = m.gather_psparse(A)
    return [_bits(M.indptr), _bits(M.indices), _bits(M.data)] + [_bits(m.gather_pvector(v)) for v in (b, xe, x0)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ns,grid", [((8, 8, 8), (2, 2, 2)), ((9, 7), (2, 2)), ((13,), (3,))],
                         ids=["8^3/2^3", "9x7/2x2", "13/3"])
def test_assemble_poisson_decoupled_bitwise(monkeypatch, ns, grid, dtype):
    from partitionedarrays_jl_tpu.models import poisson_fdm as jfdm
    from partitionedarrays_jl_tpu_torch.models import poisson_fdm as tfdm

    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "0")
    want = pa.prun(_assembled, pa.sequential, grid, jfdm_ns(jfdm, pa), ns, dtype, False)
    got = pt.prun(_assembled, pt.sequential, grid, jfdm_ns(tfdm, pt), ns, dtype, False)
    assert got == want
    # decoupled differs from the plain assembly (the couplings were zeroed)
    plain = pt.prun(lambda parts: pt.gather_psparse(pt.assemble_poisson(parts, ns, dtype=dtype)[0]).data,
                    pt.sequential, grid)
    assert _bits(plain) != got[2]


def test_assemble_cartesian_stencil_decoupled_bitwise(monkeypatch):
    from partitionedarrays_jl_tpu.models import poisson_fdm as jfdm
    from partitionedarrays_jl_tpu_torch.models import poisson_fdm as tfdm

    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "0")
    want = pa.prun(_assembled, pa.sequential, (2, 2), jfdm_ns(jfdm, pa), (10, 9), np.float64, True)
    got = pt.prun(_assembled, pt.sequential, (2, 2), jfdm_ns(tfdm, pt), (10, 9), np.float64, True)
    assert got == want


class jfdm_ns:
    """The namespace `_assembled` assembles through: the model module's
    assembly functions and the package's gathers."""

    def __init__(self, fdm, pkg):
        self.assemble_poisson = fdm.assemble_poisson
        self.assemble_cartesian_stencil = fdm.assemble_cartesian_stencil
        self.gather_psparse = pkg.gather_psparse
        self.gather_pvector = pkg.gather_pvector


def test_psparse_exchanger_keyword():
    """``PSparseMatrix(values, rows, cols, exchanger=)`` keeps the handed
    exchanger; without one the property builds `matrix_exchanger` once;
    scaling carries it."""

    def driver(parts):
        A = pt.assemble_poisson(parts, (6, 6))[0]
        ex = A.exchanger
        assert A.exchanger is ex
        B = pt.PSparseMatrix(A.values, A.rows, A.cols, exchanger=ex)
        assert B.exchanger is ex and (2.0 * B).exchanger is ex
        fresh = pt.matrix_exchanger(A.values, A.rows, A.cols)
        return ex.parts_snd, fresh.parts_snd

    a, b = pt.prun(driver, pt.sequential, (2, 2))
    assert a == b


def test_chebyshev_leg_keyword():
    """``make_chebyshev_fn(leg=)``: legs of the asked length (iterations
    count whole legs) and the default leg is `CHEBYSHEV_LEG`."""

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8), decoupled=True)
        dA = device_matrix(A, CPU)
        bd = _b_on_cols_layout(b, dA)
        x0d = DeviceVector.from_pvector(x0, CPU, dA.col_layout).data
        out = {}
        for leg in (None, 4, 7):
            kw = {} if leg is None else {"leg": leg}
            fn = gpu_krylov.make_chebyshev_fn(dA, 0.05, 8.0, 1e-8, 60, **kw)
            out[leg] = fn(bd, x0d)[3]
        return out

    its = pt.prun(driver, CPU, (2, 2))
    assert its[None] % gpu_krylov.CHEBYSHEV_LEG == 0
    assert its[4] % 4 == 0 and its[7] % 7 == 0 and its[4] != its[7]
    with pytest.raises(AssertionError, match="leg"):
        pt.prun(lambda parts: gpu_krylov.make_chebyshev_fn(
            device_matrix(pt.assemble_poisson(parts, (6, 6))[0], CPU), 0.1, 8.0, 1e-8, 10, leg=0), CPU, (1, 1))


def test_gmg_level_transfer_keywords():
    """``GMGLevel(A, P=, R=)`` serves the handed transfers (no builder
    needed) and equals the hierarchy's own level's transfers."""

    def driver(parts):
        A = pt.assemble_poisson(parts, (9, 9), decoupled=True)[0]
        h = pt.gmg_hierarchy(parts, A, (9, 9), coarse_threshold=20)
        lv = h.levels[0]
        mine = pt.GMGLevel(lv.A, P=lv.P, R=lv.R, nfs=lv.nfs, ncs=lv.ncs)
        assert mine.P is lv.P and mine.R is lv.R
        assert np.array_equal(pt.gather_pvector(mine.dinv), pt.gather_pvector(lv.dinv))
        bare = pt.GMGLevel(lv.A)
        with pytest.raises(AssertionError, match="no transfers"):
            bare.P
        return True

    assert pt.prun(driver, pt.sequential, (2, 2))


def test_make_cg_fn_rhs_batch_is_the_block_solve():
    """``make_cg_fn(rhs_batch=K)`` is `make_block_cg_fn` with K columns:
    the same iterations and values; pipelined and s-step refuse it."""

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8), decoupled=True)
        dA = device_matrix(A, CPU)
        bd = _b_on_cols_layout(b, dA)
        B = torch.stack([bd, 2.0 * bd], dim=-1)
        X0 = torch.zeros_like(B)
        got = make_cg_fn(dA, 1e-9, 200, rhs_batch=2)(B, X0)
        want = make_block_cg_fn(dA, 1e-9, 200, 2)(B, X0)
        assert torch.equal(got[0], want[0])
        assert np.array_equal(np.asarray(got[3]), np.asarray(want[3]))
        with pytest.raises(ValueError, match="pipelined"):
            make_cg_fn(dA, 1e-9, 200, pipelined=True, rhs_batch=2)
        with pytest.raises(pt.LoweringConflictError):
            make_cg_fn(dA, 1e-9, 200, sstep=2, rhs_batch=2)
        return True

    assert pt.prun(driver, CPU, (2, 2))


def test_exchange_rounds_count_box_directions():
    """A box exchange on the (2,2,2) 48^3 layout adds ``len(plan.info.dirs)``
    (= ``plan.R``) rounds to ``EXCHANGES`` and the generic one its ``R``
    colour rounds; one call each."""

    def driver(parts):
        return pt.prange(parts, (48, 48, 48), pt.with_ghost)

    rows = pt.prun(driver, CPU, (2, 2, 2))
    for box in (True, False):
        plan = tgpu.device_exchange_plan(rows, CPU, box=box)
        assert isinstance(plan, tgpu.DeviceExchangePlan) != box
        layout = tgpu.device_layout(rows, box)
        xv = torch.zeros((layout.P, layout.W), dtype=torch.float64)
        before = dict(tgpu.EXCHANGES)
        tgpu.exchange_(plan, xv)
        want = len(plan.info.dirs) if box else plan.R
        assert want == plan.R and want > 1
        assert tgpu.EXCHANGES["calls"] - before["calls"] == 1
        assert tgpu.EXCHANGES["rounds"] - before["rounds"] == want


def test_gate_drain_waits_for_a_concurrent_dispatch(monkeypatch):
    """Another thread's pump takes the request off the queue and submits it
    slowly; a `drain` started in that window returns only once the request
    is done."""
    import threading
    import time

    def driver(parts):
        A, b, _xe, x0 = pt.assemble_poisson(parts, (8, 8))
        return A, b, x0

    A, b, x0 = pt.prun(driver, pt.sequential, (2, 2))
    gate = pt.frontdoor.Gate(start_workers=True)
    gate.register("t", A, kmax=2)
    submit = gate.registry.submit

    def slow_submit(*a, **k):
        time.sleep(0.3)
        return submit(*a, **k)

    monkeypatch.setattr(gate.registry, "submit", slow_submit)
    try:
        h = gate.submit("t", b, x0=x0, tol=1e-9)
        pump = threading.Thread(target=gate.pump)
        pump.start()
        deadline = time.monotonic() + 10.0
        while gate._queue and time.monotonic() < deadline:
            time.sleep(0.001)
        assert not gate._queue, "the pump thread did not take the request"
        gate.drain()
        assert h.done() and h.result()[1]["converged"]
        pump.join(timeout=10.0)
        assert not pump.is_alive()
    finally:
        gate.shutdown()


def test_gate_pump_that_raises_leaves_no_dispatch_pending(monkeypatch):
    """A dispatch loop that raises past its per-request handler (here a
    BaseException out of the submit) takes the rest of its batch off the
    dispatch count, so a later `drain` returns instead of waiting for
    ever."""

    class Stop(BaseException):
        pass

    def driver(parts):
        A, b, _xe, x0 = pt.assemble_poisson(parts, (8, 8))
        return A, b, x0

    A, b, x0 = pt.prun(driver, pt.sequential, (2, 2))
    gate = pt.frontdoor.Gate(start_workers=True)
    gate.register("t", A, kmax=2)

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(gate.registry, "submit", stop)
    try:
        gate.submit("t", b, x0=x0, tol=1e-9)
        with pytest.raises(Stop):
            gate.pump()
        assert gate._dispatching == 0
        gate.drain()
    finally:
        gate.shutdown(drain=False)
