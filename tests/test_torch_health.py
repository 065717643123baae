"""The port's typed health guards against the JAX package's.

The repair this file pins: a NaN in b used to come back from the port's
`cg`, `pcg` and `gmres` (host loops and the device loop) as ``converged=False``
after 0 iterations, with no error; the JAX package raises `NonFiniteError`
(solvers.py:446, :1602, :1740; the device wrapper tpu.py:5903-5918). Every
case runs the same inputs through both packages (8x8 Poisson on (2,2) parts,
the sequential backend; the device loops on `GPUBackend(device="cpu")` and
`pa.tpu` on the 8-device CPU mesh) and holds the port's error type and
``diagnostics["iteration"]`` to the JAX package's: a NaN in b, a NaN entering
mid-solve through the exchange hook, a breakdown (p'Ap == 0), and the opt-in
stagnation guard (the JAX package's ``PA_HEALTH_STAGNATION``, here the
``stagnation=`` keyword); ``health=False`` (``PA_HEALTH_CHECKS=0``) returns
instead. The unit parts of `utils/health.py` (`StagnationDetector`,
`RollbackRing`, `retry_with_backoff`'s delays, the tolerances and the
per-part census) are held against `partitionedarrays_jl_tpu.parallel.health`.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.parallel import health as jh
from partitionedarrays_jl_tpu.parallel.faults import inject_faults as jax_inject
from partitionedarrays_jl_tpu_torch.parallel.faults import inject_faults as port_inject
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.utils import health as ph

CPU = GPUBackend(device="cpu")
NS = (8, 8)
PARTS = (2, 2)


def _poison(b, part=1):
    """One owned entry of b on ``part`` set to NaN (in place)."""
    iset = b.rows.partition.part_values()[part]
    b.values.part_values()[part][int(np.asarray(iset.oid_to_lid)[0])] = np.nan
    return b


def _solve(m, method, A, b, x0, **kw):
    if method == "cg":
        return m.cg(A, b, x0=x0, tol=1e-9, **kw)
    if method == "pcg":
        return m.pcg(A, b, x0=x0, tol=1e-9, **kw)
    return m.gmres(A, b, x0=x0, tol=1e-9, **kw)


def _raised(m, backend, method, nan_b=True, fault=None, inject=None, **kw):
    """(error type name, diagnostics iteration) of one poisoned solve."""

    def driver(parts):
        A, b, _, x0 = m.assemble_poisson(parts, NS)
        if fault is not None:
            m.cg(A, b, x0=x0, tol=1e-9)  # warm: the exchangers' plans are built
        if nan_b:
            _poison(b)
        try:
            if fault is not None:
                with inject(fault, seed=3):
                    _solve(m, method, A, b, x0, **kw)
            else:
                _solve(m, method, A, b, x0, **kw)
        except Exception as e:  # noqa: BLE001 - the type is the result
            return type(e).__name__, getattr(e, "diagnostics", {}).get("iteration")
        return None, None

    return m.prun(driver, backend, PARTS)


@pytest.mark.parametrize("method", ["cg", "pcg", "gmres"])
@pytest.mark.parametrize("where", ["sequential", "device"])
def test_nan_in_b_raises_where_jax_does(method, where):
    """The repair: the port raises `NonFiniteError` at the JAX package's
    iteration, on the host loops and the device loops."""
    want = _raised(pa, pa.sequential if where == "sequential" else pa.tpu, method)
    got = _raised(pt, pt.sequential if where == "sequential" else CPU, method)
    assert want[0] == "NonFiniteError"
    assert got == want


@pytest.mark.parametrize("fused", [True, False])
def test_device_cg_bodies_raise_nonfinite(fused):
    """Both device CG bodies stop on the in-graph finite test and raise
    (tpu.py:5911-5924), with the JAX package's iteration."""
    want = _raised(pa, pa.tpu, "cg", fused=fused)
    got = _raised(pt, CPU, "cg", fused=fused)
    assert got == want and got[0] == "NonFiniteError"


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_nan_entering_mid_solve(method):
    """A NaN halo payload at exchange call 6 raises `NonFiniteError` at the
    JAX package's iteration (the hook counts the same calls)."""
    want = _raised(pa, pa.sequential, method, nan_b=False, fault="nan@part=1,call=6", inject=jax_inject)
    got = _raised(pt, pt.sequential, method, nan_b=False, fault="nan@part=1,call=6", inject=port_inject)
    assert want[0] == "NonFiniteError" and got == want


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_health_off_returns_unconverged(method):
    """``health=False`` (the JAX package's ``PA_HEALTH_CHECKS=0``) keeps the
    old contract: no raise, not converged."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, NS)
        _poison(b)
        _, info = _solve(pt, method, A, b, x0, health=False)
        return info["converged"], info["iterations"]

    assert pt.prun(driver, pt.sequential, PARTS) == (False, 0)
    assert pt.prun(driver, CPU, PARTS) == (False, 0)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_breakdown_is_typed(method):
    """p'Ap == 0 (diag(1, -1), b = (1, 1)) raises `SolverBreakdownError` at
    iteration 0, as the JAX package does (tests/test_faults.py:294)."""

    def driver(m, parts):
        rows = m.prange(parts, 2)
        g = m.map_parts(lambda i: np.asarray(i.oid_to_gid), rows.partition)
        V = m.map_parts(lambda gi: np.where(gi == 0, 1.0, -1.0), g)
        A = m.PSparseMatrix.from_coo(g, g, V, rows, rows, ids="global")
        b = m.PVector.full(1.0, rows)
        minv = m.PVector.full(1.0, rows)
        try:
            if method == "cg":
                m.cg(A, b, tol=1e-12)
            else:
                m.pcg(A, b, minv=minv, tol=1e-12)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, e.diagnostics.get("iteration")

    want = pa.prun(lambda parts: driver(pa, parts), pa.sequential, 1)
    got = pt.prun(lambda parts: driver(pt, parts), pt.sequential, 1)
    assert want == ("SolverBreakdownError", 0) and got == want


def test_stagnation_guard_opt_in(monkeypatch):
    """``stagnation=(8, 0.99)`` raises `SolverStagnationError` where the JAX
    package's ``PA_HEALTH_STAGNATION=1`` (window 8) does: cg without the
    boundary start plateaus on the undecoupled Dirichlet system."""
    monkeypatch.setenv("PA_HEALTH_STAGNATION", "1")
    monkeypatch.setenv("PA_HEALTH_STAGNATION_WINDOW", "8")

    def run(m, **kw):
        def driver(parts):
            A, b, _, _ = m.assemble_poisson(parts, NS)
            try:
                m.cg(A, b, tol=1e-12, **kw)
            except Exception as e:  # noqa: BLE001
                d = e.diagnostics
                return type(e).__name__, d["iteration"], d["window"], d["best_residual"]

        return m.prun(driver, m.sequential, PARTS)

    want = run(pa)
    got = run(pt, stagnation=(8, 0.99))
    # the best residual to rounding: the two host loops agree to an ulp
    assert want[0] == "SolverStagnationError" and got[:3] == want[:3]
    assert got[3] == pytest.approx(want[3], rel=1e-12)
    monkeypatch.delenv("PA_HEALTH_STAGNATION")
    assert run(pt) is None or run(pt)[0] != "SolverStagnationError"


# ---------------------------------------------------------------------------
# the unit parts against the JAX package's
# ---------------------------------------------------------------------------


def test_error_family_matches():
    """Every typed error of the JAX package exists in the port, under the
    same base."""
    names = [n for n in jh.__all__ if n.endswith("Error") or n == "DeadlineInfeasible"]
    for n in names:
        cls = getattr(ph, n)
        assert issubclass(cls, ph.SolverHealthError)
        e = cls("x", {"iteration": 3})
        assert e.diagnostics == {"iteration": 3} and isinstance(e, RuntimeError)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tolerances_match(dtype):
    assert ph.abft_tolerance(dtype) == jh.abft_tolerance(dtype)
    assert ph.audit_tolerance(dtype) == jh.audit_tolerance(dtype)


def test_stagnation_detector_and_ring(monkeypatch):
    monkeypatch.setenv("PA_HEALTH_STAGNATION_WINDOW", "4")
    dets = (jh.StagnationDetector("unit"), ph.StagnationDetector("unit", window=4))
    raised = []
    for det in dets:
        for i, r in enumerate([10.0, 5.0, 2.0, 1.0]):
            det.update(r, i)
        with pytest.raises(Exception) as ei:
            for i in range(4, 9):
                det.update(0.999, i)
        raised.append((type(ei.value).__name__, ei.value.diagnostics))
    assert raised[0] == raised[1]
    rings = (jh.RollbackRing(2), ph.RollbackRing(2))
    for ring in rings:
        for k in range(3):
            ring.push({"x": np.full(2, float(k))}, {"it": k})
    for strike in range(3):
        a, b = (ring.restore(strike) for ring in rings)
        assert a[1] == b[1] and np.array_equal(a[0]["x"], b[0]["x"])


@pytest.mark.parametrize("jitter", [None, 7])
def test_retry_delays_match(jitter):
    """The same sleep sequence as the JAX package's, with and without the
    seeded jitter; the last failure re-raises."""
    out = []
    for f in (jh.retry_with_backoff, ph.retry_with_backoff):
        sleeps = []

        def flaky():
            raise OSError("transient")

        with pytest.raises(OSError):
            f(flaky, attempts=5, backoff=0.25, sleep=sleeps.append, jitter_seed=jitter, describe="unit")
        out.append(sleeps)
    assert out[0] == out[1] and len(out[0]) == 4


def test_nonfinite_diagnostics_match():
    def run(m):
        def driver(parts):
            A, b, _, x0 = m.assemble_poisson(parts, NS)
            _poison(b, 2)
            try:
                m.check_finite_pvector(b, "unit") if m is pt else jh.check_finite_pvector(b, "unit")
            except Exception as e:  # noqa: BLE001
                return e.diagnostics

        return m.prun(driver, m.sequential, PARTS)

    assert run(pt) == run(pa)


def test_sdc_config_defaults():
    """`SDCConfig` resolves as the JAX switches do: audits every 32 under
    ABFT, none without; an inactive config is no defense; a malformed
    device clause is refused at construction."""
    assert ph.SDCConfig(abft=True).every == 32 and ph.SDCConfig().every == 0
    assert ph.resolve_sdc(ph.SDCConfig()) is None
    assert ph.resolve_sdc(ph.SDCConfig(audit_every=5)).every == 5
    with pytest.raises(ValueError):
        ph.SDCConfig(device_fault="spmv@part=1")
    with pytest.raises(TypeError):
        ph.resolve_sdc({"abft": True})
