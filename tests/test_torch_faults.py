"""The port's chaos harness (`parallel/faults.py`) against the JAX package's.

The same spec grammar (each clause parsed to the same fields, the same
refusals), the same seeded corruption (`_corrupt_array`: the same words hit
and the same bits, for NaN and bit flips, f64 and f32, single payloads and
(L, K) slabs), the device loops' clause grammar (`parse_device_fault`
against the JAX package's ``PA_FAULT_DEVICE`` parser), and the hook at the
exchange choke point: on the sequential backend (8x8 Poisson, (2,2) parts)
the same spec and seed fire the same events and raise the same typed error
in host `cg` in both packages (a dropped part's timeout, a lost controller,
a dead part, a delay that is no error, an out-of-grid clause that fires
nothing, and a silent bit flip whose wrong answer is the JAX package's to
rounding). `solve_with_recovery` restarts a lost controller once, as the JAX
package's does, and lets a dead part through.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.models import solve_with_recovery as jax_recovery
from partitionedarrays_jl_tpu.parallel import faults as jf
from partitionedarrays_jl_tpu_torch.parallel import faults as pf

NS = (8, 8)
PARTS = (2, 2)

SPECS = [
    "nan@part=1,call=3",
    "bitflip@part=*,after=2,prob=0.25",
    "drop@part=2,call=5; delay@seconds=0.5; controller@call=7",
    "bitflip@part=1,call=3,bit=51",
    "part_loss@part=2,after=4",
    "NaN @ part = 0 , call = * ;",
]

BAD_SPECS = ["meteor@part=1", "nan@part", "nan@color=red", "part_loss@call=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_matches(spec):
    got = pf.FaultSpec.parse(spec).clauses
    want = jf.FaultSpec.parse(spec).clauses
    fields = ("kind", "part", "call", "after", "prob", "bit", "seconds")
    assert [tuple(getattr(c, f) for f in fields) for c in got] == [tuple(getattr(c, f) for f in fields) for c in want]
    for call in range(8):
        for part in (None, 0, 1, 2):
            assert [c.matches(call, part) for c in got] == [c.matches(call, part) for c in want]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_spec_refusals_match(spec):
    with pytest.raises(ValueError):
        jf.FaultSpec.parse(spec)
    with pytest.raises(ValueError):
        pf.FaultSpec.parse(spec)


@pytest.mark.parametrize("kind,bit", [("nan", None), ("bitflip", None), ("bitflip", 51), ("bitflip", 70)])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("prob", [0.25, 0.0])
def test_seeded_corruption_is_the_jax_packages(kind, bit, K, dtype, prob):
    """The same words hit with the same bits, drawn from the same seeded
    generator, which ends in the same state."""
    base = np.linspace(1.0, 2.0, 16).astype(dtype)
    a = base.copy() if K == 1 else np.tile(base[:, None], (1, K))
    b = a.copy()
    r1, r2 = np.random.default_rng(123), np.random.default_rng(123)
    n1 = jf._corrupt_array(a, kind, prob, r1, bit=bit)
    n2 = pf._corrupt_array(b, kind, prob, r2, bit=bit)
    assert n1 == n2 >= 1
    assert a.tobytes() == b.tobytes()
    assert r1.random() == r2.random()


@pytest.mark.parametrize("text", ["spmv@trip=8", "spmv@trip=8,part=1,factor=1e4", "SPMV@ factor=2.5, trip=3"])
def test_device_clause_grammar_matches(text, monkeypatch):
    monkeypatch.setenv("PA_FAULT_DEVICE", text)
    assert pf.parse_device_fault(text) == jf.device_fault_clause()


@pytest.mark.parametrize("text", ["spmv@part=1", "disk@trip=3", "spmv@trip=3,color=1", "spmv@trip"])
def test_device_clause_refusals_match(text, monkeypatch):
    monkeypatch.setenv("PA_FAULT_DEVICE", text)
    with pytest.raises(ValueError):
        jf.device_fault_clause()
    with pytest.raises(ValueError):
        pf.parse_device_fault(text)


def _faulted_cg(m, spec, seed=0):
    """Host cg under ``spec`` after a warm solve: (error type, events,
    gathered x or None, converged)."""

    def driver(parts):
        A, b, _, x0 = m.assemble_poisson(parts, NS)
        m.cg(A, b, x0=x0, tol=1e-9)  # warm: the exchangers' plans are built
        inject = jf.inject_faults if m is pa else pf.inject_faults
        with inject(spec, seed=seed) as st:
            try:
                x, info = m.cg(A, b, x0=x0, tol=1e-9)
            except Exception as e:  # noqa: BLE001 - the type is the result
                return type(e).__name__, list(st.events), None, False, dict(getattr(e, "diagnostics", {}))
        return None, list(st.events), m.gather_pvector(x), info["converged"], {}

    return m.prun(driver, m.sequential, PARTS)


@pytest.mark.parametrize("spec", [
    "drop@part=2,call=5", "controller@call=6", "controller@part=9,call=3", "part_loss@part=1,after=4",
    "delay@call=2,seconds=0.0", "nan@part=1,call=9", "bitflip@part=1,call=4,prob=1.0",
    "bitflip@part=1,call=20,bit=51",
])
def test_exchange_hook_matches(spec):
    want = _faulted_cg(pa, spec, seed=11)
    got = _faulted_cg(pt, spec, seed=11)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[3] == want[3]
    if want[0] is None:
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12 * np.abs(want[2]).max())
    for key in ("missing_parts", "part", "call", "iteration"):
        assert got[4].get(key) == want[4].get(key)


def test_bitflip_without_defense_is_silently_wrong():
    """The threat model (tests/test_abft.py:71): a high-bit flip with no
    defense converges on paper to an answer far from the clean one, and
    the info carries no SDC counters."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (12, 12))
        x_clean, _ = pt.cg(A, b, x0=x0, tol=1e-10)
        with pf.inject_faults("bitflip@part=1,call=20,bit=51", seed=3) as st:
            x_bad, info = pt.cg(A, b, x0=x0, tol=1e-10)
        err = float(np.abs(pt.gather_pvector(x_bad) - pt.gather_pvector(x_clean)).max())
        return [e["kind"] for e in st.events], info["converged"], err, "sdc" in info

    kinds, converged, err, has_sdc = pt.prun(driver, pt.sequential, PARTS)
    assert kinds == ["bitflip"] and converged and err > 1e-7 and not has_sdc


def test_recovery_restarts_a_lost_controller():
    """`solve_with_recovery` takes a lost controller as survivable: one
    restart, converged, the JAX package's failure record and x."""

    def run(m, recover, inject):
        def driver(parts):
            A, b, _, x0 = m.assemble_poisson(parts, NS)
            with inject("controller@call=6", seed=0):
                x, info = recover(A, b, method="cg", x0=x0, tol=1e-9)
            return m.gather_pvector(x), info["restarts"], info["converged"], info["failures"][0]["type"], \
                info["recovery"]["attempts"]

        return m.prun(driver, m.sequential, PARTS)

    want = run(pa, jax_recovery, jf.inject_faults)
    got = run(pt, pt.solve_with_recovery, pf.inject_faults)
    assert got[1:] == want[1:] == (1, True, "ControllerLostError", 2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12 * np.abs(want[0]).max())


def test_recovery_lets_a_dead_part_through():
    """A dead part is persistent: no restart is spent on it, the typed
    `PartLossError` reaches the caller (the elastic shrink over the
    survivors runs across cards and is not ported)."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, NS)
        with pf.inject_faults("part_loss@part=2,after=3", seed=0):
            with pytest.raises(pt.PartLossError) as ei:
                pt.solve_with_recovery(A, b, x0=x0, tol=1e-9)
        return ei.value.diagnostics["part"]

    assert pt.prun(driver, pt.sequential, PARTS) == 2
