"""The port's elastic tier (`parallel/elastic.py`, the cross-count restore of
`parallel/checkpoint.py`, the elastic rung of `solve_with_recovery`)
against the JAX package's.

* The cases of the JAX package's `tests/test_paelastic.py`: shrink shapes
  and the ``min_parts`` floor (`elastic.configure`, the JAX package's
  ``PA_ELASTIC_MIN_PARTS``), the survivor partition and its verified plan,
  the 8 -> 4 -> 8 solver-state round trip bit for bit (and across the two
  packages' checkpoints), the typed refusal with the config off, the plan
  fingerprints of a shrink and a grow, and the re-admission against the
  front door's budget.
* The chaos rows of `tests/test_chaos_matrix.py`: a part loss with the
  config on shrinks and resumes; off, it escalates typed with no restart.
  On `pt.sequential` against `pa.sequential` the ledger (``info["elastic"]``,
  ``restart_sources``), the iterations and the event kinds are equal and x
  within 1e-12 relative (the port's dots fold left to right, the JAX
  package's by `jnp.sum`). On `GPUBackend(device="cpu")` the JAX package's
  own rung raises ``ValueError`` on its device backend (its resume passes
  ``checkpoint=`` to the device `cg`; pinned here), so the port's resumed x
  is held against the JAX package's `shrink_system` and a device
  ``cg(A2, b2, x0=x_k)`` on `pa.tpu` from the same checkpointed x_k: equal
  iterations, x within 1e-10 of max |x| (the device recovery parity of
  `tests/test_torch_checkpoint.py`); and the resume is bit for bit a cold
  solve on freshly repartitioned survivors from x_k.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import telemetry as jtel
from partitionedarrays_jl_tpu.parallel import elastic as jel
from partitionedarrays_jl_tpu.parallel.faults import inject_faults as jax_inject
from partitionedarrays_jl_tpu.parallel.health import PartLossError as JaxPartLossError
from partitionedarrays_jl_tpu_torch import frontdoor, telemetry
from partitionedarrays_jl_tpu_torch.analysis.plan_verifier import (
    canonical_exchange_fingerprint, check_plan, plan_fingerprint,
)
from partitionedarrays_jl_tpu_torch.frontdoor.tenancy import TenantBudgetError
from partitionedarrays_jl_tpu_torch.parallel import elastic
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.telemetry.tracing import clear_spans, recorded_spans
from partitionedarrays_jl_tpu_torch.utils.health import PartLossError

CPU = GPUBackend(device="cpu")
TOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_degraded_marker():
    """The degraded marker is process-wide in both packages: each test
    starts and ends at full capacity."""
    elastic._DEGRADED.clear()
    jel._DEGRADED.clear()
    yield
    elastic._DEGRADED.clear()
    jel._DEGRADED.clear()


def _kinds(rec):
    return [(e.kind, e.label) for e in rec.events if e.kind != "compile_cache"]


def _has(rec, kind, label=None):
    return any(e.kind == kind and (label is None or e.label == label) for e in rec.events)


def _shrinks(reg):
    return reg.counter("elastic.shrink", labels={"reason": "part_loss"}).value


# ---------------------------------------------------------------------------
# shrink shapes, survivor partitions
# ---------------------------------------------------------------------------


def test_shrink_shape_rules(monkeypatch):
    """The first axis above one part shrinks; a dead part falls off the grid;
    the floor refuses: the JAX package's answers, its floor set by
    ``PA_ELASTIC_MIN_PARTS`` and the port's by `elastic.configure`."""
    for shape, dead in (((4, 2), None), ((1, 3), None), ((4,), None), ((4, 2), 5), ((2, 2, 2), 6), ((3, 3), 8)):
        assert pt.shrink_shape(shape, dead_part=dead) == pa.shrink_shape(shape, dead_part=dead)
    assert pt.shrink_shape((4, 2), dead_part=5) == (2, 2)
    assert pt.shrink_shape((2, 2, 2), dead_part=6) == (1, 2, 2)
    with pytest.raises(ValueError):
        pt.shrink_shape((1, 1))
    monkeypatch.setenv("PA_ELASTIC_MIN_PARTS", "6")
    with elastic.configure(min_parts=6):
        assert pt.elastic_min_parts() == 6 == pa.elastic_min_parts()
        with pytest.raises(ValueError):
            pt.shrink_shape((4, 2), dead_part=3)
        with pytest.raises(ValueError):
            pa.shrink_shape((4, 2), dead_part=3)
    assert pt.elastic_min_parts() == 1 and not pt.elastic_enabled()


def test_survivor_rows_ghost_free_and_verified():
    def driver(parts):
        A = pt.assemble_poisson(parts, (8, 8))[0]
        rows6 = pt.survivor_rows(A.rows, shape=(3, 2))
        assert not rows6.ghost and rows6.partition.num_parts == 6 and rows6.ngids == A.rows.ngids
        A6 = pt.repartition_psparse(A, rows6)
        check_plan(A6.cols.exchanger, parts=A6.cols.partition.part_values(), context="test_survivor_rows")
        return [np.asarray(i.oid_to_gid) for i in rows6.partition.part_values()]

    mine = pt.prun(driver, CPU, (4, 2))
    theirs = pa.prun(lambda parts: [np.asarray(i.oid_to_gid) for i in pa.survivor_rows(
        pa.assemble_poisson(parts, (8, 8))[0].rows, shape=(3, 2)).partition.part_values()], pa.sequential, (4, 2))
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# cross-part-count solver-state restores
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_8_4_8_bitwise(tmp_path):
    """8 -> 4 -> 8: a solver-state checkpoint of 8 parts restores onto 4 with
    the config on (counted once), is saved again and restores onto the
    8-part partition bit for bit."""
    d8, d4 = str(tmp_path / "p8"), str(tmp_path / "p4")

    def save8(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        x_ref, _ = pt.cg(A, b, x0=x0, tol=TOL)
        ck = pt.SolverCheckpointer(d8, every=1)
        ck.save_state({"x": x_ref}, {"method": "cg", "it": 9, "tol": TOL})
        ck.wait()
        return pt.gather_pvector(x_ref)

    g_ref = pt.prun(save8, CPU, (4, 2))
    n0 = telemetry.counter("elastic.crosspart_restores")
    with elastic.configure(enabled=True):
        def hop4(parts):
            st = pt.load_solver_state(d8, {"x": pt.uniform_partition(parts, 64)})
            assert int(st["meta"]["it"]) == 9
            ck = pt.SolverCheckpointer(d4, every=1)
            ck.save_state({"x": st["x"]}, dict(st["meta"]))
            ck.wait()
            return pt.gather_pvector(st["x"])

        np.testing.assert_array_equal(pt.prun(hop4, pt.sequential, (2, 2)), g_ref)
        assert telemetry.counter("elastic.crosspart_restores") == n0 + 1

        def back8(parts):
            A = pt.assemble_poisson(parts, (8, 8))[0]
            st = pt.load_solver_state(d4, {"x": A.cols})
            assert int(st["meta"]["it"]) == 9
            return pt.gather_pvector(st["x"])

        np.testing.assert_array_equal(pt.prun(back8, CPU, (4, 2)), g_ref)


def test_cross_count_restore_across_packages(tmp_path, monkeypatch):
    """A JAX package's 8-part solver state restores onto the port's 4 parts
    exactly as onto the JAX package's own 4 parts, and the reverse."""
    monkeypatch.setenv("PA_ELASTIC", "1")

    def save(m, backend, d):
        def driver(parts):
            A, b, xe, x0 = m.assemble_poisson(parts, (8, 8))
            ck = m.SolverCheckpointer(d, every=1)
            ck.save_state({"x": b}, {"method": "cg", "it": 4, "tol": TOL})
            ck.wait()
            return True
        m.prun(driver, backend, (4, 2))

    def load(m, backend, d):
        return m.prun(lambda parts: m.gather_pvector(m.load_solver_state(d, {"x": m.uniform_partition(parts, 64)})
                                                     ["x"]), backend, (2, 2))

    save(pa, pa.sequential, str(tmp_path / "j"))
    save(pt, CPU, str(tmp_path / "p"))
    with elastic.configure(enabled=True):
        for d in ("j", "p"):
            np.testing.assert_array_equal(load(pt, pt.sequential, str(tmp_path / d)),
                                          load(pa, pa.sequential, str(tmp_path / d)))


def test_solver_state_cross_count_refused_without_elastic(tmp_path):
    """With the config off the solver-state restore refuses another part
    count typed, naming both counts and the switch; the same part count
    stays ungated."""
    d = str(tmp_path / "ck")

    def save4(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        ck = pt.SolverCheckpointer(d, every=1)
        ck.save_state({"x": x0}, {"method": "cg", "it": 2, "tol": TOL})
        ck.wait()
        return True

    assert pt.prun(save4, pt.sequential, (2, 2))

    def load2(parts):
        rows = pt.uniform_partition(parts, 64)
        with pytest.raises(pt.CheckpointShapeError) as ei:
            pt.load_solver_state(d, {"x": rows})
        msg = str(ei.value)
        assert "4 parts" in msg and "2 parts" in msg and "elastic" in msg
        with elastic.configure(enabled=True):
            st = pt.load_solver_state(d, {"x": rows})
        assert st is not None and int(st["meta"]["it"]) == 2
        return True

    assert pt.prun(load2, pt.sequential, 2)
    st = pt.prun(lambda parts: pt.load_solver_state(d, {"x": pt.uniform_partition(parts, 64)}), pt.sequential, (2, 2))
    assert int(st["meta"]["it"]) == 2


# ---------------------------------------------------------------------------
# plan fingerprints across a shrink and a grow; the budget re-check
# ---------------------------------------------------------------------------


def test_repartitioned_plans_distinct_but_canonical_fingerprint_survives():
    """A shrink derives another plan (fingerprint-distinct) that passes every
    check; a grow back onto the original rows restores the
    layout-independent fingerprint, the JAX package's too."""
    def driver(parts):
        A = pt.assemble_poisson(parts, (8, 8))[0]
        f_orig = plan_fingerprint(A.cols.exchanger)
        c_orig = canonical_exchange_fingerprint(A.cols.exchanger, A.cols.partition)
        A6 = pt.repartition_psparse(A, pt.survivor_rows(A.rows, shape=(3, 2)))
        assert plan_fingerprint(A6.cols.exchanger) != f_orig
        check_plan(A6.cols.exchanger, parts=A6.cols.partition.part_values(), context="shrunken")
        A8 = pt.repartition_psparse(A6, A.rows)
        check_plan(A8.cols.exchanger, parts=A8.cols.partition.part_values(), context="grown-back")
        assert canonical_exchange_fingerprint(A8.cols.exchanger, A8.cols.partition) == c_orig
        return canonical_exchange_fingerprint(A6.cols.exchanger, A6.cols.partition)

    from partitionedarrays_jl_tpu.analysis.plan_verifier import canonical_exchange_fingerprint as jax_canonical

    def jax(parts):
        A = pa.assemble_poisson(parts, (8, 8))[0]
        A6 = pa.repartition_psparse(A, pa.survivor_rows(A.rows, shape=(3, 2)))
        return jax_canonical(A6.cols.exchanger, A6.cols.partition)

    assert pt.prun(driver, CPU, (4, 2)) == pa.prun(jax, pa.sequential, (4, 2))


def test_shrink_rechecks_memory_budget(monkeypatch):
    """The shrunken footprint is checked against the front door's budget: an
    impossible one refuses typed with both part counts; with room the same
    shrink admits and marks the degraded state, as in the JAX package."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8))
        with frontdoor.configure(mem_budget=1):
            with pytest.raises(TenantBudgetError) as ei:
                pt.shrink_system(A, b)
        d = ei.value.diagnostics
        assert d["from_parts"] == 8 and d["to_parts"] == 6 and d["footprint_bytes"] > d["budget_bytes"]
        A2, b2, x2, info = pt.shrink_system(A, b)
        assert info["to_parts"] == 6 and x2 is None
        assert pt.degraded_state()["to_parts"] == 6
        return info

    mine = pt.prun(driver, CPU, (4, 2))
    theirs = pa.prun(lambda parts: pa.shrink_system(*pa.assemble_poisson(parts, (8, 8))[:2])[3], pa.sequential,
                     (4, 2))
    assert mine == theirs


# ---------------------------------------------------------------------------
# the chaos rows
# ---------------------------------------------------------------------------


def _repartition_spans():
    return [s for s in recorded_spans() if s["kind"] == "tenant.repartition"]


def _elastic_host_run(m, backend, inject, configure, d):
    """The JAX chaos row's driver: 8x8 Poisson on (2, 2), part 3 lost at
    exchange call 6, checkpoints every 3 iterations, then a full-capacity
    solve (grow-back)."""
    def driver(parts):
        A, b, xe, x0 = m.assemble_poisson(parts, (8, 8))
        x_clean, _ = m.cg(A, b, x0=x0, tol=TOL)
        tel = telemetry if m is pt else jtel
        clear_spans()
        m0 = (_shrinks(tel.registry()), tel.counter("elastic.crosspart_restores"),
              tel.counter("events.elastic_shrink"), tel.counter("events.elastic_restore"))
        with configure(), inject("part_loss@part=3,after=6", seed=1):
            x, info = m.solve_with_recovery(A, b, x0=x0, checkpoint_dir=d, every=3, tol=TOL)
        rec = tel.last_record("solve_with_recovery")
        m1 = (_shrinks(tel.registry()), tel.counter("elastic.crosspart_restores"),
              tel.counter("events.elastic_shrink"), tel.counter("events.elastic_restore"))
        out = {"x": m.gather_pvector(x), "clean": m.gather_pvector(x_clean), "info": info, "events": _kinds(rec),
               "deltas": tuple(b - a for a, b in zip(m0, m1))}
        if m is pt:
            out["spans"] = _repartition_spans()
        m.solve_with_recovery(A, b, x0=x0, tol=TOL)
        rec2 = tel.last_record("solve_with_recovery")
        out["grow_back"] = _has(rec2, "elastic_restore", "grow_back")
        out["degraded_after"] = (elastic if m is pt else jel).degraded_state()
        return out

    return m.prun(driver, backend, (2, 2))


def test_matrix_part_loss_elastic_shrinks_and_resumes(tmp_path, monkeypatch):
    """The paelastic row on the host backends: the port's ledger, iterations
    and event kinds are the JAX package's, x within 1e-12 relative; one
    shrink, one cross-count restore, one ``tenant.repartition`` span, and
    the next full-capacity solve grows back."""
    def jax_configure():
        monkeypatch.setenv("PA_ELASTIC", "1")
        return _Restore(monkeypatch, "PA_ELASTIC")

    mine = _elastic_host_run(pt, pt.sequential, pt.inject_faults, lambda: elastic.configure(enabled=True),
                             str(tmp_path / "p"))
    theirs = _elastic_host_run(pa, pa.sequential, jax_inject, jax_configure, str(tmp_path / "j"))
    el = mine["info"]["elastic"]
    assert el["from_parts"] == 4 and el["to_parts"] == 2 and el["dead_part"] == 3
    assert el["checkpoint_iteration"] and el["checkpoint_iteration"] > 0
    assert mine["info"]["converged"] and mine["info"]["restarts"] == 0
    assert np.abs(mine["x"] - mine["clean"]).max() < 1e-7
    assert [s["from"] for s in mine["info"]["recovery"]["restart_sources"]] == ["elastic_shrink_checkpoint"]
    assert mine["info"]["recovery"]["checkpoint_restarts"] == 1
    for want in [("fault_injected", "part_loss"), ("health_error", "PartLossError"), ("elastic_shrink", "part_loss"),
                 ("restart", "PartLossError")]:
        assert want in mine["events"]
    assert any(k == "checkpoint_restore" for k, _ in mine["events"])
    assert mine["deltas"] == (1, 1, 1, 0)
    assert len(mine["spans"]) == 1
    assert mine["spans"][0]["attrs"]["from_parts"] == 4 and mine["spans"][0]["attrs"]["to_parts"] == 2
    assert mine["grow_back"] and not mine["degraded_after"]
    # against the JAX package
    assert mine["info"]["elastic"] == theirs["info"]["elastic"]
    assert mine["info"]["iterations"] == theirs["info"]["iterations"]
    assert mine["info"]["recovery"] == theirs["info"]["recovery"]
    assert mine["events"] == theirs["events"]
    assert mine["deltas"] == theirs["deltas"] and mine["grow_back"] == theirs["grow_back"]
    np.testing.assert_allclose(mine["x"], theirs["x"], rtol=0, atol=1e-12 * np.abs(theirs["x"]).max())


class _Restore:
    """A context manager that unsets an environment switch the JAX side read."""

    def __init__(self, monkeypatch, name):
        self.monkeypatch, self.name = monkeypatch, name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.monkeypatch.delenv(self.name, raising=False)
        return False


@pytest.mark.parametrize("backend", ["seq", "gpu"])
def test_matrix_part_loss_without_elastic_escalates_typed(backend, tmp_path):
    """With the config off a lost part raises a typed `PartLossError` at
    once, the JAX package's diagnostics, no restart attempted or narrated
    (on the device loop the loss lands at the third chunk's host exchange)."""
    after, kw = (6, {}) if backend == "seq" else (2, {"checkpoint_dir": str(tmp_path), "every": 3})

    def run(m, backend_, inject, err):
        def driver(parts):
            A, b, xe, x0 = m.assemble_poisson(parts, (8, 8))
            tel = telemetry if m is pt else jtel
            n0 = (tel.counter("events.restart"), tel.counter("events.elastic_shrink"))
            with inject(f"part_loss@part=3,after={after}", seed=1):
                with pytest.raises(err) as ei:
                    m.solve_with_recovery(A, b, x0=x0, tol=TOL, max_restarts=2, **kw)
            aborted = tel.last_record("solve_with_recovery")
            assert aborted.status == "raised"
            assert _has(aborted, "fault_injected", "part_loss") and _has(aborted, "health_error", "PartLossError")
            assert not _has(aborted, "restart")
            n1 = (tel.counter("events.restart"), tel.counter("events.elastic_shrink"))
            return ei.value.diagnostics["part"], ei.value.diagnostics["call"], n1[0] - n0[0], n1[1] - n0[1]

        return m.prun(driver, backend_, (2, 2))

    mine = run(pt, pt.sequential if backend == "seq" else CPU, pt.inject_faults, PartLossError)
    assert mine == (3, after, 0, 0)
    if backend == "seq":
        assert mine == run(pa, pa.sequential, jax_inject, JaxPartLossError)


def _device_elastic_run(d, after=2, every=5):
    """The port's elastic rung on `GPUBackend(device="cpu")`: 8^3 Poisson on
    (2, 2, 2), part 6 lost at the third chunk's host exchange."""
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        # the column exchanger is built before the faults are armed, so
        # `after` counts the solve's exchanges alone (the COO-free assembly
        # builds none; the COO route's b product built it)
        A.cols.exchanger
        with elastic.configure(enabled=True), pt.inject_faults(f"part_loss@part=6,after={after}", seed=1):
            x, info = pt.solve_with_recovery(A, b, x0=x0, checkpoint_dir=d, every=every, tol=TOL)
        # the cold solve a fresh caller runs on freshly repartitioned
        # survivors from the same checkpointed x_k
        A2, b2, _, _ = pt.shrink_system(A, b, shape=info["elastic"]["shape"])
        with elastic.configure(enabled=True):
            st = pt.load_solver_state(d, {"x": A2.cols, "r": b2.rows, "p": A2.cols})
        x_cold, info_cold = pt.cg(A2, b2, x0=st["x"], tol=TOL)
        return {"x": pt.gather_pvector(x), "info": info, "cold": pt.gather_pvector(x_cold),
                "cold_iterations": info_cold["iterations"], "x_k": pt.gather_pvector(st["x"])}

    return pt.prun(driver, CPU, (2, 2, 2))


def test_device_elastic_resume_against_the_jax_device_cg(tmp_path, monkeypatch):
    """On the device loop: the shrink 8 -> 4, the resume bit for bit the cold
    solve from x_k on fresh survivors, and against the JAX package's
    `shrink_system` and device `cg` on `pa.tpu` from the same x_k: equal
    iterations, x within 1e-10 of max |x|."""
    mine = _device_elastic_run(str(tmp_path / "p"))
    el, info = mine["info"]["elastic"], mine["info"]
    assert (el["from_parts"], el["to_parts"], el["dead_part"], el["shape"]) == (8, 4, 6, [1, 2, 2])
    assert el["checkpoint_iteration"] == 10
    assert info["converged"] and info["restarts"] == 0
    assert info["recovery"]["restart_sources"][0]["from"] == "elastic_shrink_checkpoint"
    np.testing.assert_array_equal(mine["x"], mine["cold"])
    assert info["iterations"] == mine["cold_iterations"]
    monkeypatch.setenv("PA_ELASTIC", "1")

    def jax(parts):
        A, b, xe, x0 = pa.assemble_poisson(parts, (8, 8, 8))
        A2, b2, _, _ = pa.shrink_system(A, b, shape=tuple(el["shape"]))
        x_k = pa.scatter_pvector_values(mine["x_k"], A2.cols)
        x, jinfo = pa.cg(A2, b2, x0=x_k, tol=TOL)
        return pa.gather_pvector(x), jinfo["iterations"]

    x_jax, it_jax = pa.prun(jax, pa.tpu, (2, 2, 2))
    assert info["iterations"] == it_jax
    np.testing.assert_allclose(mine["x"], x_jax, rtol=0, atol=1e-10 * np.abs(x_jax).max())


def test_jax_device_rung_refuses_the_checkpointed_resume(tmp_path, monkeypatch):
    """The recorded difference: the JAX package's elastic rung passes
    ``checkpoint=`` to its device `cg`, which refuses it, so on `pa.tpu` the
    same fault ends in ``ValueError`` where the port resumes."""
    monkeypatch.setenv("PA_ELASTIC", "1")

    def driver(parts):
        A, b, xe, x0 = pa.assemble_poisson(parts, (8, 8, 8))
        with jax_inject("part_loss@part=6,after=2", seed=1):
            with pytest.raises(ValueError, match="host-loop feature"):
                pa.solve_with_recovery(A, b, x0=x0, checkpoint_dir=str(tmp_path / "j"), every=5, tol=TOL)
        return True

    assert pa.prun(driver, pa.tpu, (2, 2, 2))
