"""The port's comms accounting (`telemetry/comms.py`) and exchange cost
matrix (`telemetry/commsmatrix.py`) against the JAX package's, on the CPU:
the port on ``GPUBackend(device="cpu")``, the JAX package on ``pa.tpu`` (the
8-device CPU mesh), both on the lowering cases' probe system (6^3 Poisson on
(2, 2, 2) parts).

* The model: for every ``lowering_matrix(fast=True)`` case but
  ``twolevel``, the port's `cg_comms_profile` of the case's solve function
  equals the JAX package's (its record's setup and per-iteration
  inventories) dict for dict, and the port's record's ``comms`` equals the
  JAX package's `case_probe_solve` record's.
* The counted side: ``reconcile(rec.comms_counted, rec.comms) == []`` on
  every case of the port's lowering matrix, the strict and ABFT block
  bodies included, and on the Jacobi bodies (whose model is the port's
  own: the precond sweep folds r.r and r.z once); the pipelined body run
  right after the fused one reconciles against its own counted program.
* The matrix: `static_matrix` equals the JAX package's row for row on the
  box and the generic plan, every field but the fabric label, and
  `reconcile_matrix` is empty; the measured matrix's rounds and edges are
  timed and reconcile.
"""
import importlib

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.telemetry import commsmatrix as ja_cm
from partitionedarrays_jl_tpu_torch.models.solvers import jacobi_preconditioner
from partitionedarrays_jl_tpu_torch.telemetry import comms as pt_comms
from partitionedarrays_jl_tpu_torch.telemetry import commsmatrix as pt_cm
from partitionedarrays_jl_tpu_torch.utils.health import SDCConfig

jtpu = importlib.import_module("partitionedarrays_jl_tpu.parallel.tpu")
tgpu = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
CPU = tgpu.GPUBackend(device="cpu")
FAST = [c["name"] for c in jtpu.lowering_matrix(fast=True) if c["name"] != "twolevel"]


@pytest.fixture(scope="module")
def jax_records():
    """The JAX package's probe records of the fast cases, by name."""
    return {c["name"]: jtpu.case_probe_solve(pa.tpu, c) for c in jtpu.lowering_matrix(fast=True)
            if c["name"] != "twolevel"}


def _port_case(name):
    return next(c for c in pt_comms.lowering_cases() if c["name"] == name)


def test_port_cases_are_the_jax_cases():
    """The port's lowering cases carry the JAX package's names, environment
    and tiers (all but ``twolevel``)."""
    jax_cases = {c["name"]: c for c in jtpu.lowering_matrix(fast=False)}
    port = pt_comms.lowering_cases()
    assert [c["name"] for c in pt_comms.lowering_cases(fast=True)] == FAST
    assert {c["name"] for c in port} == set(jax_cases) - {"twolevel"}
    for c in port:
        assert c["env"] == jax_cases[c["name"]]["env"]
        assert c["dtype"] == jax_cases[c["name"]]["dtype"]
        assert c["tags"] == jax_cases[c["name"]]["tags"]


@pytest.mark.parametrize("name", FAST)
def test_model_and_record_equal_jax(name, jax_records):
    """The model inventory of the case's body and the record's ``comms`` of
    the same solve equal the JAX package's, and the counted program
    reconciles with the record."""
    rec, _info = pt_comms.case_probe_solve(CPU, _port_case(name))
    jrec = jax_records[name]
    model = {k: rec.comms[k] for k in ("setup", "per_iteration", "unit") if k in rec.comms}
    want = {k: jrec.comms[k] for k in ("setup", "per_iteration", "unit") if k in jrec.comms}
    assert model == want
    assert rec.comms == jrec.comms
    assert pt_comms.reconcile(rec.comms_counted, rec.comms) == []


@pytest.mark.parametrize("name", [c["name"] for c in pt_comms.lowering_cases() if not c["fast"]])
def test_counted_reconciles_full_matrix(name):
    """Every case of the full matrix: the counted program agrees with the
    record's model accounting, ops and bytes per kind."""
    rec, _info = pt_comms.case_probe_solve(CPU, _port_case(name))
    assert rec.comms["observed"]["collective_permute"]["ops"] > 0
    assert pt_comms.reconcile(rec.comms_counted, rec.comms) == []


@pytest.mark.parametrize("body", ["fused", "standard", "strict", "abft", "block"])
def test_counted_reconciles_jacobi_bodies(body):
    """Jacobi PCG: the fused and standard bodies (the precond sweep's one
    2-lane fold), the strict one (E3's dots beside the sweep's fold), the
    defended one and the block one; the counted program reconciles and the
    info says which body ran."""
    A, b, x0 = pt_comms.probe_system(CPU, "f64")
    minv = jacobi_preconditioner(A)
    kw = {"fused": body == "fused", "strict": body == "strict"}
    if body == "abft":
        kw = {"fused": False, "sdc": SDCConfig(abft=True)}
    if body == "block":
        _, info = tgpu.gpu_block_cg(A, [b, b], X0=[x0, x0], tol=1e-9, maxiter=50, minv=minv, fused=False)
    else:
        _, info = tgpu.gpu_cg(A, b, x0=x0, tol=1e-9, maxiter=50, minv=minv, **kw)
    rec = info.record
    assert info["cg_body"] == ("fused" if body == "fused" else "standard")
    assert rec.comms["setup"]["all_gather"]["ops"] == 2  # rs0 and rz0: the precond body ran
    assert pt_comms.reconcile(rec.comms_counted, rec.comms) == []


def test_counted_side_is_the_body_that_ran():
    """The pipelined body right after the fused one on the same system, tol
    and maxiter (as the card's observability phase runs them): each record
    carries the counted program of its own solve function, the one the
    driver ran, and each reconciles."""
    A, b, x0 = pt_comms.probe_system(CPU, "f64")
    _, fused = tgpu.gpu_cg(A, b, x0=x0, tol=1e-9, maxiter=50, fused=True)
    _, pipe = tgpu.gpu_cg(A, b, x0=x0, tol=1e-9, maxiter=50, pipelined=True)
    assert (fused["cg_body"], pipe["cg_body"]) == ("fused", "pipelined")
    cache = tgpu.device_matrix(A, CPU, True)._fn_cache
    # `_krylov_fn_for`'s keys: method, tol, maxiter, precond, pipelined, fused, plain, K, s, overlap, sdc, ring
    fns = {"fused": cache[("cg", 1e-9, 50, False, False, True, False, None, 0, False, None, 0)],
           "pipelined": cache[("cg", 1e-9, 50, False, True, False, False, None, 0, False, None, 0)]}
    for info in (fused, pipe):
        assert info.record.comms_counted is fns[info["cg_body"]].comms_counted
        assert pt_comms.reconcile(info.record.comms_counted, info.record.comms) == []


def test_model_counts_trips_of_a_defended_solve():
    """A defended solve counts its trips (the audit trips too), not its
    committed iterations, as the JAX package's record does."""
    A, b, x0 = pt_comms.probe_system(CPU, "f64")
    _, info = tgpu.gpu_cg(A, b, x0=x0, tol=1e-9, maxiter=50, fused=False, box=False,
                          sdc=SDCConfig(abft=True, audit_every=2))
    rec = info.record
    trips = info["sdc"]["trips"]
    assert trips > info["iterations"]
    per = rec.comms["per_iteration"]["collective_permute"]["ops"]
    assert rec.comms["iterations"] == trips
    assert rec.comms["observed"]["collective_permute"]["ops"] == per * (trips + 1)


def _rows(matrix):
    return [{k: v for k, v in e.items() if k != "fabric"} for e in matrix["edges"]]


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_static_matrix_equals_jax(box, monkeypatch):
    """Row for row the JAX package's static matrix on the same plan family,
    every field but the fabric label (``card`` here, the mesh's ``ici``
    there); both reconcile with their own inventory."""
    if not box:
        monkeypatch.setenv("PA_TPU_BOX", "0")
    jA, _jb, _jx = jtpu._matrix_probe_system(pa.tpu, "f64") if box else _jax_probe_generic()
    jdA = jtpu.device_matrix(jA, pa.tpu)
    jm = ja_cm.static_matrix(jdA.col_plan, np.float64, K=2, backend=pa.tpu)
    A, _b, _x0 = pt_comms.probe_system(CPU, "f64")
    dA = tgpu.device_matrix(A, CPU, box)
    m = pt_cm.static_matrix(dA.col_plan, np.float64, K=2)
    assert m["plan"] == jm["plan"] == ("box" if box else "generic")
    assert _rows(m) == _rows(jm)
    for k in ("P", "K", "dtype", "rounds", "round_tiers", "static", "comms_matrix_schema_version"):
        assert m[k] == jm[k], k
    assert {e["fabric"] for e in m["edges"]} == {"card"}
    assert pt_cm.reconcile_matrix(m, dA) == [] and ja_cm.reconcile_matrix(jm, jdA) == []


def _jax_probe_generic():
    """The JAX probe system staged fresh under ``PA_TPU_BOX=0`` (the cached
    one keeps the staging of the box environment)."""
    from partitionedarrays_jl_tpu.models import assemble_poisson

    def driver(parts):
        A, b, _xe, x0 = assemble_poisson(parts, (6, 6, 6), dtype=np.float64)
        return A, b, x0

    return pa.prun(driver, pa.tpu, (2, 2, 2))


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_measured_matrix(box):
    """Every round (direction) timed, every edge's share of it, the rounds'
    sum and the whole exchange recorded, the static check empty, and the
    fabric fit present for the measured fabric."""
    A, _b, _x0 = pt_comms.probe_system(CPU, "f64")
    m = pt_cm.measure_comms_matrix(A, CPU, box=box, k1=2, k2=6, reps=3)
    assert m["attribution"] == ("measured-direction" if box else "measured-round")
    assert len(m["round_s"]) == m["rounds"] > 0 and all(t > 0 for t in m["round_s"])
    assert all(e["measured_s"] > 0 for e in m["edges"])
    assert m["exchange_s"] > 0 and m["full_exchange_s"] > 0
    assert m["static_check"] == []
    assert set(m["fabric_model"]) == {"card"}
    text = pt_cm.render_comms_matrix(m)
    assert f"plan={'box' if box else 'generic'}" in text and "static reconciliation vs comms inventory: OK" in text


def test_counting_is_scoped():
    """The tally counts inside its block only, on its own thread; nested
    tallies both see an inner count."""
    with pt_comms.counting() as outer:
        pt_comms.count("all_gather", 1, 8)
        with pt_comms.counting() as inner:
            pt_comms.count("collective_permute", 2, 16)
    pt_comms.count("all_gather", 1, 8)
    assert outer["all_gather"] == {"ops": 1, "bytes": 8}
    assert outer["collective_permute"] == inner["collective_permute"] == {"ops": 2, "bytes": 16}
    assert inner["all_gather"] == {"ops": 0, "bytes": 0}
    with pt_comms.counting() as a:  # an inner tally equal to the outer one leaves it counting
        with pt_comms.counting():
            pass
        pt_comms.count("all_gather", 1, 4)
    assert a["all_gather"] == {"ops": 1, "bytes": 4}
    with pytest.raises(ValueError):
        pt_comms.counted_profile(outer, outer, 2)
