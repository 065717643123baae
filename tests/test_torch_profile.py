"""The port's phase profile (`telemetry/profile.py`) and span mount
(`telemetry/tracing.mount_phase_spans`) against the JAX package's, on the
CPU (``GPUBackend(device="cpu")``: the split-timer, since a CPU trace
holds no device time).

* The constants (phases, bands, schema), the case names and the
  lowering descriptor are the JAX package's.
* `capture_phase_profile` on the lowering cases' probe system (6^3 Poisson
  on (2, 2, 2) parts) lies in its band and reconciles (`reconcile_phases`
  against a fresh model), on the box and the generic plan, the s-step and
  block bodies; a tampered profile fails reconciliation.
* `phase_trace_events` has the JAX package's event shape on the same
  profile (all but the process name), and the JAX package renders the
  port's profile as the port does.
* ``prof=False``: `capture_phase_profile` returns None, and a solve run
  beside it is torch.equal to one without it, with the same counted
  launches.
* `mount_phase_spans` gives the JAX package's spans on the same input, but
  for the span ids.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

from partitionedarrays_jl_tpu.telemetry import profile as ja_prof
from partitionedarrays_jl_tpu.telemetry import tracing as ja_tracing
from partitionedarrays_jl_tpu_torch import telemetry as pt_tel
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.telemetry import comms as pt_comms
from partitionedarrays_jl_tpu_torch.telemetry import profile as pt_prof
from partitionedarrays_jl_tpu_torch.telemetry import tracing as pt_tracing

tgpu = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
CPU = tgpu.GPUBackend(device="cpu")


def _probe():
    return pt_comms.probe_system(CPU, "f64")


def test_constants_and_names_equal_jax():
    assert pt_prof.PHASES == ja_prof.PHASES
    assert pt_prof.PHASE_BOUNDARY == ja_prof.PHASE_BOUNDARY
    assert pt_prof.PHASE_HALO_SPLIT == ja_prof.PHASE_HALO_SPLIT
    assert pt_prof.PHASE_SUM_BAND == ja_prof.PHASE_SUM_BAND
    assert pt_prof.PHASE_SUM_BAND_WIDE == ja_prof.PHASE_SUM_BAND_WIDE
    assert pt_prof.PHASE_SCHEMA_VERSION == ja_prof.PHASE_SCHEMA_VERSION
    for fused in (True, False):
        for k in (None, 1, 4):
            for abft in (True, False):
                for overlap in (True, False):
                    assert pt_prof.phase_case_name(fused, k, abft, overlap=overlap) == \
                        ja_prof.phase_case_name(fused, k, abft, overlap=overlap)
    assert pt_prof.phase_case_name(False, sstep=2) == ja_prof.phase_case_name(False, sstep=2) == "sstep2"
    for case in pt_comms.lowering_cases():
        assert pt_prof.phase_case_of(case["name"]) == ja_prof.phase_case_of(case["name"])


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_lowering_descriptor(box):
    A, _b, _x0 = _probe()
    assert pt_prof.lowering_descriptor(tgpu.device_matrix(A, CPU, box)) == {
        "a_oo": "dia-coded", "plan": "box" if box else "generic"}


@pytest.mark.parametrize("kw", [
    dict(fused=True), dict(fused=False, box=False), dict(sstep=2), dict(fused=True, rhs_batch=4),
    dict(fused=False, overlap=True),
], ids=["fused", "standard_nobox", "sstep2", "block_k4_fused", "overlap"])
def test_capture_in_band_and_reconciles(kw):
    """In band, reconciled against a fresh model of the profile's own
    keywords, every phase timed, keyed by the JAX package's case name."""
    A, _b, _x0 = _probe()
    prof = None
    for _ in range(3):  # a loaded host can push one capture out of band on timer jitter
        with pt_tel.configure(prof_trace=False):
            prof = pt_prof.capture_phase_profile(A, CPU, reps=3, **kw)
        if prof["in_band"]:
            break
    dA = tgpu.device_matrix(A, CPU, kw.get("box", True))
    assert prof["method"] == "split-timer"
    assert pt_prof.reconcile_phases(prof, dA=dA) == []
    want = ja_prof.phase_case_name(kw.get("fused", False), kw.get("rhs_batch"), sstep=kw.get("sstep", 0),
                                   overlap=kw.get("overlap", False))
    assert prof["case"] == want
    assert prof["lowering"]["plan"] == ("box" if kw.get("box", True) else "generic")
    assert all(v["s_per_it"] >= 0 for v in prof["phases"].values()) and prof["measured_s_per_it"] > 0
    assert prof.get("unit", 1) == kw.get("sstep", 1)
    assert (pt_prof.PHASE_BOUNDARY in prof["phases"]) == bool(kw.get("overlap"))
    # the JAX package reads and renders the port's profile as the port does
    assert ja_prof.render_phase_profile(prof) == pt_prof.render_phase_profile(prof)
    assert ja_prof.reconcile_phases(prof) == pt_prof.reconcile_phases(prof) == []


def test_reconcile_catches_tampering():
    A, _b, _x0 = _probe()
    prof = pt_prof.capture_phase_profile(A, CPU, reps=3, k1=2, k2=10)
    bad = dict(prof, phases={k: dict(v) for k, v in prof["phases"].items()})
    bad["phases"]["halo_exchange"]["comms"] = {k: {"ops": 0, "bytes": 0} for k in pt_comms.COMM_KINDS}
    assert any("collective_permute.ops" in m for m in pt_prof.reconcile_phases(bad))
    far = dict(prof, ratio_attributed_over_measured=100.0)
    assert any("outside the pinned band" in m for m in pt_prof.reconcile_phases(far))
    assert pt_prof.reconcile_phases(dict(prof, phase_schema_version=1)) != []


def test_trace_events_have_jax_shape():
    A, _b, _x0 = _probe()
    prof = pt_prof.capture_phase_profile(A, CPU, reps=3, k1=2, k2=10)
    mine, theirs = pt_prof.phase_trace_events(prof, iterations=2), ja_prof.phase_trace_events(prof, iterations=2)
    assert len(mine) == len(theirs) == 1 + 2 * len(pt_prof.PHASES)
    assert mine[0]["ph"] == theirs[0]["ph"] == "M" and "phase profile (fused)" in mine[0]["args"]["name"]
    assert mine[1:] == theirs[1:]


@contextlib.contextmanager
def _counting(monkeypatch):
    """Counting wrappers over K1, K2 and the sweep (the CPU runs their
    plain versions); `dia.LAUNCHES` reset after."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    for mod, name in ((dia, "dia_coded_spmv"), (dia, "dia_coded_spmv_pfold"), (sw, "cg_sweep")):
        f = getattr(mod, name)

        def wrapped(*a, _f=f, _k=name, **k):
            dia.LAUNCHES[_k] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    try:
        yield
    finally:
        dia.reset_launches()


def test_prof_off_launches_nothing_and_changes_no_bit(monkeypatch):
    """``prof=False``: the capture returns None and launches nothing; a
    solve beside a capture (on) and beside the switched-off one is the same
    bits with the same launches."""
    A, b, x0 = _probe()
    runs = {}
    with _counting(monkeypatch):
        for prof_on in (True, False):
            with pt_tel.configure(prof=prof_on, prof_trace=False):
                dia.reset_launches()
                p = pt_prof.capture_phase_profile(A, CPU, reps=3, k1=2, k2=10)
                assert (p is None) != prof_on
                if not prof_on:
                    assert sum(dia.LAUNCHES.values()) == 0
                dia.reset_launches()
                x, info = tgpu.gpu_cg(A, b, x0=x0, tol=1e-9, maxiter=50)
                runs[prof_on] = (np.concatenate([np.asarray(v) for v in x.values.part_values()]),
                                 dict(dia.LAUNCHES), info["iterations"])
    assert torch.equal(torch.from_numpy(runs[True][0]), torch.from_numpy(runs[False][0]))
    assert runs[True][1] == runs[False][1] and runs[True][2] == runs[False][2]
    assert runs[True][1]["dia_coded_spmv_pfold"] > 0


def _spans():
    return [
        {"trace_id": "t1", "span_id": "s1", "parent_id": None, "kind": "rpc.request", "name": "r", "t0_wall": 1.0,
         "dur_s": 0.5, "status": "ok"},
        {"trace_id": "t1", "span_id": "s2", "parent_id": "s1", "kind": "slab.solve", "name": "r", "t0_wall": 1.1,
         "dur_s": 0.3, "status": "ok"},
        {"trace_id": "t2", "span_id": "s3", "parent_id": None, "kind": "slab.solve", "name": "q", "t0_wall": 2.0,
         "dur_s": None, "status": "interrupted"},
        {"trace_id": "t3", "span_id": "s4", "parent_id": None, "kind": "slab.solve", "name": "z", "t0_wall": 3.0,
         "dur_s": 0.2, "status": "ok"},
    ]


@pytest.mark.parametrize("container", [False, True])
def test_mount_phase_spans_equals_jax(container):
    """The same spans and profile: the JAX package's added spans but for
    their ids, each under a finished slab.solve, splitting its wall time
    in the profile's shares; a container mounts its standard profile."""
    A, _b, _x0 = _probe()
    prof = pt_prof.capture_phase_profile(A, CPU, reps=3, k1=2, k2=10, fused=False)
    src = {"phase_schema_version": 2, "profiles": {"fused": dict(prof, case="fused"), "standard": prof}} \
        if container else prof
    mine, theirs = pt_tracing.mount_phase_spans(_spans(), src), ja_tracing.mount_phase_spans(_spans(), src)
    assert len(mine) == len(theirs) == 2 * len(pt_prof.PHASES)

    def strip(s):
        return {k: v for k, v in s.items() if k != "span_id"}

    assert [strip(s) for s in mine] == [strip(s) for s in theirs]
    assert len({s["span_id"] for s in mine}) == len(mine)
    assert {s["parent_id"] for s in mine} == {"s2", "s4"}
    assert all(s["attrs"]["source"] == "standard" for s in mine)
    assert pt_tracing.mount_phase_spans(_spans(), {"phases": {}}) == []
