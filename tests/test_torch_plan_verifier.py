"""The port's exchange-plan verifier (`analysis/plan_verifier.py`) against the
JAX package's.

* The committed negative corpus (`tests/fixtures/paplan/`, the host-plan
  fixtures; the two-level one waits for the two-level plans): each fixture,
  loaded into the port's `Exchanger`, is caught by exactly the checks the
  JAX verifier reports, and `clean.json` is sound.
* The port's own device plans on a 6x6 Poisson system over (2, 2) parts
  (`GPUBackend(device="cpu")`): the generic plan and the box plan are sound
  as built, as the JAX package's plans of the same system are, and seeded
  mutations are caught: a receive-slot collision, a self-send round, a
  routing (``src_of``) that disagrees with its round, a box segment
  collision and a box move written twice.
* The construction-time gate (`plan_verifier.configure(enabled=True)`, the
  JAX package's ``PA_PLAN_VERIFY=1``): a clean build passes, a corrupted
  host plan is refused typed at the device-plan build site with the checks
  the JAX package names, narrated by ``plan_defect`` and ``health_error``
  events, before any solve record opens (the chaos row
  `test_matrix_corrupted_plan_caught_statically` of the JAX package).
* Fingerprints: a plan rebuilt from the same partition is identical; the
  layout-independent fingerprint of a host plan equals the JAX package's
  on the same system and survives a checkpoint round trip.
"""
import glob
import os

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import telemetry as jtel
from partitionedarrays_jl_tpu.analysis import plan_verifier as jpv
from partitionedarrays_jl_tpu.parallel.health import PlanSoundnessError as JaxPlanSoundnessError
from partitionedarrays_jl_tpu.parallel.tpu import DeviceExchangePlan as JaxDeviceExchangePlan
from partitionedarrays_jl_tpu.parallel.tpu import DeviceLayout as JaxDeviceLayout
from partitionedarrays_jl_tpu_torch import native, telemetry
from partitionedarrays_jl_tpu_torch.analysis import plan_verifier as pv
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceExchangePlan, DeviceLayout, GPUBackend, device_exchange_plan, device_layout,
)
from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan, analyze_box_structure
from partitionedarrays_jl_tpu_torch.utils.health import PlanSoundnessError

CPU = GPUBackend(device="cpu")
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "paplan")
DEFECT_FIXTURES = [
    ("overlapping_ghost_slot.json", "ghost-race"),
    ("dropped_slot.json", "coverage"),
    ("asymmetric_counts.json", "symmetry"),
    ("self_send_round.json", "rounds"),
    ("dead_slot.json", "dead-slot"),
]


def test_host_corpus_is_covered():
    """Every host-plan fixture of the corpus is run here; the one left is the
    two-level plan's."""
    names = {os.path.basename(p) for p in glob.glob(os.path.join(FIXDIR, "*.json"))}
    assert names - {n for n, _ in DEFECT_FIXTURES} - {"clean.json"} == {"twolevel_rep_slot.json"}
    assert {c for _, c in DEFECT_FIXTURES} == set(pv.PLAN_CHECKS) == set(jpv.PLAN_CHECKS)


def test_clean_fixture_verifies_sound():
    ex, parts, ref, defect = pv.load_exchanger_fixture(os.path.join(FIXDIR, "clean.json"))
    assert defect is None
    assert isinstance(ex, pt.Exchanger)
    assert pv.verify_exchanger(ex, parts, referenced=ref) == []


@pytest.mark.parametrize("name,check", DEFECT_FIXTURES)
def test_defect_fixture_caught_by_the_jax_checks(name, check):
    """The port catches each fixture with the check the fixture names, and
    reports the same check classes on the same parts, in the same order, as
    the JAX verifier."""
    path = os.path.join(FIXDIR, name)
    ex, parts, ref, defect = pv.load_exchanger_fixture(path)
    assert defect == check
    mine = pv.verify_exchanger(ex, parts, referenced=ref)
    jex, jparts, jref, _ = jpv.load_exchanger_fixture(path)
    theirs = jpv.verify_exchanger(jex, jparts, referenced=jref)
    assert check in {d.check for d in mine}
    assert [(d.check, d.part) for d in mine] == [(d.check, d.part) for d in theirs]
    hit = next(d for d in mine if d.check == check)
    assert hit.part is not None and hit.message


def test_check_plan_raises_typed_with_diagnostics():
    ex, parts, ref, _ = pv.load_exchanger_fixture(os.path.join(FIXDIR, "overlapping_ghost_slot.json"))
    before = telemetry.counter("events.plan_defect")
    with pytest.raises(PlanSoundnessError) as ei:
        pv.check_plan(ex, parts=parts, referenced=ref, context="corpus")
    diag = ei.value.diagnostics
    assert "ghost-race" in diag["checks"]
    assert diag["defects"] and diag["defects"][0]["check"]
    assert diag["context"] == "corpus"
    assert telemetry.counter("events.plan_defect") == before + len(diag["checks"])


def test_fixture_format_matches_the_jax_package(monkeypatch, fast=False):
    """`exchanger_fixture` of the port's plan is the JAX package's fixture of
    its plan on the same system, both on one assembly route (the COO route's
    first-touch ghost numbering, or the COO-free route's sorted face slabs),
    and loads back sound."""
    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "1" if fast else "0")
    monkeypatch.setattr(native, "STENCIL_FAST", fast)

    def port(parts):
        A = pt.assemble_poisson(parts, (6, 6))[0]
        return pv.exchanger_fixture(A.cols.exchanger, A.cols.partition, pv.referenced_ghosts(A))

    def jax(parts):
        A = pa.assemble_poisson(parts, (6, 6))[0]
        return jpv.exchanger_fixture(A.cols.exchanger, A.cols.partition, jpv.referenced_ghosts(A))

    mine, theirs = pt.prun(port, pt.sequential, (2, 2)), pa.prun(jax, pa.sequential, (2, 2))
    assert mine == theirs
    ex, parts, ref, _ = pv.load_exchanger_fixture(mine)
    assert pv.verify_exchanger(ex, parts, referenced=ref) == []


def test_fixture_format_matches_the_jax_package_fast(monkeypatch):
    """The same on the COO-free route of both packages."""
    test_fixture_format_matches_the_jax_package(monkeypatch, fast=True)


def _corrupt_receive_collision(plan, trash):
    """A receive slot of one round redirected onto another: a ghost-race."""
    rcv = plan.rcv_idx.clone()
    r, q = next((r, q) for r in range(plan.R) for q in range(rcv.shape[1]) if int((rcv[r, q] != trash).sum()) >= 2)
    slots = np.nonzero((rcv[r, q] != trash).numpy())[0]
    rcv[r, q, slots[1]] = rcv[r, q, slots[0]]
    plan.rcv_idx = rcv


def test_device_plans_sound_and_mutations_caught():
    def driver(parts):
        A = pt.assemble_poisson(parts, (6, 6))[0]
        rows = A.cols
        ref = pv.referenced_ghosts(A)
        assert all(m.all() for m in ref)
        layout = DeviceLayout(rows)
        assert pv.verify_device_plan(DeviceExchangePlan(rows.exchanger, layout, CPU.device), referenced=ref) == []

        bad = DeviceExchangePlan(rows.exchanger, layout, CPU.device)
        _corrupt_receive_collision(bad, layout.trash)
        assert "ghost-race" in {d.check for d in pv.verify_device_plan(bad, referenced=ref)}

        bad2 = DeviceExchangePlan(rows.exchanger, layout, CPU.device)
        bad2.perms = (tuple(bad2.perms[0]) + ((0, 0),),) + tuple(bad2.perms[1:])
        assert "rounds" in {d.check for d in pv.verify_device_plan(bad2, referenced=ref)}

        # the routing the exchange executes must follow the round
        bad3 = DeviceExchangePlan(rows.exchanger, layout, CPU.device)
        src, dst = bad3.perms[0][0]
        src_of = bad3.src_of.clone()
        src_of[0, dst] = dst
        bad3.src_of = src_of
        hits = [d for d in pv.verify_device_plan(bad3, referenced=ref) if d.check == "rounds"]
        assert hits and hits[0].part == dst and hits[0].details["expected"] == src

        info = analyze_box_structure(rows)
        assert info is not None
        blayout = DeviceLayout(rows, box_info=info)
        assert pv.verify_box_plan(BoxExchangePlan(blayout, info, CPU.device), referenced=ref) == []

        info2 = analyze_box_structure(rows)
        p = next(p for p in range(info2.P) if len(np.asarray(info2.ghost_rel_slots[p])) >= 2)
        rel = np.asarray(info2.ghost_rel_slots[p]).copy()
        rel[1] = rel[0]
        info2.ghost_rel_slots = list(info2.ghost_rel_slots[:p]) + [rel] + list(info2.ghost_rel_slots[p + 1:])
        assert "ghost-race" in {d.check for d in pv.verify_box_plan(BoxExchangePlan(blayout, info2, CPU.device),
                                                                     referenced=ref)}

        # a flat move written twice: the executed program, not the analysis
        bad4 = BoxExchangePlan(blayout, info, CPU.device)
        dst4 = bad4.dst.clone()
        dst4[1] = dst4[0]
        bad4.dst = dst4
        assert {"ghost-race", "rounds"} <= {d.check for d in pv.verify_box_plan(bad4, referenced=ref)}
        return True

    assert pt.prun(driver, CPU, (2, 2))


def test_jax_device_plans_of_the_same_system_are_sound():
    """The reference's verdict on the same system's plans: sound."""
    def driver(parts):
        A = pa.assemble_poisson(parts, (6, 6))[0]
        plan = JaxDeviceExchangePlan(A.cols.exchanger, JaxDeviceLayout(A.cols, padded=False))
        return jpv.verify_device_plan(plan, referenced=jpv.referenced_ghosts(A))

    assert pa.prun(driver, pa.sequential, (2, 2)) == []


def test_construction_gate_passes_clean_builds():
    with pv.configure(enabled=True):
        def driver(parts):
            rows = pt.cartesian_partition(parts, (6, 6), pt.with_ghost)
            assert rows.exchanger is not None  # from_partition runs the gate
            plan = device_exchange_plan(rows, CPU)
            assert plan is device_exchange_plan(rows, CPU)  # cached, not run again
            assert isinstance(plan, BoxExchangePlan)
            device_exchange_plan(rows, CPU, box=False)
            return True

        assert pt.prun(driver, CPU, (2, 2))
    assert not pv.plan_verify_enabled()


def test_matrix_corrupted_plan_caught_statically(monkeypatch):
    """The chaos row: a corrupted host plan (an overlapping ghost slot) is
    refused at the generic device plan's build site with the typed error,
    the JAX package's checks and part, one ``plan_defect`` event per
    failing check and one ``health_error``, and no solve record opened."""
    def corrupt(rows):
        t = next(t for t in rows.exchanger.lids_rcv.part_values() if len(t.data) >= 2)
        t.data[1] = t.data[0]

    def port(parts):
        A = pt.assemble_poisson(parts, (8, 8))[0]
        rows = A.cols
        corrupt(rows)
        before = telemetry.counter("events.plan_defect")
        health_before = telemetry.counter("events.health_error")
        last = telemetry.last_record()
        with pv.configure(enabled=True), pytest.raises(PlanSoundnessError) as ei:
            device_exchange_plan(rows, CPU, box=False)
        d = ei.value.diagnostics
        assert telemetry.counter("events.plan_defect") == before + len(d["checks"])
        assert telemetry.counter("events.health_error") == health_before + 1
        assert telemetry.last_record() is last
        return d["checks"], d["defects"][0]["check"], d["defects"][0]["part"]

    monkeypatch.setenv("PA_PLAN_VERIFY", "1")
    monkeypatch.setenv("PA_TPU_BOX", "0")

    def jax(parts):
        from partitionedarrays_jl_tpu.parallel.tpu import device_exchange_plan as jax_plan

        A = pa.assemble_poisson(parts, (8, 8))[0]
        corrupt(A.cols)
        last = jtel.last_record()
        with pytest.raises(JaxPlanSoundnessError) as ei:
            jax_plan(A.cols)
        assert jtel.last_record() is last
        d = ei.value.diagnostics
        return d["checks"], d["defects"][0]["check"], d["defects"][0]["part"]

    mine, theirs = pt.prun(port, CPU, (2, 2)), pa.prun(jax, pa.sequential, (2, 2))
    assert "ghost-race" in mine[0] and mine[1] == "ghost-race" and mine[2] is not None
    assert mine == theirs


def test_rebuilt_plan_fingerprint_identical_and_sound():
    def driver(parts):
        A = pt.assemble_poisson(parts, (6, 6))[0]
        rows = A.cols
        fp0 = pv.plan_fingerprint(rows.exchanger)
        dev0 = pv.plan_fingerprint(DeviceExchangePlan(rows.exchanger, device_layout(rows, False), CPU.device))
        box0 = pv.plan_fingerprint(device_exchange_plan(rows, CPU))
        rows.invalidate_exchanger()
        ex1 = rows.exchanger  # rebuilt from the same partition
        assert pv.plans_equal(ex1, ex1) and pv.plan_fingerprint(ex1) == fp0
        assert pv.plan_fingerprint(DeviceExchangePlan(ex1, device_layout(rows, False), CPU.device)) == dev0
        assert pv.plan_fingerprint(device_exchange_plan(rows, CPU)) == box0
        assert pv.verify_exchanger(ex1, rows.partition, referenced=pv.referenced_ghosts(A)) == []
        return True

    assert pt.prun(driver, CPU, (2, 2))


def test_canonical_fingerprint_equals_the_jax_package():
    """The same global columns cross the same edges in both packages' host
    plans of one system."""
    def port(parts):
        A = pt.assemble_poisson(parts, (7, 6, 5))[0]
        return pv.canonical_exchange_fingerprint(A.cols.exchanger, A.cols.partition)

    def jax(parts):
        A = pa.assemble_poisson(parts, (7, 6, 5))[0]
        return jpv.canonical_exchange_fingerprint(A.cols.exchanger, A.cols.partition)

    assert pt.prun(port, pt.sequential, (2, 2, 1)) == pa.prun(jax, pa.sequential, (2, 2, 1))


def test_checkpoint_restored_partition_plans_sound_and_canonical_equal(tmp_path):
    """An operator saved and restored into a fresh partition (ghost lids
    renumbered column-sorted): the rebuilt plans are sound and exchange the
    same global columns over the same edges."""
    p = str(tmp_path / "A.npz")
    state = {}

    def save(parts):
        A = pt.assemble_poisson(parts, (6, 6))[0]
        state["canonical"] = pv.canonical_exchange_fingerprint(A.cols.exchanger, A.cols.partition)
        pt.save_psparse(p, A)
        return True

    def load(parts):
        A2 = pt.load_psparse(p, pt.cartesian_partition(parts, (6, 6), pt.no_ghost))
        ref = pv.referenced_ghosts(A2)
        assert pv.verify_exchanger(A2.cols.exchanger, A2.cols.partition, referenced=ref) == []
        plan = DeviceExchangePlan(A2.cols.exchanger, device_layout(A2.cols, False), CPU.device)
        assert pv.verify_device_plan(plan, referenced=ref) == []
        assert pv.canonical_exchange_fingerprint(A2.cols.exchanger, A2.cols.partition) == state["canonical"]
        return True

    assert pt.prun(save, pt.sequential, (2, 2))
    assert pt.prun(load, CPU, (2, 2))
