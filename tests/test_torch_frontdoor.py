"""The port's front door (`partitionedarrays_jl_tpu_torch.frontdoor`)
against the JAX package's (`partitionedarrays_jl_tpu.frontdoor`): tenancy
and LRU paging, EDF, SLO-class shedding, the HTTP surface, and the gate's
cost on the solve path. The journal and recovery are held in
``test_torch_frontdoor_journal.py``, the fleet in
``test_torch_frontdoor_fleet.py``.

Each scenario is written once against a package namespace and run on
``pa.sequential`` (the JAX package), ``pt.sequential`` and
``GPUBackend(device="cpu")`` (the port's device path, the kernels' plain
versions): admission, eviction and page-in counts and events, the
residency table, the EDF completion order, the shed decisions and their
diagnostics, iterations and ``converged`` are compared exactly; x within
1e-12 relative between the packages, and bit for bit inside one package
where the JAX package pins it (a paged-in solve against the one before the
eviction, an HTTP solve against the same request in-process). Each test
mirrors one of ``tests/test_pagate.py``; the pamon view and the
``tools/pagate.py`` smoke wait for the port's tools. The JAX package's
StableHLO pin has a torch counterpart here: a gate-enabled slab reuses the
bare service's cached solve function and returns its result
``torch.equal``.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import frontdoor as ja_fd
from partitionedarrays_jl_tpu import service as ja_service
from partitionedarrays_jl_tpu import telemetry as ja_tel
from partitionedarrays_jl_tpu_torch import frontdoor as pt_fd
from partitionedarrays_jl_tpu_torch import service as pt_service
from partitionedarrays_jl_tpu_torch import telemetry as pt_tel
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")

JAX = types.SimpleNamespace(name="jax", m=pa, fd=ja_fd, tel=ja_tel, svc=ja_service, be=pa.sequential)
PORT = types.SimpleNamespace(name="port", m=pt, fd=pt_fd, tel=pt_tel, svc=pt_service, be=pt.sequential)
PORT_DEV = types.SimpleNamespace(name="port-dev", m=pt, fd=pt_fd, tel=pt_tel, svc=pt_service, be=CPU)
ARMS = [JAX, PORT, PORT_DEV]

EVENT_KINDS = (
    "tenant_registered", "tenant_paged_in", "tenant_evicted", "tenant_budget_rejected", "tenant_requeued",
    "load_shedded", "idempotent_replay", "gate_recovered", "request_recovered", "journal_truncated",
    "journal_pruned", "request_adopted", "fleet_adopted", "gate_shutdown",
)
COUNTERS = (
    ("gate.evictions", None), ("gate.page_ins", None), ("gate.budget_rejected", None),
    ("gate.shed", {"slo_class": "besteffort"}), ("gate.idempotent_hits", None),
    ("gate.slo.requests", {"slo_class": "interactive"}), ("gate.slo.hits", {"slo_class": "interactive"}),
    ("gate.slo.requests", {"slo_class": "besteffort"}), ("gate.slo.hits", {"slo_class": "besteffort"}),
    ("service.rejected", {"reason": "queue_full"}), ("service.admitted", None),
    ("journal.truncated", None), ("journal.pruned", None),
)


def poisson(P, grid=(8, 8), dtype=np.float64, parts=(2, 2)):
    """The JAX package's gate fixture: the Poisson system on (2, 2) parts."""
    return P.m.prun(lambda p: P.m.assemble_poisson(p, grid, dtype=dtype), P.be, parts)


class Meter:
    """Deltas of the gate's registry counters and event counts in one arm."""

    def __init__(self, P):
        self.P = P
        self.start = self.read()

    def read(self):
        reg = self.P.tel.registry()
        out = {f"{n}{sorted((l or {}).items())}": reg.counter(n, labels=l).value for n, l in COUNTERS}
        out.update({f"events.{k}": self.P.tel.counter(f"events.{k}") for k in EVENT_KINDS})
        return out

    def delta(self):
        now = self.read()
        return {k: now[k] - self.start[k] for k in now if now[k] != self.start[k]}


def same(a, b, where="outcome"):
    """Equal outcomes; float arrays within 1e-12 relative (the two packages'
    solves round alike to that), everything else exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), (where, a, b)
        for i, (u, v) in enumerate(zip(a, b)):
            same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        scale = max(1.0, float(np.max(np.abs(a))) if a.size else 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * scale, err_msg=where)
    else:
        assert a == b, (where, a, b)


def parity(scenario, *args, arms=ARMS, **kwargs):
    """Run ``scenario(P, ...)`` in every arm and hold each port arm's
    outcome to the JAX package's; returns the outcomes by arm name."""
    outs = {P.name: scenario(P, *args, **kwargs) for P in arms}
    for P in arms[1:]:
        same(outs[arms[0].name], outs[P.name], P.name)
    return outs


def gathered(P, x):
    return np.asarray(x) if isinstance(x, np.ndarray) else P.m.gather_pvector(x)


# ---------------------------------------------------------------------------
# tenancy: budget admission and LRU paging
# ---------------------------------------------------------------------------


def _budget_lru(P):
    A1, b1, _, x01 = poisson(P, (8, 8))
    A2, _, _, _ = poisson(P, (10, 10))
    fp1, fp2 = P.fd.operator_footprint_bytes(A1, 4), P.fd.operator_footprint_bytes(A2, 4)
    m = Meter(P)
    gate = P.fd.Gate(mem_budget_bytes=max(fp1, fp2) + 8)
    gate.register("t1", A1, kmax=4)
    gate.register("t2", A2, kmax=4)  # must evict t1
    res1 = gate.residency()
    resident1 = gate.registry.resident_bytes()
    h = gate.submit("t1", b1, x0=x01, tol=1e-9, slo_class="interactive")
    gate.drain()
    x, info = h.result()
    return {"fp": (fp1, fp2), "res1": res1, "resident1": resident1, "res2": gate.residency(),
            "counts": m.delta(), "info": (info["converged"], info["iterations"]), "x": gathered(P, x)}


def test_budget_admission_and_lru_eviction():
    """Two tenants under a one-resident budget: registering the second
    evicts the first (LRU), routing a request back pages it in again; the
    residency table, counters and events equal the JAX package's."""
    out = parity(_budget_lru)["port"]
    fp1, fp2 = out["fp"]
    assert fp1 > 0 and fp2 > fp1 and out["resident1"] == fp2
    res = {r["tenant"]: r for r in out["res2"]}
    assert res["t1"]["resident"] and not res["t2"]["resident"]
    assert out["counts"]["gate.evictions[]"] == 2 and out["counts"]["gate.page_ins[]"] == 3


def _too_big(P):
    A, _, _, _ = poisson(P)
    m = Meter(P)
    gate = P.fd.Gate(mem_budget_bytes=1000)
    with pytest.raises(P.fd.TenantBudgetError) as ei:
        gate.register("huge", A, footprint_bytes=2000)
    return {"diag": ei.value.diagnostics, "tenants": [r["tenant"] for r in gate.residency()],
            "counts": m.delta(), "type": type(ei.value).__name__}


def test_operator_too_big_for_budget_is_typed():
    out = parity(_too_big)["port"]
    assert out["diag"] == {"tenant": "huge", "footprint_bytes": 2000, "budget_bytes": 1000}
    assert out["tenants"] == []


@pytest.mark.parametrize("kmax", [1, 4, 8])
def test_footprint_is_the_jax_count(kmax):
    """The structural footprint is the JAX package's count (same admission
    decisions), for both dtypes and any slab width."""
    for grid, parts in (((8, 8), (2, 2)), ((6, 5, 4), (2, 1, 2))):
        for dtype in (np.float64, np.float32):
            want = ja_fd.operator_footprint_bytes(poisson(JAX, grid, dtype, parts)[0], kmax, dtype)
            for P in (PORT, PORT_DEV):
                got = pt_fd.operator_footprint_bytes(poisson(P, grid, dtype, parts)[0], kmax, dtype)
                assert got == want


# ---------------------------------------------------------------------------
# EDF
# ---------------------------------------------------------------------------


def _edf(P):
    A, b, _, x0 = poisson(P)
    gate = P.fd.Gate()
    gate.register("t", A, kmax=1)
    rng = np.random.default_rng(7)
    deadlines = [100.0, 400.0, 200.0, 600.0, 300.0, 500.0]
    handles = {}
    for i in rng.permutation(len(deadlines)):
        handles[deadlines[i]] = gate.submit("t", b, x0=x0, tol=1e-9, deadline=deadlines[i],
                                            slo_class="interactive", tag=f"edf-{deadlines[i]:.0f}")
    gate.drain()
    finished = sorted(handles.items(), key=lambda kv: kv[1].request.finished_at)
    hf = gate.submit("t", b, x0=x0, tol=1e-9, tag="edf-free")
    hd = gate.submit("t", b, x0=x0, tol=1e-9, deadline=900.0, slo_class="interactive", tag="edf-late")
    gate.drain()
    return {"order": [d for d, _ in finished], "free_last": hd.request.finished_at < hf.request.finished_at,
            "iters": [h.result()[1]["iterations"] for _, h in finished],
            "x": [gathered(P, h.result()[0]) for _, h in finished]}


def test_edf_same_tenant_completion_order_never_inverts():
    """At slab width 1 the completion order is the deadline order whatever
    the submission order, deadline-free requests last: the JAX package's
    order, iterations and x."""
    out = parity(_edf)["port"]
    assert out["order"] == sorted(out["order"]) and out["free_last"]


# ---------------------------------------------------------------------------
# SLO-class shedding
# ---------------------------------------------------------------------------


def test_shed_policy_function():
    for classes in (("interactive", "batch", "besteffort"), ("only",), ("a", "b")):
        for depth in (0, 1, 3, 4, 5, 400):
            for mark in (1, 4, 32):
                assert pt_fd.shed_classes(depth, classes, mark) == ja_fd.shed_classes(depth, classes, mark)
    assert pt_fd.shed_classes(4, ("interactive", "batch", "besteffort"), 4) == ("besteffort",)
    assert pt_fd.shed_classes(10, ("only",), 1) == ()


def _shed(P):
    A, b, _, x0 = poisson(P)
    gate = P.fd.Gate(shed_watermark=2)
    gate.register("t", A, kmax=4)
    m = Meter(P)
    backlog = [gate.submit("t", b, x0=x0, tol=1e-9, slo_class="besteffort") for _ in range(2)]
    with pytest.raises(P.fd.LoadShedded) as ei:
        gate.submit("t", b, x0=x0, tol=1e-9, slo_class="besteffort")
    e = ei.value
    # the batch class is not shed at the watermark, only the lowest
    hb = gate.submit("t", b, x0=x0, tol=1e-9, slo_class="batch")
    hi = gate.submit("t", b, x0=x0, tol=1e-9, deadline=600.0, slo_class="interactive")
    gate.drain()
    return {"admission_rejected": isinstance(e, P.svc.AdmissionRejected), "retry_positive": e.retry_after_s > 0.0,
            "diag": e.diagnostics, "states": [h.state for h in backlog + [hb, hi]],
            "iters": [h.result()[1]["iterations"] for h in backlog + [hb, hi]], "counts": m.delta()}


def test_shed_keeps_interactive_and_is_distinct_from_queue_full():
    """Past the watermark besteffort sheds typed (`LoadShedded`, a positive
    ``retry_after_s``, ``gate.shed``) while interactive keeps being
    admitted and reaches 100% attainment; shedding is not an
    `AdmissionRejected` and moves no ``service.rejected`` counter."""
    out = parity(_shed)["port"]
    assert not out["admission_rejected"] and out["retry_positive"]
    assert out["diag"] == {"slo_class": "besteffort", "tag": "", "depth": 2, "watermark": 2, "shed": ["besteffort"]}
    c = out["counts"]
    assert c["gate.shed[('slo_class', 'besteffort')]"] == 1
    assert "service.rejected[('reason', 'queue_full')]" not in c
    assert c["gate.slo.hits[('slo_class', 'interactive')]"] == c["gate.slo.requests[('slo_class', 'interactive')]"] == 1


def _unknown_class_and_tenant(P):
    A, b, _, x0 = poisson(P)
    gate = P.fd.Gate(classes=("gold", "lead"))
    gate.register("t", A, kmax=2)
    out = {}
    with pytest.raises(AssertionError) as ei:
        gate.submit("t", b, slo_class="interactive")
    out["class"] = "unknown SLO class" in str(ei.value)
    with pytest.raises(P.fd.UnknownTenantError):
        gate.submit("ghost", b, slo_class="gold")
    h = gate.submit("t", b, x0=x0, tol=1e-9)  # default class: the lowest
    gate.drain()
    out["default_class"] = h.slo_class
    out["iters"] = h.result()[1]["iterations"]
    return out


def test_classes_argument_and_unknown_tenant():
    out = parity(_unknown_class_and_tenant)["port"]
    assert out["class"] and out["default_class"] == "lead"


# ---------------------------------------------------------------------------
# eviction: page-out / page-in reproduces the solve bit for bit
# ---------------------------------------------------------------------------


def _evict_run(P, backend, fixture):
    A, b = P.m.prun(fixture, backend, 4)
    gate = P.fd.Gate()
    gate.register("t", A, kmax=2)
    h = gate.submit("t", b, tol=1e-10, maxiter=200)
    gate.drain()
    return A, b, gate, h.result()


def test_eviction_pageout_pagein_bitwise_and_fingerprint():
    """Solve, page the tenant out (the device staging, its solve functions
    and graphs dropped), route a request back in: the page-in stages again
    (one more ``lowering_cache.miss``, one more solve function), the
    operator fingerprint is unchanged, and the solve is ``torch.equal`` to
    the one before the eviction with the same iterations; it agrees with
    the JAX package's gate on ``pa.tpu`` (tests/test_pagate.py's fixture)
    within 1e-12."""
    import importlib

    import jax
    from test_fused_cg import _fixture_spd_system
    from test_torch_abft import _fixture_system

    gpu_mod = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
    A, b, gate, (x1, i1) = _evict_run(PORT, CPU, lambda parts: _fixture_system(parts)[:2])
    assert i1["converged"] and A._device, "the solve must have staged the operator"
    fp0 = pt_tel.operator_fingerprint(A)
    dA0 = next(iter(A._device.values()))
    misses0, fns0 = pt_tel.counter("lowering_cache.miss"), gpu_mod.STATS["solve_fns"]
    gate.evict("t")
    assert not A._device, "eviction must drop the device staging"
    h2 = gate.submit("t", b, tol=1e-10, maxiter=200)  # pages the tenant back in
    gate.drain()
    x2, i2 = h2.result()
    assert pt_tel.counter("lowering_cache.miss") == misses0 + 1
    assert gpu_mod.STATS["solve_fns"] == fns0 + 1
    assert next(iter(A._device.values())) is not dA0 and pt_tel.operator_fingerprint(A) == fp0
    assert i2["converged"] and i2["iterations"] == i1["iterations"]
    assert torch.equal(torch.from_numpy(pt.gather_pvector(x1)), torch.from_numpy(pt.gather_pvector(x2)))
    _, _, _, (xj, ij) = _evict_run(JAX, pa.TPUBackend(devices=jax.devices()[:4]), _fixture_spd_system)
    assert ij["iterations"] == i1["iterations"]
    same(pa.gather_pvector(xj), pt.gather_pvector(x1))


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------


def _http(P):
    A, b, _, x0 = poisson(P)
    gate = P.fd.Gate(start_workers=True)
    gate.register("p8", A, kmax=4)
    srv = P.fd.serve_gate(gate, port=0)
    out = {}
    try:
        bg, x0g = P.m.gather_pvector(b), P.m.gather_pvector(x0)
        res = P.fd.http_solve(srv.url, "p8", bg, x0=x0g, tol=1e-9, slo_class="interactive", tag="http-req")
        out["http"] = (res["state"], res["info"], res["http_status"], res["replayed"])
        h = gate.submit("p8", b, x0=x0, tol=1e-9, tag="inproc-req")
        gate.drain()
        x_in, info_in = h.result()
        x_http = np.asarray(res["x"])
        assert np.array_equal(x_http.view(np.uint64), P.m.gather_pvector(x_in).view(np.uint64))
        out["iters"] = (res["info"]["iterations"], info_in["iterations"])
        out["x"] = x_http
        with urllib.request.urlopen(srv.url + "/healthz") as resp:
            health = json.loads(resp.read())
        assert isinstance(health.pop("uptime_s"), float)
        out["health"] = health
        with urllib.request.urlopen(srv.url + "/v1/tenants") as resp:
            out["tenants"] = json.loads(resp.read())
        with urllib.request.urlopen(srv.url + "/metrics") as resp:
            prom = resp.read().decode()
        out["prom"] = all(k in prom for k in ("pa_gate_page_ins", "pa_gate_slo_requests"))
        with urllib.request.urlopen(srv.url + "/metrics.json") as resp:
            out["metrics_json"] = isinstance(json.loads(resp.read()), dict)
        ghost = P.fd.http_solve(srv.url, "ghost", bg)
        out["ghost"] = (ghost["http_status"], ghost["error"])
        bad = P.fd.http_solve(srv.url, "p8", bg[:-1])
        out["bad"] = (bad["http_status"], bad["error"])
        try:
            urllib.request.urlopen(srv.url + "/v1/solve/r999999")
            out["unknown"] = None
        except urllib.error.HTTPError as e:
            out["unknown"] = (e.code, json.loads(e.read())["error"])
    finally:
        srv.stop()
    return out


def test_http_roundtrip_bitwise_and_endpoints():
    """Submit-poll-fetch over HTTP returns bit for bit the iterate of the
    same request in-process, in each package; the operational endpoints
    serve the gate's state; unknown tenants, malformed vectors and unknown
    requests are typed. The port's payloads equal the JAX package's."""
    out = parity(_http)["port"]
    assert out["http"][0] == "done" and out["http"][2] == 202
    assert out["health"]["ok"] and out["health"]["resident"] == ["p8"] and out["health"]["journal_epoch"] is None
    assert out["ghost"] == (404, "UnknownTenant") and out["bad"] == (400, "BadRequest")
    assert out["unknown"] == (404, "UnknownRequest") and out["prom"]


def test_http_f32_tenant_bitwise():
    """A float32 tenant over HTTP: the wire carries every float32 value
    exactly (the client names the dtype), so the HTTP solve is bit for bit
    the in-process one, in both packages; x agrees across them."""

    def run(P):
        A, b, _, x0 = poisson(P, (8, 8), np.float32)
        gate = P.fd.Gate(start_workers=True)
        gate.register("f32", A, kmax=2)
        srv = P.fd.serve_gate(gate, port=0)
        try:
            res = P.fd.http_solve(srv.url, "f32", P.m.gather_pvector(b), x0=P.m.gather_pvector(x0), tol=1e-5,
                                  dtype="float32")
            h = gate.submit("f32", b, x0=x0, tol=1e-5)
            gate.drain()
            x_in = P.m.gather_pvector(h.result()[0])
        finally:
            srv.stop()
        x_http = np.asarray(res["x"], dtype=np.float32)
        assert x_in.dtype == np.float32
        assert np.array_equal(x_http.view(np.uint32), x_in.view(np.uint32))
        return {"iters": res["info"]["iterations"], "x": x_http.astype(np.float64)}

    outs = {P.name: run(P) for P in ARMS}
    for k in ("port", "port-dev"):
        assert outs[k]["iters"] == outs["jax"]["iters"]
        np.testing.assert_allclose(outs[k]["x"], outs["jax"]["x"], rtol=1e-5, atol=1e-6)


def test_http_deadline_infeasible_is_422():
    """Spectrum admission at the door (the telemetry config's
    ``spec_admit``): once a traced solo solve warmed the operator's
    spectrum, an infeasible deadline is refused with `DeadlineInfeasible`
    before any iteration, 422 over HTTP, in-process typed."""
    A, b, _, x0 = poisson(PORT_DEV, (10, 10))
    with pt_tel.configure(spec_admit=True):
        pt.cg(A, b, x0=x0, tol=1e-9, trace_iters=64)  # measures the spectrum
        gate = pt_fd.Gate(start_workers=True)
        gate.register("t", A, kmax=2)
        warm = gate.submit("t", b, x0=x0, tol=1e-9)  # measures the throughput
        gate.drain()
        assert warm.result()[1]["converged"]
        admitted0 = pt_tel.registry().counter("service.admitted").value
        with pytest.raises(pt.DeadlineInfeasible):
            gate.submit("t", b, x0=x0, tol=1e-12, deadline=1e-9, slo_class="interactive")
        srv = pt_fd.serve_gate(gate, port=0)
        try:
            res = pt_fd.http_solve(srv.url, "t", pt.gather_pvector(b), tol=1e-12, deadline=1e-9)
        finally:
            srv.stop()
        assert res["http_status"] == 422 and res["error"] == "DeadlineInfeasible"
        assert pt_tel.registry().counter("service.admitted").value == admitted0
        assert gate.depth() == 0


# ---------------------------------------------------------------------------
# the gate adds nothing to the solve path
# ---------------------------------------------------------------------------


def test_gate_enabled_slab_reuses_the_bare_service_function(tmp_path):
    """The counterpart of the JAX package's StableHLO pin: with every front
    door switch set, a journaling gate's slab runs the SAME cached block
    solve function as the bare service's (one ``program_cache.hit``, no
    miss, no new solve function, no new capture) and returns its result
    ``torch.equal``."""
    import importlib

    gpu_mod = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop

    A, b, _, x0 = poisson(PORT_DEV)
    svc = pt_service.SolveService(A, kmax=2)
    h0 = svc.submit(b, x0=x0, tol=1e-9, deadline=600.0)
    svc.drain()
    x_bare = pt.gather_pvector(h0.result()[0])
    fns, caps = gpu_mod.STATS["solve_fns"], gpu_loop.STATS["captures"]
    hit, miss = pt_tel.counter("program_cache.hit"), pt_tel.counter("program_cache.miss")
    with pt_fd.configure(mem_budget=123456789, classes=("interactive", "besteffort"), shed_depth=5, port=0,
                         journal_dir=str(tmp_path / "j"), journal_fsync=True):
        gate = pt_fd.Gate(checkpoint_dir=str(tmp_path / "c"))
        assert gate.journal is not None and gate.watermark == 5 and gate.registry.budget == 123456789
        gate.register("seq", A, kmax=2)
        h = gate.submit("seq", b, x0=x0, tol=1e-9, deadline=600.0, slo_class="interactive",
                        idempotency_key="hlo")
        gate.drain()
    x_gate = pt.gather_pvector(h.result()[0])
    assert gpu_mod.STATS["solve_fns"] == fns and gpu_loop.STATS["captures"] == caps
    assert pt_tel.counter("program_cache.miss") == miss and pt_tel.counter("program_cache.hit") > hit
    assert torch.equal(torch.from_numpy(x_gate), torch.from_numpy(x_bare))
    kinds = {r["kind"] for r in pt_fd.read_journal(str(tmp_path / "j"))}
    assert {"admitted", "dispatched", "completed"} <= kinds


# ---------------------------------------------------------------------------
# the config object and the card's lock
# ---------------------------------------------------------------------------


def test_config_defaults_are_the_jax_defaults(monkeypatch):
    """`GateConfig`'s defaults are the JAX package's environment defaults,
    `configure` returns the previous config, which restores itself."""
    for k in ("PA_GATE_MEM_BUDGET", "PA_GATE_CLASSES", "PA_GATE_SHED_DEPTH", "PA_GATE_JOURNAL",
              "PA_GATE_JOURNAL_DIR", "PA_GATE_JOURNAL_FSYNC", "PA_GATE_JOURNAL_KEEP", "PA_GATE_PORT",
              "PA_FLEET_REPLICAS", "PA_FLEET_LEASE_S"):
        monkeypatch.delenv(k, raising=False)
    pairs = [("mem_budget", "mem_budget"), ("gate_classes", "gate_classes"), ("shed_depth", "shed_depth"),
             ("journal_enabled", "journal_enabled"), ("journal_env_dir", "journal_env_dir"),
             ("journal_fsync", "journal_fsync"), ("journal_keep", "journal_keep"), ("gate_port", "gate_port"),
             ("fleet_replicas", "fleet_replicas"), ("fleet_lease_s", "fleet_lease_s")]
    for j, p in pairs:
        assert getattr(pt_fd, p)() == getattr(ja_fd, j)(), p
    prev = pt_fd.configure(shed_depth=3, classes=("a", "b"), fleet_lease_s=0.01)
    with prev:
        assert pt_fd.shed_depth() == 3 and pt_fd.gate_classes() == ("a", "b") and pt_fd.fleet_lease_s() == 0.05
        monkeypatch.setenv("PA_GATE_SHED_DEPTH", "3")
        monkeypatch.setenv("PA_GATE_CLASSES", "a,b")
        assert pt_fd.shed_depth() == ja_fd.shed_depth() and pt_fd.gate_classes() == ja_fd.gate_classes()
    assert pt_fd.config() == pt_fd.GateConfig()
    with pytest.raises(ValueError):
        pt_fd.GateConfig(classes="interactive,batch")


def test_services_on_one_card_take_turns():
    """Two services whose operator lives on the same card run their slabs
    one at a time, each holding the card's `device_lock`, whatever threads
    drive them (the CPU stands in for the card: the services are told the
    device index the lock is keyed by). Their results equal the solo
    ones."""
    A1, b1, _, x01 = poisson(PORT_DEV)
    A2, b2, _, x02 = poisson(PORT_DEV, (10, 10))
    lock = pt_service.device_lock(0)
    assert pt_service.device_lock(0) is lock and pt_service.device_lock(1) is not lock
    spans, errors = [], []
    svcs = []
    for A in (A1, A2):
        svc = pt_service.SolveService(A, kmax=2)
        svc._cuda_index = 0
        inner = svc._block_solve

        def wrapped(*a, _inner=inner, **k):
            if not lock._is_owned():
                errors.append("slab ran without the card's lock")
            t0 = time.perf_counter()
            out = _inner(*a, **k)
            spans.append((t0, time.perf_counter()))
            return out

        svc._block_solve = wrapped
        svcs.append(svc)
    hs = [svcs[0].submit(b1, x0=x01, tol=1e-9, tag=f"a{i}") for i in range(3)]
    hs += [svcs[1].submit(b2, x0=x02, tol=1e-9, tag=f"b{i}") for i in range(3)]
    threads = [threading.Thread(target=s.drain) for s in svcs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    spans.sort()
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(spans, spans[1:])), "slabs overlapped"
    for h, (b, x0) in zip(hs, [(b1, x01)] * 3 + [(b2, x02)] * 3):
        A = A1 if h in hs[:3] else A2
        want = pt.gather_pvector(pt.cg(A, b, x0=x0, tol=1e-9)[0])
        np.testing.assert_allclose(pt.gather_pvector(h.result()[0]), want, rtol=1e-12, atol=1e-12)
