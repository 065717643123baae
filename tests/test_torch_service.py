"""The port's solve service (`partitionedarrays_jl_tpu_torch.service`)
against the JAX package's (`partitionedarrays_jl_tpu.service`).

One script runs through both packages' `SolveService` with an injected
fake clock, on ``pa.sequential`` <-> ``pt.sequential`` (the 8x8 Poisson
system on (2, 2) parts, tests/test_service.py's fixture) and, for the
device arms, on ``pa.tpu`` <-> ``GPUBackend(device="cpu")``. It covers
admission backpressure; coalescing and ragged leftovers; a transient wire
fault ejected and healed by a solo retry; a persistent fault failing
typed; a deadline expiring at a chunk boundary; a chunked solve keeping
the request's original target; a top-up at a chunk boundary; drain and
non-drain shutdown with a checkpoint; the worker thread. Compared exactly
between the packages: the stats dicts, each request's state, iterations
and error type name, the sequence of event kinds on each request's record,
and the registry's counters. The device arms also hold tests/test_service.py:586's
containment pin: under strict bits, at K = 4 on the 4-part fixture, every
co-batched request is bitwise its solo solve, in both packages.

The device pair differs in one place by design: the JAX package's device
driver looks up its staging twice a solo solve (tpu.py:5847 inside
tpu_cg's own lookup), the port once, so ``compile_cache`` events and the
``lowering_cache`` counters are compared as misses only.
"""
import types

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import service as ja_service
from partitionedarrays_jl_tpu import telemetry as ja_tel
from partitionedarrays_jl_tpu.models import solvers as ja_solvers
from partitionedarrays_jl_tpu.parallel import checkpoint as ja_ck
from partitionedarrays_jl_tpu.parallel import faults as ja_faults
from partitionedarrays_jl_tpu.parallel import health as ja_health
from partitionedarrays_jl_tpu_torch import service as pt_service
from partitionedarrays_jl_tpu_torch import telemetry as pt_tel
from partitionedarrays_jl_tpu_torch.models import solvers as pt_solvers
from partitionedarrays_jl_tpu_torch.parallel import checkpoint as pt_ck
from partitionedarrays_jl_tpu_torch.parallel import faults as pt_faults
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.utils import health as pt_health

from test_torch_abft import LID_TO_GID, _fixture_system

CPU = GPUBackend(device="cpu")


def _reset_jax():
    ja_tel.registry().reset()
    ja_tel.clear_history()
    ja_tel.reset_model()
    ja_tel.reset_store()
    ja_tel.tracing.clear_spans()


JAX = types.SimpleNamespace(
    name="jax", m=pa, tel=ja_tel, svc=ja_service, inject=ja_faults.inject_faults,
    load_state=ja_ck.load_solver_state, ranges=ja_solvers._solver_state_ranges,
    NonFiniteError=ja_health.NonFiniteError, SolveDeadlineError=ja_health.SolveDeadlineError,
    reset=_reset_jax,
)
PORT = types.SimpleNamespace(
    name="port", m=pt, tel=pt_tel, svc=pt_service, inject=pt_faults.inject_faults,
    load_state=pt_ck.load_solver_state, ranges=pt_solvers._solver_state_ranges,
    NonFiniteError=pt_health.NonFiniteError, SolveDeadlineError=pt_health.SolveDeadlineError,
    reset=pt_tel.reset_state,
)


class FakeClock:
    """Deterministic service clock: every reading advances by ``dt``."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _kinds(rec, device=False):
    kinds = [e.kind for e in rec.events]
    return [k for k in kinds if k != "compile_cache"] if device else kinds


def _req(h, device=False):
    """One request's outcome: tag, state, iterations, error type, event kinds."""
    err = type(h.error).__name__ if h.error is not None else None
    return (h.tag, h.state, int(h.iterations), err, tuple(_kinds(h.record, device)))


def _scale(P, v, s):
    out = v.copy()

    def f(iset, vals):
        np.asarray(vals)[...] *= s

    P.m.map_parts(f, out.rows.partition, out.values)
    return out


def _poison(P, v, part=0):
    out = v.copy()

    def f(i, vals):
        if int(i.part) == part:
            np.asarray(vals)[0] = np.nan

    P.m.map_parts(f, out.rows.partition, out.values)
    return out


def host_script(P, tmp):
    """The service script on the host backend; returns its outcome."""
    P.reset()
    out = {}

    def driver(parts):
        A, b, _, x0 = P.m.assemble_poisson(parts, (8, 8))
        svc_of = P.svc.SolveService
        # admission backpressure, then capacity freed by a drain
        svc = svc_of(A, queue_depth=2)
        hs = [svc.submit(b, x0=x0, tag=t) for t in ("a", "b")]
        with pytest.raises(P.svc.AdmissionRejected) as ei:
            svc.submit(b, x0=x0, tag="c")
        d = ei.value.diagnostics
        out["rejected"] = (d["reason"], d["queued"], d["depth"])
        svc.drain()
        hs.append(svc.submit(b, x0=x0, tag="c2"))
        svc.drain()
        out["admission"] = (dict(svc.stats), [_req(h) for h in hs])
        # coalescing: four of five tol=1e-9 requests, the ragged leftover,
        # the incompatible one; traced requests open span trees
        svc = svc_of(A, kmax=4, queue_depth=16)
        roots = [P.tel.start_span("rpc.request", name=f"t{i}") for i in range(5)]
        hs = [svc.submit(b, x0=x0, tol=1e-9, tag=f"t{i}", trace=r.ctx) for i, r in enumerate(roots)]
        hs.append(svc.submit(b, x0=x0, tol=1e-6, tag="loose"))
        first = svc.step()
        svc.drain()
        for r in roots:
            r.end()
        out["coalesce"] = (first, dict(svc.stats), [_req(h) for h in hs])
        spans = P.tel.tracing.recorded_spans()
        trees = []
        for h in hs[:5]:
            tid = h.trace.trace_id
            mine = [s for s in spans if s["trace_id"] == tid]
            roots, orphans = P.tel.tracing.span_tree(mine)
            trees.append((sorted(s["kind"] for s in mine), len(roots), len(orphans),
                          len(P.tel.tracing.verify_trace(spans, tid))))
        out["spans"] = trees
        # a one-shot wire fault poisons the first column: ejected, healed solo
        svc = svc_of(A, kmax=2, retries=1, retry_backoff=0.0)
        with P.inject("nan@part=1,call=5", seed=1):
            hs = [svc.submit(b, x0=x0, tol=1e-9, tag=t) for t in ("poisoned", "clean")]
            svc.drain()
        out["transient"] = (dict(svc.stats), [_req(h) for h in hs],
                            hs[0].result()[1].get("resolved_via"))
        # a persistent fault (NaN in b) fails typed after its retry
        svc = svc_of(A, kmax=3, retries=1, retry_backoff=0.0)
        hs = [svc.submit(_poison(P, b), x0=x0, tol=1e-9, tag="bad"), svc.submit(b, x0=x0, tol=1e-9, tag="good")]
        svc.drain()
        out["persistent"] = (dict(svc.stats), [_req(h) for h in hs], hs[0].record.status)
        # a deadline expires typed at a chunk boundary; the free request completes
        svc = svc_of(A, kmax=2, chunk=4, clock=FakeClock(1.0))
        hs = [svc.submit(b, x0=x0, tol=1e-9, deadline=0.5, tag="tight"), svc.submit(b, x0=x0, tol=1e-9, tag="free")]
        svc.drain()
        with pytest.raises(P.SolveDeadlineError) as ei:
            hs[0].result()
        out["deadline"] = (dict(svc.stats), [_req(h) for h in hs], ei.value.diagnostics["iteration"])
        # a chunked solve keeps the request's original target
        big, bx0 = _scale(P, b, 1e4), _scale(P, x0, 1e4)
        svc = svc_of(A, kmax=2, chunk=10, clock=FakeClock(0.001))
        h = svc.submit(big, x0=bx0, tol=1e-9, deadline=1e6, tag="big")
        svc.drain()
        _, inf = h.result()
        out["chunked"] = (dict(svc.stats), _req(h), bool(inf["converged"]))
        out["chunked_res"] = float(inf["residuals"][-1])
        # a late compatible request tops the running chunked slab up
        svc = svc_of(A, kmax=4, chunk=3, clock=FakeClock(0.001))
        early = svc.submit(b, x0=x0, tol=1e-9, deadline=99.0, tag="early")
        late = {}
        base = svc.clock

        def clock():
            if "h" not in late:
                late["h"] = None  # the submit below reads the clock too
                late["h"] = svc.submit(b, x0=x0, tol=1e-9, deadline=99.0, tag="late")
            return base()

        svc.clock = clock
        svc.drain()
        out["top_up"] = (dict(svc.stats), [_req(early), _req(late["h"])])
        # drain, then refuse
        svc = svc_of(A)
        h = svc.submit(b, x0=x0, tol=1e-9, tag="drained")
        stats = svc.shutdown(drain=True)
        with pytest.raises(P.svc.AdmissionRejected) as ei:
            svc.submit(b, x0=x0)
        out["drain"] = (stats, _req(h), ei.value.diagnostics["reason"])
        # non-drain shutdown: the in-flight request checkpoints at its
        # first chunk boundary, the queued one is suspended
        svc = svc_of(A, kmax=1, chunk=4, checkpoint_dir=str(tmp / P.name), clock=FakeClock(0.001))
        r1 = svc.submit(b, x0=x0, tol=1e-12, deadline=99.0, tag="infl")
        r2 = svc.submit(b, x0=x0, tol=1e-9, tag="queued")
        svc._stop = True  # what shutdown(drain=False) sets mid-run
        stepped = svc.step()
        st = P.load_state(r1.checkpoint_path, P.ranges(A, b))
        stats = svc.shutdown(drain=False)
        out["stop"] = (stepped, stats, [_req(r1), _req(r2)], int(st["meta"]["it"]),
                       P.m.gather_pvector(st["x"]))
        # the worker thread drains what was queued before it started
        svc = svc_of(A, kmax=2)
        hs = [svc.submit(b, x0=x0, tol=1e-9, tag=f"w{i}") for i in range(3)]
        svc.start()
        stats = svc.shutdown(drain=True)
        out["worker"] = (stats, [_req(h) for h in hs])
        return True

    assert P.m.prun(driver, P.m.sequential, (2, 2))
    out["counters"] = {k: v for k, v in P.tel.registry().snapshot()["counters"].items()}
    return out


def test_service_script_host_matches_jax(tmp_path):
    """The whole host script, both packages: equal stats, request
    outcomes, event-kind sequences, span trees and registry counters."""
    want = host_script(JAX, tmp_path)
    got = host_script(PORT, tmp_path)
    ck_want, ck_got = want.pop("stop"), got.pop("stop")
    # the final residual of the chunked request lies 1e-10 under its start:
    # the host loops' rounding differences show at 1e-8 of it
    np.testing.assert_allclose(got.pop("chunked_res"), want.pop("chunked_res"), rtol=1e-6)
    # the host loops' products round apart between the packages
    np.testing.assert_allclose(ck_got[4], ck_want[4], rtol=1e-12, atol=0)
    assert ck_got[:4] == ck_want[:4]
    for key in want:
        assert got[key] == want[key], key
    # the script's own contracts, on the port
    assert got["rejected"] == ("queue_full", 2, 2)
    assert got["coalesce"][0] == 4 and got["coalesce"][1]["slabs"] == 3
    # one span tree a request, no orphan: rpc.request -> slab.solve -> chunk
    assert all(t == (["chunk", "rpc.request", "slab.solve"], 1, 0, 0) for t in got["spans"])
    assert got["transient"][2] == "solo_retry" and got["transient"][0]["retried_solo"] == 1
    assert got["persistent"][1][0][1:4:2] == ("failed", "NonFiniteError") and got["persistent"][2] == "raised"
    assert got["deadline"][1][0][3] == "SolveDeadlineError" and got["deadline"][2] > 0
    assert got["chunked"][2] and got["top_up"][0]["slabs"] == 1
    assert ck_got[2][0][1] == "checkpointed" and ck_got[2][1][1] == "suspended" and ck_got[3] == 4
    assert got["worker"][0]["completed"] == 3


def test_worker_thread_with_live_submits():
    """The live-server mode: requests submitted from the main thread while
    the port's worker runs; a draining shutdown joins the worker (time
    bounded) and every request ends converged, bitwise its solo solve."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (8, 8))
        solo, _ = pt.cg(A, b, x0=x0, tol=1e-9)
        svc = pt_service.SolveService(A, kmax=2).start()
        hs = [svc.submit(b, x0=x0, tol=1e-9, tag=f"live{i}") for i in range(5)]
        stats = svc.shutdown(drain=True)
        assert svc._worker is not None and not svc._worker.is_alive()
        return stats, [(h.state, pt.gather_pvector(h.result()[0])) for h in hs], pt.gather_pvector(solo)

    stats, res, solo = pt.prun(driver, pt.sequential, (2, 2))
    assert stats["completed"] == 5 and stats["failed"] == 0
    for state, x in res:
        assert state == "done"
        np.testing.assert_array_equal(x, solo)


def test_worker_failure_surfaces_at_shutdown():
    """A slab that raises in the worker thread ends the worker; shutdown
    re-raises it instead of running the queue on the calling thread."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (8, 8))
        svc = pt_service.SolveService(A, kmax=2)

        def boom(slab):
            raise RuntimeError("capture failed")

        svc._run_slab = boom
        h = svc.submit(b, x0=x0, tol=1e-9)
        svc.start()
        with pytest.raises(RuntimeError, match="worker thread failed") as ei:
            svc.shutdown(drain=True)
        assert isinstance(ei.value.__cause__, RuntimeError) and "capture failed" in str(ei.value.__cause__)
        assert not svc._worker.is_alive() and svc.stats["completed"] == 0
        return True

    assert pt.prun(driver, pt.sequential, (2, 2))


def test_registry_counters_thread_hammer():
    """Two threads bump one counter and observe one histogram through the
    registry's one lock (with a short switch interval): exact totals."""
    import sys
    import threading

    pt_tel.reset_state()
    reg = pt_tel.registry()
    n = 4000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                reg.counter("service.admitted").inc()
                reg.histogram("service.solve_s").observe(1e-3)
                pt_tel.bump("events.request_done")

        ts = [threading.Thread(target=work) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert reg.counter_value("service.admitted") == 4 * n
    assert reg.histogram("service.solve_s").count == 4 * n
    assert pt_tel.counter("events.request_done") == 4 * n


# ---------------------------------------------------------------------------
# the device arms: pa.tpu against GPUBackend(device="cpu")
# ---------------------------------------------------------------------------


def _variants(P, parts):
    if P is JAX:
        from test_fused_cg import _fixture_spd_system

        A, b = _fixture_spd_system(parts)
    else:
        A, b = _fixture_system(parts)
    return A, [_scale(P, b, f) for f in (1.0, 0.5, 2.0)], _poison(P, b, part=1)


def device_script(P, backend):
    """Containment at K = 4 under strict bits (one poisoned request, three
    clean ones, one slab), then a ragged slab of 3 at kmax 2 (a slab of 2
    and a leftover of 1); returns outcomes, solutions and the solo solves."""
    P.reset()

    def driver(parts):
        A, clean, bad = _variants(P, parts)
        if P is JAX:
            from partitionedarrays_jl_tpu.parallel.tpu import tpu_cg as solo

            svc = P.svc.SolveService(A, kmax=4, retries=0)
        else:
            svc = P.svc.SolveService(A, kmax=4, retries=0, strict=True)
            solo = lambda A_, b_, **kw: pt.cg(A_, b_, strict=True, **kw)  # noqa: E731
        hs = [svc.submit(bk, tol=1e-10, maxiter=200, tag=f"v{k}") for k, bk in enumerate(clean)]
        hbad = svc.submit(bad, tol=1e-10, maxiter=200, tag="poisoned")
        svc.drain()
        res = {"stats": dict(svc.stats), "reqs": [_req(h, True) for h in hs + [hbad]]}
        res["x"] = [P.m.gather_pvector(h.result()[0]) for h in hs]
        res["hist"] = [np.asarray(h.result()[1]["residuals"]) for h in hs]
        sol = [solo(A, bk, tol=1e-10, maxiter=200) for bk in clean]
        res["solo_x"] = [P.m.gather_pvector(x) for x, _ in sol]
        res["solo_hist"] = [np.asarray(i["residuals"]) for _, i in sol]
        res["solo_it"] = [int(i["iterations"]) for _, i in sol]
        # a ragged leftover
        svc2 = P.svc.SolveService(A, kmax=2, **({} if P is JAX else {"strict": True}))
        hs2 = [svc2.submit(bk, tol=1e-10, maxiter=200, tag=f"r{k}") for k, bk in enumerate(clean)]
        svc2.drain()
        res["ragged"] = (dict(svc2.stats), [_req(h, True) for h in hs2])
        res["ragged_x"] = [P.m.gather_pvector(h.result()[0]) for h in hs2]
        # chunked: a deadline expiring at the first chunk boundary beside a
        # free request that runs on in chunks of 4 against its first target
        svc3 = P.svc.SolveService(A, kmax=2, chunk=4, clock=FakeClock(1.0),
                                  **({} if P is JAX else {"strict": True}))
        hs3 = [svc3.submit(clean[0], tol=1e-10, maxiter=200, deadline=0.5, tag="tight"),
               svc3.submit(clean[1], tol=1e-10, maxiter=200, tag="free")]
        svc3.drain()
        res["chunked"] = (dict(svc3.stats), [_req(h, True) for h in hs3])
        return res

    if P is JAX:
        import jax

        out = P.m.prun(driver, pa.TPUBackend(devices=jax.devices()[:4]), 4)
    else:
        out = P.m.prun(driver, backend, 4)
    snap = P.tel.registry().snapshot()["counters"]
    out["counters"] = {k: v for k, v in snap.items()
                       if not k.startswith(("lowering_cache.", "events.compile_cache", "program_cache.hit"))}
    return out


def test_service_device_containment_matches_jax(monkeypatch):
    """tests/test_service.py:586's pin in both packages (strict bits, K =
    4, the 4-part fixture): the poisoned request fails typed with its
    event trail, the three co-batched requests end bitwise equal to their
    solo solves (x and residual history); and the two packages' stats,
    request outcomes, event kinds and counters agree, the ragged arm too
    (its solutions to 1e-12), and a chunked slab with a deadline."""
    monkeypatch.setenv("PA_TPU_STRICT_BITS", "1")
    want = device_script(JAX, None)
    monkeypatch.delenv("PA_TPU_STRICT_BITS")
    got = device_script(PORT, CPU)
    for res in (want, got):
        assert res["stats"]["slabs"] == 1 and res["stats"]["ejected"] == 1 and res["stats"]["failed"] == 1
        tag, state, _, err, kinds = res["reqs"][3]
        assert (state, err) == ("failed", "NonFiniteError")
        assert {"column_verdict", "column_ejected", "request_failed"} <= set(kinds)
        for k in range(3):
            n = res["solo_it"][k] + 1
            np.testing.assert_array_equal(res["x"][k], res["solo_x"][k])
            np.testing.assert_array_equal(res["hist"][k][:n], res["solo_hist"][k][:n])
    assert got["stats"] == want["stats"] and got["reqs"] == want["reqs"]
    assert got["ragged"] == want["ragged"]
    assert got["chunked"] == want["chunked"]
    assert [r[1] for r in got["chunked"][1]] == ["failed", "done"] and got["chunked"][1][0][3] == "SolveDeadlineError"
    assert got["counters"] == want["counters"]
    for a, c in zip(got["ragged_x"], want["ragged_x"]):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-12)
    assert len(LID_TO_GID) == 4
