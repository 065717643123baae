"""The port's request journal and crash recovery
(`partitionedarrays_jl_tpu_torch.frontdoor.journal`, `Gate.recover`)
against the JAX package's, mirroring ``tests/test_padur.py``.

Each scenario runs on ``pa.sequential``, ``pt.sequential`` and
``GPUBackend(device="cpu")`` (`test_torch_frontdoor.parity`): journal
record kinds in order, recovery outcome summaries, handle states, the
typed error names, idempotency hits and the admitted count, iterations
exactly; x within 1e-12 between the packages, and bit for bit inside one
package where the JAX package pins it (a recovered result against the
served one). The journal is one format: each package's `read_journal`
reads a journal the other wrote, record for record, and a port gate
recovers a JAX gate's journal. The float32 wire and journal carry every
value exactly (subnormals, -0.0, the largest finite value). The
``tools/padur.py`` smoke and drills wait for the port's tools.
"""
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import frontdoor as ja_fd
from partitionedarrays_jl_tpu_torch import frontdoor as pt_fd

from test_torch_frontdoor import JAX, PORT, PORT_DEV, Meter, parity, poisson, same


def _kinds(jd):
    return [r["kind"] for r in pt_fd.read_journal(jd)]


# ---------------------------------------------------------------------------
# the journal itself
# ---------------------------------------------------------------------------


def _roundtrip(P, tmp):
    jd = str(tmp / P.name)
    a0 = P.tel.registry().counter("journal.appends").value
    r0 = P.tel.registry().counter("journal.rotations").value
    j = P.fd.RequestJournal(jd, fsync=True, segment_bytes=4096)
    for i in range(40):
        j.append("shed", tag=f"r{i}", slo_class="besteffort", depth=i)
    nseg = len(j.segments())
    appends = P.tel.registry().counter("journal.appends").value - a0
    rotations = P.tel.registry().counter("journal.rotations").value - r0
    j.close()
    j2 = P.fd.RequestJournal(jd, fsync=False)
    sheds = [r for r in j2.prior_records if r["kind"] == "shed"]
    seqs = [r["seq"] for r in j2.prior_records]
    rec = j2.append("shed", tag="post", slo_class="x", depth=0)
    j2.close()
    return {"nseg": nseg, "appends": appends, "rotations": rotations, "tags": [r["tag"] for r in sheds],
            "wall": all("wall" in r for r in sheds), "seqs": seqs, "epoch": j2.epoch, "post_seq": rec["seq"],
            "names": sorted(os.path.basename(s) for s in j2.segments())}


def test_journal_roundtrip_rotation_and_epochs(tmp_path):
    """Append, rotate, replay: every record comes back CRC-verified in
    order, seq stays monotonic across segments and epochs, each open starts
    a fresh epoch and segment; segment names and counts equal the JAX
    package's."""
    out = parity(_roundtrip, tmp_path, arms=[JAX, PORT])["port"]
    assert out["nseg"] >= 2 and out["appends"] == 41 and out["rotations"] >= 1
    assert out["tags"] == [f"r{i}" for i in range(40)] and out["wall"]
    assert out["seqs"] == sorted(set(out["seqs"])) and out["epoch"] == 2 and out["post_seq"] > max(out["seqs"])


def _torn(P, tmp):
    jd = str(tmp / P.name / "torn")
    j = P.fd.RequestJournal(jd, fsync=False)
    for i in range(3):
        j.append("shed", tag=f"t{i}", slo_class="x", depth=i)
    j.close()
    with open(sorted(j.segments())[-1], "ab") as f:
        f.write(b'{"kind":"completed","seq":99,"x":[0.1')  # a torn write
    m = Meter(P)
    j2 = P.fd.RequestJournal(jd, fsync=False)
    clean = [r["tag"] for r in j2.prior_records if r["kind"] == "shed"]
    j2.close()
    first = m.delta()
    m = Meter(P)
    P.fd.RequestJournal(jd, fsync=False).close()
    second = m.delta()
    jc = str(tmp / P.name / "corrupt")
    jx = P.fd.RequestJournal(jc, fsync=False)
    jx.append("shed", tag="aaaa", slo_class="x", depth=0)
    jx.append("shed", tag="bbbb", slo_class="x", depth=1)
    jx.close()
    seg = sorted(jx.segments())[0]
    data = bytearray(open(seg, "rb").read())
    data[data.find(b"aaaa")] = ord("z")
    open(seg, "wb").write(bytes(data))
    with pytest.raises(P.fd.JournalCorruptError):
        P.fd.read_journal(jc, strict=True)
    with pytest.raises(P.fd.JournalCorruptError):
        P.fd.RequestJournal(jc, fsync=False)
    lenient = [r["kind"] for r in P.fd.read_journal(jc)]
    return {"clean": clean, "first": first, "second": second, "lenient": lenient}


def test_torn_tail_truncates_mid_file_corruption_raises(tmp_path):
    """A torn LAST record truncates (counted, evented, clean prefix kept,
    durably: a third open sees a clean journal); a bad record followed by
    clean data is corruption and raises typed."""
    out = parity(_torn, tmp_path, arms=[JAX, PORT])["port"]
    assert out["clean"] == ["t0", "t1", "t2"]
    assert out["first"]["journal.truncated[]"] == 1 and out["first"]["events.journal_truncated"] == 1
    assert "journal.truncated[]" not in out["second"]


def test_each_package_reads_the_others_journal(tmp_path):
    """One format: a journal written by a JAX gate reads back through the
    port's `read_journal` record for record (and the other way round),
    CRCs included; the port's segment files parse as the JAX package's."""
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        jd = str(tmp_path / f"{writer.name}-gate")
        A, b, _, x0 = poisson(writer)
        g = writer.fd.Gate(journal_dir=jd)
        g.register("t", A, kmax=4, chunk=2)
        h = g.submit("t", b, x0=x0, tol=1e-9, idempotency_key="k1", tag="done")
        g.submit("t", b, x0=x0, tol=1e-9, maxiter=5000, deadline=1e-7, slo_class="interactive", tag="fail")
        g.drain()
        assert h.state == "done"
        g.shutdown()
        own = writer.fd.read_journal(jd, strict=True)
        other = reader.fd.read_journal(jd, strict=True)
        assert own == other and [r["kind"] for r in own][:2] == ["epoch", "admitted"]
    kinds = {P.name: [r["kind"] for r in P.fd.read_journal(str(tmp_path / f"{P.name}-gate"))] for P in (JAX, PORT)}
    assert kinds["jax"] == kinds["port"]


def test_port_gate_recovers_a_jax_journal(tmp_path):
    """A port gate recovers a journal a JAX gate wrote: the completed
    request serves the JAX gate's recorded x bit for bit, the failed one
    its typed name, and the queued one re-enters EDF and solves."""
    jd = str(tmp_path / "j")
    A, b, _, x0 = poisson(JAX)
    g1 = ja_fd.Gate(journal_dir=jd)
    g1.register("t", A, kmax=4, chunk=2)
    hd = g1.submit("t", b, x0=x0, tol=1e-9, tag="done-req")
    hf = g1.submit("t", b, x0=x0, tol=1e-9, maxiter=5000, deadline=1e-7, slo_class="interactive", tag="fail-req")
    g1.drain()
    xj = pa.gather_pvector(hd.result()[0])
    hq = g1.submit("t", b, x0=x0, tol=1e-9, tag="queued-req")
    for be in (pt.sequential, PORT_DEV.be):
        jd2 = str(tmp_path / f"copy-{be.__class__.__name__}")
        shutil.copytree(jd, jd2)
        Ap, bp, _, x0p = pt.prun(lambda p: pt.assemble_poisson(p, (8, 8)), be, (2, 2))
        g2 = pt_fd.Gate(journal_dir=jd2)
        g2.register("t", Ap, kmax=4)
        summary = g2.recover()
        assert (summary["completed"], summary["failed"], summary["requeued"]) == (1, 1, 1)
        xr, ir = g2.handle(hd.rid).result()
        assert ir["recovered"] and np.array_equal(xr.view(np.uint64), xj.view(np.uint64))
        with pytest.raises(pt_fd.RecoveredError) as ei:
            g2.handle(hf.rid).result()
        assert ei.value.error_type == "SolveDeadlineError"
        g2.drain()
        xq, iq = g2.handle(hq.rid).result()
        assert iq["converged"]
        same(pt.gather_pvector(pt.cg(Ap, bp, x0=x0p, tol=1e-9)[0]), pt.gather_pvector(xq))


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def _recover_ladder(P, tmp):
    A, b, _, x0 = poisson(P)
    x_solo = P.m.gather_pvector(P.m.cg(A, b, x0=x0, tol=1e-9)[0])
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd)
    g1.register("t", A, kmax=4, chunk=2)
    h_done = g1.submit("t", b, x0=x0, tol=1e-9, tag="done-req")
    h_fail = g1.submit("t", b, x0=x0, tol=1e-9, maxiter=5000, deadline=1e-7, slo_class="interactive",
                       tag="fail-req")
    g1.drain()
    states = (h_done.state, h_fail.state)
    x1 = P.m.gather_pvector(h_done.result()[0])
    h_q = g1.submit("t", b, x0=x0, tol=1e-9, tag="queued-req")
    queued = h_q.state
    # ---- crash: g1 is abandoned, nothing shuts it down ----
    m = Meter(P)
    g2 = P.fd.Gate(journal_dir=jd)
    g2.register("t", A, kmax=4)
    summary = g2.recover()
    xr, ir = g2.handle(h_done.rid).result()
    assert np.array_equal(np.asarray(xr).view(np.uint64), x1.view(np.uint64))
    with pytest.raises(P.fd.RecoveredError) as ei:
        g2.handle(h_fail.rid).result()
    with pytest.raises(Exception, match="already replayed"):
        g2.recover()
    g2.drain()
    xq, iq = g2.handle(h_q.rid).result()
    return {"states": states, "queued": queued, "summary": summary, "counts": m.delta(),
            "recovered_info": (ir["recovered"], ir["converged"], ir["iterations"]), "error": ei.value.error_type,
            "x1": x1, "xq": P.m.gather_pvector(xq), "x_solo": x_solo, "iq": iq["iterations"],
            "kinds": _kinds(jd)}


def test_recover_completed_failed_and_queued(tmp_path):
    """The recovery ladder over a simulated crash: a completed request
    serves its recorded result bit for bit, a failed one re-raises typed
    with the original class name, a queued one re-enters EDF and completes
    equal to its solo solve; recover() is one-shot. Summaries, counters,
    events and journal record kinds equal the JAX package's."""
    out = parity(_recover_ladder, tmp_path)["port-dev"]
    assert out["states"] == ("done", "failed") and out["queued"] == "gate-queued"
    s = out["summary"]
    assert (s["completed"], s["failed"], s["requeued"], s["expired"]) == (1, 1, 1, 0)
    assert out["error"] == "SolveDeadlineError" and out["recovered_info"][0]
    assert out["counts"]["events.gate_recovered"] == 1


def _resume_chunk(P, tmp):
    A, b, _, x0 = poisson(P, (12, 12))
    x_direct = P.m.gather_pvector(P.m.cg(A, b, x0=x0, tol=1e-9)[0])
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd, checkpoint_dir=str(tmp / P.name / "c"))
    g1.register("t", A, kmax=2, chunk=4)
    h = g1.submit("t", b, x0=x0, tol=1e-9, maxiter=400, deadline=3600.0, slo_class="interactive", tag="inflight")
    g1.pump(dispatch_only=True)
    svc = g1.service("t")
    svc._stop = True  # freeze after ONE chunk: a crash mid-solve
    svc.step()
    it_done = h.request.iterations
    kinds = _kinds(jd)
    # ---- crash ----
    g2 = P.fd.Gate(journal_dir=jd, checkpoint_dir=str(tmp / P.name / "c2"))
    g2.register("t", A, kmax=2, chunk=4)
    summary = g2.recover()
    h2 = g2.handle(h.rid)
    resumed = (h2.kwargs["x0"] is not None, h2.kwargs["maxiter"] == 400 - it_done, h2.kwargs["deadline"] < 3600.0)
    g2.drain()
    x, info = h2.result()
    return {"it_done": it_done, "kinds": kinds, "summary": summary, "resumed": resumed,
            "info": (info["converged"], info["iterations"]), "x": P.m.gather_pvector(x), "x_direct": x_direct}


def test_recover_resumes_inflight_from_chunk_checkpoint(tmp_path):
    """A chunked request crash-frozen mid-solve resumes from its
    journal-checkpointed iterate (x0 = the saved iterate, the spent
    iterations off the budget, the deadline clock resumed) and converges;
    the same iterations as the JAX package's."""
    out = parity(_resume_chunk, tmp_path)["port-dev"]
    assert out["it_done"] > 0 and out["kinds"].count("chunk") >= 1
    assert out["summary"]["resumed"] == 1 and all(out["resumed"]) and out["info"][0]
    np.testing.assert_allclose(out["x"], out["x_direct"], rtol=0, atol=1e-6)


def _expired(P, tmp):
    A, b, _, x0 = poisson(P)
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd)
    g1.register("t", A, kmax=4)
    g1.paused = True
    h = g1.submit("t", b, x0=x0, tol=1e-9, deadline=0.05, slo_class="interactive", tag="expired")
    time.sleep(0.1)  # ---- crash; the outage outlives the deadline ----
    g2 = P.fd.Gate(journal_dir=jd)
    g2.register("t", A, kmax=4)
    s2 = g2.recover()
    h2 = g2.handle(h.rid)
    with pytest.raises(Exception) as ei:
        h2.result()
    g3 = P.fd.Gate(journal_dir=jd)
    g3.register("t", A, kmax=4)
    s3 = g3.recover()
    with pytest.raises(P.fd.RecoveredError) as e3:
        g3.handle(h.rid).result()
    return {"s2": s2, "state": h2.state, "err": type(ei.value).__name__, "s3": s3, "err3": e3.value.error_type,
            "kinds": _kinds(jd)}


def test_recover_expired_deadline_fails_typed(tmp_path):
    """The deadline clock resumes across the outage: a journaled request
    whose deadline passed by recovery fails typed (`SolveDeadlineError`)
    instead of solving late, and the next generation serves the journaled
    failure."""
    out = parity(_expired, tmp_path)["port"]
    assert out["s2"]["expired"] == 1 and out["state"] == "failed" and out["err"] == "SolveDeadlineError"
    assert out["s3"]["failed"] == 1 and out["err3"] == "SolveDeadlineError"


def _idempotency(P, tmp):
    A, b, _, x0 = poisson(P)
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd)
    g1.register("t", A, kmax=4)
    m = Meter(P)
    h1 = g1.submit("t", b, x0=x0, tol=1e-9, idempotency_key="k")
    g1.drain()
    x1 = P.m.gather_pvector(h1.result()[0])
    replay = {}
    same_handle = g1.submit("t", b, idempotency_key="k", replay_out=replay) is h1
    live = m.delta()
    g2 = P.fd.Gate(journal_dir=jd)  # ---- crash ----
    g2.register("t", A, kmax=4)
    g2.recover()
    h2 = g2.submit("t", b, idempotency_key="k")
    assert np.array_equal(np.asarray(h2.result()[0]).view(np.uint64), x1.view(np.uint64))
    return {"same": same_handle, "replay": replay, "rid": h2.rid == h1.rid, "live": live, "all": m.delta(),
            "x": x1}


def test_idempotency_key_never_double_solves(tmp_path):
    """A retried submit with the same key returns the ORIGINAL handle and
    result and admits nothing new, live and across a crash recovery."""
    out = parity(_idempotency, tmp_path)["port-dev"]
    assert out["same"] and out["replay"] == {"replayed": True} and out["rid"]
    assert out["live"]["service.admitted[]"] == 1 and out["all"]["service.admitted[]"] == 1
    assert out["all"]["gate.idempotent_hits[]"] == 2


def _rids(P, tmp):
    A, b, _, x0 = poisson(P)
    ga, gb = P.fd.Gate(), P.fd.Gate()
    ga.register("t", A, kmax=4)
    gb.register("t", A, kmax=4)
    ha, hb = ga.submit("t", b, x0=x0, tol=1e-9), gb.submit("t", b, x0=x0, tol=1e-9)
    distinct = ha.rid != hb.rid
    ga.drain()
    gb.drain()
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd, start_workers=True)
    g1.register("t", A, kmax=4)
    srv = P.fd.serve_gate(g1, port=0)
    try:
        out = P.fd.http_solve(srv.url, "t", P.m.gather_pvector(b), x0=P.m.gather_pvector(x0), tol=1e-9)
    finally:
        srv.stop(drain=False)
    rid = out["id"]
    g2 = P.fd.Gate(journal_dir=jd, start_workers=True)
    g2.register("t", A, kmax=4)
    g2.recover()
    srv2 = P.fd.serve_gate(g2, port=0)
    try:
        with urllib.request.urlopen(f"{srv2.url}/v1/solve/{rid}") as resp:
            poll = json.loads(resp.read())
        g3 = P.fd.Gate(start_workers=True)
        g3.register("t", A, kmax=4)
        srv3 = P.fd.serve_gate(g3, port=0)
        try:
            urllib.request.urlopen(f"{srv3.url}/v1/solve/{rid}")
            off = None
        except urllib.error.HTTPError as e:
            off = (e.code, json.loads(e.read())["error"])
        finally:
            srv3.stop(drain=False)
    finally:
        srv2.stop(drain=False)
    assert np.array_equal(np.asarray(poll["x"]).view(np.uint64), np.asarray(out["x"]).view(np.uint64))
    return {"distinct": distinct, "rid": rid, "poll": (poll["state"], poll["info"]), "off": off}


def test_request_ids_collision_safe_and_pre_restart_poll(tmp_path):
    """Ids are epoch-qualified: two gate generations never mint the same id;
    journal-on, a pre-restart id polls the recovered result bit for bit;
    journal-off, it is a typed 404."""
    out = parity(_rids, tmp_path)["port"]
    assert out["distinct"] and out["rid"] == "r1-0"
    assert out["poll"][0] == "done" and out["poll"][1]["recovered"]
    assert out["off"] == (404, "UnknownRequest")


def _wal(P, tmp):
    A, b, _, x0 = poisson(P)
    jd = str(tmp / P.name)
    g = P.fd.Gate(journal_dir=jd)
    g.register("t", A, kmax=4)
    h = g.submit("t", b, x0=x0, tol=1e-9, tag="wal")
    g.pump(dispatch_only=True)
    g.service("t").drain()  # the slab finishes; account() has not run
    masked = (h.request.state, h.state)
    with pytest.raises(RuntimeError, match="journal record"):
        h.result()
    before = _kinds(jd)
    g.account()
    after = (h.state, h.result()[1]["converged"], _kinds(jd))
    g2 = P.fd.Gate()
    g2.register("t", A, kmax=4)
    h2 = g2.submit("t", b, x0=x0, tol=1e-9)
    g2.pump(dispatch_only=True)
    g2.service("t").drain()
    return {"masked": masked, "before": before, "after": after, "off": h2.state}


def test_terminal_state_not_acknowledged_before_journaled(tmp_path):
    """Write-ahead applied to completion: a finished request reads
    ``running`` (and ``result()`` refuses) until its terminal record is
    appended; journal-off it is visible at once."""
    out = parity(_wal, tmp_path)["port-dev"]
    assert out["masked"] == ("done", "running") and "completed" not in out["before"]
    assert out["after"][0] == "done" and out["after"][2].count("completed") == 1 and out["off"] == "done"


def test_journal_and_wire_carry_float32_exactly(tmp_path):
    """Exact floats for float32: subnormals, -0.0, the largest finite value
    and ordinary values go through the journal's admitted record and over
    the HTTP wire into the gate bit for bit, in the port; the JAX package's
    journal of the same request holds the same values."""
    tiny = np.finfo(np.float32).smallest_subnormal
    special = np.array([tiny, 3 * tiny, -tiny, -0.0, 0.0, np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, 1.0 / 3.0, np.pi], dtype=np.float32)
    outs = {}
    for P in (JAX, PORT, PORT_DEV):
        A, b, _, _ = poisson(P, (8, 8), np.float32)
        vals = np.zeros(A.rows.ngids, dtype=np.float32)
        vals[: special.size] = special
        bv = P.m.scatter_pvector_values(vals, A.cols)
        jd = str(tmp_path / P.name)
        g = P.fd.Gate(journal_dir=jd)
        g.register("f32", A, kmax=2)
        g.paused = True
        g.submit("f32", bv, tol=1e-5, tag="special")
        adm = next(r for r in P.fd.read_journal(jd) if r["kind"] == "admitted")
        got = np.asarray(adm["b"], dtype=adm["dtype"])
        assert adm["dtype"] == "float32" and np.array_equal(got.view(np.uint32), vals.view(np.uint32))
        outs[P.name] = adm["b"]
        if P is JAX:
            continue
        # over the wire: the request lands in the gate's handle exactly
        srv = P.fd.serve_gate(g, port=0)
        try:
            body = json.dumps({"tenant": "f32", "b": [float(v) for v in vals], "dtype": "float32",
                               "tol": 1e-5, "tag": "wire"}).encode()
            req = urllib.request.Request(srv.url + "/v1/solve", data=body,
                                         headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req) as resp:
                rid = json.loads(resp.read())["id"]
            h = g.handle(rid)
            wire = P.m.gather_pvector(h.kwargs["b"])
            assert wire.dtype == np.float32 and np.array_equal(wire.view(np.uint32), vals.view(np.uint32))
        finally:
            srv.stop(drain=False)
    assert outs["jax"] == outs["port"] == outs["port-dev"]
