"""The port's gate fleet (`partitionedarrays_jl_tpu_torch.frontdoor.fleet`),
journal retention and the `http_solve` client against the JAX package's,
mirroring ``tests/test_pafleet.py`` and the client half of
``tests/test_padur.py``.

Routing is the same function in both packages (the same owner for every
tenant and replica set); a lease either package writes, the other reads,
and both refuse a torn or flipped one typed; retention refuses and prunes
alike; `Gate.adopt` over a dead peer's journal gives the JAX package's
outcome summary with zero requests lost and zero duplicated; the client
runs the same scripted exchanges (injected opener and sleep, no server)
to the same payloads and sleeps. The ``tools/pafleet.py`` smoke and drill
wait for the port's tools.
"""
import json
import os
import time
import urllib.error

import numpy as np
import pytest

import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import frontdoor as ja_fd
from partitionedarrays_jl_tpu_torch import frontdoor as pt_fd

from test_torch_frontdoor import JAX, PORT, PORT_DEV, Meter, parity, poisson


# ---------------------------------------------------------------------------
# rendezvous routing
# ---------------------------------------------------------------------------


def test_rendezvous_matches_jax_and_moves_minimally():
    """The owner of every tenant is the JAX package's for every replica
    set; growth moves tenants only TO the new replica, shrink moves only
    the dead replica's tenants; the dead replica's adopter is rank[0]."""
    reps = ["g0", "g1", "g2"]
    tenants = [f"tenant-{i}" for i in range(200)]
    for rs in (reps, reps[::-1], reps + ["g3"], ["g0", "g2"], ["solo"]):
        for t in tenants:
            assert pt_fd.route(t, rs) == ja_fd.route(t, rs)
        assert pt_fd.rendezvous_rank("g1", rs) == ja_fd.rendezvous_rank("g1", rs)
    owners = {t: pt_fd.route(t, reps) for t in tenants}
    assert {owners[t] for t in tenants} == set(reps)
    for t in tenants:
        assert pt_fd.route(t, reps + ["g3"]) in (owners[t], "g3")
        if owners[t] != "g1":
            assert pt_fd.route(t, ["g0", "g2"]) == owners[t]
    with pytest.raises(AssertionError, match="at least one replica"):
        pt_fd.route("t", [])


# ---------------------------------------------------------------------------
# lease files
# ---------------------------------------------------------------------------


def _lease(P, tmp):
    path = str(tmp / f"{P.name}-lease.json")
    out = {"absent": P.fd.read_lease(path)}
    P.fd.write_lease(path, "g0", depth=3)
    got = P.fd.read_lease(path)
    out["got"] = (got["replica"], got["depth"], got["wall"] > 0)
    raw = open(path).read()
    open(path, "w").write(raw[: len(raw) // 2])
    with pytest.raises(P.fd.LeaseCorruptError, match="unparseable"):
        P.fd.read_lease(path)
    rec = json.loads(raw)
    rec["depth"] = 999
    open(path, "w").write(json.dumps(rec))
    with pytest.raises(P.fd.LeaseCorruptError, match="CRC"):
        P.fd.read_lease(path)
    P.fd.write_lease(path, "g0", depth=0)
    out["healed"] = P.fd.read_lease(path)["depth"]
    return out


def test_lease_roundtrip_torn_and_crc_flip_typed(tmp_path):
    out = parity(_lease, tmp_path, arms=[JAX, PORT])["port"]
    assert out == {"absent": None, "got": ("g0", 3, True), "healed": 0}


def test_each_package_reads_the_others_lease(tmp_path):
    for writer, reader in ((ja_fd, pt_fd), (pt_fd, ja_fd)):
        path = str(tmp_path / f"{writer.__name__}.json")
        rec = writer.write_lease(path, "g7", depth=5, pid=123)
        assert reader.read_lease(path) == {k: v for k, v in rec.items() if k != "crc"}


# ---------------------------------------------------------------------------
# journal retention
# ---------------------------------------------------------------------------


def test_journal_keep_is_the_jax_parsing(monkeypatch):
    """The config's ``journal_keep`` gives what the JAX package parses from
    ``PA_GATE_JOURNAL_KEEP``."""
    for raw, value in ((None, None), ("0", 0), ("-3", -3), ("1", 1), ("2", 2), ("7", 7)):
        if raw is None:
            monkeypatch.delenv("PA_GATE_JOURNAL_KEEP", raising=False)
        else:
            monkeypatch.setenv("PA_GATE_JOURNAL_KEEP", raw)
        with pt_fd.configure(journal_keep=value):
            assert pt_fd.journal_keep() == ja_fd.journal_keep(), (raw, value)


def _prune(P, tmp):
    jd = str(tmp / P.name)
    j1 = P.fd.RequestJournal(jd, fsync=False)
    j1.append("admitted", rid="r1-0", tenant="t")
    j1.close()
    j2 = P.fd.RequestJournal(jd, fsync=False)
    before = sorted(os.path.basename(s) for s in j2.segments())
    with pytest.raises(P.fd.JournalRetentionError, match="epoch"):
        j2.prune(1)
    kept = sorted(os.path.basename(s) for s in j2.segments()) == before
    j2.append("recovered", completed=0, requeued=1)
    m = Meter(P)
    pruned = [os.path.basename(p) for p in j2.prune(1)]
    epochs = {int(os.path.basename(s).split("-")[1]) for s in j2.segments()}
    again = j2.prune(1)
    j2.close()
    return {"kept": kept, "pruned": pruned, "epochs": epochs, "again": again, "counts": m.delta()}


def test_prune_refuses_unrecovered_epoch_then_prunes(tmp_path):
    out = parity(_prune, tmp_path, arms=[JAX, PORT])["port"]
    assert out["kept"] and out["pruned"] and out["epochs"] == {2} and out["again"] == []
    assert out["counts"]["events.journal_pruned"] == 1


def _retention(P, tmp, monkeypatch):
    A, b, _, x0 = poisson(P)
    jd = str(tmp / P.name)
    g1 = P.fd.Gate(journal_dir=jd)
    g1.register("t", A, kmax=4)
    hdone = g1.submit("t", b, x0=x0, tol=1e-9, tag="old-done")
    g1.drain()
    hdone.result()
    hq = g1.submit("t", b, x0=x0, tol=1e-9, tag="live-queued")
    # ---- crash; restart under retention ----
    monkeypatch.setenv("PA_GATE_JOURNAL_KEEP", "1")
    with pt_fd.configure(journal_keep=1):
        m = Meter(P)
        g2 = P.fd.Gate(journal_dir=jd)
        g2.register("t", A, kmax=4)
        summary = g2.recover()
        epochs = {int(os.path.basename(s).split("-")[1]) for s in g2.journal.segments()}
        current = g2.journal.epoch
        g2.drain()
        x2 = P.m.gather_pvector(g2.handle(hq.rid).result()[0])
        g3 = P.fd.Gate(journal_dir=jd)
        g3.register("t", A, kmax=4)
        s3 = g3.recover()
    monkeypatch.delenv("PA_GATE_JOURNAL_KEEP")
    assert np.array_equal(np.asarray(g3.handle(hq.rid).result()[0]).view(np.uint64), x2.view(np.uint64))
    return {"summary": summary, "only_current": epochs == {current}, "s3": s3,
            "aged_out": g3.handle(hdone.rid) is None, "pruned_event": m.delta().get("events.journal_pruned"),
            "x2": x2}


def test_gate_retention_recovers_live_from_retained_set(tmp_path, monkeypatch):
    """Under retention 1 a recovering gate copies live requests into the
    current epoch before pruning the old ones, so a second crash recovery
    needs only the retained set; terminal history ages out."""
    out = parity(_retention, tmp_path, monkeypatch)["port-dev"]
    assert out["summary"]["completed"] == 1 and out["summary"]["requeued"] == 1
    assert out["only_current"] and out["s3"]["completed"] == 1 and out["aged_out"]
    assert out["pruned_event"] == 2  # one a recovery


# ---------------------------------------------------------------------------
# failover: a survivor adopts a dead peer's journal
# ---------------------------------------------------------------------------


def _adopt(P, tmp):
    A, b, _, x0 = poisson(P)
    fleet = str(tmp / P.name / "fleet")
    g0 = P.fd.Gate(journal_dir=os.path.join(fleet, "g0"), rid_namespace="g0")
    g1 = P.fd.Gate(journal_dir=os.path.join(fleet, "g1"), rid_namespace="g1")
    for g in (g0, g1):
        g.register("t", A, kmax=4)
    m0, m1 = P.fd.FleetMember(fleet, "g0", g0, lease_s=0.05), P.fd.FleetMember(fleet, "g1", g1, lease_s=0.05)
    m0.heartbeat()
    m1.heartbeat()
    hd = g0.submit("t", b, x0=x0, tol=1e-9, tag="done-on-g0")
    g0.drain()
    x_done = P.m.gather_pvector(hd.result()[0])
    g0.paused = True  # g0 then dies with two requests queued
    live = [g0.submit("t", b, x0=x0, tol=1e-9, tag=f"live-{i}", idempotency_key=f"k{i}") for i in range(2)]
    assert not m1.check_peers(), "a fresh lease is not a death"
    time.sleep(0.2)  # g0's heartbeat stops; its lease goes stale
    m1.heartbeat()
    meter = Meter(P)
    adopted = m1.check_peers()
    again = m1.check_peers()
    g1.drain()
    served = {h.rid: g1.handle(h.rid) for h in [hd] + live}
    states = {rid: h.state for rid, h in served.items()}
    xr = np.asarray(served[hd.rid].result()[0])
    assert np.array_equal(xr.view(np.uint64), x_done.view(np.uint64))
    xs = [P.m.gather_pvector(served[h.rid].result()[0]) for h in live]
    # a retried submit to the survivor with the original key replays, never re-solves
    replay = g1.submit("t", b, idempotency_key="k0").rid == live[0].rid
    peer_kinds = [r["kind"] for r in P.fd.read_journal(os.path.join(fleet, "g0"))]
    return {"adopted": adopted, "again": again, "states": states, "xs": xs, "replay": replay,
            "counts": meter.delta(), "peer_kinds": peer_kinds, "peers": m1.live_peers()}


def test_adopt_dead_peer_zero_lost_zero_duplicated(tmp_path):
    """Two gates with leases in one process: g0 serves one request, queues
    two more and stops heartbeating; g1's sweep adopts g0's journal (the
    ranked adopter), serves the completed result bit for bit, solves the
    two live requests once each (``service.admitted`` +2), marks them
    ``adopted`` in g0's journal, and a second sweep adopts nothing. The
    outcome equals the JAX package's."""
    out = parity(_adopt, tmp_path)["port-dev"]
    assert out["adopted"] == {"g0": {"completed": 1, "failed": 0, "resumed": 0, "requeued": 2, "expired": 0,
                                     "skipped": 0}}
    assert out["again"] == {} and set(out["states"].values()) == {"done"} and out["replay"]
    assert out["counts"]["service.admitted[]"] == 2 and out["peer_kinds"].count("adopted") == 2


def test_pick_peer_and_shed_forward_payload(tmp_path):
    """`FleetMember.pick_peer` returns the shallowest live peer under its
    own watermark (None when every peer would shed), and a shedding
    server with the picker installed answers 307 with the peer's
    ``Location`` instead of 429."""
    A, b, _, x0 = poisson(PORT)
    fleet = str(tmp_path / "fleet")
    gates = {r: pt_fd.Gate(journal_dir=os.path.join(fleet, r), rid_namespace=r, shed_watermark=1) for r in "ab"}
    for g in gates.values():
        g.register("t", A, kmax=2)
    srvs = {r: pt_fd.serve_gate(g, port=0) for r, g in gates.items()}
    try:
        members = {r: pt_fd.FleetMember(fleet, r, gates[r], server=srvs[r], lease_s=5.0) for r in "ab"}
        for r, mem in members.items():
            mem.map.write_url(r, srvs[r].url)
            mem.heartbeat()
        srvs["a"].peer_picker = members["a"].pick_peer
        assert members["a"].pick_peer() == srvs["b"].url
        gates["a"].paused = True
        bg = pt.gather_pvector(b)
        gates["a"].submit("t", b, x0=x0, tol=1e-9)  # a's queue reaches its watermark
        out = pt_fd.http_solve(srvs["a"].url, "t", bg, x0=pt.gather_pvector(x0), tol=1e-9,
                               slo_class="besteffort", idempotency_key="fwd")
        assert out["state"] == "done" and out["id"].startswith("b-")
        assert pt.telemetry.registry().counter("fleet.forwarded").value >= 1
        gates["b"].paused = True
        gates["b"].submit("t", b, x0=x0, tol=1e-9)
        members["a"]._hz_cache.clear()
        assert members["a"].pick_peer() is None
    finally:
        for g in gates.values():
            g.paused = False
        for s in srvs.values():
            s.stop(drain=False)


# ---------------------------------------------------------------------------
# the http_solve client (injected failures, no real server)
# ---------------------------------------------------------------------------


class _FakeResponse:
    def __init__(self, status, payload):
        self.status = status
        self._payload = payload

    def read(self):
        return json.dumps(self._payload).encode()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeHTTPError(urllib.error.HTTPError):
    def __init__(self, url, code, payload, headers=None):
        import email.message

        msg = email.message.Message()
        for k, v in (headers or {}).items():
            msg[k] = str(v)
        super().__init__(url, code, "err", msg, None)
        self._payload = payload

    def read(self):
        return json.dumps(self._payload).encode()


_DONE = {"id": "r1-0", "state": "done", "x": [1.0, 2.0],
         "info": {"converged": True, "iterations": 3, "status": "converged"}}

SCRIPTS = {
    "transient_and_retry_after": (
        lambda: [urllib.error.URLError("refused"), ConnectionResetError("reset"),
                 _FakeHTTPError("u", 429, {"error": "LoadShedded", "retry_after_s": 2.5}, {"Retry-After": "3"}),
                 _FakeResponse(202, {"id": "r1-0", "state": "gate-queued"}),
                 _FakeResponse(200, {"id": "r1-0", "state": "running"}),
                 urllib.error.URLError("mid-poll restart"), _FakeResponse(200, _DONE)],
        dict(tol=1e-9, retries=3, retry_cap_s=1.5, poll_s=0.0, timeout_s=60.0)),
    "retries_503": (
        lambda: [_FakeHTTPError("u", 503, {"error": "AdmissionRejected", "message": "queue full"}),
                 _FakeHTTPError("u", 503, {"error": "AdmissionRejected", "message": "queue full"}),
                 _FakeResponse(202, {"id": "r1-0", "state": "gate-queued"}), _FakeResponse(200, _DONE)],
        dict(tol=1e-9, retries=3, poll_s=0.0, timeout_s=60.0)),
    "exhausts_503": (
        lambda: [_FakeHTTPError("u", 503, {"error": "AdmissionRejected", "message": "full"})] * 3,
        dict(retries=2, timeout_s=60.0)),
    "zero_retries_429": (
        lambda: [_FakeHTTPError("u", 429, {"error": "LoadShedded", "retry_after_s": 9.0}, {"Retry-After": "9"})],
        dict()),
    "follows_307": (
        lambda: [_FakeHTTPError("u", 307, {"error": "LoadShedded", "forwarded_to": "http://peer:9"},
                                {"Location": "http://peer:9/v1/solve", "Retry-After": "1"}),
                 _FakeResponse(202, {"id": "g1-r1-0", "state": "gate-queued"}),
                 _FakeResponse(200, dict(_DONE, id="g1-r1-0"))],
        dict(tol=1e-9, idempotency_key="fwd-key", poll_s=0.0)),
    "hop_cap": (
        lambda: [_FakeHTTPError("u", 307, {"error": "LoadShedded"}, {"Location": "http://peer:9/v1/solve"})] * 5,
        dict()),
}


def _client(fd, name):
    make, kwargs = SCRIPTS[name]
    script, urls, bodies, sleeps = make(), [], [], []

    def opener(req):
        urls.append(req.full_url)
        if req.data is not None:
            body = json.loads(req.data)
            bodies.append(body)
        ev = script.pop(0)
        if isinstance(ev, Exception):
            raise ev
        return ev

    out = fd.http_solve("http://fake", "t", [0.0, 0.0], opener=opener, sleep=sleeps.append,
                        traceparent="00-" + "1" * 32 + "-" + "2" * 16 + "-01", **kwargs)
    return {"out": out, "urls": urls, "bodies": bodies, "sleeps": sleeps, "left": len(script)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_http_solve_client_matches_jax(name):
    """The same scripted exchanges (transient failures, 429 with a measured
    Retry-After under the cap, 503 backoff and its exhaustion, the
    one-shot default, a followed 307 and the hop cap): the same payload,
    the same URLs and bodies, the same sleeps, in both packages."""
    want, got = _client(ja_fd, name), _client(pt_fd, name)
    assert got == want
    if name == "transient_and_retry_after":
        assert got["out"]["state"] == "done" and 1.5 in got["sleeps"] and got["left"] == 0
    elif name == "retries_503":
        assert got["sleeps"][:2] == [0.05, 0.1]
    elif name == "follows_307":
        assert got["urls"] == ["http://fake/v1/solve", "http://peer:9/v1/solve", "http://peer:9/v1/solve/g1-r1-0"]
        assert got["bodies"][0] == got["bodies"][1] and got["bodies"][1]["idempotency_key"] == "fwd-key"
    elif name == "hop_cap":
        assert got["out"]["http_status"] == 307 and len(got["urls"]) == 5
    elif name == "zero_retries_429":
        assert got["out"]["http_status"] == 429 and got["out"]["retry_after"] == "9" and got["sleeps"] == []


def test_http_solve_gives_up_on_deadline():
    """Once the overall timeout budget is spent, a transient failure
    re-raises instead of retrying."""
    calls = []

    def opener(req):
        calls.append(1)
        raise urllib.error.URLError("down")

    with pytest.raises(urllib.error.URLError):
        pt_fd.http_solve("http://fake", "t", [0.0], retries=50, opener=opener, sleep=lambda s: None, timeout_s=0.0)
    assert len(calls) == 1


def test_http_solve_jitter_from_config():
    """The config's ``retry_jitter`` (``PA_RETRY_JITTER``) seeds the
    client's backoff: the same seed, the same delays; unset, none."""

    def delays(seed):
        sleeps = []

        def opener(req):
            raise urllib.error.URLError("down")

        with pt_fd.configure(retry_jitter=seed):
            with pytest.raises(urllib.error.URLError):
                pt_fd.http_solve("http://fake", "t", [0.0], retries=3, opener=opener, sleep=sleeps.append,
                                 timeout_s=60.0)
        return sleeps

    assert delays(5) == delays(5) and delays(5) != delays(None)
