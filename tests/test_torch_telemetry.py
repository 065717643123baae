"""The port's telemetry core (`partitionedarrays_jl_tpu_torch.telemetry`)
against the JAX package's (`partitionedarrays_jl_tpu.telemetry`), mirroring
tests/test_pamon.py, tests/test_telemetry.py and tests/test_patx.py's
in-process half.

* Histograms: the same observations give byte-identical JSON from both
  packages; quantiles bracket the true quantile; snapshot, delta and
  apply-delta round-trip exactly.
* Registry: the same operations give the same ``to_prometheus()`` text
  (every field of it is deterministic) and the same JSON; a declared name
  refuses another kind.
* Tracing: the traceparent fuzz sweep gets the same verdict from both
  parsers; spans persist and rebuild into one tree.
* Records: a record persisted by either package loads in the other;
  `emit_event` never raises; each typed health error, injected fault,
  checkpoint save and restore, and recovery restart emits the JAX
  package's event kind and label on the same script.
* The config: `configure` scopes the switches, ``metrics`` off makes
  records inert, ``mon`` off stops histograms and throughput updates, and
  ``lock_check`` turns on the lock-order sanitizer.
"""
import json
import threading

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import telemetry as ja_tel
from partitionedarrays_jl_tpu.models import solvers as ja_solvers
from partitionedarrays_jl_tpu.parallel import checkpoint as ja_ck
from partitionedarrays_jl_tpu.parallel import faults as ja_faults
from partitionedarrays_jl_tpu.parallel import health as ja_health
from partitionedarrays_jl_tpu_torch import telemetry as pt_tel
from partitionedarrays_jl_tpu_torch.models import solvers as pt_solvers
from partitionedarrays_jl_tpu_torch.parallel import checkpoint as pt_ck
from partitionedarrays_jl_tpu_torch.parallel import faults as pt_faults
from partitionedarrays_jl_tpu_torch.utils import health as pt_health
from partitionedarrays_jl_tpu_torch.utils import locksan

_VALID_TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
#: tests/test_patx.py:58's corpus, and more
_HEADERS = [
    _VALID_TP, f"  {_VALID_TP} ", "", "00", _VALID_TP[:-4], _VALID_TP + "-extra", _VALID_TP + "00",
    _VALID_TP.replace("-", ""), "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "xy" * 8 + "-01", "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01", "0-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "00" * 16 + "-" + "cd" * 8 + "-01", "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",
    "00-" + "ab" * 17 + "-" + "cd" * 8 + "-01", "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "01-" + "ab" * 16 + "-" + "cd" * 8 + "-00", _VALID_TP + "\n", "garbage", None, 123, b"00-ab",
]


def _observations(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-6.0, 3.0, 200), [0.0, -1.0, 1e-9, 5e4, 1e-7, 1e4]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_json_byte_identical(seed):
    """The same observations: byte-identical JSON from both packages (the
    bucket layout is the JAX package's), and equal quantile bounds."""
    hj, hp = ja_tel.LatencyHistogram(), pt_tel.LatencyHistogram()
    for v in _observations(seed):
        hj.observe(v)
        hp.observe(v)
    assert pt_tel.histogram.BUCKET_BOUNDS == ja_tel.histogram.BUCKET_BOUNDS
    assert hp.to_json() == hj.to_json()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert hp.quantile_bounds(q) == hj.quantile_bounds(q)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_bracket_and_delta_roundtrip(seed):
    """The q-quantile lies inside quantile_bounds(q) (exactly: bucket edges
    from the observed data); snapshot -> delta -> apply_delta rebuilds the
    later snapshot exactly, in both packages."""
    obs = _observations(seed)
    h = pt_tel.LatencyHistogram()
    for v in obs[:100]:
        h.observe(v)
    first = h.snapshot()
    for v in obs[100:]:
        h.observe(v)
    srt = np.sort(obs)
    for q in (0.1, 0.5, 0.9, 0.99):
        lo, hi = h.quantile_bounds(q)
        true = srt[max(1, int(np.ceil(q * len(obs)))) - 1]
        assert lo <= true <= hi
    d = h.delta(first)
    assert pt_tel.apply_delta(first, d) == h.snapshot()
    assert json.dumps(d, sort_keys=True) == json.dumps(
        _ja_hist(obs).delta(_ja_hist(obs[:100]).snapshot()), sort_keys=True)
    assert pt_tel.LatencyHistogram.from_snapshot(h.snapshot()).to_json() == h.to_json()


def _ja_hist(obs):
    h = ja_tel.LatencyHistogram()
    for v in obs:
        h.observe(v)
    return h


def _registry_script(tel, prefix):
    reg = tel.registry()
    reg.reset(prefix)
    c = reg.counter(f"{prefix}.c")
    c.inc()
    c.inc(2)
    g = reg.gauge(f"{prefix}.g")
    g.set(4.0)
    g.inc()
    g.dec(2.0)
    for v in _observations(3):
        reg.histogram(f"{prefix}.h").observe(abs(v))
    reg.histogram(f"{prefix}.lh", labels={"tenant": 'a"b\\c\nd'}).observe(0.25)
    reg.counter(f"{prefix}.slo", labels={"tol_class": "1e-08"}).inc(5)
    reg.counter("service.admitted").inc(3)
    reg.histogram("service.queue_wait_s").observe(0.001)
    reg.gauge("service.queue_depth").set(7)
    with pytest.raises(TypeError):
        reg.gauge("lowering_cache.hit")
    with pytest.raises(TypeError):
        reg.counter("service.queue_wait_s")
    with pytest.raises(TypeError):
        reg.gauge("events.solve_aborted")
    return reg.to_prometheus(), reg.to_json()


def test_registry_prometheus_identical():
    """The same registry operations: the same Prometheus exposition (HELP
    and TYPE lines, escaped labels, cumulative buckets) and JSON."""
    ja_tel.registry().reset()
    pt_tel.registry().reset()
    want = _registry_script(ja_tel, "t_tel")
    got = _registry_script(pt_tel, "t_tel")
    assert got == want
    assert "pa_t_tel_c 3" in got[0] and 'pa_t_tel_slo{tol_class="1e-08"} 5' in got[0]
    assert pt_tel.CATALOG.keys() == ja_tel.CATALOG.keys()
    for name, spec in pt_tel.CATALOG.items():
        other = ja_tel.CATALOG[name]
        assert (spec.kind, spec.unit, spec.labels, spec.desc) == (other.kind, other.unit, other.labels, other.desc)
    pt_tel.registry().reset()


def test_traceparent_fuzz_same_verdict():
    """Both strict W3C parsers agree on every header of the sweep
    (truncated, overlong, non-hex, uppercase, zero ids, bad versions, wrong
    types); the valid one round-trips."""
    for h in _HEADERS:
        j, p = ja_tel.parse_traceparent(h), pt_tel.parse_traceparent(h)
        assert (j is None) == (p is None), h
        if p is not None:
            assert (p.trace_id, p.span_id) == (j.trace_id, j.span_id)
    assert pt_tel.parse_traceparent(_VALID_TP).traceparent() == _VALID_TP
    a, b = pt_tel.mint_trace(), pt_tel.mint_trace()
    assert a.trace_id != b.trace_id and pt_tel.parse_traceparent(a.traceparent()) is not None


def test_span_persistence_and_tree(tmp_path):
    """Spans persist as begin/end JSONL under ``tracing_dir`` and rebuild
    into one tree with no orphan; a span left open loads as interrupted;
    with tracing off `start_span` is the inert span."""
    with pt_tel.configure(tracing_dir=str(tmp_path)):
        with pt_tel.tracing.span("rpc.request", name="r") as root:
            with pt_tel.tracing.span("slab.solve", name="r", parent=root) as s:
                with pt_tel.tracing.span("chunk", name="r", parent=s):
                    pass
            open_span = pt_tel.start_span("chunk", name="open", parent=s)
    spans = pt_tel.tracing.load_spans(str(tmp_path))
    mine = pt_tel.tracing.spans_for(root.trace_id, spans)
    roots, orphans = pt_tel.tracing.span_tree(mine)
    assert len(mine) == 4 and len(roots) == 1 and not orphans
    assert not pt_tel.verify_trace(spans, root.trace_id)
    assert [x["status"] for x in mine if x["span_id"] == open_span.span_id] == ["interrupted"]
    assert pt_tel.tracing.trace_summary(spans, root.trace_id)["interrupted"] == 1
    assert "slab.solve:r" in pt_tel.tracing.render_trace(spans, root.trace_id)
    with pt_tel.configure(tracing=False):
        assert not pt_tel.start_span("chunk").recording
    pt_tel.tracing.clear_spans()


def _record(tel, d):
    rec = tel.begin_record("cg", tol=1e-8, maxiter=10)
    tel.emit_event("restart", label="NonFiniteError", iteration=3, attempt=1, arr=np.arange(3), obj=object())
    rec.alpha, rec.beta = [0.5, 0.25], [0.1, 0.2]
    info = rec.finish({"iterations": 2, "converged": True, "status": "converged",
                       "residuals": np.array([1.0, 0.5, 0.1])})
    return info.record, tel.list_persisted_records(str(d))


def test_records_persist_and_load_across_packages(tmp_path, monkeypatch):
    """A record persisted by either package loads in the other, on one
    schema: the same keys, the same event, the same α/β."""
    monkeypatch.setenv("PA_METRICS_DIR", str(tmp_path / "jax"))
    rj, fj = _record(ja_tel, tmp_path / "jax")
    with pt_tel.configure(metrics_dir=str(tmp_path / "port")):
        rp, fp = _record(pt_tel, tmp_path / "port")
    assert len(fj) == len(fp) == 1
    lj, lp = pt_tel.load_record(fj[0]), ja_tel.load_record(fp[0])
    assert lj.keys() == lp.keys()
    for d in (lj, lp):
        assert d["schema_version"] == pt_tel.RECORD_SCHEMA_VERSION == ja_tel.RECORD_SCHEMA_VERSION
        assert d["iterations"] == 2 and d["alpha"] == [0.5, 0.25] and d["residuals"] == [1.0, 0.5, 0.1]
        assert [(e["kind"], e["label"], e["details"]["arr"]) for e in d["events"]] == \
            [("restart", "NonFiniteError", [0, 1, 2])]
    assert rp.as_dict().keys() == rj.as_dict().keys()


def test_emit_event_never_raises():
    """emit_event swallows every failure: unserializable details, a record
    whose event method raises, a finished record."""
    rec = pt_tel.begin_record("probe")

    class Boom:
        def __repr__(self):
            raise RuntimeError("no repr")

    pt_tel.emit_event("probe", label="x", thing=Boom(), **{"nested": {"a": Boom()}})
    rec.event = None  # a broken record on the stack
    pt_tel.emit_event("probe", label="y")
    del rec.event
    rec.finish(None)
    pt_tel.emit_event("probe", label="after")
    with pt_tel.configure(metrics=False):
        inert = pt_tel.begin_record("inert")
        pt_tel.emit_event("probe")
        assert not inert.enabled and inert.events == []
        assert inert.finish({"iterations": 1}).record is inert
    assert pt_tel.counter("events.probe") >= 4


def _events_script(P, tmp):
    """Typed health errors, an injected fault, a checkpoint save and
    restore, and recovery restarts; returns (kind, label) of each event
    of the listed kinds, in order."""
    kinds = ("health_error", "fault_injected", "checkpoint_save", "checkpoint_restore", "restart",
             "solve_aborted", "column_verdict", "sdc_detection", "sdc_rollback")

    def driver(parts):
        A, b, _, x0 = P.m.assemble_poisson(parts, (8, 8))
        bad = b.copy()
        P.m.map_parts(lambda i, v: np.asarray(v).__setitem__(0, np.nan) if int(i.part) == 0 else None,
                      bad.rows.partition, bad.values)
        rec = P.tel.begin_record("script")
        for err in (P.h.NonFiniteError, P.h.SolverBreakdownError, P.h.SolveDeadlineError):
            err("probe", diagnostics={"iteration": 4, "context": "probe"})
        with pytest.raises(P.h.NonFiniteError):
            P.m.cg(A, bad, x0=x0, tol=1e-9)
        P.m.cg(A, B=[b, bad], X0=[x0, x0], tol=1e-9, column_errors="report")
        with P.inject("nan@part=1,call=5", seed=1):
            P.solvers.solve_with_recovery(A, b, x0=x0, tol=1e-9, checkpoint_dir=str(tmp / "ck"), every=5,
                                          max_restarts=2)
        ck = P.ck.SolverCheckpointer(str(tmp / "ck2"), every=1, async_write=False)
        ck.save_state({"x": x0}, {"method": "cg", "it": 3, "tol": 1e-9})
        P.ck.load_solver_state(str(tmp / "ck2"), P.solvers._solver_state_ranges(A, b))
        rec.finish(None)
        return [(e.kind, e.label) for e in rec.events if e.kind in kinds]

    return P.m.prun(driver, P.m.sequential, (2, 2))


def test_resilience_events_match_jax(tmp_path):
    """The same script through both packages: the same sequence of event
    kinds and labels (health errors, the injected fault, checkpoints, the
    recovery restart, the aborted solve, the block driver's verdict)."""
    import types

    J = types.SimpleNamespace(m=pa, tel=ja_tel, h=ja_health, inject=ja_faults.inject_faults, solvers=ja_solvers,
                              ck=ja_ck)
    P = types.SimpleNamespace(m=pt, tel=pt_tel, h=pt_health, inject=pt_faults.inject_faults, solvers=pt_solvers,
                              ck=pt_ck)
    want = _events_script(J, tmp_path / "jax")
    got = _events_script(P, tmp_path / "port")
    assert got == want
    assert ("fault_injected", "nan") in got and ("restart", "NonFiniteError") in got
    assert ("checkpoint_save", "cg") in got and ("checkpoint_restore", "cg") in got
    assert ("health_error", "SolverBreakdownError") in got and ("column_verdict", "block-host") in got


def test_config_scopes_switches():
    """`configure` returns the previous config, which restores itself as a
    context manager; ``mon`` off stops histograms and throughput updates
    (counters stay on); a bad value is refused."""
    base = pt_tel.config()
    with pt_tel.configure(mon=False, mon_ewma=0.5) as prev:
        assert prev is base and not pt_tel.monitoring_enabled() and pt_tel.mon_ewma() == 0.5
        m = pt_tel.ThroughputModel()
        m.observe_slab("fp", "float64", 4, 1e-3, 10)
        assert m.curve("fp", "float64") == {}
    assert pt_tel.config() is base
    m.observe_slab("fp", "float64", 4, 1e-3, 10)
    assert m.curve("fp", "float64") == {4: 1e-3 / 4}
    with pytest.raises(ValueError):
        pt_tel.configure(mon_ewma=0.0)
    assert pt_tel.config() is base
    snap = pt_tel.config_snapshot()
    assert snap["metrics"] is True and snap["spec_admit"] is False and snap["history"] == 16


def test_lock_sanitizer_records_order():
    """With ``lock_check`` on, `sanitized` wraps a lock and records the
    order edges two nested locks take (and Condition waits on the shim);
    off, it returns the lock itself."""
    raw = threading.RLock()
    assert locksan.sanitized(raw, "A.lock") is raw
    locksan.reset_observations()
    with pt_tel.configure(lock_check=True):
        a = locksan.sanitized(threading.RLock(), "A.lock")
        b = locksan.sanitized(threading.Lock(), "B.lock")
    cv = threading.Condition(a)
    with a:
        with b:
            pass
        with cv:
            cv.wait(timeout=0.001)

    def other():
        with a:
            with b:
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert locksan.observed_edges() == {("A.lock", "B.lock")}
    assert locksan.observed_max_nesting() == 2
    assert locksan.find_cycle(sorted(locksan.observed_edges())) is None
    assert locksan.find_cycle([("A", "B"), ("B", "A")]) == ["A", "B", "A"]
    locksan.reset_observations()


def test_chrome_trace_and_artifact(tmp_path):
    """A finished record exports as a Chrome trace (one span, its events
    as instants); the artifact writer stamps its envelope."""
    rec = pt_tel.begin_record("cg")
    pt_tel.emit_event("restart", label="x")
    rec.finish({"iterations": 1})
    path = pt_tel.write_chrome_trace(str(tmp_path / "t.json"), records=[rec])
    events = json.loads(open(path).read())["traceEvents"]
    assert [e["ph"] for e in events if e.get("pid") == 1 and e["ph"] != "M"] == ["X", "i"]
    out = pt_tel.write(str(tmp_path / "a.json"), {"x": 1}, tool="probe", echo=False)
    assert out["schema_version"] == 1 and out["platform"] in ("cpu", "gpu") and "telemetry_config" in out
    with pt_tel.annotate("pa:probe"):
        pass
