"""pamon — live service observability: metric snapshots, SLO attainment,
the front door's gate and fleet views, and the measured throughput model.

The port's counterpart of the JAX package's ``tools/pamon.py``, the
console of the `telemetry.registry` metrics plane. Data sources:

* in-process — ``--check`` / ``--demo`` run a small solve service on
  ``--device`` and render its live registry;
* a snapshot file — ``--snapshot FILE`` renders a registry export
  (``telemetry.registry().to_json()``, e.g. ``paserve --metrics-json``);
  ``--watch`` re-reads it every ``--interval`` seconds and shows deltas;
* a throughput model — ``--model PATH`` renders a
  ``ThroughputModel`` export (the per-RHS curve behind adaptive K);
* a live fleet — ``--fleet FLEET_DIR`` renders one row per gate replica of
  the port's front door (`frontdoor.fleet`: lease state and age, queue
  depth, residency, the admitted/shed/forwarded/adopted/lease_missed
  counters from each replica's ``/metrics.json``); ``--watch`` polls.

Output modes: the default table (with the front door's gate view when the
snapshot holds ``gate.*`` metrics), ``--prom``, ``--json``, ``--slo``,
``--conv`` (the convergence observatory).

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.pamon --check --device cpu
    python -m partitionedarrays_jl_tpu_torch.tools.pamon --demo --slo
    python -m partitionedarrays_jl_tpu_torch.tools.pamon --snapshot metrics.json --watch --interval 2
    python -m partitionedarrays_jl_tpu_torch.tools.pamon --fleet /tmp/fleet --watch --interval 2
"""
import argparse
import json
import sys
import time


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _hist_line(name, snap):
    from partitionedarrays_jl_tpu_torch.telemetry import LatencyHistogram

    h = LatencyHistogram.from_snapshot(snap)
    if h.total == 0:
        return f"  {name:32s} count=0"
    return (
        f"  {name:32s} count={h.total:<6d} mean={h.mean():.6f}s "
        f"p50<={h.quantile(0.5):.6f}s p90<={h.quantile(0.9):.6f}s "
        f"p99<={h.quantile(0.99):.6f}s max={h.max:.6f}s"
    )


def render_snapshot(snap, prev=None):
    """The default table: counters, gauges, histogram summaries (with
    deltas against ``prev`` in watch mode)."""
    from partitionedarrays_jl_tpu_torch.telemetry import LatencyHistogram

    lines = []
    counters = snap.get("counters") or {}
    if counters:
        lines.append("counters:")
        prev_c = (prev or {}).get("counters") or {}
        for name, v in sorted(counters.items()):
            d = v - prev_c.get(name, 0)
            delta = f"  (+{d})" if prev is not None and d else ""
            lines.append(f"  {name:32s} {v}{delta}")
    gauges = snap.get("gauges") or {}
    if gauges:
        lines.append("gauges:")
        for name, v in sorted(gauges.items()):
            lines.append(f"  {name:32s} {v:g}")
    hists = snap.get("histograms") or {}
    if hists:
        lines.append("histograms (quantiles are bucket upper edges):")
        prev_h = (prev or {}).get("histograms") or {}
        for name, hsnap in sorted(hists.items()):
            lines.append(_hist_line(name, hsnap))
            if prev is not None and name in prev_h:
                d = LatencyHistogram.from_snapshot(hsnap).delta(
                    prev_h[name]
                )
                if d["count"]:
                    lines.append(
                        f"  {'':32s} +{d['count']} since last poll "
                        f"(+{d['sum']:.6f}s)"
                    )
    return "\n".join(lines) if lines else "(registry empty)"


def render_gate(snap, prev=None):
    """The front-door view: tenant residency
    (resident/evicted, footprint vs budget) and per-SLO-class
    attainment with deltas against ``prev`` in watch mode. Pure
    rendering over the existing snapshot — the gate collects nothing
    new for this view."""
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    if not any(k.startswith("gate.") for k in
               list(counters) + list(gauges)):
        return ""
    lines = ["front door (pagate):"]
    budget = gauges.get("gate.mem_budget_bytes", 0)
    resident = gauges.get("gate.resident_bytes", 0)
    lines.append(
        f"  resident {resident:,.0f} B / budget "
        + (f"{budget:,.0f} B" if budget else "unbounded")
        + f"  queue_depth={gauges.get('gate.queue_depth', 0):g}"
        + f"  evictions={counters.get('gate.evictions', 0)}"
        + f"  page_ins={counters.get('gate.page_ins', 0)}"
    )
    tenants = {}
    for name, v in gauges.items():
        for field, prefix in (
            ("resident", "gate.tenant_resident{tenant="),
            ("footprint", "gate.tenant_footprint_bytes{tenant="),
        ):
            if name.startswith(prefix):
                tenant = name[len(prefix):].rstrip("}")
                tenants.setdefault(tenant, {})[field] = v
    for tenant in sorted(tenants):
        row = tenants[tenant]
        state = "resident" if row.get("resident") else "EVICTED"
        lines.append(
            f"  tenant {tenant:16s} {state:8s} "
            f"footprint={row.get('footprint', 0):,.0f} B"
        )
    classes = {}
    prev_c = (prev or {}).get("counters") or {}
    for name, v in counters.items():
        for field, prefix in (
            ("requests", "gate.slo.requests{slo_class="),
            ("hits", "gate.slo.hits{slo_class="),
            ("shed", "gate.shed{slo_class="),
        ):
            if name.startswith(prefix):
                cls = name[len(prefix):].rstrip("}")
                classes.setdefault(cls, {})[field] = v
                classes[cls][field + "_d"] = v - prev_c.get(name, 0)
    if classes:
        lines.append("  SLO classes (attainment = hits/requests):")
    for cls in sorted(classes):
        row = classes[cls]
        req, hit = row.get("requests", 0), row.get("hits", 0)
        rate = hit / req if req else 0.0
        line = (
            f"    class={cls:12s} requests={req:<5d} hits={hit:<5d} "
            f"shed={row.get('shed', 0):<5d} attainment={rate:.1%}"
        )
        if prev is not None and (
            row.get("requests_d") or row.get("shed_d")
        ):
            line += (
                f"  (+{row.get('requests_d', 0)} req, "
                f"+{row.get('hits_d', 0)} hit, "
                f"+{row.get('shed_d', 0)} shed since last poll)"
            )
        lines.append(line)
    return "\n".join(lines)


def _fleet_fetch(fleet_dir):
    """Per-replica rows for ``--fleet``: url + lease state from the
    fleet dir, ``/healthz`` + ``/metrics.json`` over HTTP. Never
    raises — a dead, unreachable, or lease-corrupt replica is a
    rendered state, not a crash."""
    import urllib.request

    from partitionedarrays_jl_tpu_torch.frontdoor import fleet as _fleet

    fm = _fleet.FleetMap(fleet_dir)
    lease_s = _fleet.fleet_lease_s()
    rows = {}
    for r in fm.replicas():
        row = {
            "url": fm.url(r), "lease": "absent",
            "health": {}, "counters": {}, "gauges": {},
        }
        try:
            lease = fm.lease(r)
            if lease is not None:
                age = time.time() - float(lease.get("wall", 0.0))
                row["lease_age_s"] = age
                row["lease"] = (
                    "STALE" if age > 3 * lease_s else "live"
                )
        except _fleet.LeaseCorruptError:
            row["lease"] = "CORRUPT"
        if row["url"]:
            try:
                with urllib.request.urlopen(
                    row["url"] + "/healthz", timeout=2.0
                ) as resp:
                    row["health"] = json.loads(resp.read())
                with urllib.request.urlopen(
                    row["url"] + "/metrics.json", timeout=2.0
                ) as resp:
                    snap = json.loads(resp.read())
                row["counters"] = snap.get("counters") or {}
                row["gauges"] = snap.get("gauges") or {}
            except (OSError, ValueError):
                row["down"] = True
        else:
            row["down"] = True
        rows[r] = row
    return rows


def _fleet_row_vals(row):
    """The counted columns of one fleet row (summed over labels)."""
    c = row.get("counters") or {}

    def tot(name):
        return sum(
            v for k, v in c.items()
            if k == name or k.startswith(name + "{")
        )

    return {
        "admitted": tot("service.admitted"),
        "shed": tot("gate.shed"),
        "forwarded": tot("fleet.forwarded"),
        "adopted": tot("fleet.adopted"),
        "lease_missed": tot("fleet.lease_missed"),
    }


def render_fleet(rows, prev=None):
    """The fleet view: one row per replica —
    liveness, lease state/age, queue depth, tenant residency, and the
    admitted/shed/forwarded/adopted/lease_missed counters (summed over
    labels), with deltas against ``prev`` in watch mode. Pure
    rendering over each replica's own ``/metrics.json`` registry —
    the fleet collects nothing new for this view."""
    if not rows:
        return "(fleet dir has no replicas)"
    lines = ["gate fleet (pafleet):"]
    for r in sorted(rows):
        row = rows[r]
        lease = row["lease"]
        if "lease_age_s" in row:
            lease += f"({row['lease_age_s']:.1f}s)"
        if row.get("down"):
            lines.append(f"  {r:8s} DOWN lease={lease}")
            continue
        g = row.get("gauges") or {}
        depth = row.get("health", {}).get(
            "queue_depth", g.get("gate.queue_depth", 0)
        )
        resident = sum(
            1 for k, v in g.items()
            if k.startswith("gate.tenant_resident{") and v
        )
        vals = _fleet_row_vals(row)
        line = (
            f"  {r:8s} UP   lease={lease:14s} depth={depth:<4g} "
            f"resident={resident} "
            + " ".join(f"{k}={v}" for k, v in vals.items())
        )
        if prev is not None and r in prev and not prev[r].get("down"):
            pvals = _fleet_row_vals(prev[r])
            deltas = [
                f"+{vals[k] - pvals[k]} {k}"
                for k in vals if vals[k] != pvals[k]
            ]
            if deltas:
                line += "  (" + ", ".join(deltas) + " since last poll)"
        lines.append(line)
    return "\n".join(lines)


def render_conv(snap, prev=None):
    """The convergence-observatory view: per-tenant
    predicted-vs-actual iteration forecast error (p50/p90 relative
    error bracketed from the `spec.iters_rel_error{tenant=…}` histogram
    buckets) plus the prediction/infeasibility/anomaly counters, with
    `--watch` deltas against ``prev``. Pure rendering over the existing
    snapshot."""
    from partitionedarrays_jl_tpu_torch.telemetry import LatencyHistogram

    counters = snap.get("counters") or {}
    hists = snap.get("histograms") or {}
    conv = {
        name: hsnap for name, hsnap in hists.items()
        if name.startswith("spec.iters_rel_error{tenant=")
    }
    spec_counters = {
        name: v for name, v in counters.items()
        if name.startswith("spec.")
    }
    if not conv and not spec_counters:
        return ""
    lines = ["convergence observatory (paspec):"]
    lines.append(
        "  predictions={}  infeasible={}".format(
            counters.get("spec.predictions", 0),
            counters.get("spec.infeasible", 0),
        )
        + "".join(
            f"  anomalies[{n.split('kind=', 1)[1].rstrip('}')}]={v}"
            for n, v in sorted(counters.items())
            if n.startswith("spec.anomalies{")
        )
    )
    if conv:
        lines.append(
            "  forecast error |predicted-actual|/actual "
            "(quantiles are bucket upper edges):"
        )
    prev_h = (prev or {}).get("histograms") or {}
    for name, hsnap in sorted(conv.items()):
        tenant = name.split("tenant=", 1)[1].rstrip("}")
        h = LatencyHistogram.from_snapshot(hsnap)
        if h.total == 0:
            lines.append(f"    tenant {tenant:16s} count=0")
            continue
        line = (
            f"    tenant {tenant:16s} count={h.total:<5d} "
            f"p50<={h.quantile(0.5):.3g} p90<={h.quantile(0.9):.3g} "
            f"mean={h.mean():.3g}"
        )
        if prev is not None and name in prev_h:
            d = h.delta(prev_h[name])
            if d["count"]:
                line += f"  (+{d['count']} since last poll)"
        lines.append(line)
    return "\n".join(lines)


def render_slo(snap):
    """Deadline attainment per tolerance class + the slack
    distribution."""
    counters = snap.get("counters") or {}
    classes = {}
    for name, v in counters.items():
        if name.startswith("service.slo.requests{"):
            cls = name.split("tol_class=", 1)[1].rstrip("}")
            classes.setdefault(cls, {})["requests"] = v
        elif name.startswith("service.slo.hits{"):
            cls = name.split("tol_class=", 1)[1].rstrip("}")
            classes.setdefault(cls, {})["hits"] = v
    lines = ["SLO attainment (deadline-carrying requests):"]
    if not classes:
        lines.append("  (no deadline-carrying requests observed)")
    for cls in sorted(classes):
        req = classes[cls].get("requests", 0)
        hit = classes[cls].get("hits", 0)
        rate = hit / req if req else 0.0
        lines.append(
            f"  tol_class={cls:8s} requests={req:<5d} hits={hit:<5d} "
            f"attainment={rate:.1%}"
        )
    slack = (snap.get("histograms") or {}).get("service.deadline_slack_s")
    if slack:
        lines.append(_hist_line("service.deadline_slack_s", slack))
    return "\n".join(lines)


def render_model(rec):
    """The measured per-RHS throughput table (the adaptive-K input)."""
    lines = [
        f"throughput model (schema {rec.get('throughput_schema_version')}"
        f", ewma_alpha={rec.get('ewma_alpha')}, "
        f"platform={rec.get('platform', '?')}):"
    ]
    entries = rec.get("entries") or []
    if not entries:
        lines.append("  (no measured entries)")
    groups = {}
    for e in entries:
        groups.setdefault((e["fingerprint"], e["dtype"]), []).append(e)
    for (fp, dt), es in sorted(groups.items()):
        lines.append(f"  operator {fp} [{dt}]:")
        base = next(
            (e["per_rhs_s_per_it"] for e in es if e["K"] == 1), None
        )
        for e in sorted(es, key=lambda e: e["K"]):
            gain = (
                f"  per-RHS x{base / e['per_rhs_s_per_it']:.2f} vs K=1"
                if base
                else ""
            )
            lines.append(
                f"    K={e['K']:<3d} s_per_it={e['s_per_it']:.6f} "
                f"per_rhs={e['per_rhs_s_per_it']:.6f} "
                f"samples={e['samples']}{gain}"
            )
    ref = rec.get("reference_curve")
    if ref:
        lines.append(
            f"  reference curve ({ref.get('source')}, n={ref.get('n')}, "
            f"device record):"
        )
        for k, v in sorted(
            ref.get("per_rhs_s_per_it", {}).items(), key=lambda t: int(t[0])
        ):
            sp = ref.get("per_rhs_speedup_vs_k1", {}).get(k)
            lines.append(
                f"    K={k:<3s} per_rhs={v:.6f}"
                + (f"  x{sp:.2f} vs K=1" if sp else "")
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the in-process demo (also the --check smoke)
# ---------------------------------------------------------------------------


def _run_demo(device: str):
    """A small drained service on ``device``: admission (and one
    rejection), coalescing, a deadline class, completion, then a second
    wave that carries forecasts (the operator is measured by then)."""
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun
    from partitionedarrays_jl_tpu_torch.service import AdmissionRejected, SolveService

    from . import backend_of

    def driver(parts):
        A, b, xe, x0 = assemble_poisson(parts, (8, 8))
        svc = SolveService(A, kmax=4, queue_depth=4)
        handles = [svc.submit(b, x0=x0, tol=1e-9, deadline=3600.0, tag=f"demo-{i}") for i in range(4)]
        try:  # the 5th overflows the bound: typed backpressure
            svc.submit(b, x0=x0, tol=1e-9, tag="demo-over")
        except AdmissionRejected:
            pass
        profile = svc.queue_profile()
        svc.drain()
        for h in handles:
            h.result()
        h2 = svc.submit(b, x0=x0, tol=1e-9, deadline=3600.0, tag="demo-forecast")
        svc.drain()
        h2.result()
        return svc.fingerprint, profile, dict(svc.stats)

    return prun(driver, backend_of(device), (2, 2))


def check(device: str) -> int:
    """--check: run the demo, assert the metrics plane saw it, render every
    surface once (the gate view over a synthetic gate snapshot, the fleet
    view over an empty fleet directory). Exit nonzero on a broken
    invariant."""
    import tempfile

    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.telemetry import CATALOG

    reg = telemetry.registry()
    base = reg.snapshot()

    def c(name):
        return (base.get("counters") or {}).get(name, 0)

    before = {k: c(k) for k in ("service.admitted", "service.rejected{reason=queue_full}", "service.completed")}
    fingerprint, profile, stats = _run_demo(device)
    snap = reg.snapshot()
    failures = []

    def expect(cond, msg):
        if not cond:
            failures.append(msg)

    counters = snap["counters"]
    expect(counters.get("service.admitted", 0) - before["service.admitted"] == 5,
           "admitted counter must advance by the demo's 5 admissions")
    expect(counters.get("service.rejected{reason=queue_full}", 0) - before["service.rejected{reason=queue_full}"] == 1,
           "the queue_full rejection counter must advance by the demo's 1 overflow")
    expect(counters.get("service.completed", 0) - before["service.completed"] == 5, "completed counter must advance by 5")
    for name in ("spec.predictions", "spec.infeasible", "spec.anomalies", "spec.iters_rel_error"):
        expect(name in CATALOG, f"{name} must be declared in CATALOG")
    expect(counters.get("spec.predictions", 0) >= 1, "the measured-operator wave must stamp a forecast")
    conv = render_conv(snap)
    expect("convergence observatory" in conv, "--conv view must render the observatory table")
    print(conv)
    hists = snap["histograms"]
    for name in ("service.queue_wait_s", "service.total_s", "service.solve_s", "service.slab_wait_s"):
        expect((hists.get(name) or {}).get("count", 0) > 0, f"histogram {name} must have observations")
    expect(any(k.startswith("service.slo.requests{") for k in counters),
           "SLO accounting must tick for the deadline-carrying demo class")
    expect(isinstance(profile, list), "queue_profile must return a list")
    model = telemetry.throughput_model()
    curve = model.curve(fingerprint, "float64")
    curve.update(model.curve(fingerprint, "float32"))
    expect(bool(curve), f"the throughput model must hold a measured entry for the demo operator {fingerprint}")
    print(render_snapshot(snap))
    print()
    print(render_slo(snap))
    print()
    prom = reg.to_prometheus()
    expect("pa_service_total_s_count" in prom, "prometheus export must expose the total-latency histogram")
    json.loads(reg.to_json())
    export = model.export()
    print(render_model(export))
    expect(export.get("throughput_schema_version") == telemetry.THROUGHPUT_SCHEMA_VERSION, "model export schema")
    gate_snap = {"counters": {"gate.evictions": 1, "gate.slo.requests{slo_class=interactive}": 2,
                              "gate.slo.hits{slo_class=interactive}": 1},
                 "gauges": {"gate.mem_budget_bytes": 1e6, "gate.resident_bytes": 5e5,
                            "gate.tenant_resident{tenant=t}": 1, "gate.tenant_footprint_bytes{tenant=t}": 5e5}}
    gate = render_gate(gate_snap)
    expect("tenant t" in gate and "attainment=50.0%" in gate, "--gate view must render tenants and classes")
    print(gate)
    with tempfile.TemporaryDirectory(prefix="pamon-check-") as d:
        expect(render_fleet(_fleet_fetch(d)) == "(fleet dir has no replicas)", "an empty fleet renders as empty")
    for f in failures:
        print(f"pamon --check FAILURE: {f}", file=sys.stderr)
    print("pamon --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="in-process smoke: demo service + invariants")
    ap.add_argument("--demo", action="store_true", help="run the demo service, then render")
    ap.add_argument("--snapshot", metavar="FILE", help="render a registry snapshot JSON export")
    ap.add_argument("--model", metavar="PATH", help="render a throughput model export")
    ap.add_argument("--prom", action="store_true", help="Prometheus text exposition format (with --demo)")
    ap.add_argument("--json", action="store_true", dest="json_", help="raw snapshot JSON")
    ap.add_argument("--slo", action="store_true", help="SLO attainment per tolerance class")
    ap.add_argument("--conv", action="store_true",
                    help="convergence observatory: per-tenant predicted-vs-actual forecast error")
    ap.add_argument("--fleet", metavar="FLEET_DIR", help="per-replica fleet view (--watch for deltas)")
    ap.add_argument("--watch", action="store_true", help="with --snapshot or --fleet: poll and show deltas")
    ap.add_argument("--interval", type=float, default=5.0, help="watch poll seconds (default 5)")
    ap.add_argument("--iterations", type=int, default=0, help="watch iterations (0 = until interrupted)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the demo service (--check, --demo; default cuda)")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.device)
    if args.fleet:
        prev = None
        i = 0
        while True:
            rows = _fleet_fetch(args.fleet)
            if args.watch:
                print(f"--- pamon fleet poll {i} ---")
            print(render_fleet(rows, prev=prev))
            if not args.watch:
                return 0
            prev = rows
            i += 1
            if args.iterations and i >= args.iterations:
                return 0
            time.sleep(args.interval)
    if args.model is not None and not (args.demo or args.snapshot):
        with open(args.model) as f:
            rec = json.load(f)
        print(json.dumps(rec, indent=1, sort_keys=True) if args.json_ else render_model(rec))
        return 0
    snap = None
    if args.demo:
        from partitionedarrays_jl_tpu_torch import telemetry

        _run_demo(args.device)
        reg = telemetry.registry()
        snap = reg.snapshot()
        if args.prom:
            print(reg.to_prometheus())
            return 0
    elif args.snapshot:
        if args.watch:
            prev = None
            i = 0
            while True:
                with open(args.snapshot) as f:
                    snap = json.load(f)
                print(f"--- pamon watch poll {i} ---")
                print(render_snapshot(snap, prev=prev))
                gate = render_gate(snap, prev=prev)
                if gate:
                    print(gate)
                if args.conv:
                    print(render_conv(snap, prev=prev) or "(no forecast observations yet)")
                if args.slo:
                    print(render_slo(snap))
                prev = snap
                i += 1
                if args.iterations and i >= args.iterations:
                    return 0
                time.sleep(args.interval)
        with open(args.snapshot) as f:
            snap = json.load(f)
    else:
        ap.print_help()
        return 2
    if args.json_:
        print(json.dumps(snap, indent=1, sort_keys=True))
    elif args.prom:
        print("pamon: --prom needs --demo (live registry)", file=sys.stderr)
        return 2
    else:
        print(render_snapshot(snap))
        gate = render_gate(snap)
        if gate:
            print(gate)
    if args.conv:
        print(render_conv(snap) or "(no forecast observations yet)")
    if args.slo:
        print(render_slo(snap))
    if args.model is not None:
        with open(args.model) as f:
            print(render_model(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
