"""paspec — the convergence observatory: CG–Lanczos spectral estimates
from the α/β ring, iterations-to-tolerance forecasts and the
deadline-feasibility verdict.

The port's counterpart of the JAX package's ``tools/paspec.py``, the
console of `telemetry.spectrum`:

* ``--last`` / ``--list``  the Lanczos tridiagonal of a persisted record's
                           α/β ring (``--dir``, as patrace): extremal Ritz
                           values, κ̂, the measured rate; where the ring is
                           missing, the typed ``trace_unavailable`` reason.
* ``--forecast TOL``       with ``--last``: iterations to TOL from the
                           record's own estimate.
* ``--store`` / ``--suggest-s``  a spectrum store export (``--spectrum
                           PATH``, as ``--write`` writes): its entries, and
                           the s-step depth (``sstep=``) each would take.
* ``--check``              the probe (8^3 Poisson on (2, 2, 2) parts) solved
                           on ``--device`` with the trace ring on: κ̂ within
                           its band of the analytic value, the forecaster
                           against the actual iterations at three
                           tolerances, and the admission leg (a typed
                           `DeadlineInfeasible`, zero iterations spent).
* ``--write PATH``         the probe's store export with its bands, to PATH
                           (no default: the JAX package's committed
                           ``SPECTRUM.json`` is its own).

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.paspec --check --device cpu
    python -m partitionedarrays_jl_tpu_torch.tools.paspec --last --dir /tmp/rec --forecast 1e-8
"""
import argparse
import json
import os
import sys

#: The canonical probe: the conformance Poisson FDM operator whose
#: interior spectrum is analytic (`poisson_fdm_analytic_extremes`).
PROBE_NS = (8, 8, 8)
PROBE_PARTS = (2, 2, 2)
PROBE_TRAIN_TOL = 1e-9
PROBE_MAXITER = 200
PROBE_TRACE = 256
#: The forecast's validation tolerances (three pairs of operator and
#: tolerance).
FORECAST_TOLS = (1e-4, 1e-6, 1e-8)

#: The bands (the JAX package's):
#: Ritz estimates converge from INSIDE the spectrum, so κ̂/κ_analytic
#: approaches 1 from below — the band admits an under-resolved λmax on
#: a fast-converging probe and refuses a broken reconstruction.
KAPPA_RATIO_BAND = (0.5, 1.05)
#: Max allowed |predicted − actual|/actual over the validation pairs.
FORECAST_REL_ERROR_MAX = 0.5


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def render_estimate(est, forecast_tol=None, r0_norm=None):
    if est is None:
        return "  (no usable alpha/beta ring or residual history)"
    lines = []
    if est.get("lam_min") is not None:
        lines.append(
            f"  ritz extremes: [{est['lam_min']:.6g}, "
            f"{est['lam_max']:.6g}]  (k={est['ritz_k']})"
        )
        if est.get("kappa") is not None:
            lines.append(f"  kappa estimate: {est['kappa']:.6g}")
        else:
            lines.append("  kappa estimate: — (indefinite Ritz interval)")
    else:
        lines.append("  ritz extremes: — (no alpha/beta ring)")
    if est.get("rate") is not None:
        lines.append(
            f"  measured rate: {est['rate']:.6g} per iteration "
            f"({est['iterations']} iterations)"
        )
    if forecast_tol is not None:
        from partitionedarrays_jl_tpu_torch import telemetry

        spec = {
            "kappa": est.get("kappa"), "rate": est.get("rate"),
            "samples": 1,
        }
        pred = telemetry.predict_iters(
            spec, forecast_tol, r0_norm=r0_norm
        )
        lines.append(
            f"  forecast: {pred} iterations to tol={forecast_tol:g}"
            + ("" if r0_norm is None else f" (|r0|={r0_norm:.3g})")
        )
    return "\n".join(lines)


def summarize_record(path, rec):
    from partitionedarrays_jl_tpu_torch import telemetry

    print(f"record: {os.path.basename(path)}")
    print(
        f"  solver={rec.get('solver')} status={rec.get('status')} "
        f"iterations={rec.get('iterations')}"
    )
    alpha, beta = rec.get("alpha"), rec.get("beta")
    unavailable = [
        ev for ev in rec.get("events") or []
        if ev.get("kind") == "trace_unavailable"
    ]
    if not alpha and unavailable:
        ev = unavailable[0]
        print(
            f"  alpha/beta ring: UNAVAILABLE — body "
            f"{ev.get('label')!r} cannot carry it "
            f"({(ev.get('details') or {}).get('reason', '')})"
        )
    # a wrapped ring is a TRAILING window: trace_start keys the
    # submatrix reconstruction (see lanczos_tridiagonal)
    start = int(rec.get("trace_start") or 0)
    if alpha and isinstance(alpha[0], list):  # block record: K columns
        # per-column residual histories are not persisted (only the
        # worst column's) — per-column estimates are ring-only here
        for k in range(len(alpha)):
            est = telemetry.estimate_solve(
                alpha[k], beta[k] if beta else [], None,
                trace_start=start,
            )
            print(f"  column {k}:")
            print(render_estimate(est))
        return
    est = telemetry.estimate_solve(
        alpha, beta, rec.get("residuals"), trace_start=start
    )
    print(render_estimate(est))


def render_store(store_rec):
    lines = [
        f"spectrum store (schema "
        f"{store_rec.get('spectrum_schema_version')}, "
        f"ewma_alpha={store_rec.get('ewma_alpha')}):"
    ]
    entries = store_rec.get("entries") or []
    if not entries:
        lines.append("  (no measured entries)")
    for e in entries:
        kap = e.get("kappa")
        rate = e.get("rate")
        lines.append(
            f"  {e['fingerprint']} [{e['dtype']}, minv={e['minv_class']}]"
            f" kappa={'—' if kap is None else f'{kap:.6g}'}"
            f" rate={'—' if rate is None else f'{rate:.6g}'}"
            f" samples={e['samples']}"
        )
    return "\n".join(lines)


def render_suggest_s(store_rec, tol):
    """One policy row per stored spectrum entry: the chosen
    ``sstep`` depth, the κ̂/precision-budget arithmetic that
    chose it, and the forecasted collective win at ``tol``."""
    from partitionedarrays_jl_tpu_torch import telemetry

    lines = [
        f"s-step depth policy (sstep suggestion, "
        f"s_max={telemetry.SSTEP_MAX}, forecast tol={tol:g}):"
    ]
    entries = store_rec.get("entries") or []
    if not entries:
        lines.append(
            "  (no measured entries — unmeasured operators default to "
            "the always-safe s=1)"
        )
    policies = []
    for e in entries:
        spec = {
            "kappa": e.get("kappa"), "rate": e.get("rate"),
            "samples": e.get("samples", 1),
        }
        pol = telemetry.suggest_s(spec, e["dtype"], tol=tol)
        pol["fingerprint"] = e["fingerprint"]
        pol["minv_class"] = e["minv_class"]
        policies.append(pol)
        kap = pol["kappa"]
        fc = pol.get("forecast") or {}
        win = (
            "win unforecast (no measured rate/kappa)"
            if fc.get("predicted_iters") is None
            else (
                f"forecast {fc['predicted_iters']} its: "
                f"{fc['standard_gathers']} scalar gathers -> "
                f"{fc['sstep_gathers']} block gathers "
                f"({pol['gather_factor']}x fewer collectives)"
            )
        )
        lines.append(
            f"  {e['fingerprint']} [{e['dtype']}, "
            f"minv={e['minv_class']}]: s={pol['s']} "
            f"({pol['policy']}; "
            f"kappa={'—' if kap is None else f'{kap:.6g}'}, "
            f"budget kappa^s <= {pol['budget']:.3g}); {win}"
        )
    return "\n".join(lines), policies




def suggest_s_cmd(path, tol, json_=False) -> int:
    with open(path) as f:
        rec = json.load(f)
    text, policies = render_suggest_s(rec, tol)
    print(json.dumps(policies, indent=1, sort_keys=True) if json_ else text)
    return 0


# ---------------------------------------------------------------------------
# the probe (shared by --check and --write)
# ---------------------------------------------------------------------------


def run_probe(device: str) -> dict:
    """The probe solved on ``device`` with the trace ring on (depth
    PROBE_TRACE, the whole recurrence): the measurement dict the checks
    and the written store both read."""
    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun
    from partitionedarrays_jl_tpu_torch.parallel.gpu import gpu_cg

    from . import backend_of

    def probe(parts):
        A, b, xe, x0 = assemble_poisson(parts, PROBE_NS)
        return A, b, x0

    A, b, x0 = prun(probe, backend_of(device), PROBE_PARTS)
    telemetry.reset_store()
    fp = telemetry.spectrum_fingerprint(A)
    dt = "float64"

    def solve(tol):
        _x, info = gpu_cg(A, b, x0=x0, tol=tol, maxiter=PROBE_MAXITER, trace_iters=PROBE_TRACE)
        return dict(info), info.record.alpha, info.record.beta

    info, alpha, beta = solve(PROBE_TRAIN_TOL)
    est = telemetry.estimate_solve(alpha, beta, info["residuals"])
    spec = telemetry.spectrum_store().spec(fp, dt, "none")
    lo, hi = telemetry.poisson_fdm_analytic_extremes(PROBE_NS)
    forecast = []
    for tol in FORECAST_TOLS:
        vinfo, _, _ = solve(tol)
        r0 = float(vinfo["residuals"][0])
        pred = telemetry.predict_iters(spec, tol, r0_norm=r0)
        actual = int(vinfo["iterations"])
        forecast.append({"tol": tol, "predicted": pred, "actual": actual,
                         "rel_error": None if pred is None else round(abs(pred - actual) / max(1, actual), 6)})
    return {
        "fingerprint": fp, "dtype": dt, "minv_class": "none",
        "train_info": {"iterations": int(info["iterations"]), "converged": bool(info["converged"]),
                       "tol": PROBE_TRAIN_TOL},
        "estimate": est, "spec": spec, "analytic": {"lam_min": lo, "lam_max": hi, "kappa": hi / lo},
        "forecast": forecast, "store_export": telemetry.spectrum_store().export(),
    }


def probe_failures(m):
    """Invariant checks over one probe measurement (shared by --check
    and the committed-artifact bands)."""
    failures = []
    est = m["estimate"]
    if est is None or est.get("kappa") is None:
        failures.append("probe solve yielded no kappa estimate")
        return failures, None, None
    ratio = est["kappa"] / m["analytic"]["kappa"]
    if not (KAPPA_RATIO_BAND[0] <= ratio <= KAPPA_RATIO_BAND[1]):
        failures.append(
            f"kappa ratio {ratio:.4f} outside the documented band "
            f"{KAPPA_RATIO_BAND} (estimated {est['kappa']:.4f} vs "
            f"analytic {m['analytic']['kappa']:.4f})"
        )
    # the Ritz interval must lie INSIDE the analytic spectrum (up to
    # rounding) — converging from inside is the structural property
    if est["lam_min"] < 0.99 * m["analytic"]["lam_min"]:
        failures.append(
            f"ritz lam_min {est['lam_min']:.6g} below the analytic "
            f"minimum {m['analytic']['lam_min']:.6g}"
        )
    if est["lam_max"] > 1.01 * m["analytic"]["lam_max"]:
        failures.append(
            f"ritz lam_max {est['lam_max']:.6g} above the analytic "
            f"maximum {m['analytic']['lam_max']:.6g}"
        )
    errs = [f["rel_error"] for f in m["forecast"]]
    if any(e is None for e in errs):
        failures.append("forecaster returned None on a measured spec")
        return failures, ratio, None
    worst = max(errs)
    if worst > FORECAST_REL_ERROR_MAX:
        failures.append(
            f"worst forecast rel_error {worst:.3f} > "
            f"{FORECAST_REL_ERROR_MAX} over {m['forecast']}"
        )
    preds = [f["predicted"] for f in m["forecast"]]
    if preds != sorted(preds):
        failures.append(
            f"forecast not monotone in tol: {m['forecast']}"
        )
    return failures, ratio, worst


def _feasibility_demo(failures, device: str):
    """The admission leg of --check: a trained service on ``device``
    refuses an infeasible deadline typed (`DeadlineInfeasible`), with no
    admission and no slab, under ``spec_admit``, and admits a generous
    one."""
    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun
    from partitionedarrays_jl_tpu_torch.service import SolveService
    from partitionedarrays_jl_tpu_torch.utils.health import DeadlineInfeasible

    from . import backend_of

    def driver(parts):
        A, b, xe, x0 = assemble_poisson(parts, (8, 8))
        svc = SolveService(A, kmax=2)
        h = svc.submit(b, x0=x0, tol=1e-9, tag="spec-train")
        svc.drain()
        h.result()
        admitted0, slabs0 = svc.stats["admitted"], svc.stats["slabs"]
        inf0 = telemetry.registry().counter_value("spec.infeasible")
        with telemetry.configure(spec_admit=True):
            try:
                svc.submit(b, x0=x0, tol=1e-9, deadline=1e-9, tag="spec-doomed")
                failures.append("an infeasible deadline was admitted under spec_admit")
            except DeadlineInfeasible as e:
                d = e.diagnostics
                if not (d.get("predicted_s") is not None and d.get("available_s") is not None
                        and d["predicted_s"] > d["available_s"]):
                    failures.append(f"DeadlineInfeasible diagnostics incomplete: {d}")
            if svc.stats["admitted"] != admitted0 or svc.stats["slabs"] != slabs0:
                failures.append("the infeasible refusal leaked work into the service (admitted/slab counters moved)")
            if telemetry.registry().counter_value("spec.infeasible") != inf0 + 1:
                failures.append("spec.infeasible counter did not tick")
            h2 = svc.submit(b, x0=x0, tol=1e-9, deadline=3600.0, tag="spec-fine")
            svc.drain()
            if not h2.result()[1]["converged"]:
                failures.append("the feasible request failed to converge")
        return True

    prun(driver, backend_of(device), (2, 2))


def check(device: str) -> int:
    from partitionedarrays_jl_tpu_torch import telemetry

    m = run_probe(device)
    failures, ratio, worst = probe_failures(m)
    print(render_store(m["store_export"]))
    print(render_estimate(m["estimate"]))
    print(f"  analytic kappa {m['analytic']['kappa']:.4f}  ratio {'—' if ratio is None else f'{ratio:.4f}'} "
          f"(band {KAPPA_RATIO_BAND})")
    for f in m["forecast"]:
        print(f"  forecast tol={f['tol']:g}: predicted={f['predicted']} actual={f['actual']} "
              f"rel_error={f['rel_error']}")
    n_before = len(failures)
    _feasibility_demo(failures, device)
    print("  feasibility verdict: typed DeadlineInfeasible refusal, zero iterations spent"
          if len(failures) == n_before else "  feasibility verdict: FAILED")
    for name in ("spec.predictions", "spec.infeasible", "spec.anomalies", "spec.iters_rel_error"):
        if name not in telemetry.CATALOG:
            failures.append(f"{name} missing from the metric CATALOG")
    for f in failures:
        print(f"paspec --check FAILURE: {f}", file=sys.stderr)
    print("paspec --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def write_artifact(path: str, device: str, dry_run: bool = False) -> int:
    from partitionedarrays_jl_tpu_torch import telemetry

    from . import refuse_root_artifact

    refuse_root_artifact(path)
    m = run_probe(device)
    failures, ratio, worst = probe_failures(m)
    est = m["estimate"]
    if est is None or est.get("kappa") is None:
        for f in failures:
            print(f"paspec --write FAILURE: {f}", file=sys.stderr)
        return 1
    rec = dict(m["store_export"])
    rec.update({
        "probe": {"model": "poisson_fdm", "ns": list(PROBE_NS), "parts": list(PROBE_PARTS),
                  "train_tol": PROBE_TRAIN_TOL, "maxiter": PROBE_MAXITER, "trace_iters": PROBE_TRACE,
                  "forecast_tols": list(FORECAST_TOLS), "device": device},
        "conformance": {
            "fingerprint": m["fingerprint"], "dtype": m["dtype"], "minv_class": m["minv_class"],
            "train_iterations": m["train_info"]["iterations"], "analytic_lam_min": m["analytic"]["lam_min"],
            "analytic_lam_max": m["analytic"]["lam_max"], "analytic_kappa": m["analytic"]["kappa"],
            "estimated_lam_min": est["lam_min"], "estimated_lam_max": est["lam_max"],
            "estimated_kappa": est["kappa"], "measured_rate": est["rate"],
        },
        "forecast": m["forecast"],
        "bands": {
            "spectrum_kappa_ratio": {
                "kind": "structural", "lo": KAPPA_RATIO_BAND[0], "hi": KAPPA_RATIO_BAND[1],
                "measured": None if ratio is None else round(ratio, 6),
                "in_band": None if ratio is None else bool(KAPPA_RATIO_BAND[0] <= ratio <= KAPPA_RATIO_BAND[1]),
            },
            "spectrum_forecast_rel_error_max": {
                "kind": "structural", "lo": 0.0, "hi": FORECAST_REL_ERROR_MAX,
                "measured": None if worst is None else round(worst, 6),
                "in_band": None if worst is None else bool(worst <= FORECAST_REL_ERROR_MAX),
            },
        },
    })
    telemetry.write(path, rec, tool="paspec", dry_run=dry_run)
    for f in failures:
        print(f"paspec --write FAILURE: {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="the probe: kappa band, forecast, feasibility verdict")
    ap.add_argument("--write", metavar="PATH", help="write the probe's spectrum store export to PATH")
    ap.add_argument("--dry-run", action="store_true", help="with --write: print instead of writing")
    ap.add_argument("--last", action="store_true", help="spectral summary of the newest persisted record")
    ap.add_argument("--list", action="store_true", dest="list_", help="one ring-availability line per record")
    ap.add_argument("--store", action="store_true", help="render the --spectrum store export")
    ap.add_argument("--suggest-s", action="store_true", dest="suggest_s",
                    help="the s-step depth policy per entry of the --spectrum store (--forecast TOL, default 1e-8)")
    ap.add_argument("--spectrum", metavar="PATH", help="a spectrum store export (--write's output)")
    ap.add_argument("--forecast", type=float, metavar="TOL", help="with --last: iterations-to-TOL forecast")
    ap.add_argument("--dir", help="records directory (the run's telemetry metrics_dir)")
    ap.add_argument("--json", action="store_true", dest="json_", help="raw JSON output where applicable")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the probe (--check, --write; default cuda)")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.device)
    if args.write is not None:
        return write_artifact(args.write, args.device, dry_run=args.dry_run)
    if args.suggest_s or args.store:
        if not args.spectrum:
            print("paspec: --store and --suggest-s read a store export: pass --spectrum PATH", file=sys.stderr)
            return 2
        if args.suggest_s:
            return suggest_s_cmd(args.spectrum, args.forecast if args.forecast is not None else 1e-8, args.json_)
        with open(args.spectrum) as f:
            rec = json.load(f)
        print(json.dumps(rec, indent=1, sort_keys=True) if args.json_ else render_store(rec))
        return 0
    if args.last or args.list_:
        from partitionedarrays_jl_tpu_torch import telemetry

        if not args.dir:
            print("paspec: pass --dir", file=sys.stderr)
            return 2
        paths = telemetry.list_persisted_records(args.dir)
        if not paths:
            print(f"paspec: no records in {args.dir}", file=sys.stderr)
            return 2
        if args.list_:
            for p in paths:
                rec = telemetry.load_record(p)
                avail = ("ring" if rec.get("alpha") else "unavailable" if any(
                    ev.get("kind") == "trace_unavailable" for ev in rec.get("events") or []) else "no-ring")
                print(f"{os.path.basename(p)}  solver={rec.get('solver')} it={rec.get('iterations')} trace={avail}")
            return 0
        rec = telemetry.load_record(paths[-1])
        summarize_record(paths[-1], rec)
        if args.forecast is not None:
            est = telemetry.estimate_solve(rec.get("alpha"), rec.get("beta"), rec.get("residuals"),
                                           trace_start=int(rec.get("trace_start") or 0))
            res = rec.get("residuals") or []
            print(render_estimate(est, forecast_tol=args.forecast,
                                  r0_norm=res[0] if res else None).splitlines()[-1])
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
