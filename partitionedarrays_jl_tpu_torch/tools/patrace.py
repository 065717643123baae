"""patrace — inspect runtime solver telemetry (persisted SolveRecords).

The port's counterpart of the JAX package's ``tools/patrace.py``. It reads
the schema-versioned record JSONs the telemetry layer persists (run with
``telemetry.configure(metrics_dir=DIR)``: every finished or aborted solve
writes one record there) and answers:

* ``--last``        summarize the newest record: solver, config, status,
                    iterations, residual head and tail, the event log and
                    the comms accounting.
* ``--list``        one line per persisted record, oldest first.
* ``--trace OUT``   the newest ``--n`` records (default 8) as one
                    Chrome-trace / Perfetto JSON.
* ``--diff-static`` the comms accounting of every lowering case
                    (`telemetry.comms.lowering_cases`; ``--full`` for all
                    of them) counted against its model: each case's probe
                    solve on ``--device``, its solve function's counted
                    program (``rec.comms_counted``) reconciled with the
                    record's ``comms``. (The JAX package reads its lowered
                    StableHLO here; the port's program is the captured
                    block.)
* ``--phases P``    a phase profile JSON (``paprof --profile OUT``),
                    rendered, or merged into ``--trace`` as its own track.
* ``--service``     the solve service's request records joined into one
                    timeline per slab.
* ``--check``       in-process smoke: probe solves with records into a
                    temporary directory, every leg rendered, the
                    diff-static verdict OK.

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.patrace --last --dir /tmp/rec
    python -m partitionedarrays_jl_tpu_torch.tools.patrace --trace trace.json --dir /tmp/rec
    python -m partitionedarrays_jl_tpu_torch.tools.patrace --diff-static --device cuda
"""
import argparse
import json
import os
import sys


def _load_all(d):
    from partitionedarrays_jl_tpu_torch.telemetry import RECORD_SCHEMA_VERSION, list_persisted_records, load_record

    out = []
    for path in list_persisted_records(d):
        try:
            rec = load_record(path)
        except (OSError, json.JSONDecodeError) as e:
            print(f"patrace: skipping unreadable {path}: {e}", file=sys.stderr)
            continue
        if rec.get("schema_version", 0) > RECORD_SCHEMA_VERSION:
            print(
                f"patrace: {os.path.basename(path)} has newer schema_version {rec.get('schema_version')} (this "
                f"tool speaks {RECORD_SCHEMA_VERSION}) — fields may be missing from the summary",
                file=sys.stderr,
            )
        out.append((path, rec))
    return out


def _fmt_events(rec):
    lines = []
    for ev in rec.get("events") or []:
        it = ev.get("iteration")
        at = f" it={it}" if it is not None else ""
        label = ev.get("label") or ""
        details = ev.get("details") or {}
        extra = ", ".join(
            f"{k}={v}" for k, v in sorted(details.items())
            if k not in ("message",)
        )
        lines.append(
            f"    [{ev.get('t', 0.0):9.4f}s] {ev.get('kind')}"
            f"{':' + label if label else ''}{at}"
            + (f"  ({extra})" if extra else "")
        )
    return lines


def _summarize(path, rec):
    print(f"record: {os.path.basename(path)}")
    print(
        f"  solver={rec.get('solver')} status={rec.get('status')} "
        f"converged={rec.get('converged')} iterations={rec.get('iterations')} "
        f"wall={rec.get('wall_s') if rec.get('wall_s') is None else round(rec['wall_s'], 4)}s"
    )
    cfg = rec.get("config") or {}
    shown = {k: v for k, v in cfg.items() if k != "pa_env"}
    print(f"  config: {json.dumps(shown, sort_keys=True, default=str)}")
    trace = rec.get("trace")
    if trace:
        print(
            f"  trace: {trace.get('trace_id')} "
            f"(span {trace.get('span_id')} — patx "
            f"{trace.get('trace_id')} renders the tree)"
        )
    res = rec.get("residuals") or []
    if res:
        head = ", ".join(f"{v:.3e}" for v in res[:3])
        tail = ", ".join(f"{v:.3e}" for v in res[-2:])
        print(f"  residuals[{len(res)}]: {head} ... {tail}")
    alpha = rec.get("alpha")
    if alpha:
        if isinstance(alpha[0], list):  # block solve: per-column lists
            shape = f"{len(alpha)} columns x {len(alpha[0])} entries"
            n = len(alpha[0])
        else:
            shape = f"{len(alpha)} entries"
            n = len(alpha)
        start = rec.get("trace_start") or 0
        window = f", iterations {start}..{start + n - 1}" if start else ""
        print(f"  alpha/beta trace: {shape} (trace_iters ring{window})")
    else:
        # a body that cannot carry the ring says so with a typed event:
        # surface it, so a missing spectrum is explained
        unavailable = [
            ev for ev in rec.get("events") or []
            if ev.get("kind") == "trace_unavailable"
        ]
        if unavailable:
            ev = unavailable[0]
            det = ev.get("details") or {}
            print(
                f"  alpha/beta trace: UNAVAILABLE — body "
                f"{ev.get('label')!r} (requested depth "
                f"{det.get('requested')}; {det.get('reason', '')})"
            )
    err = rec.get("error")
    if err:
        print(f"  error: {err.get('type')}: {err.get('message')}")
    comms = rec.get("comms")
    if comms:
        print(f"  comms (iterations={comms.get('iterations')}):")
        for kind, v in sorted((comms.get("observed") or {}).items()):
            if v.get("ops"):
                per = (comms.get("per_iteration") or {}).get(kind, {})
                print(
                    f"    {kind}: {v['ops']} ops, {v['bytes']} B "
                    f"({per.get('ops', 0)} ops/it, "
                    f"{per.get('bytes', 0)} B/it per device)"
                )
    events = rec.get("events") or []
    print(f"  events [{len(events)}]:")
    for line in _fmt_events(rec):
        print(line)


def _service_slabs(recs):
    """Group service-request records into slab stories.

    Returns ``[(members, member_recs, events)]`` where ``events`` is the
    deduped, absolute-time-sorted union of the members' event logs.
    Records are joined on the ``requests`` list each non-topped-up
    ``slab_formed`` event carries; an event belongs to a slab when it
    names a member (label, ``details.request``) or the slab itself
    (``details.requests`` overlap). Dedup key is the event's content —
    the same event lands in every record that was active when it fired,
    with per-record relative clocks, so identity must come from WHAT
    happened, not when each record saw it."""
    svc = [
        (path, rec) for path, rec in recs
        if rec.get("solver") == "service-request"
    ]
    by_tag = {}
    for _path, rec in svc:
        tag = (rec.get("config") or {}).get("request")
        if tag is not None:
            by_tag.setdefault(tag, rec)

    # two passes: base slabs first, THEN top-up extensions — records
    # persist at finish time, so a topped-up request that terminated
    # before the founding members files its record (and its
    # topped_up slab_formed event) ahead of the base formation
    slabs = []  # [{"members": set, "order": [tags]}]
    topups = []
    for _path, rec in svc:
        for ev in rec.get("events") or []:
            if ev.get("kind") != "slab_formed":
                continue
            details = ev.get("details") or {}
            tags = list(details.get("requests") or [])
            if not tags:
                continue
            if details.get("topped_up"):
                topups.append(tags)
                continue
            if not any(s["members"] == set(tags) for s in slabs):
                slabs.append({"members": set(tags), "order": tags})
    for tags in topups:
        for s in slabs:  # extend the slab the arrivals joined
            if s["members"] & set(tags):
                for t in tags:
                    if t not in s["members"]:
                        s["members"].add(t)
                        s["order"].append(t)
                break

    out = []
    for s in slabs:
        members = s["members"]
        member_recs = [
            (t, by_tag[t]) for t in s["order"] if t in by_tag
        ]
        seen = {}
        unnamed = {}
        continuation = {}
        t_form = None
        for tag, rec in member_recs:
            t0 = rec.get("started_at") or 0.0
            for ev in rec.get("events") or []:
                details = ev.get("details") or {}
                abs_t = t0 + (ev.get("t") or 0.0)
                key = (
                    ev.get("kind"), ev.get("label"),
                    json.dumps(details, sort_keys=True, default=str),
                )
                named = (
                    ev.get("label") in members
                    or details.get("request") in members
                    or bool(set(details.get("requests") or []) & members)
                )
                if not named:
                    # column_verdict carries column INDICES, not tags —
                    # window it into the slab below (a member's record
                    # can hold an EARLIER slab's verdicts from its
                    # queued phase; those predate this slab's formation)
                    if ev.get("kind") == "column_verdict":
                        if key not in unnamed or abs_t < unnamed[key][0]:
                            unnamed[key] = (abs_t, ev)
                    # solo-retry CONTINUATION events (the nested solve
                    # of an ejected member: faults, health errors,
                    # aborted attempts, recovery restarts) don't name
                    # the request — window them into the member's
                    # ejection->terminal interval below instead of
                    # silently dropping the retry story
                    elif ev.get("kind") in _CONTINUATION_KINDS:
                        # per-attempt identity: the iteration joins the
                        # key (two columns' otherwise-identical typed
                        # errors are two attempts, not one event)
                        ckey = key + (ev.get("iteration"),)
                        if ckey not in continuation or abs_t < (
                            continuation[ckey][0]
                        ):
                            continuation[ckey] = (abs_t, ev)
                    continue
                if ev.get("kind") == "slab_formed" and not details.get(
                    "topped_up"
                ):
                    t_form = abs_t if t_form is None else min(t_form,
                                                              abs_t)
                if key not in seen or abs_t < seen[key][0]:
                    seen[key] = (abs_t, ev)
        for key, (abs_t, ev) in unnamed.items():
            if t_form is None or abs_t >= t_form - 1e-3:
                seen.setdefault(key, (abs_t, ev))
        t_last = _last_terminal(member_recs)
        for key, (abs_t, ev) in continuation.items():
            # inside the slab's life: formation .. last member terminal
            if t_form is not None and abs_t < t_form - 1e-3:
                continue
            if t_last is not None and abs_t > t_last + 1e-3:
                continue
            owner = _retry_window_owner(member_recs, abs_t)
            if owner is not None:
                ev = dict(ev)
                ev["details"] = dict(
                    ev.get("details") or {}, retry_of=owner
                )
            seen.setdefault(key, (abs_t, ev))
        events = sorted(seen.values(), key=lambda kv: kv[0])
        out.append((s["order"], member_recs, events))
    return out


#: Event kinds a member's solo retry (or its recovery ladder) emits
#: WITHOUT naming the request — joined into the slab view by their
#: ejection-window timing (`_retry_window_owner`), so a slab whose
#: requests were all ejected still shows each retry's story.
_CONTINUATION_KINDS = (
    "fault_injected", "health_error", "solve_aborted", "restart",
    "checkpoint_save", "checkpoint_restore", "sdc_detection",
    "sdc_rollback", "sdc_escalation",
)


def _last_terminal(member_recs):
    """Latest request_done/request_failed time across the members."""
    t_last = None
    for tag, rec in member_recs:
        t0 = rec.get("started_at") or 0.0
        for ev in rec.get("events") or []:
            if (
                ev.get("kind") in ("request_done", "request_failed")
                and ev.get("label") == tag
            ):
                at = t0 + (ev.get("t") or 0.0)
                t_last = at if t_last is None else max(t_last, at)
    return t_last


def _retry_window_owner(member_recs, abs_t):
    """The member whose ejection->terminal window contains ``abs_t``
    (windows are sequential — the verdict loop retries one ejected
    column at a time — so the nearest preceding ejection wins)."""
    best = None
    for tag, rec in member_recs:
        t0 = rec.get("started_at") or 0.0
        t_eject = None
        t_term = None
        for ev in rec.get("events") or []:
            details = ev.get("details") or {}
            at = t0 + (ev.get("t") or 0.0)
            if (
                ev.get("kind") == "column_ejected"
                and details.get("request") == tag
                and t_eject is None
            ):
                t_eject = at
            if (
                ev.get("kind") in ("request_done", "request_failed")
                and ev.get("label") == tag
            ):
                t_term = at
        if t_eject is None or abs_t < t_eject - 1e-3:
            continue
        if t_term is not None and abs_t > t_term + 1e-3:
            continue
        if best is None or t_eject > best[0]:
            best = (t_eject, tag)
    return best[1] if best is not None else None


def _service_timeline(recs) -> int:
    """--service: print one joined timeline per slab."""
    slabs = _service_slabs(recs)
    if not slabs:
        print(
            "patrace --service: no service-request records found "
            "(submit through SolveService with telemetry.configure(metrics_dir=...) set)",
            file=sys.stderr,
        )
        return 1
    for i, (members, member_recs, events) in enumerate(slabs):
        print(f"slab {i}: K={len(members)} requests: "
              + ", ".join(members))
        t0 = events[0][0] if events else 0.0
        for abs_t, ev in events:
            label = ev.get("label") or ""
            it = ev.get("iteration")
            at = f" it={it}" if it is not None else ""
            details = ev.get("details") or {}
            extra = ", ".join(
                f"{k}={v}" for k, v in sorted(details.items())
                if k not in ("message",)
            )
            print(
                f"    [{abs_t - t0:9.4f}s] {ev.get('kind')}"
                f"{':' + label if label else ''}{at}"
                + (f"  ({extra})" if extra else "")
            )
        outcomes = []
        for tag, rec in member_recs:
            if rec.get("status") == "raised":
                err = (rec.get("error") or {}).get("type", "error")
                outcomes.append(f"{tag} FAILED({err})")
            else:
                outcomes.append(
                    f"{tag} {rec.get('status') or 'done'}"
                    f"(it={rec.get('iterations')})"
                )
        print("  outcomes: " + "; ".join(outcomes))
    return 0


def diff_static(device: str, full: bool = False) -> int:
    """--diff-static: every lowering case's probe solve on ``device``, its
    counted program reconciled with its record's model accounting."""
    from partitionedarrays_jl_tpu_torch.telemetry import comms

    from . import backend_of

    backend = backend_of(device)
    failed = False
    for case in comms.lowering_cases(fast=not full):
        rec, _info = comms.case_probe_solve(backend, case)
        mismatches = comms.reconcile(rec.comms_counted, rec.comms)
        print(f"  {case['name']:26s} it={rec.comms.get('iterations', '?'):>3} counted-vs-model: "
              f"{'OK' if not mismatches else 'MISMATCH'}")
        for m in mismatches:
            print(f"      {m}")
            failed = True
    print("patrace --diff-static:", "FAILED" if failed else "OK")
    return 1 if failed else 0


def check(device: str) -> int:
    """--check: probe solves persisted into a temporary directory, then
    every leg: --list, --last (with its comms block), --trace, --service's
    refusal on records that hold no service request, --diff-static."""
    import contextlib
    import io
    import tempfile

    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.telemetry import comms

    from . import backend_of

    failures = []

    def expect(cond, msg):
        if not cond:
            failures.append(msg)

    backend = backend_of(device)
    with tempfile.TemporaryDirectory(prefix="patrace-check-") as d:
        with telemetry.configure(metrics_dir=d):
            for name in ("fused", "standard_nobox"):
                case = next(c for c in comms.lowering_cases() if c["name"] == name)
                comms.case_probe_solve(backend, case)
        recs = _load_all(d)
        expect(len(recs) >= 2, f"want 2 persisted records, found {len(recs)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_last = main(["--last", "--dir", d])
            rc_list = main(["--list", "--dir", d])
            rc_trace = main(["--trace", os.path.join(d, "trace.json"), "--dir", d])
        text = out.getvalue()
        print(text)
        expect(rc_last == rc_list == rc_trace == 0, f"legs exited {rc_last}, {rc_list}, {rc_trace}")
        expect("comms (iterations=" in text and "collective_permute" in text,
               "--last must render the record's comms accounting")
        with open(os.path.join(d, "trace.json")) as f:
            expect(bool(json.load(f).get("traceEvents")), "--trace wrote no events")
        expect(main(["--service", "--dir", d]) == 1, "--service must refuse records that hold no service request")
    expect(diff_static(device) == 0, "--diff-static found a mismatch")
    for f in failures:
        print(f"patrace --check FAILURE: {f}", file=sys.stderr)
    print("patrace --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", help="record directory (the run's telemetry metrics_dir)")
    ap.add_argument("--last", action="store_true", help="summarize the newest record")
    ap.add_argument("--list", action="store_true", dest="list_", help="list persisted records")
    ap.add_argument("--json", action="store_true", help="with --last: dump the raw record JSON")
    ap.add_argument("--trace", metavar="OUT", help="write newest --n records as Chrome-trace JSON")
    ap.add_argument("--n", type=int, default=8, help="record count for --trace (default 8)")
    ap.add_argument("--phases", metavar="PROFILE", help="phase profile JSON to merge into --trace (or render)")
    ap.add_argument("--iterations", type=int, default=4, help="synthetic iterations for --phases spans (default 4)")
    ap.add_argument("--diff-static", action="store_true",
                    help="probe-solve the lowering cases and reconcile each counted program with its model")
    ap.add_argument("--full", action="store_true", help="with --diff-static: every lowering case")
    ap.add_argument("--service", action="store_true", help="join service-request records into per-slab timelines")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the probe solves (--diff-static, --check; default cuda)")
    ap.add_argument("--check", action="store_true", help="in-process smoke of every leg")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.device)
    if args.diff_static:
        return diff_static(args.device, args.full)

    phase_profile = None
    if args.phases:
        from partitionedarrays_jl_tpu_torch.telemetry import PHASE_SCHEMA_VERSION, render_phase_profile

        with open(args.phases) as f:
            phase_profile = json.load(f)
        if phase_profile.get("phase_schema_version") != PHASE_SCHEMA_VERSION:
            print(f"patrace: {args.phases} has phase_schema_version {phase_profile.get('phase_schema_version')!r} "
                  f"(this tool speaks {PHASE_SCHEMA_VERSION})", file=sys.stderr)
            return 2
        if not args.trace:
            print(render_phase_profile(phase_profile))
            if not (args.last or args.list_ or args.service):
                return 0

    if not (args.last or args.list_ or args.trace or args.service):
        ap.print_help()
        return 2

    if args.trace and phase_profile is not None and not args.dir:
        from partitionedarrays_jl_tpu_torch.telemetry import phase_trace_events, write_chrome_trace

        write_chrome_trace(args.trace, extra_events=phase_trace_events(phase_profile, iterations=args.iterations))
        print(f"wrote {args.trace} (phase profile only)")
        return 0

    if not args.dir:
        print("patrace: no record directory — pass --dir (records persist only where the run configured "
              "telemetry's metrics_dir)", file=sys.stderr)
        return 2
    recs = _load_all(args.dir)
    if not recs:
        print(f"patrace: no records under {args.dir}", file=sys.stderr)
        return 1
    if args.service:
        return _service_timeline(recs)
    if args.list_:
        for path, rec in recs:
            print(f"{os.path.basename(path)}  {str(rec.get('solver')):>20s}  status={rec.get('status')}  "
                  f"it={rec.get('iterations')}  events={len(rec.get('events') or [])}")
    if args.last:
        path, rec = recs[-1]
        if args.json:
            print(json.dumps(rec, indent=1, sort_keys=True))
        else:
            _summarize(path, rec)
    if args.trace:
        from partitionedarrays_jl_tpu_torch.telemetry import phase_trace_events, write_chrome_trace

        newest = [rec for _, rec in recs[-max(1, args.n):]]
        extra = phase_trace_events(phase_profile, iterations=args.iterations) if phase_profile is not None else None
        write_chrome_trace(args.trace, records=newest, extra_events=extra)
        print(f"wrote {args.trace} ({len(newest)} records{' + phase profile' if extra else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
