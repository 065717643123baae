"""patx — end-to-end request traces (span trees).

The port's counterpart of the JAX package's ``tools/patx.py``. It reads the
per-process span JSONL the tracing plane persists (run the serving process
with ``telemetry.configure(tracing_dir=DIR)``) and answers where one
request's time went: HTTP ingress, the gate's queue, a page-in, the slab
and its chunks.

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.patx <trace_id> --dir /tmp/tx   # render the tree
    python -m partitionedarrays_jl_tpu_torch.tools.patx --list --dir /tmp/tx       # all traces
    python -m partitionedarrays_jl_tpu_torch.tools.patx --slow 5 --dir /tmp/tx     # worst 5 by total
    python -m partitionedarrays_jl_tpu_torch.tools.patx <trace_id> --trace out.json --dir /tmp/tx
    python -m partitionedarrays_jl_tpu_torch.tools.patx <trace_id> --phases prof.json --dir /tmp/tx
        # solver.phase spans under each slab.solve: a phase profile's
        # per-iteration shares of the slab's wall time
    python -m partitionedarrays_jl_tpu_torch.tools.patx --check --device cpu
        # an ephemeral gate over HTTP on the device, its spans rebuilt,
        # the span-tree invariants asserted, a profile mounted

The Perfetto export (``--trace``) writes spans as complete events and FLOW
arrows along every parent -> child edge, on the timeline ``patrace
--trace`` uses.
"""
import argparse
import json
import sys


def _load(d):
    from partitionedarrays_jl_tpu_torch.telemetry import tracing

    if not d:
        print("patx: no span directory — pass --dir (spans persist only where the serving process configured "
              "telemetry's tracing_dir)", file=sys.stderr)
        return None
    spans = tracing.load_spans(d)
    if not spans:
        print(f"patx: no spans under {d}", file=sys.stderr)
        return None
    return spans


def _mount_phases(spans, path):
    from partitionedarrays_jl_tpu_torch.telemetry import tracing

    with open(path) as f:
        profile = json.load(f)
    added = tracing.mount_phase_spans(spans, profile)
    if not added:
        print(f"patx: {path} holds no positive phase attribution — nothing mounted", file=sys.stderr)
    return spans + added


def _list(spans, slow=None):
    from partitionedarrays_jl_tpu_torch.telemetry import tracing

    rows = [
        tracing.trace_summary(spans, tid)
        for tid in tracing.trace_ids(spans)
    ]
    if slow is not None:
        rows.sort(key=lambda r: -r["total_s"])
        rows = rows[:slow]
    print(f"{'trace_id':32s}  {'spans':>5s}  {'total':>10s}  dominant")
    for r in rows:
        mark = " [interrupted]" if r["interrupted"] else ""
        print(
            f"{r['trace_id']:32s}  {r['spans']:5d}  "
            f"{r['total_s'] * 1e3:8.2f}ms  {r['dominant']}{mark}"
        )
    return 0


def check(device: str) -> int:
    """--check: an ephemeral HTTP gate on ``device`` serves two requests
    (one with a client-minted traceparent), the persisted spans rebuild
    into one tree a request (rpc.request -> gate.queue, slab.solve ->
    chunk), and a phase profile mounts under every slab.solve."""
    import tempfile

    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.frontdoor import Gate, http_solve, serve_gate
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson, gather_pvector
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun
    from partitionedarrays_jl_tpu_torch.telemetry import tracing

    from . import backend_of

    failures = []

    def expect(cond, msg):
        if not cond:
            failures.append(msg)

    def driver(parts):
        A, b, xe, x0 = assemble_poisson(parts, (8, 8))
        return A, b, x0

    A, b, x0 = prun(driver, backend_of(device), (2, 2))
    with tempfile.TemporaryDirectory(prefix="patx-check-") as txd:
        with telemetry.configure(tracing=True, tracing_dir=txd):
            gate = Gate(start_workers=True)
            gate.register("t", A, kmax=2)
            srv = serve_gate(gate, port=0)
            try:
                bg, x0g = gather_pvector(b), gather_pvector(x0)
                tp = tracing.mint_trace().traceparent()
                out1 = http_solve(srv.url, "t", bg, x0=x0g, tol=1e-9, tag="patx-1", traceparent=tp)
                out2 = http_solve(srv.url, "t", bg, x0=x0g, tol=1e-9, tag="patx-2")
                expect(out1["state"] == "done", f"solve 1 failed: {out1}")
                expect(out2["state"] == "done", f"solve 2 failed: {out2}")
                expect(out1.get("trace_id") == tp.split("-")[1],
                       f"the client's traceparent trace_id must be joined, not replaced ({out1.get('trace_id')})")
                expect(bool(out2.get("trace_id")), "a submit without traceparent must get a minted trace")
                gate.drain()
                gate.account()
            finally:
                srv.stop()
        spans = tracing.load_spans(txd)
    tids = (out1["trace_id"], out2["trace_id"])
    expect(tids[0] != tids[1], "the two requests must be distinct traces")
    for tid in tids:
        mine = [s for s in spans if s["trace_id"] == tid]
        for p in tracing.verify_trace(spans, tid):
            expect(False, p)
        kinds = {s["kind"] for s in mine}
        expect({"rpc.request", "gate.queue", "slab.solve", "chunk"} <= kinds,
               f"trace {tid} missing span kinds (have {sorted(kinds)})")
        roots, orphans = tracing.span_tree(mine)
        expect(len(roots) == 1 and roots[0]["kind"] == "rpc.request", f"trace {tid}: want ONE rpc.request root")
        expect(not orphans, f"trace {tid}: orphans {orphans}")
        by_id = {s["span_id"]: s for s in mine}
        for s in mine:
            if s["kind"] == "slab.solve":
                expect(by_id[s["parent_id"]]["kind"] == "rpc.request", "slab.solve must parent to the request root")
            if s["kind"] == "chunk":
                expect(by_id[s["parent_id"]]["kind"] == "slab.solve", "chunk must parent to slab.solve")
        summ = tracing.trace_summary(mine, tid)
        expect(summ["dominant"] == "slab.solve",
               f"trace {tid}: a drained solve's dominant span must be slab.solve (got {summ['dominant']})")
        print(tracing.render_trace(spans, tid))
    profile = {"case": "standard", "phases": {"spmv_local": {"s_per_it": 3e-6}, "halo_exchange": {"s_per_it": 1e-6},
                                              "dot_allgather": {"s_per_it": 1e-6}, "axpy_sweep": {"s_per_it": 1e-6}}}
    added = tracing.mount_phase_spans(spans, profile)
    slabs = [s for s in spans if s["kind"] == "slab.solve" and s.get("dur_s") is not None]
    expect(len(added) == 4 * len(slabs) > 0, f"{len(added)} phase spans mounted under {len(slabs)} slab spans")
    for s in slabs:
        kids = [a for a in added if a["parent_id"] == s["span_id"]]
        expect(abs(sum(a["dur_s"] for a in kids) - s["dur_s"]) <= 1e-9 * max(1.0, s["dur_s"]),
               "the mounted phases must split their slab span's wall time")
    for f in failures:
        print(f"patx --check FAILURE: {f}", file=sys.stderr)
    print("patx --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_id", nargs="?", help="trace to render (--list shows them)")
    ap.add_argument("--dir", help="span directory (the serving process's telemetry tracing_dir)")
    ap.add_argument("--list", action="store_true", dest="list_", help="one line per trace")
    ap.add_argument("--slow", type=int, metavar="N", help="the N worst traces by total latency")
    ap.add_argument("--trace", metavar="OUT", help="Perfetto/Chrome-trace export (flow events link the span edges)")
    ap.add_argument("--phases", metavar="PROFILE", help="phase profile JSON to mount under the slab.solve spans")
    ap.add_argument("--json", action="store_true", help="dump the selected trace's spans as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="device of --check's gate")
    ap.add_argument("--check", action="store_true", help="ephemeral gate -> span-tree invariants")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.device)
    spans = _load(args.dir)
    if spans is None:
        return 2
    if args.phases:
        spans = _mount_phases(spans, args.phases)

    from partitionedarrays_jl_tpu_torch.telemetry import tracing

    if args.list_ or args.slow is not None:
        return _list(spans, slow=args.slow)
    if args.trace:
        from partitionedarrays_jl_tpu_torch.telemetry import write_chrome_trace

        write_chrome_trace(args.trace, extra_events=tracing.trace_chrome_events(spans, trace_id=args.trace_id))
        n = 1 if args.trace_id is not None else len(tracing.trace_ids(spans))
        print(f"wrote {args.trace} ({n} trace(s), flow-linked)")
        if args.trace_id is None:
            return 0
    if args.trace_id is None:
        ap.print_help()
        return 2
    mine = [s for s in spans if s["trace_id"] == args.trace_id]
    if not mine:
        print(f"patx: no spans for trace {args.trace_id}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(mine, indent=1, sort_keys=True))
        return 0
    print(tracing.render_trace(spans, args.trace_id))
    for p in tracing.verify_trace(spans, args.trace_id):
        print(f"  WARNING: {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
