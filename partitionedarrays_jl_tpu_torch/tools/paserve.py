"""paserve — run the solve service against a demo operator.

The port's counterpart of the JAX package's ``tools/paserve.py``: it
assembles a Poisson system, starts a `SolveService`, submits a batch of
requests (optionally NaN-poisoning one, to watch the service contain it,
optionally with per-request deadlines), drains, and prints one outcome
line per request and the service's stats: admission, coalescing, the
block slab, ejection and typed failure, end to end.

``--backend seq`` runs on the port's sequential backend, ``--backend gpu``
(the default) on the card (``--device cuda``) or on the plain versions of
the kernels (``--device cpu``).

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.paserve --grid 8 8 --requests 6 --kmax 4
    python -m partitionedarrays_jl_tpu_torch.tools.paserve --grid 8 8 8 --requests 8 --poison 3
    python -m partitionedarrays_jl_tpu_torch.tools.paserve ... --metrics-json m.json   # pamon --snapshot
    python -m partitionedarrays_jl_tpu_torch.tools.paserve --check --device cpu

Exit status: 0 when every request ends in a documented terminal state
(done, or failed with a typed error for the poisoned request), 1
otherwise.
"""
import argparse
import json
import sys


def _build_requests(A, b, x0, n_requests, poison):
    """The demo mix: the assembled (b, x0) and scaled copies (the system is
    linear, so scaling both keeps the Dirichlet rows consistent), request
    ``poison`` (if any) with a NaN in one owned entry of its b."""
    import numpy as np

    from partitionedarrays_jl_tpu_torch.parallel.backends import map_parts

    out = []
    for i in range(n_requests):
        bi, x0i = b.copy(), x0.copy()
        if i:
            scale = 1.0 + 0.25 * i

            def _scale(iset, vals, s=scale):
                np.asarray(vals)[...] *= s

            map_parts(_scale, bi.rows.partition, bi.values)
            map_parts(_scale, x0i.rows.partition, x0i.values)
        if poison is not None and i == poison:
            def _poison(iset, vals):
                if int(iset.part) == 0 and len(np.asarray(vals)):
                    np.asarray(vals)[0] = np.nan

            map_parts(_poison, bi.rows.partition, bi.values)
        out.append((bi, x0i))
    return out


def serve(grid, parts_grid, backend, requests=6, kmax=None, queue_depth=None, chunk=None, tol=1e-9, maxiter=None,
          deadline=None, poison=None, retries=None):
    """Run the demo; returns ``(rows, stats, ok)``."""
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun
    from partitionedarrays_jl_tpu_torch.service import SolveService

    rows = []

    def driver(parts):
        A, b, xe, x0 = assemble_poisson(parts, grid)
        svc = SolveService(A, kmax=kmax, queue_depth=queue_depth, chunk=chunk, retries=retries)
        handles = [svc.submit(bi, x0=x0i, tol=tol, maxiter=maxiter, deadline=deadline, tag=f"req-{i}")
                   for i, (bi, x0i) in enumerate(_build_requests(A, b, x0, requests, poison))]
        svc.drain()
        stats = svc.shutdown()
        for h in handles:
            row = {"request": h.tag, "state": h.state, "iterations": h.iterations}
            if h.state == "done":
                _x, info = h.result()
                row["converged"] = bool(info["converged"])
                row["status"] = str(info["status"])
            elif h.state == "failed":
                row["error"] = type(h.error).__name__
            rows.append(row)
        return stats

    stats = prun(driver, backend, parts_grid)
    ok = all(row["state"] == "failed" if (poison is not None and i == poison)
             else row["state"] == "done" and row.get("converged") for i, row in enumerate(rows))
    return rows, stats, ok


def check(device: str) -> int:
    """--check: the poisoned demo on the sequential and the device backend:
    the poisoned request fails typed (NonFiniteError) with one ejection,
    every other converges, on both."""
    from partitionedarrays_jl_tpu_torch.parallel.sequential import sequential

    from . import backend_of

    failures = []
    for name, backend in (("seq", sequential), ("gpu", backend_of(device))):
        rows, stats, ok = serve((8, 8), (2, 2), backend, requests=4, kmax=4, poison=1)
        print(f"  {name}: " + "; ".join(f"{r['request']} {r['state']}" + (f" {r['error']}" if "error" in r else "")
                                       for r in rows))
        if not ok:
            failures.append(f"{name}: a request ended outside its documented state: {rows}")
        if rows[1].get("error") != "NonFiniteError" or stats.get("ejected") != 1:
            failures.append(f"{name}: the poisoned request must fail NonFiniteError with one ejection "
                            f"({rows[1]}, ejected={stats.get('ejected')})")
    for f in failures:
        print(f"paserve --check FAILURE: {f}", file=sys.stderr)
    print("paserve --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, nargs="+", default=[8, 8], help="Poisson grid (2-D or 3-D), default 8 8")
    ap.add_argument("--parts", type=int, nargs="+", default=None, help="part grid (default 2 2 [2])")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--kmax", type=int, default=None, help="slab width bound (default: the service's)")
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None, help="per-request deadline seconds (slabs chunk)")
    ap.add_argument("--poison", type=int, default=None, help="NaN-poison request #N (containment demo)")
    ap.add_argument("--retries", type=int, default=None)
    ap.add_argument("--backend", choices=("seq", "gpu"), default="gpu")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="the gpu backend's device")
    ap.add_argument("--summary-json", default=None, help="write the outcome summary as JSON")
    ap.add_argument("--metrics-json", default=None,
                    help="write the metric registry's snapshot as JSON (pamon --snapshot renders it)")
    ap.add_argument("--check", action="store_true", help="the poisoned demo on both backends")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.device)
    from partitionedarrays_jl_tpu_torch.parallel.sequential import sequential

    from . import backend_of

    grid = tuple(args.grid)
    parts_grid = tuple(args.parts) if args.parts else (2,) * len(grid)
    backend = sequential if args.backend == "seq" else backend_of(args.device)
    rows, stats, ok = serve(grid, parts_grid, backend, args.requests, args.kmax, args.queue_depth, args.chunk,
                            args.tol, args.maxiter, args.deadline, args.poison, args.retries)
    for row in rows:
        line = f"  {row['request']:>8s}  {row['state']:>6s}  it={row['iterations']:>4d}"
        if "converged" in row:
            line += f"  converged={row['converged']}  {row['status']}"
        if "error" in row:
            line += f"  {row['error']}"
        print(line)
    print(f"stats: {json.dumps(stats, sort_keys=True)}")
    if args.summary_json:
        with open(args.summary_json, "w", encoding="utf-8") as f:
            json.dump({"requests": rows, "stats": stats, "ok": ok}, f, indent=1, sort_keys=True)
        print(f"wrote {args.summary_json}")
    if args.metrics_json:
        from partitionedarrays_jl_tpu_torch import telemetry

        with open(args.metrics_json, "w", encoding="utf-8") as f:
            f.write(telemetry.registry().to_json())
        print(f"wrote {args.metrics_json}")
    print("paserve:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
