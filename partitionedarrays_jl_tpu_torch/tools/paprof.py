"""paprof — phase-attributed solver profiling and the exchange cost matrix.

The port's counterpart of the JAX package's ``tools/paprof.py``: the
console of `telemetry.profile` (where one CG iteration's time goes: the
SpMV's compute, the halo exchange, the dots' folds, the update sweep) and
`telemetry.commsmatrix` (what each exchange edge costs). Legs:

* ``--check``              in-process smoke on the 4-part (n, n) Poisson
                           fixture on ``--device``: a profile whose per-phase
                           comms reconcile with `telemetry.comms` and whose
                           attributed sum lies in its band, and the comms
                           matrix of both plans, measured and reconciled;
                           a ``--profiles FILE`` container is validated too.
* ``--profile [OUT]``      one phase profile of the fixture (``--case``,
                           ``--k``, ``--n``, ``--nobox``), printed; with OUT
                           written as JSON (``patrace --phases OUT`` merges
                           it onto the solve timeline).
* ``--comms-matrix [OUT]`` the measured matrix of the fixture's plan.
* ``--write PATH``         the multi-case profile container (schema 2:
                           ``{"phase_schema_version": 2, "profiles":
                           {case: profile}}``, one profile a body case)
                           written to PATH. No default path: the JAX
                           package's committed ``PHASE_PROFILE.json`` and
                           ``COMMS_MATRIX.json`` are its own.

Options: ``--case standard|fused|block_k1_fused|block_k4_fused|sstep2|
overlap``, ``--k K`` (block width), ``--n N`` (grid edge, default 6),
``--trace 0|1|auto`` (the ``prof_trace`` switch for this run),
``--device cuda|cpu`` (default cuda).

Usage:
    python -m partitionedarrays_jl_tpu_torch.tools.paprof --check --device cpu
    python -m partitionedarrays_jl_tpu_torch.tools.paprof --profile prof.json --case fused
    python -m partitionedarrays_jl_tpu_torch.tools.paprof --comms-matrix matrix.json --nobox
"""
import argparse
import json
import sys

#: the body cases a profile container holds (every lowering case maps onto
#: one of them, `telemetry.profile.phase_case_of`); the JAX package's
#: ``twolevel`` entry waits for the two-level plans
CASES = {
    "standard": dict(fused=False),
    "fused": dict(fused=True),
    "block_k1_fused": dict(fused=True, rhs_batch=1),
    "block_k4_fused": dict(fused=True, rhs_batch=4),
    "sstep2": dict(fused=False, sstep=2),
    "overlap": dict(fused=False, overlap=True),
}


def fixture(backend, n: int):
    """The 4-part (n, n) Poisson operator on (2, 2) parts (the JAX tool's
    fixture)."""
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.backends import prun

    def driver(parts):
        A, _b, _xe, _x0 = assemble_poisson(parts, (n, n))
        return A

    return prun(driver, backend, (2, 2))


def _case_kwargs(case, k):
    if case is None:
        return dict(rhs_batch=k or None)
    kw = dict(CASES[case])
    if k:
        kw["rhs_batch"] = k
    return kw


def _trace_mode(trace):
    return {"0": False, "1": True, "auto": "auto", None: None}[trace]


def check(device: str, n: int = 6, profiles_path=None) -> int:
    """--check: see the module docstring."""
    import importlib

    from partitionedarrays_jl_tpu_torch.telemetry import commsmatrix as cm
    from partitionedarrays_jl_tpu_torch.telemetry import profile as prof

    from . import backend_of

    g = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
    failures = []

    def expect(cond, msg):
        if not cond:
            failures.append(msg)

    backend = backend_of(device)
    A = fixture(backend, n)
    profile = prof.capture_phase_profile(A, backend)
    for _retry in range(2):  # a loaded host can push one capture out of band on timer jitter
        if profile is None or profile["in_band"]:
            break
        profile = prof.capture_phase_profile(A, backend)
    expect(profile is not None, "capture returned None (telemetry.configure(prof=False)?)")
    if profile is not None:
        print(prof.render_phase_profile(profile))
        for m in prof.reconcile_phases(profile, dA=g.device_matrix(A, backend)):
            expect(False, f"phase reconciliation: {m}")
        json.dumps(profile)
    for box in (True, False):
        matrix = cm.measure_comms_matrix(A, backend, box=box)
        print(cm.render_comms_matrix(matrix))
        for m in matrix["static_check"]:
            expect(False, f"comms-matrix reconciliation ({matrix['plan']}): {m}")
        expect(matrix["edges"], f"the {matrix['plan']} comms matrix recorded no edges")
        expect(all(e["measured_s"] >= 0.0 for e in matrix["edges"]), "a negative edge cost")
        expect(matrix["fabric_summary"] == cm.fabric_summary(matrix["edges"]), "fabric_summary does not recompute")
    if profiles_path:
        from partitionedarrays_jl_tpu_torch.telemetry import comms

        with open(profiles_path) as f:
            rec = json.load(f)
        profiles = rec.get("profiles") or {}
        expect(rec.get("phase_schema_version") == prof.PHASE_SCHEMA_VERSION, f"{profiles_path}: schema mismatch")
        for cname, p in sorted(profiles.items()):
            expect(p.get("case") == cname, f"{profiles_path}: entry {cname!r} records case {p.get('case')!r}")
            for m in prof.reconcile_phases(p):
                expect(False, f"{profiles_path}[{cname}]: {m}")
        for case in comms.lowering_cases():
            key = prof.phase_case_of(case["name"])
            expect(key in profiles, f"{profiles_path}: lowering case {case['name']!r} has no profile ({key!r})")
    for f in failures:
        print(f"paprof --check FAILURE: {f}", file=sys.stderr)
    print("paprof --check:", "FAILED" if failures else "OK")
    return 1 if failures else 0


def write_profiles(path: str, device: str, n: int = 6) -> int:
    """--write PATH: one profile a body case (`CASES`) in the container."""
    from partitionedarrays_jl_tpu_torch.telemetry import artifacts
    from partitionedarrays_jl_tpu_torch.telemetry import profile as prof

    from . import backend_of, refuse_root_artifact

    refuse_root_artifact(path)
    backend = backend_of(device)
    A = fixture(backend, n)
    profiles = {}
    for cname, kw in CASES.items():
        print(f"paprof --write: capturing {cname} ...", flush=True)
        p = bad = None
        for _ in range(3):
            p = prof.capture_phase_profile(A, backend, **kw)
            if p is None:
                print("paprof --write: prof=False — nothing captured", file=sys.stderr)
                return 1
            bad = prof.reconcile_phases(p)
            if not bad:
                break
        if p["case"] != cname or bad:
            print(f"paprof --write: {cname} captured as {p['case']!r}, mismatches {bad}", file=sys.stderr)
            return 1
        profiles[cname] = p
    artifacts.write(path, {"phase_schema_version": prof.PHASE_SCHEMA_VERSION, "profiles": profiles}, tool="paprof")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="in-process smoke on the 4-part fixture")
    ap.add_argument("--profile", nargs="?", const="-", metavar="OUT", help="capture a phase profile (write to OUT)")
    ap.add_argument("--comms-matrix", nargs="?", const="-", metavar="OUT", dest="comms_matrix",
                    help="measure the exchange cost matrix")
    ap.add_argument("--write", metavar="PATH", help="write the multi-case profile container to PATH")
    ap.add_argument("--profiles", metavar="FILE", help="with --check: validate a profile container")
    ap.add_argument("--case", choices=tuple(CASES), help="CG body form (default: the default body)")
    ap.add_argument("--k", type=int, default=0, help="block width (rhs_batch; 0 = one right-hand side)")
    ap.add_argument("--n", type=int, default=6, help="fixture grid edge (default 6)")
    ap.add_argument("--nobox", action="store_true", help="the generic exchange plan (box=False)")
    ap.add_argument("--trace", choices=("0", "1", "auto"), help="the prof_trace switch for this run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="device (default cuda)")
    args = ap.parse_args(argv)

    from partitionedarrays_jl_tpu_torch import telemetry

    mode = _trace_mode(args.trace)
    with telemetry.configure(**({} if mode is None else {"prof_trace": mode})):
        return _dispatch(ap, args)


def _dispatch(ap, args):
    from partitionedarrays_jl_tpu_torch.telemetry import artifacts
    from partitionedarrays_jl_tpu_torch.telemetry import commsmatrix as cm
    from partitionedarrays_jl_tpu_torch.telemetry import profile as prof

    from . import backend_of, refuse_root_artifact

    if args.check:
        return check(args.device, args.n, args.profiles)
    if args.write:
        return write_profiles(args.write, args.device, args.n)
    if args.profile is not None:
        backend = backend_of(args.device)
        profile = prof.capture_phase_profile(fixture(backend, args.n), backend, box=not args.nobox,
                                             **_case_kwargs(args.case, args.k))
        if profile is None:
            print("paprof: prof=False — profiling disabled", file=sys.stderr)
            return 1
        print(prof.render_phase_profile(profile))
        if args.profile != "-":
            refuse_root_artifact(args.profile)
            artifacts.write(args.profile, profile, tool="paprof", echo=True)
        return 0
    if args.comms_matrix is not None:
        backend = backend_of(args.device)
        matrix = cm.measure_comms_matrix(fixture(backend, args.n), backend, K=max(1, args.k or 1),
                                         box=not args.nobox)
        print(cm.render_comms_matrix(matrix))
        if args.comms_matrix != "-":
            refuse_root_artifact(args.comms_matrix)
            artifacts.write(args.comms_matrix, matrix, tool="paprof", echo=True)
        return 0 if not matrix["static_check"] else 1
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
