"""Host planning seconds of the port on its two routes: the native planner
(`partitionedarrays_jl_tpu_torch/native/`, the default) against the NumPy
route (`native.ENABLED` off), at chip_smoke.py's main cell.

Per route, in a process of its own (so neither route finds the other's
caches or freed pages):

* ``assembly_s``: `assemble_poisson` of the 192^3 f32 system on one part
  (chip_smoke.py's `main_driver`);
* ``staging_s``: its lowering, `device_matrix` on the card, synchronised;
* ``hierarchy_s``: the GMG hierarchy of chip_smoke.py's `gmg_driver` (the
  decoupled 192^3 Poisson operator scaled to f32, ``coarse_threshold=500``),
  beside that driver's own ``assembly_s``;
* ``repartition_s``: phase 4o's host repartition of the 192^3 f32 (2,2,2)
  system onto the (1,2,2) survivors (`repartition_psparse`, then
  `repartition_pvector` of b), beside that system's ``assembly_s``.

Each route's systems are summarised (rows, stored entries, the hierarchy's
levels, a float64 sum of the values) so the two routes can be seen to plan
the same operators. Prints one JSON line a route, the host's CPU model and
the card's name and power limit, and with ``--out`` also writes the
route lines to that file.

    python3 tools/time_planning.py [--n 192] [--order native numpy] [--out FILE]
"""
import argparse
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTES = ("native", "numpy")


def _cpu_model() -> str:
    """The host CPU's model name, from /proc/cpuinfo or lscpu, with the
    count of cores this process may use."""
    name = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.lower().startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                         if ln.lower().startswith("model name")), "")
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{name or platform.machine()}, {len(os.sched_getaffinity(0))} cores"


def _summary(A):
    import numpy as np

    vals = A.values.part_values()
    return {"rows": int(A.rows.ngids), "nnz": int(sum(M.nnz for M in vals)),
            "sum": float(sum(np.sum(M.data, dtype=np.float64) for M in vals))}


def run_route(route: str, n: int) -> dict:
    """One route's seconds, in this process."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from partitionedarrays_jl_tpu_torch import native, prun
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel import elastic, repartition
    from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, device_matrix

    native.ENABLED = route == "native"
    backend = GPUBackend()
    out = {"route": route, "n": n, "native": native.available()}
    if native.available():
        out["library"] = str(native.LIBRARY)

    def main_cell(parts):
        t = time.perf_counter()
        A = assemble_poisson(parts, (n, n, n), dtype=np.float32)[0]
        t_asm = time.perf_counter() - t
        t = time.perf_counter()
        device_matrix(A, backend)
        torch.cuda.synchronize()
        return A, t_asm, time.perf_counter() - t

    A, out["assembly_s"], out["staging_s"] = prun(main_cell, backend, (1, 1, 1))
    out["system"] = _summary(A)
    out["lowering"] = device_matrix(A, backend).lowering
    del A
    g = prun(cs.gmg_driver, backend, (1, 1, 1), n, True)
    out["gmg_assembly_s"], out["hierarchy_s"] = g["assembly_s"], g["hierarchy_s"]
    out["levels"] = [_summary(lv.A) for lv in g["h"].levels] + [_summary(g["h"].coarse_A)]
    del g

    def stacked(parts):
        t = time.perf_counter()
        A, b, _, _ = assemble_poisson(parts, (n, n, n), dtype=np.float32)
        t_asm = time.perf_counter() - t
        new_rows = elastic.survivor_rows(A.rows, shape=(1, 2, 2))
        t = time.perf_counter()
        A2 = repartition.repartition_psparse(A, new_rows)
        t_a = time.perf_counter() - t
        t = time.perf_counter()
        repartition.repartition_pvector(b, A2.rows)
        return t_asm, t_a, time.perf_counter() - t, _summary(A2)

    t_asm, t_a, t_b, s2 = prun(stacked, backend, (2, 2, 2))
    out.update(stacked_assembly_s=t_asm, repartition_psparse_s=t_a, repartition_pvector_s=t_b,
               repartition_s=t_a + t_b, survivors=s2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--order", nargs="+", choices=ROUTES, default=list(ROUTES))
    ap.add_argument("--out", type=Path, help="also write the route lines to this file")
    ap.add_argument("--route", choices=ROUTES, help="run one route in this process (the workers' entry)")
    args = ap.parse_args(argv)
    if args.route:
        print(json.dumps(run_route(args.route, args.n)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_planning: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines, failed = [], []
    for route in args.order:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--route", route, "--n", str(args.n)],
                              capture_output=True, text=True, cwd=str(ROOT))
        rec = {"route": route, "rc": proc.returncode, "process_s": time.perf_counter() - t}
        body = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode == 0 and body:
            rec.update(json.loads(body[-1]))
        else:
            failed.append(route)
            rec["stderr_tail"] = proc.stderr.splitlines()[-20:]
        rec.update(card=smi, cpu=_cpu_model())
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
