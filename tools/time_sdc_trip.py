"""Seconds a trip of the SDC-defended CG loop on the card, for one checkout
of the port: the 192^3 f32 Poisson system on one part, its generic-plan
lowering (ABFT pins the generic plan), the fused and the standard body
under SDCConfig(abft=True, audit_every=32), as chip_smoke.py's phase 4k
times them (the median of ``--reps`` replays of the cached solve after
its capture), beside the undefended body.

    python3 tools/time_sdc_trip.py [--root CHECKOUT] [--tag NAME]

``--root`` names the checkout whose `partitionedarrays_jl_tpu_torch` is
timed (default: this one), so that two versions can be timed in one
session on one card, each in its own process: parent, change, change,
parent. Prints one JSON line a body and the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, AUDIT_EVERY, REPS = 192, 32, 5  # chip_smoke.py's N_MAIN and SDC_EVERY; the median of REPS replays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from partitionedarrays_jl_tpu_torch import prun
    from partitionedarrays_jl_tpu_torch.models import assemble_poisson
    from partitionedarrays_jl_tpu_torch.parallel.gpu import (
        DeviceVector, GPUBackend, _b_on_cols_layout, _krylov_fn_for, device_matrix,
    )
    from partitionedarrays_jl_tpu_torch.utils.health import SDCConfig

    if not torch.cuda.is_available():
        print("time_sdc_trip: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    backend = GPUBackend()
    A, b, x0 = prun(lambda p: _system(assemble_poisson, p, N), backend, (1, 1, 1))
    dA = device_matrix(A, backend, box=False)
    bd = _b_on_cols_layout(b, dA)
    x0d = DeviceVector.from_pvector(x0, backend, dA.col_layout).data
    dA.abft_row()
    tol, maxiter = 1e-5, 4 * A.rows.ngids
    sdc = SDCConfig(abft=True, audit_every=AUDIT_EVERY)

    def timed(fn):
        out = fn(bd, x0d)  # the capture
        ts = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(bd, x0d)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts), out

    for fused in (True, False):
        s_on, out_on = timed(_krylov_fn_for(dA, "cg", tol, maxiter, fused=fused, sdc=sdc))
        s_off, out_off = timed(_krylov_fn_for(dA, "cg", tol, maxiter, fused=fused))
        trips = int(out_on[5][4])
        own = slice(dA.row_layout.o0, dA.row_layout.o0 + dA.row_layout.no_max)
        same = bool(torch.equal(out_on[0][:, own], out_off[0][:, own])) and out_on[3] == out_off[3]
        print(json.dumps({
            "tag": args.tag, "body": "fused" if fused else "standard", "n": N, "audit_every": AUDIT_EVERY,
            "iterations": out_on[3], "trips": trips, "ms_per_trip": 1e3 * s_on / trips,
            "ms_per_iteration": 1e3 * s_on / out_on[3], "undefended_ms_per_iteration": 1e3 * s_off / out_off[3],
            "x_equal_to_undefended": same, "device": smi, "package": str(Path(sys.modules[GPUBackend.__module__].__file__).parents[2]),
        }), flush=True)
        if not same:
            return 1
    return 0


def _system(assemble_poisson, parts, n):
    import numpy as np

    A, b, _xe, x0 = assemble_poisson(parts, (n, n, n), dtype=np.float32)
    return A, b, x0


if __name__ == "__main__":
    sys.exit(main())
