"""Phase 4m of chip_smoke.py (the front door) alone on the card: phase 1
(the kernels' build), phase 3's 192^3 f32 driver, phase 2b's 48^3 f64
(2,2,2) system and `chip_smoke.phase_frontdoor`, with the JSON lines
chip_smoke.py prints for them. ``--profile FILE`` also writes a cProfile
of phase 4m to FILE.

    python3 tools/run_phase_4m.py [--profile phase_4m.prof]
"""
import argparse
import cProfile
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from partitionedarrays_jl_tpu_torch import prun  # noqa: E402
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, help="write a cProfile of phase 4m here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.phase_device()
    backend = GPUBackend()
    run = prun(cs.main_driver, backend, (1, 1, 1), cs.N_MAIN, cs.TOL_MAIN)
    gmulti = prun(cs.gmg_driver, backend, (2, 2, 2), cs.N_GMG_MULTI, False)
    cs.emit({"phase": "setup", "s": time.perf_counter() - t0, "iterations": run["info"]["iterations"]})
    prof = cProfile.Profile() if args.profile else None
    if prof is not None:
        prof.enable()
    cs.phase_frontdoor(backend, run, gmulti, np.random.default_rng(cs.SEED))
    if prof is not None:
        prof.disable()
        prof.dump_stats(args.profile)
    print(smi, flush=True)
    cs.emit({"phase": "total", "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
