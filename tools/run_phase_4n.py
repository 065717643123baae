"""Phase 4n of chip_smoke.py (the observability consoles) alone on the card:
phase 1 (the kernels' build), phase 3's 192^3 f32 driver, phase 2b's 48^3
f64 (2,2,2) system and `chip_smoke.phase_observability`, with the JSON lines
chip_smoke.py prints for them.

    python3 tools/run_phase_4n.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from partitionedarrays_jl_tpu_torch import prun  # noqa: E402
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    smi = cs.phase_device()
    backend = GPUBackend()
    run = prun(cs.main_driver, backend, (1, 1, 1), cs.N_MAIN, cs.TOL_MAIN)
    gmulti = prun(cs.gmg_driver, backend, (2, 2, 2), cs.N_GMG_MULTI, False)
    cs.emit({"phase": "setup", "s": time.perf_counter() - t0, "iterations": run["info"]["iterations"]})
    cs.phase_observability(backend, run, gmulti)
    print(smi, flush=True)
    cs.emit({"phase": "total", "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
