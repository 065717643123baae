"""partitionedarrays_jl_tpu_torch: the PyTorch/CUDA port of
partitionedarrays_jl_tpu.

Partitioned vectors and sparse matrices planned on the host, with the hot
path on one NVIDIA card: the 3-D Poisson CG solve (fused or pipelined) and
the multigrid-preconditioned CG, whose banded SpMVs and matrix-free
interpolation stencil run as hand-written CUDA kernels (`ops/dia.py`,
`ops/stencil.py`, `csrc/*.cu`), with the box halo exchange on Cartesian
partitions (`parallel/gpu_box.py`); the solve service over the block CG
(`service/`) and its telemetry (`telemetry/`), and the multi-tenant front
door over it (`frontdoor/`). Usage
mirrors the JAX package: ``prun(driver, gpu, (1, 1, 1))``; pass
``GPUBackend(device="cpu")`` to run on the CPU with the kernels' plain
PyTorch versions.
"""
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import *  # noqa: F401,F403
from .parallel import __all__ as _parallel_all
from .utils import *  # noqa: F401,F403
from .utils import __all__ as _utils_all
from . import frontdoor, service, telemetry  # noqa: F401
from .frontdoor import Gate, JournalCorruptError, LoadShedded, RequestJournal, TenantBudgetError  # noqa: F401
from .service import AdmissionRejected, SolveService  # noqa: F401

__all__ = (list(_parallel_all) + list(_utils_all) + list(_ops_all) + list(_models_all)
           + ["telemetry", "service", "SolveService", "AdmissionRejected", "frontdoor", "Gate",
              "JournalCorruptError", "LoadShedded", "RequestJournal", "TenantBudgetError"])
