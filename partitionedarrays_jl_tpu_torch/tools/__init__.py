"""The operator consoles of the port (tools/ of the JAX package), each a
module with ``main(argv)`` run as ``python -m
partitionedarrays_jl_tpu_torch.tools.<name>``:

* `patrace` — persisted solve records: summaries, the Chrome-trace
  export, the comms accounting counted against its model over the
  lowering cases (``--diff-static``), per-slab service timelines;
* `paprof` — the phase profile and the exchange cost matrix;
* `pamon` — the metrics plane: snapshots, SLO attainment, the front
  door's gate and fleet views, the throughput model;
* `paspec` — the convergence observatory: spectra from the α/β ring,
  forecasts, the deadline-feasibility verdict;
* `paserve` — the solve service against a demo operator;
* `patx` — request span trees, with the phase profile mounted.

Each takes ``--device cuda|cpu`` (default ``cuda``: the card, which it
needs) where it solves, ``--dir`` where the JAX tool read
``PA_METRICS_DIR`` or ``PA_TX_DIR``, and ``--check`` (an in-process smoke
that exits 0 when every invariant holds). None reads the environment, and
none writes a file it was not given a path for.
"""

#: the JAX package's committed artifacts at the repository's root, which no
#: console of the port writes (`refuse_root_artifact`)
ROOT_ARTIFACTS = ("PHASE_PROFILE.json", "COMMS_MATRIX.json", "SPECTRUM.json", "PERF_LEDGER.json")


def refuse_root_artifact(path: str) -> None:
    """Raise ValueError when ``path`` names one of the JAX package's
    committed artifacts at the repository's root."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = os.path.abspath(path)
    if os.path.dirname(p) == root and os.path.basename(p) in ROOT_ARTIFACTS:
        raise ValueError(f"{path}: the JAX package's committed artifact; write the port's elsewhere")


def backend_of(device: str):
    """The `GPUBackend` of ``--device`` (``cuda``: the card, raising
    without one; ``cpu``: the plain versions of the kernels)."""
    import importlib

    g = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")
    return g.GPUBackend(device=device)
