"""Transient heat equation: implicit Euler over the decoupled Poisson
operator, one distributed solve per time step.

The port's copy of `partitionedarrays_jl_tpu/models/heat_transient.py`:
du/dt = −(A u − b) on the interior with fixed Dirichlet boundary values,

    (I + dt·A) u_{n+1} = u_n + dt·b      (interior rows)
    u_{n+1} = g                           (boundary rows)

Each step reuses ONE solver setup: the multigrid hierarchy is built once,
and on the GPU backend its staging and the captured GMG-PCG loop are
cached on it (`parallel/gpu_gmg.py:gpu_gmg_pcg`), so every step after the
first copies its right-hand side and start into the loop's buffers and
replays the graph: one staging and one capture over the march. As t → ∞
the march approaches the steady solution A u = b, the driver's built-in
check (the manufactured solution of the Poisson fixture).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..ops.sparse import CSRMatrix
from ..parallel.backends import AbstractPData, map_parts
from ..parallel.psparse import PSparseMatrix
from ..parallel.pvector import PVector, _write_owned
from .gmg import gmg_hierarchy
from .poisson_fdm import assemble_poisson
from .solvers import _owned_zip, decouple_dirichlet, gather_pvector, pcg


def assemble_heat(
    parts: AbstractPData, ns: Sequence[int], dt: float
) -> Tuple[PSparseMatrix, PVector, PVector, PVector, PVector]:
    """Build the implicit-Euler step operator B = I + dt·A (interior
    rows; boundary rows stay identity) from the Poisson fixture (f64).

    Returns (B, bh, mask_int, u0, x_steady): the step operator, the
    decoupled steady rhs, the interior-row indicator (1 on interior, 0 on
    boundary, for the per-step right-hand sides), a start field carrying
    the boundary values, and the steady solution the march approaches."""
    A, b, x_steady, u0 = assemble_poisson(parts, ns)
    Ah, bh = decouple_dirichlet(A, b)
    dt = float(dt)

    mask_int = PVector.full(0.0, Ah.rows, dtype=Ah.dtype)

    def _step_matrix(ri, M, mv):
        r = M.row_of_nz()
        on = M.indices == r
        offsum = np.zeros(M.shape[0], dtype=M.data.dtype)
        np.add.at(offsum, r[~on], np.abs(M.data[~on]))
        interior = offsum != 0  # decoupled boundary rows are diag-only
        data = dt * M.data
        # interior diagonal += 1; boundary rows reset to exact identity
        bump = np.where(interior[r], 1.0, 0.0)
        data = np.where(on, np.where(interior[r], data + bump, 1.0), data)
        _write_owned(ri, mv, interior[: ri.num_oids].astype(M.data.dtype))
        return CSRMatrix(M.indptr, M.indices, data, M.shape)

    values = map_parts(_step_matrix, Ah.rows.partition, Ah.values, mask_int.values)
    B = PSparseMatrix(values, Ah.rows, Ah.cols)
    return B, bh, mask_int, u0, x_steady


def step_rhs(rhs: PVector, u: PVector, bh: PVector, mask_int: PVector, dt: float) -> PVector:
    """One step's right-hand side into ``rhs``: u_n + dt·b on the interior
    rows, the boundary value g (= bh there) on the boundary rows."""
    dtf = float(dt)
    _owned_zip(rhs, lambda _r, uv, bv, mv: mv * (uv + dtf * bv) + (1.0 - mv) * bv, u, bh, mask_int)
    return rhs


def heat_transient_driver(
    parts: AbstractPData,
    ns: Sequence[int],
    dt: float = 0.5,
    nsteps: int = 40,
    tol: float = 1e-10,
    coarse_threshold: int = 100,
):
    """March implicit Euler to (near-)steady state and return (error vs
    steady solution, per-step solver iteration counts). The multigrid
    hierarchy is built ONCE on the step operator and every step's `pcg`
    reuses it (on the GPU backend also its staging and captured loop)."""
    B, bh, mask_int, u0, x_steady = assemble_heat(parts, ns, dt)
    h = gmg_hierarchy(parts, B, ns, coarse_threshold=coarse_threshold)
    u = u0.copy()
    rhs = PVector.full(0.0, B.rows, dtype=bh.dtype)
    its = []
    for _ in range(int(nsteps)):
        step_rhs(rhs, u, bh, mask_int, dt)
        u, info = pcg(B, rhs, x0=u, minv=h, tol=tol)
        its.append(info["iterations"])
    err = float(np.abs(gather_pvector(u) - gather_pvector(x_steady)).max())
    return err, its
