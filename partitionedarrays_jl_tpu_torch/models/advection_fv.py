"""Finite-volume upwind advection-diffusion: the nonsymmetric model.

The port's copy of `partitionedarrays_jl_tpu/models/advection_fv.py`: a
cell-centred FV discretisation of

    -D Δu + v · ∇u = f    on an N-D Cartesian grid, Dirichlet boundary

with first-order upwinding of the advective flux, which makes the
operator nonsymmetric (CG does not apply): the end-to-end workload of
BiCGStab, on the host loop and the device loop alike. Assembly rides the
Cartesian stencil skeleton of the Poisson driver
(`poisson_fdm.assemble_cartesian_stencil`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..parallel.backends import AbstractPData
from ..utils.helpers import check
from .poisson_fdm import assemble_cartesian_stencil
from .solvers import bicgstab


def assemble_advection_fv(parts: AbstractPData, ns: Sequence[int], velocity: Optional[Sequence[float]] = None,
                          diffusion: float = 1.0):
    """The upwind advection-diffusion PSparseMatrix and (b, x̂, x0). Per
    dimension d with velocity v_d (unit cells) the upwind flux gives

        a[i, i-e_d] = -(D + max(v_d, 0))
        a[i, i+e_d] = -(D + max(-v_d, 0))
        a[i, i]    += 2 D + |v_d|

    Boundary cells are Dirichlet identity rows; b = A @ x̂. The velocity
    defaults to (1, 1.5, 2, ...)."""
    ns = tuple(int(n) for n in ns)
    dim = len(ns)
    if velocity is None:
        velocity = tuple(1.0 + 0.5 * d for d in range(dim))
    velocity = tuple(float(v) for v in velocity)
    check(len(velocity) == dim, f"velocity has {len(velocity)} components for a {dim}-D grid")
    D = float(diffusion)
    center = sum(2.0 * D + abs(v) for v in velocity)
    arms = [(-(D + max(v, 0.0)), -(D + max(-v, 0.0))) for v in velocity]  # (upstream, downstream)
    return assemble_cartesian_stencil(parts, ns, center, arms)


def advection_fv_driver(parts: AbstractPData, ns: Sequence[int] = (16, 16), velocity: Optional[Sequence[float]] = None,
                        tol: float = 1e-12, maxiter: int = 4000, verbose: bool = False) -> Tuple[float, dict]:
    """Assemble the nonsymmetric upwind operator, solve it with BiCGStab
    (the device loop on the GPU backend) and return (‖x − x̂‖, info). Gate:
    error < 1e-5 (the reference's driver tolerance, test/test_fdm.jl:118)."""
    A, b, x_exact, x0 = assemble_advection_fv(parts, ns, velocity)
    x, info = bicgstab(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    err = (x - x_exact).norm()
    return float(err), info
