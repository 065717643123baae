"""Drivers and solvers of the port: the 3-D Poisson FDM driver and its
periodic operator, the 2-D Q1 FE driver, the transient heat march, the
unstructured tet-elasticity driver, the nonsymmetric upwind advection FV
driver, CG (with its s-step body), PCG, BiCGStab, GMRES, FGMRES, MINRES and
Chebyshev with their spectral bounds, LOBPCG, the direct, ILU, IC(0) and
Schwarz preconditioners, the geometric multigrid hierarchy (V and W
cycles, coarse agglomeration), and the recovery drivers `resume_solve` and
`solve_with_recovery`."""
from .advection_fv import advection_fv_driver, assemble_advection_fv
from .fem_q1 import assemble_fem_q1, fem_q1_driver, fem_q1_rhs_via_global_view
from .heat_transient import assemble_heat, heat_transient_driver
from .elasticity_tet import assemble_elasticity_tet, elasticity_tet_driver, morton_permutation, p1_elasticity_ke, tet_mesh
from .gmg import (
    GMGHierarchy, GMGLevel, galerkin_cartesian, gmg_hierarchy, gmg_solve, interpolation_cartesian, restriction_from,
)
from .poisson_fdm import assemble_poisson, assemble_poisson_periodic, manufactured_solution, poisson_fdm_driver
from .solvers import (
    PLU, additive_schwarz, bicgstab, block_jacobi_ic0, block_jacobi_ilu, cg, chebyshev_solve, decouple_dirichlet,
    direct_solve, fgmres, gather_psparse, gather_pvector, gershgorin_bounds, gmres, jacobi_preconditioner,
    lanczos_bounds, lobpcg, lu, minres, pcg, resume_solve, scatter_pvector_values, solve_with_recovery,
)

__all__ = [
    "GMGHierarchy", "PLU", "additive_schwarz", "block_jacobi_ic0", "block_jacobi_ilu", "direct_solve", "lobpcg", "lu", "advection_fv_driver", "assemble_advection_fv", "bicgstab", "chebyshev_solve", "fgmres",
    "gershgorin_bounds", "gmres", "lanczos_bounds", "minres", "assemble_elasticity_tet", "assemble_fem_q1", "assemble_heat", "assemble_poisson",
    "assemble_poisson_periodic", "fem_q1_driver", "fem_q1_rhs_via_global_view", "heat_transient_driver", "elasticity_tet_driver", "morton_permutation",
    "p1_elasticity_ke", "tet_mesh", "cg", "decouple_dirichlet", "gather_psparse",
    "gather_pvector", "gmg_hierarchy", "gmg_solve", "jacobi_preconditioner", "manufactured_solution", "pcg",
    "poisson_fdm_driver", "resume_solve", "solve_with_recovery",
    "GMGLevel", "galerkin_cartesian", "interpolation_cartesian", "restriction_from", "scatter_pvector_values",
]
