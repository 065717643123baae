"""Drivers and solvers of the port: the 3-D Poisson FDM driver, the
unstructured tet-elasticity driver, CG and PCG, and the geometric
multigrid hierarchy."""
from .elasticity_tet import assemble_elasticity_tet, elasticity_tet_driver, morton_permutation, p1_elasticity_ke, tet_mesh
from .gmg import GMGHierarchy, gmg_hierarchy, gmg_solve
from .poisson_fdm import assemble_poisson, manufactured_solution, poisson_fdm_driver
from .solvers import cg, decouple_dirichlet, gather_psparse, gather_pvector, jacobi_preconditioner, pcg

__all__ = [
    "GMGHierarchy", "assemble_elasticity_tet", "assemble_poisson", "elasticity_tet_driver", "morton_permutation",
    "p1_elasticity_ke", "tet_mesh", "cg", "decouple_dirichlet", "gather_psparse",
    "gather_pvector", "gmg_hierarchy", "gmg_solve", "jacobi_preconditioner", "manufactured_solution", "pcg",
    "poisson_fdm_driver",
]
