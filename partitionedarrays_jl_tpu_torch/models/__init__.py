"""Drivers and solvers of the port: the 3-D Poisson FDM driver and CG."""
from .poisson_fdm import assemble_poisson, manufactured_solution, poisson_fdm_driver
from .solvers import cg, gather_pvector

__all__ = [
    "assemble_poisson", "cg", "gather_pvector", "manufactured_solution",
    "poisson_fdm_driver",
]
