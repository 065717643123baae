"""2-D Q1 finite-element assembly driver: the remote-row assembly workload.

The port's copy of `partitionedarrays_jl_tpu/models/fem_q1.py` (reference:
test/test_fem_sa.jl): a structured grid of Q1 (bilinear quad) elements,
each assembled by the part owning its lower-left node, so element
contributions touch nodes (rows AND cols) owned by *other* parts. It runs
the machinery the FDM driver does not:

* row-ghosted PRanges (`add_gids` on rows),
* `assemble_coo` migration of off-owner triplets before compression
  (reference: test/test_fem_sa.jl:76-104, src/Interfaces.jl:2406-2492),
* `global_view` writes into the rhs + PVector `assemble`
  (reference: test/test_fem_sa.jl:86-101),
* CG on the assembled operator with the 1e-5 gate
  (reference: test/test_fem_sa.jl:137); on the GPU backend the 9-point
  operator lowers to the coded-DIA kernels and the loop runs on the card.

The 4x4 Q1 Laplace element stiffness is the reference fixture's
(test/test_fem_sa.jl:17-22), the textbook
(1/6)*[[4,-1,-2,-1],[-1,4,-1,-2],[-2,-1,4,-1],[-1,-2,-1,4]].
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..parallel.backends import AbstractPData, map_parts
from ..parallel.prange import add_gids, cartesian_partition, no_ghost, p_cartesian_indices
from ..parallel.psparse import assemble_matrix_from_coo
from ..parallel.pvector import PVector, global_view
from ..utils.helpers import check
from .poisson_fdm import manufactured_rhs
from .solvers import cg

#: Q1 Laplace element stiffness, nodes ordered (0,0),(1,0),(0,1),(1,1)
KE = (
    np.array(
        [
            [4.0, -1.0, -2.0, -1.0],
            [-1.0, 4.0, -1.0, -2.0],
            [-2.0, -1.0, 4.0, -1.0],
            [-1.0, -2.0, -1.0, 4.0],
        ]
    )
    / 6.0
)

#: the element's node offsets, reference node order
CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _boundary_mask(gids, ns):
    """Dirichlet predicate: node on any face of the (n0 x n1) node grid."""
    c0, c1 = np.unravel_index(np.asarray(gids), ns)
    return (c0 == 0) | (c0 == ns[0] - 1) | (c1 == 0) | (c1 == ns[1] - 1)


def _element_corners(ci, ns):
    """The 4 node gids (reference node order) of every element whose
    lower-left node this part owns and which fits the grid."""
    x0s, x1s = ci.ranges
    ex = x0s[x0s < ns[0] - 1]
    ey = x1s[x1s < ns[1] - 1]
    EX, EY = np.meshgrid(ex, ey, indexing="ij")
    EX, EY = EX.ravel(), EY.ravel()
    return [np.ravel_multi_index((EX + dx, EY + dy), ns) for dx, dy in CORNERS]


def assemble_fem_q1(parts: AbstractPData, nodes_per_dim: Sequence[int]):
    """Assemble the Q1 Laplace stiffness over an (n0 x n1) node grid with
    Dirichlet identity rows on the boundary; returns (A, b, x_exact, x0)
    with b manufactured as A @ x̂ (f64, as the JAX package assembles it;
    `manufactured_rhs`'s order, so the system is the JAX package's bit for
    bit)."""
    ns = tuple(int(n) for n in nodes_per_dim)
    check(len(ns) == 2, "the Q1 driver is 2-D")
    rows0 = cartesian_partition(parts, ns, no_ghost)
    cis = p_cartesian_indices(parts, ns, no_ghost)

    def _local_coo(ci):
        gids = _element_corners(ci, ns)
        I_list, J_list, V_list = [], [], []
        # interior-node test functions only: boundary rows become identity
        for a in range(4):
            ga = gids[a]
            keep = ~_boundary_mask(ga, ns)
            for bidx in range(4):
                gb = gids[bidx]
                I_list.append(ga[keep])
                J_list.append(gb[keep])
                V_list.append(np.full(int(keep.sum()), KE[a, bidx]))
        return (
            np.concatenate(I_list) if I_list else np.empty(0, dtype=np.int64),
            np.concatenate(J_list) if J_list else np.empty(0, dtype=np.int64),
            np.concatenate(V_list) if V_list else np.empty(0),
        )

    coo = map_parts(_local_coo, cis)
    I = map_parts(lambda c: c[0], coo)
    J = map_parts(lambda c: c[1], coo)
    V = map_parts(lambda c: c[2], coo)

    # identity rows for boundary nodes, contributed by their owners
    def _boundary_coo(iset):
        g = iset.oid_to_gid
        gb = g[_boundary_mask(g, ns)]
        return gb, gb, np.ones(len(gb))

    bcoo = map_parts(_boundary_coo, rows0.partition)
    I = map_parts(lambda a, b: np.concatenate([a, b[0]]), I, bcoo)
    J = map_parts(lambda a, b: np.concatenate([a, b[1]]), J, bcoo)
    V = map_parts(lambda a, b: np.concatenate([a, b[2]]), V, bcoo)

    # rows ghosted by the off-owner rows each part touches -> migrate,
    # keep owned, discover column ghosts, compress
    A = assemble_matrix_from_coo(I, J, V, rows0)
    cols = A.cols

    def _exact(iset):
        c0, c1 = np.unravel_index(iset.lid_to_gid, ns)
        return np.sin(0.4 + c0 / (ns[0] + 1.0)) + np.cos(0.3 + 2.0 * c1 / (ns[1] + 1.0))

    x_exact = PVector(map_parts(_exact, cols.partition), cols)
    b = manufactured_rhs(A, x_exact)

    def _x0(iset):
        return np.where(_boundary_mask(iset.lid_to_gid, ns), _exact(iset), 0.0)

    x0 = PVector(map_parts(_x0, cols.partition), cols)
    return A, b, x_exact, x0


def fem_q1_driver(
    parts: AbstractPData,
    nodes_per_dim: Sequence[int] = (8, 8),
    tol: float = 1e-10,
    maxiter: int = 2000,
    verbose: bool = False,
) -> Tuple[float, dict]:
    """End-to-end FEM: assemble with remote-row migration, CG-solve, return
    (error vs x̂, info). Gate: error < 1e-5 (reference: test/test_fem_sa.jl:137).
    ``tol`` and ``maxiter`` go to `cg` as given (the default 2000 iterations
    suit the reference's grids; a 2048 x 2048 grid takes several thousand)."""
    A, b, x_exact, x0 = assemble_fem_q1(parts, nodes_per_dim)
    x, info = cg(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    err = (x - x_exact).norm()
    return float(err), info


def fem_q1_rhs_via_global_view(parts: AbstractPData, nodes_per_dim=(8, 8)):
    """The reference's rhs-assembly flow (test_fem_sa.jl:86-101): one 1.0
    per element corner written through a global_view into a row-ghosted
    PVector, then `assemble()`d to the owners (ghosts left at 0). Returns
    the assembled PVector."""
    ns = tuple(int(n) for n in nodes_per_dim)
    rows0 = cartesian_partition(parts, ns, no_ghost)
    cis = p_cartesian_indices(parts, ns, no_ghost)

    def _touched(ci):
        gs = _element_corners(ci, ns)
        return np.concatenate(gs) if gs else np.empty(0, dtype=np.int64)

    touched = map_parts(_touched, cis)
    rows = add_gids(rows0, touched)
    bvec = PVector.full(0.0, rows)
    gv = global_view(bvec)

    def _scatter(view, t):
        view.add_at(t, np.ones(len(t)))

    map_parts(_scatter, gv, touched)
    bvec.assemble()
    return bvec
