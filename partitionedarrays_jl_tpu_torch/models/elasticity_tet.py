"""Unstructured tet-mesh linear elasticity: the irregular-ghost-graph
workload (BASELINE.json configs[4]).

The port's copy of `partitionedarrays_jl_tpu/models/elasticity_tet.py`,
the same arithmetic on the port's PRange / PSparseMatrix / PVector, so the
two assemble the same system bit for bit:

* **Mesh**: a hex grid split into 5 tets per cell (parity-alternating so
  faces conform), with jittered interior nodes: geometrically
  unstructured, every element matrix distinct.
* **Partition**: nodes renumbered along a Morton (Z-order) curve of their
  jittered coordinates, then 1-D block-partitioned; the ghost graph is
  discovered from the COO column ids (`add_gids`). The 3 dofs of a node
  stay with its owner through a `variable_partition` over dof counts.
* **Physics**: P1 (linear) tets, isotropic Hooke law, vectorized
  B^T C B element stiffness; Dirichlet boundary as identity rows with the
  manufactured solution imposed (reference pattern: test/test_fem_sa.jl
  and test/test_fdm.jl boundary handling).
* **Assembly**: each part assembles the elements whose first node it
  owns, so rows and cols touch remote parts; `assemble_coo` migrates the
  off-owner triplets (reference: src/Interfaces.jl:2406-2492).
* **Solve**: Jacobi-preconditioned CG, error gate vs the manufactured
  solution (reference tolerance: test/test_fem_sa.jl:137). On the GPU
  backend the operator is no band, so it takes the supernode-dense, node-
  block or ELL lowering (`parallel/gpu.py:DeviceMatrix`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..parallel.backends import AbstractPData, map_parts
from ..parallel.prange import variable_partition
from ..parallel.psparse import assemble_matrix_from_coo
from ..parallel.pvector import PVector
from ..parallel.index_sets import GID_DTYPE
from ..utils.helpers import check
from .solvers import _matvec, pcg

#: hex corners numbered with bit order (x, y, z)
_EVEN_TETS = ((0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7), (0, 3, 5, 6))
_ODD_TETS = ((1, 0, 2, 4), (1, 3, 2, 7), (1, 5, 4, 7), (2, 4, 6, 7), (1, 2, 4, 7))


def tet_mesh(
    nodes_per_dim: Sequence[int], jitter: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Jittered 5-tet-per-hex mesh on an (n0 x n1 x n2) node grid.

    Returns ``(coords, tets, boundary)``: node coordinates (N, 3), tet
    connectivity (E, 4) with positive orientation, and the boundary-node
    mask (N,). The tet split alternates parity per cell so shared faces
    conform; interior nodes are jittered deterministically so no two
    element matrices coincide."""
    ns = tuple(int(n) for n in nodes_per_dim)
    check(len(ns) == 3 and min(ns) >= 2, "tet_mesh needs a 3-D grid, >= 2 nodes/dim")
    grid = np.stack(
        np.meshgrid(*[np.arange(n) for n in ns], indexing="ij"), axis=-1
    ).reshape(-1, 3)
    boundary = ((grid == 0) | (grid == np.array(ns) - 1)).any(axis=1)
    rng = np.random.default_rng(seed)
    coords = grid + np.where(
        boundary[:, None], 0.0, (rng.random(grid.shape) - 0.5) * 2 * jitter
    )
    # cells and their 8 corner node ids
    cx, cy, cz = np.meshgrid(*[np.arange(n - 1) for n in ns], indexing="ij")
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    corner = np.stack(
        [
            np.ravel_multi_index((cx + dx, cy + dy, cz + dz), ns)
            for dz in (0, 1)
            for dy in (0, 1)
            for dx in (0, 1)
        ],
        axis=1,
    )  # corner[:, b] with b's bits = (x, y, z): index 4*z + 2*y + x
    parity = (cx + cy + cz) % 2
    tets = np.concatenate(
        [
            corner[parity == 0][:, np.array(_EVEN_TETS).reshape(-1)].reshape(-1, 4),
            corner[parity == 1][:, np.array(_ODD_TETS).reshape(-1)].reshape(-1, 4),
        ]
    )
    # enforce positive orientation (jitter can flip thin tets)
    e = coords[tets[:, 1:]] - coords[tets[:, :1]]
    neg = np.linalg.det(e) < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    return coords, tets, boundary


def morton_permutation(coords: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order rank of each node: ``perm[old_id] = new_id``. Blocks of the
    renumbered ids are spatially compact but irregular — the partitioner
    stand-in that makes the ghost graph genuinely unstructured."""
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    q = ((coords - lo) / np.where(hi > lo, hi - lo, 1) * ((1 << bits) - 1)).astype(
        np.uint64
    )
    code = np.zeros(len(coords), dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    perm = np.empty(len(coords), dtype=np.int64)
    perm[np.argsort(code, kind="stable")] = np.arange(len(coords))
    return perm


def p1_elasticity_ke(
    coords: np.ndarray, tets: np.ndarray, lam: float = 1.0, mu: float = 1.0
) -> np.ndarray:
    """Vectorized 12x12 P1 tet stiffness, isotropic Hooke law.

    Standard B^T C B * vol with engineering strain (Voigt order
    xx, yy, zz, xy, yz, xz); dof order = node-major (n0x n0y n0z n1x ...)."""
    E = len(tets)
    X = coords[tets]  # (E, 4, 3)
    M = X[:, 1:] - X[:, :1]  # (E, 3, 3) edge rows
    vol = np.abs(np.linalg.det(M)) / 6.0
    # grad(lambda_a) for a = 1..3 are the rows of inv(M^T): lambda_a(x) =
    # G[a-1]·(x - X0) with G·M^T = I
    G = np.linalg.inv(np.swapaxes(M, 1, 2))
    g = np.empty((E, 4, 3))
    g[:, 1:] = G
    g[:, 0] = -G.sum(axis=1)
    B = np.zeros((E, 6, 12))
    for a in range(4):
        gx, gy, gz = g[:, a, 0], g[:, a, 1], g[:, a, 2]
        c = 3 * a
        B[:, 0, c] = gx
        B[:, 1, c + 1] = gy
        B[:, 2, c + 2] = gz
        B[:, 3, c], B[:, 3, c + 1] = gy, gx
        B[:, 4, c + 1], B[:, 4, c + 2] = gz, gy
        B[:, 5, c], B[:, 5, c + 2] = gz, gx
    C = np.diag([2 * mu + lam] * 3 + [mu] * 3).astype(float)
    C[:3, :3] += lam - np.diag([lam] * 3)
    return np.einsum("eki,kl,elj,e->eij", B, C, B, vol, optimize=True)


def _exact_disp(coords: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Smooth manufactured displacement field, (N, 3)."""
    s = coords / scale
    return np.stack(
        [
            np.sin(0.7 * s[:, 0] + 0.3) * np.cos(0.5 * s[:, 1]),
            np.cos(0.4 * s[:, 1] + 0.1) * np.sin(0.6 * s[:, 2]),
            np.sin(0.5 * s[:, 0] + 0.8 * s[:, 2]),
        ],
        axis=1,
    )


def assemble_elasticity_tet(
    parts: AbstractPData,
    nodes_per_dim: Sequence[int] = (5, 5, 5),
    jitter: float = 0.2,
    seed: int = 0,
    strict: bool = False,
):
    """Assemble the distributed elasticity system; returns (A, b, x̂, x0).
    ``strict`` takes b = A x̂ with the strict product (each row folded left
    to right, `mul_into(strict=True)`), as the JAX package assembles it
    under ``PA_TPU_STRICT_BITS=1``: the system a strict solve is held on.

    The mesh is built replicated on host (it is plan-time metadata, like
    every partitioner input); each part keeps only the elements and dofs
    it owns. Rows carry no ghosts after migration; cols carry the column
    ghost layer discovered from the kept triplets."""
    ns = tuple(int(n) for n in nodes_per_dim)
    coords0, tets0, boundary0 = tet_mesh(ns, jitter=jitter, seed=seed)
    perm = morton_permutation(coords0)
    N = len(coords0)
    coords = np.empty_like(coords0)
    coords[perm] = coords0
    boundary = np.zeros(N, dtype=bool)
    boundary[perm] = boundary0
    tets = perm[tets0]
    ndofs = 3 * N

    # node block partition (Morton-ordered) -> dof variable_partition so a
    # node's 3 dofs never split across parts
    P = parts.num_parts
    node_first = np.array([(N * p) // P for p in range(P + 1)], dtype=np.int64)
    noids = map_parts(lambda p: 3 * int(node_first[p + 1] - node_first[p]), parts)
    rows0 = variable_partition(
        parts, noids, ngids=ndofs, part_to_firstgid=3 * node_first[:-1]
    )
    node_owner = np.searchsorted(node_first, np.arange(N), side="right") - 1
    xhat = _exact_disp(coords, np.array(ns, dtype=float))

    ke_all = None  # assembled lazily once, shared by every part's closure

    def _local_coo(p):
        nonlocal ke_all
        mine = node_owner[tets[:, 0]] == p
        et = tets[mine]
        if ke_all is None:
            ke_all = p1_elasticity_ke(coords, tets)
        ke = ke_all[mine]
        # 12 global dof ids per element
        gd = (3 * et[:, :, None] + np.arange(3)).reshape(-1, 12)
        I = np.repeat(gd, 12, axis=1).reshape(-1)
        J = np.tile(gd, (1, 12)).reshape(-1)
        V = ke.reshape(-1)
        # boundary test functions drop out (identity rows added by owners);
        # boundary trial columns move to the rhs via the imposed values, a
        # fold done after compression by keeping the column and setting
        # x0/x̂ there — the reference keeps these columns too.
        keep = ~boundary[I // 3]
        return I[keep], J[keep], V[keep]

    coo = map_parts(_local_coo, parts)
    I = map_parts(lambda c: c[0].astype(GID_DTYPE), coo)
    J = map_parts(lambda c: c[1].astype(GID_DTYPE), coo)
    V = map_parts(lambda c: c[2], coo)

    def _boundary_coo(iset):
        g = np.asarray(iset.oid_to_gid)
        gb = g[boundary[g // 3]]
        return gb, gb, np.ones(len(gb))

    bcoo = map_parts(_boundary_coo, rows0.partition)
    I = map_parts(lambda a, b: np.concatenate([a, b[0]]), I, bcoo)
    J = map_parts(lambda a, b: np.concatenate([a, b[1]]), J, bcoo)
    V = map_parts(lambda a, b: np.concatenate([a, b[2]]), V, bcoo)

    A = assemble_matrix_from_coo(I, J, V, rows0)
    cols = A.cols

    def _vals(iset):
        g = np.asarray(iset.lid_to_gid)
        return xhat[g // 3, g % 3]

    x_exact = PVector(map_parts(_vals, cols.partition), cols)
    b = _matvec(A, x_exact, strict)

    def _x0(iset):
        g = np.asarray(iset.lid_to_gid)
        return np.where(boundary[g // 3], xhat[g // 3, g % 3], 0.0)

    x0 = PVector(map_parts(_x0, cols.partition), cols)
    return A, b, x_exact, x0


def elasticity_tet_driver(
    parts: AbstractPData,
    nodes_per_dim: Sequence[int] = (5, 5, 5),
    tol: float = 1e-12,
    maxiter: int = 3000,
    verbose: bool = False,
    lowering: str = "auto",
) -> Tuple[float, dict]:
    """End-to-end unstructured elasticity: assemble with off-owner triplet
    migration over an irregular ghost graph, Jacobi-PCG solve, return
    (error vs x̂, solver info). Gate: error < 1e-5 (the reference's FEM
    tolerance, test/test_fem_sa.jl:137). ``lowering`` is passed to `pcg`
    (the device's first non-band lowering tried)."""
    A, b, x_exact, x0 = assemble_elasticity_tet(parts, nodes_per_dim)
    x, info = pcg(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose, lowering=lowering)
    err = (x - x_exact).norm()
    return float(err), info
