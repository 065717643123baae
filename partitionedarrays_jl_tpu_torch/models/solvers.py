"""Distributed CG over the PData algebra.

The port's copy of the parts of `partitionedarrays_jl_tpu/models/solvers.py`
the Poisson slice needs (solvers.py:290-393, :410-522, :957): `cg`
dispatches a GPU-backend right-hand side to `parallel/gpu.py:gpu_cg` and
runs the host CG loop for anything else; `gather_pvector` collects owned
values on MAIN.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..parallel.backends import map_parts
from ..parallel.psparse import PSparseMatrix
from ..parallel.pvector import PVector, _owned, _write_owned
from ..utils.helpers import check, krylov_info, warn_tol_below_floor


def _owned_zip(dest: PVector, f, *srcs: PVector):
    """dest.owned = f(dest.owned, *src.owned), in place, across
    owned-compatible PRanges."""
    args = [dest.rows.partition, dest.values]
    for s in srcs:
        args += [s.rows.partition, s.values]

    def kernel(di, dv, *rest):
        owned_srcs = [_owned(rest[2 * k], rest[2 * k + 1]) for k in range(len(srcs))]
        _write_owned(di, dv, f(_owned(di, dv), *owned_srcs))

    map_parts(kernel, *args)


def _owned_update(dest: PVector, f, src: PVector):
    _owned_zip(dest, f, src)


def _owned_assign(dest: PVector, src: PVector):
    _owned_update(dest, lambda _d, s: s, src)


def _final_true_rel(A, x, b, rel_est, rs0_norm, tol, force=False):
    """The true final relative residual for status classification: the
    solver's own value when it already passes, else recomputed on the host
    from b - A@x."""
    if rel_est <= tol and not force:
        return rel_est
    r = b.copy()
    q = A @ x
    _owned_update(r, lambda rv, qv: rv - qv, q)
    return float(r.norm()) / max(1.0, rs0_norm)


def cg(
    A: PSparseMatrix,
    b: PVector,
    x0: Optional[PVector] = None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    verbose: bool = False,
    fused: bool = True,
) -> Tuple[PVector, dict]:
    """Conjugate gradients for SPD `A`; the start vector lives on
    ``A.cols``. A GPU-backend `b` runs the device loop (`gpu_cg`, fused
    body by default); any other backend runs the host loop below, whose
    value sequence the device bodies follow."""
    from ..parallel.gpu import GPUBackend, gpu_cg

    check(b is not None, "cg: a right-hand side b is required")
    if isinstance(b.values.backend, GPUBackend):
        return gpu_cg(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose, fused=fused)
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="cg")
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    r = b.copy()  # rows-range residual
    q = A @ x
    _owned_update(r, lambda rv, qv: rv - qv, q)
    p = PVector.full(0.0, A.cols, dtype=b.dtype)
    _owned_assign(p, r)
    rs = r.dot(r)
    rs0 = rs
    history = [np.sqrt(rs)]
    it = 0
    while np.sqrt(rs) > tol * max(1.0, np.sqrt(rs0)) and it < maxiter:
        q = A @ p
        alpha = rs / p.dot(q)
        _owned_update(x, lambda xv, pv: xv + alpha * pv, p)
        _owned_update(r, lambda rv, qv: rv - alpha * qv, q)
        rs_new = r.dot(r)
        beta = rs_new / rs
        _owned_update(p, lambda pv, rv: rv + beta * pv, r)
        rs = rs_new
        history.append(np.sqrt(rs))
        it += 1
        if verbose:
            print(f"cg it={it} residual={np.sqrt(rs):.3e}")
    return x, krylov_info(
        it, history, np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)),
        tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(
            A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
            force=floor_warned,
        ),
        cg_body="host",
    )


def gather_pvector(b: PVector) -> np.ndarray:
    """Owned values of every part placed at their gids (on MAIN)."""
    out = np.zeros(b.rows.ngids, dtype=b.dtype)
    for iset, vals in zip(b.rows.partition.part_values(), b.values.part_values()):
        out[iset.oid_to_gid] = _owned(iset, np.asarray(vals))
    return out
