"""LOBPCG on the card: the block eigensolve as one device loop.

The counterpart of `partitionedarrays_jl_tpu/parallel/tpu_lobpcg.py`. The
blocks of k vectors live as owned slabs ``(P, no_max, k)`` of the
operator's column frame; every iteration runs

* the block SpMV of the residual directions W, one launch for the m
  columns through the lowering's slab form (`_spmv_body(block=True)`:
  `dia_coded_spmm` / `dia_stream_spmm` on a band, the slab forms of SD,
  BSR and ELL), the A-images of X and P combined with the Ritz
  coefficients instead of recomputed;
* the (3m, 3m) Gram products of the basis ``S = [X | W | P]`` with
  ``A S`` and with itself, per-part partials folded in part order (the
  fold of every dot of the port);
* the whitened Rayleigh–Ritz: eigenvalues of the Gram matrix below
  1e-10 of the largest are clamped and their directions pushed past the
  sought end of the spectrum by a large diagonal penalty (the JAX
  package's fixed-shape stabilisation, tpu_lobpcg.py:113-170), so the
  trajectory is the device program's, not the host loop's, and the gate
  between the two is eigenpair agreement;
* the convergence test ``|r_i| <= tol*max(1, |lambda_i|)`` for all i.

The two small symmetric eigenproblems an iteration (3m x 3m) go to the
host: ``torch.linalg.eigh`` on a CUDA tensor checks its result on the
host, which a CUDA-graph capture refuses, so the loop runs uncaptured
(`gpu_loop.DeviceLoop` with ``graph=False``, one iteration a block) and
copies the two Gram matrices to the host and the (3m, m) coefficients
back once an iteration. The eigensolves are a library call, as the JAX
package's are (`jnp.linalg.eigh`, outside any Pallas kernel).

Preconditioners: none, a diagonal (the inverse diagonal on the column
frame, applied on the owned band) or a `models.gmg.GMGHierarchy` built on
the same operator, whose whole cycle (`gpu_gmg.make_vcycle`) is applied to
each residual column.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..utils.helpers import check
from . import gpu_loop as gl
from .gpu import DeviceVector, GPUBackend, _fold_parts, _spmv_body, device_matrix
from .pvector import PVector

#: Ritz value penalty of a clamped (near-dependent) direction, relative to
#: the reduced matrix's largest entry (tpu_lobpcg.py:159)
PENALTY = 1e12
#: Gram eigenvalues at or below this fraction of the largest are clamped
WHITEN_FLOOR = 1e-10


def _whiten(G: torch.Tensor):
    """``(Q / sqrt(w), bad)`` of the symmetric Gram matrix G (on the host):
    its eigenvalues at or below WHITEN_FLOOR times the largest are replaced
    by the largest and flagged ``bad``."""
    w, Q = torch.linalg.eigh(G)
    wmax = torch.clamp(w[-1], min=1e-300 if G.dtype == torch.float64 else 1e-38)
    bad = w <= wmax * WHITEN_FLOOR
    ws = torch.where(bad, wmax, w)
    return Q / torch.sqrt(ws)[None, :], bad


def _ritz(G_a: torch.Tensor, G_m: torch.Tensor, m: int, sgn: float) -> torch.Tensor:
    """The (3m, m) coefficients of the m sought Ritz vectors in the basis
    whose Gram matrices with A S and S are G_a and G_m (on the host)."""
    Bw, bad = _whiten(G_m)
    red = Bw.T @ (sgn * G_a) @ Bw
    big = PENALTY * (1.0 + torch.max(torch.abs(red)))
    red = red + torch.diag(big * bad.to(red.dtype))
    red = 0.5 * (red + red.T)
    _, Q_r = torch.linalg.eigh(red)
    return Bw @ Q_r[:, :m]


def make_lobpcg_fn(dA, nev: int, tol: float, maxiter: int, largest: bool = False, precond: bool = False,
                   gmg_h=None, plain: bool = False):
    """The LOBPCG solve on a lowered operator (tpu_lobpcg.py:38-216):
    ``fn(X0, mv) -> (X, lam, res, iterations, history)`` with X0 the
    ``(P, no_max, nev)`` owned start block (made orthonormal first), ``mv``
    the inverse diagonal on the column frame with ``precond`` (else None),
    X the Ritz vectors in the same layout, ``lam`` and ``res`` their values
    and residual norms sorted by the sought end, and the (maxiter, nev)
    history of residual norms, NaN past the last iteration. ``gmg_h``
    applies the hierarchy's cycle to each residual column (its level-0
    operator must share dA's frame). ``plain`` runs the kernels' plain
    versions. ``fn.stats`` describes the last run."""
    m = int(nev)
    check(m >= 1, "lobpcg: nev must be >= 1")
    body = _spmv_body(dA, plain=plain, block=True)
    L, Lr = dA.col_layout, dA.row_layout
    no = L.no_max
    sl = slice(L.o0, L.o0 + no)
    sgn = -1.0 if largest else 1.0
    vcycle = None
    if gmg_h is not None:
        from .gpu_gmg import device_hierarchy, make_vcycle

        dh = device_hierarchy(gmg_h, dA.backend)
        L0 = dh["levels"][0]["dA"].col_layout
        check(L0.W == L.W and L0.o0 == L.o0,
              "lobpcg: the hierarchy's level-0 frame differs from A's; build the hierarchy from the operator "
              "being solved")
        vcycle = make_vcycle(gmg_h, dh, plain=plain)

    def fold(part):
        return _fold_parts(part)

    def spmv_rows(B):
        z = torch.zeros((B.shape[0], L.W, B.shape[2]), dtype=B.dtype, device=B.device)
        z[:, sl] = B
        return body(z)[:, Lr.o0 : Lr.o0 + no]

    def gram(U, V):
        return fold(torch.matmul(U.transpose(1, 2), V))

    def rownorms(B):
        return gl.sqrt_rn(fold((B * B).sum(dim=1)))

    def unit(B):
        nrm = rownorms(B)
        return B / torch.where(nrm > 0, nrm, torch.ones_like(nrm))

    def rayleigh(X, AX):
        return fold((X * AX).sum(dim=1)) / fold((X * X).sum(dim=1))

    def unconverged(lam, res, it):
        good = res <= tol * torch.clamp(torch.abs(lam), min=1.0)
        return ((~torch.all(good)) & (it < maxiter)).to(torch.int32)

    def precondition(R, mv):
        if vcycle is not None:
            cols = []
            for i in range(m):
                rv = torch.zeros((R.shape[0], L.W), dtype=R.dtype, device=R.device)
                rv[:, sl] = R[..., i]
                cols.append(vcycle(rv)[:, sl])
            return torch.stack(cols, dim=-1)
        if mv is not None:
            return R * mv[:, sl, None]
        return R

    def step(S):
        if not bool(S["live"].item()):
            return S  # a converged start: the loop's one block changes nothing
        X, AX, Pd, AP, lam, it = S["X"], S["AX"], S["P"], S["AP"], S["lam"], S["it"]
        W = unit(precondition(AX - lam * X, S.get("mv")))
        Pn = unit(Pd)
        pnrm = rownorms(Pd)
        APn = AP / torch.where(pnrm > 0, pnrm, torch.ones_like(pnrm))
        Sb = torch.cat([X, W, Pn], dim=-1)  # (P, no, 3m)
        ASb = torch.cat([AX, spmv_rows(W), APn], dim=-1)
        G_a, G_m = gram(Sb, ASb), gram(Sb, Sb)
        C = _ritz(G_a.cpu(), G_m.cpu(), m, sgn).to(X.device)
        Cp = C.clone()
        Cp[:m] = 0
        X_new, AX_new = torch.matmul(Sb, C), torch.matmul(ASb, C)
        lam_new = rayleigh(X_new, AX_new)
        res_new = rownorms(AX_new - lam_new * X_new)
        hist = S["hist"]
        hist[min(int(it.item()), hist.shape[0] - 1)] = res_new
        it_new = it + 1
        return dict(S, X=X_new, AX=AX_new, P=torch.matmul(Sb, Cp), AP=torch.matmul(ASb, Cp), lam=lam_new,
                    res=res_new, it=it_new, live=unconverged(lam_new, res_new, it_new))

    loop = gl.DeviceLoop(step, 1, graph=False)

    def fn(X0, mv=None):
        check((mv is not None) == precond, "make_lobpcg_fn: pass mv exactly when the function was built with precond")
        B0, _ = _whiten(gram(X0, X0).cpu())
        X = torch.matmul(X0, B0.to(X0.device))
        AX = spmv_rows(X)
        lam = rayleigh(X, AX)
        res = rownorms(AX - lam * X)
        it = torch.zeros((), dtype=torch.int32, device=X.device)
        init = {
            "X": X, "AX": AX, "P": torch.zeros_like(X), "AP": torch.zeros_like(X), "lam": lam, "res": res,
            "it": it, "live": unconverged(lam, res, it),
            "hist": torch.full((max(int(maxiter), 1), m), float("nan"), dtype=X.dtype, device=X.device),
        }
        if mv is not None:
            init["mv"] = mv
        S, _ = loop.run(init)
        order = torch.argsort(sgn * S["lam"])
        return (S["X"][..., order].clone(), S["lam"][order].clone(), S["res"][order].clone(), int(S["it"].item()),
                S["hist"].cpu().numpy())

    fn.stats = loop.stats
    fn.loop = loop
    fn.nev = m
    return fn


def _lobpcg_fn_for(dA, m, tol, maxiter, largest, precond, gmg_h, plain):
    """`make_lobpcg_fn`'s function cached on the lowering (`dA._fn_cache`),
    keyed by nev, tol, maxiter, the sought end, the preconditioner kind and
    plain; a hierarchy by its id, the entry dropped when the hierarchy dies
    (tpu_lobpcg.py:249-284)."""
    from .gpu import STATS

    key = ("lobpcg", m, float(tol), int(maxiter), bool(largest), bool(precond),
           None if gmg_h is None else id(gmg_h), bool(plain))
    if key not in dA._fn_cache:
        STATS["solve_fns"] += 1
        dA._fn_cache[key] = make_lobpcg_fn(dA, m, tol, maxiter, largest, precond, gmg_h=gmg_h, plain=plain)
        if gmg_h is not None:
            weakref.finalize(gmg_h, dA._fn_cache.pop, key, None)
    return dA._fn_cache[key]


def gpu_lobpcg(A, nev: int = 1, X0=None, minv=None, tol: float = 1e-6, maxiter: int = 200,
               largest: bool = False, seed: int = 0, verbose: bool = False, plain: bool = False):
    """Device LOBPCG, the counterpart of `tpu_lobpcg` (tpu_lobpcg.py:218):
    the ``nev`` smallest (or ``largest``) eigenpairs of symmetric A.
    ``minv`` is None, an inverse-diagonal PVector or a `GMGHierarchy` on
    A; X0 (nev PVectors) or seeded normal starts on each part's owned
    entries (the JAX package's seeds). Returns ``(eigenvalues, eigenvectors
    as PVectors over A.cols, info)`` with ``iterations``,
    ``residual_norms`` (one row an iteration) and ``converged``.
    ``plain`` runs the kernels' plain versions (the comparison path)."""
    from ..models.gmg import GMGHierarchy

    backend = A.values.backend
    check(isinstance(backend, GPUBackend), "gpu_lobpcg needs the GPU backend")
    gmg_h = minv if isinstance(minv, GMGHierarchy) else None
    check(minv is None or gmg_h is not None or isinstance(minv, PVector),
          "gpu_lobpcg takes a diagonal PVector or GMGHierarchy preconditioner; for other callables use "
          "models.solvers.lobpcg (the host loop)")
    m = int(nev)
    dA = device_matrix(A, backend)
    L = dA.col_layout
    solve = _lobpcg_fn_for(dA, m, tol, maxiter, largest, minv is not None and gmg_h is None, gmg_h, plain)
    dt = A.dtype
    Xs = np.zeros((L.P, L.no_max, m), dtype=dt)
    if X0 is not None:
        check(len(X0) == m, "gpu_lobpcg: X0 must hold nev vectors")
        for k, v in enumerate(X0):
            Xs[:, :, k] = DeviceVector.from_pvector(v, backend, L).data.cpu().numpy()[:, L.o0 : L.o0 + L.no_max]
    else:
        for p, iset in enumerate(A.cols.partition.part_values()):
            for k in range(m):
                rng = np.random.default_rng(seed + 7919 * k + int(iset.part))
                Xs[p, : iset.num_oids, k] = rng.standard_normal(iset.num_oids)
    X0d = torch.from_numpy(Xs).to(backend.device)
    mv = None
    if minv is not None and gmg_h is None:
        mv = DeviceVector.from_pvector(minv, backend, L).data.to(X0d.dtype)
    Xd, lam, res, it, hist = solve(X0d, mv)
    lam = lam.cpu().numpy()
    res = res.cpu().numpy()
    Xh = Xd.cpu().numpy()
    vecs = []
    for k in range(m):
        full = np.zeros((L.P, L.W), dtype=dt)
        full[:, L.o0 : L.o0 + L.no_max] = Xh[..., k]
        vecs.append(DeviceVector(torch.from_numpy(full).to(backend.device), A.cols, L, backend).to_pvector())
    hist = hist[~np.isnan(hist[:, 0])]
    if verbose:
        for i, row in enumerate(hist):
            print(f"lobpcg it={i + 1} max|r|={row.max():.3e}")
    return lam, vecs, {
        "iterations": it,
        "residual_norms": hist,
        "converged": bool(np.all(res <= tol * np.maximum(1.0, np.abs(lam)))),
        "device_loop": dict(solve.stats),
    }
