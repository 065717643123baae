"""The rest of the device Krylov family on the card: BiCGStab, restarted
GMRES, MINRES, Chebyshev and the differentiable CG solve.

The counterparts of the JAX package's `make_bicgstab_fn`,
`make_gmres_fn`, `make_minres_fn`, `make_chebyshev_fn` and
`make_diff_solve_fn` (`partitionedarrays_jl_tpu/parallel/tpu.py:5021-5782`)
and of their `tpu_*` entry points. Each runs as `gpu.make_cg_fn` runs CG: a
device-resident loop (`gpu_loop.DeviceLoop`) over stacked ``(P, W)``
frames whose stopping test is a device flag, read once per block of steps;
on a CUDA device the block is a CUDA graph after the first, eager one.
Every SpMV is `gpu._spmv_body`'s, so a band operator runs K1/K4 and any
other lowering its products of `ops/irregular.py`; the dots are
`gpu._pdot_factory`'s part-order fold (E3's tree on a strict lowering).
The vector updates and scalar recurrences are eager torch ops inside the
captured block, as the JAX package computes them in XLA outside any
Pallas kernel; GMRES's basis products stay `torch.matmul` (TF32 refused).

The flag: ``live`` holds whether another step is due. It is computed at
the start (the first stopping test) and, at the end of every step, from
the step's new state (``live and cond``), so the flag the host reads after
a block already tells whether the solve is done, and no block runs past
the one that ends the solve (a solve that ends in its function's first
block captures its graph at the start of the next run,
`gpu_loop.DeviceLoop`). A step that runs with the flag at
0 is frozen: it changes nothing that the solve returns (x is kept by
``torch.where``, the scalars and the history likewise); the work vectors
(directions, Lanczos vectors), which nothing reads once the flag is 0,
are left as the frozen step computed them.

Steps: BiCGStab and MINRES take one iteration a step (blocks of
`gpu_loop.CG_BLOCK`); Chebyshev one leg of ``leg`` iterations with no
reduction inside it, so the flag is read once a leg; GMRES one restart
cycle: the ``m`` Arnoldi steps unrolled, each masked by a device flag as
the JAX package masks the steps of its flexible GMRES (tpu_gmg.py:1050),
then the cycle's finish (the padded triangular solve, ``x += V y`` and the
true residual). Unrolled, Arnoldi step j reads only the j + 1 basis rows
it has, and the finish runs once a cycle; the iteration count is the
Arnoldi steps, counted as tpu.py counts them.

Every solve function is cached on its `DeviceMatrix` by
`gpu._krylov_fn_for`.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.irregular import check_full_precision
from ..utils.helpers import check
from . import gpu_loop as gl
from .gpu import _fold_parts, _pdot_factory, _spmv_body


def _check_layout(name: str, dA, b: torch.Tensor, x0: torch.Tensor) -> None:
    shape = (dA.col_layout.P, dA.col_layout.W)
    check(tuple(b.shape) == shape and tuple(x0.shape) == shape,
          f"{name}: vectors laid out {tuple(b.shape)}/{tuple(x0.shape)}, matrix expects {shape}: "
          "build vectors with the matrix's col_layout")


def _check_minv(name: str, precond: bool, minv) -> None:
    check((minv is not None) == precond,
          f"{name}: pass minv exactly when the function was built with precond")


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _flag(cond: torch.Tensor) -> torch.Tensor:
    return cond.to(torch.int32)


def _solve_fn(loop: gl.DeviceLoop, run: Callable, **attrs) -> Callable:
    run.stats = loop.stats  # updated in place by every run
    run.loop = loop
    for k, v in attrs.items():
        setattr(run, k, v)
    return run


def make_bicgstab_fn(dA, tol: float, maxiter: int, precond: bool = False, plain: bool = False,
                     graph: bool = True) -> Callable:
    """BiCGStab on the card (tpu.py:5099-5246): ``fn(b, x0[, minv]) -> (x,
    rs, rs0, iterations, history)``. Two SpMVs an iteration, the dots by
    the part-order fold. Breakdown (rho or omega at zero, or r̂·v at zero)
    ends the solve: that step commits nothing of x, rs, the scalars or the
    history and does not count, as the JAX program's ``jnp.where(ok, ...)``
    carry keeps them (:5200-5206), and the solve reports ``converged=False``
    through its residual. With ``precond`` the loop is right-preconditioned
    by the inverse diagonal ``minv`` (its residuals stay true residuals).
    One step is one iteration; the loop continues while ``sqrt(rs) >
    tol*max(1, sqrt(rs0))``, ``it < maxiter`` and no breakdown happened.
    ``plain`` runs the kernels' plain versions (the comparison path)."""
    body = _spmv_body(dA, plain=plain)
    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + n)
    pdot = _pdot_factory(o0, n, dA.strict, plain)
    stop_it = gl.stop_bound(maxiter)

    def apply_k(v, minv):
        """K^-1 v in the column frame (right preconditioning)."""
        if minv is None:
            return v
        z = torch.zeros_like(v)
        z[:, sl] = minv[:, sl] * v[:, sl]
        return z

    def cond(rs, it, ok, thr):
        return (gl.sqrt_rn(rs) > thr) & (it < stop_it) & (ok != 0)

    def step(S):
        live = S["live"]
        x, r, rhat, p, v = S["x"], S["r"], S["rhat"], S["p"], S["v"]
        rho0, alpha0, omega0 = S["rho"], S["alpha"], S["omega"]
        one = torch.ones_like(rho0)
        minv = S.get("minv")
        rho_new = pdot(rhat, r)
        ok = (S["ok"] != 0) & (rho_new != 0) & (omega0 != 0)
        beta = torch.where(ok, (rho_new / rho0) * (alpha0 / omega0), 0)
        p[:, sl] = r[:, sl] + beta * (p[:, sl] - omega0 * v[:, sl])
        phat = apply_k(p, minv)
        v = body(phat)  # the product in the row frame: only its owned band is read
        rv = pdot(rhat, v)
        ok = ok & (rv != 0)
        alpha = torch.where(ok, rho_new / torch.where(rv == 0, one, rv), 0)
        s = torch.zeros_like(r)
        s[:, sl] = r[:, sl] - alpha * v[:, sl]
        shat = apply_k(s, minv)
        t = body(shat)
        tt = pdot(t, t)
        omega = torch.where(tt == 0, 0, pdot(t, s) / torch.where(tt == 0, one, tt))
        # the solution update rides the preconditioned directions
        g = (live != 0) & ok
        x[:, sl] = torch.where(g, x[:, sl] + (alpha * phat[:, sl] + omega * shat[:, sl]), x[:, sl])
        r[:, sl] = s[:, sl] - omega * t[:, sl]
        rs_new = pdot(r, r)
        it = S["it"] + _flag(g)
        gl.record(S["hist"], it, _flag(g), gl.sqrt_rn(rs_new))
        rs = torch.where(g, rs_new, S["rs"])
        ok_out = torch.where(live != 0, _flag(ok), S["ok"])
        return dict(
            S, v=v, rho=torch.where(g, rho_new, rho0), alpha=torch.where(g, alpha, alpha0),
            omega=torch.where(g, omega, omega0), rs=rs, it=it, ok=ok_out,
            live=live * _flag(cond(rs, it, ok_out, S["thr"])),
        )

    loop = gl.DeviceLoop(step, gl.CG_BLOCK, graph)

    def fn(b, x0, minv=None):
        _check_layout("bicgstab", dA, b, x0)
        _check_minv("make_bicgstab_fn", precond, minv)
        x = x0.clone()
        q = body(x0.clone())
        r = torch.zeros_like(x)
        r[:, sl] = b[:, sl] - q[:, sl]
        rs0 = pdot(r, r)
        one = _scalar(1.0, rs0)
        dev = x.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        ok = torch.ones((), dtype=torch.int32, device=dev)
        thr = tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0)
        init = {
            "x": x, "r": r, "rhat": r.clone(), "p": torch.zeros_like(x), "v": torch.zeros_like(q),
            "rho": one, "alpha": one.clone(), "omega": one.clone(), "rs": rs0, "it": it, "ok": ok,
            "thr": thr, "hist": gl.history(gl.sqrt_rn(rs0), maxiter), "live": _flag(cond(rs0, it, ok, thr)),
        }
        if precond:
            init["minv"] = minv
        S, _ = loop.run(init)
        return S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    return _solve_fn(loop, fn)


def _givens(h: torch.Tensor, cs: torch.Tensor, sn: torch.Tensor, j: int) -> None:
    """Apply the cycle's rotations 0..j-1 to the column ``h`` (entries
    0..j), in place and in order (tpu.py:5337-5347)."""
    for i in range(j):
        t = cs[i] * h[i] + sn[i] * h[i + 1]
        u = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = t
        h[i + 1] = u


def make_gmres_fn(dA, restart: int, tol: float, maxiter: int, precond: bool = False, plain: bool = False,
                  graph: bool = True) -> Callable:
    """Restarted GMRES(m) on the card (tpu.py:5248-5440): ``fn(b, x0[, minv])
    -> (x, rs, rs0, iterations, history)``. The Arnoldi basis is a ``(P,
    m+1, n)`` array of owned regions; each Arnoldi step orthogonalises by
    classical Gram-Schmidt twice (CGS2), the basis products per part as
    ``torch.matmul`` over the rows the cycle has, their partials folded in
    part order; Givens rotations, the triangular solve and the restarts run
    on the card. With ``precond`` the iteration is left-preconditioned by
    the inverse diagonal ``minv`` (the residuals are the preconditioned
    ones). One step of the device loop is one restart cycle: its ``m``
    Arnoldi steps unrolled, step j active while the cycle's steps before it
    were, ``it < maxiter``, no lucky breakdown and the Givens residual
    estimate above ``tol*max(1, sqrt(rs0))``; the cycle then solves the
    triangular system padded to m x m (identity columns and zero right-hand
    side past the steps taken: the j-size solution exactly), updates x,
    recomputes the true residual and writes it over the last history
    entry, as tpu.py's outer step does. The loop runs cycles while that
    residual is above the threshold, ``it < maxiter`` and no lucky
    breakdown ended a cycle. ``iterations`` counts Arnoldi steps."""
    m = int(restart)
    check(m >= 1, "gmres: restart dimension must be >= 1")
    body = _spmv_body(dA, plain=plain)
    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + n)
    pdot = _pdot_factory(o0, n, dA.strict, plain)
    odot = _pdot_factory(0, n, dA.strict, plain)  # dots of owned-region (P, n) arrays
    stop_it = gl.stop_bound(maxiter)

    def residual_owned(x, b, minv):
        y = body(x)
        r = b[:, sl] - y[:, sl]
        return minv[:, sl] * r if minv is not None else r

    def apply_op(v_own, minv, like):
        z = torch.zeros_like(like)
        z[:, sl] = v_own
        w = body(z)[:, sl]
        return minv[:, sl] * w if minv is not None else w

    def basis_dots(Vj, w):
        """(j+1,) = sum over parts of V_p[:j+1] @ w_p, parts in order."""
        return _fold_parts(torch.matmul(Vj, w.unsqueeze(-1)).squeeze(-1))

    def step(S):
        live = S["live"]
        x, r, V, b = S["x"], S["r"], S["V"], S["b"]
        minv = S.get("minv")
        thr = S["thr"]
        beta = S["res"]
        one = torch.ones_like(beta)
        bsafe = beta > 0
        V[:, 0] = torch.where(bsafe, r / torch.where(bsafe, beta, one), 0.0 * r)
        R = torch.zeros((m, m), dtype=beta.dtype, device=beta.device)
        cs = torch.zeros(m, dtype=beta.dtype, device=beta.device)
        sn = torch.zeros_like(cs)
        g = torch.zeros(m + 1, dtype=beta.dtype, device=beta.device)
        g[0] = beta
        active = live != 0
        it, res, ok = S["it"], beta, torch.ones_like(live, dtype=torch.bool)
        j_used = torch.zeros_like(live)
        hist = S["hist"]
        for j in range(m):
            active = active & (it < stop_it) & ok & (res > thr)
            w = apply_op(V[:, j], minv, x)
            Vj = V[:, : j + 1]
            h1 = basis_dots(Vj, w)
            w = w - torch.matmul(h1, Vj)
            h2 = basis_dots(Vj, w)
            w = w - torch.matmul(h2, Vj)
            h = h1 + h2
            hj1 = gl.sqrt_rn(odot(w, w))
            _givens(h, cs, sn, j)
            hjj = h[j]
            rho = gl.sqrt_rn(hjj * hjj + hj1 * hj1)
            safe = rho > 0
            c = torch.where(safe, hjj / torch.where(safe, rho, one), one)
            s = torch.where(safe, hj1 / torch.where(safe, rho, one), 0)
            cs[j], sn[j] = c, s
            h[j] = rho
            R[: j + 1, j] = h
            gj = g[j].clone()
            g[j] = c * gj
            g[j + 1] = -s * gj
            res_j = torch.abs(g[j + 1])
            ok_j = hj1 > 0  # hj1 == 0: lucky breakdown, the cycle ends after this step
            # a basis row an inactive step writes is 0, so nothing stale enters x
            V[:, j + 1] = torch.where(active & ok_j, w / torch.where(ok_j, hj1, one), 0.0 * w)
            it = it + _flag(active)
            gl.record(hist, it, _flag(active), res_j)
            res = torch.where(active, res_j, res)
            ok = torch.where(active, ok_j, ok)
            j_used = torch.where(active, j + 1, j_used)
        used = torch.arange(m, device=beta.device) < j_used
        Rp = torch.where(used[None, :], R, torch.eye(m, dtype=R.dtype, device=R.device))
        gp = torch.where(used, g[:m], 0)
        y = torch.linalg.solve_triangular(Rp, gp.unsqueeze(-1), upper=True).squeeze(-1)
        x[:, sl] = x[:, sl] + torch.matmul(y, V[:, :m])
        # the Givens estimate drifts from the true residual under roundoff;
        # the cycle's end recomputes it (tpu.py:5389-5392)
        r_new = residual_owned(x, b, minv)
        res_true = gl.sqrt_rn(odot(r_new, r_new))
        gl.record(hist, it, live, res_true)
        res_out = torch.where(live != 0, res_true, S["res"])
        ok_out = torch.where(live != 0, _flag(ok), S["ok"])
        go = (res_out > thr) & (it < stop_it) & (ok_out != 0)
        return dict(S, r=r_new, it=it, res=res_out, ok=ok_out, live=live * _flag(go))

    loop = gl.DeviceLoop(step, 1, graph)

    def fn(b, x0, minv=None):
        _check_layout("gmres", dA, b, x0)
        _check_minv("make_gmres_fn", precond, minv)
        check_full_precision(b.dtype, b.device, "GMRES's basis products", "")
        x = x0.clone()
        r = residual_owned(x, b, minv)
        rs0 = odot(r, r)
        res = gl.sqrt_rn(rs0)
        dev = x.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        thr = tol * torch.clamp(res, min=1.0)
        init = {
            "x": x, "b": b, "r": r, "V": torch.zeros((r.shape[0], m + 1, n), dtype=r.dtype, device=dev),
            "res": res, "it": it, "ok": torch.ones((), dtype=torch.int32, device=dev), "thr": thr,
            "hist": gl.history(res, maxiter), "live": _flag((res > thr) & (it < stop_it)),
        }
        if precond:
            init["minv"] = minv
        S, _ = loop.run(init)
        res = S["res"].clone()
        return S["x"].clone(), res * res, rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    return _solve_fn(loop, fn)


def make_minres_fn(dA, tol: float, maxiter: int, plain: bool = False, graph: bool = True) -> Callable:
    """MINRES (Paige-Saunders) on the card (tpu.py:5441-5592): ``fn(b, x0)
    -> (x, rs, rs0, iterations, history)`` for symmetric, possibly
    indefinite operators, unpreconditioned: the three-term Lanczos
    recurrence and one Givens rotation an iteration, one SpMV and two
    dots. A step with rho == 0 (hard breakdown) commits nothing and ends
    the solve; a lucky breakdown (beta == 0, rho != 0) commits its step and
    ends it; the loop continues while ``|eta| > tol*max(1, beta0)`` and
    ``it < maxiter``. One step is one iteration."""
    body = _spmv_body(dA, plain=plain)
    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + n)
    pdot = _pdot_factory(o0, n, dA.strict, plain)
    stop_it = gl.stop_bound(maxiter)

    def owned(vals, like):
        out = torch.zeros_like(like)
        out[:, sl] = vals
        return out

    def step(S):
        live = S["live"]
        x, v, v_old, w, w_old = S["x"], S["v"], S["v_old"], S["w"], S["w_old"]
        c_old, s_old, c, s, eta, beta_k = S["c_old"], S["s_old"], S["c"], S["s"], S["eta"], S["beta_k"]
        one = torch.ones_like(eta)
        av = body(v)
        alpha = pdot(v, av)
        lan = owned(av[:, sl] - alpha * v[:, sl] - beta_k * v_old[:, sl], x)
        beta_new = gl.sqrt_rn(pdot(lan, lan))
        delta = c * alpha - c_old * s * beta_k
        gamma2 = s * alpha + c_old * c * beta_k
        gamma3 = s_old * beta_k
        rho = gl.sqrt_rn(delta * delta + beta_new * beta_new)
        valid = rho != 0
        cont = valid & (beta_new > 0)
        rho_s = torch.where(valid, rho, one)
        c_new = delta / rho_s
        s_new = beta_new / rho_s
        w_new = owned((v[:, sl] - gamma2 * w[:, sl] - gamma3 * w_old[:, sl]) / rho_s, x)
        g = (live != 0) & valid
        x[:, sl] = torch.where(g, x[:, sl] + c_new * eta * w_new[:, sl], x[:, sl])
        eta_new = -s_new * eta
        nsafe = beta_new > 0
        v_new = owned(torch.where(nsafe, lan[:, sl] / torch.where(nsafe, beta_new, one), 0.0), x)
        res_new = torch.abs(eta_new)
        it = S["it"] + _flag(g)
        gl.record(S["hist"], it, _flag(g), res_new)

        def keep(new, old):
            return torch.where(g, new, old)

        res = keep(res_new, S["res"])
        ok = torch.where(live != 0, _flag((S["ok"] != 0) & cont), S["ok"])
        go = (res > S["thr"]) & (it < stop_it) & (ok != 0)
        return dict(
            S, v=v_new, v_old=v, w=w_new, w_old=w, c_old=keep(c, c_old), s_old=keep(s, s_old),
            c=keep(c_new, c), s=keep(s_new, s), eta=keep(eta_new, eta), beta_k=keep(beta_new, beta_k),
            res=res, it=it, ok=ok, live=live * _flag(go),
        )

    loop = gl.DeviceLoop(step, gl.CG_BLOCK, graph)

    def fn(b, x0):
        _check_layout("minres", dA, b, x0)
        x = x0.clone()
        q = body(x0.clone())
        r = owned(b[:, sl] - q[:, sl], x)
        rs0 = pdot(r, r)
        beta0 = gl.sqrt_rn(rs0)
        one, zero = _scalar(1.0, rs0), _scalar(0.0, rs0)
        bsafe = beta0 > 0
        v = owned(torch.where(bsafe, r[:, sl] / torch.where(bsafe, beta0, one), 0.0), x)
        dev = x.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        thr = tol * torch.clamp(beta0, min=1.0)
        init = {
            "x": x, "v": v, "v_old": torch.zeros_like(x), "w": torch.zeros_like(x), "w_old": torch.zeros_like(x),
            "c_old": one, "s_old": zero, "c": one.clone(), "s": zero.clone(), "eta": beta0.clone(),
            "beta_k": zero.clone(), "res": beta0, "it": it, "ok": torch.ones((), dtype=torch.int32, device=dev),
            "thr": thr, "hist": gl.history(beta0, maxiter), "live": _flag((beta0 > thr) & (it < stop_it)),
        }
        S, _ = loop.run(init)
        res = S["res"].clone()
        return S["x"].clone(), res * res, rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    return _solve_fn(loop, fn)


#: Chebyshev iterations a leg: the loop reads its flag, and takes its one
#: reduction, once a leg (tpu.py:5623's ``leg``)
CHEBYSHEV_LEG = 16


def make_chebyshev_fn(dA, lmin: float, lmax: float, tol: float, maxiter: int, plain: bool = False,
                      graph: bool = True) -> Callable:
    """Chebyshev iteration on the card (tpu.py:5623-5711): ``fn(b, x0) ->
    (x, rs, rs0, iterations, history)`` for an SPD operator with its
    spectrum in [lmin, lmax], bounds fixed when the function is built. One
    step of the device loop is one leg of `CHEBYSHEV_LEG` iterations with no
    reduction inside it (the only traffic between parts is the SpMV's halo
    exchange); one residual dot a leg decides the stop, so the flag is read
    once a leg. The loop continues while ``sqrt(rs) > tol*max(1,
    sqrt(rs0))`` and ``it < maxiter``, ``it`` counting whole legs; the
    history holds one entry a leg."""
    body = _spmv_body(dA, plain=plain)
    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + n)
    pdot = _pdot_factory(o0, n, dA.strict, plain)
    stop_it = gl.stop_bound(maxiter)
    leg = CHEBYSHEV_LEG
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    n_legs = -(-int(maxiter) // leg)

    def step(S):
        live = S["live"]
        x, r, d, rho = S["x"], S["r"], S["d"], S["rho"]
        x_kept = x[:, sl].clone()
        for _ in range(leg):
            x[:, sl] = x[:, sl] + d[:, sl]
            q = body(d)
            r[:, sl] = r[:, sl] + (-q[:, sl])
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d[:, sl] = rho_new * rho * d[:, sl] + (2.0 * rho_new / delta) * r[:, sl]
            rho = rho_new
        rs_new = pdot(r, r)
        x[:, sl] = torch.where(live != 0, x[:, sl], x_kept)
        it = S["it"] + leg * live
        gl.record(S["hist"], torch.div(it, leg, rounding_mode="floor"), live, gl.sqrt_rn(rs_new))
        rs = torch.where(live != 0, rs_new, S["rs"])
        go = (gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it)
        return dict(S, rho=rho, rs=rs, it=it, live=live * _flag(go))

    loop = gl.DeviceLoop(step, 1, graph)

    def fn(b, x0):
        _check_layout("chebyshev", dA, b, x0)
        x = x0.clone()
        q = body(x0.clone())
        r = torch.zeros_like(x)
        r[:, sl] = b[:, sl] - q[:, sl]
        rs0 = pdot(r, r)
        d = torch.zeros_like(x)
        d[:, sl] = r[:, sl] / theta
        dev = x.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        thr = tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0)
        init = {
            "x": x, "r": r, "d": d, "rho": _scalar(1.0 / sigma1, rs0), "rs": rs0, "it": it, "thr": thr,
            "hist": gl.history(gl.sqrt_rn(rs0), n_legs), "live": _flag((gl.sqrt_rn(rs0) > thr) & (it < stop_it)),
        }
        S, _ = loop.run(init)
        return S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    return _solve_fn(loop, fn, leg=leg)


def make_diff_solve_fn(dA, tol: float = 1e-10, maxiter: Optional[int] = None, minv=None) -> Callable:
    """Differentiable ``x = A^{-1} b`` (tpu.py:5021-5097): a function of a
    ``(P, W)`` column-frame tensor b returning the ``(P, W)`` solution with
    every slot outside the owned regions exactly 0, as a
    `torch.autograd.Function`. Forward is the CG solve (the function
    `gpu._krylov_fn_for` caches on ``dA``) of the masked b; backward is the
    same solve of the masked cotangent x̄: for symmetric positive definite
    A, b̄ = A^{-T} x̄ = A^{-1} x̄ (the implicit-function theorem), so one
    backward pass costs one solve on the loop forward already captured.
    ``minv`` (an inverse diagonal in the column frame) makes both solves
    Jacobi PCG. A must be truly symmetric: Dirichlet conditions imposed as
    identity rows are not (decouple them first). A solve that does not
    converge warns: the value and its gradient are then inaccurate."""
    from .gpu import _krylov_fn_for

    if maxiter is None:
        maxiter = 4 * int(dA.rows.ngids)
    solve = _krylov_fn_for(dA, "cg", tol, int(maxiter), precond=minv is not None)
    L = dA.col_layout
    mask_np = np.zeros((L.P, L.W), dtype=bool)
    for p in range(L.P):
        mask_np[p, L.o0 : L.o0 + int(L.noids[p])] = True
    mask = torch.from_numpy(mask_np).to(dA.backend.device)

    def solve_masked(v):
        args = (v * mask, torch.zeros_like(v)) + ((minv,) if minv is not None else ())
        # the solve returns copies: the loop's buffers are reused by the next run
        x, rs, rs0, it, _hist = solve(*args)
        rs, rs0 = float(rs), float(rs0)
        if not math.sqrt(rs) <= tol * max(1.0, math.sqrt(rs0)):
            warnings.warn(
                f"make_diff_solve_fn: CG stopped at {int(it)} iterations with residual "
                f"{math.sqrt(rs):.3e} (tol {tol:.1e}): the value AND its gradient are inaccurate",
                stacklevel=3,
            )
        return x * mask

    class DiffSolve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, b):
            return solve_masked(b)

        @staticmethod
        def backward(ctx, xbar):
            return solve_masked(xbar)

    def f(b):
        return DiffSolve.apply(b)

    f.solve = solve
    return f


# ---------------------------------------------------------------------------
# entry points on GPU-backend PVectors
# ---------------------------------------------------------------------------


def _device_solve(name: str, A, b, maxiter, box: bool = True):
    from .gpu import GPUBackend, device_matrix

    backend = b.values.backend
    check(isinstance(backend, GPUBackend), f"gpu_{name} needs a GPU-backend PVector")
    maxiter = int(maxiter if maxiter is not None else 4 * A.rows.ngids)
    return device_matrix(A, backend, box), maxiter


def gpu_bicgstab(A, b, x0=None, tol: float = 1e-8, maxiter: Optional[int] = None, minv=None,
                 verbose: bool = False, plain: bool = False, box: bool = True):
    """Device BiCGStab on the GPU backend, the counterpart of `tpu_bicgstab`
    (tpu.py:6276-6306): `make_bicgstab_fn`'s loop, cached on A's lowering
    (`gpu._krylov_fn_for`); ``minv`` (an inverse-diagonal PVector over
    A.cols) right-preconditions it. ``plain`` runs the kernels' plain
    versions; ``box=False`` takes the generic layout and exchange plan, as
    in `gpu_cg`. Returns ``(x, info)``; ``info["lowering"]`` names A's
    lowering."""
    from .gpu import _krylov_fn_for, _run_krylov

    dA, maxiter = _device_solve("bicgstab", A, b, maxiter, box)
    solve = _krylov_fn_for(dA, "bicgstab", tol, maxiter, precond=minv is not None, plain=plain)
    return _run_krylov(A, b, x0, tol, verbose, solve, "bicgstab", minv=minv, dA=dA, lowering=dA.lowering)


def gpu_gmres(A, b, x0=None, restart: int = 30, tol: float = 1e-8, maxiter: Optional[int] = None, minv=None,
              verbose: bool = False, plain: bool = False, health: bool = True):
    """Device restarted GMRES(m), m = ``restart``, on the GPU backend, the
    counterpart of `tpu_gmres` (tpu.py:5593-5622): `make_gmres_fn`'s loop,
    cached on A's lowering; ``minv`` left-preconditions it (the residuals
    are then the preconditioned ones). ``info["device_loop"]`` counts
    restart cycles (one loop step each); ``iterations`` Arnoldi steps."""
    from .gpu import _krylov_fn_for, _run_krylov

    dA, maxiter = _device_solve("gmres", A, b, maxiter)
    solve = _krylov_fn_for(dA, "gmres", tol, maxiter, precond=minv is not None, plain=plain, restart=int(restart))
    return _run_krylov(A, b, x0, tol, verbose, solve, "gmres", minv=minv, dA=dA, lowering=dA.lowering,
                       health=health, restart=int(restart))


def gpu_minres(A, b, x0=None, tol: float = 1e-8, maxiter: Optional[int] = None, verbose: bool = False,
               plain: bool = False):
    """Device MINRES on the GPU backend, the counterpart of `tpu_minres`
    (tpu.py:5567-5590): `make_minres_fn`'s loop, cached on A's lowering."""
    from .gpu import _krylov_fn_for, _run_krylov

    dA, maxiter = _device_solve("minres", A, b, maxiter)
    solve = _krylov_fn_for(dA, "minres", tol, maxiter, plain=plain)
    return _run_krylov(A, b, x0, tol, verbose, solve, "minres", dA=dA, lowering=dA.lowering)


def gpu_chebyshev(A, b, lmin: float, lmax: float, x0=None, tol: float = 1e-8, maxiter: Optional[int] = None,
                  verbose: bool = False, plain: bool = False):
    """Device Chebyshev iteration on the GPU backend, the counterpart of
    `tpu_chebyshev` (tpu.py:5714-5782): `make_chebyshev_fn`'s loop, cached
    on A's lowering per bounds. The residual history holds one entry a leg
    (``residuals_every``), its NaN tail removed; maxiter defaults to 10
    times the size."""
    from ..models.solvers import _final_true_rel
    from ..utils.helpers import krylov_info, warn_tol_below_floor
    from .gpu import DeviceVector, PVector, _b_on_cols_layout, _krylov_fn_for

    floor_warned = warn_tol_below_floor(tol, b.dtype, name="chebyshev")
    maxiter = int(maxiter if maxiter is not None else 10 * A.rows.ngids)
    dA, maxiter = _device_solve("chebyshev", A, b, maxiter)
    backend = b.values.backend
    solve = _krylov_fn_for(dA, "chebyshev", tol, maxiter, plain=plain, lmin=float(lmin), lmax=float(lmax))
    x0 = x0 if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    x_data, rs, rs0, it, hist = solve(_b_on_cols_layout(b, dA), DeviceVector.from_pvector(x0, backend, dA.col_layout).data)
    x = DeviceVector(x_data, A.cols, dA.col_layout, backend).to_pvector()
    rs, rs0 = float(rs), float(rs0)
    residuals = hist[~np.isnan(hist)]
    leg = solve.leg
    if verbose:
        for i, res in enumerate(residuals[1:], start=1):
            print(f"chebyshev leg={i} (it={leg * i}) residual={res:.3e}")
    converged = bool(np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)))
    return x, krylov_info(
        it, residuals, converged, tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
                                  force=floor_warned),
        residuals_every=leg, device_loop=dict(solve.stats), lowering=dA.lowering,
    )
