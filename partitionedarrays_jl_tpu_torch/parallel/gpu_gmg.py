"""Geometric multigrid on the card: the V-cycle (every level's SpMVs, halo
exchanges, Jacobi sweeps, inter-level transfers and the dense coarse solve)
on stacked ``(P, W)`` tensors, and the V-cycle-preconditioned CG.

The counterpart of `partitionedarrays_jl_tpu/parallel/tpu_gmg.py`, with
its one transfer route for the generic exchange plan: the factored
transfer P = S·E (`_stage_structured_transfer`, tpu_gmg.py:322-405,
non-box branch :381-385). S is the square interpolation stencil, lowered
like any operator (the coded-DIA kernel); E embeds coarse points at the
even fine points through an element-gather index map ``emb``. The box
exchange plan, its matrix-free stencil transfers and the strided-box
``emb_fast`` embedding wait for ROADMAP Queue D item 3.

Frames: every level vector lives in the level operator's column frame;
the S operand and product have their own frames. All frames are compact
with the owned band at ``o0``, so a move between frames is an owned-slice
copy, and every move below names its source and destination slices. The
coarse solve is one mat-vec with the host-computed dense inverse.

The PCG loop runs in Python and reads the stopping test once per iteration,
as `gpu.make_cg_fn` does; ``plain=True`` runs the kernels' plain versions
on the same tensors (the comparison path of chip_smoke.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.solvers import _dense, gather_psparse
from ..utils.helpers import check
from .gpu import (
    DeviceVector,
    GPUBackend,
    _pdot_factory,
    _run_krylov,
    _spmv_body,
    device_exchange_plan,
    device_matrix,
    exchange_,
)
from .pvector import PVector


def _stage_structured_transfer(h, li: int, backend: GPUBackend) -> dict:
    """Stage the factored transfer P = S·E of level `li`: the stencil S
    (its DeviceMatrix), the even-point embedding map ``emb`` (coarse owned
    point -> slot of its even fine point in S's column frame; pads point at
    the trash slot) and the ghost -> owner assembly plan of S's column
    range (combine ``add``)."""
    from ..models.gmg import interp_stencil_cartesian

    lvl = h.levels[li]
    coarse_rows = h.levels[li + 1].A.rows if li + 1 < len(h.levels) else h.coarse_A.rows
    S = interp_stencil_cartesian(lvl.nfs, lvl.A.rows, dtype=lvl.A.dtype)
    dS = device_matrix(S, backend)
    LS = dS.col_layout
    nc_max = max((i.num_oids for i in coarse_rows.partition.part_values()), default=0)
    emb = np.full((LS.P, max(nc_max, 1)), LS.trash, dtype=np.int64)
    for p, (ci, fi) in enumerate(zip(coarse_rows.partition.part_values(), S.cols.partition.part_values())):
        kg = np.asarray(ci.oid_to_gid, dtype=np.int64)
        if len(kg) == 0:
            continue
        kc = np.unravel_index(kg, lvl.ncs)
        lids = fi.gids_to_lids(np.ravel_multi_index(tuple(2 * c for c in kc), lvl.nfs))
        check(bool((lids >= 0).all()), "structured transfer: an embedded point lies beyond its part's fine halo")
        emb[p, : len(kg)] = LS.lid_slots[p][lids]
    return {
        "dS": dS,
        "emb": torch.from_numpy(emb).to(backend.device),
        "rev_plan": device_exchange_plan(S.cols, backend, reverse=True),
    }


def device_hierarchy(h, backend: GPUBackend) -> dict:
    """Stage every level of a `models.gmg.GMGHierarchy` for the card
    (tpu_gmg.py:71-134): per level the operator, the inverse diagonal in
    its column frame and the structured transfer; the dense coarse
    inverse and the per-part global positions ``gmap`` of the coarsest
    owned slots (pads -> nc, the extra zero slot of the padded global
    vector). Cached on the hierarchy per backend."""
    cache = getattr(h, "_device_cache", None)
    if cache is None:
        cache = h._device_cache = {}
    if backend in cache:
        return cache[backend]
    levels = []
    for li, lvl in enumerate(h.levels):
        dA = device_matrix(lvl.A, backend)
        dinv = DeviceVector.from_pvector(lvl.dinv, backend, dA.col_layout).data
        levels.append({"dA": dA, "dinv": dinv, **_stage_structured_transfer(h, li, backend)})
    cinv = np.linalg.inv(_dense(gather_psparse(h.coarse_A)))
    coarse_isets = h.coarse_A.rows.partition.part_values()
    ncmax = max((i.num_oids for i in coarse_isets), default=0)
    nc = h.coarse_A.rows.ngids
    gmap = np.full((len(coarse_isets), max(ncmax, 1)), nc, dtype=np.int64)
    for p, iset in enumerate(coarse_isets):
        gmap[p, : iset.num_oids] = np.asarray(iset.oid_to_gid, dtype=np.int64)
    dt = levels[0]["dinv"].dtype
    staged = {
        "levels": levels,
        "cinv": torch.from_numpy(cinv).to(backend.device, dt),
        "gmap": torch.from_numpy(gmap).to(backend.device),
        "nc": int(nc),
    }
    cache[backend] = staged
    return staged


def make_vcycle(h, dh: dict, plain: bool = False) -> Callable:
    """The V-cycle on the stacked frames (tpu_gmg.py:_vcycle_shard_body,
    structured-transfer route): ``vcycle(b) -> correction``, both in
    level 0's column frame, x = 0 on entry. Per level with pre = post = 1:
    2 SpMVs with the level operator and 2 with S; from x = 0 the first
    pre-smoothing sweep is x = omega * dinv * b (tpu_gmg.py:591-601)."""
    bodies = [
        {"A": _spmv_body(l["dA"], plain=plain), "S": _spmv_body(l["dS"], plain=plain)}
        for l in dh["levels"]
    ]
    pre, post, omega = h.pre, h.post, h.omega
    L = len(dh["levels"])
    nc = dh["nc"]

    def solve_level(level, b_l):
        lv = dh["levels"][level]
        LA = lv["dA"].col_layout  # level vectors live here
        LAr = lv["dA"].row_layout  # the level operator's product frame
        LS = lv["dS"].col_layout  # S operand frame
        LSr = lv["dS"].row_layout  # S product frame
        no = LA.no_max
        sl = slice(LA.o0, LA.o0 + no)
        sS = slice(LS.o0, LS.o0 + no)
        sSr = slice(LSr.o0, LSr.o0 + no)
        dinv = lv["dinv"]

        def spmv_A(z):
            out = torch.zeros_like(z)
            out[:, sl] = bodies[level]["A"](z)[:, LAr.o0 : LAr.o0 + no]
            return out

        def sweep(x):
            q = spmv_A(x)
            x[:, sl] = x[:, sl] + omega * dinv[:, sl] * (b_l[:, sl] - q[:, sl])

        x = torch.zeros_like(b_l)
        if pre > 0:
            x[:, sl] = omega * dinv[:, sl] * b_l[:, sl]
        for _ in range(max(pre - 1, 0)):
            sweep(x)
        q = spmv_A(x)
        # restriction R = Eᵀ·S: stencil-apply the residual, refresh ghosts
        # so embedded points owned elsewhere are readable, extract the
        # even-point slots (pads read the zero trash slot)
        rS = torch.zeros((b_l.shape[0], LS.W), dtype=b_l.dtype, device=b_l.device)
        rS[:, sS] = b_l[:, sl] - q[:, sl]
        w = bodies[level]["S"](rS)
        v = torch.zeros_like(rS)
        v[:, sS] = w[:, sSr]
        exchange_(lv["dS"].col_plan, v)
        rc_own = v.gather(1, lv["emb"])
        if level + 1 == L:
            # dense coarse solve: place every part's owned coarse residual
            # by gid, one mat-vec with the inverse, read back the slots
            glob = torch.zeros(nc + 1, dtype=b_l.dtype, device=b_l.device)
            glob[dh["gmap"].reshape(-1)] = rc_own.reshape(-1)  # pads: 0 into slot nc
            ec_glob = torch.cat([dh["cinv"] @ glob[:nc], glob.new_zeros(1)])
            ec_own = ec_glob[dh["gmap"]]
        else:
            nxt = dh["levels"][level + 1]["dA"].col_layout
            bc = torch.zeros((b_l.shape[0], nxt.W), dtype=b_l.dtype, device=b_l.device)
            bc[:, nxt.o0 : nxt.o0 + nxt.no_max] = rc_own
            ec_own = solve_level(level + 1, bc)[:, nxt.o0 : nxt.o0 + nxt.no_max]
        # prolongation P = S·E: scatter the coarse correction onto the even
        # fine points, assemble values embedded into ghosts to their owners
        # (the add exchange leaves ghosts and trash at 0), one S SpMV
        z = torch.zeros_like(rS)
        z.scatter_(1, lv["emb"], ec_own)
        z[:, LS.trash] = 0
        exchange_(lv["rev_plan"], z, combine="add")
        ef = bodies[level]["S"](z)
        x[:, sl] = x[:, sl] + ef[:, sSr]
        for _ in range(post):
            sweep(x)
        return x

    return lambda b: solve_level(0, b)


def make_gmg_pcg_fn(h, backend: GPUBackend, tol: float, maxiter: int,
                    plain: bool = False) -> Callable:
    """V-cycle-preconditioned CG on the card (tpu_gmg.py:886-985):
    ``fn(b, x0) -> (x, rs, rs0, iterations, residual history)``. z =
    Vcycle(r) is computed at the top of the body with beta = 0 on the
    first pass; the loop continues while ``sqrt(rs) > tol*max(1,
    sqrt(rs0))``, ``it < maxiter`` and ``rz_prev != 0``, read once per
    iteration."""
    dh = device_hierarchy(h, backend)
    dA0 = dh["levels"][0]["dA"]
    L0, L0r = dA0.col_layout, dA0.row_layout
    no = L0.no_max
    sl = slice(L0.o0, L0.o0 + no)
    pdot = _pdot_factory(L0.o0, no)
    body_A0 = _spmv_body(dA0, plain=plain)
    vcycle = make_vcycle(h, dh, plain=plain)

    def spmv(z):
        out = torch.zeros_like(z)
        out[:, sl] = body_A0(z)[:, L0r.o0 : L0r.o0 + no]
        return out

    def fn(b, x0):
        x = x0.clone()
        q = spmv(x0.clone())
        r = torch.zeros_like(x0)
        r[:, sl] = b[:, sl] - q[:, sl]
        p = torch.zeros_like(x0)
        rs0 = pdot(r, r)
        thr = tol * torch.clamp(torch.sqrt(rs0), min=1.0)
        rs, rz_prev = rs0, torch.ones((), dtype=x.dtype, device=x.device)
        hist = [torch.sqrt(rs0)]
        it = 0
        while it < maxiter and bool(((torch.sqrt(rs) > thr) & (rz_prev != 0)).item()):
            z = vcycle(r)
            rz = pdot(r, z)
            beta = torch.zeros_like(rz) if it == 0 else rz / rz_prev
            p[:, sl] = z[:, sl] + beta * p[:, sl]
            q = spmv(p)
            alpha = rz / pdot(p, q)
            x[:, sl] = x[:, sl] + alpha * p[:, sl]
            r[:, sl] = r[:, sl] + (-alpha) * q[:, sl]
            rs, rz_prev = pdot(r, r), rz
            it += 1
            hist.append(torch.sqrt(rs))
        return x, rs, rs0, it, torch.stack(hist).cpu().numpy()

    return fn


def gpu_gmg_pcg(h, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8,
                maxiter: Optional[int] = None, verbose: bool = False,
                plain: bool = False) -> Tuple[PVector, dict]:
    """V-cycle-preconditioned CG on the card, the counterpart of
    `tpu_gmg_pcg` (tpu_gmg.py:1225, `_run_gmg`); the device form of
    ``pcg(A, b, minv=hierarchy)``."""
    backend = b.values.backend
    check(isinstance(backend, GPUBackend), "pcg+gmg needs a GPU-backend PVector")
    if maxiter is None:
        maxiter = 4 * int(h.levels[0].A.rows.ngids)
    solve = make_gmg_pcg_fn(h, backend, tol, int(maxiter), plain=plain)
    return _run_krylov(h.levels[0].A, b, x0, tol, verbose, solve, "pcg+gmg")
