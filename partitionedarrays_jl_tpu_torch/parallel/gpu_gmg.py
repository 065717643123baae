"""Geometric multigrid on the card: the V-cycle (every level's SpMVs, halo
exchanges, Jacobi sweeps, inter-level transfers and the dense coarse solve)
on stacked ``(P, W)`` tensors, and the V-cycle-preconditioned CG.

The counterpart of `partitionedarrays_jl_tpu/parallel/tpu_gmg.py`. Each
level's transfer P = S·E (S the d-linear interpolation stencil, E the
embedding of coarse points at the even fine points; R = Pᵀ = Eᵀ·S) takes
one of three routes, resolved per level as the JAX package resolves them
off a TPU (`_device_hierarchy`, tpu_gmg.py:71-134):

* **stencil** (matrix-free, `_stage_stencil_transfer`, tpu_gmg.py:137-289):
  where the level's column plan is the box exchange plan and its ghost
  segments cover the full in-grid shell of every part, S runs as the
  `box_stencil_apply` kernel (`ops/stencil.py`) on the level's own frame
  after a box exchange, and E as strided views of each part's box. No S is
  assembled or staged.
* **structured with emb_fast** (`_stage_structured_transfer`,
  tpu_gmg.py:322-405, and `_embedding_box_fast_path`, :408-465): S is
  assembled and lowered like any operator (the coded-DIA kernel); where
  every part's coarse points are its own even fine points in one box
  shape, E is a strided view of the box too.
* **structured**: S as above; E is an element gather through the index map
  ``emb``, with a halo refresh for restriction and the ghost -> owner
  ``add`` exchange for prolongation.

``box=False`` (the generic layout and exchange plan, no strided
embedding) and ``stencil=False`` select the structured routes.
``strict=True`` (strict-bits mode, the JAX package's
``PA_TPU_STRICT_BITS=1``) stages every level's operator and every S as
the ELL lowering on the generic plan (`DeviceMatrix(strict=True)`,
tpu.py:1370, :1410, :796-805), so no level takes the stencil route (its
plan is not the box plan) and every transfer is structured, with the
strided embedding where it applies as the JAX package stages it off a
TPU (`_box_enabled`, tpu_gmg.py:39, is not tied to strict mode); the PCG
loop then runs the standard body with E3's dots (tpu.py:827, :2538).

Frames: every level vector lives in the level operator's column frame; S's
operand and product have their own frames. All frames are compact with the
owned band at ``o0``, so a move between frames is an owned-slice copy. The
coarse solve is one mat-vec with the host-computed dense inverse.

The stationary solve (`make_gmg_solve_fn`, the device form of
`models.gmg.gmg_solve`) and FGMRES with the cycle run the same cycle. With
``h.cycle == "w"`` `make_vcycle` runs the W-cycle on all of them.

The PCG loop is device-resident, as `gpu.make_cg_fn`'s: the stopping test
is a device flag read once per block of iterations, and on a CUDA device
the block is a CUDA graph (`gpu_loop.py`); ``plain=True`` runs the
kernels' plain versions on the same tensors (the comparison path of
chip_smoke.py).

A hierarchy keeps what it staged (`device_hierarchy`, per backend and
route keywords) and the solve functions built on it (`gmg_pcg_fn`, per
backend, tol, maxiter and route keywords, tpu_gmg.py:1193-1204's
``h._fn_cache``): a second solve with the same key copies its b and x0
into the captured loop's buffers and replays it. `STATS` counts the
stagings and the solve functions built, for the tests and chip_smoke.py.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.solvers import _dense, gather_psparse
from ..ops import epilogue as ep
from ..ops import stencil as stn
from ..utils.helpers import check
from .gpu import STATS as gpu_stats
from .gpu import (
    DeviceMatrix,
    DeviceVector,
    GPUBackend,
    _pdot_factory,
    _run_krylov,
    _spmv_body,
    device_exchange_plan,
    device_matrix,
    exchange_,
)
from .gpu_box import BoxExchangePlan
from .pvector import PVector

#: hierarchies staged (`device_hierarchy` cache misses) and GMG-PCG solve
#: functions built (`gmg_pcg_fn` cache misses), since import; callers
#: reset or difference them
STATS = {"stagings": 0, "pcg_fns": 0}


def _coarse_rows(h, li: int):
    return h.levels[li + 1].A.rows if li + 1 < len(h.levels) else h.coarse_A.rows


def _stage_stencil_transfer(h, li: int, dA, device, dtype) -> Optional[dict]:
    """Stage the matrix-free transfer of level `li` (tpu_gmg.py:137-289):
    per part the embedding descriptor (fine box fb, coarse box cb, even-
    point start st), the plan's ghost segments as the stencil's shell, and
    for periodic partitions the mask that zeroes wrapped segments (S
    truncates at the global boundary; it does not wrap). None, and the
    level takes a structured route, unless the column plan is the box plan,
    every part's coarse points are its own even fine points, and every
    in-grid shell piece arrives as a segment of the exact face, edge or
    corner extent. Returns ``{"stencil": StencilOperand}``."""
    lvl = h.levels[li]
    dim = len(lvl.nfs)
    if dim > 3:
        return None
    plan = dA.col_plan
    if not isinstance(plan, BoxExchangePlan):
        return None
    info = plan.info
    # the cols partition carries the ghosts the stencil reads; its owned
    # boxes are the rows'
    fsets = lvl.A.cols.partition.part_values()
    csets = _coarse_rows(h, li).partition.part_values()
    P = len(fsets)
    variants = np.asarray(info.variants)
    dir_index = {d_.dir: k for k, d_ in enumerate(info.dirs)}
    senders = [{q: s for s, q in d_.perm} for d_ in info.dirs]
    # descriptors are keyed by the whole embedding (fb, cb, st): equal fine
    # boxes over an odd coarse grid still split into floor/ceil coarse boxes
    descs = []
    dsel = np.zeros(P, dtype=np.int64)
    shmask = np.ones((P, 27))
    any_wrapped = False
    all_dirs = [d_ for d_ in np.ndindex(*(3,) * dim) if any(c != 1 for c in d_)]
    for p, (fi, ci) in enumerate(zip(fsets, csets)):
        if getattr(fi, "box_shape", None) is None or getattr(ci, "box_shape", None) is None:
            return None
        fb = info.box_shapes[int(variants[p])]
        if fi.box_shape != fb:
            return None
        cb = ci.box_shape
        if any(s == 0 for s in cb):
            return None  # an agglomerated coarse level
        st = tuple(2 * cl - fl for cl, fl in zip(ci.box_lo, fi.box_lo))
        if any(s < 0 or s > 1 for s in st):
            return None
        if any(st[d] + 2 * (cb[d] - 1) >= fb[d] for d in range(dim)):
            return None
        cand = (fb, tuple(cb), st)
        if cand in descs:
            dsel[p] = descs.index(cand)
        else:
            if len(descs) >= 16:
                return None  # an implausible split: keep the structured route
            dsel[p] = len(descs)
            descs.append(cand)
        # every in-grid shell piece must arrive as a segment of the exact
        # face/edge/corner extent; a wrapped one (periodic) is masked to 0
        gdims = fi.grid_shape
        for delta in all_dirs:
            dvec = tuple(c - 1 for c in delta)
            in_grid = all(
                (c != -1 or fi.box_lo[j] > 0) and (c != 1 or fi.box_hi[j] < gdims[j])
                for j, c in enumerate(dvec)
            )
            k = dir_index.get(dvec)
            s = senders[k].get(p) if k is not None else None
            if s is None:
                if in_grid:
                    return None  # a shell piece exists but never arrives
                continue  # no segment: it reads 0, as S truncates
            d_ = info.dirs[k]
            exp_shape = tuple(1 if c != 0 else fb[j] for j, c in enumerate(dvec))
            if d_.geo[int(variants[s])][1] != exp_shape:
                return None  # the sender's slab is not the exact extent
            n_seg = int(np.prod(exp_shape))
            if not info.seg_mask[p, d_.off : d_.off + n_seg].all():
                return None  # orphan slots inside the piece
            if not in_grid:
                shmask[p, stn.dir_index(dvec)] = 0.0
                any_wrapped = True
    LA = dA.col_layout
    table = np.zeros((P, stn.TABLE), dtype=np.int32)
    table[:, 4:31] = -1
    for d_ in info.dirs:
        table[:, 4 + stn.dir_index(d_.dir)] = d_.off
    for p in range(P):
        fb = descs[dsel[p]][0]
        table[p, :3] = (1,) * (3 - dim) + fb
        table[p, 3] = math.prod(fb)
    groups = []
    for v, (fb, cb, st) in enumerate(descs):
        parts = np.flatnonzero(dsel == v)
        idx = None if len(parts) == P else torch.from_numpy(parts).to(device)
        groups.append(stn.StencilGroup(idx, fb, cb, st))
    op = stn.bind_kernel(stn.StencilOperand(
        dim=dim,
        table=torch.from_numpy(table).to(device),
        mask=torch.from_numpy(shmask).to(device, dtype) if any_wrapped else None,
        dirs=tuple((d_.dir, d_.off) for d_ in info.dirs),
        groups=tuple(groups),
        o0=LA.o0, g0=LA.g0, W=LA.W, n=LA.no_max, fmax=tuple(int(v) for v in table[:, :3].max(axis=0)),
    ))
    return {"stencil": op}


def _embedding_box_fast_path(lvl, coarse_rows, S, LS, emb):
    """The strided-box embedding (tpu_gmg.py:408-465): when every part's
    owned fine and coarse regions are boxes of one shape each and its
    coarse points are exactly its own even fine points, restriction and
    prolongation extract and place them through a strided view of the box,
    with no gather and no ghost traffic. Returns the one descriptor
    ``(fine box, coarse box, starts)`` or None."""
    dim = len(lvl.nfs)
    descr = None
    for p, (ci, fi) in enumerate(zip(coarse_rows.partition.part_values(), S.cols.partition.part_values())):
        if fi.num_oids == 0 or ci.num_oids == 0:
            return None
        fc = np.stack(np.unravel_index(np.asarray(fi.oid_to_gid, dtype=np.int64), lvl.nfs))
        cc = np.stack(np.unravel_index(np.asarray(ci.oid_to_gid, dtype=np.int64), lvl.ncs))
        lo_f, hi_f = fc.min(axis=1), fc.max(axis=1) + 1
        lo_c, hi_c = cc.min(axis=1), cc.max(axis=1) + 1
        fb = tuple(int(x) for x in hi_f - lo_f)
        cb = tuple(int(x) for x in hi_c - lo_c)
        if int(np.prod(fb)) != fi.num_oids or int(np.prod(cb)) != ci.num_oids:
            return None  # the owned set is not a box
        st = tuple(int(2 * lo_c[d] - lo_f[d]) for d in range(dim))
        if any(s < 0 or s > 1 for s in st):
            return None  # a coarse point falls outside this part's box
        if any(st[d] + 2 * (cb[d] - 1) >= fb[d] for d in range(dim)):
            return None
        cand = (fb, cb, st)
        if descr is None:
            descr = cand
        elif cand != descr:
            return None  # parts differ
        if not np.array_equal(
            LS.lid_slots[p][: fi.num_oids],
            LS.o0 + np.arange(fi.num_oids, dtype=LS.lid_slots[p].dtype),
        ):
            return None  # owned slots are not the identity map
        # emb row p must be the slots of the box's even points in
        # coarse-scan order, with no ghost reads
        fine_idx = np.arange(fi.num_oids, dtype=np.int64).reshape(fb)
        lids = fine_idx[tuple(slice(st[d], st[d] + 2 * cb[d], 2) for d in range(dim))].reshape(-1)
        expect = LS.lid_slots[p][lids]
        if not np.array_equal(emb[p, : len(expect)], expect):
            return None
        if (emb[p, len(expect):] != LS.trash).any():
            return None
    return descr


def _stage_structured_transfer(h, li: int, backend: GPUBackend, box: bool, strict: bool = False,
                               lowering: str = "auto") -> dict:
    """Stage the factored transfer P = S·E of level `li`
    (tpu_gmg.py:322-405): the stencil S (its DeviceMatrix; the ELL
    lowering on the generic plan with ``strict``), the even-point
    embedding map ``emb`` (coarse owned point -> slot of its even fine
    point in S's column frame; pads point at the trash slot), the ghost ->
    owner assembly plan of S's column range (combine ``add``) and, with
    ``box``, the strided-box embedding ``emb_fast`` where it applies.
    None where a coarse point's even fine point lies beyond its part's
    fine halo (an agglomerated level): the level then takes the assembled
    route."""
    lvl = h.levels[li]
    coarse_rows = _coarse_rows(h, li)
    S = lvl.S
    dS = device_matrix(S, backend, box, strict=strict, lowering=lowering)
    LS = dS.col_layout
    nc_max = max((i.num_oids for i in coarse_rows.partition.part_values()), default=0)
    emb = np.full((LS.P, max(nc_max, 1)), LS.trash, dtype=np.int64)
    for p, (ci, fi) in enumerate(zip(coarse_rows.partition.part_values(), S.cols.partition.part_values())):
        kg = np.asarray(ci.oid_to_gid, dtype=np.int64)
        if len(kg) == 0:
            continue
        kc = np.unravel_index(kg, lvl.ncs)
        lids = fi.gids_to_lids(np.ravel_multi_index(tuple(2 * c for c in kc), lvl.nfs))
        if (lids < 0).any():
            return None  # an embedded point beyond this part's fine halo: the assembled route
        emb[p, : len(kg)] = LS.lid_slots[p][lids]
    out = {
        "dS": dS,
        "emb": torch.from_numpy(emb).to(backend.device),
        "rev_plan": device_exchange_plan(S.cols, backend, reverse=True, box=box and not strict),
    }
    if box:
        fast = _embedding_box_fast_path(lvl, coarse_rows, S, LS, emb)
        if fast is not None:
            out["emb_fast"] = stn.StencilGroup(None, *fast)
    return out


def route(level: dict) -> str:
    """The transfer route a staged level takes: ``"stencil"``,
    ``"emb_fast"`` (structured, strided embedding), ``"structured"`` or
    ``"assembled"`` (the rectangular R and P, ELL)."""
    if "dR" in level:
        return "assembled"
    return "stencil" if "stencil" in level else "emb_fast" if "emb_fast" in level else "structured"


def device_hierarchy(h, backend: GPUBackend, box: bool = True, stencil: bool = True,
                     strict: bool = False, lowering: str = "auto") -> dict:
    """Stage every level of a `models.gmg.GMGHierarchy` for the card
    (tpu_gmg.py:71-134): per level the operator, the inverse diagonal in
    its column frame and the transfer: the stencil route first (with
    ``stencil``), else the structured one; then the dense coarse inverse
    and the per-part global positions ``gmap`` of the coarsest owned slots
    (pads -> nc, the extra zero slot of the padded global vector). The
    stencil route builds no S. ``strict`` stages every operator as the ELL
    lowering on the generic plan (the module docstring); ``lowering`` names
    the first non-band lowering every operator tries (`gpu.DeviceMatrix`;
    a band takes its band lowering whatever it names), as the JAX
    package's ``PA_TPU_SD``/``PA_TPU_BSR`` switches reach every staging.
    An agglomerated level (a coarse partition with empty parts) takes the
    structured route (tpu_gmg.py:214) and keeps the box plan where its
    partition has one. Cached on the hierarchy per backend and route
    keywords; no cycle changes what is staged. A staging whose operators
    no ``lowering`` changes (every one a band or a rectangular transfer:
    `gpu.DeviceMatrix.lowering_free`, as `models.gmg.gmg_hierarchy` builds
    them) answers every ``lowering``; its ``"lowering"`` entry is then
    ``"auto"``, else the ``lowering`` it was staged for."""
    cache = getattr(h, "_device_cache", None)
    if cache is None:
        cache = h._device_cache = {}
    key = (backend, box, stencil, strict, lowering)
    if key in cache:
        return cache[key]
    same = next((st for k, st in cache.items() if k[:4] == key[:4] and st["lowering_free"]), None)
    if same is not None:
        cache[key] = same
        return same
    STATS["stagings"] += 1
    levels = []
    for li, lvl in enumerate(h.levels):
        dA = device_matrix(lvl.A, backend, box, strict=strict, lowering=lowering)
        dinv = DeviceVector.from_pvector(lvl.dinv, backend, dA.col_layout).data
        st = _stage_stencil_transfer(h, li, dA, backend.device, dinv.dtype) if stencil else None
        if st is None:
            st = _stage_structured_transfer(h, li, backend, box, strict, lowering)
        if st is None:
            # the assembled rectangular transfers (tpu_gmg.py:107-112)
            st = {"dR": device_matrix(lvl.R, backend, box, strict=strict, lowering=lowering),
                  "dP": device_matrix(lvl.P, backend, box, strict=strict, lowering=lowering)}
        levels.append({"dA": dA, "dinv": dinv, **st})
    cinv = np.linalg.inv(_dense(gather_psparse(h.coarse_A)))
    coarse_isets = h.coarse_A.rows.partition.part_values()
    ncmax = max((i.num_oids for i in coarse_isets), default=0)
    nc = h.coarse_A.rows.ngids
    gmap = np.full((len(coarse_isets), max(ncmax, 1)), nc, dtype=np.int64)
    for p, iset in enumerate(coarse_isets):
        gmap[p, : iset.num_oids] = np.asarray(iset.oid_to_gid, dtype=np.int64)
    dt = levels[0]["dinv"].dtype
    free = all(m.lowering_free for lv in levels for m in lv.values() if isinstance(m, DeviceMatrix))
    staged = {
        "levels": levels,
        "cinv": torch.from_numpy(cinv).to(backend.device, dt),
        "gmap": torch.from_numpy(gmap).to(backend.device),
        "nc": int(nc),
        "lowering_free": free,
        "lowering": "auto" if free else lowering,
    }
    cache[key] = staged
    return staged


def _even_view(band: torch.Tensor, g: stn.StencilGroup):
    """The even points of group g's boxes in ``band`` (P, >= |fb|), the
    owned band of a frame: a strided view (P or the group's parts, *cb)
    (`_box_extract`/`_box_interleave`, tpu_gmg.py:468-505)."""
    nfb = math.prod(g.fb)
    box = band[:, :nfb].view((band.shape[0],) + g.fb)
    return box, (slice(None),) + tuple(slice(s, s + 2 * c, 2) for s, c in zip(g.st, g.cb))


def _extract(band: torch.Tensor, groups, dest: torch.Tensor) -> None:
    """Restriction's E^T: the even points of every part's box in ``band``
    into the coarse owned band ``dest`` (P, nc_pad), one copy a group;
    slots past a part's coarse count are left as they are (zero)."""
    for g in groups:
        box, even = _even_view(band, g)
        ncb = math.prod(g.cb)
        if g.idx is None:
            dest[:, :ncb].view((dest.shape[0],) + g.cb).copy_(box[even])
        else:
            dest[g.idx, :ncb] = box[(g.idx,) + even[1:]].reshape(len(g.idx), ncb)


def _interleave(ec: torch.Tensor, groups, band: torch.Tensor) -> None:
    """Prolongation's E: the coarse owned values ``ec`` (P, nc_pad) onto
    the even points of every part's box in ``band``, a zero owned band."""
    for g in groups:
        box, even = _even_view(band, g)
        ncb = math.prod(g.cb)
        if g.idx is None:
            box[even] = ec[:, :ncb].view((ec.shape[0],) + g.cb)
        else:
            box[(g.idx,) + even[1:]] = ec[g.idx, :ncb].view((len(g.idx),) + g.cb)


def make_vcycle(h, dh: dict, plain: bool = False) -> Callable:
    """The multigrid cycle on the stacked frames
    (tpu_gmg.py:_vcycle_shard_body): ``vcycle(b) -> correction``, both in
    level 0's column frame, x = 0 on entry; a V-cycle, or with ``h.cycle
    == "w"`` the W-cycle: below every level whose next level is not the
    coarsest, a second pass on the next level warm-started from the
    first's correction (tpu_gmg.py:559, :589, :710-715), whose pre-smoothing
    runs ``pre`` full sweeps. Per level with pre = post = 1: 2 SpMVs with the level operator
    (from x = 0 the first pre-smoothing sweep is x = omega * dinv * b,
    tpu_gmg.py:591-601) and two transfers, each on the level's route
    (`route`): on the stencil route a box exchange of the level's frame
    and one `box_stencil_apply` each, with the even points extracted or
    placed through strided views; on the structured routes one S SpMV
    each, with the even points through strided views (``emb_fast``) or
    through ``emb``, a halo refresh and the ``add`` exchange. The
    smoother's sweeps and the residual run as the `ops/epilogue.py` kernel
    on each SpMV's product where it lies (``init``, ``smooth``,
    ``residual``: pre + post + 1 launches a level from x = 0 with pre >
    0); ``plain`` takes every kernel's plain version."""
    apply_S = stn.box_stencil_apply_plain if plain else stn.box_stencil_apply
    epilogue = ep.vcycle_epilogue_plain if plain else ep.vcycle_epilogue
    bodies = [
        {"A": _spmv_body(l["dA"], plain=plain),
         "S": _spmv_body(l["dS"], plain=plain) if "dS" in l else None,
         "R": _spmv_body(l["dR"], plain=plain) if "dR" in l else None,
         "P": _spmv_body(l["dP"], plain=plain) if "dP" in l else None}
        for l in dh["levels"]
    ]
    pre, post, omega = h.pre, h.post, h.omega
    w_cycle = h.cycle == "w"
    L = len(dh["levels"])
    nc = dh["nc"]

    def solve_level(level, b_l, x0_l=None):
        lv = dh["levels"][level]
        LA = lv["dA"].col_layout  # level vectors live here
        LAr = lv["dA"].row_layout  # the level operator's product frame
        no = LA.no_max
        sl = slice(LA.o0, LA.o0 + no)
        dinv = lv["dinv"]
        P = b_l.shape[0]
        spmv_A = bodies[level]["A"]  # the product in its row frame, band at LAr.o0

        def sweep(x):
            epilogue("smooth", b_l, LA.o0, no, dinv=dinv, y=spmv_A(x), yo0=LAr.o0, x=x, omega=omega)

        if x0_l is not None:
            # the W-cycle's warm pass: full sweeps from the first pass's x
            x = x0_l
            sweeps = pre
        elif pre > 0:
            x = epilogue("init", b_l, LA.o0, no, dinv=dinv, omega=omega)
            sweeps = pre - 1
        else:
            x = torch.zeros_like(b_l)
            sweeps = 0
        for _ in range(sweeps):
            sweep(x)
        q = spmv_A(x)
        # the coarse right-hand side's frame: the next level's column frame,
        # or the padded owned block of the dense coarse solve
        if level + 1 == L:
            bc = torch.zeros((P, dh["gmap"].shape[1]), dtype=b_l.dtype, device=b_l.device)
            rc_own = bc
        else:
            nxt = dh["levels"][level + 1]["dA"].col_layout
            bc = torch.zeros((P, nxt.W), dtype=b_l.dtype, device=b_l.device)
            rc_own = bc[:, nxt.o0 : nxt.o0 + nxt.no_max]
        if "stencil" in lv:
            # R = Eᵀ·S, matrix-free: refresh the residual's ghost segments
            # through the level's box exchange, apply S, extract
            op = lv["stencil"]
            rv = epilogue("residual", b_l, LA.o0, no, y=q, yo0=LAr.o0)
            exchange_(lv["dA"].col_plan, rv)
            _extract(apply_S(op, rv), op.groups, rc_own)
        elif "dR" in lv:
            # the assembled restriction: the residual into R's column frame
            LR, LRr = lv["dR"].col_layout, lv["dR"].row_layout
            rR = epilogue("residual", b_l, LA.o0, no, y=q, yo0=LAr.o0, width=LR.W, out_o0=LR.o0)
            rc_own[:, : LRr.no_max] = bodies[level]["R"](rR)[:, LRr.o0 : LRr.o0 + LRr.no_max]
        else:
            # R = Eᵀ·S with the assembled S, then the even points: strided
            # (emb_fast), or gathered after a halo refresh so that embedded
            # points owned elsewhere are readable (pads read the zero trash)
            LS, LSr = lv["dS"].col_layout, lv["dS"].row_layout
            rS = epilogue("residual", b_l, LA.o0, no, y=q, yo0=LAr.o0, width=LS.W, out_o0=LS.o0)
            w = bodies[level]["S"](rS)
            if "emb_fast" in lv:
                _extract(w[:, LSr.o0 : LSr.o0 + no], (lv["emb_fast"],), rc_own)
            else:
                v = torch.zeros_like(rS)
                v[:, LS.o0 : LS.o0 + no] = w[:, LSr.o0 : LSr.o0 + no]
                exchange_(lv["dS"].col_plan, v)
                rc_own[:, : lv["emb"].shape[1]] = v.gather(1, lv["emb"])
        if level + 1 == L:
            # dense coarse solve: place every part's owned coarse residual
            # by gid, one mat-vec with the inverse, read back the slots
            glob = torch.zeros(nc + 1, dtype=b_l.dtype, device=b_l.device)
            glob[dh["gmap"].reshape(-1)] = rc_own.reshape(-1)  # pads: 0 into slot nc
            ec_glob = torch.cat([dh["cinv"] @ glob[:nc], glob.new_zeros(1)])
            ec_own = ec_glob[dh["gmap"]]
        else:
            ec = solve_level(level + 1, bc)
            if w_cycle:
                ec = solve_level(level + 1, bc, ec)
            ec_own = ec[:, nxt.o0 : nxt.o0 + nxt.no_max]
        if "stencil" in lv:
            # P = S·E, matrix-free: place the coarse correction on the even
            # fine points, refresh the ghost segments, apply S
            op = lv["stencil"]
            z = torch.zeros_like(b_l)
            _interleave(ec_own, op.groups, z[:, sl])
            exchange_(lv["dA"].col_plan, z)
            x[:, sl] = x[:, sl] + apply_S(op, z)
        elif "dP" in lv:
            # the assembled prolongation: the coarse correction into P's
            # column frame, one SpMV
            LP, LPr = lv["dP"].col_layout, lv["dP"].row_layout
            ecp = torch.zeros((P, LP.W), dtype=b_l.dtype, device=b_l.device)
            ecp[:, LP.o0 : LP.o0 + LP.no_max] = ec_own[:, : LP.no_max]
            x[:, sl] = x[:, sl] + bodies[level]["P"](ecp)[:, LPr.o0 : LPr.o0 + no]
        else:
            # P = S·E with the assembled S: the even points placed strided
            # (emb_fast), or scattered and the values embedded into ghosts
            # assembled to their owners (the add exchange leaves ghosts and
            # trash at 0); then one S SpMV
            LS, LSr = lv["dS"].col_layout, lv["dS"].row_layout
            z = torch.zeros((P, LS.W), dtype=b_l.dtype, device=b_l.device)
            if "emb_fast" in lv:
                _interleave(ec_own, (lv["emb_fast"],), z[:, LS.o0 : LS.o0 + no])
            else:
                z.scatter_(1, lv["emb"], ec_own[:, : lv["emb"].shape[1]])
                z[:, LS.trash] = 0
                exchange_(lv["rev_plan"], z, combine="add")
            ef = bodies[level]["S"](z)
            x[:, sl] = x[:, sl] + ef[:, LSr.o0 : LSr.o0 + no]
        for _ in range(post):
            sweep(x)
        return x

    return lambda b: solve_level(0, b)


def make_gmg_pcg_fn(h, backend: GPUBackend, tol: float, maxiter: int,
                    plain: bool = False, box: bool = True, stencil: bool = True,
                    graph: bool = True, block: Optional[int] = None, strict: bool = False,
                    lowering: str = "auto") -> Callable:
    """V-cycle-preconditioned CG on the card (tpu_gmg.py:886-985):
    ``fn(b, x0) -> (x, rs, rs0, iterations, residual history)``, on the
    transfer routes ``box`` and ``stencil`` select (`device_hierarchy`).
    z = Vcycle(r) is computed at the top of the body with ``beta =
    where(it == 0, 0, rz / rz_prev)``; the loop continues while
    ``sqrt(rs) > tol*max(1, sqrt(rs0))``, ``it < maxiter`` and ``rz_prev !=
    0`` (tpu_gmg.py:950-956). It runs as `gpu.make_cg_fn` runs its bodies:
    a device-resident loop with the stopping test a device flag
    (`gpu_loop.DeviceLoop`), read once per block of ``block`` iterations
    (`gpu_loop.GMG_BLOCK`), the block replayed as a CUDA graph on a CUDA
    device unless ``graph=False``; level 0's x and r are updated and r.r
    taken in one sweep (`ops/sweep.py`). With ``strict`` (strict-bits
    mode, tpu_gmg.py:886 under ``PA_TPU_STRICT_BITS=1``) the hierarchy is
    staged strict (`device_hierarchy`) and every dot is E3's fixed tree
    (`_pdot_factory(strict=True)`): the sweep updates x and r, and r.r is
    E3's dot of the updated r, the JAX package's standard strict body.
    ``lowering`` as in `device_hierarchy`; the cycle is the hierarchy's (V
    or W). ``fn.stats`` describes the last run, ``fn.loop`` is the
    `gpu_loop.DeviceLoop`, ``fn.staged`` the staged hierarchy."""
    from ..ops import sweep as sw
    from . import gpu_loop as gl

    dh = device_hierarchy(h, backend, box, stencil, strict, lowering)
    dA0 = dh["levels"][0]["dA"]
    L0, L0r = dA0.col_layout, dA0.row_layout
    no = L0.no_max
    sl = slice(L0.o0, L0.o0 + no)
    pdot = _pdot_factory(L0.o0, no, strict, plain)
    body_A0 = _spmv_body(dA0, plain=plain)
    vcycle = make_vcycle(h, dh, plain=plain)
    sweep = sw.cg_sweep_plain if plain else sw.cg_sweep
    stop_it = gl.stop_bound(maxiter)

    def spmv(z):
        out = torch.zeros_like(z)
        out[:, sl] = body_A0(z)[:, L0r.o0 : L0r.o0 + no]
        return out

    def step(S):
        rs, rz_prev, it = S["rs"], S["rz_prev"], S["it"]
        live = S["live"] * ((gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it) & (rz_prev != 0)).to(torch.int32)
        r, p = S["r"], S["p"]
        z = vcycle(r)
        rz = pdot(r, z)
        beta = torch.where(it == 0, torch.zeros_like(rz), rz / rz_prev)
        p[:, sl] = z[:, sl] + beta * p[:, sl]
        q = spmv(p)
        alpha = rz / pdot(p, q)
        if strict:
            sweep(r, q, alpha, live, S["part"], L0.o0, no, x=S["x"], p=p)
            rs_new = pdot(r, r)
        else:
            rs_new = sweep(r, q, alpha, live, S["part"], L0.o0, no, x=S["x"], p=p)
        return gl.finish_step(dict(S, rz_prev=torch.where(live != 0, rz, rz_prev)), S, live, rs_new)

    loop = gl.DeviceLoop(step, gl.GMG_BLOCK if block is None else block, graph)

    def fn(b, x0):
        x = x0.clone()
        q = spmv(x0.clone())
        r = torch.zeros_like(x0)
        r[:, sl] = b[:, sl] - q[:, sl]
        rs0 = pdot(r, r)
        init = {
            "x": x, "r": r, "p": torch.zeros_like(x0), "rs": rs0,
            "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
            "rz_prev": torch.ones((), dtype=x.dtype, device=x.device),
            "it": torch.zeros((), dtype=torch.int32, device=x.device),
            "live": torch.ones((), dtype=torch.int32, device=x.device),
            "hist": gl.history(gl.sqrt_rn(rs0), maxiter), "part": sw.sweep_partials(r, no),
        }
        S, _ = loop.run(init)
        return S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    fn.stats = loop.stats  # updated in place by every run
    fn.loop = loop
    fn.staged = dh
    return fn


def gmg_pcg_fn(h, backend: GPUBackend, tol: float, maxiter: int, plain: bool = False,
               box: bool = True, stencil: bool = True, strict: bool = False, lowering: str = "auto") -> Callable:
    """The GMG-PCG solve function of `make_gmg_pcg_fn`, cached on the
    hierarchy per backend, tol, maxiter and the keywords
    (tpu_gmg.py:1193-1204, ``h._fn_cache``): a hit reuses the staged
    hierarchy and the `gpu_loop.DeviceLoop` with its captured graph.
    An entry keeps on the card the loop's persistent state (level 0's x,
    r and p frames, the sweep's partials, the residual history of at most
    `gpu_loop.HIST_MAX` entries), its CUDA graph with the graph's private
    memory pool (a block's temporaries: every level's V-cycle frames), and
    the staged hierarchy it runs on (`device_hierarchy`'s entry for its
    route keywords, shared by every entry with those keywords: each
    level's operator, inverse diagonal and transfer). Nothing evicts an
    entry: it lives as long as the hierarchy."""
    cache = getattr(h, "_fn_cache", None)
    if cache is None:
        cache = h._fn_cache = {}
    # the lowering the staging answers for: a band hierarchy's is "auto"
    lowering = device_hierarchy(h, backend, box, stencil, strict, lowering)["lowering"]
    key = ("pcg+gmg", backend, float(tol), int(maxiter), bool(plain), bool(box), bool(stencil), bool(strict),
           lowering)
    if key not in cache:
        STATS["pcg_fns"] += 1
        cache[key] = make_gmg_pcg_fn(h, backend, tol, int(maxiter), plain=plain, box=box, stencil=stencil,
                                     strict=strict, lowering=lowering)
    return cache[key]


def gpu_gmg_pcg(h, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8,
                maxiter: Optional[int] = None, verbose: bool = False,
                plain: bool = False, box: bool = True, stencil: bool = True,
                strict: bool = False, lowering: str = "auto") -> Tuple[PVector, dict]:
    """V-cycle-preconditioned CG on the card, the counterpart of
    `tpu_gmg_pcg` (tpu_gmg.py:1225, `_run_gmg`); the device form of
    ``pcg(A, b, minv=hierarchy)``. ``box=False`` and ``stencil=False``
    select the generic exchange and the structured transfers; ``strict``
    the strict-bits loop (`make_gmg_pcg_fn`); ``lowering`` the first
    non-band lowering of every level's operators (`device_hierarchy`). The
    solve function is `gmg_pcg_fn`'s, cached on the hierarchy. The info
    dict names the level-0 lowering and the mode under ``lowering`` and
    ``strict``."""
    backend = b.values.backend
    check(isinstance(backend, GPUBackend), "pcg+gmg needs a GPU-backend PVector")
    if maxiter is None:
        maxiter = 4 * int(h.levels[0].A.rows.ngids)
    solve = gmg_pcg_fn(h, backend, tol, int(maxiter), plain=plain, box=box, stencil=stencil, strict=strict,
                       lowering=lowering)
    dA0 = solve.staged["levels"][0]["dA"]
    return _run_krylov(h.levels[0].A, b, x0, tol, verbose, solve, "pcg+gmg", dA=dA0,
                       lowering=dA0.lowering, strict=dA0.strict)


def make_gmg_solve_fn(h, backend: GPUBackend, tol: float, maxiter: int, plain: bool = False,
                      graph: bool = True) -> Callable:
    """The stationary cycle iteration x <- x + cycle(b - A x) on the card
    (tpu_gmg.py:807-883), the device form of `models.gmg.gmg_solve`:
    ``fn(b, x0) -> (x, rs, rs0, iterations, residual history)``. The
    residual rides the state, computed once an iteration after the update
    (as the host loop does); the loop runs while ``sqrt(rs) > tol*max(1,
    sqrt(rs0))`` and ``it < maxiter``, a device-resident loop as
    `make_gmg_pcg_fn`'s (`gpu_loop.DeviceLoop`, blocks of
    `gpu_loop.GMG_BLOCK` iterations, a CUDA graph on the card unless
    ``graph=False``) on the default routes. A frozen iteration keeps x
    (``torch.where``) and so recomputes the same r. Per iteration: one
    cycle (V or W, the hierarchy's) and one A SpMV. ``plain`` as in
    `make_gmg_pcg_fn`; ``fn.staged`` is the staged hierarchy."""
    from . import gpu_loop as gl

    dh = device_hierarchy(h, backend)
    dA0 = dh["levels"][0]["dA"]
    L0, L0r = dA0.col_layout, dA0.row_layout
    no = L0.no_max
    sl = slice(L0.o0, L0.o0 + no)
    pdot = _pdot_factory(L0.o0, no, False, plain)
    body_A0 = _spmv_body(dA0, plain=plain)
    vcycle = make_vcycle(h, dh, plain=plain)
    stop_it = gl.stop_bound(maxiter)

    def residual(x, b):
        r = torch.zeros_like(x)
        r[:, sl] = b[:, sl] - body_A0(x)[:, L0r.o0 : L0r.o0 + no]
        return r

    def step(S):
        rs, it = S["rs"], S["it"]
        live = S["live"] * ((gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it)).to(torch.int32)
        x = S["x"]
        e = vcycle(S["r"])
        x[:, sl] = torch.where(live != 0, x[:, sl] + e[:, sl], x[:, sl])
        r = residual(x, S["b"])
        return gl.finish_step(dict(S, r=r), S, live, pdot(r, r))

    loop = gl.DeviceLoop(step, gl.GMG_BLOCK, graph)

    def fn(b, x0):
        x = x0.clone()
        r = residual(x, b)
        rs0 = pdot(r, r)
        init = {
            "x": x, "r": r, "b": b.clone(), "rs": rs0, "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
            "it": torch.zeros((), dtype=torch.int32, device=x.device),
            "live": torch.ones((), dtype=torch.int32, device=x.device),
            "hist": gl.history(gl.sqrt_rn(rs0), maxiter),
        }
        S, _ = loop.run(init)
        return S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy()

    fn.stats = loop.stats
    fn.loop = loop
    fn.staged = dh
    fn.cycle = h.cycle
    return fn


def gmg_solve_fn(h, backend: GPUBackend, tol: float, maxiter: int, plain: bool = False) -> Callable:
    """`make_gmg_solve_fn`'s solve function, cached on the hierarchy beside
    GMG-PCG's (`gmg_pcg_fn`, ``h._fn_cache``; tpu_gmg.py:1193-1204); a
    miss counts in `gpu.STATS` (``solve_fns``)."""
    cache = getattr(h, "_fn_cache", None)
    if cache is None:
        cache = h._fn_cache = {}
    key = ("gmg", backend, float(tol), int(maxiter), bool(plain))
    if key not in cache:
        gpu_stats["solve_fns"] += 1
        cache[key] = make_gmg_solve_fn(h, backend, tol, int(maxiter), plain=plain)
    return cache[key]


def gpu_gmg_solve(h, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8, maxiter: int = 100,
                  verbose: bool = False, plain: bool = False) -> Tuple[PVector, dict]:
    """The stationary cycle iteration on the card, the counterpart of
    `tpu_gmg_solve` (tpu_gmg.py:1208): the device form of
    ``gmg_solve(h, b)``. The solve function is `gmg_solve_fn`'s, cached on
    the hierarchy; ``plain`` as in `gpu_gmg_pcg`."""
    backend = b.values.backend
    check(isinstance(backend, GPUBackend), "gmg_solve on the card needs a GPU-backend PVector")
    solve = gmg_solve_fn(h, backend, tol, int(maxiter), plain=plain)
    dA0 = solve.staged["levels"][0]["dA"]
    return _run_krylov(h.levels[0].A, b, x0, tol, verbose, solve, "gmg", dA=dA0, lowering=dA0.lowering,
                       cycle=h.cycle)


def make_fgmres_gmg_fn(h, backend: GPUBackend, tol: float, maxiter: int, restart: int = 30,
                       plain: bool = False, stencil: bool = True, graph: bool = True) -> Callable:
    """Flexible restarted GMRES with the whole V-cycle as its right
    preconditioner, on the card (tpu_gmg.py:990-1165), the device form of
    ``fgmres(A, b, minv=h)``: ``fn(b, x0) -> (x, rs, rs0, iterations,
    history)``. The Arnoldi loop follows the host algorithm step for step:
    z = Vcycle(v_j) kept in a flexible basis Z beside V, w = A z,
    modified Gram-Schmidt in fixed order, sequential Givens rotations, the
    triangular solve by back-substitution, x updated by axpys over Z in
    host order on the owned band, and the true residual decides the
    restart. One step of the device loop is one restart cycle: the
    ``restart`` Arnoldi steps unrolled, each masked by a device flag
    (active while ``it < maxiter`` and the steps before it neither
    converged, ``|g_{j+1}| <= tol*max(1, beta0)``, nor broke down, hj1 == 0),
    as the JAX program masks its ``fori_loop`` steps; the flag the host
    reads is ``beta > tol*max(1, beta0)`` and ``it < maxiter`` after the
    cycle. ``iterations`` counts Arnoldi steps (V-cycle applications);
    ``plain``, ``stencil`` and ``graph`` as in `make_gmg_pcg_fn` (the box
    plan where the partition has one).
    ``fn.stats`` counts cycles, ``fn.staged`` is the staged hierarchy."""
    from . import gpu_loop as gl

    m = int(restart)
    check(m >= 1, "fgmres: restart dimension must be >= 1")
    dh = device_hierarchy(h, backend, stencil=stencil)
    dA0 = dh["levels"][0]["dA"]
    L0, L0r = dA0.col_layout, dA0.row_layout
    no = L0.no_max
    sl = slice(L0.o0, L0.o0 + no)
    pdot = _pdot_factory(L0.o0, no, False, plain)
    body_A0 = _spmv_body(dA0, plain=plain)
    vcycle = make_vcycle(h, dh, plain=plain)
    stop_it = gl.stop_bound(maxiter)

    def spmv(z):
        out = torch.zeros_like(z)
        out[:, sl] = body_A0(z)[:, L0r.o0 : L0r.o0 + no]
        return out

    def residual(x, b):
        r = torch.zeros_like(x)
        r[:, sl] = b[:, sl] - spmv(x)[:, sl]
        return r

    def step(S):
        live = S["live"]
        x, r, V, Z, b, thr = S["x"], S["r"], S["V"], S["Z"], S["b"], S["thr"]
        b2 = S["beta"]
        one = torch.ones_like(b2)
        V[0] = r / torch.where(b2 > 0, b2, one)
        Hm = torch.zeros((m + 1, m), dtype=b2.dtype, device=b2.device)
        cs = torch.zeros(m, dtype=b2.dtype, device=b2.device)
        sn = torch.zeros_like(cs)
        g = torch.zeros(m + 1, dtype=b2.dtype, device=b2.device)
        g[0] = b2
        active = (live != 0) & (b2 > thr)
        it, hist = S["it"], S["hist"]
        j_used = torch.zeros_like(live)
        for j in range(m):
            active = active & (it < stop_it)
            z = vcycle(V[j])
            w = spmv(z)
            hcol = torch.zeros(m + 1, dtype=b2.dtype, device=b2.device)
            for i in range(j + 1):  # modified Gram-Schmidt, fixed order
                hij = pdot(w, V[i])
                w[:, sl] = w[:, sl] - hij * V[i][:, sl]
                hcol[i] = hij
            hj1 = gl.sqrt_rn(pdot(w, w))
            hcol[j + 1] = hj1
            for i in range(j):  # the accumulated rotations, in order
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                u = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
                hcol[i + 1] = u
            hjj = hcol[j].clone()
            rho = torch.hypot(hjj, hj1)
            csj = torch.where(rho == 0, one, hjj / rho)
            snj = torch.where(rho == 0, 0, hj1 / rho)
            hcol[j] = rho
            hcol[j + 1].zero_()
            gj = g[j].clone()
            res = torch.abs(-snj * gj)
            # masked commits: an inactive step leaves the cycle as it was
            Z[j] = torch.where(active, z, Z[j])
            Hm[:, j] = torch.where(active, hcol, Hm[:, j])
            cs[j] = torch.where(active, csj, cs[j])
            sn[j] = torch.where(active, snj, sn[j])
            g[j] = torch.where(active, csj * gj, g[j])
            g[j + 1] = torch.where(active, -snj * gj, g[j + 1])
            V[j + 1] = torch.where(active, w / torch.where(hj1 > 0, hj1, one), V[j + 1])
            it = it + active.to(it.dtype)
            gl.record(hist, it, active.to(torch.int32), res)
            j_used = torch.where(active, j + 1, j_used)
            # the host breaks after committing step j on convergence or a
            # lucky breakdown
            active = active & (res > thr) & (hj1 > 0)
        # back-substitute the j_used x j_used triangular system
        y = torch.zeros(m, dtype=b2.dtype, device=b2.device)
        for i in range(m - 1, -1, -1):
            s = g[i] - torch.sum(Hm[i, :m] * y)
            d = torch.where(Hm[i, i] != 0, Hm[i, i], one)
            y[i] = torch.where(i < j_used, s / d, 0)
        # the flexible update rides the preconditioned basis Z, axpys in host
        # order over the owned band (Z's ghost slots hold V-cycle internals)
        for i in range(m):
            x[:, sl] = x[:, sl] + y[i] * Z[i][:, sl]
        r_new = residual(x, b)
        beta = gl.sqrt_rn(pdot(r_new, r_new))
        go = (beta > thr) & (it < stop_it)
        return dict(S, r=r_new, beta=beta, it=it, live=live * go.to(torch.int32))

    loop = gl.DeviceLoop(step, 1, graph)

    def fn(b, x0):
        x = x0.clone()
        r = residual(x, b)
        beta0 = gl.sqrt_rn(pdot(r, r))
        thr = tol * torch.clamp(beta0, min=1.0)
        dev = x.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        P, W = x.shape
        init = {
            "x": x, "b": b, "r": r, "beta": beta0, "thr": thr, "it": it,
            "V": torch.zeros((m + 1, P, W), dtype=x.dtype, device=dev),
            "Z": torch.zeros((m, P, W), dtype=x.dtype, device=dev),
            "hist": gl.history(beta0, maxiter), "live": ((beta0 > thr) & (it < stop_it)).to(torch.int32),
        }
        S, _ = loop.run(init)
        beta = S["beta"].clone()
        return S["x"].clone(), beta * beta, beta0 * beta0, int(S["it"].item()), S["hist"].cpu().numpy()

    fn.stats = loop.stats  # updated in place by every run
    fn.loop = loop
    fn.staged = dh
    return fn


def fgmres_gmg_fn(h, backend: GPUBackend, tol: float, maxiter: int, restart: int = 30, plain: bool = False,
                  stencil: bool = True) -> Callable:
    """`make_fgmres_gmg_fn`'s solve function, cached on the hierarchy beside
    GMG-PCG's (`gmg_pcg_fn`, ``h._fn_cache``; tpu_gmg.py:1193-1204), keyed
    by restart, backend, tol, maxiter and the keywords; a miss counts in
    `gpu.STATS` (``solve_fns``)."""
    cache = getattr(h, "_fn_cache", None)
    if cache is None:
        cache = h._fn_cache = {}
    key = ("fgmres+gmg", int(restart), backend, float(tol), int(maxiter), bool(plain), bool(stencil))
    if key not in cache:
        gpu_stats["solve_fns"] += 1
        cache[key] = make_fgmres_gmg_fn(h, backend, tol, int(maxiter), restart=restart, plain=plain, stencil=stencil)
    return cache[key]


def gpu_fgmres_gmg(h, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8,
                   maxiter: Optional[int] = None, restart: int = 30, verbose: bool = False,
                   plain: bool = False, stencil: bool = True) -> Tuple[PVector, dict]:
    """Flexible GMRES with the V-cycle inlined, on the card: the
    counterpart of `tpu_fgmres_gmg` (tpu_gmg.py:1168-1188), the device form
    of ``fgmres(A, b, minv=h)``. The solve function is `fgmres_gmg_fn`'s,
    cached on the hierarchy; ``info["device_loop"]`` counts restart
    cycles, ``iterations`` Arnoldi steps."""
    backend = b.values.backend
    check(isinstance(backend, GPUBackend), "fgmres+gmg needs a GPU-backend PVector")
    if maxiter is None:
        maxiter = 4 * int(h.levels[0].A.rows.ngids)
    solve = fgmres_gmg_fn(h, backend, tol, int(maxiter), restart=restart, plain=plain, stencil=stencil)
    dA0 = solve.staged["levels"][0]["dA"]
    return _run_krylov(h.levels[0].A, b, x0, tol, verbose, solve, f"fgmres+gmg(m={int(restart)})", dA=dA0,
                       lowering=dA0.lowering, restart=int(restart))
