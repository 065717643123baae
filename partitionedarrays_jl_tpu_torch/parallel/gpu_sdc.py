"""The in-graph silent-corruption (SDC) defense of the device CG loops.

The port of the SDC loops of `partitionedarrays_jl_tpu/parallel/tpu.py`'s
`make_cg_fn` (tpu.py:3519-4052: the standard, fused and Jacobi bodies) and
`make_block_cg_fn` (tpu.py:4411-4860), on `gpu_loop.DeviceLoop`. Built by
`gpu.make_cg_fn` / `gpu.make_block_cg_fn` when their ``sdc`` config is
active (`gpu._sdc_config`); otherwise those build exactly the undefended
loops.

A loop step is one trip of three kinds:

* **commit**, a real iteration: the state advances;
* **audit**, every ``ae`` iterations: the body's one SpMV streams ``A x``
  instead of ``A p`` (an operand select before the product, so an audit
  trip launches no second SpMV), the dot's operands are ``d = b - A x -
  r`` (so it yields ||d||², the drift of the recurrence residual from the
  true one), and a state that passes is pushed onto the ring;
* **restore**, on a detection (the ABFT checksum lanes, or a failed
  audit): the ring state ``strike`` slots back replaces the state, the
  in-memory rollback, which rewinds ``it`` and the history rows but not
  ``trip``; once ``mrb`` rollbacks are spent a detection latches the
  escalation flag instead, the loop stops, and `gpu._run_krylov` raises
  `SilentCorruptionError` with the counters.

Every update is a device tensor op, so a block of trips is captured as a
CUDA graph like any other loop: the counters, the trip counter and the
escalation latch are int32 scalars updated by ``torch.where``; the state
vectors x, r and p (the fused body's pprev) live in double buffers ``(2,
...)`` whose slot 1 is a discard slot, so a trip that must not write them
writes slot 1 (``index_copy_`` with a device index); the ring keeps ``R``
audited states in a circular buffer of ``R + 1`` slots (slot R again a
discard), pushed and read by device indices. The sweep kernel updates x and
r in place on commit trips only: its device flag is the commit flag, so a
non-commit trip writes neither. The loop's ``live`` flag folds in "not
escalated" and ``trip < trip_max``.

The clean path: with no fault, every commit trip runs the undefended
body's arithmetic on the same values: the fused body's fold is K2's plain
expression and K1 computes the product (`gpu._spmv_body`'s SDC modes), the
dots and the sweep are the same calls, and the checksum lanes are folded
beside the dot (`gpu._pdot_extra_factory`), not into it. Audit trips change
no state. So the iterations, the history and x are the undefended solve's
bit for bit. After a rollback the replay of a deterministic loop lands bit
for bit on the fault-free run.

The checksum and audit reductions are eager torch ops beside the kernels
(the JAX package's XLA fusions); the ring push and restore and the operand
select each cost whole-vector passes every trip, since a captured graph has
no branch. PERF.md records their cost per trip.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.helpers import check

#: the order of `fn`'s SDC output vector (tpu.py:_decode_sdc_outputs)
SDC_LANES = ("detections", "rollbacks", "audit_iterations", "escalations", "trips")
#: the state vectors' rows of a slot of the vector buffer
X, R_, P_ = 0, 1, 2


def _vector_buffer(x, r, p, R: int) -> torch.Tensor:
    """The state vectors and their ring in one buffer ``(R + 2, 3, ...)``:
    slots 0..R-1 the ring (R copies of the initial state, audited by
    construction), slot R the live state (x, r and p, the fused body's
    pprev, each a contiguous frame the kernels update in place), slot R + 1
    the discard slot."""
    return torch.stack([torch.stack([x, r, p])] * (R + 2))


def _scalar_rings(scal: dict, R: int) -> dict:
    """The ring of the scalar state: ``R`` copies of each initial scalar,
    and a discard slot R."""
    return {"ring_" + k: torch.stack([v] * (R + 1)) for k, v in scal.items()}


def _counters(dev) -> dict:
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return {"since": z(), "strike": z(), "rollbacks": z(), "dets": z(), "audits": z(), "esc": z(), "trip": z(),
            "head": z()}


def _ladder(S: dict, out: dict, cfg: dict, aud, detect, live):
    """The counters' transition of one trip (tpu.py:sdc_next): the restore
    and escalation decisions, the strike, the audit counter and the ring
    head. Returns ``(restore, apass, push_slot, read_slot)``: whether the
    trip restores, whether its audit passed, the ring slot a passed audit
    writes (R, a discard slot, on any other trip) and the slot a restore
    reads (the entry ``strike`` slots behind the newest)."""
    R, mrb = cfg["R"], cfg["mrb"]
    i32 = torch.int32
    exhausted = S["rollbacks"] >= mrb
    restore = detect & ~exhausted
    apass = aud & ~detect
    head = S["head"]
    nhead = torch.remainder(head + 1, R)
    push_slot = torch.where(apass, nhead, torch.full_like(head, R)).to(torch.int64).reshape(1)
    read_slot = torch.remainder(head - torch.clamp(S["strike"], max=R - 1), R).to(torch.int64).reshape(1)
    out.update(
        head=torch.where(apass, nhead, head),
        since=torch.where(aud | restore, torch.zeros_like(S["since"]), S["since"] + live),
        strike=torch.where(restore, torch.clamp(S["strike"] + 1, max=R - 1),
                           torch.where(apass, torch.zeros_like(S["strike"]), S["strike"])),
        rollbacks=S["rollbacks"] + restore.to(i32),
        dets=S["dets"] + detect.to(i32),
        audits=S["audits"] + aud.to(i32),
        esc=torch.where(detect & exhausted, torch.ones_like(S["esc"]), S["esc"]),
        trip=S["trip"] + live,
    )
    return restore, apass, push_slot, read_slot


def _move_vectors(buf, R: int, restore, apass, push_slot, read_slot) -> None:
    """The ring's one vector move of a trip: a passed audit copies the live
    state into the ring slot ``push_slot``, a restore copies the ring slot
    ``read_slot`` into the live state, any other trip copies the live state
    into the discard slot (one gather and one scatter of the three
    vectors, whatever the trip)."""
    live = torch.full_like(push_slot, R)
    src = torch.where(restore, read_slot, live)
    dst = torch.where(apass, push_slot, torch.where(restore, live, live + 1))
    buf.index_copy_(0, dst, buf.index_select(0, src))


def _move_scalars(S: dict, keys, cur: dict, push_slot, read_slot) -> dict:
    """Push the trip's pre-step scalars ``cur`` at ``push_slot`` and read
    the restore candidates at ``read_slot``, ring by ring."""
    got = {}
    for k in keys:
        ring = S["ring_" + k]
        got[k] = ring.index_select(0, read_slot)[0]
        ring.index_copy_(0, push_slot, cur[k].unsqueeze(0))
    return got


def _commit_index(commit, R: int):
    """Slot R (the live state) on a commit trip, R + 1 (discard) otherwise."""
    return torch.where(commit, R, R + 1).to(torch.int64).reshape(1)


def _rewind_history(hist, restore, it_r, rows) -> None:
    """A restore clears the history rows past the restored iteration (NaN,
    as rows never written)."""
    mask = restore & (rows > it_r)
    hist.masked_fill_(mask if hist.dim() == 1 else mask[:, None], math.nan)


def _drift(b, q, r, sl):
    """Per-part partials of ||d||² with d = b - A x - r on an audit trip
    (tpu.py:_aud_ops): the audit's drift of the recurrence residual from the
    true one, ``(P,)`` or ``(P, K)``. Taken every trip (a captured graph
    has no branch) and selected on audit trips only."""
    d = b[:, sl] - q[:, sl]
    d.sub_(r[:, sl])
    return (d * d).sum(dim=1)


def sdc_vector(S: dict) -> torch.Tensor:
    """The SDC output lanes (`SDC_LANES`) of a finished loop's state."""
    return torch.stack([S["dets"], S["rollbacks"], S["audits"], S["esc"], S["trip"]])


def _abft_lanes(dA, sl, block: bool):
    """``lanes(q, xpost, exd, exs) -> (delta, scale)`` per part, the ABFT
    identity ``c·(A x)`` against ``(c·A)·x`` with the staged checksum row
    (tpu.py:cs_lanes): float64 sums (of q read in its dtype, and of the
    float64 products w·x), cast to the working dtype, plus the exchange
    rounds' checksum pair."""
    w = dA.abft_row()
    f64 = torch.float64

    def lanes(q, xpost, exd, exs):
        qo = q[:, sl]
        t = (w[:, :, None] if block else w) * xpost
        delta = (torch.sum(qo, dim=1, dtype=f64) - t.sum(dim=1)).abs() + exd.to(f64).abs()
        scale = (torch.linalg.vector_norm(qo, ord=1, dim=1, dtype=f64) + torch.linalg.vector_norm(t, ord=1, dim=1)
                 + exs.to(f64))
        return delta.to(q.dtype), scale.to(q.dtype)

    return lanes


def _injector(cfg: dict, P: int, o0: int, block: bool):
    """The device fault clause (tpu.py:inject): at trip ``trip`` of a live
    loop, part ``part``'s first owned slot of q (column 0 of a slab) gets
    ``factor·(1 + |q|)`` added, before the checksum, so detection and
    recurrence see the same corrupted product. A part outside the grid is
    inert."""
    fault = cfg["fault"]
    if fault is None or not (0 <= fault["part"] < P):
        return lambda q, trip, on: q
    fp, ft, factor = fault["part"], fault["trip"], fault["factor"]

    def inject(q, trip, on):
        idx = (fp, o0, 0) if block else (fp, o0)
        v = q[idx]
        q[idx] = torch.where(on & (trip == ft), v + factor * (1.0 + v.abs()), v)
        return q

    return inject


def make_sdc_cg_fn(dA, tol: float, maxiter: int, cfg: dict, fused: bool, precond: bool, plain: bool,
                   graph: bool, block: Optional[int]):
    """The SDC-defended single-vector CG loop (tpu.py:3652-4052): ``fn(b,
    x0[, minv]) -> (x, rs, rs0, iterations, history, sdc)``, ``sdc`` the
    (5,) int32 vector of `SDC_LANES`. ``fused`` the fused body (the fold
    K2's plain expression, K1 the product), else the standard one;
    ``precond`` Jacobi PCG; on a strict lowering the sweep updates x and r
    and E3 takes every dot, as the undefended strict loop does."""
    return _make_fn(dA, tol, maxiter, cfg, fused, precond, plain, graph, block, None)


def make_sdc_block_cg_fn(dA, tol: float, maxiter: int, K: int, cfg: dict, fused: bool, precond: bool,
                         plain: bool, graph: bool, block: Optional[int]):
    """The SDC-defended block CG loop (tpu.py:4499-4860): (K,) checksum and
    audit lanes, a detection in any column is a detection of the trip, and
    a rollback restores the whole block (frozen columns to their frozen
    bits). ``fn(b, x0[, minv]) -> (x, rs, rs0, iterations (K,), history (H,
    K), sdc)``; each column's commit-trip arithmetic is the undefended
    block body's."""
    return _make_fn(dA, tol, maxiter, cfg, fused, precond, plain, graph, block, int(K))


def _make_fn(dA, tol, maxiter, cfg, fused, precond, plain, graph, block, K):
    """Both loops: ``K`` None the single-vector body (its scalars 0-d, the
    sweep `cg_sweep`, the dot `_pdot_factory`), else the block body over
    ``(P, W, K)`` slabs (per-column scalars and flags, `cg_sweep_block`,
    `_block_pdot_factory`), each the undefended body's arithmetic on commit
    trips."""
    from . import gpu_loop as gl
    from .gpu import _fold_parts, _pdot_extra_factory, _sdc_tolerances, _spmv_body
    from ..ops import sweep as sw

    slab = K is not None
    strict = dA.strict
    abft, ae, R = cfg["abft"], cfg["ae"], cfg["R"]
    audit = ae > 0
    body = _spmv_body(dA, plain=plain, block=slab, abft=abft)
    body_pfold = _spmv_body(dA, pfold=True, plain=plain, block=slab, abft=abft, audit=audit) if fused else None
    if slab:
        sweep = sw.cg_sweep_block_plain if plain else sw.cg_sweep_block
    else:
        sweep = sw.cg_sweep_plain if plain else sw.cg_sweep
    o0, no_max, P = dA.row_layout.o0, dA.row_layout.no_max, dA.row_layout.P
    sl = slice(o0, o0 + no_max)
    pdotx = _pdot_extra_factory(o0, no_max, strict, plain, block=slab)
    lanes = _abft_lanes(dA, sl, slab) if abft else None
    inject = _injector(cfg, P, o0, slab)
    stop_it = gl.stop_bound(maxiter)
    trip_max = cfg["trip_max"]
    scal_keys = ("rs", "rz", "beta", "it") + (("itk",) if slab else ())
    tiny = {}

    def step(S):
        buf = S["buf"]
        x, r, p_state = buf[R, X], buf[R, R_], buf[R, P_]
        rs, rz, it, armed = S["rs"], S["rz"], S["it"], S["live"]
        go = (gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it) & torch.isfinite(rs)
        if precond:
            go = go & (rz != 0)
        gate = (S["trip"] < trip_max) & (S["esc"] == 0)
        if slab:
            act = (go & (armed != 0) & gate).to(torch.int32)  # (K,)
            on_k = act != 0
            live = act.amax()
        else:
            live = armed * (go & gate).to(torch.int32)
            on_k = live != 0
        on = live != 0
        aud = on & (S["since"] >= ae) if audit else torch.zeros_like(on)
        mv = S["minv"] if precond else None
        beta_in = torch.where(on_k, S["beta"], 0) if slab else S["beta"]
        if fused:
            out_b = body_pfold(r, p_state, beta_in, minv=mv, aud=aud if audit else None, audx=x)
            q, opnd = out_b[0], out_b[1]
            p = opnd
            exd_exs = out_b[2:]
        else:
            p = p_state
            opnd = torch.where(aud, x, p) if audit else p
            out_b = body(opnd)
            q = out_b[0] if abft else out_b
            exd_exs = out_b[1:] if abft else ()
        q = inject(q, S["trip"], on)
        extras = lanes(q, opnd, *exd_exs) if abft else ()
        pq, ex_out = pdotx(p, q, extras)
        pqdd = torch.where(aud, _fold_parts(_drift(S["b"], q, r, sl)), pq) if audit else pq
        key = q.dtype
        if key not in tiny:
            tiny[key] = float(torch.finfo(q.dtype).tiny)
        if abft:
            cs_trip = ex_out[0] > S["cs_tol"] * (ex_out[1] + tiny[key])
            cs_trip = cs_trip.any() if slab else cs_trip
        else:
            cs_trip = torch.zeros_like(on)
        audit_fail = aud & ((pqdd > S["athr2"]).any() if slab else (pqdd > S["athr2"]))
        detect = on & (cs_trip | audit_fail)
        commit = on & ~aud & ~detect
        if slab:
            cact = act * commit.to(torch.int32)
            con = cact != 0
            alpha = torch.where(on_k, rz / pqdd, 0)
        else:
            cact = commit.to(torch.int32)
            con = commit
            alpha = rz / pqdd
        if strict:
            sweep(r, q, alpha, cact, S["part"], o0, no_max, x=x, p=p)
            rs_new = pdotx(r, r)[0]
            if precond:
                z = torch.zeros_like(r)
                z[:, sl] = (mv[:, sl, None] if slab else mv[:, sl]) * r[:, sl]
                rz_new = pdotx(r, z)[0]
        elif precond:
            rz_new, rs_new = sweep(r, q, alpha, cact, S["part"], o0, no_max, x=x, p=p, minv=mv)
        else:
            rs_new = sweep(r, q, alpha, cact, S["part"], o0, no_max, x=x, p=p)
        if not precond:
            rz_new = rs_new
        beta_new = rz_new / rz
        # the direction advances on commit trips only (the discard slot
        # takes it otherwise)
        cidx = _commit_index(commit, R)
        if fused:
            buf[:, P_].index_copy_(0, cidx, p.unsqueeze(0))
        else:
            z = ((mv[:, sl, None] if slab else mv[:, sl]) * r[:, sl]) if precond else r[:, sl]
            bn = torch.where(on_k, beta_new, 0) if slab else beta_new
            buf[:, P_, :, sl].index_copy_(0, cidx, (z + bn * p[:, sl]).unsqueeze(0))
        out = dict(S)
        restore, apass, push_slot, read_slot = _ladder(S, out, cfg, aud, detect, live)
        _move_vectors(buf, R, restore, apass, push_slot, read_slot)
        cur = {"rs": rs, "rz": rz, "beta": S["beta"], "it": it}
        if slab:
            cur["itk"] = S["itk"]
        got = _move_scalars(S, scal_keys, cur, push_slot, read_slot)
        gl.record(S["hist"], it + 1, cact, gl.sqrt_rn(rs_new))
        _rewind_history(S["hist"], restore, got["it"], S["rows"])
        out.update(
            rs=torch.where(con, rs_new, torch.where(restore, got["rs"], rs)),
            rz=torch.where(con, rz_new, torch.where(restore, got["rz"], rz)),
            beta=torch.where(con, beta_new, torch.where(restore, got["beta"], S["beta"])),
            it=torch.where(commit, it + 1, torch.where(restore, got["it"], it)),
            live=live,
        )
        if slab:
            out["itk"] = torch.where(commit, S["itk"] + act, torch.where(restore, got["itk"], S["itk"]))
        return out

    loop = gl.DeviceLoop(step, gl.CG_BLOCK if block is None else block, graph)

    def fn(b, x0, minv=None):
        if slab:
            check(tuple(b.shape) == tuple(x0.shape) and b.dim() == 3 and b.shape[2] == K,
                  f"block cg: operands laid out {tuple(b.shape)}/{tuple(x0.shape)}, the function expects "
                  f"(P, W, {K}) slabs in the matrix's column layout")
        check((minv is not None) == precond, "pass minv exactly when the function was built with precond")
        dev = x0.device
        x = x0.clone()
        q = body(x0.clone())
        q = q[0] if abft else q
        r = torch.zeros_like(x)
        r[:, sl] = b[:, sl] - q[:, sl]
        rs0 = pdotx(r, r)[0]
        cs_tol, audit_tol = _sdc_tolerances(cfg, x.dtype, P, no_max)
        z, rz0 = r, rs0
        if precond:
            z = torch.zeros_like(r)
            z[:, sl] = (minv[:, sl, None] if slab else minv[:, sl]) * r[:, sl]
            rz0 = pdotx(r, z)[0]
        p0 = torch.zeros_like(x)
        if not fused:
            p0[:, sl] = z[:, sl]
        zero = torch.zeros_like(rs0)
        it0 = torch.zeros((), dtype=torch.int32, device=dev)
        hist = gl.history(gl.sqrt_rn(rs0), maxiter)
        scal = {"rs": rs0, "rz": rz0, "beta": zero, "it": it0}
        if slab:
            scal["itk"] = torch.zeros((K,), dtype=torch.int32, device=dev)
        init = {
            "buf": _vector_buffer(x, r, p0, R), "b": b, **scal,
            "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
            "athr2": (audit_tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0)) ** 2,
            "cs_tol": torch.tensor(cs_tol, dtype=x.dtype, device=dev),
            "live": torch.ones((), dtype=torch.int32, device=dev),
            "hist": hist, "rows": torch.arange(hist.shape[0], device=dev, dtype=torch.int32),
            "part": sw.sweep_partials(r, no_max, ((2 * K if precond and not strict else K) if slab else
                                                   (2 if precond and not strict else None))),
            **_counters(dev), **_scalar_rings(scal, R),
        }
        if precond:
            init["minv"] = minv
        S, _ = loop.run(init)
        iters = S["itk"].cpu().numpy().astype(np.int64) if slab else int(S["it"].item())
        return (S["buf"][R, X].clone(), S["rs"].clone(), rs0, iters, S["hist"].cpu().numpy(),
                sdc_vector(S).cpu().numpy())

    fn.cg_body = "fused" if fused else "standard"
    fn.precond = bool(precond)
    fn.strict = strict
    fn.overlap = False
    if slab:
        fn.rhs_batch = K
    fn.has_sdc = True
    fn.abft = abft
    fn.stats = loop.stats
    fn.loop = loop
    return fn
