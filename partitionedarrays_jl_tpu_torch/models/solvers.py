"""Distributed Krylov solvers over the PData algebra.

The port's copy of the parts of `partitionedarrays_jl_tpu/models/solvers.py`
that the Poisson, multigrid and advection slices need (solvers.py:45-289,
:290-522, :540-922, :939-1066, :1345-1674, :1677-2152): `bicgstab`, `gmres`,
`minres` and `chebyshev_solve` dispatch a GPU-backend right-hand side to
their device loops (`parallel/gpu_krylov.py`) under the JAX package's
conditions (a callable preconditioner runs the host loop on any backend);
`fgmres`, `lanczos_bounds` and `gershgorin_bounds` are host loops on every
backend (the device FGMRES with the V-cycle is `gpu_gmg.gpu_fgmres_gmg`);
`cg` dispatches a GPU-backend right-hand side to
`parallel/gpu.py:gpu_cg` (fused, standard or pipelined body) and runs the
host CG loop for anything else; `pcg` sends a diagonal preconditioner
(Jacobi, the default) on the GPU backend to `gpu_cg(minv=)` and a
`GMGHierarchy` to `parallel/gpu_gmg.py:gpu_gmg_pcg`, and runs the host PCG
loop for any other callable preconditioner on any backend; both take a
block of right-hand sides ``B`` (`gpu_block_cg` on the GPU backend, solo
loops in sequence elsewhere, `_host_block_solve`);
`decouple_dirichlet` symmetrizes a Dirichlet-identity system;
`gather_psparse`/`gather_pvector` collect on MAIN, where `PLU` factors.

``strict=True`` is strict-bits mode (the JAX package's
``PA_TPU_STRICT_BITS=1``, a keyword here): the host loops take the strict
SpMV (`csr_spmv(strict=True)`) and the fixed-tree dots
(`PVector.dot(strict=True)`), the device loop the ELL lowering and E3, and
both give the same iterations, residual history and solution bit for bit;
the device block solve too, each column its solo strict loop. The strict
device GMG-PCG takes the host strict loop's iterations and agrees with it
to rounding (the JAX package promises no more: its V-cycle is not the
host's either).
``lowering`` names the first non-band lowering the device tries
(`parallel/gpu.py:DeviceMatrix`: "auto", "sd", "bsr", "ell"), for the solo
and the block solves alike.

The resilience layer (solvers.py:152-525, :1556-1813, :2153-2611): the host
`cg`, `pcg` and `gmres` raise the typed health errors of `utils/health.py`
where the JAX package does (``health=True``, its ``PA_HEALTH_CHECKS``;
``stagnation=`` its ``PA_HEALTH_STAGNATION``); ``sdc=SDCConfig(...)``
runs the host CG and PCG loops under the silent-corruption defense
(`_SDCGuard`: checksummed exchanges, the periodic true-residual audit and
the in-memory rollback ring) and the device loops under its in-graph form;
``checkpoint=`` (a `parallel/checkpoint.SolverCheckpointer`) saves the host
loops' full recurrence state, which `resume_solve` continues exactly;
`solve_with_recovery` restarts a failed solve from its last checkpoint
(host) or runs the device solve in checkpointed chunks.

Telemetry (solvers.py:394-406, :525, :1539-1551 of the JAX package): `cg`,
`pcg` and `solve_with_recovery` run in a `telemetry.solve_scope` and
return an ``InfoDict`` (``info.record``); the host loops stamp their α/β
recurrence on the record (`_attach_host_ab`), the device loops their trace
ring (``trace_iters=``), and a finished CG or PCG feeds
`telemetry.observe_solve`. The SDC guard, the block driver's column
verdicts and the recovery restarts emit their events.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from ..ops.sparse import CSRMatrix, compresscoo
from ..parallel.backends import map_parts
from ..parallel.prange import PRange, oids_are_equal
from ..parallel.psparse import PSparseMatrix, psparse_global_triplets
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


def _matvec(A: PSparseMatrix, x: PVector, strict: bool) -> PVector:
    """A @ x, with strict mode's left-to-right row folds when ``strict``."""
    if not strict:
        return A @ x
    return A.mul_into(PVector.full(0.0, A.rows, dtype=np.result_type(A.dtype, x.dtype)), x, strict=True)


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


def _host_block_solve(solve_one, B, X0, column_errors="raise"):
    """Host multi-RHS driver (solvers.py:45-124): each column runs the solo
    loop, the per-column semantics the device block program reproduces.
    Returns ``(xs, info)`` with per-column infos under ``columns`` and
    the worst-column aggregates at top level. With ``column_errors=
    "report"`` a column whose solo loop raises a `SolverHealthError` gets
    a failed-column info (and the error under ``column_health``) while the
    other columns still run; ``"raise"`` lets the first failure through."""
    from ..utils.health import SolverHealthError

    K = len(B)
    check(K >= 1, "block solve: B must hold at least one right-hand side")
    X0 = list(X0) if X0 is not None else [None] * K
    check(len(X0) == K, "block solve: X0 must hold one start per RHS")
    xs, columns, health = [], [], []
    for bk, x0k in zip(B, X0):
        try:
            x, inf = solve_one(bk, x0k)
        except SolverHealthError as e:
            if column_errors != "report":
                raise
            from .. import telemetry

            telemetry.emit_event("column_verdict", label="block-host", columns=[len(xs)],
                                 error=type(e).__name__)
            xs.append(x0k.copy() if x0k is not None else None)
            columns.append({"iterations": 0, "residuals": [], "converged": False, "status": type(e).__name__})
            health.append({"status": type(e).__name__, "converged": False, "iterations": 0, "error": e})
            continue
        xs.append(x)
        columns.append(inf)
        health.append({"status": "ok", "converged": bool(inf["converged"]), "iterations": int(inf["iterations"])})
    # an unconverged column wins the aggregate over a merely slow one
    bad_cols = [k for k in range(K) if not columns[k]["converged"]]
    worst = (max(bad_cols, key=lambda k: columns[k]["iterations"]) if bad_cols
             else max(range(K), key=lambda k: columns[k]["iterations"]))
    info = {
        "iterations": max(c["iterations"] for c in columns),
        "iterations_per_column": [c["iterations"] for c in columns],
        "residuals": columns[worst]["residuals"],
        "converged": not bad_cols,
        "status": columns[worst]["status"],
        "columns": columns,
        "column_health": health,
        "rhs_batch": K,
        "cg_body": "host",
    }
    return xs, info


def _check_block_args(name, b, x0, B, column_errors="raise", checkpoint=None, _resume_state=None):
    """Validate a multi-RHS call (solvers.py:126-147); returns B as a list."""
    check(column_errors in ("raise", "report"), f"{name}: column_errors is 'raise' or 'report'")
    check(b is None and x0 is None, f"{name}: pass b/x0 OR the multi-RHS block B/X0, not both")
    B = list(B)
    check(len(B) >= 1, f"{name}: B must hold at least one right-hand side")
    if checkpoint is not None or _resume_state is not None:
        raise ValueError(f"{name}: checkpoint/resume is a single-RHS feature; solve columns individually to "
                         "checkpoint them")
    return B


class _SDCGuard:
    """The host loops' silent-corruption defense, shared by `cg` and `pcg`
    (solvers.py:152-288): the periodic true-residual audit and the bounded
    in-memory rollback ring (`utils/health.RollbackRing`), the oracle of the
    device loops' in-graph ladder:

    1. a detection (`SilentCorruptionError` from a checksummed exchange, or
       a failed audit here) rewinds the recurrence to the newest audited
       ring state, at most ``audit_every`` iterations back, with no disk I/O;
    2. consecutive failed replays walk to older ring entries;
    3. past ``max_rollbacks`` rollbacks the next detection escalates: a
       `SilentCorruptionError` carrying the counters under
       ``diagnostics["sdc"]``, which `solve_with_recovery` turns into a
       checkpoint restart.

    Inactive (every call a no-op) without an active ``sdc`` or with
    ``health=False``. The audit's extra ``A @ x`` runs one exchange, so the
    chaos harness's call counter advances faster with audits on; replayed
    iterations are new wire calls, so a one-shot ``call=k`` clause does
    not fire again on the replay, which is why a clean replay heals."""

    def __init__(self, name: str, matvec, b, rs0, health: bool, sdc):
        from ..utils.health import RollbackRing

        self.name = name
        self.matvec, self.b = matvec, b
        self.rs0 = float(rs0)
        self.active = bool(health) and sdc is not None
        self.every = sdc.every if self.active else 0
        self.ring = RollbackRing(sdc.rollback_depth) if self.active else None
        self.max_rb = sdc.max_rollbacks if self.active else 0
        self.tol = sdc.audit_tolerance(b.dtype) if self.active else 0.0
        self.strike = 0
        self.counters = {"detections": 0, "rollbacks": 0, "escalations": 0, "audit_iterations": 0}

    def push(self, vectors: dict, meta: dict, history) -> None:
        """Record an audited state (the initial state is one by construction)."""
        if not self.active:
            return
        m = dict(meta)
        m["history"] = [np.float64(h) for h in history]
        self.ring.push(vectors, m)
        self.strike = 0

    def audit(self, x, r, it: int, meta: dict, extra_vectors: dict, history):
        """Every ``audit_every`` iterations: ||(b - A x) - r|| must lie within
        the recurrence's rounding envelope; a pass pushes the state onto the
        ring, a failure raises `SilentCorruptionError` (caught by the loop's
        rollback arm)."""
        if not self.active or self.every <= 0 or it == 0 or it % self.every:
            return
        from ..utils.health import SilentCorruptionError

        self.counters["audit_iterations"] += 1
        rt = self.b.copy()
        qx = self.matvec(x)
        _owned_update(rt, lambda tv, qv: tv - qv, qx)
        _owned_update(rt, lambda tv, rv: tv - rv, r)
        drift = float(rt.norm())
        thresh = self.tol * max(1.0, float(np.sqrt(self.rs0)))
        if not (drift <= thresh):  # NaN fails <=
            raise SilentCorruptionError(
                f"{self.name}: true-residual audit failed at iteration {it}: ||(b - A x) - r|| = {drift:.3e} "
                f"exceeds {thresh:.3e}: the recurrence has silently diverged from the true residual",
                diagnostics={"detector": "true_residual_audit", "iteration": int(it), "drift": drift,
                             "threshold": thresh},
            )
        self.push({"x": x, "r": r, **extra_vectors}, meta, history)

    def rollback(self, e, it: int):
        """Handle a detection: the ring state ``strike`` slots back, or the
        escalation once the budget is spent. Returns ``(vectors, meta,
        history)`` for the loop to reinstate."""
        from .. import telemetry
        from ..utils.health import SilentCorruptionError

        self.counters["detections"] += 1
        telemetry.emit_event("sdc_detection", label=self.name, iteration=int(it),
                             detector=getattr(e, "diagnostics", {}).get("detector"))
        exhausted = self.counters["rollbacks"] >= self.max_rb
        st = self.ring.restore(self.strike) if self.active and not exhausted else None
        if st is None:
            self.counters["escalations"] += 1
            telemetry.emit_event("sdc_escalation", label=self.name, iteration=int(it),
                                 rollbacks=self.counters["rollbacks"])
            diag = dict(getattr(e, "diagnostics", {}))
            diag["sdc"] = dict(self.counters)
            diag["iteration"] = int(it)
            raise SilentCorruptionError(
                f"{self.name}: {e}: in-memory rollback budget ({self.max_rb}) exhausted at iteration {it}; "
                "escalating to the checkpoint-restart tier (solve_with_recovery)",
                diagnostics=diag,
            ) from e
        self.counters["rollbacks"] += 1
        self.strike += 1
        vecs, meta = st
        telemetry.emit_event("sdc_rollback", label=self.name, iteration=int(it),
                             restored_iteration=int(meta.get("it", 0)), strike=self.strike)
        return vecs, meta, list(meta["history"])

    def info_extra(self) -> dict:
        return {"sdc": dict(self.counters)} if self.active else {}


def _abft_scope(sdc, health: bool):
    """The host exchanges' checksum scope of a defended solve: open when
    ``sdc`` asks for ABFT (and health is on), else a no-op."""
    from contextlib import nullcontext

    from ..parallel.collectives import abft_exchanges

    return abft_exchanges(sdc.abft_tol) if (health and sdc is not None and sdc.abft) else nullcontext()


def cg(
    A: PSparseMatrix,
    b: Optional[PVector] = None,
    x0: Optional[PVector] = None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    verbose: bool = False,
    pipelined: bool = False,
    fused: Optional[bool] = None,
    box: bool = True,
    B=None,
    X0=None,
    column_errors: str = "raise",
    strict: bool = False,
    lowering: str = "auto",
    sstep: Optional[int] = None,
    overlap: bool = False,
    health: bool = True,
    stagnation=None,
    sdc=None,
    checkpoint=None,
    _resume_state: Optional[dict] = None,
    trace_iters: int = 0,
) -> Tuple[PVector, dict]:
    """Conjugate gradients for SPD `A`; the start vector lives on
    ``A.cols``. A GPU-backend `b` runs the device loop (`gpu_cg`: the
    fused body by default, the lag-1 body with ``pipelined``, the textbook
    body with ``fused=False``; fused and pipelined together raise; the box
    exchange plan on a Cartesian partition unless ``box=False``); any
    other backend runs the host loop below, whose value sequence every
    device body follows (the three flags are host no-ops).

    ``B`` (a sequence of K right-hand-side PVectors, with optional starts
    ``X0``) selects the multi-RHS block solve instead of ``b``/``x0``: on
    the GPU backend one device loop for the whole block (`gpu_block_cg`,
    fused or standard body), each column following its solo recurrence and
    freezing where it stops; elsewhere the solo loop column by column.
    Returns ``(xs, info)``; ``column_errors="report"`` reports a column's
    non-finite failure under ``info["column_health"]`` instead of raising.
    ``pipelined`` with ``B`` raises: the lag-1 body is single-RHS only.

    ``strict`` and ``lowering``: see the module docstring; the device block
    solve takes both, on every lowering (a band, SD, BSR, ELL), each
    column in strict mode the host's strict solo loop bit for bit.

    ``sstep=s`` (s >= 2) runs the device loop's s-step (communication-
    avoiding) body (`parallel/gpu.py:make_cg_fn`); with ``fused=True``,
    ``pipelined``, ``B``, ``strict`` or an active ``sdc`` it raises
    `LoweringConflictError`. ``overlap`` runs the device SpMVs with the
    interior/boundary overlap tail (the same values). Both are host no-ops
    but for the conflicts.

    Health (solvers.py:410-522): with ``health`` (the default) a
    non-finite r.r raises `NonFiniteError` at the iteration it appears (a
    poisoned start at iteration 0, before the loop), p'Ap == 0 raises
    `SolverBreakdownError`, and ``stagnation`` (True, or a ``(window,
    factor)`` pair) raises `SolverStagnationError` when the best residual
    stops improving. ``sdc`` (an `SDCConfig`) runs the silent-corruption
    defense: on the host `_SDCGuard` (checksummed exchanges under
    ``abft``, the audit every ``audit_every`` iterations, the rollback
    ring), on the device the in-graph form (`gpu.make_cg_fn`); the info
    dict then carries ``info["sdc"]``, the counters. ``checkpoint`` (a
    `SolverCheckpointer`) saves the full recurrence state every
    ``checkpoint.every`` iterations, host loop only; `resume_solve`
    continues it (``_resume_state``) on the same trajectory.

    ``trace_iters`` (the JAX package's ``PA_TRACE_ITERS``) gives the device
    loops their α/β trace ring, its last ``trace_iters`` iterations on
    ``info.record.alpha``/``beta``; the host loop records every iteration's
    α and β whatever it is."""
    from ..parallel.gpu import GPUBackend, _sstep_conflict, gpu_block_cg, gpu_cg
    from ..utils.health import resolve_sdc

    sdc = resolve_sdc(sdc)
    if B is not None:
        B = _check_block_args("cg", b, x0, B, column_errors, checkpoint, _resume_state)
        if int(sstep or 0) >= 2:
            _sstep_conflict("rhs_batch")
        if pipelined:
            raise ValueError("cg: the pipelined (lag-1) form is single-RHS only; drop pipelined or B")
        if isinstance(B[0].values.backend, GPUBackend):
            return gpu_block_cg(A, B, X0=X0, tol=tol, maxiter=maxiter, verbose=verbose, fused=fused,
                                column_errors=column_errors, box=box, strict=strict, lowering=lowering,
                                overlap=overlap, sdc=sdc, trace_iters=trace_iters)
        return _host_block_solve(
            lambda bk, x0k: cg(A, bk, x0=x0k, tol=tol, maxiter=maxiter, verbose=verbose, strict=strict,
                               health=health, stagnation=stagnation, sdc=sdc),
            B, X0, column_errors=column_errors,
        )
    check(b is not None, "cg: a right-hand side b (or a block B) is required")
    if isinstance(b.values.backend, GPUBackend):
        if checkpoint is not None or _resume_state is not None:
            raise ValueError(
                "cg: per-iteration checkpointing is a host-loop feature; the device loop cannot stop "
                "mid-solve: use models.solvers.solve_with_recovery, which chunks the device solve at "
                "checkpoint boundaries"
            )
        return gpu_cg(
            A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose, fused=fused,
            pipelined=pipelined, box=box, strict=strict, lowering=lowering, sstep=sstep, overlap=overlap,
            health=health, sdc=sdc, trace_iters=trace_iters,
        )
    if sdc is not None and int(sstep or 0) >= 2:
        _sstep_conflict("the SDC defense (sdc=)")
    from .. import telemetry

    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    with telemetry.solve_scope("cg", backend="host", tol=float(tol), maxiter=int(maxiter),
                               resumed=_resume_state is not None) as rec:
        with _abft_scope(sdc, health):
            x, info = _cg_host_loop(A, b, x0, tol, maxiter, verbose, strict, health, stagnation, sdc, checkpoint,
                                    _resume_state)
        # spectral estimate and anomaly detection, before the finish
        telemetry.observe_solve(A, rec, info=info, dtype=b.dtype)
        return x, rec.finish(info)


def _cg_host_loop(A, b, x0, tol, maxiter, verbose, strict, health, stagnation, sdc, checkpoint, _resume_state):
    """The host CG recurrence (solvers.py:410-522), the oracle every device
    body is held against, with its health guards, SDC guard and checkpoint
    hook."""
    from ..utils.health import (
        SilentCorruptionError, SolverBreakdownError, StagnationDetector, check_finite_scalar,
    )

    floor_warned = warn_tol_below_floor(tol, b.dtype, name="cg")
    if _resume_state is not None:
        x, r, p = _resume_state["x"], _resume_state["r"], _resume_state["p"]
        meta = _resume_state["meta"]
        rs, rs0, it = meta["rs"], meta["rs0"], int(meta["it"])
        history = [np.float64(h) for h in meta["history"]]
    else:
        x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
        r = b.copy()  # rows-range residual
        q = _matvec(A, x, strict)
        _owned_update(r, lambda rv, qv: rv - qv, q)
        p = PVector.full(0.0, A.cols, dtype=b.dtype)
        _owned_assign(p, r)
        rs = r.dot(r, strict=strict)
        rs0 = rs
        history = [np.sqrt(rs)]
        it = 0
    if health and _resume_state is None:
        # a NaN in b/x0 makes the while test False: guard before the loop so
        # a poisoned start raises instead of returning converged=False
        check_finite_scalar(rs, "cg", it=0, vectors=(("r", r), ("x", x)))
    stag = StagnationDetector.from_option("cg", stagnation) if health else None
    guard = _SDCGuard("cg", lambda v: _matvec(A, v, strict), b, rs0, health, sdc)
    guard.push({"x": x, "r": r, "p": p}, {"rs": rs, "it": it}, history)
    # the α/β recurrence (the device ring's host twin), rewound with a rollback
    it0, ab_alpha, ab_beta = it, [], []
    while np.sqrt(rs) > tol * max(1.0, np.sqrt(rs0)) and it < maxiter:
        try:
            q = _matvec(A, p, strict)
            pq = p.dot(q, strict=strict)
            if pq == 0.0:
                raise SolverBreakdownError("cg: breakdown, p'Ap == 0", diagnostics={"iteration": it, "rs": float(rs)})
            alpha = rs / pq
            _owned_update(x, lambda xv, pv: xv + alpha * pv, p)
            _owned_update(r, lambda rv, qv: rv - alpha * qv, q)
            rs_new = r.dot(r, strict=strict)
            if health:
                # free: rs_new was reduced anyway
                check_finite_scalar(rs_new, "cg", it=it + 1, vectors=(("r", r), ("q", q), ("x", x)))
            beta = rs_new / rs
            _owned_update(p, lambda pv, rv: rv + beta * pv, r)
            rs = rs_new
            history.append(np.sqrt(rs))
            it += 1
            ab_alpha.append(float(alpha))
            ab_beta.append(float(beta))
            guard.audit(x, r, it, {"rs": rs, "it": it}, {"p": p}, history)
        except SilentCorruptionError as e:
            # the in-memory rollback to the newest audited state, or the
            # escalation once the budget is spent
            vecs, meta_r, history = guard.rollback(e, it)
            x, r, p = vecs["x"], vecs["r"], vecs["p"]
            rs, it = meta_r["rs"], meta_r["it"]
            del ab_alpha[max(0, it - it0):], ab_beta[max(0, it - it0):]
            continue
        if stag is not None:
            stag.update(float(np.sqrt(rs)), it)
        if checkpoint is not None and checkpoint.due(it):
            checkpoint.save_state(
                {"x": x, "r": r, "p": p},
                {"method": "cg", "it": it, "rs": rs, "rs0": rs0, "tol": tol, "maxiter": maxiter,
                 "history": history},
            )
        if verbose:
            print(f"cg it={it} residual={np.sqrt(rs):.3e}")
    if checkpoint is not None:
        checkpoint.wait()  # the last write lands before the return
    _attach_host_ab(ab_alpha, ab_beta, it0)
    return x, krylov_info(
        it, history, np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)),
        tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(
            A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
            force=floor_warned,
        ),
        cg_body="host", **guard.info_extra(),
    )


def _attach_host_ab(ab_alpha, ab_beta, it0: int) -> None:
    """Stamp a host loop's α/β recurrence on the active `SolveRecord`
    (solvers.py:525): the spectrum layer reads it as it reads the device
    ring. No-op on inert records or zero-iteration solves."""
    from .. import telemetry

    rec = telemetry.current_record()
    if rec is None or not rec.enabled or not ab_alpha:
        return
    rec.alpha = list(ab_alpha)
    rec.beta = list(ab_beta)
    rec.trace_start = int(it0)


def gather_psparse(A: PSparseMatrix) -> CSRMatrix:
    """The owned-row triplets of every part compressed into the global
    matrix (reference gather(A): src/Interfaces.jl:2664-2704)."""
    gi_all, gj_all, v_all = [], [], []
    for (gi, gj, v), iset in zip(
        psparse_global_triplets(A).part_values(), A.rows.partition.part_values()
    ):
        owned = iset.lid_to_ohid[iset.gids_to_lids(gi)] >= 0
        gi_all.append(gi[owned])
        gj_all.append(gj[owned])
        v_all.append(v[owned])
    return compresscoo(
        np.concatenate(gi_all), np.concatenate(gj_all), np.concatenate(v_all),
        A.rows.ngids, A.cols.ngids,
    )


def gather_pvector(b: PVector) -> np.ndarray:
    """Owned values of every part placed at their gids (on MAIN)."""
    out = np.zeros(b.rows.ngids, dtype=b.dtype)
    for iset, vals in zip(b.rows.partition.part_values(), b.values.part_values()):
        out[iset.oid_to_gid] = _owned(iset, np.asarray(vals))
    return out


def scatter_pvector_values(c_main: np.ndarray, rows: PRange) -> PVector:
    """Distribute a global vector over a PRange, ghost entries included
    (reference scatter!: src/Interfaces.jl:2734-2748)."""
    return PVector(map_parts(lambda i: np.asarray(c_main)[i.lid_to_gid], rows.partition), rows)


class PLU:
    """Centralize-on-main LU factorization, reusable across solves
    (reference PLU/lu/ldiv!: src/Interfaces.jl:2641-2662)."""

    def __init__(self, A: PSparseMatrix):
        from scipy.linalg import lu_factor

        self.cols = A.cols
        self._factors = lu_factor(_dense(gather_psparse(A)))

    def refactorize(self, A: PSparseMatrix) -> "PLU":
        """Factor a new operator of the same shape in place (reference ldiv!
        reuse, src/Interfaces.jl:2641-2662)."""
        from scipy.linalg import lu_factor

        self._factors = lu_factor(_dense(gather_psparse(A)))
        return self

    def solve(self, b: PVector) -> PVector:
        from scipy.linalg import lu_solve

        return scatter_pvector_values(lu_solve(self._factors, gather_pvector(b)), self.cols)


def _dense(M: CSRMatrix) -> np.ndarray:
    out = np.zeros(M.shape, dtype=M.dtype)
    np.add.at(out, (M.row_of_nz(), M.indices), M.data)
    return out


def jacobi_preconditioner(A: PSparseMatrix) -> PVector:
    """The inverse diagonal of A as a PVector over ``A.cols``: owned
    entries 1/diag (zero diagonals pass through as 1), ghost entries 0."""
    minv = PVector.full(0.0, A.cols, dtype=A.dtype)

    def per_part(iset, M, mv):
        # the native diagonal scan (solvers.py:1032 of the JAX package)
        d = native.csr_diag(M.indptr, M.indices, M.data, iset.num_oids)
        if d is None:
            d = np.zeros(iset.num_oids, dtype=M.data.dtype)
            r = M.row_of_nz()
            hits = np.nonzero((M.indices == r) & (r < iset.num_oids))[0]
            d[r[hits]] = M.data[hits]
        _write_owned(iset, mv, 1.0 / np.where(d == 0, 1.0, d))

    # diagonal entries sit at col == row < num_oids, so the full local CSR
    # answers directly where it has no ghost rows, and the owned/ghost
    # block split (a second copy of the operator) is not forced
    no_ghost_rows = all(m.shape[0] == i.num_oids for m, i in zip(A.values.part_values(), A.rows.partition.part_values()))
    map_parts(per_part, A.cols.partition, A.values if no_ghost_rows else A.owned_owned_values, minv.values)
    return minv


def decouple_dirichlet(A: PSparseMatrix, b: Optional[PVector] = None):
    """Symmetrize a Dirichlet-identity system without changing its
    solution (solvers.py:1345 of the JAX package): every coupling A[i, j]
    into a diagonal-only row j is zeroed (values only: the sparsity
    pattern is kept, so lowerings and exchangers stay valid) and, with
    ``b``, the boundary values g_j = b_j / A_jj fold into the right-hand
    side: b̂_i = b_i − Σ_j A[i, j]·g_j. Returns Â, or (Â, b̂) with ``b``."""
    if b is not None:
        check(oids_are_equal(b.rows, A.rows), "decouple_dirichlet: b must live on A's row range")
    # pass 1: flag = 1 at owned diagonal-only rows (nonzero diagonal, no
    # off-diagonal values), g = b/diag there; both exchanged so each part
    # sees its ghost columns' values
    flag = PVector.full(0.0, A.cols, dtype=A.dtype)
    g = PVector.full(0.0, A.cols, dtype=A.dtype)

    def _classify(ci, M, fv, gv, *b_args):
        r = M.row_of_nz()
        diag = np.zeros(M.shape[0], dtype=M.data.dtype)
        offsum = np.zeros(M.shape[0], dtype=M.data.dtype)
        on = M.indices == r
        np.add.at(diag, r[on], M.data[on])
        np.add.at(offsum, r[~on], np.abs(M.data[~on]))
        no = ci.num_oids
        only = ((offsum == 0) & (diag != 0))[:no]
        _write_owned(ci, fv, only.astype(M.data.dtype))
        if b_args:
            bi, bvals = b_args
            safe = np.where(diag[:no] == 0, 1.0, diag[:no])
            _write_owned(ci, gv, np.where(only, _owned(bi, np.asarray(bvals)) / safe, 0.0))

    b_args = () if b is None else (b.rows.partition, b.values)
    map_parts(_classify, A.cols.partition, A.values, flag.values, g.values, *b_args)
    if b is not None:
        g.exchange()
    flag.exchange()

    # pass 2: one kill mask per part drives the value strip and the lift
    b_hat = None if b is None else PVector.full(0.0, b.rows, dtype=b.dtype)

    def _strip_and_lift(M, fv, *b_args):
        r = M.row_of_nz()
        kill = (np.asarray(fv)[M.indices] != 0) & (M.indices != r)
        if b_args:
            gv, bi, bvals, bhv = b_args
            corr = np.zeros(M.shape[0], dtype=M.data.dtype)
            np.add.at(corr, r[kill], M.data[kill] * np.asarray(gv)[M.indices[kill]])
            _write_owned(bi, bhv, _owned(bi, np.asarray(bvals)) - corr[: bi.num_oids])
        return CSRMatrix(M.indptr, M.indices, np.where(kill, 0.0, M.data).astype(M.data.dtype), M.shape)

    if b is None:
        return PSparseMatrix(map_parts(_strip_and_lift, A.values, flag.values), A.rows, A.cols)
    values = map_parts(
        _strip_and_lift, A.values, flag.values, g.values, b.rows.partition, b.values,
        b_hat.values,
    )
    return PSparseMatrix(values, A.rows, A.cols), b_hat


def pcg(
    A: PSparseMatrix,
    b: Optional[PVector] = None,
    x0: Optional[PVector] = None,
    minv=None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    verbose: bool = False,
    box: bool = True,
    stencil: bool = True,
    fused: Optional[bool] = None,
    B=None,
    X0=None,
    column_errors: str = "raise",
    strict: bool = False,
    lowering: str = "auto",
    health: bool = True,
    stagnation=None,
    sdc=None,
    checkpoint=None,
    _resume_state: Optional[dict] = None,
    trace_iters: int = 0,
) -> Tuple[PVector, dict]:
    """Preconditioned CG. ``minv`` is an inverse-diagonal PVector over
    A.cols (default `jacobi_preconditioner(A)`) or a callable
    ``minv(r) -> z``, such as a `GMGHierarchy` (one V-cycle). On the GPU
    backend a diagonal ``minv`` runs Jacobi PCG in the device loop
    (`gpu_cg(minv=)`, solvers.py:1533-1538: the fused body by default, the
    standard one with ``fused=False``), and a `GMGHierarchy` built on this
    `A` runs as the device GMG-PCG (`gpu_gmg_pcg`, solvers.py:1511-1532) on
    the routes ``box`` and ``stencil`` select (`parallel/gpu_gmg.py`; an
    explicit ``fused`` there raises: that loop has one body). Any other
    callable, and every preconditioner on the host backend, runs the host
    loop below, which the device loops follow step for step.

    ``B``/``X0`` select the multi-RHS block solve as in `cg`
    (solvers.py:1476-1510): with a diagonal ``minv`` on the GPU backend one
    device loop for the block (`gpu_block_cg`), the shared preconditioner
    applied per column; a callable ``minv`` (a `GMGHierarchy` included)
    solves the columns in sequence, each through its solo path.

    ``strict`` and ``lowering`` as in `cg`. With a `GMGHierarchy` on the
    GPU backend, ``strict`` runs the strict device GMG-PCG (every level's
    operator and transfer on the ELL lowering and the generic plan, E3's
    dots: tpu_gmg.py:886 under ``PA_TPU_STRICT_BITS=1``), which takes the
    sequential strict loop's iterations and agrees with it to rounding (the
    V-cycle's products are not the host's, on either side); ``lowering``
    there names the first non-band lowering of every level's operators
    (`gpu_gmg.device_hierarchy`), as the JAX package's lowering switches
    reach every staging of its GMG-PCG.

    ``health``, ``stagnation``, ``sdc`` and ``checkpoint`` as in `cg`
    (solvers.py:1556-1674): the device Jacobi PCG runs the in-graph defense;
    the device GMG-PCG has no defended form and refuses an active ``sdc``.
    ``trace_iters`` as in `cg` (the device Jacobi PCG and block PCG)."""
    from ..parallel.gpu import GPUBackend, gpu_block_cg, gpu_cg
    from ..utils.health import resolve_sdc
    from .gmg import GMGHierarchy

    sdc = resolve_sdc(sdc)
    if minv is None:
        minv = jacobi_preconditioner(A)
    if B is not None:
        B = _check_block_args("pcg", b, x0, B, column_errors, checkpoint, _resume_state)
        if isinstance(B[0].values.backend, GPUBackend) and not callable(minv):
            return gpu_block_cg(A, B, X0=X0, tol=tol, maxiter=maxiter, verbose=verbose, minv=minv,
                                fused=fused, column_errors=column_errors, box=box, strict=strict,
                                lowering=lowering, sdc=sdc, trace_iters=trace_iters)
        return _host_block_solve(
            lambda bk, x0k: pcg(A, bk, x0=x0k, minv=minv, tol=tol, maxiter=maxiter, verbose=verbose,
                                box=box, stencil=stencil, fused=fused, strict=strict, lowering=lowering,
                                health=health, stagnation=stagnation, sdc=sdc),
            B, X0, column_errors=column_errors,
        )
    check(b is not None, "pcg: a right-hand side b (or a block B) is required")
    if isinstance(b.values.backend, GPUBackend):
        if checkpoint is not None or _resume_state is not None:
            raise ValueError(
                "pcg: per-iteration checkpointing is a host-loop feature; use "
                "models.solvers.solve_with_recovery on the device path"
            )
        if isinstance(minv, GMGHierarchy):
            from ..parallel.gpu_gmg import gpu_gmg_pcg

            if sdc is not None:
                raise ValueError("pcg: the device GMG-PCG has no SDC-defended form; the defense covers CG "
                                 "and Jacobi PCG (drop sdc, or solve on the host backend)")
            if fused is not None:
                raise ValueError(
                    "pcg: the GMG-preconditioned device loop has one PCG body, with no fused "
                    "variant; drop the fused argument for GMG preconditioning"
                )
            check(minv.levels[0].A is A, "pcg: the hierarchy's fine operator must be A itself")
            return gpu_gmg_pcg(minv, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose,
                               box=box, stencil=stencil, strict=strict, lowering=lowering)
        if not callable(minv):
            return gpu_cg(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose, fused=fused,
                          box=box, minv=minv, strict=strict, lowering=lowering, health=health, sdc=sdc,
                          trace_iters=trace_iters)
    from .. import telemetry

    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    with telemetry.solve_scope("pcg", backend="host", tol=float(tol), maxiter=int(maxiter),
                               resumed=_resume_state is not None,
                               preconditioner="callable" if callable(minv) else "diagonal") as rec:
        with _abft_scope(sdc, health):
            x, info = _pcg_host_loop(A, b, x0, minv, tol, maxiter, verbose, strict, health, stagnation, sdc,
                                     checkpoint, _resume_state)
        telemetry.observe_solve(A, rec, info=info, dtype=b.dtype, minv=minv)
        return x, rec.finish(info)


def _pcg_host_loop(A, b, x0, minv, tol, maxiter, verbose, strict=False, health=True, stagnation=None, sdc=None,
                   checkpoint=None, _resume_state=None):
    """The host PCG recurrence (solvers.py:1556-1674), with the guards of
    `_cg_host_loop`; ``strict`` as in `cg`."""
    from ..utils.health import (
        SilentCorruptionError, SolverBreakdownError, StagnationDetector, check_finite_scalar,
    )

    floor_warned = warn_tol_below_floor(tol, b.dtype, name="pcg")
    z = PVector.full(0.0, A.cols, dtype=b.dtype)

    def _apply_precond():
        if callable(minv):
            _owned_assign(z, minv(r))
        else:
            _owned_zip(z, lambda _z, mv, rv: mv * rv, minv, r)

    if _resume_state is not None:
        x, r, p = _resume_state["x"], _resume_state["r"], _resume_state["p"]
        meta = _resume_state["meta"]
        rs, rz, rs0 = meta["rs"], meta["rz"], meta["rs0"]
        it = int(meta["it"])
        history = [np.float64(h) for h in meta["history"]]
    else:
        x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
        r = b.copy()
        q = _matvec(A, x, strict)
        _owned_update(r, lambda rv, qv: rv - qv, q)
        _apply_precond()
        p = PVector.full(0.0, A.cols, dtype=b.dtype)
        _owned_assign(p, z)
        rs = r.dot(r, strict=strict)
        rz = r.dot(z, strict=strict)
        rs0 = rs
        history = [np.sqrt(rs)]
        it = 0
    if health and _resume_state is None:
        check_finite_scalar(rs, "pcg", it=0, vectors=(("r", r), ("x", x)))
    stag = StagnationDetector.from_option("pcg", stagnation) if health else None
    guard = _SDCGuard("pcg", lambda v: _matvec(A, v, strict), b, rs0, health, sdc)
    guard.push({"x": x, "r": r, "p": p}, {"rs": rs, "rz": rz, "it": it}, history)
    it0, ab_alpha, ab_beta = it, [], []
    while np.sqrt(rs) > tol * max(1.0, np.sqrt(rs0)) and it < maxiter:
        try:
            q = _matvec(A, p, strict)
            pq = p.dot(q, strict=strict)
            if pq == 0.0:
                raise SolverBreakdownError("pcg: breakdown, p'Ap == 0",
                                           diagnostics={"iteration": it, "rs": float(rs)})
            alpha = rz / pq
            _owned_update(x, lambda xv, pv: xv + alpha * pv, p)
            _owned_update(r, lambda rv, qv: rv - alpha * qv, q)
            _apply_precond()
            rz_new = r.dot(z, strict=strict)
            rs = r.dot(r, strict=strict)
            if health:
                check_finite_scalar(rs, "pcg", it=it + 1, vectors=(("r", r), ("z", z), ("x", x)))
            beta = rz_new / rz
            _owned_update(p, lambda pv, zv: zv + beta * pv, z)
            rz = rz_new
            history.append(np.sqrt(rs))
            it += 1
            ab_alpha.append(float(alpha))
            ab_beta.append(float(beta))
            guard.audit(x, r, it, {"rs": rs, "rz": rz, "it": it}, {"p": p}, history)
        except SilentCorruptionError as e:
            vecs, meta_r, history = guard.rollback(e, it)
            x, r, p = vecs["x"], vecs["r"], vecs["p"]
            rs, rz, it = meta_r["rs"], meta_r["rz"], meta_r["it"]
            del ab_alpha[max(0, it - it0):], ab_beta[max(0, it - it0):]
            continue
        if stag is not None:
            stag.update(float(np.sqrt(rs)), it)
        if checkpoint is not None and checkpoint.due(it):
            checkpoint.save_state(
                {"x": x, "r": r, "p": p},
                {"method": "pcg", "it": it, "rs": rs, "rz": rz, "rs0": rs0, "tol": tol, "maxiter": maxiter,
                 "history": history},
            )
        if verbose:
            print(f"pcg it={it} residual={np.sqrt(rs):.3e}")
    if checkpoint is not None:
        checkpoint.wait()
    _attach_host_ab(ab_alpha, ab_beta, it0)
    return x, krylov_info(
        it, history, np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)),
        tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(
            A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
            force=floor_warned,
        ),
        **guard.info_extra(),
    )


# ---------------------------------------------------------------------------
# the rest of the Krylov family (solvers.py:540-922, :1677-2152)
# ---------------------------------------------------------------------------


def gershgorin_bounds(A: PSparseMatrix) -> Tuple[float, float]:
    """Gershgorin spectral interval (solvers.py:540-570): every eigenvalue
    lies in [min_i (a_ii - R_i), max_i (a_ii + R_i)] with R_i the
    off-diagonal absolute row sum, over owned rows and reduced across
    parts. The lower bound is typically <= 0 for Laplacian-like operators,
    so it is an ``lmax`` source for `chebyshev_solve`, not an ``lmin``
    source."""
    from ..parallel.collectives import preduce

    def _bounds(ri, ci, M):
        lo, hi = np.inf, -np.inf
        val = M.data
        diag = np.zeros(M.shape[0], dtype=val.dtype)
        radius = np.zeros(M.shape[0], dtype=val.dtype)
        r = M.row_of_nz()
        row_gid = np.asarray(ri.lid_to_gid)[r] if len(r) else r
        col_gid = np.asarray(ci.lid_to_gid)[M.indices] if M.nnz else r
        on_diag = row_gid == col_gid
        np.add.at(diag, r[on_diag], val[on_diag])
        np.add.at(radius, r[~on_diag], np.abs(val[~on_diag]))
        own = np.asarray(ri.lid_to_part) == ri.part
        if own.any():
            lo = float((diag - radius)[own].min())
            hi = float((diag + radius)[own].max())
        return lo, hi

    per = map_parts(_bounds, A.rows.partition, A.cols.partition, A.values)
    lo = preduce(min, map_parts(lambda t: t[0], per), init=np.inf)
    hi = preduce(max, map_parts(lambda t: t[1], per), init=-np.inf)
    return float(lo), float(hi)


def lanczos_bounds(A: PSparseMatrix, iters: int = 30, seed: int = 0,
                   safety: Tuple[float, float] = (0.5, 1.05)) -> Tuple[float, float]:
    """Extremal-eigenvalue estimates of symmetric ``A`` by a k-step Lanczos
    recurrence (solvers.py:573-640): ``(ritz_min * safety[0], ritz_max *
    safety[1])`` for a positive spectrum, the margins pushed outward on
    both ends for negative and indefinite ones. The start vector is seeded
    per part (``seed + part``), as the JAX package seeds it, so both return
    the same bounds on the same partition. A host loop on any backend."""
    check(iters >= 2, "lanczos_bounds needs at least 2 iterations")

    def _rand(iset):
        rng = np.random.default_rng(seed + int(iset.part))
        vals = np.zeros(iset.num_lids)
        return _write_owned(iset, vals, rng.standard_normal(iset.num_oids))

    v = PVector(map_parts(_rand, A.cols.partition), A.cols)
    nrm = v.norm()
    check(nrm > 0, "lanczos_bounds: zero start vector")
    v = v / nrm
    v_old = PVector.full(0.0, A.cols, dtype=v.dtype)
    beta = 0.0
    alphas, betas = [], []
    for _ in range(int(iters)):
        av = A @ v
        alpha = float(v.dot(av))
        alphas.append(alpha)
        bk = beta
        lan = PVector.full(0.0, A.cols, dtype=v.dtype)
        _owned_zip(lan, lambda _l, qv, vv, ov: qv - alpha * vv - bk * ov, av, v, v_old)
        beta = float(lan.norm())
        if beta <= 1e-14 * max(abs(a) for a in alphas):
            break  # invariant subspace: the Ritz values are exact
        betas.append(beta)
        v_old, v = v, lan / beta
    k = len(alphas)
    T = np.diag(np.array(alphas))
    if k > 1:
        off = np.array(betas[: k - 1])
        T += np.diag(off, 1) + np.diag(off, -1)
    ritz = np.linalg.eigvalsh(T)
    spread = max(float(ritz[-1] - ritz[0]), 1e-30)
    r0, r1 = float(ritz[0]), float(ritz[-1])
    # the strong margin (toward zero) goes to the end near zero, the mild
    # outward one to the dominant end(s)
    s0, s1 = float(safety[0]), float(safety[1])
    if r0 > 0.0:
        lo, hi = r0 * s0, r1 * s1
    elif r1 < 0.0:
        lo, hi = r0 * s1, r1 * s0
    else:
        lo = r0 * s1 if r0 != 0.0 else -(s1 - 1.0) * spread
        hi = r1 * s1 if r1 != 0.0 else (s1 - 1.0) * spread
    return float(lo), float(hi)


def chebyshev_solve(A: PSparseMatrix, b: PVector, lmin: float, lmax: float, x0: Optional[PVector] = None,
                    tol: float = 1e-8, maxiter: Optional[int] = None, verbose: bool = False) -> Tuple[PVector, dict]:
    """Chebyshev iteration for SPD ``A`` with its spectrum inside [lmin,
    lmax] (solvers.py:854-922): no inner products in the loop. A
    GPU-backend b runs the device loop (`gpu_krylov.gpu_chebyshev`: one
    residual dot a leg of 16 iterations, the history one entry a leg);
    any other backend the host loop below, which checks the residual every
    iteration."""
    check(lmax > lmin > 0.0, "chebyshev_solve needs 0 < lmin < lmax")
    from ..parallel.gpu import GPUBackend
    from ..parallel.gpu_krylov import gpu_chebyshev

    if isinstance(b.values.backend, GPUBackend):
        return gpu_chebyshev(A, b, lmin, lmax, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    maxiter = maxiter if maxiter is not None else 10 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="chebyshev")
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    r = b.copy()
    q = A @ x
    _owned_update(r, lambda rv, qv: rv - qv, q)
    rs0 = r.dot(r)
    d = PVector.full(0.0, A.cols, dtype=b.dtype)
    _owned_zip(d, lambda _d, rv: rv / theta, r)
    history = [np.sqrt(rs0)]
    it, rs = 0, rs0
    while np.sqrt(rs) > tol * max(1.0, np.sqrt(rs0)) and it < maxiter:
        _owned_update(x, lambda xv, dv: xv + dv, d)
        q = A @ d
        _owned_update(r, lambda rv, qv: rv - qv, q)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        _owned_zip(d, lambda dv, rv: rho_new * rho * dv + (2.0 * rho_new / delta) * rv, r)
        rho = rho_new
        rs = r.dot(r)
        history.append(np.sqrt(rs))
        it += 1
        if verbose:
            print(f"chebyshev it={it} residual={np.sqrt(rs):.3e}")
    return x, krylov_info(
        it, history, np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)), tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
                                  force=floor_warned),
    )


def _arnoldi_column(H, cs, sn, g, j):
    """Rotate the new column j of H by the cycle's rotations, make the new
    rotation zeroing H[j+1, j], and advance g (solvers.py:1767-1784)."""
    for i in range(j):
        t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
        H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
        H[i, j] = t
    rho = np.hypot(H[j, j], H[j + 1, j])
    if rho == 0.0:
        cs[j], sn[j] = 1.0, 0.0
    else:
        cs[j], sn[j] = H[j, j] / rho, H[j + 1, j] / rho
    H[j, j] = rho
    H[j + 1, j] = 0.0
    g[j + 1] = -sn[j] * g[j]
    g[j] = cs[j] * g[j]


def _back_substitute(H, g, j_used):
    y = np.zeros(j_used)
    for i in range(j_used - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1 : j_used] @ y[i + 1 : j_used]) / H[i, i]
    return y


def gmres(A: PSparseMatrix, b: PVector, x0: Optional[PVector] = None, restart: int = 30, tol: float = 1e-8,
          maxiter: Optional[int] = None, minv=None, verbose: bool = False, health: bool = True
          ) -> Tuple[PVector, dict]:
    """Restarted GMRES(m) for general operators (solvers.py:1677-1813):
    Arnoldi with modified Gram-Schmidt on the host, the m+1 basis vectors
    on ``A.cols``. With ``minv`` (an inverse-diagonal PVector over A.cols)
    the iteration is left-preconditioned and the residuals are in the
    preconditioned norm; ``minv`` may also be a callable ``minv(r) -> z``
    (a `GMGHierarchy`), which runs this host loop on any backend. A
    GPU-backend b with no callable runs the device loop
    (`gpu_krylov.gpu_gmres`: CGS2, host and device agree to rounding).
    With ``health`` a non-finite initial residual norm, or Arnoldi norm,
    raises `NonFiniteError` (solvers.py:1733-1766)."""
    from ..parallel.gpu import GPUBackend
    from ..parallel.gpu_krylov import gpu_gmres
    from ..utils.health import check_finite_scalar

    check(restart >= 1, "gmres: restart dimension must be >= 1")
    apply_minv = callable(minv)
    if isinstance(b.values.backend, GPUBackend) and not apply_minv:
        return gpu_gmres(A, b, x0=x0, restart=restart, tol=tol, maxiter=maxiter, minv=minv, verbose=verbose,
                         health=health)
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="gmres")
    m = restart

    def precond(v):
        """owned-region M^{-1} v, in place (identity when minv is None)."""
        if minv is None:
            return v
        if apply_minv:
            _owned_assign(v, minv(v))
        else:
            _owned_update(v, lambda vv, mv: mv * vv, minv)
        return v

    def residual_vec():
        r = PVector.full(0.0, A.cols, dtype=b.dtype)
        q = A @ x
        _owned_zip(r, lambda _r, bv, qv: bv - qv, b, q)
        return precond(r)

    r = residual_vec()
    beta = r.norm()
    if health:
        # a poisoned b/x0 raises, not a silent "converged"
        check_finite_scalar(beta, "gmres", it=0, vectors=(("r", r),))
    rs0 = beta
    history = [beta]
    it = 0
    converged = beta <= tol * max(1.0, rs0)
    while not converged and it < maxiter:
        V = [r / beta if beta > 0 else r.copy()]
        H = np.zeros((m + 1, m), dtype=np.float64)
        cs, sn, g = np.zeros(m), np.zeros(m), np.zeros(m + 1)
        g[0] = beta
        j_used = 0
        for j in range(m):
            if it >= maxiter:
                break
            w = precond(A @ V[j])
            for i in range(j + 1):  # modified Gram-Schmidt, fixed order
                hij = w.dot(V[i])
                H[i, j] = hij
                _owned_update(w, lambda wv, vv: wv - hij * vv, V[i])
            hj1 = w.norm()
            if health:
                # free: the norm was reduced anyway
                check_finite_scalar(hj1, "gmres", it=it + 1, vectors=(("w", w),))
            H[j + 1, j] = hj1
            _arnoldi_column(H, cs, sn, g, j)
            it += 1
            j_used = j + 1
            res = abs(g[j + 1])
            history.append(res)
            if verbose:
                print(f"gmres it={it} residual={res:.3e}")
            if res <= tol * max(1.0, rs0) or hj1 == 0.0:
                # convergence is declared from the true residual after the x
                # update, as the device loop does
                break
            vn = PVector.full(0.0, A.cols, dtype=b.dtype)
            _owned_zip(vn, lambda _v, wv: wv / hj1, w)
            V.append(vn)
        if j_used:
            y = _back_substitute(H, g, j_used)
            for i in range(j_used):
                yi = y[i]
                _owned_update(x, lambda xv, vv: xv + yi * vv, V[i])
        r = residual_vec()
        beta = r.norm()
        converged = beta <= tol * max(1.0, rs0)
    return x, krylov_info(it, history, converged, tol, b.dtype, floor_warned, final_rel=beta / max(1.0, rs0))


def fgmres(A: PSparseMatrix, b: PVector, x0: Optional[PVector] = None, restart: int = 30, tol: float = 1e-8,
           maxiter: Optional[int] = None, minv=None, verbose: bool = False) -> Tuple[PVector, dict]:
    """Flexible restarted GMRES (solvers.py:1816-1936): right-preconditioned
    Arnoldi keeping the preconditioned basis Z beside V, so ``minv`` may
    change from one application to the next (an inner iterative solve, a
    V-cycle). ``minv`` is a callable, an inverse-diagonal PVector over
    A.cols, or None (GMRES with M = I, its history the true residual). A
    host loop on every backend, as the JAX package runs it; the device form
    with a `GMGHierarchy` is `gpu_gmg.gpu_fgmres_gmg`."""
    check(restart >= 1, "fgmres: restart dimension must be >= 1")
    apply_minv = callable(minv)
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="fgmres")
    m = restart

    def precond(v):
        """z = M^{-1} v as a fresh vector on A.cols (v stays in the basis)."""
        z = PVector.full(0.0, A.cols, dtype=b.dtype)
        if minv is None:
            _owned_assign(z, v)
        elif apply_minv:
            _owned_assign(z, minv(v))
        else:
            _owned_zip(z, lambda _z, vv, mv: mv * vv, v, minv)
        return z

    def residual_vec():
        # the true residual: right preconditioning never touches the norm
        r = PVector.full(0.0, A.cols, dtype=b.dtype)
        q = A @ x
        _owned_zip(r, lambda _r, bv, qv: bv - qv, b, q)
        return r

    r = residual_vec()
    beta = r.norm()
    rs0 = beta
    history = [beta]
    it = 0
    converged = beta <= tol * max(1.0, rs0)
    while not converged and it < maxiter:
        V = [r / beta if beta > 0 else r.copy()]
        Z = []
        H = np.zeros((m + 1, m), dtype=np.float64)
        cs, sn, g = np.zeros(m), np.zeros(m), np.zeros(m + 1)
        g[0] = beta
        j_used = 0
        for j in range(m):
            if it >= maxiter:
                break
            Z.append(precond(V[j]))
            w = A @ Z[j]
            for i in range(j + 1):  # modified Gram-Schmidt, fixed order
                hij = w.dot(V[i])
                H[i, j] = hij
                _owned_update(w, lambda wv, vv: wv - hij * vv, V[i])
            hj1 = w.norm()
            H[j + 1, j] = hj1
            _arnoldi_column(H, cs, sn, g, j)
            it += 1
            j_used = j + 1
            res = abs(g[j + 1])
            history.append(res)
            if verbose:
                print(f"fgmres it={it} residual={res:.3e}")
            if res <= tol * max(1.0, rs0) or hj1 == 0.0:
                break
            vn = PVector.full(0.0, A.cols, dtype=b.dtype)
            _owned_zip(vn, lambda _v, wv: wv / hj1, w)
            V.append(vn)
        if j_used:
            y = _back_substitute(H, g, j_used)
            for i in range(j_used):
                yi = y[i]
                # the update rides the preconditioned basis Z: the flexible part
                _owned_update(x, lambda xv, zv: xv + yi * zv, Z[i])
        r = residual_vec()
        beta = r.norm()
        converged = beta <= tol * max(1.0, rs0)
    return x, krylov_info(it, history, converged, tol, b.dtype, floor_warned, final_rel=beta / max(1.0, rs0))


def minres(A: PSparseMatrix, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8,
           maxiter: Optional[int] = None, verbose: bool = False) -> Tuple[PVector, dict]:
    """MINRES (Paige-Saunders) for symmetric, possibly indefinite, operators
    (solvers.py:1939-2041): the three-term Lanczos recurrence and one Givens
    rotation a step, constant memory. A GPU-backend b runs the device loop
    (`gpu_krylov.gpu_minres`), which follows this update sequence."""
    from ..parallel.gpu import GPUBackend
    from ..parallel.gpu_krylov import gpu_minres

    if isinstance(b.values.backend, GPUBackend):
        return gpu_minres(A, b, x0=x0, tol=tol, maxiter=maxiter, verbose=verbose)
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="minres")
    r = PVector.full(0.0, A.cols, dtype=b.dtype)
    q0 = A @ x
    _owned_zip(r, lambda _r, bv, qv: bv - qv, b, q0)
    beta = r.norm()
    rs0 = beta
    history = [beta]
    if beta == 0.0:
        return x, krylov_info(0, history, True, tol, b.dtype, floor_warned, final_rel=0.0)
    v = r / beta
    v_old = PVector.full(0.0, A.cols, dtype=b.dtype)
    w = PVector.full(0.0, A.cols, dtype=b.dtype)
    w_old = PVector.full(0.0, A.cols, dtype=b.dtype)
    c_old, s_old = 1.0, 0.0
    c, s = 1.0, 0.0
    eta = beta
    beta_k = 0.0  # the sub/superdiagonal entry of the current column: 0 at k = 1
    it = 0
    res = beta
    while res > tol * max(1.0, rs0) and it < maxiter:
        av = A @ v
        alpha = v.dot(av)
        _owned_zip(av, lambda qv, vv, ov: qv - alpha * vv - beta_k * ov, v, v_old)
        beta_new = av.norm()
        delta = c * alpha - c_old * s * beta_k
        gamma2 = s * alpha + c_old * c * beta_k
        gamma3 = s_old * beta_k
        rho = np.hypot(delta, beta_new)
        if rho == 0.0:
            break  # hard breakdown: converged=False, as the device loop ends
        c_old, s_old = c, s
        c, s = delta / rho, beta_new / rho
        g2, g3, rr = gamma2, gamma3, rho
        w, w_old = w_old, w
        _owned_zip(w, lambda w2ago, vv, wprev: (vv - g2 * wprev - g3 * w2ago) / rr, v, w_old)
        step = c * eta
        _owned_update(x, lambda xv, wv: xv + step * wv, w)
        eta = -s * eta
        vn = PVector.full(0.0, A.cols, dtype=b.dtype)
        s_beta = beta_new if beta_new > 0 else 1.0
        _owned_zip(vn, lambda _v, qv: qv / s_beta, av)
        v_old, v = v, vn
        beta_k = beta_new
        res = abs(eta)
        history.append(res)
        it += 1
        if verbose:
            print(f"minres it={it} residual={res:.3e}")
        if beta_new == 0.0:  # invariant subspace: the exact solve is reached
            break
    return x, krylov_info(
        it, history, res <= tol * max(1.0, rs0), tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(A, x, b, res / max(1.0, rs0), rs0, tol, force=floor_warned),
    )


def bicgstab(A: PSparseMatrix, b: PVector, x0: Optional[PVector] = None, tol: float = 1e-8,
             maxiter: Optional[int] = None, minv=None, verbose: bool = False) -> Tuple[PVector, dict]:
    """BiCGStab for general (nonsymmetric) operators (solvers.py:2044-2152):
    two SpMVs an iteration, breakdown ends it with ``converged=False``.
    ``minv`` right-preconditions it (its residuals stay the true ones): an
    inverse-diagonal PVector over A.cols, or a callable ``minv(v) -> z``,
    which runs this host loop on any backend. A GPU-backend b with no
    callable runs the device loop (`gpu_krylov.gpu_bicgstab`)."""
    from ..parallel.gpu import GPUBackend
    from ..parallel.gpu_krylov import gpu_bicgstab

    apply_minv = callable(minv)
    if isinstance(b.values.backend, GPUBackend) and not apply_minv:
        return gpu_bicgstab(A, b, x0=x0, tol=tol, maxiter=maxiter, minv=minv, verbose=verbose)

    def precond(v):
        """K^-1 v as a fresh vector on A.cols; the identity returns v itself."""
        if minv is None:
            return v
        z = PVector.full(0.0, A.cols, dtype=b.dtype)
        if apply_minv:
            _owned_assign(z, minv(v))
        else:
            _owned_zip(z, lambda _z, mv, vv: mv * vv, minv, v)
        return z

    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    floor_warned = warn_tol_below_floor(tol, b.dtype, name="bicgstab")
    r = b.copy()
    q = A @ x
    _owned_update(r, lambda rv, qv: rv - qv, q)
    rhat = PVector.full(0.0, A.cols, dtype=b.dtype)
    _owned_assign(rhat, r)
    rcol = PVector.full(0.0, A.cols, dtype=b.dtype)
    _owned_assign(rcol, r)
    r = rcol  # the residual on A.cols, so every vector shares one range
    v = PVector.full(0.0, A.cols, dtype=b.dtype)
    p = PVector.full(0.0, A.cols, dtype=b.dtype)
    s = PVector.full(0.0, A.cols, dtype=b.dtype)
    rho = alpha = omega = 1.0
    rs = r.dot(r)
    rs0 = rs
    history = [np.sqrt(rs)]
    it = 0
    while np.sqrt(rs) > tol * max(1.0, np.sqrt(rs0)) and it < maxiter:
        rho_new = rhat.dot(r)
        if rho_new == 0.0 or omega == 0.0:
            break
        beta = (rho_new / rho) * (alpha / omega)
        ww = omega
        _owned_zip(p, lambda pv, rv, vv: rv + beta * (pv - ww * vv), r, v)
        phat = precond(p)  # right preconditioning: v = A K^-1 p
        v = A @ phat
        rv_ = rhat.dot(v)
        if rv_ == 0.0:
            break
        alpha = rho_new / rv_
        _owned_zip(s, lambda _s, rv, vv: rv - alpha * vv, r, v)
        shat = precond(s)
        t = A @ shat
        tt = t.dot(t)
        omega = 0.0 if tt == 0.0 else t.dot(s) / tt
        aa, oo_ = alpha, omega
        # the solution update rides the preconditioned directions
        _owned_zip(x, lambda xv, pv, sv: xv + aa * pv + oo_ * sv, phat, shat)
        _owned_zip(r, lambda _r, sv, tv: sv - oo_ * tv, s, t)
        rho = rho_new
        rs = r.dot(r)
        history.append(np.sqrt(rs))
        it += 1
        if verbose:
            print(f"bicgstab it={it} residual={np.sqrt(rs):.3e}")
    return x, krylov_info(
        it, history, np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)), tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
                                  force=floor_warned),
    )


# ---------------------------------------------------------------------------
# LOBPCG (solvers.py:646-853)
# ---------------------------------------------------------------------------


def lobpcg(A: PSparseMatrix, nev: int = 1, X0=None, minv=None, tol: float = 1e-6, maxiter: int = 200,
           largest: bool = False, seed: int = 0, verbose: bool = False):
    """Locally optimal block preconditioned CG: the ``nev`` smallest (or
    largest) eigenpairs of symmetric ``A`` (solvers.py:646-853). ``minv``
    is None, an inverse-diagonal PVector or any callable ``minv(r) -> z``
    (a `GMGHierarchy`, `additive_schwarz(mode='asm')`, ...). Returns
    ``(eigenvalues (nev,), eigenvectors: list of PVector, info)``. On the
    GPU backend a diagonal, a `GMGHierarchy` or no preconditioner runs the
    device loop (`parallel/gpu_lobpcg.py:gpu_lobpcg`, solvers.py:679-692);
    other callables run the host loop below on any backend. The two
    stabilise the basis differently (dropping near-dependent directions
    here, a masked penalty there), so they agree on eigenpairs, not on
    iteration counts."""
    from ..parallel.collectives import preduce
    from ..parallel.gpu import GPUBackend
    from .gmg import GMGHierarchy

    check(nev >= 1, "lobpcg: nev must be >= 1")
    m = int(nev)
    if isinstance(A.values.backend, GPUBackend) and (not callable(minv) or isinstance(minv, GMGHierarchy)):
        from ..parallel.gpu_lobpcg import gpu_lobpcg

        return gpu_lobpcg(A, nev=m, X0=X0, minv=minv, tol=tol, maxiter=maxiter, largest=largest, seed=seed,
                          verbose=verbose)

    def _rand_block():
        out = []
        for k in range(m):
            def _rand(iset, k=k):
                rng = np.random.default_rng(seed + 7919 * k + int(iset.part))
                return _write_owned(iset, np.zeros(iset.num_lids), rng.standard_normal(iset.num_oids))

            out.append(PVector(map_parts(_rand, A.cols.partition), A.cols))
        return out

    X = [v.copy() for v in X0] if X0 is not None else _rand_block()
    check(len(X) == m, "lobpcg: X0 must hold nev vectors")

    def _apply_m(r):
        if minv is None:
            return r.copy()
        if callable(minv):
            return minv(r)
        z = PVector.full(0.0, A.cols, dtype=r.dtype)
        _owned_zip(z, lambda _z, mv, rv: mv * rv, minv, r)
        return z

    def _gram(U, V):
        # one part-ordered reduce per Gram product: each part's whole
        # owned-block partial U_p V_pᵀ, folded in part order
        ku, kv = len(U), len(V)
        if ku == 0 or kv == 0:
            return np.zeros((ku, kv))
        args = []
        for w in (*U, *V):
            args += [w.rows.partition, w.values]

        def _partial(*vals):
            Uo = np.stack([_owned(vals[2 * i], np.asarray(vals[2 * i + 1])) for i in range(ku)])
            Vo = np.stack([_owned(vals[2 * (ku + i)], np.asarray(vals[2 * (ku + i) + 1])) for i in range(kv)])
            return Uo @ Vo.T

        import operator

        return preduce(operator.add, map_parts(_partial, *args), np.zeros((ku, kv)))

    def _combine(blocks, C):
        out = []
        for j in range(C.shape[1]):
            w = PVector.full(0.0, A.cols, dtype=X[0].dtype)
            for c, v in zip(C[:, j], blocks):
                if c != 0.0:
                    cc = float(c)
                    _owned_update(w, lambda wv, vv: wv + cc * vv, v)
            out.append(w)
        return out

    def _orthonormalize(U):
        w, Q = np.linalg.eigh(_gram(U, U))
        keep = w > w[-1] * 1e-12
        return _combine(U, Q[:, keep] / np.sqrt(w[keep]))

    def _unit(vs):
        out = []
        for v in vs:
            n = float(v.norm())
            if n > 0:
                out.append(v / n)
        return out

    X = _orthonormalize(X)
    P: list = []
    sgn = -1.0 if largest else 1.0
    history = []
    it = 0
    lam = np.zeros(m)
    converged = False
    AX = None
    while it < maxiter:
        if AX is None:
            AX = [A @ x for x in X]
        lam = np.array([float(x.dot(ax)) for x, ax in zip(X, AX)])
        R = []
        for x, ax, l in zip(X, AX, lam):
            r = PVector.full(0.0, A.cols, dtype=x.dtype)
            ll = float(l)
            _owned_zip(r, lambda _r, av, xv: av - ll * xv, ax, x)
            R.append(r)
        rnorms = np.array([float(r.norm()) for r in R])
        history.append(rnorms.copy())
        if verbose:
            print(f"lobpcg it={it} max|r|={rnorms.max():.3e}")
        if np.all(rnorms <= tol * np.maximum(1.0, np.abs(lam))):
            converged = True
            break
        # unit search directions: near convergence W and P are tiny, and
        # unscaled they fall below the whitening's drop threshold
        W = _unit([_apply_m(r) for r in R])
        P = _unit(P)
        S = X + W + P
        AS = AX + [A @ v for v in S[m:]]
        G_a, G_m = _gram(S, AS), _gram(S, S)
        w_m, Q_m = np.linalg.eigh(G_m)
        keep = w_m > w_m[-1] * 1e-10
        B = Q_m[:, keep] / np.sqrt(w_m[keep])
        _, Q_r = np.linalg.eigh(sgn * (B.T @ G_a @ B))
        C = B @ Q_r[:, :m]
        X_new = _combine(S, C)
        C_p = C.copy()
        C_p[:m, :] = 0.0
        P = _combine(S, C_p)
        X = X_new
        AX = _combine(AS, C)  # the A-images combine with the same coefficients
        it += 1
    if not converged:
        AX = [A @ x for x in X]
        lam = np.array([float(x.dot(ax)) for x, ax in zip(X, AX)])
    order = np.argsort(sgn * lam)
    return lam[order], [X[int(k)] for k in order], {
        "iterations": it, "residual_norms": np.array(history), "converged": converged,
    }


# ---------------------------------------------------------------------------
# direct and incomplete-factorisation preconditioners (solvers.py:974-1006,
# :1069-1344)
# ---------------------------------------------------------------------------


def lu(A: PSparseMatrix) -> PLU:
    """The centralised LU factorisation of A (reference lu: src/Interfaces.jl:2641-2662)."""
    return PLU(A)


def direct_solve(A: PSparseMatrix, b: PVector) -> PVector:
    """The ``\\`` analog (solvers.py:997-1006): gather A and b on MAIN, dense
    solve, scatter back over A.cols. Debug-scale only."""
    return scatter_pvector_values(np.linalg.solve(_dense(gather_psparse(A)), gather_pvector(b)), A.cols)


def _spilu_factor(M: CSRMatrix, drop_tol, fill_factor):
    """Threshold ILU of one local CSR block (SciPy ``spilu``), None for an
    empty block (solvers.py:1046-1066)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import spilu

    if M.shape[0] == 0:
        return None
    check(M.nnz > 0, "spilu: a part's block is structurally zero; the preconditioner would silently map its "
                     "residual to zero")
    kw = {"fill_factor": fill_factor}
    if drop_tol is not None:
        kw["drop_tol"] = drop_tol
    return spilu(csr_matrix((M.data, M.indices, M.indptr), shape=M.shape).tocsc(), **kw)


def _per_part_apply(A: PSparseMatrix, factors):
    """``minv(r)``: each part's factor solves its owned block of r, no
    communication; a part without a factor (no rows) leaves z at 0."""
    from ..parallel.backends import get_part_ids

    parts = get_part_ids(A.values)

    def apply(r: PVector) -> PVector:
        z = PVector.full(0.0, A.cols, dtype=r.dtype)

        def per_part(p, zi, zv, ri_, rv):
            f = factors[int(p)]
            if f is not None:
                _write_owned(zi, zv, f.solve(_owned(ri_, np.asarray(rv))))

        map_parts(per_part, parts, z.rows.partition, z.values, r.rows.partition, r.values)
        return z

    return apply


def block_jacobi_ilu(A: PSparseMatrix, drop_tol=None, fill_factor=10):
    """Non-overlapping block-Jacobi preconditioner with a threshold ILU
    (SciPy ``spilu``) of each part's owned-owned block (solvers.py:1069-1131):
    z = M⁻¹ r solves each part's block locally, with no communication.
    Returns a callable for ``minv=``; the factorisations happen once, on
    the host. An LU-based M⁻¹ is only approximately symmetric, so CG's
    conjugacy holds approximately (`block_jacobi_ic0` is the symmetric
    companion)."""
    return _per_part_apply(A, [_spilu_factor(M, drop_tol, fill_factor) for M in A.owned_owned_values.part_values()])


def ic0_lower(indptr, cols, a_vals, n: int):
    """Zero-fill incomplete Cholesky of a lower triangle (diagonal last in
    each row, columns sorted): ``(l_vals, -1)``, or ``(None, i)`` on a
    non-positive pivot at row i: the native factorisation (planning.cpp
    `pa_ic0_f64`, solvers.py:1145 of the JAX package), or with
    `native.ENABLED` off its plain version, the port's copy of the JAX
    package's NumPy form (native/__init__.py:882-925)."""
    if native.available():
        return native.ic0(indptr, cols, a_vals, n)
    ip = np.asarray(indptr, dtype=np.int64)
    cc = np.asarray(cols, dtype=np.int64)
    av = np.asarray(a_vals, dtype=np.float64)
    lv = np.empty_like(av)
    for i in range(n):
        s_i, e_i = ip[i], ip[i + 1]
        if e_i == s_i or cc[e_i - 1] != i:
            return None, i
        for idx in range(s_i, e_i):
            j = cc[idx]
            s = av[idx]
            pi, pj, ej = s_i, ip[j], ip[j + 1]
            while pi < idx and pj < ej - 1:
                ci, cj = cc[pi], cc[pj]
                if ci == cj:
                    if ci >= j:
                        break
                    s -= lv[pi] * lv[pj]
                    pi += 1
                    pj += 1
                elif ci < cj:
                    pi += 1
                else:
                    pj += 1
            if j < i:
                lv[idx] = s / lv[ej - 1]
            else:
                if s <= 0.0:
                    return None, i
                lv[idx] = np.sqrt(s)
    return lv, -1


def _ic0_factor(M: CSRMatrix, shift: float = 0.0, auto_shift: bool = True):
    """IC(0) of one local SPD CSR block (solvers.py:1132-1218): an object
    whose ``solve(r)`` applies (L Lᵀ)⁻¹, or None for an empty block. A
    nonsymmetric block, a missing diagonal entry, and a non-positive pivot
    even at the largest diagonal shift raise; with ``auto_shift`` the
    diagonal is scaled by (1 + a) for a in 1e-3, 1e-2, 1e-1, 1 until the
    factorisation exists (Manteuffel's remedy)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import spsolve_triangular

    n = M.shape[0]
    if n == 0:
        return None
    check(M.nnz > 0, "ic0: a part's block is structurally zero; the preconditioner would silently map its "
                     "residual to zero")
    sp = csr_matrix((M.data, M.indices, M.indptr), shape=M.shape)
    asym = abs(sp - sp.T).max() if M.nnz else 0.0
    if asym > 1e-12 * max(abs(sp).max(), 1.0):
        raise ValueError(
            f"ic0: block is not symmetric (max |A - A'| = {asym:.2e}); incomplete Cholesky requires an SPD "
            "block; use block_jacobi_ilu / additive_schwarz(factor='ilu') for nonsymmetric operators"
        )
    r = M.row_of_nz()
    keep = M.indices <= r
    li, lj, lv0 = r[keep], M.indices[keep], M.data[keep].astype(np.float64)
    L0 = compresscoo(li, lj, lv0, n, n)
    last = L0.indices[np.maximum(L0.indptr[1:], 1) - 1]
    row_has = (L0.indptr[1:] > L0.indptr[:-1]) & (last == np.arange(n))
    if not row_has.all():
        raise ValueError(f"ic0: local row {int(np.nonzero(~row_has)[0][0])} has no stored diagonal entry; IC(0) "
                         "needs a full diagonal")
    shifts = [shift]
    if auto_shift:
        shifts += [a for a in (1e-3, 1e-2, 1e-1, 1.0) if a > shift]
    lvals = fail = L = None
    for a in shifts:
        lv = np.where(li == lj, lv0 * (1.0 + a), lv0) if a else lv0
        L = compresscoo(li, lj, lv, n, n)
        lvals, fail = ic0_lower(L.indptr, L.indices, L.data, n)
        if lvals is not None:
            break
    if lvals is None:
        raise np.linalg.LinAlgError(f"ic0: non-positive pivot at local row {fail} even with the maximum diagonal "
                                    "shift; the block is not SPD; use block_jacobi_ilu")
    Lm = csr_matrix((lvals, L.indices, L.indptr), shape=(n, n))
    Lt = Lm.T.tocsr()

    class _IC0:
        def solve(self, rv):
            return spsolve_triangular(Lt, spsolve_triangular(Lm, rv, lower=True), lower=False)

    return _IC0()


def block_jacobi_ic0(A: PSparseMatrix, shift: float = 0.0):
    """Block-Jacobi preconditioner with a zero-fill incomplete Cholesky of
    each part's owned-owned block (solvers.py:1219-1240): the exactly
    symmetric companion of `block_jacobi_ilu` for SPD operators. Returns a
    callable for ``minv=``."""
    return _per_part_apply(A, [_ic0_factor(M, shift) for M in A.owned_owned_values.part_values()])


def additive_schwarz(A: PSparseMatrix, mode: str = "asm", drop_tol=None, fill_factor=10, factor: str = "ilu",
                     shift: float = 0.0):
    """Overlapping Schwarz preconditioner with one layer of overlap
    (solvers.py:1241-1344): each part factors the block over its owned rows
    and the rows of its column-ghost layer, replicated from their owners
    along the ghost graph (`exchange_coo`). An application fills the
    overlap with one halo exchange, solves each extended block locally and
    combines: ``mode='asm'`` assembles the overlap corrections back
    (ghost -> owner add; symmetric for symmetric blocks, for `pcg`),
    ``mode='ras'`` keeps each part's owned slice only (restricted AS:
    nonsymmetric, for `gmres` and `bicgstab`). ``factor='ic0'`` takes the
    extended blocks' IC(0) (``shift`` its Manteuffel knob) instead of the
    ILUT (``drop_tol``, ``fill_factor``). Returns a callable for
    ``minv=``; on every backend it runs the host loops."""
    from ..parallel.backends import get_part_ids
    from ..parallel.prange import add_gids
    from ..parallel.psparse import exchange_coo, psparse_owned_triplets
    from ..parallel.pvector import _assign_full

    check(mode in ("asm", "ras"), "additive_schwarz: mode is 'asm' or 'ras'")
    check(factor in ("ilu", "ic0"), "additive_schwarz: factor is 'ilu' or 'ic0'")
    check(factor == "ilu" or drop_tol is None,
          "additive_schwarz: drop_tol tunes the ILUT blocks; IC(0) is zero-fill by definition (use shift=)")
    check(factor == "ic0" or shift == 0.0,
          "additive_schwarz: shift is the IC(0) Manteuffel knob; the ILUT blocks take drop_tol/fill_factor")
    ghost_gids = map_parts(lambda ci: np.asarray(ci.lid_to_gid)[np.asarray(ci.lid_to_ohid) < 0], A.cols.partition)
    rows_ext = add_gids(A.rows, ghost_gids)
    trip = psparse_owned_triplets(A)
    I2, J2, V2 = exchange_coo(map_parts(lambda t: t[0], trip), map_parts(lambda t: t[1], trip),
                              map_parts(lambda t: t[2], trip), rows_ext)
    factors = []
    for iset, gi, gj, v in zip(rows_ext.partition.part_values(), I2.part_values(), J2.part_values(),
                               V2.part_values()):
        nl = iset.num_lids
        li = iset.gids_to_lids(np.asarray(gi, dtype=np.int64))
        lj = iset.gids_to_lids(np.asarray(gj, dtype=np.int64))
        keep = (li >= 0) & (lj >= 0)  # couplings leaving the overlap are dropped
        if nl == 0 or not np.any(keep):
            factors.append(None)
            continue
        B = compresscoo(li[keep], lj[keep], np.asarray(v)[keep], nl, nl)
        factors.append(_ic0_factor(B, shift) if factor == "ic0" else _spilu_factor(B, drop_tol, fill_factor))
    parts = get_part_ids(A.values)

    def apply(r: PVector) -> PVector:
        re = PVector.full(0.0, rows_ext, dtype=r.dtype)
        _owned_zip(re, lambda _e, rv: rv, r)
        re.exchange()
        ze = PVector.full(0.0, rows_ext, dtype=r.dtype)

        def per_part(p, ev, zev):
            f = factors[int(p)]
            if f is not None:
                _assign_full(zev, f.solve(np.asarray(ev)))

        map_parts(per_part, parts, re.values, ze.values)
        if mode == "asm":
            ze.assemble()  # the overlap corrections flow back to their owners and add
        z = PVector.full(0.0, A.cols, dtype=r.dtype)
        _owned_zip(z, lambda _z, zev: zev, ze)
        return z

    return apply


# ---------------------------------------------------------------------------
# checkpoint resume and recovery (solvers.py:2153-2611)
# ---------------------------------------------------------------------------


def _solver_state_ranges(A: PSparseMatrix, b: PVector) -> dict:
    """The target PRanges of a cg/pcg full-state checkpoint: x and p ride
    A.cols, r rides b's row range."""
    return {"x": A.cols, "r": b.rows, "p": A.cols}


def resume_solve(directory: str, A: PSparseMatrix, b: PVector, method: Optional[str] = None, minv=None,
                 tol: Optional[float] = None, maxiter: Optional[int] = None, verbose: bool = False,
                 checkpoint=None, sdc=None) -> Tuple[PVector, dict]:
    """Continue a checkpointed Krylov run from its last saved state
    (solvers.py:2160-2244). ``directory`` holds a full-state checkpoint
    written by a `SolverCheckpointer` (the host loops' ``checkpoint=``
    hook), by either package. The state restores onto the partition ``A``
    and ``b`` live on (the same part count: `CheckpointShapeError`
    otherwise); on a host backend with a full (x, r, p) state and the same
    method the recurrence continues exactly, bit for bit the uninterrupted
    run. On the GPU backend (whose device loop cannot ingest mid-recurrence
    state), from an iterate-only checkpoint, or across a method switch,
    Krylov restarts from the checkpointed iterate. ``method``, ``tol`` and
    ``maxiter`` default to what the checkpoint recorded; ``checkpoint``
    keeps checkpointing the resumed host run."""
    from ..parallel.checkpoint import load_solver_state
    from ..parallel.gpu import GPUBackend

    state = load_solver_state(directory, _solver_state_ranges(A, b))
    if state is None:
        raise ValueError(f"resume_solve: {directory!r} holds no complete solver checkpoint (no manifest.json)")
    meta = state["meta"]
    method = method or meta.get("method", "cg")
    check(method in ("cg", "pcg"), "resume_solve: method is 'cg' or 'pcg'")
    tol = tol if tol is not None else float(meta.get("tol", 1e-8))
    if maxiter is None and meta.get("maxiter") is not None:
        maxiter = int(meta["maxiter"])
    kw = dict(tol=tol, maxiter=maxiter, verbose=verbose, sdc=sdc)
    # an exact resume needs the full state and the same method (a cg
    # checkpoint has no rz for pcg)
    full_state = all(k in state for k in ("x", "r", "p")) and "rs" in meta and meta.get("method") == method
    on_device = isinstance(b.values.backend, GPUBackend)
    if on_device or not full_state:
        if on_device and checkpoint is not None:
            raise ValueError("resume_solve: per-iteration checkpointing is a host-loop feature; on the device "
                             "backend use models.solvers.solve_with_recovery to keep checkpointing")
        ck = None if on_device else checkpoint
        if method == "pcg":
            x, info = pcg(A, b, x0=state["x"], minv=minv, checkpoint=ck, **kw)
        else:
            x, info = cg(A, b, x0=state["x"], checkpoint=ck, **kw)
    elif method == "pcg":
        x, info = pcg(A, b, minv=minv, checkpoint=checkpoint, _resume_state=state, **kw)
    else:
        x, info = cg(A, b, checkpoint=checkpoint, _resume_state=state, **kw)
    info["resumed_from_iteration"] = int(meta["it"])
    return x, info


def _new_recovery_ledger() -> dict:
    """The cumulative ``info["recovery"]`` of the host and chunked device
    recovery drivers (solvers.py:2247)."""
    return {"attempts": 0, "detections": 0, "rollbacks": 0, "checkpoint_restarts": 0, "restart_sources": []}


def _ledger_fold_sdc(ledger: dict, counters) -> None:
    """Fold one attempt's in-memory-tier counters (an ``info["sdc"]``, or
    the same on an escalated error's diagnostics) into the ledger."""
    if counters:
        ledger["detections"] += int(counters.get("detections", 0))
        ledger["rollbacks"] += int(counters.get("rollbacks", 0))


def solve_with_recovery(A: PSparseMatrix, b: PVector, method: str = "cg", checkpoint_dir: Optional[str] = None,
                        every: int = 25, max_restarts: int = 2, minv=None, x0: Optional[PVector] = None,
                        tol: float = 1e-8, maxiter: Optional[int] = None, verbose: bool = False,
                        sdc=None) -> Tuple[PVector, dict]:
    """A Krylov solve under the whole resilience layer (solvers.py:2269-2350):
    checkpoints every ``every`` iterations and a restart from the last one
    when any `SolverHealthError` fires (a NaN-poisoned exchange, a dropped
    part's timeout, a lost controller, a breakdown, or a
    `SilentCorruptionError` escalated by the in-memory rollback tier), up
    to ``max_restarts``. ``info`` carries ``restarts``, ``failures`` and
    the cumulative ``recovery`` ledger (``attempts``, the in-memory tier's
    ``detections`` and ``rollbacks`` over all attempts,
    ``checkpoint_restarts`` and per restart its ``restart_sources`` entry:
    the failure and the state restarted from).

    A host backend checkpoints the full recurrence state in the loop, so a
    restart replays the exact trajectory (`_solve_with_recovery_host`). On
    the GPU backend the device loop cannot stop mid-solve, so the solve
    runs in ``every``-iteration chunks with the iterate checkpointed
    between chunks (`_solve_with_recovery_chunked`): a restart re-enters
    Krylov from the checkpointed iterate. Without ``checkpoint_dir``
    nothing is written and a restart begins from ``x0``. ``sdc`` runs
    every attempt under the SDC defense. A `PartLossError` spends no
    restart (no restart on the same partition recovers a dead part): with
    the elastic config enabled (`parallel.elastic.configure(enabled=True)`)
    the system shrinks onto the surviving parts, which stay stacked parts
    of the same backend, and resumes from the last checkpointed iterate
    (`elastic.shrink_and_resume`, ``info["elastic"]``; on the GPU backend
    one unchunked device solve over a fresh staging of the survivors);
    otherwise the error propagates typed. A successful exit at full
    capacity after a shrink emits ``elastic_restore`` (grow-back)."""
    from ..parallel.checkpoint import SolverCheckpointer
    from ..parallel.gpu import GPUBackend

    from .. import telemetry

    check(method in ("cg", "pcg"), "solve_with_recovery: method is 'cg' or 'pcg'")
    ckpt = SolverCheckpointer(checkpoint_dir, every=every) if checkpoint_dir is not None else None
    with telemetry.solve_scope("solve_with_recovery", method=method, tol=float(tol),
                               max_restarts=int(max_restarts), checkpointing=checkpoint_dir is not None) as rec:
        try:
            if isinstance(b.values.backend, GPUBackend):
                x, info = _solve_with_recovery_chunked(A, b, method, ckpt, every, max_restarts, minv, x0, tol,
                                                       maxiter, verbose, sdc)
            else:
                x, info = _solve_with_recovery_host(A, b, method, ckpt, max_restarts, minv, x0, tol, maxiter,
                                                    verbose, sdc)
        except BaseException:
            # raise with no checkpoint write in flight: a caller that removes
            # the directory on the error must not race the writer thread
            if ckpt is not None:
                try:
                    ckpt.wait()
                except Exception:
                    pass  # the solve's own error is the one to report
            raise
        from ..parallel import elastic

        elastic.note_recovered(int(A.rows.partition.num_parts), info)
        return x, rec.finish(info)


def _failure(e) -> dict:
    return {"type": type(e).__name__, "message": str(e), "diagnostics": e.diagnostics}


def _solve_with_recovery_host(A, b, method, ckpt, max_restarts, minv, x0, tol, maxiter, verbose, sdc):
    """The host recovery loop (solvers.py:2353-2474): exact-recurrence
    restarts from the full-state checkpoint."""
    import sys

    from ..parallel import elastic
    from ..parallel.checkpoint import CheckpointCorruptError, load_solver_state
    from ..utils.health import PartLossError, SolverHealthError

    restarts, failures, state = 0, [], None
    ledger = _new_recovery_ledger()
    while True:
        try:
            ledger["attempts"] += 1
            kw = dict(tol=tol, maxiter=maxiter, verbose=verbose, checkpoint=ckpt, _resume_state=state, sdc=sdc)
            if method == "pcg":
                x, info = pcg(A, b, x0=x0, minv=minv, **kw)
            else:
                x, info = cg(A, b, x0=x0, **kw)
            info["restarts"] = restarts
            if failures:
                info["failures"] = failures
            _ledger_fold_sdc(ledger, info.get("sdc"))
            info["recovery"] = ledger
            return x, info
        except PartLossError as e:
            # persistent: no restart on this partition can recover it;
            # shrink onto the survivors or escalate typed
            failures.append(_failure(e))
            _ledger_fold_sdc(ledger, e.diagnostics.get("sdc"))
            if not elastic.elastic_enabled():
                raise
            return elastic.shrink_and_resume(A, b, method, minv, ckpt, x0, tol, maxiter, verbose, e, ledger,
                                             failures, restarts, sdc=sdc)
        except SolverHealthError as e:
            failures.append(_failure(e))
            _ledger_fold_sdc(ledger, e.diagnostics.get("sdc"))
            if restarts >= max_restarts:
                raise
            restarts += 1
            state = None
            how = "scratch"
            source = {"failure": type(e).__name__, "from": "scratch"}
            if ckpt is not None:
                try:
                    ckpt.wait()  # let an in-flight write land first
                except Exception:
                    pass
                if ckpt.has_state():
                    try:
                        st = load_solver_state(ckpt.directory, _solver_state_ranges(A, b))
                    except CheckpointCorruptError as ce:
                        # a rotted checkpoint degrades the restart to scratch
                        st = None
                        source["checkpoint_corrupt"] = str(ce)
                    if st is not None:
                        meta_ = st.get("meta", {})
                        if all(k in st for k in ("x", "r", "p")) and "rs" in meta_ and meta_.get("method") == method:
                            state = st
                            how = "last checkpoint (exact recurrence)"
                            source["from"] = "checkpoint_state"
                        else:
                            x0 = st["x"]
                            how = "checkpointed iterate (Krylov restart)"
                            source["from"] = "checkpoint_iterate"
                        source["checkpoint_iteration"] = int(meta_.get("it", 0))
                        ledger["checkpoint_restarts"] += 1
            ledger["restart_sources"].append(source)
            from .. import telemetry

            telemetry.emit_event("restart", label=type(e).__name__, attempt=restarts, **source)
            print(f"[partitionedarrays_jl_tpu_torch] {method}: {type(e).__name__}: {e}: restart {restarts}/"
                  f"{max_restarts} from " + how, file=sys.stderr, flush=True)


def _solve_with_recovery_chunked(A, b, method, ckpt, every, max_restarts, minv, x0, tol, maxiter, verbose, sdc):
    """The device recovery loop (solvers.py:2477-2611): the device solve in
    ``every``-iteration chunks, the iterate checkpointed between chunks;
    convergence is judged against the first chunk's initial residual, so
    the chunked run answers the unchunked run's question."""
    import sys

    from ..parallel import elastic
    from ..parallel.checkpoint import CheckpointCorruptError, load_solver_state
    from ..utils.health import PartLossError, SolverHealthError

    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    chunk = max(1, int(every)) if ckpt is not None else maxiter
    x = x0.copy() if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
    solver = pcg if method == "pcg" else cg
    kw = {"minv": minv} if method == "pcg" else {}
    done = restarts = 0
    failures, residuals = [], []
    rs0 = info = None
    ledger = _new_recovery_ledger()
    while done < maxiter:
        try:
            ledger["attempts"] += 1
            x_new, info = solver(A, b, x0=x, tol=tol, maxiter=min(chunk, maxiter - done), verbose=verbose,
                                 sdc=sdc, **kw)
            _ledger_fold_sdc(ledger, info.get("sdc"))
        except PartLossError as e:
            failures.append(_failure(e))
            _ledger_fold_sdc(ledger, e.diagnostics.get("sdc"))
            if not elastic.elastic_enabled():
                raise
            # the resume starts from the retained iterate unless a
            # checkpoint exists (shrink_and_resume prefers the checkpoint)
            return elastic.shrink_and_resume(A, b, method, minv, ckpt, x, tol, max(1, maxiter - done), verbose,
                                             e, ledger, failures, restarts, sdc=sdc)
        except SolverHealthError as e:
            failures.append(_failure(e))
            _ledger_fold_sdc(ledger, e.diagnostics.get("sdc"))
            if restarts >= max_restarts:
                raise
            restarts += 1
            # with no clean checkpoint the run continues from the last
            # completed chunk's iterate
            source = {"failure": type(e).__name__, "from": "retained_iterate"}
            if ckpt is not None and ckpt.has_state():
                try:
                    st = load_solver_state(ckpt.directory, _solver_state_ranges(A, b))
                except CheckpointCorruptError as ce:
                    st = None
                    source["checkpoint_corrupt"] = str(ce)
                if st is not None:
                    x = st["x"]
                    done = int(st["meta"].get("it", done))
                    source["from"] = "checkpoint_iterate"
                    source["checkpoint_iteration"] = done
                    ledger["checkpoint_restarts"] += 1
            ledger["restart_sources"].append(source)
            from .. import telemetry

            telemetry.emit_event("restart", label=type(e).__name__, attempt=restarts, **source)
            print(f"[partitionedarrays_jl_tpu_torch] {method} (chunked): {type(e).__name__}: {e}: restart "
                  f"{restarts}/{max_restarts}", file=sys.stderr, flush=True)
            continue
        x = x_new
        if rs0 is None:
            rs0 = float(info["residuals"][0]) if len(info["residuals"]) else 0.0
        done += int(info["iterations"])
        residuals.extend(float(v) for v in info["residuals"][1:])
        final = float(info["residuals"][-1]) if len(info["residuals"]) else 0.0
        if final <= tol * max(1.0, rs0):
            break
        if int(info["iterations"]) == 0:
            break  # the chunk made no progress
        if ckpt is not None:
            ckpt.save_state({"x": x}, {"method": method, "it": done, "tol": tol})
    if ckpt is not None:
        ckpt.wait()
    final = residuals[-1] if residuals else (rs0 or 0.0)
    out = krylov_info(
        done, [rs0 or 0.0] + residuals, final <= tol * max(1.0, rs0 or 0.0), tol, b.dtype, False,
        final_rel=_final_true_rel(A, x, b, final / max(1.0, rs0 or 1.0), rs0 or 0.0, tol),
    )
    out["restarts"] = restarts
    if failures:
        out["failures"] = failures
    out["recovery"] = ledger
    return x, out
