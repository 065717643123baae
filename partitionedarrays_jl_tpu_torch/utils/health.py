"""Solver and communication health: the typed errors, the guards that raise
them, and the silent-corruption (SDC) configuration.

The port's own copy of `partitionedarrays_jl_tpu/parallel/health.py`
(health.py:116-245, :299-545): the error family whose base,
`SolverHealthError`, a recovery driver catches; the free scalar guard
`check_finite_scalar` (a NaN or Inf anywhere in a part's values poisons the
reduction the solver takes anyway, so testing the reduced scalar adds no
work) and its per-part localisation `nonfinite_part_diagnostics`;
`StagnationDetector`, `RollbackRing` and `retry_with_backoff`; and the
detection tolerances `abft_tolerance` and `audit_tolerance`.

The port reads no environment. The JAX package's switches are keywords:
``PA_HEALTH_CHECKS`` is ``health=True`` on the solvers, ``PA_HEALTH_STAGNATION``
(with its window and factor) is ``stagnation=`` (a `StagnationDetector`
config: True, or a ``(window, factor)`` pair), and the SDC switches
(``PA_TPU_ABFT``, ``PA_HEALTH_AUDIT_EVERY``, ``PA_HEALTH_ROLLBACK_DEPTH``,
``PA_HEALTH_MAX_ROLLBACKS``, ``PA_TPU_ABFT_TOL``, ``PA_HEALTH_AUDIT_TOL``,
``PA_FAULT_DEVICE``) are the fields of one frozen `SDCConfig`, passed as
``sdc=`` to `cg`, `pcg`, `gpu_cg`, `gpu_block_cg` and `solve_with_recovery`.
The telemetry events of the JAX package wait for the port's telemetry
layer; the counters are kept.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np

__all__ = [
    "SolverHealthError", "NonFiniteError", "SolverBreakdownError", "SolverStagnationError",
    "ExchangeTimeoutError", "SolveDeadlineError", "DeadlineInfeasible", "ControllerLostError",
    "PartLossError", "SilentCorruptionError", "PlanSoundnessError", "LoweringConflictError",
    "SDCConfig", "abft_tolerance", "audit_tolerance", "RollbackRing", "StagnationDetector",
    "check_finite_scalar", "check_finite_pvector", "nonfinite_part_diagnostics", "retry_with_backoff",
]


# ---------------------------------------------------------------------------
# typed failures
# ---------------------------------------------------------------------------


class SolverHealthError(RuntimeError):
    """A solver detected a state it cannot continue from. ``diagnostics``
    carries what the raising guard knows (the context, the iteration, the
    parts, the residuals); `models.solvers.solve_with_recovery` catches this
    type: every subclass is survivable by a restart."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})


class NonFiniteError(SolverHealthError):
    """NaN/Inf detected in solver state or an exchanged payload."""


class LoweringConflictError(SolverHealthError):
    """Two requested solver-body forms cannot compose into one loop (the
    s-step body with ``fused``, ``pipelined``, ``precond``, a block of
    right-hand sides, strict mode or the SDC defense; the pipelined body
    with the SDC defense), raised when the solve function is built, naming
    both sides under ``diagnostics["conflict"]``, instead of silently
    building another body than the caller asked for."""


class SolverBreakdownError(SolverHealthError):
    """A Krylov recurrence hit an exact breakdown (p'Ap == 0, ...)."""


class SolverStagnationError(SolverHealthError):
    """The residual stopped improving (raised only when the solver was asked
    to, ``stagnation=``; the default contract is ``info["status"]``)."""


class ExchangeTimeoutError(SolverHealthError):
    """A neighbour's contribution never arrived (a ``drop`` fault clause);
    ``diagnostics["missing_parts"]`` names the senders."""


class SolveDeadlineError(SolverHealthError):
    """A solve request's wall-clock deadline expired (the JAX package's solve
    service raises it; kept for the shared vocabulary)."""


class DeadlineInfeasible(SolverHealthError):
    """A deadline-carrying request refused at admission by a forecast (the
    JAX package's solve service; kept for the shared vocabulary)."""


class ControllerLostError(SolverHealthError):
    """A controller process died mid-run (a ``controller`` fault clause)."""


class PartLossError(SolverHealthError):
    """A part died mid-run: its exchange contribution will never arrive
    again (a ``part_loss`` fault clause). Persistent, unlike
    `ExchangeTimeoutError`: a restart on the same partition fails the same
    way, so `solve_with_recovery` spends no restart on it and lets it
    propagate (the elastic shrink over the surviving parts runs across
    cards and is not ported). ``diagnostics["part"]`` names the part,
    ``diagnostics["call"]`` the exchange call it died at."""


class SilentCorruptionError(SolverHealthError):
    """Finite corruption detected by the SDC defense: an ABFT checksum
    mismatch (an exchanged slab, or the SpMV's ``c·(A x)`` against
    ``(c·A)·x``) or a failed true-residual audit. Raised at the detection
    site (the host exchange's slab verify) or once the in-memory rollback
    budget is spent, when ``diagnostics["sdc"]`` carries the counters;
    `solve_with_recovery` escalates it to a checkpoint restart."""


class PlanSoundnessError(SolverHealthError):
    """An exchange plan failed static verification (the JAX package's plan
    verifier; kept for the shared vocabulary)."""


# ---------------------------------------------------------------------------
# the SDC configuration and tolerances
# ---------------------------------------------------------------------------


def abft_tolerance(dtype) -> float:
    """Relative ABFT checksum threshold of the host exchange's slab verify:
    |Δ| > tol·scale is corruption (health.py:299)."""
    return 1e-3 if np.dtype(dtype).itemsize <= 4 else 1e-10


def audit_tolerance(dtype) -> float:
    """Relative true-residual drift threshold: ||(b - A x) - r|| >
    tol·max(1, ||r0||) fails the audit (health.py:310)."""
    return 1e-3 if np.dtype(dtype).itemsize <= 4 else 1e-8


@dataclass(frozen=True)
class SDCConfig:
    """The silent-corruption defense of a solve, the JAX package's
    environment switches as one frozen value (health.py:252-317):

    * ``abft`` (``PA_TPU_ABFT``): checksummed halo exchanges and, on the
      device loops, the SpMV checksum ``c·(A x)`` against ``(c·A)·x``;
    * ``audit_every`` (``PA_HEALTH_AUDIT_EVERY``): the true-residual audit
      period in iterations, 0 off; None takes the JAX default, 32 under
      ABFT and 0 otherwise;
    * ``rollback_depth`` (``PA_HEALTH_ROLLBACK_DEPTH``): the ring depth R of
      audited states;
    * ``max_rollbacks`` (``PA_HEALTH_MAX_ROLLBACKS``): in-memory rollbacks a
      solve may take before a detection escalates;
    * ``abft_tol`` / ``audit_tol`` (``PA_TPU_ABFT_TOL`` /
      ``PA_HEALTH_AUDIT_TOL``): threshold overrides, None for the
      dtype-scaled defaults;
    * ``device_fault`` (``PA_FAULT_DEVICE``): the device loops' chaos seam,
      ``"spmv@trip=N[,part=P][,factor=F]"`` (`parallel/faults.py:
      parse_device_fault`), staged only by an active defense.

    ``SDCConfig()`` is inactive (no ABFT, no audits): a solve given it runs
    the undefended loop."""

    abft: bool = False
    audit_every: Optional[int] = None
    rollback_depth: int = 2
    max_rollbacks: int = 3
    abft_tol: Optional[float] = None
    audit_tol: Optional[float] = None
    device_fault: Optional[str] = None

    def __post_init__(self):
        if self.audit_every is not None and int(self.audit_every) < 0:
            raise ValueError("SDCConfig: audit_every must be >= 0")
        if int(self.rollback_depth) < 1:
            raise ValueError("SDCConfig: rollback_depth must be >= 1")
        if int(self.max_rollbacks) < 0:
            raise ValueError("SDCConfig: max_rollbacks must be >= 0")
        if self.device_fault is not None:
            from ..parallel.faults import parse_device_fault

            parse_device_fault(self.device_fault)  # refuse a malformed clause now

    @property
    def every(self) -> int:
        """The audit period in effect (the JAX default resolved)."""
        if self.audit_every is None:
            return 32 if self.abft else 0
        return int(self.audit_every)

    @property
    def active(self) -> bool:
        return bool(self.abft) or self.every > 0

    def audit_tolerance(self, dtype) -> float:
        return float(self.audit_tol) if self.audit_tol else audit_tolerance(dtype)


def resolve_sdc(sdc) -> Optional[SDCConfig]:
    """``sdc=`` as the solvers take it: None or an inactive config is no
    defense (None), an active `SDCConfig` itself; anything else raises."""
    if sdc is None:
        return None
    if not isinstance(sdc, SDCConfig):
        raise TypeError(f"sdc= takes an SDCConfig, got {type(sdc).__name__}")
    return sdc if sdc.active else None


# ---------------------------------------------------------------------------
# finite checks
# ---------------------------------------------------------------------------


def nonfinite_part_diagnostics(*vectors) -> dict:
    """Per-part census of NaN/Inf over ``(name, PVector)`` pairs: for each
    part with any, the counts and the first offending local id. The
    localisation pass, run only after a scalar guard tripped."""
    parts = {}
    for name, v in vectors:
        for p, vals in enumerate(v.values.part_values()):
            a = np.asarray(vals)
            if a.dtype.kind != "f":
                continue
            bad = ~np.isfinite(a)
            if bad.any():
                d = parts.setdefault(int(p), {})
                d[name] = {
                    "nan": int(np.isnan(a).sum()),
                    "inf": int(np.isinf(a).sum()),
                    "first_lid": int(np.nonzero(bad)[0][0]),
                }
    return {"parts": parts}


def check_finite_scalar(value, context: str, it: Optional[int] = None, vectors: Sequence = ()) -> None:
    """Raise `NonFiniteError` when an already-reduced scalar (a dot, a norm)
    is NaN/Inf; ``vectors`` (``(name, PVector)`` pairs) are swept for the
    per-part diagnostics only after the guard trips."""
    if np.isfinite(value):
        return
    diag = {"context": context, "value": float(value)}
    if it is not None:
        diag["iteration"] = int(it)
    try:
        diag.update(nonfinite_part_diagnostics(*vectors))
    except Exception:  # diagnostics must never mask the primary failure
        pass
    raise NonFiniteError(
        f"{context}: non-finite reduction value {value!r}"
        + (f" at iteration {it}" if it is not None else "")
        + " — a NaN/Inf entered the solver state (see .diagnostics)",
        diagnostics=diag,
    )


def check_finite_pvector(v, context: str) -> None:
    """Full finiteness sweep of a PVector."""
    diag = nonfinite_part_diagnostics(("values", v))
    if diag["parts"]:
        diag["context"] = context
        raise NonFiniteError(f"{context}: non-finite values on parts {sorted(diag['parts'])}", diagnostics=diag)


class StagnationDetector:
    """Windowed best-residual tracker of the Krylov loops: ``update(res,
    it)`` raises `SolverStagnationError` when over the last ``window``
    updates the best residual failed to improve below ``factor`` times the
    previous best (health.py:382; the JAX defaults 32 and 0.99)."""

    def __init__(self, context: str, window: int = 32, factor: float = 0.99):
        self.context = context
        self.window = max(2, int(window))
        self.factor = float(factor)
        self.best = np.inf
        self.since_improvement = 0

    @classmethod
    def from_option(cls, context: str, stagnation) -> Optional["StagnationDetector"]:
        """The detector a solver's ``stagnation=`` keyword asks for: None or
        False none, True the defaults, a ``(window, factor)`` pair those."""
        if not stagnation:
            return None
        if stagnation is True:
            return cls(context)
        window, factor = stagnation
        return cls(context, window, factor)

    def update(self, res: float, it: int) -> None:
        if res < self.factor * self.best:
            self.best = res
            self.since_improvement = 0
            return
        self.since_improvement += 1
        if self.since_improvement >= self.window:
            raise SolverStagnationError(
                f"{self.context}: best residual {self.best:.3e} has not improved by "
                f"{1.0 - self.factor:.1%} over the last {self.window} iterations (it={it})",
                diagnostics={"context": self.context, "iteration": int(it), "best_residual": float(self.best),
                             "window": self.window},
            )


class RollbackRing:
    """Bounded in-memory ring of the last R audited recurrence states, the
    no-disk tier of the SDC defense (health.py:416): ``push`` only states
    that passed a true-residual audit (and the initial state); ``restore(strike)``
    the entry ``strike`` slots back (clamped), as fresh copies, or None when
    the ring is empty. The device loops keep the same ring as device
    tensors (`parallel/gpu_sdc.py`)."""

    def __init__(self, depth: int = 2):
        self.depth = int(depth)
        self._ring: list = []  # newest first

    def push(self, vectors: dict, meta: dict) -> None:
        self._ring.insert(0, ({k: v.copy() for k, v in vectors.items()}, dict(meta)))
        del self._ring[self.depth:]

    def restore(self, strike: int = 0):
        if not self._ring:
            return None
        vecs, meta = self._ring[min(max(0, strike), len(self._ring) - 1)]
        return {k: v.copy() for k, v in vecs.items()}, dict(meta)

    def __len__(self):
        return len(self._ring)


# ---------------------------------------------------------------------------
# transient-failure retry
# ---------------------------------------------------------------------------


def retry_with_backoff(
    fn: Callable,
    *,
    attempts: int = 3,
    backoff: float = 0.5,
    max_backoff: float = 30.0,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    jitter_seed: Optional[int] = None,
    give_up: Optional[Callable[[], bool]] = None,
):
    """Call ``fn()`` up to ``attempts`` times, sleeping ``backoff`` and then
    doubling it (capped at ``max_backoff``) between tries (health.py:482;
    the JAX defaults of ``PA_RETRY_ATTEMPTS`` and ``PA_RETRY_BACKOFF``);
    only ``exceptions`` are transient, and the last failure re-raises.
    ``backoff=0`` never sleeps. ``jitter_seed`` (``PA_RETRY_JITTER``) draws
    each delay from U[backoff, 3·previous], seeded; ``give_up()`` returning
    True after a failure re-raises at once."""
    attempts = max(1, int(attempts))
    rng = np.random.default_rng(jitter_seed) if jitter_seed is not None else None
    base = max(0.0, float(backoff))
    delay = base
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt >= attempts or (give_up is not None and give_up()):
                raise
            print(
                f"[partitionedarrays_jl_tpu_torch] {describe} failed (attempt {attempt}/{attempts}: "
                f"{type(e).__name__}: {e}); retrying in {delay:.1f}s",
                file=sys.stderr, flush=True,
            )
            sleep(delay)
            if rng is not None:
                delay = min(max_backoff, float(rng.uniform(base, max(base, delay * 3))))
            else:
                delay = min(max_backoff, delay * 2)
