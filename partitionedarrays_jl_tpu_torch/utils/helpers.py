"""Contract-enforcement and Krylov info helpers.

The port's own copy of `partitionedarrays_jl_tpu/utils/helpers.py` (the
reference's error macros, src/Helpers.jl:6-61): `check` and its switch,
`notimplemented`/`unreachable`, strict mode's fixed-tree `pairwise_sum`, the
tolerance-floor warning and the info dict shared by the host and device CG
loops. The JAX package strips contract checks with ``PA_TPU_CHECKS=0``; the
port reads no environment: set `CHECKS_ENABLED` to False instead.
"""
from __future__ import annotations

import warnings

import numpy as np

#: contract checks on (`check` raises); False strips them, the
#: ``--boundscheck=no`` analog
CHECKS_ENABLED = True


class AbstractMethodError(NotImplementedError):
    pass


def abstractmethod(obj=None, name: str = "") -> None:
    """Raise: a subtype forgot to implement part of its interface contract."""
    raise AbstractMethodError(
        f"abstract method {name or ''} called on {type(obj).__name__}: "
        "concrete implementations must override it"
    )


def notimplemented(msg: str = "this case is not yet implemented") -> None:
    raise NotImplementedError(msg)


def notimplementedif(condition: bool, msg: str = "this case is not yet implemented") -> None:
    if condition:
        notimplemented(msg)


def unreachable(msg: str = "this line of code cannot be reached") -> None:
    raise AssertionError(msg)


def checks_enabled() -> bool:
    """Whether `check` asserts (the module switch `CHECKS_ENABLED`)."""
    return CHECKS_ENABLED


def check(condition, msg: str = "check failed") -> None:
    """Cheap contract assertion, stripped when `CHECKS_ENABLED` is False
    (reference: src/Helpers.jl:50-61, `@check`)."""
    if CHECKS_ENABLED and not condition:
        raise AssertionError(msg)


def pairwise_sum(v):
    """Fixed-tree pairwise sum (helpers.py:66-75 of the JAX package): pad to
    the next power of two with exact zeros, then ``v[0::2] + v[1::2]``
    until one element. Strict mode's dots use it a part on the host
    (`PVector.dot(strict=True)`); the card's E3 kernel
    (`ops/irregular.pairwise_dot`) runs the identical tree, so the
    partials agree bit for bit. Zero tail slots are rounding-neutral, so
    trees padded to different power-of-two lengths agree as long as the
    real data is a prefix (up to the sign of an exact-zero sum)."""
    v = np.asarray(v)
    if v.size == 0:
        return v.dtype.type(0.0) if v.dtype.kind == "f" else 0.0
    n = 1 << int(v.size - 1).bit_length() if v.size > 1 else 1
    if v.size < n:
        v = np.concatenate([v, np.zeros(n - v.size, dtype=v.dtype)])
    while v.size > 1:
        v = v[0::2] + v[1::2]
    return v[0]


#: a relative residual in dtype d cannot be resolved below about this many
#: machine epsilons
TOL_FLOOR_EPS_MULTIPLE = 50.0


def tolerance_floor(dtype) -> float:
    """The smallest relative-residual tolerance `dtype` can resolve."""
    return TOL_FLOOR_EPS_MULTIPLE * float(np.finfo(np.dtype(dtype)).eps)


def warn_tol_below_floor(tol: float, dtype, name: str = "solver") -> bool:
    """Warn (RuntimeWarning) when a relative tolerance sits below the
    dtype's resolution floor. Returns whether the warning fired."""
    if not (tol > 0):  # tol=0 fixed-trip runs are deliberate
        return False
    dt = np.dtype(dtype)
    if dt.kind != "f" or tol >= tolerance_floor(dt):
        return False
    warnings.warn(
        f"{name}: tol={tol:g} is below the {dt.name} resolution floor "
        f"(~{TOL_FLOOR_EPS_MULTIPLE:g}x eps = {tolerance_floor(dt):g}); the "
        "run may stall at the floor with converged=False despite an "
        "accurate solution. Solve in float64 or loosen tol.",
        RuntimeWarning,
        stacklevel=3,
    )
    return True


def krylov_status(residuals, converged: bool, tol: float, dtype, final_rel=None) -> str:
    """Classify a finished Krylov run: converged, stalled, diverged or
    maxiter (the JAX package's classification, unchanged)."""
    if converged:
        return "converged"
    r = np.asarray(residuals, dtype=np.float64)
    r = r[np.isfinite(r)]
    if len(r) >= 2 and r[-1] > 10.0 * max(r[0], 1e-300):
        return "diverged"
    dt = np.dtype(dtype)
    if (
        final_rel is not None
        and dt.kind == "f"
        and tol < float(final_rel) <= 10.0 * tolerance_floor(dt)
    ):
        return "stalled"
    if len(r) >= 8:
        w = max(4, len(r) // 4)
        if float(np.min(r[-w:])) > 0.9 * float(np.min(r[:-w])):
            return "stalled"
    return "maxiter"


def krylov_info(it, history, converged, tol, dtype, floor_warned, final_rel=None, **extra):
    """The Krylov info dict of the port's host and device CG loops."""
    residuals = np.array(history)
    converged = bool(converged)
    if converged and floor_warned and final_rel is not None and final_rel > tol:
        # the recurrence residual underflowed past a below-floor tol while
        # the true residual did not
        converged = False
    info = {
        "iterations": int(it),
        "residuals": residuals,
        "converged": converged,
        "status": krylov_status(residuals, converged, tol, dtype, final_rel=final_rel),
        **extra,
    }
    if floor_warned:
        info["tol_below_dtype_floor"] = True
    return info
