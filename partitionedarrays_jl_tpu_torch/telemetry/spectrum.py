"""The convergence observatory: online CG–Lanczos spectral estimates,
iterations-to-tolerance forecasts and deadline-feasibility admission
(telemetry/spectrum.py of the JAX package, on its ``SPECTRUM.json``
format).

* **Lanczos reconstruction.** The CG coefficients are a Lanczos
  factorization: after k iterations the tridiagonal

  .. code-block:: text

      T_k[j, j]   = 1/α_j + β_{j-1}/α_{j-1}   (β_{-1}/α_{-1} := 0)
      T_k[j, j+1] = √β_j / α_j

  has Ritz values (eigenvalues of ``T_k``) that converge to the extremal
  eigenvalues of ``A`` (of ``M⁻¹A`` for PCG), so a finished solve's α/β
  trace (the device ring of ``trace_iters=``, or the host loop's) gives
  ``κ̂ = ritz_max/ritz_min``, host-side, after the solve.
  `scipy.linalg.eigh_tridiagonal` takes the eigenvalues.
* **The spectrum store.** Per ``(operator fingerprint, dtype,
  minv-class)``, estimates EWMA into a process-wide table
  (`SpectrumStore`): extremal eigenvalues, κ̂ and the measured residual
  reduction rate an iteration. ``export()``/``load()`` round-trip the
  schema-versioned table.
* **Forecasting.** `predict_iters`: the measured rate blended in log
  space with the κ-bound rate ``(√κ−1)/(√κ+1)`` as the prior; monotone in
  ``tol``.
* **s-selection.** `suggest_s`: the largest s-step depth ``s ≤ SSTEP_MAX``
  whose basis growth ``κ̂^s`` stays inside the dtype's precision budget.
* **Admission.** `check_deadline_feasible` multiplies the forecast by the
  throughput model's measured ``s_per_it`` and refuses a deadline that
  cannot be met with the typed `utils.health.DeadlineInfeasible`, before
  any iteration runs (the config's ``spec_admit``, default off;
  unmeasured operators are always admitted).
* **Anomaly detection.** `detect_anomalies` classifies a finished
  solve's residual trajectory and Ritz drift: ``stagnation``,
  ``divergence``, ``precond_degradation`` (κ̂ above ``drift_factor`` ×
  the stored baseline), emitted as ``convergence_anomaly`` events and
  counted under ``spec.anomalies{kind=…}``.

Switches (`telemetry.configure`): ``spec`` (the JAX package's ``PA_SPEC``,
default on), ``spec_admit`` (``PA_SPEC_ADMIT``, default off) and
``drift_factor``. No solve reads them: all spectral math runs on the host,
on traces and histories already downloaded.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import config
from .registry import mon_ewma, registry

__all__ = [
    "SPECTRUM_SCHEMA_VERSION",
    "ANOMALY_KINDS",
    "spec_enabled",
    "spec_admit_enabled",
    "lanczos_tridiagonal",
    "ritz_values",
    "measured_rate",
    "estimate_solve",
    "poisson_fdm_analytic_extremes",
    "SpectrumStore",
    "store",
    "reset_store",
    "has_spec",
    "spectrum_fingerprint",
    "residual_norm",
    "observe_solve",
    "detect_anomalies",
    "predict_iters",
    "admission_prediction",
    "check_deadline_feasible",
    "SSTEP_MAX",
    "sstep_stability_limit",
    "suggest_s",
]

SPECTRUM_SCHEMA_VERSION = 1

#: The anomaly vocabulary `detect_anomalies` speaks (the
#: ``convergence_anomaly`` event labels and ``spec.anomalies`` kinds).
ANOMALY_KINDS = ("stagnation", "divergence", "precond_degradation")

#: Stagnation: over the trailing window the best residual must improve
#: below FACTOR x the pre-window best, else the solve is stalling.
ANOMALY_WINDOW = 12
STAGNATION_FACTOR = 0.95
#: Divergence: final residual at least this factor above the best seen
#: (and not below the start) on an unconverged solve.
DIVERGENCE_FACTOR = 10.0
#: Preconditioner degradation: κ̂ drifting this factor above the stored
#: baseline (the config's ``drift_factor`` defaults to it), or the measured
#: rate needing >2x the iterations per decade.
KAPPA_DRIFT_FACTOR = 4.0
RATE_DRIFT_FACTOR = 0.5

#: Rate clamps: log-space blending needs rates strictly inside (0, 1).
_RATE_FLOOR = 1e-12
_RATE_CEIL = 1.0 - 1e-12
#: Reconstruction depth cap: the dense-eigvalsh fallback is O(k³), and
#: extremal Ritz values converge in the LEADING Krylov iterations — a
#: 20k-iteration host solve must not build a 20k×20k matrix in the
#: service worker's completion path.
_MAX_RITZ_K = 512
#: Prior weight (in samples) of the κ-bound rate when blending with the
#: measured rate — one synthetic observation's worth of trust.
_PRIOR_WEIGHT = 1.0


def spec_enabled() -> bool:
    """The config's ``spec`` (host-side estimation; default on)."""
    return bool(config().spec)


def spec_admit_enabled() -> bool:
    """The config's ``spec_admit`` (deadline-feasibility admission;
    default off)."""
    return bool(config().spec_admit)


# ---------------------------------------------------------------------------
# CG -> Lanczos reconstruction
# ---------------------------------------------------------------------------


def _usable_prefix(alpha, beta) -> Tuple[List[float], List[float]]:
    """The longest leading run of (α, β) pairs the reconstruction can
    use, capped at `_MAX_RITZ_K`: entries must exist, be finite, with
    α ≠ 0 and β ≥ 0. Block solves mask post-convergence trips as
    ``None`` — truncated here."""
    a_out: List[float] = []
    b_out: List[float] = []
    n = min(len(alpha or ()), len(beta or ()), _MAX_RITZ_K)
    for j in range(n):
        a, b = alpha[j], beta[j]
        if a is None or b is None:
            break
        a, b = float(a), float(b)
        if not (math.isfinite(a) and math.isfinite(b)) or a == 0.0 or b < 0.0:
            break
        a_out.append(a)
        b_out.append(b)
    return a_out, b_out


def lanczos_tridiagonal(alpha, beta,
                        trace_start: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The Lanczos tridiagonal ``T_k`` of a CG run, as ``(diag, off)``
    arrays (``off`` has ``k-1`` entries). ``alpha[j]``/``beta[j]`` are
    the recorded CG coefficients of committed iteration j (the
    trace ring's layout; ``None`` entries truncate). Empty
    inputs return empty arrays.

    ``trace_start > 0`` marks a TRAILING window (a wrapped ring, or a
    checkpoint-resumed host loop): the window's first diagonal entry
    would be missing its ``β_{j0−1}/α_{j0−1}`` term, so the first
    recorded pair is spent completing entry 1 and the returned matrix
    is the TRUE principal submatrix ``T[j0+1:, j0+1:]`` — its
    eigenvalues interlace the full T_k's and stay inside the spectrum
    (the containment the κ̂ band relies on)."""
    a, b = _usable_prefix(alpha, beta)
    k = len(a)
    if k == 0:
        return np.empty(0), np.empty(0)
    d = np.empty(k)
    e = np.empty(max(0, k - 1))
    d[0] = 1.0 / a[0]
    for j in range(1, k):
        d[j] = 1.0 / a[j] + b[j - 1] / a[j - 1]
    for j in range(k - 1):
        e[j] = math.sqrt(b[j]) / a[j]
    if trace_start and k > 0:
        d, e = d[1:], e[1:] if k > 1 else e
    return d, e


def ritz_values(alpha, beta,
                trace_start: int = 0) -> Optional[np.ndarray]:
    """Sorted Ritz values (eigenvalues of the reconstructed ``T_k``),
    or ``None`` when no usable coefficients exist."""
    d, e = lanczos_tridiagonal(alpha, beta, trace_start=trace_start)
    if len(d) == 0:
        return None
    if len(d) == 1:
        return np.asarray([float(d[0])])
    try:
        # tridiagonal solver when available (O(k²) vs dense O(k³))
        from scipy.linalg import eigh_tridiagonal

        return eigh_tridiagonal(d, e, eigvals_only=True)
    except ImportError:
        pass
    except Exception:
        return None
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    try:
        return np.linalg.eigvalsh(T)
    except np.linalg.LinAlgError:
        return None


def measured_rate(residuals) -> Optional[float]:
    """Geometric-mean per-iteration residual reduction of one solve
    (``(h_end/h_0)^(1/its)``), clamped into (0, 1) open — or ``None``
    when the history is too short or unusable."""
    if residuals is None:
        return None
    h = [float(v) for v in residuals]
    if len(h) < 2 or not all(math.isfinite(v) for v in h):
        return None
    if h[0] <= 0.0:
        return None
    its = len(h) - 1
    hend = max(h[-1], _RATE_FLOOR * h[0])
    rho = (hend / h[0]) ** (1.0 / its)
    return min(max(rho, _RATE_FLOOR), _RATE_CEIL)


def estimate_solve(alpha, beta, residuals,
                   trace_start: int = 0) -> Optional[dict]:
    """One finished solve's spectral estimate: extremal Ritz values and
    κ̂ when the α/β ring is present (``trace_start`` marks a trailing
    window — see `lanczos_tridiagonal`), the measured rate when the
    residual history is. Returns ``None`` when neither source yields
    anything."""
    ritz = ritz_values(alpha, beta, trace_start=trace_start)
    rate = measured_rate(residuals)
    if ritz is None and rate is None:
        return None
    out: dict = {
        "lam_min": None,
        "lam_max": None,
        "kappa": None,
        "rate": rate,
        "ritz_k": 0 if ritz is None else int(len(ritz)),
        "iterations": (
            0 if residuals is None else max(0, len(residuals) - 1)
        ),
    }
    if ritz is not None:
        lo, hi = float(ritz[0]), float(ritz[-1])
        out["lam_min"] = lo
        out["lam_max"] = hi
        if lo > 0.0:  # κ is an SPD concept — indefinite estimates stay raw
            out["kappa"] = hi / lo
    return out


def poisson_fdm_analytic_extremes(ns) -> Tuple[float, float]:
    """Closed-form extremal eigenvalues of the Dirichlet FDM Laplacian's
    INTERIOR block on an ``ns`` cell grid (boundary cells are identity
    rows): ``λ = Σ_d 4 sin²(k_d π / (2(ns_d−1)))``, ``k_d = 1..ns_d−2``.

    This is the effective spectrum CG sees on the
    `models.poisson_fdm.assemble_poisson` fixture: its ``x0`` carries
    the exact boundary values, so ``r0 = A(x̂−x0)`` is supported on
    interior rows and identity boundary rows keep every iterate there —
    the Krylov space never leaves the interior block (where the
    operator acts as the symmetric ``L_II``, decoupled or not). The
    analytic pin the committed SPECTRUM.json κ band is checked
    against."""
    ns = tuple(int(n) for n in ns)
    if any(n < 3 for n in ns):
        raise ValueError("poisson_fdm_analytic_extremes needs ns >= 3")
    lam_int_min = sum(4.0 * math.sin(math.pi / (2.0 * (n - 1))) ** 2
                      for n in ns)
    lam_int_max = sum(
        4.0 * math.sin((n - 2) * math.pi / (2.0 * (n - 1))) ** 2
        for n in ns
    )
    return lam_int_min, lam_int_max


# ---------------------------------------------------------------------------
# the process-wide spectrum store
# ---------------------------------------------------------------------------

_Key = Tuple[str, str, str]


class SpectrumStore:
    """EWMA table of spectral estimates keyed
    ``(fingerprint, dtype, minv_class)`` — thread-safe on the shared
    registry lock (solves finish on the service worker thread while
    admission reads from submit threads). ``minv_class`` is ``"none"``,
    ``"diag"``, or ``"callable"`` — preconditioning changes the
    EFFECTIVE spectrum CG sees, so the classes must not blend."""

    def __init__(self, alpha: Optional[float] = None):
        #: None -> the config's mon_ewma at each observation.
        self.alpha = alpha
        self._entries: Dict[_Key, Dict[str, float]] = {}

    # -- updates ---------------------------------------------------------
    def observe(self, fingerprint: str, dtype: str, minv_class: str,
                est: dict) -> None:
        """Fold one solve's `estimate_solve` output into the table."""
        if est is None:
            return
        key = (str(fingerprint), str(dtype), str(minv_class))
        a = self.alpha if self.alpha is not None else mon_ewma()

        def _ewma(old, new):
            return new if old is None else (1.0 - a) * old + a * new

        with registry().lock:
            e = self._entries.setdefault(key, {
                "lam_min": None, "lam_max": None, "log_rate": None,
                "samples": 0, "iterations": 0,
            })
            if est.get("lam_min") is not None:
                e["lam_min"] = _ewma(e["lam_min"], float(est["lam_min"]))
                e["lam_max"] = _ewma(e["lam_max"], float(est["lam_max"]))
            if est.get("rate") is not None:
                e["log_rate"] = _ewma(
                    e["log_rate"], math.log(float(est["rate"]))
                )
            e["samples"] += 1
            e["iterations"] += int(est.get("iterations") or 0)

    # -- queries ---------------------------------------------------------
    def spec(self, fingerprint: str, dtype: str,
             minv_class: str) -> Optional[dict]:
        """The accumulated spec of one operator class (κ derived on
        read), or ``None`` while unmeasured."""
        with registry().lock:
            e = self._entries.get(
                (str(fingerprint), str(dtype), str(minv_class))
            )
            if e is None:
                return None
            e = dict(e)
        kappa = None
        if e["lam_min"] is not None and e["lam_min"] > 0.0:
            kappa = e["lam_max"] / e["lam_min"]
        return {
            "lam_min": e["lam_min"],
            "lam_max": e["lam_max"],
            "kappa": kappa,
            "rate": (
                None if e["log_rate"] is None
                else math.exp(e["log_rate"])
            ),
            "samples": int(e["samples"]),
            "iterations": int(e["iterations"]),
        }

    # -- export / import -------------------------------------------------
    def export(self) -> dict:
        """The schema-versioned table (deterministic ordering, no
        wall-clock fields — the artifacts writer stamps provenance)."""
        with registry().lock:
            keys = sorted(self._entries)
        entries: List[dict] = []
        for k in keys:
            s = self.spec(*k)
            if s is None:
                continue
            entries.append({
                "fingerprint": k[0],
                "dtype": k[1],
                "minv_class": k[2],
                "lam_min": (
                    None if s["lam_min"] is None
                    else round(s["lam_min"], 9)
                ),
                "lam_max": (
                    None if s["lam_max"] is None
                    else round(s["lam_max"], 9)
                ),
                "kappa": (
                    None if s["kappa"] is None else round(s["kappa"], 9)
                ),
                # 12 decimals: the rate floor is 1e-12 — a 9-decimal
                # round would export a tiny rate as 0.0, which load()
                # could never log()
                "rate": (
                    None if s["rate"] is None else round(s["rate"], 12)
                ),
                "samples": s["samples"],
                "iterations": s["iterations"],
            })
        return {
            "spectrum_schema_version": SPECTRUM_SCHEMA_VERSION,
            "ewma_alpha": (
                self.alpha if self.alpha is not None else mon_ewma()
            ),
            "entries": entries,
        }

    @classmethod
    def load(cls, rec: dict) -> "SpectrumStore":
        if rec.get("spectrum_schema_version") != SPECTRUM_SCHEMA_VERSION:
            raise ValueError(
                f"spectrum schema {rec.get('spectrum_schema_version')!r} "
                f"!= {SPECTRUM_SCHEMA_VERSION}"
            )
        m = cls(alpha=rec.get("ewma_alpha"))
        for e in rec.get("entries", []):
            m._entries[(str(e["fingerprint"]), str(e["dtype"]),
                        str(e["minv_class"]))] = {
                "lam_min": e.get("lam_min"),
                "lam_max": e.get("lam_max"),
                "log_rate": (
                    None if e.get("rate") is None
                    # clamp: a hand-edited/legacy record must not make
                    # load() raise on log(0)
                    else math.log(
                        min(max(float(e["rate"]), _RATE_FLOOR),
                            _RATE_CEIL)
                    )
                ),
                "samples": int(e.get("samples", 1)),
                "iterations": int(e.get("iterations", 0)),
            }
        return m

    def __repr__(self):
        return f"SpectrumStore(entries={len(self._entries)})"


#: THE process-wide store (what finished solves feed and admission
#: reads).
_STORE = SpectrumStore()


def store() -> SpectrumStore:
    return _STORE


def reset_store() -> None:
    """Tests only: drop every measured entry."""
    with registry().lock:
        _STORE._entries.clear()


# ---------------------------------------------------------------------------
# the post-solve hook (solvers call this host-side, never in-graph)
# ---------------------------------------------------------------------------


def minv_class_of(minv) -> str:
    """The preconditioner class axis of the store key."""
    if minv is None:
        return "none"
    return "callable" if callable(minv) else "diag"


def spectrum_fingerprint(A) -> str:
    """VALUE-sensitive operator identity for the spectrum store:
    `throughput.operator_fingerprint` (shape/parts) plus a digest of
    the per-part value-stream moments. κ and the convergence rate are
    value-bound — two same-shaped operators (two gate tenants on the
    same grid) must not blend their spectra the way they legitimately
    share a throughput curve (cost IS shape-bound). One O(nnz) pass
    per operator, cached on the matrix object."""
    cached = getattr(A, "_spec_fingerprint", None)
    if cached is not None:
        return cached
    import hashlib

    from .throughput import operator_fingerprint

    h = hashlib.sha256()
    for vals in A.values.part_values():
        arr = np.asarray(getattr(vals, "data", vals))
        h.update(repr((
            int(arr.size),
            float(arr.sum()),
            float(np.abs(arr).sum()),
        )).encode())
    fp = f"{operator_fingerprint(A)}-v{h.hexdigest()[:8]}"
    try:
        A._spec_fingerprint = fp
    except Exception:
        pass
    return fp


def residual_norm(A, b, x0=None) -> Optional[float]:
    """Host-side ``‖b − A·x0‖`` (``‖b‖`` when ``x0`` is None) — the
    forecast's relative-target input. Warm starts pay one host SpMV at
    admission so a checkpointed near-converged resubmission (an
    eviction requeue, a journal resume) forecasts its REMAINING work,
    not a cold solve's — cold-forecasting it could refuse a request
    that is iterations from done."""
    try:
        if x0 is None:
            return float(b.norm())
        from ..models.solvers import _owned_update

        r = b.copy()
        q = A @ x0
        _owned_update(r, lambda rv, qv: rv - qv, q)
        return float(r.norm())
    except Exception:
        return None


def _columns_of(rec, info) -> List[Tuple[list, list, list, bool]]:
    """Normalize a record (scalar or block) into per-column
    ``(alpha, beta, residuals, converged)`` tuples."""
    alpha = getattr(rec, "alpha", None)
    beta = getattr(rec, "beta", None)
    info = info or {}
    if alpha and isinstance(alpha[0], list):  # block solve: K columns
        cols = info.get("columns") or []
        out = []
        for k in range(len(alpha)):
            ck = cols[k] if k < len(cols) else {}
            out.append((
                alpha[k], beta[k] if beta else [],
                ck.get("residuals"), bool(ck.get("converged")),
            ))
        return out
    residuals = info.get("residuals")
    if residuals is None:
        residuals = getattr(rec, "residuals", None)
    return [(alpha or [], beta or [], residuals,
             bool(info.get("converged")))]


def has_spec(fingerprint: str, dtype: str, minv_class: str) -> bool:
    """Cheap measured-or-not probe — admission paths check this BEFORE
    paying the O(n) ``b.norm()`` a forecast needs (the common case is
    an unmeasured operator, which must cost nothing)."""
    return _STORE.spec(fingerprint, dtype, minv_class) is not None


def observe_solve(A, rec, info=None, dtype=None, minv=None,
                  tol=None) -> Optional[dict]:
    """The ONE post-solve hook: reconstruct each column's spectral
    estimate from the record's α/β ring + residual history, run the
    anomaly detectors against the stored baseline, and EWMA the
    estimates into the process-wide store. Called by the solve drivers
    BEFORE the record is finalized (anomaly events land on the active
    record), entirely host-side — the compiled program never changes.
    Returns the last column's estimate (tests read it)."""
    if not spec_enabled() or rec is None or not getattr(
        rec, "enabled", False
    ):
        return None
    try:
        fp = spectrum_fingerprint(A)
    except Exception:
        return None
    dt = str(np.dtype(dtype)) if dtype is not None else "float64"
    mc = minv if isinstance(minv, str) else minv_class_of(minv)
    est = None
    trace_start = int(getattr(rec, "trace_start", 0) or 0)
    for alpha, beta, residuals, converged in _columns_of(rec, info):
        col_est = estimate_solve(
            alpha, beta, residuals, trace_start=trace_start
        )
        if col_est is None:
            continue
        prior = _STORE.spec(fp, dt, mc)
        for kind in detect_anomalies(
            col_est, residuals, prior, converged, mc
        ):
            registry().counter(
                "spec.anomalies", labels={"kind": kind}
            ).inc()
            from .record import emit_event

            emit_event(
                "convergence_anomaly", label=kind,
                iteration=col_est["iterations"],
                fingerprint=fp, minv_class=mc,
                kappa=col_est.get("kappa"), rate=col_est.get("rate"),
                baseline_kappa=None if prior is None else prior["kappa"],
                baseline_rate=None if prior is None else prior["rate"],
            )
        _STORE.observe(fp, dt, mc, col_est)
        est = col_est
    return est


def detect_anomalies(est, residuals, prior, converged,
                     minv_class) -> List[str]:
    """Classify one finished solve against its trajectory and the
    stored baseline (run BEFORE the estimate is folded into the store).
    Returns a subset of `ANOMALY_KINDS`."""
    out: List[str] = []
    h = [] if residuals is None else [float(v) for v in residuals]
    if len(h) >= 2 and all(math.isfinite(v) for v in h):
        if (
            not converged
            and h[-1] > DIVERGENCE_FACTOR * min(h)
            and h[-1] >= h[0]
        ):
            out.append("divergence")
        elif not converged and len(h) >= 2 * ANOMALY_WINDOW:
            recent = min(h[-ANOMALY_WINDOW:])
            before = min(h[:-ANOMALY_WINDOW])
            if before > 0 and recent > STAGNATION_FACTOR * before:
                out.append("stagnation")
    if (
        est is not None
        and prior is not None
        and prior["samples"] >= 2
        and minv_class != "none"
    ):
        degraded = False
        if (
            est.get("kappa") is not None
            and prior["kappa"] is not None
            and est["kappa"] > float(config().drift_factor) * prior["kappa"]
        ):
            degraded = True
        if (
            est.get("rate") is not None
            and prior["rate"] is not None
            and prior["rate"] < 1.0
            and math.log(min(max(est["rate"], _RATE_FLOOR), _RATE_CEIL))
            > RATE_DRIFT_FACTOR * math.log(prior["rate"])
        ):
            degraded = True
        if degraded:
            out.append("precond_degradation")
    return out


# ---------------------------------------------------------------------------
# the forecaster
# ---------------------------------------------------------------------------


def _kappa_rate(kappa: float) -> float:
    """The textbook CG convergence-rate bound ``(√κ−1)/(√κ+1)``."""
    sk = math.sqrt(max(1.0, float(kappa)))
    return min(max((sk - 1.0) / (sk + 1.0), _RATE_FLOOR), _RATE_CEIL)


def predict_iters(spec: Optional[dict], tol: float,
                  r0_norm: Optional[float] = None) -> Optional[int]:
    """Iterations-to-tolerance forecast from one stored spec.

    The convergence contract everywhere in this package is relative:
    done when ``‖r‖ ≤ tol·max(1, ‖r0‖)``, i.e. a reduction factor
    ``ε = tol·max(1, ‖r0‖)/‖r0‖`` (``ε = tol`` when ``r0_norm`` is not
    given). The per-iteration rate blends the MEASURED residual
    reduction with the κ-bound rate ``(√κ−1)/(√κ+1)`` as a prior
    (log-space, weighted by sample count) — then
    ``k = ⌈ln ε / ln ρ⌉``. The blended rate does not depend on the
    target, so the forecast is monotone non-increasing in ``tol`` (the
    pinned invariant). Returns ``None`` while the spec holds neither a
    measured rate nor a κ estimate (unmeasured operators make no
    claim), 0 when the start already satisfies the target."""
    if spec is None:
        return None
    tol = float(tol)
    # a poisoned right-hand side yields a NaN/Inf norm — an unusable
    # target makes NO claim (None, so admission passes and the solve
    # itself fails typed NonFiniteError); an absent norm falls back to
    # the bare relative tolerance
    if r0_norm is not None and (
        not math.isfinite(float(r0_norm)) or r0_norm < 0.0
    ):
        return None
    if r0_norm is None:
        eps = tol
    elif r0_norm == 0.0:
        return 0  # an exactly-satisfied start (warm resubmission)
    else:
        eps = tol * max(1.0, float(r0_norm)) / float(r0_norm)
    if not math.isfinite(eps) or eps <= 0.0:
        return None
    if eps >= 1.0:
        return 0
    rate = spec.get("rate")
    kappa = spec.get("kappa")
    if rate is None and kappa is None:
        return None
    logs: List[Tuple[float, float]] = []  # (weight, log rate)
    if rate is not None:
        rate = min(max(float(rate), _RATE_FLOOR), _RATE_CEIL)
        logs.append((max(1.0, float(spec.get("samples") or 1)),
                     math.log(rate)))
    if kappa is not None:
        logs.append((_PRIOR_WEIGHT, math.log(_kappa_rate(kappa))))
    log_rho = sum(w * lr for w, lr in logs) / sum(w for w, _ in logs)
    return max(1, int(math.ceil(math.log(eps) / log_rho)))


# ---------------------------------------------------------------------------
# s-step depth selection (the policy input of cg(sstep=))
# ---------------------------------------------------------------------------

#: Depth ceiling for `suggest_s`. The s-step body's Gram payload is
#: (2s+1)² entries and its trip recurrences unroll s deep — past ~8 the
#: monomial basis is numerically hopeless at ANY realistic κ̂ and the
#: unrolled body stops paying for its own compile time.
SSTEP_MAX = 8

#: Precision headroom of the stability budget: the monomial basis
#: [p, Ap, …, A^s p] conditions like κ^s, and the trip's Gram solve
#: squares it — we demand κ̂^s ≤ 1/(HEADROOM·eps(dtype)) so the basis
#: keeps ~10 bits of slack above the dtype's noise floor (the classic
#: s-step practice of staying well clear of 1/√eps per power).
_SSTEP_HEADROOM = 2.0 ** 10


def sstep_stability_limit(kappa: Optional[float],
                          dtype: str = "float64") -> int:
    """Largest ``s`` in ``[1, SSTEP_MAX]`` whose monomial-basis growth
    ``κ̂^s`` stays inside the dtype precision budget
    ``1/(HEADROOM·eps)``. ``s = 1`` is ALWAYS stable (it is the
    textbook body's own conditioning), so an unmeasured or degenerate
    κ̂ returns 1, never 0."""
    eps = float(np.finfo(np.dtype(dtype)).eps)
    budget = 1.0 / (_SSTEP_HEADROOM * eps)
    if kappa is None or not math.isfinite(float(kappa)) or kappa <= 1.0:
        # κ ≤ 1: a perfectly conditioned (or unmeasured) operator —
        # every depth is stable, the ceiling is the compile-size cap
        return SSTEP_MAX if kappa is not None and 0.0 < kappa <= 1.0 \
            else 1
    if budget <= 1.0:
        return 1
    # log-space: κ^s ≤ budget  ⇔  s ≤ ln budget / ln κ
    s = int(math.floor(math.log(budget) / math.log(float(kappa))))
    return max(1, min(SSTEP_MAX, s))


def suggest_s(spec: Optional[dict], dtype: str = "float64",
              tol: Optional[float] = None,
              r0_norm: Optional[float] = None) -> dict:
    """The s-step depth policy (``cg(sstep=)``) for one stored spec (one
    ``(operator fingerprint, dtype, minv-class)`` class): pick the
    largest stability-budget-feasible ``s`` and forecast what it buys.

    The s-step body replaces the textbook body's 2 scalar all_gathers
    per iteration with ONE block all_gather per s-iteration trip (the
    (2s+1)-wide Gram payload), so the modeled collective saving of
    depth s is a factor ``2s`` in gather COUNT — latency-bound ICI
    steps are where that wins (docs/performance.md). `predict_iters`
    (when a ``tol`` is given) turns the stored rate into absolute
    gather counts per variant so the caller sees the forecasted win,
    not just the factor.

    Returns a policy dict: ``s`` (the suggestion), ``policy``
    (``"largest-stable"`` | ``"unmeasured-default"``), ``kappa``,
    ``eps``/``budget`` (the stability arithmetic), per-depth
    ``candidates`` rows (growth, stability, modeled gather factor),
    and the forecast block when ``tol`` is given. Never raises on an
    unmeasured spec — the policy degrades to the always-safe s=1."""
    eps = float(np.finfo(np.dtype(dtype)).eps)
    budget = 1.0 / (_SSTEP_HEADROOM * eps)
    kappa = None if spec is None else spec.get("kappa")
    measured = kappa is not None and math.isfinite(float(kappa)) \
        and kappa > 0.0
    s_limit = sstep_stability_limit(kappa if measured else None, dtype)
    candidates = []
    for s in range(1, SSTEP_MAX + 1):
        log_growth = None if not measured else s * math.log(
            max(float(kappa), 1.0)
        )
        candidates.append({
            "s": s,
            # growth capped representable: κ^s can overflow float64 at
            # depths the policy would never pick anyway
            "basis_growth": (
                None if log_growth is None
                else math.exp(min(log_growth, 700.0))
            ),
            "stable": (s == 1) or (measured and s <= s_limit),
            "gather_factor": 2 * s,  # 2 gathers/it -> 1 gather/s its
        })
    chosen = s_limit if measured else 1
    out = {
        "s": int(chosen),
        "policy": "largest-stable" if measured else "unmeasured-default",
        "kappa": None if not measured else float(kappa),
        "dtype": str(np.dtype(dtype)),
        "eps": eps,
        "budget": budget,
        "sstep_max": SSTEP_MAX,
        "candidates": candidates,
        "gather_factor": 2 * int(chosen),
    }
    if tol is not None:
        its = predict_iters(spec, tol, r0_norm=r0_norm)
        out["forecast"] = {
            "tol": float(tol),
            "predicted_iters": its,
            # the textbook body's 2 scalar gathers per iteration vs
            # one block gather per s-trip — the absolute win the
            # factor models
            "standard_gathers": None if its is None else 2 * its,
            "sstep_gathers": (
                None if its is None
                else int(math.ceil(its / max(1, chosen)))
            ),
        }
    return out


def admission_prediction(fingerprint: str, dtype: str, minv_class: str,
                         tol: float,
                         r0_norm: Optional[float] = None,
                         cost_fingerprint: Optional[str] = None,
                         ) -> Optional[dict]:
    """The admission-time forecast for one request: predicted
    iterations from the stored spec (``fingerprint`` is the
    VALUE-sensitive `spectrum_fingerprint`), predicted seconds from
    the throughput model's cheapest measured ``s_per_it`` under
    ``cost_fingerprint`` (the SHAPE-bound `operator_fingerprint` —
    cost and spectrum key differently; optimistic per iteration, so
    admission refuses only what is infeasible even at the best
    measured width). ``None`` while the operator is spectrally
    unmeasured; ``predicted_s`` is ``None`` while no throughput entry
    exists."""
    if not spec_enabled():
        return None
    spec = _STORE.spec(fingerprint, dtype, minv_class)
    its = predict_iters(spec, tol, r0_norm=r0_norm)
    if its is None:
        return None
    from .throughput import model

    curve = model().curve(
        cost_fingerprint or fingerprint, dtype
    )  # {K: per-RHS s_per_it}
    s_per_it = None
    if curve:
        s_per_it = min(v * k for k, v in curve.items())  # = min s_per_it
    return {
        "predicted_iters": int(its),
        "s_per_it": s_per_it,
        "predicted_s": None if s_per_it is None else its * s_per_it,
        "kappa": spec["kappa"],
        "rate": spec["rate"],
        "samples": spec["samples"],
    }


def check_deadline_feasible(fingerprint: str, dtype: str,
                            minv_class: str, tol: float,
                            deadline_s: float,
                            r0_norm: Optional[float] = None,
                            tag: str = "", where: str = "service",
                            cost_fingerprint: Optional[str] = None,
                            ) -> Optional[dict]:
    """The ``spec_admit`` gate: forecast the request's cost and
    refuse a deadline that cannot be met — typed `DeadlineInfeasible`
    (counted under ``spec.infeasible``, evented as
    ``deadline_infeasible``) BEFORE any solver iteration burns.
    Unmeasured operators (no spectrum, or no throughput entry) are
    always admitted. Returns the prediction dict (or ``None``) when
    admitted, for the caller to stamp on the request record."""
    if not spec_admit_enabled():
        return None
    pred = admission_prediction(
        fingerprint, dtype, minv_class, tol, r0_norm=r0_norm,
        cost_fingerprint=cost_fingerprint,
    )
    if pred is None or pred["predicted_s"] is None:
        return pred
    if pred["predicted_s"] <= float(deadline_s):
        return pred
    from ..utils.health import DeadlineInfeasible
    from .record import emit_event

    registry().counter("spec.infeasible").inc()
    emit_event(
        "deadline_infeasible", label=tag,
        predicted_s=pred["predicted_s"],
        available_s=float(deadline_s),
        predicted_iters=pred["predicted_iters"],
        s_per_it=pred["s_per_it"],
        fingerprint=fingerprint, where=where,
    )
    raise DeadlineInfeasible(
        f"{where}: request {tag or 'request'} cannot meet its deadline "
        f"— predicted cost {pred['predicted_s']:.6f}s "
        f"({pred['predicted_iters']} iterations x measured "
        f"{pred['s_per_it']:.6f} s/it) exceeds the {deadline_s}s budget"
        " — refused at admission (zero iterations spent); relax the "
        "deadline or tolerance, or turn spec_admit off",
        diagnostics={
            "context": where,
            "tag": tag,
            "predicted_s": pred["predicted_s"],
            "available_s": float(deadline_s),
            "predicted_iters": pred["predicted_iters"],
            "s_per_it": pred["s_per_it"],
            "kappa": pred["kappa"],
            "rate": pred["rate"],
            "fingerprint": fingerprint,
        },
    )
