"""Phase-attributed solver profiling: where a CG iteration's time goes
(telemetry/profile.py of the JAX package).

Of one CG iteration's time, how much is the SpMV's compute, the halo
exchange, the dots' folds, the update sweep? Two capture methods, one
schema:

* **torch-trace** (``prof_trace`` True or ``"auto"``) — the counterpart of
  the JAX package's ``jax-trace``: one fixed-trip solve under
  `torch.profiler` with CUDA activity, its device kernels bucketed by name
  into the phases (`_bucket`). The port's kernels are bound by ctypes and
  show under their own symbol names (``dia_coded``, ``cg_sweep``, ...);
  the exchange shows as torch's gather, scatter and index kernels; the
  reductions of the dots as torch's reduce kernels and the block dot's
  products. Elementwise kernels (a dot's product, the standard body's
  direction update, the scalar selects) land in ``axpy_sweep``: a name
  does not say which phase a multiply serves. A warm-up step runs before
  the recorded one, and a spin on the card opens the recorded step (a
  trace started right before a solve dropped its first launches). With
  ``"auto"`` a trace with no device time (the CPU) falls back to:
* **split-timer** — each phase timed as its own chain of k steps by the
  marginal protocol (`marginal_s`: two trip counts, differenced), built
  from the operator's own `DeviceMatrix`: the halo exchange
  (`gpu.exchange_`), the full SpMV (`gpu._spmv_body`: K1 on a coded
  operator; the local share is the SpMV less the exchange), one fold dot
  (`gpu._pdot_factory`), and the sweep (`ops/sweep.cg_sweep`). On the
  card each chain is captured in a CUDA graph and timed by CUDA events
  after an L2 flush and a queued spin (`chain_timer`); on the CPU by
  `time.perf_counter`.

Both methods scale to the measured total: the real body's seconds per
iteration at two fixed trip counts (tol 0), differenced.

The profile (schema version 2, the JAX package's) is keyed by the lowering
case's name (`phase_case_name`, the JAX package's names) and the
operator's fingerprint, and carries two checks: the per-phase collective
inventories sum per kind to `telemetry.comms.cg_comms_profile`'s
per-iteration inventory, and the attributed sum divided by the measured
total lies in ``PHASE_SUM_BAND`` (``PHASE_SUM_BAND_WIDE`` for the s-step
and block bodies), `reconcile_phases`.

Profiling builds its own chains and solve functions: it never touches a
solve's path. ``telemetry.configure(prof=False)`` makes
`capture_phase_profile` return None at once, launching nothing.
Switches (`TelemetryConfig`): ``prof`` (``PA_PROF``), ``prof_reps``
(``PA_PROF_REPS``, the repetitions a chain measurement takes the least
of) and ``prof_trace`` (``PA_PROF_TRACE``: True forces the trace and
raises if it holds no device time, False never traces, ``"auto"`` traces
and falls back).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Optional

from .comms import COMM_KINDS, cg_comms_profile
from .config import config

__all__ = [
    "PHASE_SCHEMA_VERSION",
    "PHASES",
    "PHASE_BOUNDARY",
    "PHASE_HALO_SPLIT",
    "PHASE_SUM_BAND",
    "PHASE_SUM_BAND_WIDE",
    "prof_enabled",
    "prof_reps",
    "prof_trace_mode",
    "lowering_descriptor",
    "phase_case_name",
    "phase_case_of",
    "profile_phases",
    "chain_timer",
    "marginal_s",
    "capture_phase_profile",
    "reconcile_phases",
    "phase_trace_events",
    "render_phase_profile",
]

PHASE_SCHEMA_VERSION = 2

#: The attribution axes of one CG iteration; ``spmv_local`` is the SpMV's
#: compute (the full SpMV less its halo update), so the four sum to one
#: iteration's work.
PHASES = ("spmv_local", "halo_exchange", "dot_allgather", "axpy_sweep")

#: The overlap body's extra axis: the boundary-row (A_oh) share of the
#: SpMV's compute, split out of ``spmv_local`` by the interior and
#: boundary nnz counts (a structural attribution, not a timer).
PHASE_BOUNDARY = "boundary_spmv"

#: The JAX package's two-level plans' split of ``halo_exchange`` per
#: fabric; the port reads such profiles (`profile_phases`) and records none.
PHASE_HALO_SPLIT = ("halo_ici", "halo_dcn_agg")

#: The acceptance band of attributed sum / measured total (the JAX
#: package's values): the chains pay per-phase costs the real body's loop
#: amortizes, so the claim is the same scale, not equality.
PHASE_SUM_BAND = (0.15, 6.0)

#: The looser band of the heavier bodies: the s-step trip (basis stacking,
#: the Gram product, the trip-end products) and the block bodies carry
#: work the four chains do not model.
PHASE_SUM_BAND_WIDE = (0.05, 6.0)

#: cycles of the spin queued before a timed span on the card (~0.5 ms at
#: an H100's clock: longer than a launch's host cost)
SPIN_CYCLES = 1_000_000
#: the L2 flush buffer's bytes (an H100's L2 holds 50 MB)
FLUSH_BYTES = 64 * 2**20


def profile_phases(profile: dict) -> tuple:
    """The phase keys of one profile in canonical order: the four axes
    (``halo_exchange`` replaced by the per-fabric split where a JAX
    two-level profile recorded it) and ``boundary_spmv`` where the overlap
    body recorded it."""
    ph = profile.get("phases", {})
    out = []
    for p in PHASES:
        if p == "halo_exchange" and PHASE_HALO_SPLIT[0] in ph:
            out.extend(PHASE_HALO_SPLIT)
        else:
            out.append(p)
    if PHASE_BOUNDARY in ph:
        out.append(PHASE_BOUNDARY)
    return tuple(out)


def prof_enabled() -> bool:
    """The ``prof`` switch: profile capture on."""
    return bool(config().prof)


def prof_reps() -> int:
    """Timed repetitions a chain measurement (``prof_reps``, >= 3)."""
    return max(3, int(config().prof_reps))


def prof_trace_mode():
    """The ``prof_trace`` switch: True, False or ``"auto"``."""
    return config().prof_trace


def lowering_descriptor(dA) -> Dict[str, str]:
    """The operator's lowering as the JAX package names it: the A_oo path
    (``dia-coded``, ``dia`` for the streaming band, ``sd``, ``bsr``,
    ``ell``) and the exchange plan (``box``, ``generic``)."""
    from ..parallel.gpu_box import BoxExchangePlan

    if dA.dia_mode == "coded":
        a_oo = "dia-coded"
    elif dA.dia_mode == "stream":
        a_oo = "dia"
    else:
        a_oo = dA.lowering
    return {"a_oo": a_oo, "plan": "box" if isinstance(dA.col_plan, BoxExchangePlan) else "generic"}


def phase_case_name(fused: bool, rhs_batch: Optional[int] = None, abft: bool = False, sstep: int = 0,
                    overlap: bool = False, twolevel: bool = False) -> str:
    """The lowering case's name a profile is keyed by (the JAX package's
    `lowering_matrix` names: body form, K, mode)."""
    if int(sstep) >= 2:
        return f"sstep{int(sstep)}"
    body = "fused" if fused else "standard"
    name = f"block_k{int(rhs_batch)}_{body}" if rhs_batch else body
    if overlap:
        name = "overlap" if name == "standard" else name + "_overlap"
    if twolevel:
        name = "twolevel" if name == "standard" else name + "_twolevel"
    return name + ("_abft" if abft else "")


def phase_case_of(name: str) -> str:
    """The profile that represents a lowering case's body shape: mode
    suffixes (``_nobox``, ``_abft``, ``_f32``, ``strict_``) share their
    base body's profile."""
    if name.startswith("sstep"):
        return "sstep2"
    if name == "twolevel" or name.endswith("_twolevel"):
        return "twolevel"
    if name == "overlap" or name.endswith("_overlap"):
        return "overlap"
    for k in ("block_k1", "block_k4"):
        if k in name:
            return f"{k}_fused"
    if "fused" in name:
        return "fused"
    return "standard"


# ---------------------------------------------------------------------------
# timing: chains of k steps, the marginal protocol
# ---------------------------------------------------------------------------

_FLUSH = {}


def _flush(device):
    if device not in _FLUSH:
        import torch

        _FLUSH[device] = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    return _FLUSH[device]


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def chain_timer(step: Callable[[], object], device) -> Callable[[int], float]:
    """``timed(k)``: the seconds of one run of ``k`` calls of ``step``. On a
    CUDA device the k calls are captured once into a CUDA graph (after two
    eager warm-up calls; the cyclic GC off during the capture, as
    `gpu_loop.DeviceLoop` captures) and each run replays it between two
    CUDA events, after an L2 flush and a queued spin, so the span holds the
    card's time and no host launch latency. On the CPU the calls run
    eagerly between two `time.perf_counter` reads."""
    import torch

    if device.type != "cuda":
        def timed_cpu(k: int) -> float:
            t = time.perf_counter()
            for _ in range(k):
                step()
            return time.perf_counter() - t

        return timed_cpu
    graphs = {}

    def timed(k: int) -> float:
        if k not in graphs:
            step()
            step()
            torch.cuda.synchronize(device)
            g = torch.cuda.CUDAGraph()
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(g):
                    for _ in range(k):
                        step()
            finally:
                if gc_on:
                    gc.enable()
            graphs[k] = g
            g.replay()
        flush = _flush(device)
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graphs[k].replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    return timed


def marginal_s(timed: Callable[[int], float], k1: int, k2: int, reps: int) -> float:
    """The marginal seconds a step of a chain (JAX profile.py:_marginal_s):
    each trip count warmed twice, the least of ``reps`` runs each, their
    difference over ``k2 - k1`` (what a run costs besides its steps
    cancels). One doubling of ``k2`` absorbs a timer-noise inversion; a
    chain still cheaper than the noise gets the whole chain's bound at the
    last length (an overestimate, which the band absorbs)."""

    def least(k: int) -> float:
        timed(k)
        timed(k)
        return min(timed(k) for _ in range(reps))

    t1 = least(k1)
    kk2 = k2
    for _ in range(2):
        t2 = least(kk2)
        dt = (t2 - t1) / (kk2 - k1)
        if dt > 0:
            return dt
        kk2 *= 2
    return max(t2 / max(kk2 // 2, 1), 1e-12)


def _phase_steps(dA, rhs_batch: Optional[int], torch_dtype) -> Dict[str, Callable]:
    """The four phase chains' steps, built from ``dA``'s own plan and
    operands on frames of its column layout (``(P, W)``, or ``(P, W, K)``
    slabs for a block body): ``exchange`` (`gpu.exchange_`), ``spmv``
    (`gpu._spmv_body`, the exchange included), ``dot`` (one fold dot) and
    ``axpy`` (one CG sweep over x, r)."""
    import importlib

    import torch

    from ..ops import sweep as sw

    g = importlib.import_module("..parallel.gpu", __package__)
    L = dA.col_layout
    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    K = int(rhs_batch) if rhs_batch else 0
    dev = dA.backend.device
    shape = (L.P, L.W, K) if K else (L.P, L.W)
    x = torch.zeros(shape, dtype=torch_dtype, device=dev)
    x[:, L.o0 : L.g0] = 1.0
    body = g._spmv_body(dA, block=bool(K))
    dot = g._block_pdot_factory(o0, n) if K else g._pdot_factory(o0, n)
    r, q, p, xs = (x.clone() for _ in range(4))
    alpha = torch.full((K,) if K else (), 1e-3, dtype=torch_dtype, device=dev)
    live = torch.ones((K,) if K else (), dtype=torch.int32, device=dev)
    part = sw.sweep_partials(r, n, K if K else None)
    sweep = sw.cg_sweep_block if K else sw.cg_sweep
    return {
        "exchange": lambda: g.exchange_(dA.col_plan, x),
        "spmv": lambda: body(x),
        "dot": lambda: dot(x, x),
        "axpy": lambda: sweep(r, q, alpha, live, part, o0, n, x=xs, p=p),
    }


def _body_timer(fns: dict, make_fn: Callable[[int], Callable], args: tuple, device) -> Callable[[int], float]:
    """``timed(k)``: the seconds of one fixed-trip (tol 0) solve of k
    iterations of the real body (its functions cached in ``fns``, one per
    trip count), the host's clock around a synchronised call. The loop runs
    whole blocks; trip counts with equal residues modulo the block make the
    difference whole iterations."""

    def timed(k: int) -> float:
        if k not in fns:
            fns[k] = make_fn(k)
        _sync(device)
        t = time.perf_counter()
        out = fns[k](*args)
        _sync(device)
        dt = time.perf_counter() - t
        it = out[3]
        if not (int(it) == k if not hasattr(it, "__len__") else all(int(v) == k for v in it)):
            raise RuntimeError(f"phase profile: the fixed-trip solve stopped after {it} of {k} iterations")
        return dt

    return timed


#: name fragments of the device kernels each phase takes (`_bucket`), in
#: order of precedence; anything else is an elementwise update
_SPMV_NAMES = ("dia_coded", "dia_stream", "box_stencil", "ell_spmv", "ell_spmm", "bsr_spmv", "bsr_spmm", "spmv",
               "spmm", "bmm_kernel")
_DOT_NAMES = ("block_products", "pairwise_dot", "reduce", "gemm", "cutlass", "xmma")
_HALO_NAMES = ("gather", "scatter", "index")


def _bucket(name: str) -> Optional[str]:
    """The phase of one device kernel by its name, or None for the spin
    that opens the recorded step."""
    n = name.lower()
    if "spin" in n or "sleep" in n or n.startswith("profilerstep"):
        return None
    if "cg_sweep" in n:
        return "axpy_sweep"
    if any(t in n for t in _SPMV_NAMES):
        return "spmv_local"
    if any(t in n for t in _DOT_NAMES):
        return "dot_allgather"
    if any(t in n for t in _HALO_NAMES):
        return "halo_exchange"
    return "axpy_sweep"


def _trace_phase_fractions(fn, args: tuple, device) -> Optional[dict]:
    """One fixed-trip solve under `torch.profiler` (CPU and CUDA activity):
    a warm-up step, then a spin on the card and the recorded step; the
    device kernels' self time bucketed by name (`_bucket`). Returns
    ``{phase: fraction}``, or None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    fn(*args)
    _sync(device)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn(*args)
        _sync(device)
        prof.step()
        if device.type == "cuda":
            torch.cuda._sleep(SPIN_CYCLES)
        _sync(device)
        fn(*args)
        _sync(device)
    buckets = {p: 0.0 for p in PHASES}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        phase = _bucket(e.key)
        if phase is not None:
            buckets[phase] += e.self_device_time_total
    total = sum(buckets.values())
    if total <= 0.0:
        return None
    return {p: v / total for p, v in buckets.items()}


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def capture_phase_profile(A, backend, fused: Optional[bool] = None, precond: bool = False,
                          rhs_batch: Optional[int] = None, k1: int = 4, k2: int = 28, reps: Optional[int] = None,
                          sstep: int = 0, overlap: bool = False, box: bool = True) -> Optional[dict]:
    """One phase profile of the CG body for ``A`` on ``backend`` (the
    module docstring): the schema-versioned dict, or None with
    ``prof=False``. ``box=False`` profiles the generic plan; the method
    follows the ``prof_trace`` switch. The solves are fixed-trip (tol 0)
    from b = 1 and x0 = 0 in A's dtype (minv = 1 with ``precond``);
    ``k1`` and ``k2`` (iterations) should share their residue modulo the
    loop's block of 8.

    ``sstep >= 2`` profiles the s-step body per TRIP (``"unit": sstep``,
    ``measured_s_per_it`` seconds a trip), as its comms inventory counts.
    ``overlap=True`` splits ``boundary_spmv`` out of ``spmv_local`` by the
    interior and boundary nnz counts (``boundary_attribution``)."""
    import importlib

    import numpy as np
    import torch

    from .throughput import operator_fingerprint

    if not prof_enabled():
        return None
    g = importlib.import_module("..parallel.gpu", __package__)
    reps = prof_reps() if reps is None else max(3, int(reps))
    mode = prof_trace_mode()
    dA = g.device_matrix(A, backend, box)
    dtype = np.dtype(A.dtype)
    tdt = getattr(torch, dtype.name)
    dev = backend.device
    L = dA.col_layout
    K = int(rhs_batch) if rhs_batch else 0
    shape = (L.P, L.W, K) if K else (L.P, L.W)
    b = torch.zeros(shape, dtype=tdt, device=dev)
    b[:, L.o0 : L.o0 + L.no_max] = 1.0
    x0 = torch.zeros(shape, dtype=tdt, device=dev)
    args = (b, x0) + ((torch.ones((L.P, L.W), dtype=tdt, device=dev),) if precond else ())
    sstep = int(sstep)
    unit = sstep if sstep >= 2 else 1
    band = PHASE_SUM_BAND_WIDE if (sstep >= 2 or rhs_batch) else PHASE_SUM_BAND

    def make_fn(k):
        return g.make_cg_fn(dA, 0.0, k, fused=fused, precond=precond, rhs_batch=rhs_batch,
                            sstep=sstep or None, overlap=overlap)

    fns: dict = {}
    body = _body_timer(fns, make_fn, args, dev)
    measured = marginal_s(body, k1, k2, reps) * unit
    comms_kwargs = dict(fns[k2].comms_kwargs)
    per_it = cg_comms_profile(dA, dtype, **comms_kwargs)["per_iteration"]
    n_gathers = per_it["all_gather"]["ops"]
    overlap_on = bool(comms_kwargs.get("overlap"))

    method, fractions = "split-timer", None
    if mode is not False:
        fractions = _trace_phase_fractions(fns[k2], args, dev)
        if fractions is not None:
            method = "torch-trace"
        elif mode is True:
            raise RuntimeError("phase profile: the forced trace (prof_trace=True) holds no device time")
    attempts = 1
    if fractions is not None:
        phase_s = {p: fractions[p] * measured for p in PHASES}
    else:
        steps = _phase_steps(dA, rhs_batch, tdt)
        chains = {k: chain_timer(v, dev) for k, v in steps.items()}
        sc = unit * (2 if sstep >= 2 else 1)
        best = None
        for attempts in range(1, 4):
            # a plan of no rounds (one part) exchanges nothing: no chain to time
            t_exch = marginal_s(chains["exchange"], k1, k2, reps) if per_it["collective_permute"]["ops"] else 0.0
            t_spmv = marginal_s(chains["spmv"], k1, k2, reps)
            t_dot1 = marginal_s(chains["dot"], k1, k2, reps)
            t_axpy = marginal_s(chains["axpy"], k1, k2, reps)
            cand = {
                "halo_exchange": sc * t_exch,
                "spmv_local": sc * max(t_spmv - t_exch, 0.0),
                "dot_allgather": n_gathers * t_dot1,
                "axpy_sweep": t_axpy,
            }
            r = sum(cand.values()) / measured if measured > 0 else float("inf")
            dist = abs(math.log(r)) if r > 0 else float("inf")
            if best is None or dist < best[0]:
                best = (dist, cand, measured)
            if band[0] <= r <= band[1]:
                break
            if attempts < 3:
                measured = marginal_s(body, k1, k2, reps) * unit
        _, phase_s, measured = best

    boundary_frac = None
    if overlap_on:
        nnz_oh = int(dA.oh_nnz or 0)
        nnz_all = int(dA.flops_per_spmv // 2)
        boundary_frac = nnz_oh / nnz_all if nnz_all else 0.0
        phase_s = dict(phase_s)
        phase_s[PHASE_BOUNDARY] = boundary_frac * phase_s["spmv_local"]
        phase_s["spmv_local"] = (1.0 - boundary_frac) * phase_s["spmv_local"]

    def _entry(kind, take):
        return {"ops": per_it[kind]["ops"] if take else 0, "bytes": per_it[kind]["bytes"] if take else 0}

    phase_comms = {
        "dot_allgather": {k: _entry(k, k == "all_gather") for k in COMM_KINDS},
        "spmv_local": {k: _entry(k, False) for k in COMM_KINDS},
        "axpy_sweep": {k: _entry(k, False) for k in COMM_KINDS},
        "halo_exchange": {k: _entry(k, k == "collective_permute") for k in COMM_KINDS},
    }
    if overlap_on:
        phase_comms[PHASE_BOUNDARY] = {k: _entry(k, False) for k in COMM_KINDS}
    unattributed = {k: dict(per_it[k]) for k in COMM_KINDS
                    if k not in ("collective_permute", "all_gather") and (per_it[k]["ops"] or per_it[k]["bytes"])}
    attributed = sum(phase_s.values())
    ratio = attributed / measured if measured > 0 else float("inf")
    plist = PHASES + ((PHASE_BOUNDARY,) if overlap_on else ())
    fused_resolved = fns[k2].cg_body == "fused"
    profile = {
        "phase_schema_version": PHASE_SCHEMA_VERSION,
        "case": phase_case_name(fused_resolved, rhs_batch, bool(comms_kwargs.get("abft")), sstep=sstep,
                                overlap=overlap_on),
        "fingerprint": operator_fingerprint(A),
        "lowering": lowering_descriptor(dA),
        "dtype": str(dtype),
        "device": str(dev),
        "method": method,
        "trips": {"k1": int(k1), "k2": int(k2), "reps": int(reps)},
        "attempts": int(attempts),
        "phases": {p: {"s_per_it": round(phase_s[p], 9), "comms": phase_comms[p]} for p in plist},
        "unattributed_comms": unattributed,
        "per_iteration_comms": per_it,
        "comms_kwargs": comms_kwargs,
        "measured_s_per_it": round(measured, 9),
        "attributed_s_per_it": round(attributed, 9),
        "ratio_attributed_over_measured": round(ratio, 6),
        "band": list(band),
        "in_band": bool(band[0] <= ratio <= band[1]),
    }
    if unit > 1:
        profile["unit"] = unit
    if overlap_on:
        profile["boundary_attribution"] = "structural-nnz-split"
        profile["boundary_nnz_fraction"] = round(boundary_frac, 6)
    return profile


# ---------------------------------------------------------------------------
# checks and exports
# ---------------------------------------------------------------------------


def reconcile_phases(profile: dict, dA=None) -> list:
    """A profile (fresh or loaded) against itself and its model
    (JAX profile.py:861). Returns mismatch strings (empty: reconciled):

    1. per kind, the phase inventories (and the unattributed ones) sum to
       the recorded per-iteration inventory;
    2. nothing hides in ``unattributed_comms``;
    3. with ``dA``, the recorded inventory equals a fresh
       `cg_comms_profile` under the profile's ``comms_kwargs``;
    4. the attributed / measured ratio lies in the recorded band."""
    out = []
    if profile.get("phase_schema_version") != PHASE_SCHEMA_VERSION:
        return [f"phase_schema_version {profile.get('phase_schema_version')!r} != {PHASE_SCHEMA_VERSION}"]
    plist = profile_phases(profile)
    per_it = profile["per_iteration_comms"]
    for kind in COMM_KINDS:
        for field in ("ops", "bytes"):
            total = sum(profile["phases"][p]["comms"][kind][field] for p in plist) + profile.get(
                "unattributed_comms", {}).get(kind, {}).get(field, 0)
            if total != per_it[kind][field]:
                out.append(f"{kind}.{field}: phase sum {total} != per-iteration inventory {per_it[kind][field]}")
    if profile.get("unattributed_comms"):
        out.append(f"unattributed collectives present: {sorted(profile['unattributed_comms'])}")
    if dA is not None:
        import numpy as np

        fresh = cg_comms_profile(dA, np.dtype(profile["dtype"]), **dict(profile.get("comms_kwargs") or {}))
        if fresh["per_iteration"] != per_it:
            out.append(f"recorded per-iteration inventory drifted from cg_comms_profile: recorded {per_it} != "
                       f"fresh {fresh['per_iteration']}")
    lo, hi = profile.get("band", PHASE_SUM_BAND)
    ratio = profile["ratio_attributed_over_measured"]
    if not (lo <= ratio <= hi):
        out.append(f"attributed/measured ratio {ratio} outside the pinned band [{lo}, {hi}]")
    if profile.get("in_band") != (lo <= ratio <= hi):
        out.append("in_band flag inconsistent with ratio and band")
    return out


def phase_trace_events(profile: dict, pid: int = 3, iterations: int = 1) -> list:
    """Chrome-trace spans of one profile: ``iterations`` synthetic
    iterations, each phase a consecutive span of its measured s_per_it
    (the ``patrace --phases`` merge feed)."""
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"partitionedarrays_jl_tpu_torch phase profile ({profile.get('case')})"}}]
    t = 0.0
    for it in range(max(1, int(iterations))):
        for p in profile_phases(profile):
            dur = profile["phases"][p]["s_per_it"] * 1e6
            out.append({
                "name": p, "ph": "X", "ts": t, "dur": max(dur, 0.01), "pid": pid, "tid": 0, "cat": "phase",
                "args": {"iteration": it, "case": profile.get("case"), "fingerprint": profile.get("fingerprint"),
                         "comms": profile["phases"][p]["comms"], "method": profile.get("method")},
            })
            t += max(dur, 0.01)
    return out


def render_phase_profile(profile: dict) -> str:
    """The operator-facing phase table."""
    lines = [
        f"phase profile: case={profile['case']} operator={profile['fingerprint']} "
        f"lowering={profile['lowering']['a_oo']}/{profile['lowering']['plan']} method={profile['method']}",
    ]
    total = profile["attributed_s_per_it"]
    for p in profile_phases(profile):
        ph = profile["phases"][p]
        share = ph["s_per_it"] / total if total > 0 else 0.0
        comms = ", ".join(f"{k}:{v['ops']} ops/{v['bytes']} B" for k, v in ph["comms"].items() if v["ops"])
        lines.append(f"  {p:14s} {ph['s_per_it'] * 1e6:12.2f} us/it ({share:6.1%})" + (f"  [{comms}]" if comms else ""))
    lines.append(
        f"  {'attributed':14s} {total * 1e6:12.2f} us/it vs measured {profile['measured_s_per_it'] * 1e6:.2f} us/it "
        f"(ratio {profile['ratio_attributed_over_measured']:.3f}, band {profile['band']}, "
        f"{'in band' if profile['in_band'] else 'OUT OF BAND'})"
    )
    return "\n".join(lines)
