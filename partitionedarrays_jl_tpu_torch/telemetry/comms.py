"""Model-against-counted comms accounting of the device CG programs
(telemetry/comms.py of the JAX package).

Two independent derivations of "what goes between the parts per solve",
held against each other:

* **Model** — `cg_comms_profile` builds, from the host-side plan objects
  alone (the exchange plan's rounds and slab sizes, the dots' lane
  structure, the body form), the setup and per-iteration collective
  inventory of a CG body; a finished solve reports ``observed = setup +
  per_iteration x iterations`` (`observed_comms`, stamped into its
  `SolveRecord` as ``rec.comms``).
* **Counted** — the port has no lowered program text to read (the JAX
  package reads StableHLO, ``expected_from_report``). Its program is the
  block of loop steps that `parallel/gpu_loop.DeviceLoop` captures. While
  the loop runs its first block, and while the solve function runs its
  setup, every exchange and every dot fold adds itself to a tally
  (`counting`, `count`); the function keeps the result as
  ``fn.comms_counted`` (`counted_profile`: per iteration is the block's
  count divided by the block's size), and the driver that ran it puts it
  on the solve's record beside the model (``rec.comms_counted``). A
  cached solve replays a graph and calls no Python, so nothing is read
  from global counters afterwards.

`reconcile` compares the two at a solve's iteration count, ops and bytes
per kind. The kind names and the dict schema are the JAX package's, so a
record's ``comms`` reads the same in both. On one card the parts are
stacked, so the kinds mean:

* ``collective_permute`` — one exchange round between stacked parts (a
  colour round of the generic plan, a direction of the box plan), its
  bytes the per-part slab the round moves (the generic plan's padded
  max-edge slab, one checksum slot wider under ABFT; the box plan's
  direction segment), times the slab's columns;
* ``all_gather`` — one part-order fold of per-part partials
  (`parallel/gpu.py:_fold_parts`, E3's strict tree, the sweep kernel's
  fold), its bytes ``P·K·lanes·itemsize``: the partials a multi-card run
  would gather.

The model follows the port's bodies, which equal the JAX package's but
in two places: the standard Jacobi body takes r·r and r·z from the
precond sweep's one fold (one 2-lane gather where the JAX body gathers
twice), and on a strict lowering the sweep's fold runs beside E3's dots
(the sweep updates x and r and folds its partials; E3 takes r·r and r·z
again), so a strict body gathers p·q, the sweep's fold, r·r and r·z.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = [
    "COMM_KINDS",
    "cg_comms_profile",
    "observed_comms",
    "reconcile",
    "counting",
    "count",
    "counted_profile",
    "LOWERING_CASES",
    "lowering_cases",
    "probe_system",
    "case_probe_solve",
]

#: The kinds this accounting speaks about (the JAX package's program-report
#: family).
COMM_KINDS = (
    "all_gather",
    "collective_permute",
    "all_reduce",
    "reduce_scatter",
)


def _zero() -> Dict[str, Dict[str, int]]:
    return {k: {"ops": 0, "bytes": 0} for k in COMM_KINDS}


def _add(tbl, kind: str, ops: int, nbytes: int) -> None:
    tbl[kind]["ops"] += int(ops)
    tbl[kind]["bytes"] += int(nbytes)


def _exchange_inventory(dA, abft: bool, K: int, itemsize: int):
    """(ops, bytes) of ONE halo update (combine ``set``) of the matrix's
    column plan: the generic plan's R colour rounds, each the padded
    max-edge slab (one checksum slot wider under ABFT); the box plan's one
    move per direction, each that direction's segment."""
    from ..parallel.gpu_box import BoxExchangePlan

    plan = dA.col_plan
    if isinstance(plan, BoxExchangePlan):
        sizes = [d.size for d in plan.info.dirs]
    else:
        if plan.R == 0:
            return 0, 0
        slot = plan.snd_idx.shape[-1] + (1 if abft else 0)
        sizes = [slot] * plan.R
    return len(sizes), sum(s * K * itemsize for s in sizes)


def cg_comms_profile(
    dA,
    dtype,
    precond: bool = False,
    pipelined: bool = False,
    fused: bool = False,
    rhs_batch: Optional[int] = None,
    sdc: bool = False,
    abft: bool = False,
    sstep: int = 0,
    overlap: bool = False,
    strict: bool = False,
) -> dict:
    """The plan-level collective inventory of one CG body of
    `parallel/gpu.py` (`make_cg_fn`, `make_block_cg_fn`, the defended
    loops of `gpu_sdc.py`, the s-step body): ``{"setup": {kind: {ops,
    bytes}}, "per_iteration": {...}}`` (JAX comms.py:86).

    * every SpMV runs one halo update (`_exchange_inventory`);
    * each dot is one ``all_gather`` of its per-part partials, ``(P,)`` or
      ``(P, K)``; the sweep's fold is one gather of its lanes (r.r, and
      r.z in the precond form);
    * the SDC-defended bodies take p·q through the extra-lane dot
      (`gpu._pdot_extra_factory`): ABFT adds two checksum lanes to that
      one gather, never an op; an audit trip streams its drift through
      the same dot.

    ``sstep >= 2`` gives the s-step body's per-TRIP inventory (``"unit":
    sstep``; `observed_comms` evaluates it at ``iterations // unit``
    trips): per trip ``sstep`` halo updates of the ``(W, 2)`` pair slab
    and one ``(2s+1, 2s+1)`` Gram gather. ``overlap`` reorders the SpMV
    schedule only: no inventory change. ``strict`` (a strict lowering):
    see the module docstring."""
    import numpy as np

    itemsize = int(np.dtype(dtype).itemsize)
    P = dA.row_layout.P
    K = int(rhs_batch) if rhs_batch else 1

    ex_ops, ex_bytes = _exchange_inventory(dA, abft, K, itemsize)

    def ag(tbl, lanes: int) -> None:
        _add(tbl, "all_gather", 1, P * K * lanes * itemsize)

    def exchange(tbl) -> None:
        _add(tbl, "collective_permute", ex_ops, ex_bytes)

    setup = _zero()
    per_it = _zero()

    # ---- setup: the initial residual's SpMV, rs0 (and rz0 with precond)
    exchange(setup)
    ag(setup, 1)
    if precond:
        ag(setup, 1)

    if int(sstep) >= 2:
        s = int(sstep)
        m = 2 * s + 1
        _add(per_it, "collective_permute", s * ex_ops, s * ex_bytes * 2)
        _add(per_it, "all_gather", 1, P * m * m * itemsize)
        return {"setup": setup, "per_iteration": per_it, "unit": s}

    exchange(per_it)  # the body's one SpMV
    ag(per_it, 1 + (2 if sdc and abft else 0))  # p·q (the extra-lane dot)
    if strict:
        ag(per_it, 1)  # the sweep's fold
        ag(per_it, 1)  # r·r by E3
        if precond and not pipelined:
            ag(per_it, 1)  # r·z by E3
    else:
        ag(per_it, 2 if precond and not pipelined else 1)  # the sweep's fold: r·r (and r·z)
    # fused, block and overlap bodies share this inventory
    return {"setup": setup, "per_iteration": per_it}


def observed_comms(profile: dict, iterations: int) -> dict:
    """The accounting of one finished solve: the profile evaluated at the
    solve's iteration count (JAX comms.py:156). An s-step profile
    (``"unit" > 1``) is evaluated at the trip count."""
    it = int(iterations)
    unit = int(profile.get("unit", 1))
    units = it // unit if unit > 1 else it
    obs = _zero()
    for k in COMM_KINDS:
        for field in ("ops", "bytes"):
            obs[k][field] = profile["setup"][k][field] + profile["per_iteration"][k][field] * units
    out = {
        "iterations": it,
        "setup": profile["setup"],
        "per_iteration": profile["per_iteration"],
        "observed": obs,
    }
    if unit > 1:
        out["unit"] = unit
        out["comm_units"] = units
    return out


def reconcile(counted: dict, comms: dict) -> list:
    """Cross-check a solve's accounting (``comms``, the `observed_comms`
    structure on its record) against the counted program (``counted``, the
    solve function's ``comms_counted``) at the solve's iteration count
    (trips for an s-step solve). Returns human-readable mismatch strings
    (empty: they agree)."""
    it = int(comms.get("comm_units", comms["iterations"]))
    out = []
    for k in COMM_KINDS:
        for field in ("ops", "bytes"):
            want = counted["setup"][k][field] + counted["per_iteration"][k][field] * it
            got = comms["observed"][k][field]
            if want != got:
                out.append(
                    f"{k}.{field}: counted program {want} (setup {counted['setup'][k][field]} + "
                    f"{counted['per_iteration'][k][field]}/it x {it} it) != model accounting {got}"
                )
    return out


# ---------------------------------------------------------------------------
# the counted side
# ---------------------------------------------------------------------------

_local = threading.local()


@contextmanager
def counting():
    """A tally ``{kind: {ops, bytes}}`` that every `count` on this thread
    adds into while the block runs (nested tallies all see the counts)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    tally = _zero()
    stack.append(tally)
    try:
        yield tally
    finally:
        stack.pop()  # the innermost: blocks nest on one thread


def count(kind: str, ops: int, nbytes: int) -> None:
    """Add one collective (``ops`` of ``nbytes`` in all) to the active
    tallies of this thread; nothing when none is active."""
    stack = getattr(_local, "stack", None)
    if stack:
        for tally in stack:
            _add(tally, kind, ops, nbytes)


def counted_profile(setup: dict, block_tally: dict, block: int, unit: int = 1) -> dict:
    """The counted program of a solve function in `cg_comms_profile`'s
    schema: its setup's tally, and the tally of one loop block of
    ``block`` steps divided by the block (per step: an iteration, a
    defended trip, or an s-step trip of ``unit`` iterations)."""
    per_it = _zero()
    for k in COMM_KINDS:
        for field in ("ops", "bytes"):
            v = block_tally[k][field]
            if v % block:
                raise ValueError(f"counted_profile: {k}.{field} = {v} is not a whole count a step of {block}")
            per_it[k][field] = v // block
    out = {"setup": {k: dict(v) for k, v in setup.items()}, "per_iteration": per_it}
    if unit > 1:
        out["unit"] = int(unit)
    return out


# ---------------------------------------------------------------------------
# the lowering cases and their probe solves
# ---------------------------------------------------------------------------

#: The JAX package's compiled-CG lowering cases (`lowering_matrix`,
#: tpu.py:6472), as data: the name, the JAX package's environment
#: (``env``, for reference) and the port's keywords of `gpu_cg` /
#: `gpu_block_cg` that select the same body and plan (``options``:
#: ``PA_TPU_BOX=0`` is ``box=False``, ``PA_TPU_ABFT=1`` is
#: ``sdc={"abft": True}`` (an `SDCConfig`'s fields), ``PA_TPU_SSTEP``
#: ``sstep``, ``PA_TPU_OVERLAP`` ``overlap``, ``PA_TPU_STRICT_BITS``
#: ``strict``). ``fast`` marks the tier the JAX package's ``fast=True``
#: returns. The ``twolevel`` case waits for the two-level plans.
LOWERING_CASES = (
    dict(name="standard", fast=True, env={}, options={"fused": False}, dtype="f64",
         tags={"body": "standard"}),
    dict(name="fused", fast=True, env={}, options={"fused": True}, dtype="f64", tags={"body": "fused"}),
    dict(name="block_k1_fused", fast=True, env={}, options={"fused": True, "rhs_batch": 1}, dtype="f64",
         tags={"body": "block", "K": 1, "block_of": "fused"}),
    dict(name="block_k4_fused", fast=True, env={}, options={"fused": True, "rhs_batch": 4}, dtype="f64",
         tags={"body": "block", "K": 4, "block_of": "fused"}),
    dict(name="standard_nobox", fast=True, env={"PA_TPU_BOX": "0"}, options={"fused": False, "box": False},
         dtype="f64", tags={"body": "standard", "plan": "generic"}),
    dict(name="standard_abft", fast=True, env={"PA_TPU_ABFT": "1", "PA_TPU_BOX": "0"},
         options={"fused": False, "box": False, "sdc": {"abft": True}}, dtype="f64",
         tags={"body": "standard", "abft": True, "abft_off": "standard_nobox"}),
    dict(name="standard_f32", fast=True, env={}, options={"fused": False}, dtype="f32",
         tags={"body": "standard", "staged": "f32"}),
    dict(name="sstep2", fast=True, env={"PA_TPU_SSTEP": "2"}, options={"sstep": 2}, dtype="f64",
         tags={"body": "sstep", "s": 2}),
    dict(name="overlap", fast=True, env={"PA_TPU_OVERLAP": "1"}, options={"fused": False, "overlap": True},
         dtype="f64", tags={"body": "standard", "overlap": True, "overlap_off": "standard"}),
    dict(name="block_k1_standard", fast=False, env={}, options={"fused": False, "rhs_batch": 1}, dtype="f64",
         tags={"body": "block", "K": 1, "block_of": "standard"}),
    dict(name="block_k4_standard", fast=False, env={}, options={"fused": False, "rhs_batch": 4}, dtype="f64",
         tags={"body": "block", "K": 4, "block_of": "standard"}),
    dict(name="fused_nobox", fast=False, env={"PA_TPU_BOX": "0"}, options={"fused": True, "box": False},
         dtype="f64", tags={"body": "fused", "plan": "generic"}),
    dict(name="block_k4_fused_nobox", fast=False, env={"PA_TPU_BOX": "0"},
         options={"fused": True, "rhs_batch": 4, "box": False}, dtype="f64",
         tags={"body": "block", "K": 4, "block_of": "fused", "plan": "generic"}),
    dict(name="fused_abft", fast=False, env={"PA_TPU_ABFT": "1", "PA_TPU_BOX": "0"},
         options={"fused": True, "box": False, "sdc": {"abft": True}}, dtype="f64",
         tags={"body": "fused", "abft": True, "abft_off": "fused_nobox"}),
    dict(name="block_k4_fused_abft", fast=False, env={"PA_TPU_ABFT": "1", "PA_TPU_BOX": "0"},
         options={"fused": True, "rhs_batch": 4, "box": False, "sdc": {"abft": True}}, dtype="f64",
         tags={"body": "block", "K": 4, "block_of": "fused", "abft": True, "abft_off": "block_k4_fused_nobox"}),
    dict(name="strict_standard", fast=False, env={"PA_TPU_STRICT_BITS": "1"},
         options={"fused": False, "strict": True}, dtype="f64", tags={"body": "standard", "strict": True}),
    dict(name="fused_f32", fast=False, env={}, options={"fused": True}, dtype="f32",
         tags={"body": "fused", "staged": "f32"}),
)


def lowering_cases(fast: bool = False) -> list:
    """The lowering cases (`LOWERING_CASES`), copies: the tier-1 subset
    with ``fast``, else all."""
    import copy

    return [copy.deepcopy(c) for c in LOWERING_CASES if c["fast"] or not fast]


#: The probe systems, by (backend object, dtype, ns, parts) (`probe_system`):
#: a solve function is cached on its operator, so two backends share no
#: operator and no solve function.
_PROBES: dict = {}


def probe_system(backend, dtype: str = "f64", ns=(6, 6, 6), parts=(2, 2, 2)):
    """The small fixed probe operator every case solves (tpu.py:6565): the
    (6, 6, 6) Poisson system on a (2, 2, 2) box partition, ``(A, b, x0)``
    with the Dirichlet start. Cached per backend and (dtype, ns, parts)."""
    import numpy as np

    from ..models import assemble_poisson
    from ..parallel.backends import prun

    np_dtype = np.float32 if dtype == "f32" else np.float64

    def driver(p):
        A, b, _xe, x0 = assemble_poisson(p, tuple(ns), dtype=np_dtype)
        return A, b, x0

    key = (backend, dtype, tuple(ns), tuple(parts))
    if key not in _PROBES:
        _PROBES[key] = prun(driver, backend, tuple(parts))
    return _PROBES[key]


def case_probe_solve(backend, case: dict, tol: Optional[float] = None, maxiter: int = 50, system=None):
    """Run ``case``'s CG body on the probe system (or ``system``, an
    ``(A, b, x0)``) through the public drivers (`gpu_cg`, `gpu_block_cg`)
    and return ``(record, info)``. The record carries both sides of the
    accounting of the solve function that ran, stamped by the driver: the
    model (``rec.comms``) and the counted program (``rec.comms_counted``),
    the pair `reconcile` compares (tpu.py:6644); the info carries the
    loop's statistics (``info["device_loop"]``)."""
    import importlib

    from ..utils.health import SDCConfig

    # the module itself: the package's ``parallel.gpu`` name is the default backend
    g = importlib.import_module("..parallel.gpu", __package__)
    A, b, x0 = system if system is not None else probe_system(backend, case.get("dtype", "f64"))
    opts = dict(case.get("options", {}))
    K = opts.pop("rhs_batch", None)
    if "sdc" in opts:
        opts["sdc"] = SDCConfig(**opts["sdc"])
    if tol is None:
        tol = 1e-4 if case.get("dtype") == "f32" else 1e-9
    if K:
        _, info = g.gpu_block_cg(A, [b] * K, X0=[x0] * K, tol=tol, maxiter=maxiter, **opts)
    else:
        _, info = g.gpu_cg(A, b, x0=x0, tol=tol, maxiter=maxiter, **opts)
    rec = info.record
    if rec is None or rec.comms is None or rec.comms_counted is None:
        raise RuntimeError("case_probe_solve: the probe solve produced no comms accounting "
                           "(telemetry.configure(metrics=False)?)")
    return rec, info
