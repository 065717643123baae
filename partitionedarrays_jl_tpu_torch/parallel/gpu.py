"""GPU backend: the parts of a partition stacked on one CUDA card (L3').

The counterpart of `partitionedarrays_jl_tpu/parallel/tpu.py`, cut to the
Poisson CG, multigrid and unstructured-elasticity slices (the rest of the
Krylov family is `gpu_krylov.py`):

* **Planning on the host.** `GPUData` extends the sequential PData, so
  PRange construction, Exchanger build and COO assembly run unchanged; only
  the hot-path arrays live on the card.
* **Stacked parts.** All P parts sit on one device as ``(P, W)`` tensors in
  the compact layout ``[owned | ghosts | trash]`` (`DeviceLayout`); on a
  Cartesian partition the ghosts are laid out in per-direction segments
  (the box layout, `gpu_box.py`).
* **Halo exchange.** On the box layout the Exchanger is lowered to slab
  moves, one per direction and box shape (`gpu_box.BoxExchangePlan`);
  otherwise to colour rounds (`DeviceExchangePlan`): per round one gather
  of the send slots, one copy between parts, one scatter into the ghost
  slots, the trash slot zeroed after each round. ``box=False`` keeps the
  generic layout and plan on any partition.
* **Operator.** `DeviceMatrix` lowers a PSparseMatrix's owned block A_oo
  to the coded-DIA form (codebook + nibble-packed per-row codes) or, for a
  band of variable coefficients, the streaming-DIA form (dense
  per-diagonal values), both run by the CUDA kernels of `ops/dia.py`; an
  operator that is no band (an unstructured FE operator) to supernode-dense
  groups, node blocks or padded ELL (`gpu_irregular.py`, products in
  `ops/irregular.py`). Its ghost block A_oh lives on the boundary rows, as
  node blocks or compact boundary-row ELL.
* **Halo exchange.** Combine ``set`` (owner -> ghost) and ``add`` (ghost
  -> owner assembly, over the reversed plan).
* **CG.** `make_cg_fn` runs the textbook, the fused (direction fold riding
  the SpMV kernel) or the pipelined body (the lagged solution update
  riding the SpMV kernel) as a device-resident loop (`gpu_loop.py`: the
  stopping test a device flag, blocks of iterations replayed as a CUDA
  graph); x and r are updated and r.r taken in one sweep kernel
  (`ops/sweep.py`); dots are per-part partials folded in part order.
  Multigrid on the card is `parallel/gpu_gmg.py`.
* **The solve cache.** `_krylov_fn_for` keeps one solve function per
  key on the `DeviceMatrix` (tpu.py:6308-6392): a second `gpu_cg`,
  `gpu_block_cg` or solve of `gpu_krylov.py` (BiCGStab, GMRES, MINRES,
  Chebyshev, the differentiable solve) with the same key replays the
  captured loop and builds nothing.
* **Block solves.** `make_block_cg_fn` / `gpu_block_cg` run K
  right-hand sides over ``(P, W, K)`` slabs on every lowering, the
  operator read once an iteration for all K (the slab forms of the
  products).
* **Strict bits.** ``strict=True`` (the JAX package's
  ``PA_TPU_STRICT_BITS=1``, a keyword here) lowers to ELL on the generic
  plan and takes every dot through the fixed pairwise tree (E3): the
  solve is then the host's strict loop bit for bit; a strict block solve
  gives each column its strict solo loop bit for bit.
* **s-step CG and the overlap tail.** ``sstep=s`` runs the
  communication-avoiding body (`_make_sstep_cg_fn`: s pair SpMVs of the
  ``(P, W, 2)`` slab ``[p | r]`` a trip, each exchanged through the
  operator's own plan, one Gram reduction); ``overlap=True`` runs each
  SpMV's halo exchange on a side stream beside its A_oo product
  (`_overlapped`) where the body's schedule allows it.

The device defaults to ``cuda``; with no card it raises at first use and
never falls back to the CPU. Tests pass ``GPUBackend(device="cpu")``, where
every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops import dia
from ..ops.sparse import CSRMatrix, ELLMatrix
from ..telemetry import comms as tcomms
from ..utils.helpers import check, krylov_info, warn_tol_below_floor
from ..utils.table import INDEX_DTYPE
from .backends import AbstractBackend, PartShape, _as_shape
from .exchanger import Exchanger
from .prange import PRange
from .psparse import PSparseMatrix
from .pvector import PVector, _ghost, _owned
from .sequential import SequentialData


class GPUBackend(AbstractBackend):
    """All parts on one torch device, ``cuda`` unless the caller names
    another (``GPUBackend(device="cpu")`` runs the plain versions)."""

    def __init__(self, device=None):
        self._requested = device

    @property
    def device(self) -> torch.device:
        dev = torch.device("cuda" if self._requested is None else self._requested)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GPUBackend: no CUDA device is available; pass "
                "GPUBackend(device='cpu') to run on the CPU"
            )
        return dev

    def get_part_ids(self, nparts: PartShape) -> "GPUData":
        self.device  # validate the device before any planning starts
        shape = _as_shape(nparts)
        return GPUData(list(range(math.prod(shape))), shape, self)

    def __repr__(self):
        return f"GPUBackend(device={self._requested or 'cuda'})"


#: Default instance, the counterpart of `pa.tpu` (first use needs a card).
gpu = GPUBackend()


class GPUData(SequentialData):
    """Host-side per-part values under the GPU backend: planning values
    live on the host exactly as in the sequential backend."""

    __slots__ = ("_backend",)

    def __init__(self, parts, shape=None, backend: GPUBackend = None):
        super().__init__(parts, shape)
        self._backend = backend if backend is not None else gpu

    @property
    def backend(self) -> GPUBackend:
        return self._backend

    def _like(self, parts: list) -> "GPUData":
        return GPUData(parts, self._shape, self._backend)


# ---------------------------------------------------------------------------
# layout, vectors, exchange
# ---------------------------------------------------------------------------


class DeviceLayout:
    """Compact slot layout of every device object over one PRange:
    ``[owned (padded to no_max) | ghosts | trash]`` (tpu.py:260). The
    generic layout keeps the ghosts in hid order, padded to nh_max; under
    a box layout (``box_info``, `gpu_box.py`) the ghost region is the
    per-direction segments, ``nh_total`` slots, and hids reach their
    slots through ``lid_slots``/``hid_slots`` only (host lid order is
    untouched). Padding stays zero by construction, except orphan segment
    slots of a box layout, which hold sender values after a forward
    exchange and are real only where ``box_info.seg_mask`` is True; the
    trash slot absorbs masked scatter lanes."""

    __slots__ = ("P", "W", "no_max", "nh_max", "noids", "nhids", "lid_slots",
                 "hid_slots", "o0", "g0", "box_info")

    def __init__(self, rows: PRange, box_info=None):
        isets = rows.partition.part_values()
        self.P = len(isets)
        self.noids = np.array([i.num_oids for i in isets], dtype=np.int64)
        self.nhids = np.array([i.num_hids for i in isets], dtype=np.int64)
        self.no_max = int(self.noids.max())
        self.nh_max = int(self.nhids.max()) if self.P else 0
        self.box_info = box_info
        # the segment frame can be wider than nh_max (segments of absent
        # neighbours stay zero)
        nh_span = box_info.nh_total if box_info is not None else self.nh_max
        self.o0 = 0
        self.g0 = self.no_max
        self.W = self.no_max + nh_span + 1
        self.lid_slots = []
        self.hid_slots = []  # ghost slots in hid order
        for p, i in enumerate(isets):
            ohid = np.asarray(i.lid_to_ohid)
            if box_info is not None:
                rel = box_info.ghost_rel_slots[p]
                gslot = self.g0 + (rel[np.clip(-ohid - 1, 0, rel.size - 1)] if rel.size else np.zeros_like(ohid))
            else:
                gslot = self.g0 + (-ohid - 1)
            slots = np.where(ohid >= 0, self.o0 + ohid, gslot).astype(INDEX_DTYPE)
            self.lid_slots.append(slots)
            h = ohid < 0
            hs = np.empty(int(self.nhids[p]), dtype=INDEX_DTYPE)
            hs[-ohid[h] - 1] = slots[h]
            self.hid_slots.append(hs)

    @property
    def trash(self) -> int:
        return self.W - 1


def device_layout(rows: PRange, box: bool = True) -> DeviceLayout:
    """The layout of a PRange, cached on it per ``box`` (invalidated with
    its exchanger when ghosts are added). With ``box`` (the default, as
    the JAX package's ``PA_TPU_BOX``) a Cartesian partition whose halo
    `gpu_box.box_structure` detects gets the box layout; anything else,
    and ``box=False``, the generic one (tpu.py:1169-1180)."""
    from .gpu_box import box_structure

    cache = getattr(rows, "_device_layout", None)
    if cache is None:
        cache = rows._device_layout = {}
    if box not in cache:
        info = box_structure(rows) if box else None
        if box and info is None:
            cache[box] = device_layout(rows, False)  # no box structure: the generic layout
        else:
            cache[box] = DeviceLayout(rows, box_info=info)
    return cache[box]


def _color_edges(edges):
    """Greedy edge colouring of the directed neighbour graph into rounds in
    which each part sends to at most one part and receives from at most
    one (tpu.py:339)."""
    edges = sorted(edges, key=lambda e: -len(e[2]))  # big payloads first
    rounds = []
    for src, dst, snd, rcv in edges:
        for r in rounds:
            if all(s != src for s, _, _, _ in r) and all(d != dst for _, d, _, _ in r):
                r.append((src, dst, snd, rcv))
                break
        else:
            rounds.append([(src, dst, snd, rcv)])
    return rounds


def _exchange_edges(exchanger: Exchanger, layout: DeviceLayout) -> list:
    """The directed slot-level edges ``(src, dst, snd_slots, rcv_slots)``
    of an Exchanger over a layout (tpu.py:359)."""
    edges = []
    parts_snd = exchanger.parts_snd.part_values()
    parts_rcv = exchanger.parts_rcv.part_values()
    lids_snd = exchanger.lids_snd.part_values()
    lids_rcv = exchanger.lids_rcv.part_values()
    for p in range(layout.P):
        for j, q in enumerate(np.asarray(parts_snd[p])):
            q = int(q)
            hits = np.nonzero(np.asarray(parts_rcv[q]) == p)[0]
            check(len(hits) == 1, "device plan: inconsistent neighbor graphs")
            i = int(hits[0])
            snd_slots = layout.lid_slots[p][lids_snd[p][j]]
            rcv_slots = layout.lid_slots[q][lids_rcv[q][i]]
            check(len(snd_slots) == len(rcv_slots), "device plan: edge size mismatch")
            edges.append((p, q, snd_slots, rcv_slots))
    return edges


class DeviceExchangePlan:
    """Static halo-exchange program on stacked ``(P, W)`` tensors: R
    colour rounds of (gather send slots, copy sender -> receiver, scatter
    into ghost slots), staged on the backend's device."""

    __slots__ = ("layout", "R", "L", "snd_idx", "snd_mask", "rcv_idx", "src_of", "perms")

    def __init__(self, exchanger: Exchanger, layout: DeviceLayout, device):
        P = layout.P
        edges = _exchange_edges(exchanger, layout)
        rounds = _color_edges(edges)
        self.layout = layout
        self.R = len(rounds)
        self.L = max((len(e[2]) for e in edges), default=0)
        R, L = max(self.R, 1), max(self.L, 1)
        # per round contiguous (R, P, L) index blocks
        si = np.zeros((R, P, L), dtype=np.int64)
        sm = np.zeros((R, P, L), dtype=bool)
        ri = np.full((R, P, L), layout.trash, dtype=np.int64)
        # receiver q of round r takes sender src_of[r, q]'s buffer; a part
        # that receives nothing copies its own buffer into its trash slot
        src_of = np.tile(np.arange(P, dtype=np.int64), (R, 1))
        perms = []
        for r, edges_r in enumerate(rounds):
            for src, dst, snd, rcv in edges_r:
                k = len(snd)
                si[r, src, :k] = snd
                sm[r, src, :k] = True
                ri[r, dst, :k] = rcv
                src_of[r, dst] = src
            perms.append(tuple((src, dst) for src, dst, _, _ in edges_r))
        #: the (sender, receiver) pairs of each round, in colouring order
        #: (the JAX plan's ``perms``: the comms matrix's edge rows)
        self.perms = tuple(perms)
        self.snd_idx = torch.from_numpy(si).to(device)
        self.snd_mask = torch.from_numpy(sm).to(device)
        self.rcv_idx = torch.from_numpy(ri).to(device)
        self.src_of = torch.from_numpy(src_of).to(device)


def device_exchange_plan(rows: PRange, backend: GPUBackend, reverse: bool = False,
                         box: bool = True):
    """The halo plan of a PRange on a backend's device, cached on it
    (tpu.py:1228-1300): the box plan (`gpu_box.BoxExchangePlan`) over a
    box layout, else the generic colour-round plan. ``reverse`` gives the
    ghost -> owner assembly plan (for combine ``add``): the box plan's
    reverse, or the generic plan of ``rows.exchanger.reverse()``. With
    `analysis.plan_verifier`'s config ``enabled``, a forward plan is
    verified when it is built (a reverse plan mirrors a forward one whose
    exchanger the same gate verified) and a defect raises
    `PlanSoundnessError` before any exchange runs over it."""
    from ..analysis.plan_verifier import check_plan, plan_verify_enabled
    from .gpu_box import BoxExchangePlan

    cache = getattr(rows, "_device_plan", None)
    if cache is None:
        cache = rows._device_plan = {}
    layout = device_layout(rows, box)
    key = (backend, reverse, layout.box_info is not None)
    if key not in cache:
        if layout.box_info is not None:
            fwd = (backend, False, True)
            if fwd not in cache:
                plan = BoxExchangePlan(layout, layout.box_info, backend.device)
                if plan_verify_enabled():
                    check_plan(plan, context="device_exchange_plan")
                cache[fwd] = plan
            if reverse:
                cache[key] = cache[fwd].reverse()
        else:
            ex = rows.exchanger.reverse() if reverse else rows.exchanger
            plan = DeviceExchangePlan(ex, layout, backend.device)
            if plan_verify_enabled() and not reverse:
                check_plan(plan, context="device_exchange_plan")
            cache[key] = plan
    return cache[key]


def _slot_index(idx: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """A (P, L) slot index for gather/scatter along dim 1 of xv: as it is
    for a (P, W) frame, repeated over the columns of a (P, W, K) slab."""
    return idx if xv.dim() == 2 else idx[..., None].expand(*idx.shape, xv.shape[2])


#: halo exchanges (`exchange_` calls) and their rounds since the last
#: reset (a generic plan's colour rounds, a box plan's directions): the
#: structural count the ABFT launch-parity checks compare (the rounds are
#: eager torch ops, which `dia.LAUNCHES` does not count)
EXCHANGES = {"calls": 0, "rounds": 0}


def exchange_(plan, xv: torch.Tensor, combine: str = "set", abft: bool = False):
    """The plan's exchange on a stacked ``(P, W)`` tensor, or a ``(P, W,
    K)`` slab of K columns, in place (tpu.py:_shard_exchange): combine
    ``set`` is the owner -> ghost halo update; ``add`` (over a reversed
    plan) accumulates ghost contributions into their owners and then zeroes
    the ghost region. A box plan runs `gpu_box.box_exchange_`; the generic
    plan runs its colour rounds, the trash slot zeroed after every round.
    A slab moves the same slots in the same order for every column, so
    column k of a slab exchange is the exchange of column k, bit for bit.

    ``abft=True`` (generic plan only, tpu.py:617-728) returns ``(xv,
    delta, scale)``: each round the sender's slab sum travels with its slab
    and the receiver adds ``|Σ received - shipped sum|`` into ``delta`` and
    the abs-sums into ``scale``, per part (``(P,)``, or ``(P, K)`` for a
    slab). The same rounds move the same values: the exchanged tensor is
    bit for bit the unchecked one's.

    Every round counts in `EXCHANGES` and, as one ``collective_permute``
    of its per-part slab (the generic plan's padded max-edge slab, one
    checksum slot wider under ``abft``; the box plan's direction segment)
    times the slab's columns, in the active `telemetry.comms` tallies."""
    from .gpu_box import BoxExchangePlan, box_exchange_

    check(combine in ("set", "add"), "exchange_: combine is 'set' or 'add'")
    EXCHANGES["calls"] += 1
    cols = xv.shape[2] if xv.dim() == 3 else 1
    if isinstance(plan, BoxExchangePlan):
        check(not abft, "ABFT exchange checksums require the generic plan")
        EXCHANGES["rounds"] += plan.R
        tcomms.count("collective_permute", plan.R,
                     sum(d.size for d in plan.info.dirs) * cols * xv.element_size())
        return box_exchange_(plan, xv, combine)
    if abft:
        delta = xv.new_zeros((xv.shape[0],) + tuple(xv.shape[2:]))
        scale = xv.new_zeros((xv.shape[0],) + tuple(xv.shape[2:]))
    slab_bytes = (plan.snd_idx.shape[-1] + (1 if abft else 0)) * cols * xv.element_size()
    for r in range(plan.R):
        EXCHANGES["rounds"] += 1
        tcomms.count("collective_permute", 1, slab_bytes)
        sent, buf = exchange_round_(plan, r, xv, combine)
        if abft:
            # the sender's sum rides with its slab; the receiver re-sums
            rcs = sent.sum(dim=1)[plan.src_of[r]]
            delta = delta + (buf.sum(dim=1) - rcs).abs()
            scale = scale + buf.abs().sum(dim=1) + rcs.abs()
    if combine == "add":
        xv[:, plan.layout.g0 :] = 0  # ghost contributions now live on owners
    return (xv, delta, scale) if abft else xv


def exchange_round_(plan: DeviceExchangePlan, r: int, xv: torch.Tensor, combine: str = "set"):
    """Round ``r`` of a generic plan on a stacked frame or slab, in place:
    the senders' slots gathered (masked), copied to their receivers,
    scattered (``set``) or added (``add``) into the ghost slots, the trash
    slot zeroed. Returns the sent slab and the received one, which the
    ABFT checksums sum (and the comms matrix times one round alone)."""
    mask = plan.snd_mask[r] if xv.dim() == 2 else plan.snd_mask[r][..., None]
    sent = torch.where(mask, xv.gather(1, _slot_index(plan.snd_idx[r], xv)), 0)
    buf = sent[plan.src_of[r]]
    if combine == "add":
        xv.scatter_add_(1, _slot_index(plan.rcv_idx[r], xv), buf)
    else:
        xv.scatter_(1, _slot_index(plan.rcv_idx[r], xv), buf)
    xv[:, plan.layout.trash] = 0  # keep the trash slot clean
    return sent, buf


def make_exchange_fn(rows: PRange, backend: GPUBackend, combine: str = "set") -> Callable:
    """The halo update of vectors over `rows` as a function of the
    stacked ``(P, W)`` tensor (updated in place and returned): ghosts made
    current (``combine="set"``, exchange!) or ghost values added into their
    owners over the reverse plan (``combine="add"``, assemble!)."""
    check(combine in ("set", "add"), f"make_exchange_fn: combine must be 'set' or 'add', got {combine!r}")
    plan = device_exchange_plan(rows, backend, reverse=combine == "add")
    return lambda xv: exchange_(plan, xv, combine)


class DeviceVector:
    """A PVector lowered to one ``(P, W)`` tensor on the backend's device."""

    __slots__ = ("data", "rows", "layout", "backend")

    def __init__(self, data: torch.Tensor, rows: PRange, layout: DeviceLayout, backend: GPUBackend):
        self.data = data
        self.rows = rows
        self.layout = layout
        self.backend = backend

    @classmethod
    def from_pvector(cls, v: PVector, backend: GPUBackend, layout=None) -> "DeviceVector":
        layout = layout or device_layout(v.rows)
        stacked = np.zeros((layout.P, layout.W), dtype=v.dtype)
        for p, (iset, vals) in enumerate(
            zip(v.rows.partition.part_values(), v.values.part_values())
        ):
            vals = np.asarray(vals)
            stacked[p, layout.o0 : layout.o0 + iset.num_oids] = _owned(iset, vals)
            stacked[p, layout.hid_slots[p]] = _ghost(iset, vals)
        return cls(torch.from_numpy(stacked).to(backend.device), v.rows, layout, backend)

    def to_pvector(self) -> PVector:
        host = self.data.cpu().numpy()
        o0 = self.layout.o0
        vals = []
        for p, iset in enumerate(self.rows.partition.part_values()):
            owned = host[p, o0 : o0 + iset.num_oids]
            ghost = host[p, self.layout.hid_slots[p]]
            if iset.owned_first:
                v = np.concatenate([owned, ghost])
            else:
                v = np.empty(iset.num_lids, dtype=host.dtype)
                v[np.asarray(iset.oid_to_lid)] = owned
                v[np.asarray(iset.hid_to_lid)] = ghost
            vals.append(v)
        return PVector(self.rows.partition._like(vals), self.rows)


# ---------------------------------------------------------------------------
# band analysis: the plain versions of the native layer's band_offsets,
# unique_small and row_classes, which `DeviceMatrix._detect_dia` takes
# where `native.ENABLED` is off
# ---------------------------------------------------------------------------


def band_offsets(indptr, cols, m: int, K: int):
    """Sorted distinct band offsets (j - i) of a CSR, capped at K: returns
    ``(offsets, ok)``, ok=False when more than K exist. Counted with one
    bincount over the offset range (no sort of the nonzeros)."""
    ip = np.asarray(indptr)
    r = np.repeat(np.arange(m, dtype=np.int64), np.diff(ip[: m + 1]))
    d = np.asarray(cols, dtype=np.int64) - r
    lo = int(d.min())
    u = np.flatnonzero(np.bincount(d - lo)) + lo
    return (u, True) if len(u) <= K else (None, False)


def unique_small(vals: np.ndarray, K: int):
    """Sorted distinct values of a 1-D array and whether there are at most K."""
    u = np.unique(np.asarray(vals, dtype=np.float64))
    return u, len(u) <= K


def row_classes(dia_p: np.ndarray, n: int, K: int):
    """Row classes (distinct column tuples) of dia_p[:, :n], capped at K:
    ``(class_table, codes, ok)`` with classes in lexicographic order.
    Rows with distinct projections on a fixed random direction are
    distinct, so more than K distinct projections refuse without sorting
    the rows themselves. Otherwise the projection's classes are the row
    classes once every row equals its class's first row exactly (one
    vectorised comparison), and only those few representatives are sorted
    into lexicographic order; a projection that merges distinct rows takes
    the exact sort of all rows (`_row_classes_exact`). Both give the same
    table and codes."""
    rows = dia_p[:, :n].T
    w = np.random.default_rng(0).standard_normal(rows.shape[1])
    pu, pinv = np.unique(rows @ w, return_inverse=True)
    if len(pu) > K:
        return None, None, False
    pinv = pinv.reshape(-1)
    first = np.full(len(pu), n, dtype=np.int64)
    np.minimum.at(first, pinv, np.arange(n, dtype=np.int64))
    reps = rows[first]
    if not np.array_equal(rows, reps[pinv]):
        return _row_classes_exact(rows, K)
    u, rinv = np.unique(reps, axis=0, return_inverse=True)
    return u, rinv.reshape(-1)[pinv].astype(np.uint8), True


def _row_classes_exact(rows: np.ndarray, K: int):
    """`row_classes` by a lexicographic sort of all the rows."""
    u, inv = np.unique(rows, axis=0, return_inverse=True)
    if len(u) > K:
        return None, None, False
    return u, inv.reshape(-1).astype(np.uint8), True


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


#: the lowerings a caller may ask for (`DeviceMatrix`'s ``lowering``)
LOWERINGS = ("auto", "sd", "bsr", "ell")


class DeviceMatrix:
    """A PSparseMatrix lowered for the card (tpu.py:1366-1487), named in
    ``lowering``. A_oo as a band when it is one: a coded-DIA operand
    (`ops/dia.py:CodedOperator`, ``"coded"``) when every diagonal holds few
    distinct values, or dense per-diagonal values ``(P, D, no_max)``
    (``"stream"``, tpu.py:1688-1726 in its off-TPU form) otherwise; both
    set ``dia_mode``. Any other A_oo takes, in the JAX package's order off
    a TPU, the supernode-dense groups (``"sd"``: ``sd_idx``, ``sd_vals``
    per width bucket), node blocks (``"bsr"``: ``bsr_vals`` and int32
    ``bsr_cols`` slot-major, ``bsr_counts`` the real blocks a node row)
    or padded ELL (``"ell"``: ``oo_vals``, ``oo_cols``, slot-major), staged by
    `gpu_irregular`; the keyword ``lowering`` ("auto", "sd", "bsr", "ell")
    names the first of those tried. A_oh lives on the boundary rows only:
    node blocks of the SD/BSR block size where the ghosts arrive as whole
    nodes (``ohb_*``), else boundary-row ELL (``oh_*``). With ``box`` (the
    default) the column range takes the box layout and plan where
    `gpu_box` detects one (tpu.py:1264-1283). ``strict`` (strict-bits
    mode) forces the ELL lowering and the generic plan: every product is
    then the host's strict `csr_spmv` + `mul_into` order, bit for bit."""

    #: most band offsets of the DIA form (tpu.py:DeviceMatrix)
    DIA_MAX_OFFSETS = 64
    #: most distinct values per diagonal (and row classes) of the coded form
    CODE_MAX_VALUES = 8

    def __init__(self, A: PSparseMatrix, backend: GPUBackend, box: bool = True, strict: bool = False,
                 lowering: str = "auto"):
        check(lowering in LOWERINGS, f"DeviceMatrix: lowering is one of {LOWERINGS}, got {lowering!r}")
        #: the solve functions built on this operator (`_krylov_fn_for`)
        self._fn_cache = {}
        #: the ABFT checksum row, staged by the first SDC solve that asks
        #: for it (`abft_row`)
        self.abft_w = None
        self._source = A
        if strict:
            # strict mode: the ELL lowering, whose two-phase left-to-right
            # fold is the host's csr_spmv + mul_into order, and the generic
            # exchange plan (tpu.py:1363-1367, :791-805)
            check(lowering in ("auto", "ell"), "DeviceMatrix: strict mode takes the ELL lowering")
            lowering, box = "ell", False
        isets = A.rows.partition.part_values()
        P = len(isets)
        noids = np.array([i.num_oids for i in isets], dtype=np.int64)
        no_max = int(noids.max()) if P else 0
        dt = A.dtype
        det = oo = oh = None
        full = A.values.part_values()
        if not strict and native.available() and A._blocks is None and all(
            full[p].shape[0] == int(noids[p]) for p in range(P)
        ):
            # no-split analysis (tpu.py:1368-1406): the band read straight
            # off each part's full CSR, its sorted ghost tail skipped by
            # column limit, and only the surface-sized A_oh extracted; the
            # owned/ghost block split would copy the whole operator
            det = self._detect_dia(A, full, P, noids, no_max, col_limits=noids, fused_only=True)
            if det is not None:
                oh = []
                for p in range(P):
                    M = full[p]
                    ip_hi, c_hi, v_hi = native.csr_extract_hi(M.indptr, M.indices, M.data, M.shape[0], int(noids[p]))
                    oh.append(CSRMatrix(ip_hi, c_hi, v_hi, (M.shape[0], M.shape[1] - int(noids[p]))))
        if det is None:
            oo = A.owned_owned_values.part_values()
            oh = A.owned_ghost_values.part_values()
            if not strict:
                det = self._detect_dia(A, oo, P, noids, no_max)
        self.strict = bool(strict)
        #: no ``lowering`` changes this staging: a band (or, set by
        #: `_stage_irregular`, a rectangular A_oo, which takes ELL)
        self.lowering_free = det is not None
        self.rows, self.cols = A.rows, A.cols
        self.backend = backend
        self.row_layout = device_layout(A.rows, box)
        self.col_layout = device_layout(A.cols, box)
        check(self.row_layout.no_max == no_max, "rows layout mismatch")
        self.col_plan = device_exchange_plan(A.cols, backend, box=box)
        self.flops_per_spmv = 2 * sum(full[p].nnz for p in range(P))

        self.coded = self.stream_vals = self.stream_no = self.stream_form = None
        self.dia_kk = self.dia_code_row = self.dia_cls_pattern = None
        self.dia_mode = self.dia_offsets = None
        self.sd_bs = self.sd_g = self.sd_idx = self.sd_vals = None
        self.bsr_bs = self.bsr_cols = self.bsr_vals = self.bsr_counts = None
        self.oo_vals = self.oo_cols = None
        if det is None:
            self._stage_irregular(oo, P, noids, no_max, dt, lowering)
        self._stage_boundary(A, oh, P, dt)
        if det is None:
            return
        dev = backend.device
        self.lowering = "coded" if det["coded_ok"] else "stream"

        self.dia_offsets = tuple(int(o) for o in det["offsets"])
        if not det["coded_ok"]:
            # streaming-DIA staging: the dense per-diagonal values,
            # diagonal-major so a kernel's neighbouring rows read
            # neighbouring values
            self.dia_mode = "stream"
            self.stream_vals = torch.from_numpy(
                np.ascontiguousarray(self._dense_dia(A.owned_owned_values.part_values(), P, no_max,
                                                    det["offsets"]).astype(dt))
                if det["dia"] is None else np.ascontiguousarray(det["dia"].astype(dt))
            ).to(dev)
            self.stream_no = torch.from_numpy(noids.astype(np.int32)).to(dev)
            # the kernel's form, by shape (ops/dia.py:stream_form)
            self.stream_form = dia.stream_form(P, no_max, self.stream_vals.element_size(), dia.sm_count(dev))
            return

        # coded-DIA staging (tpu.py:1584-1687)
        offsets, dia_, uniq, kk = det["offsets"], det["dia"], det["uniq"], det["kk"]
        code_row, coded, Dc = det["code_row"], det["coded"], det["Dc"]
        cls_uniq, cls_ids = det["cls_uniq"], det["cls_ids"]
        D = len(offsets)
        kmax = max(kk)
        cb = np.zeros((P, D, kmax))
        for p in range(P):
            for d in range(D):
                if cls_uniq is not None and code_row[d] >= 0:
                    u = cls_uniq[p][:, d]  # slot k = d's value in class k
                else:
                    u = uniq[p][d]
                if len(u) == 0:
                    u = np.zeros(1)
                cb[p, d, : len(u)] = u
                cb[p, d, len(u):] = u[0]
        n_streams = 1 if cls_uniq is not None else max(Dc, 1)
        codes = np.zeros((P, n_streams, no_max), dtype=np.uint8)
        if cls_uniq is not None:
            codes[:, 0, :] = cls_ids
        elif dia_ is None:
            # the fused analysis: a diagonal's codes through the class ->
            # code map of its few classes (dia[p, d, r] is
            # cls_tables[p][cls_codes[p, r], d]; tpu.py:1629-1651); rows
            # past a part's owned count stay code 0, masked by `no`
            for p in range(P):
                n_o = int(noids[p])
                for j, d in enumerate(coded):
                    u = uniq[p][d]
                    if len(u):
                        m_ = np.clip(np.searchsorted(u, det["cls_tables"][p][:, d]), 0, len(u) - 1).astype(np.uint8)
                        codes[p, j, :n_o] = m_[det["cls_codes"][p, :n_o]]
        else:
            for p in range(P):
                for j, d in enumerate(coded):
                    u = uniq[p][d]
                    if len(u):
                        codes[p, j] = np.clip(np.searchsorted(u, dia_[p, d]), 0, len(u) - 1)
        packed = dia.pack_nibble_codes(codes).view(np.uint8)
        # row-class decode: per-class masks of the diagonals nonzero in any
        # part; K capped as in the JAX package (tpu.py:1673-1682)
        cls_pattern = None
        if cls_uniq is not None and 1 < kmax <= 4:
            cls_pattern = tuple(
                tuple(bool(np.any(cb[:, d, k] != 0)) for d in range(D))
                for k in range(kmax)
            )
        self.dia_mode = "coded"
        self.dia_kk = tuple(int(k) for k in kk)
        self.dia_code_row = tuple(int(c) for c in code_row)
        self.dia_cls_pattern = cls_pattern
        self.coded = dia.CodedOperator(
            cb=torch.from_numpy(cb.astype(dt)).to(dev),
            no=torch.from_numpy(noids.astype(np.int32)).to(dev),
            codes=torch.from_numpy(np.ascontiguousarray(packed)).to(dev),
            offsets=self.dia_offsets,
            kk=self.dia_kk,
            code_row=self.dia_code_row,
            cls_pattern=cls_pattern,
            o0=self.row_layout.o0,
        )

    def _stage_irregular(self, oo, P, noids, no_max, dt, lowering):
        """A_oo of an operator that is not a band, in the JAX package's order
        off a TPU (tpu.py:1424-1487): supernode-dense, else node blocks,
        else padded ELL. ``lowering`` names the first one tried (``"sd"``
        is ``"auto"``; ``"bsr"`` skips SD and ``"ell"`` both, as
        ``PA_TPU_SD=0`` / ``PA_TPU_BSR=0`` do); ``self.lowering`` names
        the one taken. ELL keeps no footprint ceiling on the card (the JAX
        package's ``_ell_guard_check`` is a TPU fault ceiling;
        `gpu_irregular.stage_ell` records the decision). A rectangular
        A_oo (an assembled multigrid transfer) takes ELL: SD and BSR stage
        square node blocks."""
        from . import gpu_irregular as gi
        from ..ops import irregular as irr

        dev = self.backend.device
        rl, cl = self.row_layout, self.col_layout
        check(rl.o0 == cl.o0, "irregular lowering: the row and column frames' owned bands must start together")
        if cl.no_max != no_max:
            lowering = "ell"
            self.lowering_free = True
        sd = gi.detect_sd(oo, P, noids, no_max, dt) if lowering in ("auto", "sd") else None
        bsr = gi.detect_bsr(oo, P, noids, no_max, dt) if sd is None and lowering != "ell" else None
        if sd is not None:
            self.lowering = "sd"
            self.sd_bs, self.sd_g = sd["bs"], sd["G"]
            self.sd_idx = tuple(torch.from_numpy(c["idx"].astype(np.int64)).to(dev) for c in sd["chunks"])
            self.sd_vals = tuple(torch.from_numpy(c["vals"]).to(dev) for c in sd["chunks"])
            irr.check_full_precision(self.sd_vals[0].dtype, dev)
        elif bsr is not None:
            self.lowering = "bsr"
            self.bsr_bs = bsr["bs"]
            check(no_max // bsr["bs"] < 2**31, "BSR staging: the node frame does not fit int32 node columns")
            # E2's slot-major layout (`irregular.bsr_row_major` gives the
            # JAX package's staging back)
            self.bsr_cols = irr.bsr_slot_major(torch.from_numpy(bsr["cols"].astype(np.int32))).to(dev)
            self.bsr_vals = irr.bsr_slot_major(torch.from_numpy(bsr["vals"])).to(dev)
            self.bsr_counts = torch.from_numpy(bsr["counts"]).to(dev)
        else:
            self.lowering = "ell"
            vals, cols = gi.stage_ell(oo, P, no_max, cl, dt)
            self.oo_vals = torch.from_numpy(vals).to(dev)
            self.oo_cols = torch.from_numpy(cols).to(dev)

    def _stage_boundary(self, A, oh, P, dt):
        """A_oh, on the boundary rows only (tpu.py:1513-1558): node blocks
        of the SD or BSR block size where the ghost columns arrive as whole
        nodes (`gpu_irregular.detect_oh_blocks`: per-bucket views of one
        flat buffer an array, all buckets one launch of
        `ops/irregular.bsr_spmv_boundary`), else compact boundary-row ELL
        arrays (rows ``(P, nb_max)``, values and int32 columns slot-major
        ``(P, L, nb_max)``) for `ops/irregular.ell_spmv_boundary`,
        whose columns index the column frame through its slot maps (so a
        box layout's ghost segments need nothing more)."""
        from . import gpu_irregular as gi

        dev = self.backend.device
        rl, cl = self.row_layout, self.col_layout
        self.oh_nnz = sum(m.nnz for m in oh)
        self.oh_rows = self.oh_vals = self.oh_cols = None
        self.ohb_bs = self.ohb_rows = self.ohb_cols = self.ohb_vals = self.ohb_nhn = None
        if not self.oh_nnz:
            return
        bs = self.sd_bs or self.bsr_bs
        ohb = gi.detect_oh_blocks(A.cols.partition.part_values(), oh, P, bs, rl, cl, dt) if bs else None
        if ohb is not None:
            self.ohb_bs = ohb["bs"]
            self.ohb_nhn = (cl.W - cl.g0 - 1) // self.ohb_bs  # ghost nodes of the column frame
            check(self.ohb_nhn < 2**31, "node-block boundary: the ghost nodes do not fit int32 node columns")
            # each array's buckets in one flat buffer (E2's boundary mode
            # launches once over all of them), kept as per-bucket views;
            # rows int64 slots, cols int32 ghost nodes
            types = {"rows": np.int64, "cols": np.int32, "vals": dt}
            for name in ("rows", "cols", "vals"):
                arrs = [c[name].astype(types[name]) for c in ohb["chunks"]]
                flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrs])).to(dev)
                views, at = [], 0
                for a in arrs:
                    views.append(flat[at : at + a.size].view(a.shape))
                    at += a.size
                setattr(self, f"ohb_{name}", tuple(views))
            return
        L_oh = max(max(int(m.row_lengths().max()) if m.nnz else 0 for m in oh), 1)
        nb_max = max(max(int(np.count_nonzero(m.row_lengths())) for m in oh), 1)
        check(cl.W < 2**31, "boundary ELL: the column frame does not fit int32 slot columns")
        # E1's slot-major layout: (P, L, nb_max), int32 slot columns
        oh_rows = np.full((P, nb_max), rl.trash, dtype=np.int64)
        oh_vals = np.zeros((P, L_oh, nb_max), dtype=dt)
        oh_cols = np.full((P, L_oh, nb_max), cl.trash, dtype=np.int32)
        for p in range(P):
            br = np.nonzero(oh[p].row_lengths())[0]
            if len(br):
                E = ELLMatrix.from_csr(oh[p], row_width=L_oh)
                oh_rows[p, : len(br)] = rl.o0 + br
                oh_vals[p, :, : len(br)] = E.vals[br].T
                # ELL pad cols are hid 0 with value 0: a real slot, safe
                oh_cols[p, :, : len(br)] = cl.hid_slots[p][E.cols[br]].T
        self.oh_rows = torch.from_numpy(oh_rows).to(dev)
        self.oh_vals = torch.from_numpy(oh_vals).to(dev)
        self.oh_cols = torch.from_numpy(oh_cols).to(dev)

    def abft_row(self) -> torch.Tensor:
        """The ABFT checksum row ``w = 1ᵀA`` per part over the column frame,
        ``(P, Wc)`` float64 (tpu.py:1560-1571, :1729-1790): ``w[p, slot(j)]
        = Σ_i A_p[i, j]`` over part p's owned rows, the staged ``(c·A)`` of
        the identity ``c·(A x) == (c·A)·x``, accumulated in float64 on the
        host (its accuracy is the detection floor), the trash slot 0.
        Staged once per operator, by the first SDC solve with ABFT."""
        if self.abft_w is None:
            A, cl = self._source, self.col_layout
            oo = A.owned_owned_values.part_values()
            oh = A.owned_ghost_values.part_values()
            w = np.zeros((cl.P, cl.W), dtype=np.float64)
            for p in range(cl.P):
                M = oo[p]
                if M.nnz:
                    w[p, cl.o0 : cl.o0 + M.shape[1]] += np.bincount(
                        M.indices, weights=M.data.astype(np.float64), minlength=M.shape[1])
                Mh = oh[p]
                if Mh.nnz:
                    np.add.at(w[p], cl.hid_slots[p], np.bincount(
                        Mh.indices, weights=Mh.data.astype(np.float64), minlength=len(cl.hid_slots[p])))
            w[:, cl.trash] = 0.0
            self.abft_w = torch.from_numpy(w).to(self.backend.device)
        return self.abft_w

    #: row-class cap of the fused band analysis (tpu.py:1349 `_CLS_CAP`):
    #: an analysis cap only; the row-class compression still takes at
    #: most CODE_MAX_VALUES classes
    _CLS_CAP = 64

    @classmethod
    def _analyze_dia_classes(cls, oo, P, noids, no_max, offsets, col_limits=None):
        """The band analysis without the dense diagonals (tpu.py:2115-2204):
        one native pass a part classifies the rows by their tuple of
        diagonal values (planning.cpp `dia_classify_impl`, the classes and
        first-touch order of `dia_fill` + `row_classes`); the codebooks,
        the coded set and the row-class compression all come from the
        small class tables, so the (P, D, no_max) diagonals are never
        built. Returns the analysis with ``det["dia"] = None``, or None
        where it does not apply (native off, more than `_CLS_CAP`
        classes, a diagonal over CODE_MAX_VALUES values), and the caller
        runs the dense path, which also serves the streaming staging."""
        if not native.available():
            return None
        D = len(offsets)
        off_arr = np.array(offsets)
        KMAX = cls.CODE_MAX_VALUES
        tables = []
        codes_all = np.zeros((P, no_max), dtype=np.uint8)
        for p in range(P):
            M = oo[p]
            n_o = int(noids[p])
            if M.nnz:
                t, c, ok = native.dia_classify(
                    M.indptr, M.indices, M.data, M.shape[0], off_arr, cls._CLS_CAP,
                    col_limit=int(col_limits[p]) if col_limits is not None else 2**31,
                )
                if not ok:
                    return None
                tables.append(t)
                codes_all[p, :n_o] = c
            else:
                tables.append(np.zeros((1, D)))
        uniq = [[np.unique(tables[p][:, d]) for d in range(D)] for p in range(P)]
        kk = tuple(max((len(uniq[p][d]) for p in range(P)), default=1) or 1 for d in range(D))
        if max(kk) > KMAX:
            return None  # the streaming staging needs the dense diagonals
        code_row, coded = [], []
        for d in range(D):
            if kk[d] > 1:
                code_row.append(len(coded))
                coded.append(d)
            else:
                code_row.append(-1)
        cls_uniq = cls_ids = None
        if len(coded) >= 3 and all(len(t) <= KMAX for t in tables):
            cls_uniq, cls_ids = tables, codes_all
            n_class = max((len(t) for t in tables), default=1) or 1
            kk = tuple(n_class if kk[d] > 1 else 1 for d in range(D))
            code_row = [0 if c >= 0 else -1 for c in code_row]
        return {
            "offsets": offsets, "dia": None, "uniq": uniq, "kk": kk,
            "code_row": code_row, "coded": coded, "Dc": len(coded),
            "coded_ok": True, "cls_uniq": cls_uniq, "cls_ids": cls_ids,
            "cls_tables": tables, "cls_codes": codes_all,
        }

    @staticmethod
    def _dense_dia(oo, P, no_max, offsets):
        """The dense per-diagonal values (P, D, no_max) float64 of the A_oo
        blocks: entry (r, r+o) of part p on diagonal o, absent entries 0
        (the native fill where the layer is on, tpu.py:2286-2298)."""
        off_arr = np.array(offsets)
        dia_ = np.zeros((P, len(offsets), no_max))
        for p in range(P):
            M = oo[p]
            if M.nnz and not native.dia_fill(M.indptr, M.indices, M.data, M.shape[0], off_arr, dia_[p]):
                r = M.row_of_nz()
                d = np.searchsorted(off_arr, M.indices.astype(np.int64) - r)
                dia_[p, d, r] = M.data
        return dia_

    @classmethod
    def _detect_dia(cls, A, oo, P, noids, no_max, col_limits=None, fused_only=False):
        """Band and class analysis of A_oo (tpu.py:2206-2342): None unless
        A_oo is a square band of at most DIA_MAX_OFFSETS diagonals; else
        the per-diagonal distinct values and the row-class compression when
        it removes code streams (>= 3 coded diagonals, <= CODE_MAX_VALUES
        classes). With the native layer on, the fused analysis
        (`_analyze_dia_classes`, ``det["dia"]`` None) comes first; the
        dense diagonals (``det["dia"]``) serve the rest. ``col_limits`` reads each part's full CSR in
        ``oo``, its ghost tail skipped (the no-split lowering), and then
        ``fused_only`` declines where the fused analysis does."""

        def _oids_eq(ri, ci):
            if (
                hasattr(ri, "box_lo") and hasattr(ci, "box_lo")
                and ri.grid_shape == ci.grid_shape
                and ri.box_lo == ci.box_lo and ri.box_hi == ci.box_hi
            ):
                return True
            return np.array_equal(ri.oid_to_gid, ci.oid_to_gid)

        if not all(
            _oids_eq(ri, ci)
            for ri, ci in zip(A.rows.partition.part_values(), A.cols.partition.part_values())
        ):
            return None
        on = native.available()
        offs = set()
        for p in range(P):
            M = oo[p]
            if M.nnz:
                if on:
                    u, ok = native.band_offsets(
                        M.indptr, M.indices, M.shape[0], cls.DIA_MAX_OFFSETS,
                        col_limit=int(col_limits[p]) if col_limits is not None else 2**31,
                    )
                else:
                    u, ok = band_offsets(M.indptr, M.indices, M.shape[0], cls.DIA_MAX_OFFSETS)
                if not ok:
                    return None
                offs.update(u.tolist())
        if not (0 < len(offs) <= cls.DIA_MAX_OFFSETS):
            return None
        offsets = tuple(sorted(offs))
        D = len(offsets)
        det = cls._analyze_dia_classes(oo, P, noids, no_max, offsets, col_limits=col_limits)
        if det is not None or fused_only:
            return det
        dia_ = cls._dense_dia(oo, P, no_max, offsets)
        KMAX = cls.CODE_MAX_VALUES
        uniq = []
        for p in range(P):
            n_o = int(noids[p])
            row = []
            for d in range(D):
                u, ok = (native.unique_small if on else unique_small)(dia_[p, d, :n_o], KMAX)
                row.append(u if ok else np.arange(KMAX + 1, dtype=float))
            uniq.append(row)
        kk = tuple(max((len(uniq[p][d]) for p in range(P)), default=1) or 1 for d in range(D))
        code_row, coded = [], []
        for d in range(D):
            if kk[d] > 1:
                code_row.append(len(coded))
                coded.append(d)
            else:
                code_row.append(-1)
        coded_ok = max(kk) <= KMAX
        cls_uniq = cls_ids = None
        if coded_ok and len(coded) >= 3:
            cls_uniq, cls_ids, n_class = [], np.zeros((P, no_max), np.uint8), 1
            for p in range(P):
                n_o = int(noids[p])
                # first-touch class order natively, lexicographic in the
                # plain version: both select the same values
                u, inv, ok = (native.row_classes if on else row_classes)(dia_[p], n_o, KMAX)
                if not ok:
                    cls_uniq = cls_ids = None
                    break
                cls_uniq.append(u)
                cls_ids[p, :n_o] = inv
                n_class = max(n_class, len(u))
        if cls_uniq is not None:
            kk = tuple(n_class if kk[d] > 1 else 1 for d in range(D))
            code_row = [0 if c >= 0 else -1 for c in code_row]
        return {
            "offsets": offsets, "dia": dia_, "uniq": uniq, "kk": kk,
            "code_row": code_row, "coded": coded, "Dc": len(coded),
            "coded_ok": coded_ok, "cls_uniq": cls_uniq, "cls_ids": cls_ids,
        }


def device_matrix(A: PSparseMatrix, backend: GPUBackend, box: bool = True, strict: bool = False,
                  lowering: str = "auto") -> DeviceMatrix:
    """The lowering of A for a backend, cached on A per ``box``, ``strict``
    and ``lowering`` (strict mode is one entry: the ELL lowering on the
    generic plan). An operator whose staging no ``lowering`` changes (a
    band, or a rectangular A_oo: `DeviceMatrix.lowering_free`) is staged
    once for every ``lowering``. Counts ``lowering_cache.{hit,miss,
    stale_rekey}`` and emits a ``compile_cache`` event (tpu.py:2436-2455):
    a miss on a backend A was already staged on, under other keywords, is
    a ``stale_rekey``."""
    from .. import telemetry

    key = (backend, False, True, "ell") if strict else (backend, bool(box), False, lowering)
    if key not in A._device:
        action = "stale_rekey" if any(k[0] is backend for k in A._device) else "miss"
        telemetry.bump(f"lowering_cache.{action}")
        telemetry.emit_event("compile_cache", label=f"lowering_{action}", cache="lowering", action=action)
        same = next((d for k, d in A._device.items() if k[:3] == key[:3] and d.lowering_free), None)
        A._device[key] = same if same is not None else DeviceMatrix(A, backend, box, strict=strict,
                                                                    lowering=lowering)
    else:
        telemetry.bump("lowering_cache.hit")
        telemetry.emit_event("compile_cache", label="lowering_hit", cache="lowering", action="hit")
    return A._device[key]


# ---------------------------------------------------------------------------
# SpMV and CG
# ---------------------------------------------------------------------------


def _irregular_aoo(dA: DeviceMatrix, plain: bool, block: bool = False) -> Callable:
    """``aoo(xv, width) -> y`` for the SD, BSR and ELL lowerings: the A_oo
    product of the column frame xv into a (P, width) row frame, the owned
    band computed and 0 elsewhere (tpu.py:3096-3161): `irregular.sd_spmv`
    (torch.bmm: no plain form), E2 `bsr_spmv` or E1 `ell_spmv`; with
    ``block`` the same on (P, W, K) slabs (`sd_spmv` on a slab, E2
    `bsr_spmm`, E1 `ell_spmm`)."""
    from ..ops import irregular as irr

    o0, n = dA.col_layout.o0, dA.col_layout.no_max
    if dA.lowering == "sd":
        return lambda xv, width: irr.sd_spmv(dA.sd_idx, dA.sd_vals, xv, o0, n, dA.sd_bs, dA.sd_g, width)
    if dA.lowering == "bsr":
        if plain:
            vals, cols = irr.bsr_row_major(dA.bsr_vals), irr.bsr_row_major(dA.bsr_cols)
            k = irr.bsr_spmm_plain if block else irr.bsr_spmv_plain
            return lambda xv, width: k(vals, cols, xv, o0, o0, width)
        k = irr.bsr_spmm if block else irr.bsr_spmv
        return lambda xv, width: k(dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, xv, o0, o0, width)
    if block:
        k = irr.ell_spmm_plain if plain else irr.ell_spmm
    else:
        k = irr.ell_spmv_plain if plain else irr.ell_spmv
    return lambda xv, width: k(dA.oo_vals, dA.oo_cols, xv, o0, width)


#: the side stream of each CUDA device that the overlap tail's halo copies
#: run on (`_spmv_body(overlap=True)`)
_SIDE_STREAMS = {}


def _side_stream(device: torch.device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _overlapped(compute: Callable, plan, xv: torch.Tensor, abft: bool = False):
    """``compute()`` (the A_oo product, which reads the owned slots of xv
    only) on the current stream while the halo exchange of xv (which
    writes its ghost and trash slots only) runs on a side stream, forked
    from and joined back into the current stream by events, so a CUDA
    graph captures both branches (tpu.py:866-878, :2827-2846: the
    interior/boundary split of ``PA_TPU_OVERLAP=1``). The two touch
    disjoint slots, so the values are those of the sequential schedule.
    Off the card the two run one after the other. Returns ``(y, ex)``, ex
    the exchange's checksum pair under ``abft`` (else None)."""
    if xv.device.type != "cuda":
        y = compute()
        ex = exchange_(plan, xv, abft=abft)
        return y, (ex[1:] if abft else None)
    main = torch.cuda.current_stream(xv.device)
    side = _side_stream(xv.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        ex = exchange_(plan, xv, abft=abft)
    y = compute()
    main.wait_stream(side)
    return y, (ex[1:] if abft else None)


def _can_overlap(dA: DeviceMatrix, fused: bool) -> bool:
    """Whether a CG body's iterations have an overlap tail to run: not the
    fused body on a coded operator, whose operand p is an output of the
    product's own kernel (K2), so its exchange can only follow it. There
    ``overlap=True`` is the same solve function as ``overlap=False``."""
    return not (fused and dA.dia_mode == "coded")


def _spmv_body(dA: DeviceMatrix, pfold: bool = False, axpy: bool = False,
               plain: bool = False, block: bool = False, overlap: bool = False,
               abft: bool = False, audit: bool = False):
    """The stacked SpMV (tpu.py:_spmv_body): the A_oo product first (it
    reads owned slots only), then the halo exchange of the operand, then
    the A_oh contribution on the boundary rows and the ghost region of the
    result zeroed (`_finish`). The operand's ghost slots are refreshed in
    place. A coded operator runs the coded-DIA kernel, a streaming one the
    streaming-DIA kernel (`_dia_rowsum`, tpu.py:2960-2975), an SD, BSR or
    ELL one its product of `ops/irregular.py` (`_irregular_aoo`). A_oh
    runs E2's boundary mode, one launch over its width buckets (node
    blocks), or E1's (boundary-row ELL). ``pfold`` gives ``body(r, pprev, beta, minv=None)
    -> (A p, p)`` with ``p = r + beta*pprev`` (with ``minv``, Jacobi PCG's
    ``p = minv*r + beta*pprev``); ``axpy`` gives ``body(x, xacc, pprev,
    alpha) -> (A x, xacc)`` with the lagged update ``xacc += alpha*pprev``
    applied in place on the owned band where the optional device flag
    ``live`` is not 0 (tpu.py:3237-3256). On a coded operator both ride the
    kernel's pass (K2, K3); on any other the fold and the update are eager
    ops before the product, as the JAX package applies them outside its
    kernel (tpu.py:3284-3291, :3022-3031, :2859-2864), each product rounded
    on its own. ``block`` gives the same bodies over ``(P, W, K)`` slabs
    (beta (K,) per column, minv shared), on the block products
    `dia_coded_spmm` / `dia_stream_spmm` of a band and the slab forms of
    the others (`_irregular_aoo`; A_oh by the boundary modes on slabs);
    column k of a block body is the single-vector body of column k (bit
    for bit but on SD, whose `torch.bmm` takes its own order for K
    columns). ``plain`` runs the plain versions of the kernels on the same
    tensors (the comparison path).

    ``overlap`` is the interior/boundary overlap tail (tpu.py:866-878,
    :2827-2846): the operand's halo exchange runs on a side stream while
    the A_oo product runs (`_overlapped`), and the boundary finish waits
    for both. It changes the schedule, not the values: every product is
    ``torch.equal`` to ``overlap=False``'s. The coded fused body's operand
    p is an output of the product's own kernel (K2), so its exchange can
    only follow it there (`_can_overlap`).

    The SDC modes (tpu.py:2879-2889, :3034-3047, :3258-3297): ``abft``
    runs the operand's halo exchange with its round checksums and every
    body returns them after its usual outputs (``body(x) -> (y, delta,
    scale)``, ``body_pfold(...) -> (y, p, delta, scale)``, the per-part
    pairs of `exchange_`); ``audit`` gives ``body_pfold`` the keywords
    ``aud`` and ``audx``: where the device flag ``aud`` is set the SpMV
    streams ``audx`` (the iterate, for the true-residual audit) instead of
    the folded direction, through the body's one product, and the body
    returns that operand as p. Either mode keeps K2's fold out of the
    kernel, as the JAX package keeps its fold kernel off: the fold is the
    eager ``fold_k``, whose products and adds are K2's
    (`ops/dia.py:_fold`), so p is K2's p bit for bit, and K1
    (`dia_coded_spmv`, its slab form with ``block``) computes the product,
    K2's product bit for bit."""
    from ..ops import irregular as irr

    sdc_fold = abft or audit
    op = dA.coded
    wy = dA.row_layout.W
    g0 = dA.row_layout.g0
    o0 = dA.row_layout.o0
    plan = dA.col_plan
    check(not (block and axpy), "the pipelined body is single-vector only")
    check(not (axpy and (abft or audit)), "the pipelined body has no SDC-defended form")
    if dA.dia_mode == "coded":
        if block:
            spmv_k = dia.dia_coded_spmm_plain if plain else dia.dia_coded_spmm
            pfold_k = dia.dia_coded_spmm_pfold_plain if plain else dia.dia_coded_spmm_pfold
        else:
            spmv_k = dia.dia_coded_spmv_plain if plain else dia.dia_coded_spmv
            pfold_k = dia.dia_coded_spmv_pfold_plain if plain else dia.dia_coded_spmv_pfold
            axpy_k = dia.dia_coded_spmv_axpy_plain if plain else dia.dia_coded_spmv_axpy
    else:
        n = dA.row_layout.no_max
        own = (torch.arange(n)[None, :] < torch.from_numpy(dA.row_layout.noids)[:, None]).to(dA.backend.device)
        if dA.dia_mode == "stream":
            if block:
                stream_k = dia.dia_stream_spmm_plain if plain else dia.dia_stream_spmm
                form = {}
            else:
                stream_k = dia.dia_stream_spmv_plain if plain else dia.dia_stream_spmv
                form = {} if plain else {"form": dA.stream_form}

            def spmv_k(_op, xv, width):
                return stream_k(dA.stream_vals, xv, dA.dia_offsets, dA.stream_no, o0, width, **form)
        else:
            aoo = _irregular_aoo(dA, plain, block)

            def spmv_k(_op, xv, width):
                return aoo(xv, width)

        def axpy_k(_op, xv, xacc, pprev, alpha, width, live=None):
            band = slice(o0, o0 + n)
            on = own if live is None else own & (live.reshape(()) != 0)
            xb = xacc[:, band]
            xb.copy_(torch.where(on, xb + alpha * pprev[:, band], xb))
            return spmv_k(_op, xv, width)

    def fold_k(rv, pv, beta, minv=None):
        # beta*pprev, then + r (or + minv*r): the rounding of `dia._fold`
        # (K2's), in two passes over the band; rows past a part's owned
        # count are 0 in r and pprev, so they fold to +0, as K2's masked
        # fold gives them
        n = dA.row_layout.no_max
        band = slice(o0, o0 + n)
        p = torch.empty_like(rv)
        p[:, :o0] = 0
        p[:, o0 + n :] = 0
        pb = p[:, band]
        torch.mul(pv[:, band], beta, out=pb)
        if minv is None:
            pb.add_(rv[:, band])
        else:
            pb.add_((minv[:, band, None] if block else minv[:, band]) * rv[:, band])
        return p

    ell_b = irr.ell_spmv_boundary_plain if plain else irr.ell_spmv_boundary
    bsr_b = irr.bsr_spmv_boundary_plain if plain else irr.bsr_spmv_boundary
    trash = dA.row_layout.trash
    cg0 = dA.col_layout.g0

    def _boundary(y, xv):
        if dA.oh_nnz:
            if dA.ohb_bs is not None:
                bsr_b(dA.ohb_rows, dA.ohb_vals, dA.ohb_cols, xv, cg0, dA.ohb_nhn, y, trash)
            else:
                ell_b(dA.oh_rows, dA.oh_vals, dA.oh_cols, xv, y, trash)
            y[:, g0:] = 0
        return y

    def _tail(compute, xv):
        # the A_oo product, the operand's halo exchange, the A_oh finish;
        # with abft also the exchange's checksum pair
        if overlap:
            y, ex = _overlapped(compute, plan, xv, abft)
        else:
            y = compute()
            ex = exchange_(plan, xv, abft=abft)
            ex = ex[1:] if abft else None
        y = _boundary(y, xv)
        return (y,) + tuple(ex) if abft else y

    def body(xv):
        return _tail(lambda: spmv_k(op, xv, wy), xv)

    def body_pfold(rv, pv, beta, minv=None, aud=None, audx=None):
        if sdc_fold:
            p = fold_k(rv, pv, beta, minv)
            if aud is not None:
                p = torch.where(aud, audx, p)  # the audit trip streams A x
            out = _tail(lambda: spmv_k(op, p, wy), p)
            return (out[0], p) + out[1:] if abft else (out, p)
        if dA.dia_mode == "coded":
            y, p = pfold_k(op, rv, pv, beta, wy, minv=minv)
            exchange_(plan, p)
            return _boundary(y, p), p
        p = fold_k(rv, pv, beta, minv)
        return _tail(lambda: spmv_k(op, p, wy), p), p

    def body_axpy(xv, xacc, pprev, alpha, live=None):
        return _tail(lambda: axpy_k(op, xv, xacc, pprev, alpha, wy, live), xv), xacc

    return body_pfold if pfold else body_axpy if axpy else body


def make_spmv_fn(dA: DeviceMatrix) -> Callable:
    """y = A @ x on the stacked frames: ``(P, Wc)`` column-range tensor ->
    ``(P, Wr)`` row-range product (ghost slots of y zero), or a ``(P, Wc,
    K)`` slab of K columns -> ``(P, Wr, K)`` (the block body, tpu.py:2827's
    rank-polymorphic SpMV). The ghost slots of x are refreshed in place."""
    bodies = {2: _spmv_body(dA), 3: _spmv_body(dA, block=True)}
    shape = (dA.col_layout.P, dA.col_layout.W)

    def run(x):
        check(
            tuple(x.shape[:2]) == shape and x.dim() in bodies,
            f"spmv: vector laid out {tuple(x.shape)}, matrix expects {shape} or {shape} + (K,)",
        )
        return bodies[x.dim()](x)

    return run


def _pdot_factory(o0: int, no_max: int, strict: bool = False, plain: bool = False):
    """Deterministic dot over the owned regions: per-part partials, folded
    in part order (tpu.py:_pdot_factory). ``strict`` takes E3
    (`ops/irregular.pairwise_dot`, its plain version with ``plain``): the
    strict branch of tpu.py:2538-2551, bit for bit the host's strict
    `PVector.dot`. Each dot counts as one ``all_gather`` of its ``(P,)``
    partials in the active `telemetry.comms` tallies."""
    if strict:
        from ..ops import irregular as irr

        k = irr.pairwise_dot_plain if plain else irr.pairwise_dot

        def sdot(a, b):
            _count_fold(a, 1)
            return k(a, b, o0, no_max)

        return sdot

    def partials(a, b):
        return (a[:, o0 : o0 + no_max] * b[:, o0 : o0 + no_max]).sum(dim=1)

    def pdot(a, b):
        _count_fold(a, 1)
        return _fold_parts(partials(a, b))

    pdot.partials = partials
    return pdot


def _count_fold(like: torch.Tensor, lanes: int, ops: int = 1) -> None:
    """One part-order fold of ``lanes`` per-part partials a column of
    ``like`` (a (P, W) frame or a (P, W, K) slab) into the active
    `telemetry.comms` tallies: ``all_gather``, ``P·K·lanes·itemsize``
    bytes (``ops`` 0 adds lanes to the gather counted just before)."""
    cols = like.shape[2] if like.dim() == 3 else 1
    tcomms.count("all_gather", ops, like.shape[0] * cols * lanes * like.element_size())


def _counted_sweep(sweep: Callable) -> Callable:
    """A CG sweep (`ops/sweep.py`) whose fold of the partials counts as one
    ``all_gather`` of its lanes (r.r, and r.z in the precond form)."""

    def run(r, q, alpha, live, part, o0, n, x=None, p=None, minv=None):
        _count_fold(r, 1 if minv is None else 2)
        return sweep(r, q, alpha, live, part, o0, n, x=x, p=p, minv=minv)

    return run


def _pdot_extra_factory(o0: int, no_max: int, strict: bool = False, plain: bool = False, block: bool = False):
    """The deterministic dot with extra per-part lanes folded beside it
    (tpu.py:2616, the ABFT and audit transport): ``pdotx(a, b, extras) ->
    (a·b, folded extras)``, ``extras`` a tuple of per-part partials ``(P,)``
    (``(P, K)`` with ``block``), each folded in part order as the dot's own
    partials are. The dot is `_pdot_factory`'s (`_block_pdot_factory`'s)
    call itself, so carrying the lanes never moves its bits. The lanes
    count as lanes of the dot's one ``all_gather`` (tpu.py:2616 gathers
    the widened partials once), not as a gather of their own.

    ``alt = (sel, part)`` (not with ``strict``: E3 folds the parts in its
    own tree) puts ``part``, per-part partials of another dot, in the place
    of the dot's own where the device flag ``sel`` holds, before the one
    fold: the audit's drift ||d||² through the trip's p·q gather
    (tpu.py:_aud_ops selects the dot's operands; the partials of selected
    operands are the selected partials)."""
    pdot = _block_pdot_factory(o0, no_max, plain, strict) if block else _pdot_factory(o0, no_max, strict, plain)

    def pdotx(a, b, extras=(), alt=None):
        if alt is None:
            d = pdot(a, b)
        else:
            _count_fold(a, 1)
            d = _fold_parts(torch.where(alt[0], alt[1], pdot.partials(a, b)))
        if not extras:
            return d, ()
        _count_fold(a, len(extras), ops=0)
        folded = _fold_parts(torch.stack(extras, dim=-1))
        return d, tuple(folded[..., i] for i in range(len(extras)))

    return pdotx


def _fold_parts(part: torch.Tensor) -> torch.Tensor:
    """Per-part partials ``(P, ...)`` added left to right: the part order
    of every deterministic dot of the port."""
    acc = part[0]
    for i in range(1, part.shape[0]):
        acc = acc + part[i]
    return acc


def _block_pdot_factory(o0: int, no_max: int, plain: bool = False, strict: bool = False):
    """`_pdot_factory`'s dot per column of ``(P, W, K)`` slabs, returning
    (K,), each column in the solo order. ``strict`` takes E3's block form
    (`ops/irregular.pairwise_dot_block`, its plain version with ``plain``):
    every column's fixed tree in one launch, column k bit for bit the solo
    strict dot (tpu.py:2501, :2538-2551). A reduction over the strided
    column of a slab is another sum than the solo one's over a contiguous
    (P, n) product (on the card the reduction's schedule follows the shape,
    the strides and the pointer's alignment), so the products of all
    columns are written in one pass into K contiguous (P, n) blocks
    (`ops/sweep.py:block_products`), each starting on a 64-element boundary
    as a fresh tensor does; each block is then summed as the solo dot sums
    its product, and the parts are added left to right. Column k equals
    the solo dot of column k bit for bit. ``plain`` takes the products'
    plain version."""
    from ..ops import sweep as sw

    if strict:
        from ..ops import irregular as irr

        k = irr.pairwise_dot_block_plain if plain else irr.pairwise_dot_block

        def sdot(a, b):
            _count_fold(a, 1)
            return k(a, b, o0, no_max)

        return sdot

    products = sw.block_products_plain if plain else sw.block_products

    def partials(a, b):
        P, K = a.shape[0], a.shape[2]
        m = P * no_max
        stride = sw.block_product_stride(P, no_max)
        buf = products(a, b, o0, no_max)
        return torch.stack([buf[k * stride : k * stride + m].view(P, no_max).sum(dim=1) for k in range(K)]).t()

    def bdot(a, b):
        _count_fold(a, 1)
        return _fold_parts(partials(a, b))

    bdot.partials = partials
    return bdot


def _sdc_config(sdc, maxiter: int) -> Optional[dict]:
    """The device loops' SDC defense from an `SDCConfig` (tpu.py:1011-1052):
    None when inactive (the loop is then exactly the undefended one), else
    ``abft``, ``ae`` (the audit period), ``R`` and ``mrb`` (ring depth and
    rollback budget), ``fault`` (the parsed device fault clause, or None)
    and ``trip_max``, the bound on loop trips: the iterations, the audit
    trips and the replays of ``mrb + 1`` rollbacks (each rewinds at most
    R·ae iterations, or to the start without audits); ``key`` joins the
    solve cache's key."""
    from ..utils.health import resolve_sdc
    from .faults import parse_device_fault

    sdc = resolve_sdc(sdc)
    if sdc is None:
        return None
    ae, R, mrb = sdc.every, int(sdc.rollback_depth), int(sdc.max_rollbacks)
    fault = parse_device_fault(sdc.device_fault)
    audits = (maxiter // ae + 2) if ae > 0 else 0
    replay = (R * ae + 2) if ae > 0 else maxiter + 1
    return {
        "abft": bool(sdc.abft), "ae": ae, "R": R, "mrb": mrb, "fault": fault, "sdc": sdc,
        "trip_max": int(min(maxiter + audits + (mrb + 1) * replay, 2**31 - 1)),
        "key": (bool(sdc.abft), ae, R, mrb, sdc.abft_tol, sdc.audit_tol,
                tuple(sorted(fault.items())) if fault else None),
    }


def _sdc_tolerances(cfg: dict, dtype, P: int, no_max: int):
    """The detection thresholds (tpu.py:1055-1073): the SpMV checksum
    compares two sums of n terms, whose rounding grows ~ sqrt(n)·eps of the
    terms, so its relative threshold is 100·eps·sqrt(P·no_max) (or
    ``abft_tol``); the audit's is `SDCConfig.audit_tolerance`."""
    sdc = cfg["sdc"]
    if sdc.abft_tol:
        cs_tol = float(sdc.abft_tol)
    else:
        cs_tol = 100.0 * float(torch.finfo(dtype).eps) * float(np.sqrt(max(1, P * no_max)))
    return cs_tol, sdc.audit_tolerance(np.dtype(f"float{torch.finfo(dtype).bits}"))


def _sstep_conflict(other: str):
    """The typed refusal of an explicit s-step depth >= 2 meeting a body
    form it does not compose with (tpu.py:3418-3428)."""
    from ..utils.health import LoweringConflictError

    raise LoweringConflictError(
        f"make_cg_fn: the s-step (communication-avoiding) body does not compose with {other}; "
        f"drop sstep or {other}",
        diagnostics={"conflict": ("sstep", other)},
    )


def _sdc_conflict(other: str):
    """The typed refusal of the SDC defense meeting a body with no defended
    form (tpu.py:3525-3547)."""
    from ..utils.health import LoweringConflictError

    raise LoweringConflictError(
        f"make_cg_fn: the {other} body has no SDC-defended form; drop sdc or {other}",
        diagnostics={"conflict": ("sdc", other)},
    )


def _resolve_cg_body(sstep, fused, pipelined, precond, strict, rhs_batch=None, sdc: bool = False):
    """The CG body `make_cg_fn` builds, as ``(sstep, fused)`` (tpu.py:3415-3500
    without the environment): an explicit ``sstep`` >= 2 refuses
    ``fused=True``, ``pipelined``, ``precond``, a block of right-hand sides,
    strict mode and (``sdc``) the SDC defense with `LoweringConflictError`,
    and is an unfused body; 0 and 1 are the textbook forms. Otherwise
    ``fused`` defaults to on unless ``pipelined`` or ``strict``; the
    pipelined body refuses the SDC defense."""
    s = int(sstep or 0)
    s = s if s >= 2 else 0
    if s and sdc:
        _sstep_conflict("the SDC defense (sdc=)")
    if pipelined and sdc:
        _sdc_conflict("pipelined")
    if s:
        if strict:
            _sstep_conflict("strict (the textbook body is the bitwise oracle)")
        if fused:
            _sstep_conflict("fused")
        if rhs_batch is not None:
            _sstep_conflict("rhs_batch")
        if pipelined:
            _sstep_conflict("pipelined")
        if precond:
            _sstep_conflict("precond")
        return s, False
    if rhs_batch is not None:
        return 0, (not strict) if fused is None else bool(fused)
    return 0, (not pipelined and not strict) if fused is None else bool(fused)


def make_cg_fn(dA: DeviceMatrix, tol: float, maxiter: int, fused: Optional[bool] = None,
               pipelined: bool = False, plain: bool = False, graph: bool = True,
               block: Optional[int] = None, precond: bool = False, sstep: Optional[int] = None,
               overlap: bool = False, sdc=None, trace_iters: int = 0,
               rhs_batch: Optional[int] = None) -> Callable:
    """The CG solve over the stacked frames: ``fn(b, x0) -> (x, rs, rs0,
    iterations, residual history)``, run as a device-resident loop
    (`gpu_loop.DeviceLoop`, the counterpart of the JAX package's
    ``lax.while_loop``): the state is device tensors, the stopping test a
    device flag ``live`` carried as ``live and cond(state)``, with the
    JAX package's conditions (tpu.py:cond_fused/cond/cond_pipe): continue
    while ``sqrt(rs) > tol*max(1, sqrt(rs0))``, ``it < maxiter`` and rs is
    finite, in the working dtype. The host reads the flag once per block
    of ``block`` iterations (`gpu_loop.CG_BLOCK`); on a CUDA device the
    block is a CUDA graph, replayed, unless ``graph=False`` (the eager
    comparison path). Iterations after the stop are frozen, so the results
    are those of a loop that stops at once.

    ``fused`` (the default unless ``pipelined``) folds the direction
    update ``p = r + beta*p`` into the next SpMV kernel (tpu.py:4054-4123);
    ``pipelined`` applies the solution update ``x += alpha*p`` one
    iteration late, inside the next SpMV kernel's pass (tpu.py:4278-4313),
    and the first frozen iteration's SpMV applies the last one (the flush);
    otherwise the textbook body runs (tpu.py:4125-4170). Every body updates
    x and r and takes r.r in one sweep (`ops/sweep.py`; r only in the
    pipelined body). All three follow the same scalar recurrence, so they
    take the same iterations. The history holds H = min(maxiter + 1, 4096)
    entries, NaN past the last one written (entry i is sqrt(rs) after
    iteration i, at min(i, H - 1)). The returned function names its body
    in ``fn.cg_body``, describes its last run in ``fn.stats`` and keeps its
    `gpu_loop.DeviceLoop` (whose state buffers hold the last run's final
    state) in ``fn.loop``.

    ``precond`` gives Jacobi PCG (tpu.py:3634-3649, :4065-4099,
    :4144-4170), ``fn(b, x0, minv)`` with the inverse diagonal ``minv`` on
    b's frame: z = minv*r, alpha = r.z / p.q, beta = r.z' / r.z, and the
    loop also stops where r.z == 0 (a breakdown). The fused body folds
    ``p = minv*r + beta*pprev`` into the SpMV pass (K2 with minv); the
    standard body updates ``p = minv*r + beta*p`` eagerly; the sweep takes
    the r.z and r.r partials together (its precond form). The pipelined
    body stays unpreconditioned, as in the JAX package.

    On a strict lowering (``dA.strict``, strict-bits mode) the standard
    body is the default, as `_fused_cg_enabled` keeps it (tpu.py:818-826),
    and every reduction is E3's fixed tree (`_pdot_factory`): the sweep
    updates x and r (each product rounded) and r.r, with ``precond`` also
    r.z of the stored z = minv*r, are taken by E3 from them, so the loop
    follows the host's strict CG bit for bit.

    ``sstep=s`` (s >= 2) is the communication-avoiding s-step body
    (tpu.py:3400-3440, :4172-4262; `_make_sstep_cg_fn`); 0 and 1 are the
    textbook body itself. It refuses ``fused=True``, ``pipelined``,
    ``precond`` and a strict lowering with `LoweringConflictError` (a
    block of right-hand sides too: `_krylov_fn_for`). ``overlap`` runs
    every SpMV with the interior/boundary overlap tail
    (`_spmv_body(overlap=True)`): the same values, another schedule.

    ``sdc`` (an active `SDCConfig`) builds the SDC-defended loop of the
    standard, fused or Jacobi body instead (`gpu_sdc.make_sdc_cg_fn`,
    tpu.py:3519-4052), whose ``fn`` also returns the (5,) counter vector
    (``fn.has_sdc``); with ``abft`` the operator's checksum row is staged
    (`DeviceMatrix.abft_row`). The s-step and pipelined bodies have no
    defended form and refuse it with `LoweringConflictError`
    (tpu.py:3525-3547); the defended loop runs without the overlap
    tail.

    ``trace_iters`` (the JAX package's ``PA_TRACE_ITERS``, tpu.py:988,
    :3549-3555) adds the α/β trace ring: a ``(Ht, 2)`` device tensor,
    Ht = min(trace_iters, maxiter), that every live iteration writes
    (α, β) into at row ``it % Ht`` (`gpu_loop.record_ab`: a device index,
    gated on the flag, so the write sits inside the captured block); ``fn``
    then returns the ring as a sixth value (after the SDC vector of a
    defended loop) and ``fn.trace_iters`` is Ht. 0, the default, builds
    the loop without it, launching what it launched before. The pipelined
    body has no ring (Ht 0, as in the JAX package).

    ``rhs_batch=K`` (the JAX package's keyword) builds the block
    (multi-RHS) solve of K columns instead: `make_block_cg_fn`. The
    pipelined body and s-step have no block form and refuse it."""
    from . import gpu_loop as gl
    from ..ops import sweep as sw

    if rhs_batch is not None:
        if pipelined:
            raise ValueError("make_cg_fn: the pipelined (lag-1) form is single-RHS only; drop pipelined or rhs_batch")
        if sstep is not None and int(sstep) >= 2:
            _sstep_conflict("rhs_batch")
        return make_block_cg_fn(dA, tol, maxiter, int(rhs_batch), precond=precond, fused=fused, plain=plain,
                                graph=graph, block=block, overlap=overlap, sdc=sdc, trace_iters=trace_iters)
    strict = dA.strict
    cfg = _sdc_config(sdc, maxiter)
    sstep, fused = _resolve_cg_body(sstep, fused, pipelined, precond, strict, sdc=cfg is not None)
    overlap = bool(overlap) and _can_overlap(dA, fused)
    Ht = 0 if pipelined else int(min(max(0, int(trace_iters)), int(maxiter)))
    if cfg is not None:
        from .gpu_sdc import make_sdc_cg_fn

        return make_sdc_cg_fn(dA, tol, maxiter, cfg, fused, precond, plain, graph, block, trace_iters=Ht)
    if sstep:
        return _make_sstep_cg_fn(dA, tol, maxiter, sstep, plain=plain, graph=graph, block=block,
                                 overlap=overlap, trace_iters=Ht)
    if fused and pipelined:
        raise ValueError("make_cg_fn: fused and pipelined are mutually exclusive forms")
    if precond and pipelined:
        raise ValueError("make_cg_fn: the pipelined body is unpreconditioned")
    body = _spmv_body(dA, plain=plain, overlap=overlap)
    body_pfold = _spmv_body(dA, pfold=True, plain=plain, overlap=overlap) if fused else None
    body_axpy = _spmv_body(dA, axpy=True, plain=plain, overlap=overlap) if pipelined else None
    sweep = _counted_sweep(sw.cg_sweep_plain if plain else sw.cg_sweep)
    o0, no_max = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + no_max)
    pdot = _pdot_factory(o0, no_max, strict, plain)
    stop_it = gl.stop_bound(maxiter)

    def step(S):
        rs, it, armed = S["rs"], S["it"], S["live"]
        go = (gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it) & torch.isfinite(rs)
        if precond:
            go = go & (S["rz"] != 0)
        live = armed * go.to(torch.int32)
        out = dict(S)
        mv = S["minv"] if precond else None
        if fused:
            q, p = body_pfold(S["r"], S["pprev"], S["beta"], minv=mv)
        elif pipelined:
            # the SpMV also applies last iteration's x update, while the
            # previous iteration was live (the flush in the first frozen one)
            p = S["p"]
            q, _ = body_axpy(p, S["x"], S["pprev"], S["alpha_prev"], armed)
        else:
            p = S["p"]
            q = body(p)
        rz = S["rz"] if precond else rs
        alpha = rz / pdot(p, q)
        if pipelined:
            rs_new = sweep(S["r"], q, alpha, live, S["part"], o0, no_max)
            if strict:
                rs_new = pdot(S["r"], S["r"])
        elif strict:
            # the sweep updates x and r; the dots are E3's tree
            sweep(S["r"], q, alpha, live, S["part"], o0, no_max, x=S["x"], p=p)
            rs_new = pdot(S["r"], S["r"])
            if precond:
                z = torch.zeros_like(S["r"])
                z[:, sl] = mv[:, sl] * S["r"][:, sl]
                rz_new = pdot(S["r"], z)
                out["rz"] = torch.where(live != 0, rz_new, rz)
        elif precond:
            rz_new, rs_new = sweep(S["r"], q, alpha, live, S["part"], o0, no_max, x=S["x"], p=p, minv=mv)
            out["rz"] = torch.where(live != 0, rz_new, rz)
        else:
            rs_new = sweep(S["r"], q, alpha, live, S["part"], o0, no_max, x=S["x"], p=p)
        beta = (rz_new if precond else rs_new) / rz
        if Ht:
            gl.record_ab(S["ab"], it, live, alpha, beta)
        if fused:
            out["pprev"], out["beta"] = p, beta
        elif pipelined:
            pnew = torch.zeros_like(p)
            pnew[:, sl] = S["r"][:, sl] + beta * p[:, sl]
            out["pprev"], out["alpha_prev"], out["p"] = p, alpha, pnew
        else:
            z = mv[:, sl] * S["r"][:, sl] if precond else S["r"][:, sl]
            p[:, sl] = z + beta * p[:, sl]
        return gl.finish_step(out, S, live, rs_new)

    loop = gl.DeviceLoop(step, gl.CG_BLOCK if block is None else block, graph)

    def fn(b, x0, minv=None):
        check((minv is not None) == precond,
              "make_cg_fn: pass minv exactly when the function was built with precond")
        with tcomms.counting() as setup:
            x = x0.clone()
            q = body(x0.clone())
            r = torch.zeros_like(x)
            r[:, sl] = b[:, sl] - q[:, sl]
            rs0 = pdot(r, r)
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            init = {
                "x": x, "r": r, "rs": rs0, "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
                "it": torch.zeros((), dtype=torch.int32, device=x.device),
                "live": torch.ones((), dtype=torch.int32, device=x.device),
                "hist": gl.history(gl.sqrt_rn(rs0), maxiter),
                "part": sw.sweep_partials(r, no_max, 2 if precond and not strict else None),
            }
            z = r
            if precond:
                z = torch.zeros_like(r)
                z[:, sl] = minv[:, sl] * r[:, sl]
                init.update(minv=minv, rz=pdot(r, z))
            if fused:
                init.update(pprev=torch.zeros_like(x), beta=zero)
            else:
                p = torch.zeros_like(x)
                p[:, sl] = z[:, sl]
                init["p"] = p
            if pipelined:
                init.update(pprev=torch.zeros_like(x), alpha_prev=zero)
            if Ht:
                init["ab"] = gl.trace_ring(Ht, rs0)
        S, _ = loop.run(init)
        fn.comms_counted = tcomms.counted_profile(setup, loop.comms, loop.block)
        out = (S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy())
        return out + ((S["ab"].cpu().numpy(),) if Ht else ())

    fn.cg_body = "pipelined" if pipelined else "fused" if fused else "standard"
    fn.precond = bool(precond)
    fn.strict = strict
    fn.overlap = bool(overlap)
    fn.trace_iters = Ht
    fn.stats = loop.stats  # updated in place by every run
    fn.loop = loop
    fn.comms_kwargs = _comms_kwargs(fn, fused=fused, pipelined=pipelined)
    fn.comms_counted = None  # the counted program, after the first run
    return fn


def _comms_kwargs(fn, fused: bool = False, pipelined: bool = False, rhs_batch: Optional[int] = None,
                  sdc: bool = False, abft: bool = False, sstep: int = 0) -> dict:
    """The keywords of `telemetry.comms.cg_comms_profile` that describe a
    CG solve function's body (tpu.py:4351-4358, :5013): the model half of
    the accounting that `_run_krylov` stamps into the solve's record."""
    return dict(precond=bool(fn.precond), pipelined=bool(pipelined), fused=bool(fused), rhs_batch=rhs_batch,
                sdc=bool(sdc), abft=bool(abft), sstep=int(sstep), overlap=bool(fn.overlap), strict=bool(fn.strict))


#: rows of a chunk of the s-step Gram product (`_pgram_factory`)
GRAM_CHUNK = 8192


def _pgram_factory(o0: int, no_max: int):
    """The s-step block reduction (tpu.py:2665): ``pgram(V) -> G = V Vᵀ``
    for the owned basis V ``(P, m, no_max)`` (a basis vector a row), every
    inner product of an outer trip in one reduction. A part's rows are cut
    into chunks of GRAM_CHUNK: one batched product of the chunks, summed
    over the chunks in order, plus the tail's product, then the per-part
    (m, m) partials folded in part order (`_fold_parts`). One product over
    the whole row (k of millions against m, n of 5 to 9) ran at a fifth of
    the card's bandwidth (PERF.md, PR 17)."""

    def pgram(V):
        P, m, n = V.shape
        tcomms.count("all_gather", 1, P * m * m * V.element_size())
        C = n // GRAM_CHUNK
        part = None
        if C:
            Vc = V[:, :, : C * GRAM_CHUNK].reshape(P, m, C, GRAM_CHUNK).transpose(1, 2).reshape(P * C, m, GRAM_CHUNK)
            part = torch.bmm(Vc, Vc.transpose(1, 2)).view(P, C, m, m).sum(dim=1)
        if C * GRAM_CHUNK < n:
            tail = V[:, :, C * GRAM_CHUNK :]
            tail = torch.matmul(tail, tail.transpose(1, 2))
            part = tail if part is None else part + tail
        return _fold_parts(part)

    return pgram


def _make_sstep_cg_fn(dA: DeviceMatrix, tol: float, maxiter: int, s: int, plain: bool = False,
                      graph: bool = True, block: Optional[int] = None, overlap: bool = False,
                      trace_iters: int = 0) -> Callable:
    """The s-step (communication-avoiding) CG loop (tpu.py:4172-4262): one
    step of the device loop is one outer trip of s textbook iterations.
    The trip builds the monomial basis ``[p, Ap, .., Aˢp, r, Ar, ..,
    Aˢ⁻¹r]`` by s levels of a PAIR SpMV of the ``(P, W, 2)`` slab ``[p |
    r]``, which is the state p and r are kept in (the block body: `dia_coded_spmm` / `dia_stream_spmm` at K = 2,
    or the slab forms of SD, BSR and ELL; one halo exchange of the pair a
    level through the operator's plan), takes the whole (2s+1)-column Gram
    matrix in one part-ordered reduction (`_pgram_factory`), runs the s
    inner iterations as scalar recurrences on basis coordinates (``B``
    the static degree shift), and materialises x, r and p once at the end
    of the trip (one product of the basis with their three coordinate
    vectors). The basis is kept a vector a row, ``(P, 2s+1, no_max)``:
    interleaving it a row a point cost a transposing copy of 1.2 ms a trip
    at 192³ (PERF.md, PR 17). The residual of inner
    iteration j is sqrt(max(r_cᵀ G r_c, 0)); the stopping test is the
    textbook one, taken once a trip, so a solve can run up to s - 1
    iterations past the tolerance, and ``iterations`` counts trips x s. A
    frozen trip (the flag 0) keeps every state tensor as it was
    (``torch.where``). The inner recurrences re-associate the dots, so
    the trajectory is not the textbook one bit for bit; the Gram product
    and the trip-end products are `torch.matmul`, as the JAX package
    computes them with XLA outside any kernel. The device loop runs
    ``max(1, CG_BLOCK // s)`` trips a block. ``trace_iters`` as in
    `make_cg_fn`: inner iteration j of a trip writes its (α, β) at row
    ``(it + j) % Ht`` (tpu.py:4240-4276)."""
    from . import gpu_loop as gl

    body2 = _spmv_body(dA, plain=plain, block=True, overlap=overlap)
    body1 = _spmv_body(dA, plain=plain, overlap=overlap)
    o0, no_max = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + no_max)
    pdot = _pdot_factory(o0, no_max, False, plain)
    pgram = _pgram_factory(o0, no_max)
    stop_it = gl.stop_bound(maxiter)
    Ht = int(trace_iters)
    m_dim = 2 * s + 1
    shift = np.zeros((m_dim, m_dim))
    for i in range(s):
        shift[i + 1, i] = 1.0
    for i in range(s - 1):
        shift[s + 2 + i, s + 1 + i] = 1.0
    consts = {}

    def step(S):
        x, pr, rs, it = S["x"], S["pr"], S["rs"], S["it"]
        live = S["live"] * ((gl.sqrt_rn(rs) > S["thr"]) & (it < stop_it) & torch.isfinite(rs)).to(torch.int32)
        on = live != 0
        # the basis a vector a row, [p, Ap, .., A^s p, r, Ar, .., A^(s-1) r];
        # the first level's operand is the state's pair itself (its halo
        # refresh writes ghost slots only)
        V = torch.empty((x.shape[0], m_dim, no_max), dtype=x.dtype, device=x.device)
        V[:, 0] = pr[:, sl, 0]
        V[:, s + 1] = pr[:, sl, 1]
        cur = pr
        for lev in range(s):
            yo = body2(cur)[:, sl]
            V[:, lev + 1] = yo[..., 0]
            if lev < s - 1:
                V[:, s + 2 + lev] = yo[..., 1]
                cur = torch.zeros_like(pr)
                cur[:, sl] = yo
        G = pgram(V)
        key = (G.dtype, G.device)
        if key not in consts:
            # staged in the loop's first block, which runs eagerly before
            # any capture (a capture takes no host copies): the shift and
            # the start coordinates of p and r
            eye = np.eye(m_dim)
            consts[key] = tuple(torch.from_numpy(a).to(G.device, G.dtype) for a in (shift, eye[0], eye[s + 1]))
        Bs, p_c, r_c = consts[key]
        x_c = torch.zeros_like(p_c)
        rs_j = rs
        for j in range(s):
            w = Bs @ p_c  # the coordinates of A p_j
            den = p_c @ (G @ w)
            # a Gram residual of exactly 0 (or p_j of G-norm 0) inside the
            # trip freezes the coordinates where the textbook body would
            # have stopped: alpha and beta 0, not 0/0
            go = (rs_j > 0) & (den != 0)
            alpha = torch.where(go, rs_j / den, torch.zeros_like(den))
            x_c = x_c + alpha * p_c
            r_c = r_c - alpha * w
            rs_new = torch.where(go, torch.clamp(r_c @ (G @ r_c), min=0.0), rs_j)
            beta = torch.where(go, rs_new / rs_j, torch.zeros_like(rs_j))
            p_c = r_c + beta * p_c
            gl.record(S["hist"], it + (j + 1) * live, live, gl.sqrt_rn(rs_new))
            if Ht:
                gl.record_ab(S["ab"], it + j, live, alpha, beta)
            rs_j = rs_new
        # x, r and p from one product with the basis
        U = torch.matmul(torch.stack([x_c, r_c, p_c]), V)  # (P, 3, no_max)
        x[:, sl] = torch.where(on, x[:, sl] + U[:, 0], x[:, sl])
        pr[:, sl] = torch.where(on, torch.stack([U[:, 2], U[:, 1]], dim=-1), pr[:, sl])
        return dict(S, rs=torch.where(on, rs_j, rs), it=it + s * live, live=live)

    loop = gl.DeviceLoop(step, max(1, gl.CG_BLOCK // s) if block is None else block, graph)

    def fn(b, x0):
        with tcomms.counting() as setup:
            x = x0.clone()
            q = body1(x0.clone())
            r = torch.zeros_like(x)
            r[:, sl] = b[:, sl] - q[:, sl]
            rs0 = pdot(r, r)
            init = {
                "x": x, "pr": torch.stack([r, r], dim=-1), "rs": rs0,
                "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
                "it": torch.zeros((), dtype=torch.int32, device=x.device),
                "live": torch.ones((), dtype=torch.int32, device=x.device),
                "hist": gl.history(gl.sqrt_rn(rs0), maxiter),
            }
            if Ht:
                init["ab"] = gl.trace_ring(Ht, rs0)
        S, _ = loop.run(init)
        fn.comms_counted = tcomms.counted_profile(setup, loop.comms, loop.block, unit=s)
        out = (S["x"].clone(), S["rs"].clone(), rs0, int(S["it"].item()), S["hist"].cpu().numpy())
        return out + ((S["ab"].cpu().numpy(),) if Ht else ())

    fn.cg_body = f"sstep{s}"
    fn.precond = False
    fn.strict = False
    fn.overlap = bool(overlap)
    fn.trace_iters = Ht
    fn.stats = loop.stats
    fn.loop = loop
    fn.comms_kwargs = _comms_kwargs(fn, sstep=s)
    fn.comms_counted = None
    return fn


def make_block_cg_fn(dA: DeviceMatrix, tol: float, maxiter: int, rhs_batch: int,
                     precond: bool = False, fused: Optional[bool] = None, plain: bool = False,
                     graph: bool = True, block: Optional[int] = None, overlap: bool = False,
                     sdc=None, trace_iters: int = 0) -> Callable:
    """Block (multi-RHS) CG over ``(P, W, K)`` slabs, K = ``rhs_batch``
    right-hand sides against one operator (tpu.py:make_block_cg_fn,
    :4362-5020, its fused and standard bodies, with and without
    ``precond``): ``fn(b, x0, minv=None) -> (x, rs, rs0, iterations,
    history)`` with x (P, W, K), rs and rs0 (K,) device tensors, the
    per-column iterations a (K,) int array and the (H, K) history, NaN past
    each column's freeze. Every iteration streams the operator once for
    the K columns (`dia_coded_spmm` / `dia_stream_spmm`, the fused body's
    fold riding the coded product), exchanges (P, W, K) slabs and sweeps
    all columns in one `cg_sweep_block` launch; the dots write their
    products once, column by column (`ops/sweep.py:block_products`).

    Each column follows the textbook single-vector recurrence of
    `make_cg_fn` exactly: its products, exchanges, dots (`_block_pdot_factory`)
    and sweep partials are those of the solo solve of that column, in the
    same order, so column k takes the solo solve's iterations and, at K =
    1, its values bit for bit. A column is active while its solo loop would
    run (sqrt(rs) > tol*max(1, sqrt(rs0)), rs finite, r.z != 0 with
    precond, it < maxiter); an inactive column is frozen, not removed: its
    alpha is 0, the sweep writes none of its state, its scalars are kept
    by ``torch.where`` (tpu.py:4466-4471), and its direction is refolded
    with beta 0 so that nothing of it grows while it waits. The device
    loop (`gpu_loop.DeviceLoop`, blocks of ``block`` iterations, a CUDA
    graph on the card unless ``graph=False``) runs while some column is
    active and ``it < maxiter``.

    Every lowering takes it: a band (the coded and streaming SpMMs) and
    SD, BSR and ELL (their slab products, `_irregular_aoo`, and the
    boundary modes on slabs). On a strict lowering (``dA.strict``) it
    follows `make_cg_fn`'s strict rules (tpu.py:4440): the standard body
    is the default (``fused=True`` is honoured), the block sweep updates x
    and r, and r.r, p.q and, with ``precond``, r.z of the stored z =
    minv*r are E3's block dots (`_block_pdot_factory(strict=True)`), so
    column k takes the host's strict solo loop of column k bit for bit.
    ``overlap`` as in `make_cg_fn`; ``sdc`` builds the SDC-defended block
    loop (`gpu_sdc.make_sdc_block_cg_fn`, tpu.py:4411-4860): (K,) checksum
    and audit lanes, a rollback restores the whole block.

    ``trace_iters`` adds the block's α/β ring (tpu.py:4417-4422,
    :4900-4972): ``(Ht, 2, K)``, written at row ``it % Ht`` (``it`` the
    loop's trip count, the slowest column's) on every live trip, a frozen
    column's α 0; ``fn`` returns it as a sixth value. The defended block
    loop has none (Ht 0, as in the JAX package)."""
    from . import gpu_loop as gl
    from ..ops import sweep as sw

    K = int(rhs_batch)
    check(K >= 1, "make_block_cg_fn: rhs_batch must be >= 1")
    strict = dA.strict
    fused = (not strict) if fused is None else bool(fused)
    overlap = bool(overlap) and _can_overlap(dA, fused)
    cfg = _sdc_config(sdc, maxiter)
    Ht = 0 if cfg is not None else int(min(max(0, int(trace_iters)), int(maxiter)))
    if cfg is not None:
        from .gpu_sdc import make_sdc_block_cg_fn

        return make_sdc_block_cg_fn(dA, tol, maxiter, K, cfg, fused, precond, plain, graph, block)
    body = _spmv_body(dA, plain=plain, block=True, overlap=overlap)
    body_pfold = _spmv_body(dA, pfold=True, plain=plain, block=True, overlap=overlap) if fused else None
    sweep = _counted_sweep(sw.cg_sweep_block_plain if plain else sw.cg_sweep_block)
    o0, no_max = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + no_max)
    bdot = _block_pdot_factory(o0, no_max, plain, strict)
    stop_it = gl.stop_bound(maxiter)

    def step(S):
        rs, it, armed = S["rs"], S["it"], S["live"]
        rz = S["rz"] if precond else rs
        go = (gl.sqrt_rn(rs) > S["thr"]) & torch.isfinite(rs) & (it < stop_it) & (armed != 0)
        if precond:
            go = go & (rz != 0)
        act = go.to(torch.int32)
        on = act != 0
        live = act.amax()
        out = dict(S)
        mv = S["minv"] if precond else None
        if fused:
            q, p = body_pfold(S["r"], S["pprev"], torch.where(on, S["beta"], 0), minv=mv)
        else:
            p = S["p"]
            q = body(p)
        alpha = torch.where(on, rz / bdot(p, q), 0)
        if strict:
            # the sweep updates x and r; the dots are E3's block form
            sweep(S["r"], q, alpha, act, S["part"], o0, no_max, x=S["x"], p=p)
            rs_new = bdot(S["r"], S["r"])
            if precond:
                z = torch.zeros_like(S["r"])
                z[:, sl] = mv[:, sl, None] * S["r"][:, sl]
                rz_new = bdot(S["r"], z)
                out["rz"] = torch.where(on, rz_new, rz)
        elif precond:
            rz_new, rs_new = sweep(S["r"], q, alpha, act, S["part"], o0, no_max, x=S["x"], p=p, minv=mv)
            out["rz"] = torch.where(on, rz_new, rz)
        else:
            rs_new = sweep(S["r"], q, alpha, act, S["part"], o0, no_max, x=S["x"], p=p)
        beta = (rz_new if precond else rs_new) / rz
        if fused:
            beta = torch.where(on, beta, S["beta"])
            out["pprev"], out["beta"] = p, beta
        else:
            beta = torch.where(on, beta, 0)
            z = mv[:, sl, None] * S["r"][:, sl] if precond else S["r"][:, sl]
            p[:, sl] = z + beta * p[:, sl]
        if Ht:
            gl.record_ab(S["ab"], it, live, alpha, beta)
        out.update(rs=torch.where(on, rs_new, rs), it=it + live, itk=S["itk"] + act, live=live)
        gl.record(S["hist"], out["it"], act, gl.sqrt_rn(rs_new))
        return out

    loop = gl.DeviceLoop(step, gl.CG_BLOCK if block is None else block, graph)

    def fn(b, x0, minv=None):
        check(tuple(b.shape) == tuple(x0.shape) and b.dim() == 3 and b.shape[2] == K,
              f"block cg: operands laid out {tuple(b.shape)}/{tuple(x0.shape)}, the function expects "
              f"(P, W, {K}) slabs in the matrix's column layout")
        check((minv is not None) == precond,
              "make_block_cg_fn: pass minv exactly when the function was built with precond")
        with tcomms.counting() as setup:
            x = x0.clone()
            q = body(x0.clone())
            r = torch.zeros_like(x)
            r[:, sl] = b[:, sl] - q[:, sl]
            rs0 = bdot(r, r)
            dev = x.device
            init = {
                "x": x, "r": r, "rs": rs0, "thr": tol * torch.clamp(gl.sqrt_rn(rs0), min=1.0),
                "it": torch.zeros((), dtype=torch.int32, device=dev),
                "itk": torch.zeros((K,), dtype=torch.int32, device=dev),
                "live": torch.ones((), dtype=torch.int32, device=dev),
                "hist": gl.history(gl.sqrt_rn(rs0), maxiter),
                "part": sw.sweep_partials(r, no_max, 2 * K if precond and not strict else K),
            }
            z = r
            if precond:
                z = torch.zeros_like(r)
                z[:, sl] = minv[:, sl, None] * r[:, sl]
                init.update(minv=minv, rz=bdot(r, z))
            if fused:
                init.update(pprev=torch.zeros_like(x), beta=torch.zeros((K,), dtype=x.dtype, device=dev))
            else:
                p = torch.zeros_like(x)
                p[:, sl] = z[:, sl]
                init["p"] = p
            if Ht:
                init["ab"] = gl.trace_ring(Ht, rs0, K)
        S, _ = loop.run(init)
        fn.comms_counted = tcomms.counted_profile(setup, loop.comms, loop.block)
        out = (S["x"].clone(), S["rs"].clone(), rs0, S["itk"].cpu().numpy().astype(np.int64),
               S["hist"].cpu().numpy())
        return out + ((S["ab"].cpu().numpy(),) if Ht else ())

    fn.cg_body = "fused" if fused else "standard"
    fn.precond = bool(precond)
    fn.strict = strict
    fn.overlap = bool(overlap)
    fn.rhs_batch = K
    fn.trace_iters = Ht
    fn.stats = loop.stats
    fn.loop = loop
    fn.comms_kwargs = _comms_kwargs(fn, fused=fused, rhs_batch=K)
    fn.comms_counted = None
    return fn


#: solve functions built by `_krylov_fn_for` and `gpu_gmg.fgmres_gmg_fn`
#: (cache misses) since import; callers reset or difference it
STATS = {"solve_fns": 0}


def _count_program(hit: bool, method: str) -> None:
    """A solve-function cache lookup into the telemetry: the counter
    ``program_cache.{hit,miss}`` and a ``compile_cache`` event
    (tpu.py:6372-6391)."""
    from .. import telemetry

    action = "hit" if hit else "miss"
    telemetry.bump(f"program_cache.{action}")
    telemetry.emit_event("compile_cache", label=f"program_{action}", cache="program", action=action,
                         method=method)


def _krylov_fn_for(dA: DeviceMatrix, method: str, tol: float, maxiter: int, precond: bool = False,
                   pipelined: bool = False, fused: Optional[bool] = None, plain: bool = False,
                   rhs_batch: Optional[int] = None, sstep: Optional[int] = None, overlap: bool = False,
                   sdc=None, trace_iters: int = 0, **options) -> Callable:
    """The solve function of ``method`` on ``dA``, cached on it
    (tpu.py:6308-6392, ``dA._cg_cache``): one function, and so one
    `gpu_loop.DeviceLoop` with its captured graph, per key. The key holds
    method, tol, maxiter, precond, the concrete CG body (s-step depth,
    pipelined, fused: resolved as `make_cg_fn` resolves them, refusing the
    conflicts of an explicit s-step depth), the overlap tail where the body
    has one (`_can_overlap`; elsewhere the key is ``overlap=False``'s), plain, the
    block width K and the method's own options (GMRES's restart, Chebyshev's
    bounds and leg), the SDC config's key (`_sdc_config`) and the
    effective trace-ring depth (tpu.py:6334-6370: ``min(trace_iters,
    maxiter)``, 0 for a body without a ring: the pipelined CG, the
    defended block loop and every other method, which emit a
    ``trace_unavailable`` event when a depth was asked for), so a
    defended or traced solve never replays an undefended or untraced
    loop's graph, nor the reverse. A hit copies the next b and x0 into the
    loop's buffers and replays its graph. Hits and misses count under
    ``program_cache.{hit,miss}`` with a ``compile_cache`` event.
    Methods: ``"cg"`` (`make_cg_fn`, or with ``rhs_batch``
    `make_block_cg_fn`), ``"bicgstab"``, ``"gmres"``, ``"minres"``,
    ``"chebyshev"`` (`gpu_krylov.py`)."""
    from . import gpu_krylov as kr

    eff_sstep = 0
    cfg = _sdc_config(sdc, maxiter)
    check(method == "cg" or cfg is None, f"_krylov_fn_for: {method} has no SDC-defended loop")
    if method == "cg":
        eff_sstep, fused = _resolve_cg_body(sstep, fused, pipelined, precond, dA.strict, rhs_batch,
                                            sdc=cfg is not None)
    overlap = method == "cg" and cfg is None and bool(overlap) and _can_overlap(dA, fused)
    requested = max(0, int(trace_iters))
    if method != "cg" or pipelined or (rhs_batch is not None and cfg is not None):
        trace_ht = 0
        if requested:
            from .. import telemetry

            body = "pipelined" if pipelined else "sdc-block" if method == "cg" else method
            telemetry.emit_event(
                "trace_unavailable", label=body, requested=requested, method=method,
                reason="this body carries no alpha/beta trace ring — spectral estimates fall back to the "
                       "residual history",
            )
    else:
        trace_ht = int(min(requested, int(maxiter)))
    key = (method, float(tol), int(maxiter), bool(precond), bool(pipelined), fused, bool(plain),
           rhs_batch, eff_sstep, bool(overlap), cfg["key"] if cfg else None,
           trace_ht) + tuple(sorted(options.items()))
    _count_program(key in dA._fn_cache, method)
    if key not in dA._fn_cache:
        if method == "cg" and rhs_batch is None:
            fn = make_cg_fn(dA, tol, maxiter, fused=fused, pipelined=pipelined, plain=plain, precond=precond,
                            sstep=eff_sstep, overlap=overlap, sdc=sdc, trace_iters=trace_ht)
        elif method == "cg":
            fn = make_block_cg_fn(dA, tol, maxiter, rhs_batch, precond=precond, fused=fused, plain=plain,
                                  overlap=overlap, sdc=sdc, trace_iters=trace_ht)
        elif method == "bicgstab":
            fn = kr.make_bicgstab_fn(dA, tol, maxiter, precond=precond, plain=plain)
        elif method == "gmres":
            fn = kr.make_gmres_fn(dA, options["restart"], tol, maxiter, precond=precond, plain=plain)
        elif method == "minres":
            fn = kr.make_minres_fn(dA, tol, maxiter, plain=plain)
        elif method == "chebyshev":
            fn = kr.make_chebyshev_fn(dA, options["lmin"], options["lmax"], tol, maxiter, plain=plain)
        else:
            raise ValueError(f"_krylov_fn_for: unknown method {method!r}")
        STATS["solve_fns"] += 1
        dA._fn_cache[key] = fn
    return dA._fn_cache[key]


def _b_on_cols_layout(b: PVector, dA: DeviceMatrix) -> torch.Tensor:
    """b lives on A.rows (no ghosts); the CG keeps every vector in the
    cols layout (same owned gids). Restack b's owned values there (also
    the staging of a Jacobi minv: its owned inverse diagonal)."""
    layout = dA.col_layout
    stacked = np.zeros((layout.P, layout.W), dtype=b.dtype)
    for p, (iset, vals) in enumerate(zip(b.rows.partition.part_values(), b.values.part_values())):
        stacked[p, layout.o0 : layout.o0 + iset.num_oids] = _owned(iset, np.asarray(vals))
    return torch.from_numpy(stacked).to(dA.backend.device)


def _block_on_cols_layout(Bs, dA: DeviceMatrix, with_ghosts: bool = False) -> torch.Tensor:
    """K column PVectors as one ``(P, W, K)`` slab in the matrix's column
    layout (tpu.py:6004): the owned values, and with ``with_ghosts`` the
    ghost slots too (start vectors that carry a halo)."""
    layout = dA.col_layout
    dt = np.result_type(*[b.dtype for b in Bs])
    stacked = np.zeros((layout.P, layout.W, len(Bs)), dtype=dt)
    for k, b in enumerate(Bs):
        for p, (iset, vals) in enumerate(zip(b.rows.partition.part_values(), b.values.part_values())):
            vals = np.asarray(vals)
            stacked[p, layout.o0 : layout.o0 + iset.num_oids, k] = _owned(iset, vals)
            if with_ghosts:
                stacked[p, layout.hid_slots[p], k] = _ghost(iset, vals)
    return torch.from_numpy(stacked).to(dA.backend.device)


def _decode_sdc_outputs(name: str, sdcvec, it=None) -> dict:
    """The one decode of a defended loop's SDC output lanes (tpu.py:5783-5830,
    shared by `_run_krylov` and `gpu_block_cg`): returns ``info["sdc"]``
    (``detections``, ``rollbacks``, ``escalations``, ``audit_iterations``,
    ``trips``), or raises `SilentCorruptionError` with them under
    ``diagnostics["sdc"]`` when the loop latched its escalation: corruption
    kept firing past the in-memory rollback budget."""
    from ..utils.health import SilentCorruptionError
    from .gpu_sdc import SDC_LANES

    v = dict(zip(SDC_LANES, (int(t) for t in np.asarray(sdcvec))))
    sdc_info = {"detections": v["detections"], "rollbacks": v["rollbacks"],
                "escalations": int(bool(v["escalations"])), "audit_iterations": v["audit_iterations"],
                "trips": v["trips"]}
    if sdc_info["detections"] or sdc_info["rollbacks"] or sdc_info["escalations"]:
        # the loop reports counters only (its detections fired on the
        # device): one structured event each, so no device recovery is
        # silent in the record (tpu.py:5803-5818)
        from .. import telemetry

        iteration = None if it is None else int(it)
        telemetry.emit_event("sdc_detection", label=name, iteration=iteration, **sdc_info)
        if sdc_info["rollbacks"]:
            telemetry.emit_event("sdc_rollback", label=name, iteration=iteration,
                                 rollbacks=sdc_info["rollbacks"])
    if sdc_info["escalations"]:
        diag = {"context": name, "sdc": sdc_info}
        if it is not None:
            diag["iteration"] = int(it)
        raise SilentCorruptionError(
            f"{name}: in-graph SDC detection exhausted the rollback budget ({sdc_info['rollbacks']} rollbacks, "
            f"{sdc_info['detections']} detections)" + (f" at device iteration {it}" if it is not None else "")
            + "; escalating to checkpoint restart",
            diagnostics=diag,
        )
    return sdc_info


def _exchange_plan_name(dA: DeviceMatrix) -> str:
    """The exchange plan a lowering runs: ``"box"`` or ``"generic"``."""
    return "box" if dA.col_layout.box_info is not None else "generic"


def _run_krylov(A: PSparseMatrix, b: PVector, x0: Optional[PVector], tol: float,
                verbose: bool, solve: Callable, name: str, box: bool = True,
                minv: Optional[PVector] = None, dA: Optional[DeviceMatrix] = None,
                health: bool = True, **extra) -> Tuple[PVector, dict]:
    """Shared device-Krylov driver (tpu.py:_run_krylov): stage b and x0 in
    the column layout of A's lowering ``dA`` (by default the one for
    ``box``), and a Jacobi ``minv`` (its owned values), run ``solve(b, x0[, minv]) -> (x, rs, rs0, it,
    history[, sdc])``, lift the result back to a host PVector and build the info
    dict: the history cut to ``it + 1`` entries (at most its length),
    ``device_loop`` the solve's `fn.stats` (loop form, block, device
    iterations), and ``extra`` keys merged in.

    A defended loop (``solve.has_sdc``) adds ``info["sdc"]`` and raises
    `SilentCorruptionError` on its escalation (`_decode_sdc_outputs`). With
    ``health`` (the JAX package's ``PA_HEALTH_CHECKS``) a non-finite rs or
    rs0, which the loop's in-graph finite test stopped on, raises
    `NonFiniteError` with ``diagnostics["iteration"]`` (tpu.py:5903-5924)
    instead of returning a NaN answer marked only as not converged.

    Telemetry (tpu.py:5841-5945): staging and solve run under
    `telemetry.annotate`; a traced loop's ring (``solve.trace_iters``)
    lands on the active record as ``alpha``/``beta``, unrolled
    (`gpu_loop.unroll_ring`) with ``trace_start``, before any typed raise;
    a CG or PCG solve then feeds `telemetry.observe_solve`."""
    from .. import telemetry
    from ..models.solvers import _final_true_rel
    from ..utils.health import NonFiniteError
    from . import gpu_loop as gl

    backend = b.values.backend
    floor_warned = warn_tol_below_floor(tol, b.dtype, name=name)
    rec = telemetry.current_record()
    with telemetry.annotate(f"pa:{name}:stage", backend.device):
        dA = dA if dA is not None else device_matrix(A, backend, box)
        x0 = x0 if x0 is not None else PVector.full(0.0, A.cols, dtype=b.dtype)
        db = _b_on_cols_layout(b, dA)
        dx0 = DeviceVector.from_pvector(x0, backend, dA.col_layout)
        args = (db, dx0.data) if minv is None else (db, dx0.data, _b_on_cols_layout(minv, dA).to(db.dtype))
    with telemetry.annotate(f"pa:{name}:solve", backend.device):
        out = solve(*args)
    x_data, rs, rs0, it, hist = out[:5]
    has_sdc = getattr(solve, "has_sdc", False)
    ab = out[6 if has_sdc else 5] if getattr(solve, "trace_iters", 0) else None
    hist = hist[: min(it + 1, len(hist))]  # entries past the last iteration are NaN
    x = DeviceVector(x_data, A.cols, dA.col_layout, backend).to_pvector()
    rs, rs0 = float(rs), float(rs0)
    if ab is not None and rec is not None and rec.enabled:
        rows, n, rec.trace_start = gl.unroll_ring(ab, it)
        rec.alpha = [float(v) for v in rows[:n, 0]]
        rec.beta = [float(v) for v in rows[:n, 1]]
    # the comms accounting, before the typed raises below: an aborted
    # record carries it too; a defended loop pays its collectives on every
    # trip (commit, audit, restore), so it counts trips (tpu.py:5890-5899)
    _stamp_comms(rec, solve, dA, b.dtype, int(np.asarray(out[5])[4]) if has_sdc else it)
    if verbose:
        for i, res in enumerate(hist[1:], start=1):
            print(f"{name} it={i} residual={res:.3e}")
    if has_sdc:
        extra["sdc"] = _decode_sdc_outputs(name, out[5], it=it)
    if health and not (np.isfinite(rs) and np.isfinite(rs0)):
        # the loop stopped on its in-graph finite test, one iteration after
        # the poison entered
        raise NonFiniteError(
            f"{name}: non-finite residual after {it} device iterations (rs={rs!r}): the solver state was "
            "NaN/Inf-poisoned",
            diagnostics={"context": name, "iteration": it, "rs": rs,
                         "residual_tail": [float(v) for v in hist[-4:]]},
        )
    converged = bool(np.sqrt(rs) <= tol * max(1.0, np.sqrt(rs0)))
    info = krylov_info(
        it, hist, converged, tol, b.dtype, floor_warned,
        final_rel=_final_true_rel(
            A, x, b, np.sqrt(rs) / max(1.0, np.sqrt(rs0)), np.sqrt(rs0), tol,
            force=floor_warned,
        ),
        device_loop=dict(solve.stats), **extra,
    )
    if name in ("cg", "pcg"):
        # CG family only: the store's Lanczos and κ-rate semantics are CG's
        telemetry.observe_solve(A, rec, info=info, dtype=b.dtype, minv=minv)
    return x, info


def gpu_cg(
    A: PSparseMatrix,
    b: PVector,
    x0: Optional[PVector] = None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    verbose: bool = False,
    fused: Optional[bool] = None,
    pipelined: bool = False,
    plain: bool = False,
    box: bool = True,
    minv: Optional[PVector] = None,
    strict: bool = False,
    lowering: str = "auto",
    sstep: Optional[int] = None,
    overlap: bool = False,
    health: bool = True,
    sdc=None,
    trace_iters: int = 0,
) -> Tuple[PVector, dict]:
    """Device CG on the GPU backend, the counterpart of `tpu_cg`
    (tpu.py:5952): the fused body by default, the lag-1 form with
    ``pipelined``, the textbook body with ``fused=False``; with a diagonal
    ``minv`` (an inverse-diagonal PVector over A.cols) Jacobi PCG in the
    fused or the standard body. ``plain=True`` runs the kernels' plain
    versions on the card instead (the comparison path of chip_smoke.py).
    ``box=False`` lowers A on the generic layout and exchange plan instead
    of the box ones; ``lowering`` names the first non-band lowering tried
    (`DeviceMatrix`). ``strict`` (strict-bits mode) lowers A to ELL on the
    generic plan and runs the standard body with E3's dots: the iterations,
    residual history and solution of the host's strict loop, bit for bit.
    ``sstep=s`` (s >= 2) runs the s-step body (`make_cg_fn`) on the same
    lowering; ``overlap`` the interior/boundary overlap tail on every body
    whose schedule has one (`_can_overlap`).
    The info dict records the body under ``cg_body`` (``"sstep<s>"`` for
    the s-step body), the lowering under ``lowering`` and the exchange plan
    under ``exchange_plan``.

    ``sdc`` (an `SDCConfig`) runs the in-graph SDC defense (`gpu_sdc`) and
    adds ``info["sdc"]``; under ``abft`` a Cartesian partition takes the
    generic exchange plan (the checksummed rounds are the generic plan's,
    tpu.py:791-805). ``health`` as in `_run_krylov`. ``trace_iters``: the
    α/β trace ring (`make_cg_fn`; the pipelined body has none), unrolled
    onto the solve's record (``info.record.alpha``/``beta``). The solve
    runs in a `telemetry.solve_scope` (tpu.py:5987-6000): ``info`` is an
    `InfoDict` carrying its `SolveRecord`."""
    from .. import telemetry
    from ..utils.health import resolve_sdc

    backend = b.values.backend
    check(isinstance(backend, GPUBackend), "gpu_cg needs a GPU-backend PVector")
    maxiter = maxiter if maxiter is not None else 4 * A.rows.ngids
    sdc = resolve_sdc(sdc)
    if sdc is not None and sdc.abft:
        box = False
    name = "pcg" if minv is not None else "cg"
    with telemetry.solve_scope(name, backend="gpu", tol=float(tol), maxiter=int(maxiter),
                               dtype=str(np.dtype(b.dtype))) as rec:
        dA = device_matrix(A, backend, box, strict=strict, lowering=lowering)
        solve = _krylov_fn_for(dA, "cg", tol, int(maxiter), precond=minv is not None, pipelined=pipelined,
                               fused=fused, plain=plain, sstep=sstep, overlap=overlap, sdc=sdc,
                               trace_iters=trace_iters)
        rec.config["cg_body"] = solve.cg_body
        x, info = _run_krylov(A, b, x0, tol, verbose, solve, name, minv=minv, dA=dA, health=health,
                              cg_body=solve.cg_body, lowering=dA.lowering, strict=dA.strict,
                              exchange_plan=_exchange_plan_name(dA))
        return x, rec.finish(info)


def gpu_block_cg(
    A: PSparseMatrix,
    B,
    X0=None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    verbose: bool = False,
    minv: Optional[PVector] = None,
    fused: Optional[bool] = None,
    column_errors: str = "raise",
    plain: bool = False,
    box: bool = True,
    strict: bool = False,
    lowering: str = "auto",
    overlap: bool = False,
    sdc=None,
    trace_iters: int = 0,
) -> Tuple[list, dict]:
    """Device block (multi-RHS) CG on the GPU backend, the counterpart of
    `tpu_block_cg` / `_tpu_block_cg_impl` (tpu.py:6025-6275): solve ``A x_k
    = b_k`` for every right-hand side in ``B`` (PVectors over A.rows) in
    one device loop (`make_block_cg_fn`), the shared diagonal ``minv``
    preconditioning every column. Returns ``(xs, info)``: the K solutions
    and an info dict with one krylov info per column under ``columns``
    (each column's trajectory its solo `gpu_cg` trajectory), the
    worst-column aggregates, ``iterations_per_column``, ``rhs_batch``,
    ``cg_body``, ``lowering``, ``strict`` and ``column_health`` (a
    ``{"status", "converged", "iterations"}`` verdict per column, status
    ``"ok"`` or ``"nonfinite"``). ``column_errors="raise"`` raises
    `NonFiniteError` naming the columns whose residual is not finite;
    ``"report"`` marks them in their column info and verdict and raises
    nothing. ``box``, ``strict`` and ``lowering`` as in `gpu_cg`: on a
    strict lowering every column is the host's strict solo solve of that
    column, bit for bit. ``sdc`` as in `gpu_cg` (the block's defended
    loop: per-column lanes, whole-block rollback). ``trace_iters``: the
    block's α/β ring (`make_block_cg_fn`), unrolled onto the record per
    column (``rec.alpha[k]``), the trips after column k froze masked
    ``None`` (tpu.py:6127-6160). The solve runs in a
    `telemetry.solve_scope` (tpu.py:6074-6085); a non-finite column under
    ``"report"`` emits a ``column_verdict`` event."""
    from .. import telemetry

    check(column_errors in ("raise", "report"), "gpu_block_cg: column_errors is 'raise' or 'report'")
    B = list(B)
    K = len(B)
    check(K >= 1, "gpu_block_cg: B must hold at least one right-hand side")
    backend = B[0].values.backend
    check(isinstance(backend, GPUBackend), "gpu_block_cg needs GPU-backend PVectors")
    maxiter = int(maxiter if maxiter is not None else 4 * A.rows.ngids)
    dt = np.result_type(*[b.dtype for b in B])
    name = "block-pcg" if minv is not None else "block-cg"
    with telemetry.solve_scope(name, backend="gpu", tol=float(tol), maxiter=maxiter, rhs_batch=K,
                               dtype=str(np.dtype(dt))) as rec:
        xs, info = _gpu_block_cg_impl(A, B, X0, tol, maxiter, verbose, minv, fused, column_errors, plain, box,
                                      strict, lowering, overlap, sdc, trace_iters, K, backend, dt, name, rec)
        return xs, rec.finish(info)


def _gpu_block_cg_impl(A, B, X0, tol, maxiter, verbose, minv, fused, column_errors, plain, box, strict,
                       lowering, overlap, sdc, trace_iters, K, backend, dt, name, rec):
    from .. import telemetry
    from ..models.solvers import _final_true_rel
    from ..utils.health import NonFiniteError, resolve_sdc

    sdc = resolve_sdc(sdc)
    if sdc is not None and sdc.abft:
        box = False
    with telemetry.annotate(f"pa:{name}:stage", backend.device):
        dA = device_matrix(A, backend, box, strict=strict, lowering=lowering)
        solve = _krylov_fn_for(dA, "cg", tol, maxiter, precond=minv is not None, fused=fused, plain=plain,
                               rhs_batch=K, overlap=overlap, sdc=sdc, trace_iters=trace_iters)
        rec.config["cg_body"] = solve.cg_body
        floor_warned = warn_tol_below_floor(tol, dt, name="block-cg")
        db = _block_on_cols_layout(B, dA)
        if X0 is None:
            X0 = [PVector.full(0.0, A.cols, dtype=dt) for _ in range(K)]
        else:
            X0 = list(X0)
            check(len(X0) == K, "gpu_block_cg: X0 must hold one start per RHS")
        dx0 = _block_on_cols_layout(X0, dA, with_ghosts=True).to(db.dtype)
        args = (db, dx0) if minv is None else (db, dx0, _b_on_cols_layout(minv, dA).to(db.dtype))
    with telemetry.annotate(f"pa:{name}:solve", backend.device):
        out = solve(*args)
    x_data, rs, rs0, itk, hist = out[:5]
    has_sdc = getattr(solve, "has_sdc", False)
    if getattr(solve, "trace_iters", 0) and rec.enabled:
        _attach_block_ring(rec, out[6 if has_sdc else 5], itk)
    _stamp_comms(rec, solve, dA, dt, int(np.asarray(out[5])[4]) if has_sdc else int(np.asarray(itk).max()))
    sdc_info = _decode_sdc_outputs(name, out[5], it=int(itk.max())) if has_sdc else None
    rs = rs.cpu().numpy().astype(np.float64)
    rs0 = rs0.cpu().numpy().astype(np.float64)
    xs, columns = [], []
    for k in range(K):
        x = DeviceVector(x_data[..., k].contiguous(), A.cols, dA.col_layout, backend).to_pvector()
        xs.append(x)
        it_k = int(itk[k])
        residuals = hist[: min(it_k + 1, hist.shape[0]), k]
        if verbose:
            for i, rv in enumerate(residuals[1:], start=1):
                print(f"{name} col={k} it={i} residual={rv:.3e}")
        columns.append(krylov_info(
            it_k, residuals, bool(np.sqrt(rs[k]) <= tol * max(1.0, np.sqrt(rs0[k]))), tol, dt, floor_warned,
            final_rel=_final_true_rel(
                A, x, B[k], np.sqrt(rs[k]) / max(1.0, np.sqrt(rs0[k])), np.sqrt(rs0[k]), tol,
                force=floor_warned,
            ),
        ))
    bad = [k for k in range(K) if not np.isfinite(rs[k])]
    column_health = [
        {"status": "nonfinite" if k in bad else "ok", "converged": bool(columns[k]["converged"]),
         "iterations": int(itk[k])}
        for k in range(K)
    ]
    if bad:
        if column_errors == "report":
            for k in bad:
                columns[k]["status"] = "nonfinite"
                columns[k]["converged"] = False
            telemetry.emit_event("column_verdict", label=name, columns=bad, iterations=[int(itk[k]) for k in bad])
        else:
            raise NonFiniteError(
                f"{name}: non-finite residual in column(s) {bad}: those columns' solver state was "
                "NaN/Inf-poisoned (each froze one iteration after the poison entered; the other "
                "columns completed normally)",
                diagnostics={"context": name, "columns": bad, "iterations": [int(itk[k]) for k in bad],
                             "rs": [float(rs[k]) for k in bad]},
            )
    # an unconverged column wins the aggregate over a merely slow one
    bad_cols = [k for k in range(K) if not columns[k]["converged"]]
    worst = max(bad_cols, key=lambda k: int(itk[k])) if bad_cols else int(np.argmax(itk))
    info = {
        "iterations": int(itk.max()),
        "iterations_per_column": [int(v) for v in itk],
        "residuals": columns[worst]["residuals"],
        "converged": not bad_cols,
        "status": columns[worst]["status"],
        "columns": columns,
        "column_health": column_health,
        "rhs_batch": K,
        "cg_body": solve.cg_body,
        "lowering": dA.lowering,
        "strict": dA.strict,
        "exchange_plan": _exchange_plan_name(dA),
        "device_loop": dict(solve.stats),
    }
    if sdc_info is not None:
        info["sdc"] = sdc_info
    if floor_warned:
        info["tol_below_dtype_floor"] = True
    # per-column spectral estimates from the block ring, before the finish
    telemetry.observe_solve(A, rec, info=info, dtype=dt, minv=minv)
    return xs, info


def _stamp_comms(rec, solve: Callable, dA: DeviceMatrix, dtype, units: int) -> None:
    """``rec.comms``: the model inventory of a CG solve function's body
    (``solve.comms_kwargs``, `telemetry.comms.cg_comms_profile`) evaluated
    at ``units`` iterations (trips for a defended loop), and beside it
    ``rec.comms_counted``, the counted program of the same function, on an
    enabled record of a function that has one."""
    ck = getattr(solve, "comms_kwargs", None)
    if ck is not None and rec is not None and rec.enabled:
        rec.comms = tcomms.observed_comms(tcomms.cg_comms_profile(dA, dtype, **ck), units)
        rec.comms_counted = solve.comms_counted


def _attach_block_ring(rec, ab: np.ndarray, itk: np.ndarray) -> None:
    """The block ring ``(Ht, 2, K)`` on a record (tpu.py:6127-6160): its
    rows are indexed by the loop's trip count, the slowest column's
    iterations, so it is unrolled once for all columns; column k's lists
    hold ``None`` on the trips after it froze."""
    from . import gpu_loop as gl

    itks = np.asarray(itk).astype(int).ravel()
    rows, n, rec.trace_start = gl.unroll_ring(ab, int(itks.max()))
    live = [[rec.trace_start + j < itks[k] for j in range(n)] for k in range(len(itks))]
    rec.alpha = [[float(rows[j, 0, k]) if live[k][j] else None for j in range(n)] for k in range(len(itks))]
    rec.beta = [[float(rows[j, 1, k]) if live[k][j] else None for j in range(n)] for k in range(len(itks))]
