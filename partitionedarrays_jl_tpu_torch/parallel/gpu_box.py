"""Box halo exchange for Cartesian partitions: per-direction slab moves
into contiguous ghost segments.

The port's copy of `partitionedarrays_jl_tpu/parallel/tpu_box.py`. The
generic plan (`gpu.py:DeviceExchangePlan`) packs and unpacks with index
vectors, edge by edge in colour rounds. This module detects the box
structure of a Cartesian partition, whose per-part owned ids are a
C-order scan of an axis-aligned box, and lowers the same Exchanger to:

* pack: a static slab of the sender's owned box;
* move: sender -> receiver, one partial permutation of the parts per
  geometric direction;
* unpack: a contiguous store into a per-direction ghost SEGMENT of the
  receiver.

The ghost region of the device layout is reordered into those segments
through the layout's slot maps only (``DeviceLayout.lid_slots`` /
``hid_slots``); host lid order is untouched. Each direction's segment is
the sender's slab in C-order scan, so the sender's slab order is the
receiver's slot order. Unequal Cartesian splits give at most 2^d box
shapes, each a pack-slice VARIANT; inactive parts (no owned ids, no
ghosts) are a degenerate variant that never sends. Anything else
(irregular graphs, partial shells that are not slabs, ambiguous periodic
wraps) returns None and the caller keeps the generic plan.

The analysis is host NumPy and the same as the JAX package's, so both
packages take the same plan on the same partition. The exchange body
works on stacked ``(P, W)`` tensors: the JAX package's per-shard
``lax.switch`` over variants and its ``ppermute`` per direction are
resolved at plan time into slot indices over the whole stacked frame, so
an exchange is a few index launches whatever the number of directions
and variants (per-direction slab moves cost more host time than the
generic plan's rounds).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE
from .prange import PRange


class BoxDir:
    """One geometric direction of the box exchange (tpu_box.py:45): a
    static sender slab PER BOX-SHAPE VARIANT (start and shape relative to
    the owned box), the receiver segment's offset into the ghost region,
    and the sender -> receiver pairs. The segment is sized to the largest
    variant's slab."""

    __slots__ = ("dir", "geo", "off", "size", "perm")

    def __init__(self, dir, geo, off, perm):
        self.dir = tuple(dir)
        #: per variant: (start, shape) of the pack slice; a degenerate
        #: in-bounds slice for variants with no edge in this direction
        self.geo = tuple(
            (tuple(int(x) for x in s), tuple(int(x) for x in sh)) for s, sh in geo
        )
        self.off = int(off)
        self.size = max(int(math.prod(sh)) for _, sh in self.geo)
        self.perm = tuple(perm)


class BoxInfo:
    """Result of `analyze_box_structure` (tpu_box.py:81), all host-side."""

    __slots__ = (
        "box_shapes", "variants", "dirs", "nh_total", "ghost_rel_slots", "seg_mask", "P",
    )

    def __init__(self, box_shapes, variants, dirs, nh_total, ghost_rel_slots, seg_mask, P):
        #: distinct per-part owned-box shapes (sorted) and each part's
        #: index into them
        self.box_shapes = tuple(tuple(s) for s in box_shapes)
        self.variants = np.asarray(variants, dtype=np.int32)
        self.dirs = tuple(dirs)
        self.nh_total = int(nh_total)
        #: per part: hid -> slot relative to g0 (the segment layout)
        self.ghost_rel_slots = ghost_rel_slots
        #: (P, nh_total) bool: True where a segment slot is a real ghost.
        #: Slab packing ships whole bounding slabs, so boundary-trimmed
        #: shells leave orphan slots holding sender values after a forward
        #: exchange; the reverse (assembly) path masks them out
        self.seg_mask = seg_mask
        self.P = int(P)


def _logical_coords(gids, gdims, lo, hi):
    """Global gids -> logical coordinates relative to a part's box
    [lo, hi) (tpu_box.py:126): periodic ghosts wrap, so per dimension the
    logical cell is whichever of {c, c-n, c+n} lies nearest the box.
    None when two candidates tie (a wrap too small to be unambiguous)."""
    coords = np.stack(np.unravel_index(np.asarray(gids, dtype=np.int64), gdims))
    out = np.empty_like(coords)
    for d, n in enumerate(gdims):
        c = coords[d]
        cands = np.stack([c, c - n, c + n])
        dist = np.maximum(np.maximum(lo[d] - cands, cands - (hi[d] - 1)), 0)
        pick = dist.argmin(axis=0)
        m = np.arange(cands.shape[1])
        best_d = dist[pick, m]
        if ((dist == best_d[None, :]).sum(axis=0) > 1).any():
            return None
        out[d] = cands[pick, m]
    return out


def analyze_box_structure(rows: PRange) -> Optional[BoxInfo]:
    """Detect the box halo structure of a Cartesian PRange
    (tpu_box.py:152-334). Pure host analysis; None whenever any
    precondition fails, so the caller keeps the generic plan."""
    isets = rows.partition.part_values()
    P = len(isets)
    if P == 0:
        return None
    gdims = getattr(isets[0], "grid_shape", None)
    if gdims is None:
        return None
    dim = len(gdims)
    for i in isets:
        if getattr(i, "grid_shape", None) != gdims:
            return None
        if not getattr(i, "owned_first", True):
            return None
    # an inactive part (empty box, no ghosts) is a degenerate variant; an
    # empty box with ghosts is not that case
    for i in isets:
        if math.prod(i.box_shape) == 0 and i.num_hids:
            return None
    box_shapes = sorted({i.box_shape for i in isets})
    if sum(1 for s in box_shapes if math.prod(s) > 0) > (1 << dim):
        return None  # not a tensor-product split
    variants = np.array([box_shapes.index(i.box_shape) for i in isets], dtype=np.int32)
    # owned ids must be the C-order box scan: a Cartesian index set is one
    # by contract, so its first and last ids suffice
    for i in isets:
        og = np.asarray(i.oid_to_gid)
        if len(og) != math.prod(i.box_shape):
            return None
        if len(og):
            first = np.ravel_multi_index(i.box_lo, gdims)
            last = np.ravel_multi_index(tuple(h - 1 for h in i.box_hi), gdims)
            if og[0] != first or og[-1] != last:
                return None

    exchanger = rows.exchanger
    parts_snd = [np.asarray(t) for t in exchanger.parts_snd.part_values()]
    parts_rcv = [np.asarray(t) for t in exchanger.parts_rcv.part_values()]
    lids_snd = exchanger.lids_snd.part_values()
    lids_rcv = exchanger.lids_rcv.part_values()

    # direction -> [(p, q, sender-box-relative coordinates, receiver hids)]
    groups = {}
    covered = [np.zeros(i.num_hids, dtype=bool) for i in isets]
    for p in range(P):
        iset_p = isets[p]
        for j, q in enumerate(parts_snd[p]):
            q = int(q)
            hits = np.nonzero(parts_rcv[q] == p)[0]
            if len(hits) != 1:
                return None
            snd_l = np.asarray(lids_snd[p][j])
            rcv_l = np.asarray(lids_rcv[q][int(hits[0])])
            if len(snd_l) != len(rcv_l) or len(snd_l) == 0:
                return None
            gids = np.asarray(iset_p.lid_to_gid)[snd_l]
            sc = _logical_coords(gids, gdims, iset_p.box_lo, iset_p.box_hi)
            if sc is None:
                return None
            if ((sc < np.array(iset_p.box_lo)[:, None]) | (sc >= np.array(iset_p.box_hi)[:, None])).any():
                return None  # the exchanger sends ids the sender does not own
            iset_q = isets[q]
            qc = _logical_coords(gids, gdims, iset_q.box_lo, iset_q.box_hi)
            if qc is None:
                return None
            dir_of = np.zeros((dim, len(gids)), dtype=np.int8)
            for d in range(dim):
                dir_of[d] = (qc[d] >= iset_q.box_hi[d]).astype(np.int8) - (
                    qc[d] < iset_q.box_lo[d]
                ).astype(np.int8)
            if (dir_of == 0).all(axis=0).any():
                return None  # a "ghost" inside the receiver's own box
            rel = sc - np.array(iset_p.box_lo, dtype=np.int64)[:, None]
            hids_all = -np.asarray(iset_q.lid_to_ohid)[rcv_l] - 1
            if (hids_all < 0).any():
                return None  # receiver lid not a ghost
            # split the edge by direction (a periodic split of 2 sends both
            # faces of one axis to the same neighbour in one edge)
            uniq = {}
            for e in range(len(gids)):
                uniq.setdefault(tuple(int(v) for v in dir_of[:, e]), []).append(e)
            for k, idx in uniq.items():
                idx = np.asarray(idx)
                hids = hids_all[idx]
                if covered[q][hids].any():
                    return None
                covered[q][hids] = True
                groups.setdefault(k, []).append((p, q, rel[:, idx], hids))
    for p in range(P):
        if not covered[p].all():
            return None  # some ghost never receives

    # per direction: the bounding slab over every edge's sub-box, per
    # sender variant; each receiver's slot map follows its sender's slab
    dirs = []
    ghost_rel = [np.full(i.num_hids, -1, dtype=INDEX_DTYPE) for i in isets]
    off = 0
    V = len(box_shapes)
    for k in sorted(groups):
        entries = groups[k]
        slab_lo = [None] * V
        slab_hi = [None] * V
        for p, q, rel, hids in entries:
            v = int(variants[p])
            lo_e, hi_e = rel.min(axis=1), rel.max(axis=1) + 1
            slab_lo[v] = lo_e if slab_lo[v] is None else np.minimum(slab_lo[v], lo_e)
            slab_hi[v] = hi_e if slab_hi[v] is None else np.maximum(slab_hi[v], hi_e)
        geo = []
        for v in range(V):
            if slab_lo[v] is None:
                # a variant that never sends here: a degenerate slice (an
                # empty box slices zero elements)
                if math.prod(box_shapes[v]) == 0:
                    geo.append(((0,) * dim, (0,) * dim))
                else:
                    geo.append(((0,) * dim, (1,) * dim))
            else:
                geo.append((
                    tuple(int(x) for x in slab_lo[v]),
                    tuple(int(x) for x in (slab_hi[v] - slab_lo[v])),
                ))
        senders, receivers = set(), set()
        perm = []
        for p, q, rel, hids in entries:
            if p in senders or q in receivers:
                return None  # not a partial permutation
            senders.add(p)
            receivers.add(q)
            perm.append((p, q))
            lo_v, shape_v = geo[int(variants[p])]
            pos = np.ravel_multi_index(tuple(rel - np.asarray(lo_v)[:, None]), shape_v)
            if len(np.unique(pos)) != len(pos):
                return None
            ghost_rel[q][hids] = off + pos
        d = BoxDir(k, geo, off, sorted(perm))
        dirs.append(d)
        off += d.size
    nh_total = off
    seg_mask = np.zeros((P, max(nh_total, 1)), dtype=bool)
    for p in range(P):
        if (ghost_rel[p] < 0).any():
            return None
        seg_mask[p, ghost_rel[p]] = True
    return BoxInfo(box_shapes, variants, dirs, nh_total, ghost_rel, seg_mask, P)


def box_structure(rows: PRange) -> Optional[BoxInfo]:
    """`analyze_box_structure`, cached on the PRange (it walks every edge)."""
    if not hasattr(rows, "_box_info"):
        rows._box_info = analyze_box_structure(rows)
    return rows._box_info


def _move_slots(layout, info: BoxInfo):
    """Every move of the plan as frame slots, flat over the stacked
    ``(P, W)`` frame, in plan order (direction, then sender -> receiver
    pair): the sender's slab slots of its owned box, the receiver's segment
    slots, and whether each segment slot is one of the receiver's real
    ghosts (``seg_mask``)."""
    W, o0, g0 = layout.W, layout.o0, layout.g0
    src, dst, real = [], [], []
    for d in info.dirs:
        for p, q in d.perm:
            v = int(info.variants[p])
            start, shape = d.geo[v]
            pos = np.unravel_index(np.arange(math.prod(shape)), shape)
            owned = np.ravel_multi_index(tuple(np.asarray(start)[:, None] + np.asarray(pos)), info.box_shapes[v])
            src.append(p * W + o0 + owned)
            dst.append(q * W + g0 + d.off + np.arange(owned.size))
            real.append(info.seg_mask[q, d.off : d.off + owned.size])
    cat = lambda xs, dt: np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt)  # noqa: E731
    return cat(src, np.int64), cat(dst, np.int64), cat(real, bool)


class BoxExchangePlan:
    """The box halo program over a box layout (tpu_box.py:337), flattened
    at plan time to slot indices over the stacked frame. Combine ``set``:
    one gather of every move's slab slots, one copy into the segments, and
    one fill of the ghost slots nothing covers (a part that receives
    nothing in a direction reads 0 there, as the JAX package's
    ``ppermute`` leaves it). ``reverse()`` gives the ghost -> owner
    assembly plan (combine ``add``) over the same moves: the real segment
    slots gathered once, then added into their owners in rounds, round k
    holding each owner slot's k-th contribution in direction order (so no
    round adds twice into one slot: the sums are deterministic and in the
    order of the JAX package's direction loop)."""

    __slots__ = ("layout", "info", "reverse_mode", "src", "dst", "zero", "add_src", "add_rounds")

    def __init__(self, layout, info: BoxInfo, device, reverse_mode: bool = False, _slots=None):
        self.layout = layout
        self.info = info
        self.reverse_mode = bool(reverse_mode)
        if _slots is None:
            src, dst, real = _move_slots(layout, info)
            zero = None
            if len(dst) < info.P * info.nh_total:
                P, W = layout.P, layout.W
                ghost = (np.arange(P)[:, None] * W + np.arange(layout.g0, W)).reshape(-1)
                zero = torch.from_numpy(np.setdiff1d(ghost, dst)).to(device)
            # add: the real slots only (orphans never reach owners), each
            # owner slot's contributions ranked in plan order
            a_src, a_dst = dst[real], src[real]
            order = np.argsort(a_dst, kind="stable")
            first = np.searchsorted(a_dst[order], a_dst[order])
            rank = np.empty(len(a_dst), dtype=np.int64)
            rank[order] = np.arange(len(a_dst)) - first
            by_round = np.lexsort((np.arange(len(a_dst)), rank))
            ends = np.cumsum(np.bincount(rank)) if len(rank) else np.zeros(0, np.int64)
            a_dst = torch.from_numpy(a_dst[by_round]).to(device)
            rounds = tuple((int(a), int(b), a_dst[a:b]) for a, b in zip(np.r_[0, ends[:-1]], ends))
            _slots = (torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device), zero,
                      torch.from_numpy(a_src[by_round]).to(device), rounds)
        self.src, self.dst, self.zero, self.add_src, self.add_rounds = _slots

    @property
    def R(self) -> int:
        """Directions, the counterpart of the generic plan's rounds."""
        return len(self.info.dirs)

    def reverse(self) -> "BoxExchangePlan":
        return BoxExchangePlan(
            self.layout, self.info, None, not self.reverse_mode,
            (self.src, self.dst, self.zero, self.add_src, self.add_rounds),
        )


def box_exchange_(plan: BoxExchangePlan, xv: torch.Tensor, combine: str) -> torch.Tensor:
    """The box plan's exchange on a stacked, contiguous ``(P, W)`` tensor,
    or a ``(P, W, K)`` slab of K columns, in place
    (tpu_box.py:shard_box_exchange). Combine ``set`` (a forward plan): the
    senders' slabs copied into the receivers' segments, the uncovered ghost
    slots zeroed. Combine ``add`` (a reversed plan): the receivers' real
    segment slots added into the senders' owned slots, then the ghost
    region zeroed. A slab's slots move as rows of K values, in the same
    order, so column k is the exchange of column k bit for bit."""
    check(
        plan.reverse_mode == (combine == "add"),
        "box exchange: combine mode does not match the plan direction; use "
        "plan.reverse() for ghost -> owner assembly",
    )
    flat = xv.view(-1) if xv.dim() == 2 else xv.view(-1, xv.shape[2])
    if not plan.reverse_mode:
        if len(plan.src):
            flat.index_copy_(0, plan.dst, flat.index_select(0, plan.src))
        if plan.zero is not None:
            flat.index_fill_(0, plan.zero, 0)
        return xv
    if len(plan.add_src):
        vals = flat.index_select(0, plan.add_src)
        for a, b, idx in plan.add_rounds:
            flat.index_add_(0, idx, vals[a:b])
    xv[:, plan.layout.g0 :] = 0  # ghost contributions now live on owners
    return xv
