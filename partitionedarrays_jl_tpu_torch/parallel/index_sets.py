"""Per-part index sets: the owner/ghost description of a partition (L4).

The port's copy of `partitionedarrays_jl_tpu/parallel/index_sets.py`
(reference: src/Interfaces.jl:566-696, src/IndexSets.jl) with the NumPy
lookup paths only. Vocabulary:

* **gid** — global id in ``0..ngids-1`` (0-based here)
* **lid** — local id in ``0..nlids-1``
* **oid** — owned-local id (this part owns the gid)
* **hid** — ghost/"halo" local id (owned by another part)

All lookups are vectorized NumPy: arithmetic for owned boxes and ranges,
binary search over sorted ghost gids. ``lid_to_ohid`` is signed: owned lid
-> ``oid`` (>= 0), ghost lid -> ``-(hid+1)`` (< 0).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE

GID_DTYPE = np.int64  # global ids can exceed 2^31 at 1e8+ DOFs x ghosts


def _as_gids(a) -> np.ndarray:
    return np.asarray(a, dtype=GID_DTYPE)


def _as_idx(a) -> np.ndarray:
    return np.asarray(a, dtype=INDEX_DTYPE)


def _first_touch_new(gids: np.ndarray, owners: np.ndarray, lids: np.ndarray, part: int):
    """Select the gids absent from the partition (lids < 0), deduplicated in
    first-touch order, with their owners; validates no self-owned ghost."""
    new_mask = lids < 0
    if not new_mask.any():
        return None
    cand = gids[new_mask]
    _, first = np.unique(cand, return_index=True)
    order = np.sort(first)
    new_gids = cand[order]
    new_owners = owners[new_mask][order]
    check((new_owners != part).all(), "add_gids: cannot add own gid as ghost")
    return new_gids, new_owners


class AbstractIndexSet:
    """Contract: `part`, `lid_to_gid`, `lid_to_part`, `oid_to_lid`,
    `hid_to_lid`, `lid_to_ohid`, vectorized `gids_to_lids`
    (reference accessor layer: src/Interfaces.jl:568-577)."""

    part: int

    # --- sizes ---------------------------------------------------------
    @property
    def num_lids(self) -> int:
        return len(self.lid_to_gid)

    @property
    def num_oids(self) -> int:
        return len(self.oid_to_lid)

    @property
    def num_hids(self) -> int:
        return len(self.hid_to_lid)

    # --- derived views -------------------------------------------------
    @property
    def oid_to_gid(self) -> np.ndarray:
        return self.lid_to_gid[self.oid_to_lid]

    @property
    def hid_to_gid(self) -> np.ndarray:
        return self.lid_to_gid[self.hid_to_lid]

    @property
    def hid_to_part(self) -> np.ndarray:
        return self.lid_to_part[self.hid_to_lid]

    @property
    def owned_first(self) -> bool:
        """True when lids are numbered owned block first (oid == lid for
        owned entries): the layout every built-in constructor produces, and
        the fast path the GPU backend exploits (owned data = array prefix)."""
        o = self.oid_to_lid
        return len(o) == 0 or (o[0] == 0 and o[-1] == len(o) - 1 and
                               np.array_equal(o, np.arange(len(o), dtype=o.dtype)))

    # --- vectorized lookup --------------------------------------------
    def gids_to_lids(self, gids, missing_to: int = -1) -> np.ndarray:
        """Vectorized gid -> lid; absent gids map to `missing_to`."""
        raise NotImplementedError

    # --- mutation ------------------------------------------------------
    def add_gid(self, gid: int, owner: int) -> int:
        """Append one ghost entry (owner known); returns its lid.
        Reference: src/Interfaces.jl:579-600 (`add_gid!`)."""
        return int(self.add_gids(np.array([gid]), np.array([owner]))[0])

    def add_gids(self, gids, owners) -> np.ndarray:
        """Append ghost entries for any gids not yet local (first-touch
        order, duplicates ignored). Returns the lids of `gids`.
        Reference: src/Interfaces.jl:602-627 (`add_gids!`)."""
        raise NotImplementedError

    def has_gids(self, gids) -> np.ndarray:
        return self.gids_to_lids(gids) >= 0

    # --- renumbering ---------------------------------------------------
    def to_lids(self, ids: np.ndarray) -> np.ndarray:
        """In-place gid -> lid renumbering of `ids`
        (reference: src/Interfaces.jl:629-637)."""
        lids = self.gids_to_lids(ids)
        check((lids >= 0).all(), "to_lids: some gids are not local")
        ids[...] = lids
        return ids

    def to_gids(self, ids: np.ndarray) -> np.ndarray:
        """In-place lid -> gid renumbering (reference: src/Interfaces.jl:639-645)."""
        ids[...] = self.lid_to_gid[ids]
        return ids

    # --- comparison (reference: src/Interfaces.jl:647-657) -------------
    def oids_eq(self, other: "AbstractIndexSet") -> bool:
        return np.array_equal(self.oid_to_gid, other.oid_to_gid)

    def hids_eq(self, other: "AbstractIndexSet") -> bool:
        return np.array_equal(self.hid_to_gid, other.hid_to_gid)

    def lids_eq(self, other: "AbstractIndexSet") -> bool:
        return np.array_equal(self.lid_to_gid, other.lid_to_gid)

    def find_lid_map(self, other: "AbstractIndexSet") -> np.ndarray:
        """Permutation mapping this set's lids to `other`'s lids via gids
        (reference: src/Interfaces.jl:659-667)."""
        lids = other.gids_to_lids(self.lid_to_gid)
        check((lids >= 0).all(), "find_lid_map: gid missing in target")
        return lids

    def touched_hids(self, gids) -> np.ndarray:
        """Ghost lids whose gids appear in `gids`, deduplicated in
        first-touch order, returned as hids
        (reference: src/Interfaces.jl:670-696)."""
        lids = self.gids_to_lids(_as_gids(gids))
        ok = lids >= 0
        ohids = self.lid_to_ohid[lids[ok]]
        hids = -(ohids[ohids < 0]) - 1
        _, first = np.unique(hids, return_index=True)
        return hids[np.sort(first)].astype(INDEX_DTYPE)

    def __repr__(self):
        return (
            f"{type(self).__name__}(part={self.part}, nlids={self.num_lids}, "
            f"noids={self.num_oids}, nhids={self.num_hids})"
        )


def _derive_o_h(lid_to_part: np.ndarray, part: int):
    lid_to_part = _as_idx(lid_to_part)
    owned = lid_to_part == part
    oid_to_lid = np.nonzero(owned)[0].astype(INDEX_DTYPE)
    hid_to_lid = np.nonzero(~owned)[0].astype(INDEX_DTYPE)
    lid_to_ohid = np.empty(len(lid_to_part), dtype=INDEX_DTYPE)
    lid_to_ohid[oid_to_lid] = np.arange(len(oid_to_lid), dtype=INDEX_DTYPE)
    lid_to_ohid[hid_to_lid] = -np.arange(1, len(hid_to_lid) + 1, dtype=INDEX_DTYPE)
    return oid_to_lid, hid_to_lid, lid_to_ohid


class IndexSet(AbstractIndexSet):
    """Fully explicit index set for arbitrary partitions (e.g. from a mesh
    partitioner). Reference: src/IndexSets.jl:215-291 — with the Dict
    replaced by a sorted-gid binary-search index."""

    def __init__(
        self,
        part: int,
        lid_to_gid,
        lid_to_part,
        oid_to_lid: Optional[np.ndarray] = None,
        hid_to_lid: Optional[np.ndarray] = None,
        lid_to_ohid: Optional[np.ndarray] = None,
    ):
        self.part = int(part)
        self.lid_to_gid = _as_gids(np.array(lid_to_gid, copy=True))
        self.lid_to_part = _as_idx(np.array(lid_to_part, copy=True))
        check(len(self.lid_to_gid) == len(self.lid_to_part), "lid arrays mismatch")
        if oid_to_lid is None or hid_to_lid is None:
            oid_to_lid, hid_to_lid, lid_to_ohid = _derive_o_h(self.lid_to_part, self.part)
        elif lid_to_ohid is None:
            lid_to_ohid = np.empty(len(self.lid_to_gid), dtype=INDEX_DTYPE)
            lid_to_ohid[_as_idx(oid_to_lid)] = np.arange(len(oid_to_lid), dtype=INDEX_DTYPE)
            lid_to_ohid[_as_idx(hid_to_lid)] = -np.arange(
                1, len(hid_to_lid) + 1, dtype=INDEX_DTYPE
            )
        self.oid_to_lid = _as_idx(np.array(oid_to_lid, copy=True))
        self.hid_to_lid = _as_idx(np.array(hid_to_lid, copy=True))
        self.lid_to_ohid = _as_idx(np.array(lid_to_ohid, copy=True))
        self._lookup = None  # (sorted gids, perm) cache

    def _index(self):
        if self._lookup is None:
            perm = np.argsort(self.lid_to_gid, kind="stable").astype(INDEX_DTYPE)
            self._lookup = (self.lid_to_gid[perm], perm)
        return self._lookup

    def gids_to_lids(self, gids, missing_to: int = -1) -> np.ndarray:
        gids = np.atleast_1d(_as_gids(gids))
        sorted_gids, perm = self._index()
        pos = np.searchsorted(sorted_gids, gids)
        pos = np.clip(pos, 0, len(sorted_gids) - 1) if len(sorted_gids) else pos
        out = np.full(gids.shape, missing_to, dtype=INDEX_DTYPE)
        if len(sorted_gids):
            hit = sorted_gids[pos] == gids
            out[hit] = perm[pos[hit]]
        return out

    def add_gids(self, gids, owners) -> np.ndarray:
        gids = np.atleast_1d(_as_gids(gids))
        owners = np.atleast_1d(_as_idx(owners))
        lids = self.gids_to_lids(gids)
        new = _first_touch_new(gids, owners, lids, self.part)
        if new is not None:
            new_gids, new_owners = new
            n0 = self.num_lids
            h0 = self.num_hids
            k = len(new_gids)
            self.lid_to_gid = np.concatenate([self.lid_to_gid, new_gids])
            self.lid_to_part = np.concatenate([self.lid_to_part, new_owners])
            self.hid_to_lid = np.concatenate(
                [self.hid_to_lid, np.arange(n0, n0 + k, dtype=INDEX_DTYPE)]
            )
            self.lid_to_ohid = np.concatenate(
                [self.lid_to_ohid, -np.arange(h0 + 1, h0 + k + 1, dtype=INDEX_DTYPE)]
            )
            self._lookup = None
            lids = self.gids_to_lids(gids)
        return lids


class IndexRange(AbstractIndexSet):
    """Compressed index set: the owned block is the contiguous gid range
    ``firstgid : firstgid + noids``; only ghosts are stored explicitly, and
    lids are **owned-first** (owned block, then ghosts in append order).

    Reference: src/IndexSets.jl:343-421 — the lazy vector fields
    (`LidToGid`/`LidToPart`/`GidToLid`, src/IndexSets.jl:39-172) become
    arithmetic in the vectorized lookups. The owned-first layout is what the
    GPU backend exploits: owned values of a PVector are ``values[:noids]``,
    a plain slice.
    """

    def __init__(
        self,
        part: int,
        noids: int,
        firstgid: int,
        hid_to_gid=None,
        hid_to_part=None,
    ):
        self.part = int(part)
        self.noids = int(noids)
        self.firstgid = int(firstgid)
        self._hid_to_gid = _as_gids(
            np.array(hid_to_gid, copy=True) if hid_to_gid is not None else []
        )
        self._hid_to_part = _as_idx(
            np.array(hid_to_part, copy=True) if hid_to_part is not None else []
        )
        check(len(self._hid_to_gid) == len(self._hid_to_part), "hid arrays mismatch")
        self._lookup = None

    # --- contract fields, materialized lazily -------------------------
    @property
    def lid_to_gid(self) -> np.ndarray:
        return np.concatenate(
            [
                np.arange(self.firstgid, self.firstgid + self.noids, dtype=GID_DTYPE),
                self._hid_to_gid,
            ]
        )

    @property
    def lid_to_part(self) -> np.ndarray:
        return np.concatenate(
            [np.full(self.noids, self.part, dtype=INDEX_DTYPE), self._hid_to_part]
        )

    @property
    def oid_to_lid(self) -> np.ndarray:
        return np.arange(self.noids, dtype=INDEX_DTYPE)

    @property
    def hid_to_lid(self) -> np.ndarray:
        return np.arange(self.noids, self.noids + len(self._hid_to_gid), dtype=INDEX_DTYPE)

    @property
    def lid_to_ohid(self) -> np.ndarray:
        return np.concatenate(
            [
                np.arange(self.noids, dtype=INDEX_DTYPE),
                -np.arange(1, len(self._hid_to_gid) + 1, dtype=INDEX_DTYPE),
            ]
        )

    @property
    def num_lids(self) -> int:
        return self.noids + len(self._hid_to_gid)

    @property
    def num_oids(self) -> int:
        return self.noids

    @property
    def num_hids(self) -> int:
        return len(self._hid_to_gid)

    @property
    def oid_to_gid(self) -> np.ndarray:
        return np.arange(self.firstgid, self.firstgid + self.noids, dtype=GID_DTYPE)

    @property
    def hid_to_gid(self) -> np.ndarray:
        return self._hid_to_gid

    @property
    def hid_to_part(self) -> np.ndarray:
        return self._hid_to_part

    def _index(self):
        if self._lookup is None:
            perm = np.argsort(self._hid_to_gid, kind="stable").astype(INDEX_DTYPE)
            self._lookup = (self._hid_to_gid[perm], perm)
        return self._lookup

    def gids_to_lids(self, gids, missing_to: int = -1) -> np.ndarray:
        gids = np.atleast_1d(_as_gids(gids))
        out = np.full(gids.shape, missing_to, dtype=INDEX_DTYPE)
        owned = (gids >= self.firstgid) & (gids < self.firstgid + self.noids)
        out[owned] = (gids[owned] - self.firstgid).astype(INDEX_DTYPE)
        if len(self._hid_to_gid):
            sorted_gids, perm = self._index()
            rest = ~owned
            pos = np.clip(np.searchsorted(sorted_gids, gids[rest]), 0, len(sorted_gids) - 1)
            hit = sorted_gids[pos] == gids[rest]
            idx = np.nonzero(rest)[0]
            out[idx[hit]] = self.noids + perm[pos[hit]]
        return out

    def add_gids(self, gids, owners) -> np.ndarray:
        gids = np.atleast_1d(_as_gids(gids))
        owners = np.atleast_1d(_as_idx(owners))
        lids = self.gids_to_lids(gids)
        new = _first_touch_new(gids, owners, lids, self.part)
        if new is not None:
            new_gids, new_owners = new
            self._hid_to_gid = np.concatenate([self._hid_to_gid, new_gids])
            self._hid_to_part = np.concatenate([self._hid_to_part, new_owners])
            self._lookup = None
            lids = self.gids_to_lids(gids)
        return lids


class CartesianIndexSet(IndexSet):
    """Explicit index set whose owned lids form an N-D box of a global
    Cartesian grid, in C (ij) order. Owned lookups are pure arithmetic —
    the vectorized form of the reference's lazy tensor-product index maps
    (reference: src/IndexSets.jl:195-213, src/Interfaces.jl:1307-1499) —
    and only the ghost tail is indexed, so `gids_to_lids`/`to_lids` over
    millions of owned cells cost O(n) instead of a sort + binary search of
    the whole owned block. Ghost mutation (`add_gids`) behaves exactly as
    IndexSet: ghosts append after the owned box."""

    def __init__(self, part, grid_shape, box_lo, box_hi, lid_to_gid,
                 lid_to_part, **kw):
        super().__init__(part, lid_to_gid, lid_to_part, **kw)
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.box_lo = tuple(int(l) for l in box_lo)
        self.box_hi = tuple(int(h) for h in box_hi)
        self.box_shape = tuple(
            h - l for l, h in zip(self.box_lo, self.box_hi)
        )

    def _index(self):
        # sort only the ghost tail (owned lids are answered arithmetically)
        if self._lookup is None:
            noids = len(self.oid_to_lid)
            ghost_gids = self.lid_to_gid[noids:]
            perm = np.argsort(ghost_gids, kind="stable").astype(INDEX_DTYPE)
            self._lookup = (ghost_gids[perm], perm + noids)
        return self._lookup

    def gids_to_lids(self, gids, missing_to: int = -1) -> np.ndarray:
        gids = np.atleast_1d(np.asarray(gids))
        if gids.dtype != np.int32:  # int32 batches pass through copy-free
            gids = _as_gids(gids)
        shape = gids.shape
        gids = np.ascontiguousarray(gids).ravel()
        out = np.full(gids.shape, -1, dtype=INDEX_DTYPE)
        ng = math.prod(self.grid_shape)
        owned = (gids >= 0) & (gids < ng)
        if self.box_shape == self.grid_shape:
            # the box is the whole grid: the owned lid is the gid
            out[owned] = gids[owned]
        else:
            coords = np.unravel_index(np.clip(gids, 0, ng - 1), self.grid_shape)
            local = []
            for c, lo, hi in zip(coords, self.box_lo, self.box_hi):
                owned &= (c >= lo) & (c < hi)
                local.append(c - lo)
            if self.box_shape and min(self.box_shape) > 0:
                out[owned] = np.ravel_multi_index(
                    [l[owned] for l in local], self.box_shape
                ).astype(INDEX_DTYPE)
        sorted_gids, lid_of = self._index()
        if len(sorted_gids):
            rest = out < 0
            pos = np.clip(
                np.searchsorted(sorted_gids, gids[rest]), 0, len(sorted_gids) - 1
            )
            hit = sorted_gids[pos] == gids[rest]
            idx = np.nonzero(rest)[0]
            out[idx[hit]] = lid_of[pos[hit]]
        if missing_to != -1:
            out[out < 0] = missing_to
        return out.reshape(shape)


# ---------------------------------------------------------------------------
# gid -> owner global maps (lazy, vectorized)
# ---------------------------------------------------------------------------


class ExtendedIndexRange(IndexSet):
    """Explicit lid vectors with a contiguous owned gid range, the
    gathered/main-centric ranges (reference: src/IndexSets.jl:293-341).
    Inherits IndexSet's explicit storage; the contiguous owned range is
    recorded so owned lookups stay arithmetic."""

    def __init__(self, part, noids, firstgid, lid_to_gid, lid_to_part):
        super().__init__(part, lid_to_gid, lid_to_part)
        self.noids_range = (int(firstgid), int(firstgid) + int(noids))


class LinearGidToPart:
    """gid -> owner for 1-D block partitions via searchsorted over
    `part_to_firstgid` (reference: src/IndexSets.jl:174-193)."""

    def __init__(self, ngids: int, part_to_firstgid: np.ndarray):
        self.ngids = int(ngids)
        self.part_to_firstgid = _as_gids(part_to_firstgid)  # length nparts

    def __call__(self, gids) -> np.ndarray:
        gids = _as_gids(gids)
        return (
            np.searchsorted(self.part_to_firstgid, gids, side="right") - 1
        ).astype(INDEX_DTYPE)


class CartesianGidToPart:
    """gid -> owner for N-D Cartesian block partitions: decompose the gid
    into N-D cell coords, searchsorted per dimension, ravel the part coords
    (reference: src/IndexSets.jl:195-213). C-order linearization."""

    def __init__(self, ngids: Tuple[int, ...], dim_firstids: Tuple[np.ndarray, ...]):
        self.ngids = tuple(int(n) for n in ngids)
        self.dim_firstids = tuple(_as_gids(f) for f in dim_firstids)
        self.part_shape = tuple(len(f) for f in self.dim_firstids)

    def __call__(self, gids) -> np.ndarray:
        gids = _as_gids(gids)
        coords = np.unravel_index(gids, self.ngids)  # C-order
        pcoords = [
            np.searchsorted(f, c, side="right") - 1
            for f, c in zip(self.dim_firstids, coords)
        ]
        return np.ravel_multi_index(pcoords, self.part_shape).astype(INDEX_DTYPE)


# ---------------------------------------------------------------------------
# free-function API parity with the reference exports
# ---------------------------------------------------------------------------


def get_lid_to_gid(i: AbstractIndexSet) -> np.ndarray:
    return i.lid_to_gid


def get_lid_to_part(i: AbstractIndexSet) -> np.ndarray:
    return i.lid_to_part


def get_oid_to_lid(i: AbstractIndexSet) -> np.ndarray:
    return i.oid_to_lid


def get_hid_to_lid(i: AbstractIndexSet) -> np.ndarray:
    return i.hid_to_lid


def get_lid_to_ohid(i: AbstractIndexSet) -> np.ndarray:
    return i.lid_to_ohid


def get_gid_to_lid(i: AbstractIndexSet):
    """Vectorized lookup callable (the Dict analog)."""
    return i.gids_to_lids


def touched_hids(i, gids):
    """Which ghost ids appear in `gids` (dedup, first-touch order).
    Accepts a single IndexSet, a PData of IndexSets, or a PRange paired
    with a PData of gid arrays (reference: src/Interfaces.jl:670-696)."""
    from .backends import AbstractPData, map_parts

    if isinstance(gids, AbstractPData):
        partition = i.partition if hasattr(i, "partition") else i
        return map_parts(lambda s, g: s.touched_hids(g), partition, gids)
    return i.touched_hids(gids)


def add_gid(i: AbstractIndexSet, gid: int, owner: int) -> int:
    return i.add_gid(gid, owner)


def _per_part_count(i, attr: str):
    """Shared body of the num_* free functions: one IndexSet, a PData of
    IndexSets, or a PRange (reference exports num_gids/num_lids/num_oids/
    num_hids, src/PartitionedArrays.jl:63-66)."""
    from .backends import AbstractPData, map_parts

    if hasattr(i, "partition"):  # PRange
        i = i.partition
    if isinstance(i, AbstractPData):
        return map_parts(lambda s: getattr(s, attr), i)
    return getattr(i, attr)


def num_gids(i):
    """Total global ids of a PRange (`ngids`). Index sets do not record
    the global count, so only a PRange (or anything carrying `ngids`) is
    accepted, as in the reference."""
    if hasattr(i, "ngids"):
        return i.ngids
    raise TypeError("num_gids needs a PRange (index sets don't store ngids)")


def num_lids(i):
    return _per_part_count(i, "num_lids")


def num_oids(i):
    return _per_part_count(i, "num_oids")


def num_hids(i):
    return _per_part_count(i, "num_hids")
