"""The lowerings of an operator that is not a band: supernode-dense (SD),
node-block (BSR) and padded ELL for the owned block A_oo, and the
node-block form of the boundary block A_oh.

The port's copy of the host analyses of the JAX package's `DeviceMatrix`
(`partitionedarrays_jl_tpu/parallel/tpu.py`): `detect_sd` (:1800-1927),
`detect_oh_blocks` (:1930-2047), `detect_bsr` (:2050-2112) and the ELL
staging (:1460-1487), with their constants. Each returns plain NumPy arrays
(the staging) or None when it declines; `parallel/gpu.py:DeviceMatrix`
resolves them in the JAX package's order off a TPU (band, SD, BSR, ELL)
and puts the arrays on the card, where `ops/irregular.py` runs their
products.
"""
from __future__ import annotations

import bisect

import numpy as np

from ..ops.sparse import ELLMatrix
from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE

#: node rows a supernode group holds (tpu.py:DeviceMatrix.SD_GROUP)
SD_GROUP = 64
#: bytes of the densified SD group blocks, summed over parts (SD_MAX_BYTES)
SD_MAX_BYTES = int(2.5e9)
#: width buckets of the SD groups and of the node-block boundary (SD_BUCKETS)
SD_BUCKETS = 8
#: least share of a node block's entries that are stored (BSR_MIN_FILL)
BSR_MIN_FILL = 0.6
#: the block sizes tried, largest first
BLOCK_SIZES = (4, 3, 2)


def _block_fill_ok(oo, bs: int, noids, no_max: int) -> bool:
    """Whether every part's A_oo tiles into bs x bs blocks and the blocks
    are dense enough (nnz over stored blocks' entries >= BSR_MIN_FILL),
    counted from integer keys without touching the values."""
    if no_max % bs or any(int(n) % bs for n in noids):
        return False
    if any(m.shape[1] % bs for m in oo):
        return False
    nnz = sum(m.nnz for m in oo)
    nb = 0
    for m in oo:
        if m.nnz:
            keys = (m.row_of_nz().astype(np.int64) // bs) * (m.shape[1] // bs) + m.indices.astype(np.int64) // bs
            nb += len(np.unique(keys))
    return nnz / max(nb * bs * bs, 1) >= BSR_MIN_FILL


def detect_sd(oo, P: int, noids, no_max: int, dt):
    """Supernode-dense staging (tpu.py:_detect_sd): groups of SD_GROUP
    consecutive node rows densified over their exact column union (own
    nodes first, then the sorted external nodes), the groups in SD_BUCKETS
    contiguous width buckets, each padded to its own union maximum. None
    when no block size passes the fill test, fits SD_MAX_BYTES and keeps
    the padded external gathers under 0.7 nnz. Returns ``{"bs", "G",
    "chunks"}``, a chunk ``{"idx": (P, groups, emax), "vals": (P, groups,
    G*bs, (G + emax)*bs), "r0"}``."""
    nnz = sum(m.nnz for m in oo)
    if nnz == 0:
        return None
    G = SD_GROUP
    for bs in BLOCK_SIZES:
        if not _block_fill_ok(oo, bs, noids, no_max):
            continue
        # per-part group unions (own nodes excluded: they arrive by reshape)
        unions, ngr_max = [], 1
        for p in range(P):
            m = oo[p]
            nn = m.shape[0] // bs
            ngr = -(-nn // G) if nn else 0
            ngr_max = max(ngr_max, ngr)
            us = []
            for g in range(ngr):
                r0, r1 = g * G * bs, min((g + 1) * G * bs, m.shape[0])
                bc = np.unique(m.indices[m.indptr[r0] : m.indptr[r1]] // bs)
                us.append(bc[(bc < g * G) | (bc >= g * G + G)])
            unions.append(us)
        B = int(min(SD_BUCKETS, ngr_max))
        bounds = [round(i * ngr_max / B) for i in range(B + 1)]
        chunks, sd_bytes, pad_ext = [], 0, 0
        for c in range(B):
            r0c, r1c = bounds[c], bounds[c + 1]
            if r0c == r1c:
                continue
            emax_c = 1
            for p in range(P):
                for g in range(r0c, min(r1c, len(unions[p]))):
                    emax_c = max(emax_c, len(unions[p][g]))
            sd_bytes += P * (r1c - r0c) * (G * bs) * (G + emax_c) * bs * np.dtype(dt).itemsize
            pad_ext += P * (r1c - r0c) * emax_c
            chunks.append((r0c, r1c, emax_c))
        if sd_bytes > SD_MAX_BYTES:
            continue  # a smaller bs may still fit the budget
        # the padded external gathers must stay under BSR's block count
        if pad_ext * bs * bs > 0.7 * nnz:
            continue
        out = [
            {"idx": np.zeros((P, r1c - r0c, emax_c), dtype=INDEX_DTYPE),
             "vals": np.zeros((P, r1c - r0c, G * bs, (G + emax_c) * bs), dtype=dt), "r0": r0c}
            for r0c, r1c, emax_c in chunks
        ]
        starts = [c["r0"] for c in out]
        for p in range(P):
            m = oo[p]
            for g, ext in enumerate(unions[p]):
                ch = out[bisect.bisect_right(starts, g) - 1]
                r0, r1 = g * G * bs, min((g + 1) * G * bs, m.shape[0])
                s, e = m.indptr[r0], m.indptr[r1]
                rr = np.repeat(np.arange(r0, r1), np.diff(m.indptr[r0 : r1 + 1])) - r0
                cc = m.indices[s:e]
                bc = cc // bs
                own = (bc >= g * G) & (bc < g * G + G)
                lc = np.where(own, cc - g * G * bs, (np.searchsorted(ext, bc) + G) * bs + cc % bs)
                gl = g - ch["r0"]
                ch["idx"][p, gl, : len(ext)] = ext
                ch["vals"][p, gl][rr, lc] = m.data[s:e]
        return {"bs": bs, "G": G, "chunks": out}
    return None


def detect_bsr(oo, P: int, noids, no_max: int, dt):
    """Node-block staging (tpu.py:_detect_bsr): the first bs in
    BLOCK_SIZES whose blocks pass the fill test; ``{"bs", "cols": (P,
    no_max/bs, Lb) node columns, "vals": (P, no_max/bs, Lb, bs, bs),
    "counts": (P, no_max/bs) int32}``, a node row's stored blocks first
    (``counts`` of them, the CSR's blocks a node row), then pad blocks,
    node 0 and value 0. None when no bs passes."""
    from scipy.sparse import csr_matrix

    if sum(m.nnz for m in oo) == 0:
        return None
    for bs in BLOCK_SIZES:
        if not _block_fill_ok(oo, bs, noids, no_max):
            continue
        S = [csr_matrix((m.data, m.indices, m.indptr), shape=m.shape).tobsr((bs, bs)) for m in oo]
        Lb = max(max((int(np.diff(s.indptr).max()) if s.indptr.size > 1 else 0 for s in S), default=0), 1)
        nn_max = no_max // bs
        cols = np.zeros((P, nn_max, Lb), dtype=INDEX_DTYPE)
        vals = np.zeros((P, nn_max, Lb, bs, bs))
        counts = np.zeros((P, nn_max), dtype=np.int32)
        for p, s in enumerate(S):
            lens = np.diff(s.indptr)
            if not lens.size or not s.data.size:
                continue
            slot = np.arange(len(s.indices)) - np.repeat(s.indptr[:-1], lens)
            rr = np.repeat(np.arange(len(lens)), lens)
            cols[p, rr, slot] = s.indices
            vals[p, rr, slot] = s.data
            counts[p, : len(lens)] = lens
        return {"bs": bs, "cols": cols, "vals": vals.astype(dt), "counts": counts}
    return None


def detect_oh_blocks(cols_isets, oh, P: int, bs: int, row_layout, col_layout, dt):
    """Node-block staging of the boundary block A_oh
    (tpu.py:_detect_oh_blocks): when every part's ghost columns arrive as
    whole aligned nodes and the ghost slots keep hid order (not a box
    layout), its boundary nodes in SD_BUCKETS contiguous buckets, each
    padded to its own blocks-a-node maximum. Returns ``{"bs", "chunks"}``,
    a chunk ``{"b0", "rows": (P, nb, bs) row slots (pads at the trash
    slot), "cols": (P, nb, Lb) ghost nodes, "vals": (P, nb, Lb, bs, bs)}``;
    None when a precondition fails or the padded blocks pass
    SD_MAX_BYTES."""
    from scipy.sparse import csr_matrix

    if col_layout.box_info is not None:
        return None  # segment-reordered ghost slots break node triples
    nb_max, plans = 1, []
    for p in range(P):
        m = oh[p]
        nh = m.shape[1]
        if nh % bs or m.shape[0] % bs:
            return None
        iset = cols_isets[p]
        g = np.asarray(iset.lid_to_gid[iset.num_oids :], dtype=np.int64)
        if len(g) != nh:
            return None
        if nh:
            g3 = g.reshape(-1, bs)
            if not np.array_equal(g3, (g3[:, :1] // bs) * bs + np.arange(bs)):
                return None  # ghosts not aligned nodes
        if not m.nnz:
            plans.append(None)
            continue
        S = csr_matrix((m.data, m.indices, m.indptr), shape=m.shape).tobsr((bs, bs))
        lens = np.diff(S.indptr)
        bn = np.nonzero(lens)[0]
        plans.append((S, bn, lens))
        nb_max = max(nb_max, len(bn))
    B = int(min(SD_BUCKETS, nb_max))
    bounds = [round(i * nb_max / B) for i in range(B + 1)]
    # size every bucket first, so an over-budget block is refused before
    # any padded array exists
    geom, total_bytes = [], 0
    for c in range(B):
        b0, b1 = bounds[c], bounds[c + 1]
        if b0 == b1:
            continue
        Lb_c = 1
        for pl in plans:
            if pl is not None:
                _S, bn, lens = pl
                sel = lens[bn[b0:b1]]
                if sel.size:
                    Lb_c = max(Lb_c, int(sel.max()))
        total_bytes += P * (b1 - b0) * Lb_c * bs * bs * 8
        geom.append((b0, b1, Lb_c))
    if total_bytes > SD_MAX_BYTES:
        return None
    chunks = [
        {"b0": b0, "rows": np.full((P, b1 - b0, bs), row_layout.trash, dtype=INDEX_DTYPE),
         "cols": np.zeros((P, b1 - b0, Lb_c), dtype=INDEX_DTYPE),
         "vals": np.zeros((P, b1 - b0, Lb_c, bs, bs), dtype=dt)}
        for b0, b1, Lb_c in geom
    ]
    starts = [c["b0"] for c in chunks]
    for p, pl in enumerate(plans):
        if pl is None:
            continue
        S, bn, lens = pl
        slot = np.arange(len(S.indices)) - np.repeat(S.indptr[:-1], lens)
        rr = np.repeat(np.arange(len(lens)), lens)
        inv = np.full(len(lens), -1)
        inv[bn] = np.arange(len(bn))
        bpos = inv[rr]  # position of each block's node in the boundary list
        ci = np.searchsorted(starts, bpos, side="right") - 1
        for k, ch in enumerate(chunks):
            b0 = ch["b0"]
            b1 = b0 + ch["rows"].shape[1]
            j = np.arange(b0, min(b1, len(bn)))
            if j.size:
                ch["rows"][p, j - b0] = row_layout.o0 + bn[j][:, None] * bs + np.arange(bs)
            e = ci == k
            ch["cols"][p, bpos[e] - b0, slot[e]] = S.indices[e]
            ch["vals"][p, bpos[e] - b0, slot[e]] = S.data[e]
    return {"bs": bs, "chunks": chunks}


def stage_ell(oo, P: int, no_max: int, col_layout, dt):
    """Padded-ELL staging of A_oo (tpu.py:1460-1487) in E1's slot-major
    layout: ``(vals, cols)`` of shape (P, L, no_max), L the longest row over
    all parts, columns int32 slots of the column frame; pad slots value 0 at
    the owned slot o0, rows past a part's owned count at the trash slot.
    The transpose of the last two axes is the JAX package's (P, no_max, L)
    staging (`ops/irregular.ell_row_major`).

    No footprint ceiling: the JAX package refuses a padded-ELL gather past
    ``ELL_MAX_GATHER`` = 2.5e7 elements a part (`_ell_guard_check`,
    tpu.py:1096, :1124), a TPU fault ceiling that the card does not share.
    The card has run E1 past it without a fault: the strict lowering of the
    192^3 f32 Poisson operator (7,077,888 rows x 7 slots, 49.5M elements)
    and the forced ELL of the 64^3 elasticity operator (786,432 x 57,
    44.8M). A staging that does not fit the card fails in torch's
    allocator, with its own out-of-memory error."""
    L = max(max((int(m.row_lengths().max()) if m.nnz else 0 for m in oo), default=0), 1)
    check(col_layout.W < 2**31, "ELL staging: the column frame does not fit int32 slot columns")
    vals = np.zeros((P, L, no_max), dtype=dt)
    cols = np.full((P, L, no_max), col_layout.trash, dtype=np.int32)
    for p in range(P):
        E = ELLMatrix.from_csr(oo[p], row_width=L)
        m = E.vals.shape[0]
        vals[p, :, :m] = E.vals.T
        cols[p, :, :m] = col_layout.o0 + E.cols.T
    return vals, cols
