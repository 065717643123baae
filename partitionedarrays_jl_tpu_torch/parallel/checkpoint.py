"""Checkpoint and resume of partitioned arrays and solver states.

The port's own copy of `partitionedarrays_jl_tpu/parallel/checkpoint.py`,
on the same on-disk format, so a checkpoint either package writes loads in
the other bit for bit. State is serialized in partition-independent form
(owned values keyed by global ids for vectors, global COO triplets for
matrices), so a checkpoint written from an N-part run restores onto any
other partition, part count or backend.

Format: one ``.npz`` per object (written to a temporary name, then
renamed), plus a ``manifest.json`` per checkpoint directory naming the
objects, their kinds and their CRC32s; the sharded forms keep one ``.npz``
per part under a generation tag and an ``index.json``, retaining the
previous committed generation and falling back to it when the newest has a
truncated or bit-rotted shard (`CheckpointCorruptError` only when no clean
generation exists). `SolverCheckpointer` is the solvers' ``checkpoint=``
hook and `load_solver_state` its loader; a save and a restore are
``checkpoint_save`` / ``checkpoint_restore`` events in the active solve
records (checkpoint.py:697-699, :797-804). A cross-part-count solver-state
restore raises `CheckpointShapeError`: the JAX package's elastic tier that
opts into it runs across cards and is not ported.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import zlib
from typing import Dict, Optional, Union

import numpy as np

from .backends import AbstractPData, map_parts
from ..utils.health import retry_with_backoff
from .prange import PRange
from .psparse import PSparseMatrix
from .pvector import PVector, _owned


class CheckpointShapeError(RuntimeError):
    """A solver-state checkpoint written at one part count was asked to
    restore at a different part count. The format itself is
    partition-independent (the generic loaders restore onto any
    partition), but a mid-run solver-state restore across part counts
    changes the partition under a live recurrence, an elastic-tier
    decision that runs across cards and is not ported. Raised by
    `load_solver_state` (and so `models.solvers.resume_solve`) naming both
    part counts."""


class CheckpointCorruptError(RuntimeError):
    """No clean generation of a checkpoint could be read: every retained
    generation has a missing, truncated, or bit-rotted (CRC-mismatched)
    file. Deliberately NOT a `SolverHealthError`: retrying the same read
    cannot help, so the recovery drivers treat it as restart-from-
    scratch, not restart-from-checkpoint."""


def _global_owned(v: PVector) -> np.ndarray:
    """Owned values of every part placed at their gids — the
    partition-independent image of a PVector (ghosts are derived data and
    are not stored)."""
    out = np.zeros(v.rows.ngids, dtype=v.dtype)
    for iset, vals in zip(v.rows.partition.part_values(), v.values.part_values()):
        out[iset.oid_to_gid] = _owned(iset, np.asarray(vals))
    return out


def save_pvector(path: str, v: PVector) -> int:
    """Serialize a PVector (owned values by gid) to ``path`` (.npz);
    returns the file CRC32 (recorded by `save_checkpoint` manifests)."""
    return _atomic_savez(
        path, kind="pvector", ngids=v.rows.ngids, values=_global_owned(v)
    )


def load_pvector(path: str, rows: PRange) -> PVector:
    """Restore a PVector onto ``rows`` — any partition of the same global
    size. Ghost entries are filled from the global image (they are exact,
    not stale), so no post-load exchange is needed."""
    with np.load(path) as z:
        # plain raises, not check(): these validate external file input and
        # must survive CHECKS_ENABLED = False
        if str(z["kind"]) != "pvector":
            raise ValueError(f"{path} is not a PVector checkpoint")
        if int(z["ngids"]) != rows.ngids:
            raise ValueError(
                f"checkpoint has {int(z['ngids'])} gids, target PRange {rows.ngids}"
            )
        glob = z["values"]
    vals = map_parts(lambda i: glob[i.lid_to_gid], rows.partition)
    return PVector(vals, rows)


def save_psparse(path: str, A: PSparseMatrix) -> int:
    """Serialize a PSparseMatrix as global owned-row COO triplets (.npz);
    returns the file CRC32. Nonzero ghost-row entries (unassembled
    contributions) are rejected — call ``A.assemble()`` first."""
    from .psparse import psparse_owned_triplets

    trip = psparse_owned_triplets(A)
    gi_all, gj_all, v_all = [], [], []
    for gi, gj, v in trip.part_values():
        gi_all.append(gi)
        gj_all.append(gj)
        v_all.append(v)
    return _atomic_savez(
        path,
        kind="psparse",
        nrows=A.rows.ngids,
        ncols=A.cols.ngids,
        gi=np.concatenate(gi_all),
        gj=np.concatenate(gj_all),
        v=np.concatenate(v_all),
    )


def load_psparse(
    path: str,
    rows: PRange,
    cols: Optional[PRange] = None,
) -> PSparseMatrix:
    """Restore a PSparseMatrix onto ``rows``/``cols``. When ``cols`` is
    None the column ghost layer is rediscovered from the triplets (the
    same `add_gids` flow as assembly)."""
    from .prange import add_gids

    with np.load(path) as z:
        if str(z["kind"]) != "psparse":
            raise ValueError(f"{path} is not a PSparseMatrix checkpoint")
        if int(z["nrows"]) != rows.ngids:
            raise ValueError(
                f"checkpoint has {int(z['nrows'])} rows, target PRange {rows.ngids}"
            )
        gi, gj, v = z["gi"], z["gj"], z["v"]
    # each part keeps the triplets whose row it owns: one owner-map build
    # + one stable sort, instead of a per-part isin scan over all triplets
    nparts = len(rows.partition.part_values())
    owner_of_gid = np.empty(rows.ngids, dtype=np.int64)
    for p, iset in enumerate(rows.partition.part_values()):
        owner_of_gid[iset.oid_to_gid] = p
    order = np.argsort(owner_of_gid[gi], kind="stable")
    bounds = np.searchsorted(owner_of_gid[gi][order], np.arange(nparts + 1))
    chunks = [order[bounds[p] : bounds[p + 1]] for p in range(nparts)]
    I = rows.partition._like([gi[c].copy() for c in chunks])
    J = rows.partition._like([gj[c].copy() for c in chunks])
    V = rows.partition._like([v[c].copy() for c in chunks])
    if cols is None:
        cols = add_gids(rows, J)
    return PSparseMatrix.from_coo(I, J, V, rows, cols, ids="global")


def save_pvector_sharded(directory: str, v: PVector) -> None:
    """Serialize a PVector as one ``.npz`` per part (owned gids + owned
    values) under ``directory`` — NO part ever materializes the global
    vector, so this scales to sizes where `save_pvector`'s gather-to-one-
    host image is a wall .
    The shard set is still partition-independent: gid-keyed shards
    restore onto any partition, any part count.

    Crash-atomic in place: shards are written under a fresh generation
    tag and ``index.json`` (naming that generation) is replaced last, so
    a crash mid-save leaves the previous generation fully readable —
    never a mix of old and new shards."""
    gen = _new_generation()
    os.makedirs(directory, exist_ok=True)
    isets = v.rows.partition.part_values()
    vals = v.values.part_values()
    dtype = None
    crcs = {}
    for p, (iset, vv) in enumerate(zip(isets, vals)):
        owned = _owned(iset, np.asarray(vv))
        dtype = owned.dtype
        crcs[_shard_name(p, gen)] = _atomic_savez(
            os.path.join(directory, _shard_name(p, gen)),
            kind="pvector_shard",
            gids=np.asarray(iset.oid_to_gid, dtype=np.int64),
            values=owned,
        )
    _commit_index(
        directory,
        {
            "kind": "pvector",
            "ngids": int(v.rows.ngids),
            "nshards": len(isets),
            "gen": gen,
            "dtype": np.dtype(dtype if dtype is not None else v.dtype).name,
            "shards": crcs,
        },
    )


def load_pvector_sharded(directory: str, rows: PRange) -> PVector:
    """Restore a sharded PVector onto ``rows`` (any partition of the same
    global size), streaming one shard at a time — peak host memory is one
    shard plus the target's own local arrays. Ghost entries whose owner
    values appear in some shard are filled exactly, so no post-load
    exchange is needed (same contract as `load_pvector`).

    Routing per shard is O(n log n), part-count-independent: owned slots
    fill through an owner split (one argsort), ghost slots through a
    per-part binary search of that part's (few, surface-sized) ghost gids
    against the shard — not a full per-part scan of every shard."""
    idx = _read_index(directory, "pvector")
    if int(idx["ngids"]) != rows.ngids:
        raise ValueError(
            f"checkpoint has {idx['ngids']} gids, target PRange {rows.ngids}"
        )
    g = _select_generation(directory, idx)
    isets = rows.partition.part_values()
    dtype = np.dtype(g.get("dtype") or "float64")
    out = [np.zeros(i.num_lids, dtype=dtype) for i in isets]
    owner_of = _owner_fn(rows)
    gen = g.get("gen")
    hid_gids = [
        np.asarray(i.lid_to_gid)[np.asarray(i.hid_to_lid)] for i in isets
    ]
    for s in range(int(g["nshards"])):
        with np.load(os.path.join(directory, _shard_name(s, gen))) as z:
            gids, values = z["gids"], z["values"]
        # owned routing: one owner split per shard
        ow = owner_of(gids)
        order = np.argsort(ow, kind="stable")
        bounds = np.searchsorted(ow[order], np.arange(len(isets) + 1))
        sort_g = None
        for p, iset in enumerate(isets):
            chunk = order[bounds[p] : bounds[p + 1]]
            if len(chunk):
                lids = iset.gids_to_lids(gids[chunk])
                m = lids >= 0
                out[p][lids[m]] = values[chunk[m]]
            # ghost fill: look THIS part's ghost gids up in the shard
            hg = hid_gids[p]
            if len(hg):
                if sort_g is None:
                    sort_g = np.argsort(gids, kind="stable")
                    sg = gids[sort_g]
                pos = np.searchsorted(sg, hg)
                ok = pos < len(sg)
                ok[ok] = sg[pos[ok]] == hg[ok]
                if ok.any():
                    hl = np.asarray(isets[p].hid_to_lid)[ok]
                    out[p][hl] = values[sort_g[pos[ok]]]
    return PVector(rows.partition._like(out), rows)


def save_psparse_sharded(directory: str, A: PSparseMatrix) -> None:
    """Serialize a PSparseMatrix as one global-COO ``.npz`` per part
    (each part's owned-row triplets) — the sharded form of
    `save_psparse`, with the same assembled-matrix contract and the same
    generation-tagged crash atomicity as `save_pvector_sharded`."""
    from .psparse import psparse_owned_triplets

    gen = _new_generation()
    os.makedirs(directory, exist_ok=True)
    trip = psparse_owned_triplets(A).part_values()
    dtype = None
    crcs = {}
    for p, (gi, gj, v) in enumerate(trip):
        v = np.asarray(v)
        dtype = v.dtype
        crcs[_shard_name(p, gen)] = _atomic_savez(
            os.path.join(directory, _shard_name(p, gen)),
            kind="psparse_shard",
            gi=np.asarray(gi, dtype=np.int64),
            gj=np.asarray(gj, dtype=np.int64),
            v=v,
        )
    _commit_index(
        directory,
        {
            "kind": "psparse",
            "nrows": int(A.rows.ngids),
            "ncols": int(A.cols.ngids),
            "nshards": len(trip),
            "gen": gen,
            "dtype": np.dtype(dtype if dtype is not None else A.dtype).name,
            "shards": crcs,
        },
    )


def load_psparse_sharded(
    directory: str,
    rows: PRange,
    cols: Optional[PRange] = None,
) -> PSparseMatrix:
    """Restore a sharded PSparseMatrix onto ``rows``/``cols``, streaming
    one shard at a time; each target part keeps the triplets whose row it
    owns. Routing is one owner split (argsort + searchsorted) per shard —
    part-count-independent, the same pattern as `load_psparse`."""
    idx = _read_index(directory, "psparse")
    if int(idx["nrows"]) != rows.ngids:
        raise ValueError(
            f"checkpoint has {idx['nrows']} rows, target PRange {rows.ngids}"
        )
    g = _select_generation(directory, idx)
    isets = rows.partition.part_values()
    P = len(isets)
    dtype = np.dtype(g.get("dtype") or "float64")
    gi_p = [[] for _ in range(P)]
    gj_p = [[] for _ in range(P)]
    v_p = [[] for _ in range(P)]
    owner_of = _owner_fn(rows)
    gen = g.get("gen")
    for s in range(int(g["nshards"])):
        with np.load(os.path.join(directory, _shard_name(s, gen))) as z:
            gi, gj, v = z["gi"], z["gj"], z["v"]
        ow = owner_of(gi)
        order = np.argsort(ow, kind="stable")
        bounds = np.searchsorted(ow[order], np.arange(P + 1))
        for p in range(P):
            chunk = order[bounds[p] : bounds[p + 1]]
            if len(chunk):
                gi_p[p].append(gi[chunk])
                gj_p[p].append(gj[chunk])
                v_p[p].append(v[chunk])

    def _cat(chunks, dt):
        return [
            np.concatenate(c) if c else np.empty(0, dtype=dt) for c in chunks
        ]

    I = rows.partition._like(_cat(gi_p, np.int64))
    J = rows.partition._like(_cat(gj_p, np.int64))
    V = rows.partition._like(_cat(v_p, dtype))
    if cols is None:
        from .prange import add_gids

        cols = add_gids(rows, J)
    return PSparseMatrix.from_coo(I, J, V, rows, cols, ids="global")


def _owner_fn(rows: PRange):
    """gid -> owner part, preferring the PRange's lazy arithmetic map
    (no global array); falls back to a one-pass owner table."""
    if rows.gid_to_part is not None:
        return lambda g: np.asarray(rows.gid_to_part(np.asarray(g)))
    owner_of_gid = np.empty(rows.ngids, dtype=np.int32)
    for p, iset in enumerate(rows.partition.part_values()):
        owner_of_gid[np.asarray(iset.oid_to_gid)] = p
    return lambda g: owner_of_gid[np.asarray(g)]


def _new_generation() -> str:
    import secrets

    return secrets.token_hex(4)


def _shard_name(p: int, gen: Optional[str]) -> str:
    return f"shard{p:05d}-{gen}.npz" if gen else f"shard{p:05d}.npz"


#: Committed generations retained on disk (newest + fallback). The cost
#: is one extra copy of the object; the payoff is that a bit-rotted or
#: truncated newest generation degrades to the previous committed state
#: instead of to nothing.
KEEP_GENERATIONS = 2


def _commit_index(directory: str, idx: dict) -> None:
    """Atomically publish the new generation (recording per-shard CRCs
    and carrying forward the previous generation's entry under
    ``generations``), then best-effort remove shards of generations that
    fell off the retention window (their index entry is gone; a crash
    between the two steps only leaks orphan files, never corrupts a
    read)."""
    prev = []
    ipath = os.path.join(directory, "index.json")
    if os.path.isfile(ipath):
        try:
            with open(ipath) as f:
                old = json.load(f)
            if old.get("kind") == idx.get("kind"):
                prev = old.get("generations") or [
                    {
                        k: old[k]
                        for k in ("gen", "nshards", "dtype", "shards")
                        if k in old
                    }
                ]
        except (OSError, ValueError):
            prev = []  # an unreadable old index must not block the commit
    entry = {
        k: idx[k] for k in ("gen", "nshards", "dtype", "shards") if k in idx
    }
    gens = [entry] + [g for g in prev if g.get("gen") != idx["gen"]]
    idx["generations"] = gens[:KEEP_GENERATIONS]
    _atomic_json(ipath, idx)
    keep = {g["gen"] for g in idx["generations"]}
    for f in os.listdir(directory):
        if (
            f.startswith("shard")
            and f.endswith(".npz")
            and not any(f"-{g}." in f for g in keep)
        ):
            try:
                os.unlink(os.path.join(directory, f))
            except OSError:
                pass


def _select_generation(directory: str, idx: dict) -> dict:
    """The newest fully-verifiable generation of a sharded checkpoint:
    every shard file present and matching its committed CRC32. A
    truncated or bit-rotted newest generation falls back to the previous
    retained one (with a stderr note — operators should know their
    storage is eating data); `CheckpointCorruptError` only when no
    retained generation is clean. Pre-CRC indexes (no ``shards`` map)
    verify file presence only.

    Deliberately a SEPARATE pass before any deserialization (each shard
    is read twice on a clean load): the whole generation must be
    verified before routing begins, or corruption discovered mid-load
    would mean restarting the partially-filled restore against the
    fallback generation — the double read is the price of a simple
    all-or-nothing generation choice, and the second read hits the page
    cache."""
    gens = idx.get("generations")
    if not gens:
        gens = [
            {
                k: idx.get(k)
                for k in ("gen", "nshards", "dtype", "shards")
            }
        ]
    bad = {}
    for rank, g in enumerate(gens):
        ok = True
        for s in range(int(g["nshards"])):
            name = _shard_name(s, g.get("gen"))
            path = os.path.join(directory, name)
            if not os.path.isfile(path):
                bad[str(g.get("gen"))] = f"missing shard {name}"
                ok = False
                break
            want = (g.get("shards") or {}).get(name)
            if want is not None and _crc_file(path) != int(want):
                bad[str(g.get("gen"))] = (
                    f"CRC mismatch on shard {name} (truncated or bit-rotted)"
                )
                ok = False
                break
        if ok:
            if rank > 0:
                print(
                    f"[partitionedarrays_jl_tpu_torch] checkpoint {directory}: "
                    f"newest generation unreadable ({bad}); falling back "
                    f"to previous committed generation {g.get('gen')!r}",
                    file=sys.stderr,
                    flush=True,
                )
            return g
    raise CheckpointCorruptError(
        f"checkpoint {directory}: no clean generation — every retained "
        f"generation has a missing or corrupted shard: {bad}"
    )


def _read_index(directory: str, kind: str) -> dict:
    p = os.path.join(directory, "index.json")
    if not os.path.isfile(p):
        raise ValueError(f"{directory} is not a sharded checkpoint (no index.json)")
    with open(p) as f:
        idx = json.load(f)
    if idx.get("kind") != kind:
        raise ValueError(
            f"{directory} holds a {idx.get('kind')!r} checkpoint, not {kind!r}"
        )
    return idx


def _atomic_json(path: str, obj: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    os.close(fd)
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
        _replace_with_retry(
            tmp, path, f"checkpoint index publish ({os.path.basename(path)})"
        )
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _replace_with_retry(tmp: str, path: str, describe: str) -> None:
    """`os.replace` with backoff for shared-filesystem races (NFS ESTALE,
    transient EACCES on overlay mounts) — aware that the failure mode
    being retried may have COMMITTED the rename before erroring: a retry
    that finds tmp gone and path present after such an error is a
    success, not a FileNotFoundError to propagate."""
    maybe_landed = [False]

    def _do():
        try:
            os.replace(tmp, path)
        except FileNotFoundError:
            if (
                maybe_landed[0]
                and not os.path.exists(tmp)
                and os.path.exists(path)
            ):
                return  # the errored attempt actually landed
            raise
        except OSError:
            maybe_landed[0] = True
            raise

    retry_with_backoff(_do, exceptions=(OSError,), describe=describe)


def save_checkpoint(
    directory: str,
    objects: Dict[str, Union[PVector, PSparseMatrix]],
    meta: Optional[dict] = None,
    sharded: bool = False,
) -> None:
    """Write a named set of arrays + user metadata (e.g. the iteration
    number) as one checkpoint directory. Objects land as ``<name>.npz``
    (or, with ``sharded=True``, as per-part shard directories ``<name>/``
    that never materialize a global array on one host); the manifest is
    written last, so a checkpoint with a readable manifest is complete."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"meta": meta or {}, "objects": {}, "crcs": {}}
    if "meta" in objects:
        raise ValueError('the object name "meta" is reserved for checkpoint metadata')
    for name, obj in objects.items():
        if sharded:
            p = os.path.join(directory, name)
            if isinstance(obj, PVector):
                save_pvector_sharded(p, obj)
                manifest["objects"][name] = "pvector_sharded"
            elif isinstance(obj, PSparseMatrix):
                save_psparse_sharded(p, obj)
                manifest["objects"][name] = "psparse_sharded"
            else:
                raise TypeError(
                    f"cannot checkpoint object of type {type(obj).__name__}"
                )
            continue
        p = os.path.join(directory, f"{name}.npz")
        if isinstance(obj, PVector):
            manifest["crcs"][name] = save_pvector(p, obj)
            manifest["objects"][name] = "pvector"
        elif isinstance(obj, PSparseMatrix):
            manifest["crcs"][name] = save_psparse(p, obj)
            manifest["objects"][name] = "psparse"
        else:
            raise TypeError(
                f"cannot checkpoint object of type {type(obj).__name__}"
            )
    tmp = os.path.join(directory, ".manifest.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(directory, "manifest.json"))


def load_checkpoint(
    directory: str,
    ranges: Dict[str, PRange],
) -> Dict[str, Union[PVector, PSparseMatrix, dict]]:
    """Restore every object in a checkpoint directory. ``ranges`` maps
    object names to target PRanges (for a psparse entry the value may be a
    ``(rows, cols)`` tuple; a bare PRange rediscovers the column ghosts).
    Returns the objects plus the saved user metadata under ``"meta"``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Union[PVector, PSparseMatrix, dict]] = {
        "meta": manifest["meta"]
    }
    crcs = manifest.get("crcs") or {}
    for name, kind in manifest["objects"].items():
        if name not in ranges:
            raise ValueError(
                f"no target PRange given for checkpoint object {name!r}"
            )
        # whole-object files carry their CRC in the manifest; a mismatch
        # (truncated / bit-rotted write) is typed, not an np.load crash —
        # sharded objects verify per shard in _select_generation instead
        if kind in ("pvector", "psparse") and name in crcs:
            p = os.path.join(directory, f"{name}.npz")
            if not os.path.isfile(p) or _crc_file(p) != int(crcs[name]):
                raise CheckpointCorruptError(
                    f"checkpoint {directory}: object {name!r} is missing "
                    "or fails its committed CRC (truncated or bit-rotted)"
                )
        if kind == "pvector":
            out[name] = load_pvector(
                os.path.join(directory, f"{name}.npz"), ranges[name]
            )
        elif kind == "pvector_sharded":
            out[name] = load_pvector_sharded(
                os.path.join(directory, name), ranges[name]
            )
        else:
            tgt = ranges[name]
            rows, cols = tgt if isinstance(tgt, tuple) else (tgt, None)
            if kind == "psparse_sharded":
                out[name] = load_psparse_sharded(
                    os.path.join(directory, name), rows, cols
                )
            else:
                out[name] = load_psparse(
                    os.path.join(directory, f"{name}.npz"), rows, cols
                )
    return out


def _atomic_savez(path: str, **arrays) -> int:
    """Write atomically; returns the committed file's CRC32 (computed
    from the bytes on disk before the rename, so what the index records
    is what a clean later read must hash to)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        # np.savez(appends .npz to bare paths) — hand it the open file
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        crc = _crc_file(tmp)
        _replace_with_retry(
            tmp, path, f"checkpoint write ({os.path.basename(path)})"
        )
        return crc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# solver-state checkpointing (the recovery half of the resilience layer)
# ---------------------------------------------------------------------------


class SolverCheckpointer:
    """Periodic, optionally asynchronous checkpointing hook for solver
    loops (``cg``/``pcg`` take one via their ``checkpoint=`` argument;
    `models.solvers.solve_with_recovery` builds one for you).

    Every ``every`` iterations the loop hands over its FULL recurrence
    state (the iterate plus the residual/direction vectors and scalars),
    which is snapshotted synchronously — owned-value copies, so the loop
    may keep mutating — and serialized through `save_checkpoint`'s
    partition-independent format in a background thread
    (``async_write=True``, the default). A checkpoint therefore restores
    onto ANY part count, and a resumed run continues the recurrence
    exactly: same trajectory, bit-identical final iterate on the same
    partition (the `tests/test_faults.py` contract).

    One write is in flight at a time; a failed background write
    re-raises on the next `save_state`/`wait`. The manifest is written
    last (see `save_checkpoint`), so a crash mid-write leaves the
    previous complete checkpoint readable.
    """

    def __init__(self, directory: str, every: int = 25, async_write: bool = True):
        self.directory = str(directory)
        self.every = int(every)
        self.async_write = bool(async_write)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def due(self, it: int) -> bool:
        return self.every > 0 and it > 0 and it % self.every == 0

    def save_state(self, vectors: Dict[str, PVector], meta: dict) -> None:
        """Snapshot ``vectors`` (copied now) + ``meta`` (scalars; numpy
        types are converted to JSON-native) and write the checkpoint."""
        self.wait()  # one writer at a time; surfaces a prior failure
        objs = {k: v.copy() for k, v in vectors.items()}
        meta = _json_safe_meta(meta)
        # record the writing run's part count: load_solver_state refuses
        # a cross-part-count restore with CheckpointShapeError (older
        # checkpoints without the key are not checked)
        for v in vectors.values():
            meta.setdefault("nparts", int(v.rows.partition.num_parts))
            break
        from ..telemetry import emit_event

        emit_event(
            "checkpoint_save", label=str(meta.get("method", "")),
            iteration=meta.get("it"), directory=self.directory,
            vectors=sorted(objs), async_write=self.async_write,
        )
        if self.async_write:
            t = threading.Thread(
                target=self._write, args=(objs, meta), daemon=True,
                name="pa-checkpoint-writer",
            )
            self._thread = t
            t.start()
        else:
            self._write(objs, meta)
            self.wait()

    def _write(self, objs, meta):
        try:
            save_checkpoint(self.directory, objs, meta=meta)
        except BaseException as e:  # surfaced on the next save/wait
            self._error = e

    def wait(self) -> None:
        """Block until the in-flight write (if any) lands; re-raise its
        failure if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def has_state(self) -> bool:
        return os.path.isfile(os.path.join(self.directory, "manifest.json"))


def _json_safe_meta(meta: dict) -> dict:
    """Scalars/lists of numpy numbers -> JSON-native (Python repr round-
    trips floats exactly, so resumed scalars are bit-identical)."""

    def conv(v):
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, np.ndarray):
            return [conv(x) for x in v.tolist()]
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return conv(dict(meta))


def load_solver_state(
    directory: str, ranges: Dict[str, PRange]
) -> Optional[Dict[str, Union[PVector, PSparseMatrix, dict]]]:
    """Restore a solver-state checkpoint written by `SolverCheckpointer`
    onto ``ranges`` (any partition of the same global sizes), or None
    when ``directory`` holds no complete checkpoint yet — the caller
    then restarts from scratch instead of failing.

    A checkpoint that records its writing part count (every
    `SolverCheckpointer` write does) restores onto another part count
    with `CheckpointShapeError`, so a resume never silently repartitions
    a live recurrence (the generic `load_checkpoint` stays
    partition-independent)."""
    if not os.path.isfile(os.path.join(directory, "manifest.json")):
        return None
    with open(os.path.join(directory, "manifest.json")) as f:
        _manifest = json.load(f)
    src_parts = (_manifest.get("meta") or {}).get("nparts")
    tgt_parts = next(
        (
            int(r.num_parts)
            for r in ranges.values()
            if isinstance(r, PRange)
        ),
        None,
    )
    if src_parts is not None and tgt_parts is not None and int(src_parts) != tgt_parts:
        raise CheckpointShapeError(
            f"solver-state checkpoint {directory!r} was written at {int(src_parts)} parts but the restore "
            f"target has {tgt_parts} parts: cross-part-count solver restores are an elastic-tier decision, "
            "which the port does not have"
        )
    st = load_checkpoint(directory, ranges)
    from ..telemetry import emit_event

    meta = st.get("meta", {}) if isinstance(st, dict) else {}
    emit_event(
        "checkpoint_restore", label=str(meta.get("method", "")),
        iteration=meta.get("it"), directory=str(directory),
    )
    return st
