"""K-process stencil emission into shared memory: the port's copy of
`partitionedarrays_jl_tpu/native/parallel_emit.py`.

The per-part CSR of a Cartesian stencil is emitted row-slab by row-slab:
each row's nnz is known in closed form (identity rows carry 1 entry,
interior rows 2*dim+1 — planning.cpp emits decoupled values in place,
pattern preserved), so every slab's output offset is computable before
any emission runs. K spawned workers therefore write DISJOINT slices of
one preallocated shared-memory CSR with zero stitching, and the result
is byte-identical to the one-shot `native.stencil_emit`
(`tests/test_torch_native.py`).

`spawn` context by design: forking a process with live CUDA or torch
threads is deadlock-prone. Each spawned worker first runs this file as a
script (`_boot`), which registers the package as a bare namespace, so the
task's import of `partitionedarrays_jl_tpu_torch.native.parallel_emit`
loads `native/__init__.py` (numpy and ctypes) without the package's
`__init__.py`, which imports torch. A failed emission raises.

On a 1-core host the K-process wall time is ~1x the serial emission; the
same switch scales on multi-core planning hosts.
Reference anchor: per-rank local assembly, test/test_fdm.jl:52-81.
"""
from __future__ import annotations

import math
import runpy
import sys
import types
from multiprocessing import get_context, shared_memory
from pathlib import Path

import numpy as np

__all__ = ["stencil_emit_parallel", "slab_nnz"]

_PKG = "partitionedarrays_jl_tpu_torch"
#: the run name under which a spawned worker executes this file (`_boot`)
_BOOT = "__pa_torch_emit_boot__"

# one spawn pool per worker count, reused across parts and calls.
# Terminated at interpreter exit.
_pools: dict = {}


def _boot() -> None:
    """Register the package and its `native` subpackage by path, without
    running the package's `__init__.py` (which imports torch)."""
    if _PKG in sys.modules:
        return
    pkg_dir = Path(__file__).resolve().parents[1]
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = [str(pkg_dir)]
    sys.modules[_PKG] = pkg


def _pool(k: int):
    import atexit

    p = _pools.get(k)
    if p is None:
        p = _pools[k] = get_context("spawn").Pool(
            k, initializer=runpy.run_path, initargs=(__file__, None, _BOOT)
        )
        if len(_pools) == 1:
            atexit.register(_shutdown_pools)
    return p


def _shutdown_pools():
    for p in _pools.values():
        p.terminate()
        p.join()
    _pools.clear()


def _worker_imports(_=None):
    """Whether torch is loaded in a worker (its import path must not need it)."""
    return "torch" in sys.modules


def slab_nnz(dims, lo, hi, i0, i1):
    """Exact nnz of box row-slab i in [i0, i1) (slab along box dim 0):
    interior grid cells emit 2*dim+1 entries, grid-boundary cells 1."""
    dim = len(dims)

    def interior_count(d, a, b):
        # grid coords [a, b) clipped to the interior band [1, dims[d]-1)
        return max(0, min(b, dims[d] - 1) - max(a, 1))

    rows = (i1 - i0) * math.prod(hi[d] - lo[d] for d in range(1, dim))
    inter = interior_count(0, lo[0] + i0, lo[0] + i1)
    for d in range(1, dim):
        inter *= interior_count(d, lo[d], hi[d])
    return inter * (2 * dim + 1) + (rows - inter) * 1


def _worker(args):
    """Emit rows [row0, row1) into the shared CSR at offset nnz0.

    Top-level so `spawn` can import it; attaches the shm segments by
    name, wraps zero-copy views, and calls the native range kernel."""
    (
        shm_names, dims, lo, hi, center, arm_vals, ghost_gids, dt_name,
        decouple, xtab, row0, row1, nnz0, nnz_slab, with_b, nnz_total,
    ) = args
    from partitionedarrays_jl_tpu_torch import native

    no = math.prod(h - l for h, l in zip(hi, lo))
    segs = {k: shared_memory.SharedMemory(name=v) for k, v in shm_names.items()}
    # NOTE on cpython <=3.12 attach-registration (bpo-38119): pool
    # workers spawned by _pool() inherit the PARENT'S resource tracker,
    # so their attach-registrations land in the same (idempotent) cache
    # entry the parent's create made — the parent's unlink() unregisters
    # it once, no "leaked shared_memory" warnings and no double
    # unregister (a worker-side unregister here would KeyError the
    # shared tracker daemon)
    try:
        dt = np.dtype(dt_name)
        # shm segments are page-rounded: size the views from geometry,
        # never from seg.size
        indptr = np.ndarray(no + 1, dtype=np.int32, buffer=segs["indptr"].buf)
        cols = np.ndarray(nnz_total, dtype=np.int32, buffer=segs["cols"].buf)
        vals = np.ndarray(nnz_total, dtype=dt, buffer=segs["vals"].buf)
        b = (
            np.ndarray(no, dtype=dt, buffer=segs["b"].buf)
            if with_b
            else None
        )
        ip_slab = np.empty(row1 - row0 + 1, dtype=np.int32)
        w = native.stencil_emit_range(
            dims, lo, hi, center, arm_vals, ghost_gids, dt,
            row0, row1,
            ip_slab,
            cols[nnz0 : nnz0 + nnz_slab],
            vals[nnz0 : nnz0 + nnz_slab],
            b_out=b[row0:row1] if with_b else None,
            decouple=decouple,
            xtab=xtab,
        )
        if w is None or w != nnz_slab:
            return (row0, -1 if w is None else w)
        # absolute indptr: every slab's relative pointers + its offset.
        # Slab k writes indptr[row0] == nnz0, which slab k-1 also wrote
        # as its LAST entry — same value, benign overlap.
        indptr[row0 : row1 + 1] = ip_slab + np.int32(nnz0)
        return (row0, w)
    finally:
        for s in segs.values():
            s.close()


def stencil_emit_parallel(
    dims, lo, hi, center, arm_vals, ghost_gids, dtype, procs,
    decouple=False, xtab=None,
):
    """`native.stencil_emit` semantics, emitted by `procs` spawned
    workers over row slabs. Returns (indptr, cols, vals[, b]) or None
    when ineligible (callers use the serial path); raises when a worker's
    emission declines or comes out short."""
    from partitionedarrays_jl_tpu_torch import native

    dim = len(dims)
    dims = tuple(int(d) for d in dims)
    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    box0 = hi[0] - lo[0]
    if not native.available() or dim > 3 or procs < 2 or box0 < 2:
        return None
    dt = np.dtype(dtype)
    if dt.name not in ("float64", "float32"):
        return None
    no = math.prod(h - l for h, l in zip(hi, lo))
    inner = math.prod(hi[d] - lo[d] for d in range(1, dim))
    nnz_total = slab_nnz(dims, lo, hi, 0, box0)
    if nnz_total >= 2**31 or no + len(ghost_gids) >= 2**31 or no == 0:
        return None
    with_b = xtab is not None

    K = min(procs, box0)
    cuts = [round(k * box0 / K) for k in range(K + 1)]
    gg = np.ascontiguousarray(ghost_gids, dtype=np.int64)
    av = np.ascontiguousarray(arm_vals, dtype=np.float64)
    xt = np.ascontiguousarray(xtab, dtype=np.float64) if with_b else None

    shm = {}
    try:
        # created INSIDE the try: a partial creation (e.g. no room left
        # in shared memory) must roll back the segments already made
        shm["indptr"] = shared_memory.SharedMemory(
            create=True, size=(no + 1) * 4
        )
        shm["cols"] = shared_memory.SharedMemory(
            create=True, size=nnz_total * 4
        )
        shm["vals"] = shared_memory.SharedMemory(
            create=True, size=nnz_total * dt.itemsize
        )
        if with_b:
            shm["b"] = shared_memory.SharedMemory(
                create=True, size=max(no, 1) * dt.itemsize
            )
        names = {k: s.name for k, s in shm.items()}
        tasks = []
        nnz0 = 0
        for k in range(K):
            i0, i1 = cuts[k], cuts[k + 1]
            if i0 == i1:
                continue
            nz = slab_nnz(dims, lo, hi, i0, i1)
            tasks.append(
                (
                    names, dims, lo, hi, float(center), av, gg, dt.name,
                    bool(decouple), xt, i0 * inner, i1 * inner, nnz0, nz,
                    with_b, nnz_total,
                )
            )
            nnz0 += nz
        assert nnz0 == nnz_total, (nnz0, nnz_total)
        # one pool keyed by the REQUESTED worker count: parts whose dim-0
        # extent caps K below procs would otherwise spawn a second pool
        # per distinct task count; submitting fewer tasks to a procs-wide
        # pool is free
        results = _pool(procs).map(_worker, tasks)
        bad = [(r0, w) for (r0, w), t in zip(results, tasks) if w < 0 or w != t[13]]
        if bad:
            raise RuntimeError(f"stencil_emit_parallel: slabs (first row, nnz) {bad} declined or came out short")
        indptr = np.ndarray(
            no + 1, dtype=np.int32, buffer=shm["indptr"].buf
        ).copy()
        cols = np.ndarray(
            nnz_total, dtype=np.int32, buffer=shm["cols"].buf
        ).copy()
        vals = np.ndarray(
            nnz_total, dtype=dt, buffer=shm["vals"].buf
        ).copy()
        out = (indptr, cols, vals)
        if with_b:
            out = out + (
                np.ndarray(no, dtype=dt, buffer=shm["b"].buf).copy(),
            )
        return out
    finally:
        for s in shm.values():
            try:
                s.close()
            finally:
                s.unlink()


if __name__ == _BOOT:
    _boot()
