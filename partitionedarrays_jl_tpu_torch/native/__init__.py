"""The port's native planning layer: its own `planning.cpp`, built by g++
at first use, and ctypes bindings with the JAX package's names and return
conventions (`partitionedarrays_jl_tpu/native/__init__.py:220-950`).

The library is compiled from this package's `planning.cpp` into
`build/pa_torch_planning/libpa_planning_<hash>.so`, the hash taken over
the source and the flags, written to a temporary name and `os.replace`d
into place (parallel test workers build at once). A failed build raises
with g++'s output: the port never degrades to NumPy behind the caller's
back. The NumPy route stays reachable through the module switches, the
port's form of the JAX package's environment variables (the port reads no
environment):

* `ENABLED` (``PA_TPU_NATIVE``): False plans with NumPy only; every
  wrapper then answers as the JAX package's does with the layer absent
  (None / False, or its own NumPy fallback).
* `STENCIL_FAST` (``PA_TPU_STENCIL_FAST``): the COO-free Cartesian stencil
  assembly of `models/poisson_fdm.py`.
* `PLAN_PROCS` (``PA_TPU_PLAN_PROCS``): worker processes per part for
  that assembly's emission (`parallel_emit.py`); a failure raises.

`-ffp-contract=off` keeps `csr_spmv`'s left-to-right fold free of fused
multiply-adds, so the host products are the bits the JAX package's
drivers take for b. This module imports numpy and ctypes only: the
emission workers of `parallel_emit.py` load it without torch."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

#: plan with the native layer (False: NumPy only)
ENABLED = True
#: the COO-free Cartesian stencil assembly (False: the COO route)
STENCIL_FAST = True
#: worker processes per part of the stencil emission (1: in process)
PLAN_PROCS = 1
#: the C++ compiler that builds the library
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

SOURCE = Path(__file__).resolve().parent / "planning.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pa_torch_planning"

_lib: Optional[ctypes.CDLL] = None
#: the path of the loaded library
LIBRARY: Optional[Path] = None


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library of this source and these flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libpa_planning_{tag}.so"


def build(cxx: Optional[str] = None, build_dir: Optional[Path] = None) -> Path:
    """Compile `planning.cpp` unless its library is already built; return
    the library's path. Raises RuntimeError with the compiler's output
    when the build fails."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f".{so.name}.{os.getpid()}.tmp"
    cmd = [cxx or CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native planning build: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native planning build failed ({' '.join(cmd)}), exit {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def compiler_version(cxx: Optional[str] = None) -> str:
    """The first line of ``<cxx> --version``."""
    out = subprocess.run([cxx or CXX, "--version"], capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).splitlines()[0] if (out.stdout or out.stderr) else ""


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None when `ENABLED` is off.
    A failed build raises."""
    global _lib, LIBRARY
    if not ENABLED:
        return None
    if _lib is not None:
        return _lib
    so = build()
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    _lib, LIBRARY = lib, so
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    """The argument and result types of every `extern "C"` entry."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pa_box_gids_to_lids.argtypes = [
        i64p, ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int32, i32p,
    ]
    lib.pa_box_gids_to_lids.restype = None
    lib.pa_box_gids_to_lids_i32.argtypes = [
        i32p, ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int32, i32p,
    ]
    lib.pa_box_gids_to_lids_i32.restype = None
    lib.pa_lookup_sorted.argtypes = [
        i64p, ctypes.c_int64, i64p, i32p, ctypes.c_int64, i32p,
    ]
    lib.pa_lookup_sorted.restype = ctypes.c_int64
    lib.pa_lookup_sorted_i32.argtypes = [
        i32p, ctypes.c_int64, i64p, i32p, ctypes.c_int64, i32p,
    ]
    lib.pa_lookup_sorted_i32.restype = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    for name, fp in (("pa_coo_to_csr_f64", f64p), ("pa_coo_to_csr_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, fp, i32p,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_coo_to_csr_i64_f64", f64p), ("pa_coo_to_csr_i64_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i64p, i64p, fp, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, fp, i32p,
        ]
        fn.restype = ctypes.c_int64
    lib.pa_unique_small_f64.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, f64p,
    ]
    lib.pa_unique_small_f64.restype = ctypes.c_int64
    lib.pa_row_classes_f64.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, f64p, u8p,
    ]
    lib.pa_row_classes_f64.restype = ctypes.c_int64
    lib.pa_ic0_f64.argtypes = [i32p, i32p, f64p, ctypes.c_int64, f64p]
    lib.pa_ic0_f64.restype = ctypes.c_int64
    for name, fp in (("pa_csr_split_f64", f64p), ("pa_csr_split_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, ctypes.c_int32,
            i32p, i32p, fp, i32p, i32p, fp,
        ]
        fn.restype = None
    for name, fp in (("pa_csr_spmv_f64", f64p), ("pa_csr_spmv_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [i32p, i32p, fp, ctypes.c_int64, fp, fp]
        fn.restype = None
    for name, fp in (("pa_dia_fill_f64", f64p), ("pa_dia_fill_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int64, f64p,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (("pa_csr_diag_f64", f64p), ("pa_csr_diag_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [i32p, i32p, fp, ctypes.c_int64, fp]
        fn.restype = None
    for name, fp in (("pa_galerkin3_f64", f64p), ("pa_galerkin3_f32", f32p)):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, i64p, i64p, i64p, i64p,
            i64p, i64p, i64p, ctypes.c_int32, f64p,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_galerkin3_sub_f64", f64p), ("pa_galerkin3_sub_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, i64p, i64p, i64p, i64p,
            i64p, i64p, i64p, ctypes.c_int32, f64p, i64p, i64p,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_galerkin_classify_f64", f64p),
        ("pa_galerkin_classify_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, i64p, i64p,
            ctypes.c_int32, ctypes.c_int64, f64p, u8p,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_galerkin_emit_f64", f64p), ("pa_galerkin_emit_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            f64p, i64p, i64p, i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int32, i32p, i32p, fp,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_stencil_emit_f64", f64p), ("pa_stencil_emit_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i64p, i64p, i64p, ctypes.c_int32, ctypes.c_double, f64p,
            i64p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, fp,
            f64p, fp, ctypes.c_int32,
        ]
        fn.restype = ctypes.c_int64
    for name, fp in (
        ("pa_stencil_emit_range_f64", f64p),
        ("pa_stencil_emit_range_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i64p, i64p, i64p, ctypes.c_int32, ctypes.c_double, f64p,
            i64p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, fp,
            f64p, fp, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ]
        fn.restype = ctypes.c_int64
    lib.pa_band_offsets.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, i64p,
        ctypes.c_int64,
    ]
    lib.pa_band_offsets.restype = ctypes.c_int64
    for name, fp in (
        ("pa_dia_classify_f64", f64p), ("pa_dia_classify_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int64, f64p, u8p, ctypes.c_int64,
        ]
        fn.restype = ctypes.c_int64
    lib.pa_count_ge.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32]
    lib.pa_count_ge.restype = ctypes.c_int64
    for name, fp in (
        ("pa_csr_extract_hi_f64", f64p), ("pa_csr_extract_hi_f32", f32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i32p, i32p, fp, ctypes.c_int64, ctypes.c_int32,
            i32p, i32p, fp,
        ]
        fn.restype = None


def available() -> bool:
    """Whether the native layer is on (and so built and loaded)."""
    return _load() is not None


def box_gids_to_lids(
    gids: np.ndarray, grid, lo, hi, out: np.ndarray
) -> bool:
    """out[i] = C-order lid of gids[i] inside box [lo, hi) of `grid`, or
    -1. Returns False (untouched out) when the native layer is absent."""
    lib = _load()
    if lib is None or len(grid) > 8:
        return False
    if np.asarray(gids).dtype == np.int32:
        # int32 COO batches skip the n-sized int64 conversion copy
        g = np.ascontiguousarray(gids, dtype=np.int32)
        fn = lib.pa_box_gids_to_lids_i32
    else:
        g = np.ascontiguousarray(gids, dtype=np.int64)
        fn = lib.pa_box_gids_to_lids
    fn(
        g,
        len(g),
        np.asarray(grid, dtype=np.int64),
        np.asarray(lo, dtype=np.int64),
        np.asarray(hi, dtype=np.int64),
        len(grid),
        out,
    )
    return True


def lookup_sorted(
    gids: np.ndarray, sorted_gids: np.ndarray, lid_of: np.ndarray, out: np.ndarray
) -> bool:
    """Fill out[i] (where still -1) with lid_of[searchsorted hit]."""
    lib = _load()
    if lib is None:
        return False
    if np.asarray(gids).dtype == np.int32:
        g = np.ascontiguousarray(gids, dtype=np.int32)
        fn = lib.pa_lookup_sorted_i32
    else:
        g = np.ascontiguousarray(gids, dtype=np.int64)
        fn = lib.pa_lookup_sorted
    fn(
        g,
        len(g),
        np.ascontiguousarray(sorted_gids, dtype=np.int64),
        np.ascontiguousarray(lid_of, dtype=np.int32),
        len(sorted_gids),
        out,
    )
    return True


_FLOAT_FN = {"float64": "f64", "float32": "f32"}


def coo_to_csr(I, J, V, m: int, n: int):
    """COO -> (indptr, cols, vals) CSR with column-sorted rows and
    +-accumulated duplicates. None when native is absent or the inputs are
    out of the int32/float32-64 envelope. int64 and int32 I/J are both
    consumed in place (no conversion copy) when already matching and
    contiguous."""
    lib = _load()
    dt = np.dtype(np.asarray(V).dtype).name
    if (
        lib is None
        or dt not in _FLOAT_FN
        or m >= 2**31
        or n >= 2**31
        or len(I) >= 2**31
    ):
        return None
    nnz = len(I)
    if np.asarray(I).dtype == np.int64 and np.asarray(J).dtype == np.int64:
        Ic = np.ascontiguousarray(I, dtype=np.int64)
        Jc = np.ascontiguousarray(J, dtype=np.int64)
        fn = getattr(lib, f"pa_coo_to_csr_i64_{_FLOAT_FN[dt]}")
    else:
        Ic = np.ascontiguousarray(I, dtype=np.int32)
        Jc = np.ascontiguousarray(J, dtype=np.int32)
        fn = getattr(lib, f"pa_coo_to_csr_{_FLOAT_FN[dt]}")
    Vc = np.ascontiguousarray(V)
    indptr = np.empty(m + 1, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=Vc.dtype)
    cursor = np.empty(max(m, 1), dtype=np.int32)
    w = fn(Ic, Jc, Vc, nnz, m, indptr, cols, vals, cursor)
    if w < (nnz * 3) // 4:  # compaction shrank a lot: don't pin dead memory
        return indptr, cols[:w].copy(), vals[:w].copy()
    return indptr, cols[:w], vals[:w]


def csr_split_by_col(indptr, cols, vals, m: int, thr: int):
    """Split a full-row CSR at a column threshold into (lo, hi) halves,
    hi columns remapped by -thr. Returns ((ip, c, v) lo, (ip, c, v) hi)
    or None when native is absent/ineligible."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    if lib is None or dt not in _FLOAT_FN or len(cols) >= 2**31:
        return None
    n_lo = int(np.count_nonzero(np.asarray(cols) < thr))
    n_hi = len(cols) - n_lo
    ip = np.ascontiguousarray(indptr, dtype=np.int32)
    c = np.ascontiguousarray(cols, dtype=np.int32)
    v = np.ascontiguousarray(vals)
    ip_lo = np.empty(m + 1, dtype=np.int32)
    c_lo = np.empty(n_lo, dtype=np.int32)
    v_lo = np.empty(n_lo, dtype=v.dtype)
    ip_hi = np.empty(m + 1, dtype=np.int32)
    c_hi = np.empty(n_hi, dtype=np.int32)
    v_hi = np.empty(n_hi, dtype=v.dtype)
    fn = getattr(lib, f"pa_csr_split_{_FLOAT_FN[dt]}")
    fn(ip, c, v, m, thr, ip_lo, c_lo, v_lo, ip_hi, c_hi, v_hi)
    return (ip_lo, c_lo, v_lo), (ip_hi, c_hi, v_hi)


def csr_spmv(indptr, cols, vals, x, y) -> bool:
    """Fused y = A @ x over a CSR (one pass, no nnz-sized temporary; see
    csr_spmv_impl). Returns False untouched when native is absent or the
    dtypes/widths are out of envelope; `y` must be preallocated with the
    result dtype of (vals, x)."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    if (
        lib is None
        or dt not in _FLOAT_FN
        or np.asarray(x).dtype != np.asarray(vals).dtype
        or y.dtype != np.asarray(vals).dtype
        or len(cols) >= 2**31
    ):
        return False
    fn = getattr(lib, f"pa_csr_spmv_{_FLOAT_FN[dt]}")
    fn(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        len(y),
        np.ascontiguousarray(x),
        y,
    )
    return True


def dia_fill(indptr, cols, vals, m: int, offsets, dia: np.ndarray) -> bool:
    """Scatter CSR entries into dense per-diagonal rows:
    dia[d, i] = A[i, i + offsets[d]] (dia is (D, stride) float64,
    pre-zeroed). Returns False untouched when native is absent, and
    raises ValueError when an entry's offset is not in `offsets` (the
    caller's offset set must be the union it just computed)."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    if lib is None or dt not in _FLOAT_FN or len(cols) >= 2**31:
        return False
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    fn = getattr(lib, f"pa_dia_fill_{_FLOAT_FN[dt]}")
    rc = fn(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        m,
        off,
        len(off),
        dia.shape[1],
        dia,
    )
    if rc != 0:
        raise ValueError("dia_fill: entry offset outside the offset set")
    return True


def csr_diag(indptr, cols, vals, m: int):
    """Diagonal of a column-sorted CSR block (missing entries 0), or
    None when the native layer is absent / dtype out of envelope."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    if lib is None or dt not in _FLOAT_FN or len(cols) >= 2**31:
        return None
    d = np.empty(m, dtype=np.asarray(vals).dtype)
    fn = getattr(lib, f"pa_csr_diag_{_FLOAT_FN[dt]}")
    fn(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        m,
        d,
    )
    return d


def galerkin3(
    indptr, cols, vals, no: int, lid_gid, fdims, flo, fhi, cdims, elo, ehi,
    sub_coords=None,
):
    """Per-part Galerkin stencil collapse A_c = P^T A P over an owned
    fine box (d-linear P, d <= 3): returns the POS-MAJOR
    (prod(ehi-elo), 3^dim) float64 diagonal accumulator, or None when
    native is absent, dim > 3, or some fine entry's coordinate offset
    leaves the +-1 cube (the caller falls back to the generic sparse
    product).

    ``sub_coords`` (per-dim sequences of GLOBAL fine coordinates, each
    sorted, within [flo, fhi)) restricts the collapse to the product of
    those fine rows — the rep-support mode of the classed collapse:
    accumulator rows fully supported by the subset are exact, all others
    are partial garbage the caller overwrites by expansion."""
    lib = _load()
    dim = len(fdims)
    if lib is None or dim > 3 or len(cols) >= 2**31:
        return None
    dt = np.dtype(np.asarray(vals).dtype).name
    if dt not in _FLOAT_FN:
        return None
    ebox = [int(h - l) for l, h in zip(elo, ehi)]
    out = np.zeros((int(np.prod(ebox)), 3**dim), dtype=np.float64)
    args = [
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        no,
        np.ascontiguousarray(lid_gid, dtype=np.int64),
        np.asarray(fdims, dtype=np.int64),
        np.asarray(flo, dtype=np.int64),
        np.asarray(fhi, dtype=np.int64),
        np.asarray(cdims, dtype=np.int64),
        np.asarray(elo, dtype=np.int64),
        np.asarray(ehi, dtype=np.int64),
        dim,
        out,
    ]
    if sub_coords is None:
        fn = getattr(lib, f"pa_galerkin3_{_FLOAT_FN[dt]}")
        rc = fn(*args)
    else:
        counts = np.array([len(c) for c in sub_coords], dtype=np.int64)
        flat = (
            np.concatenate([np.asarray(c, dtype=np.int64) for c in sub_coords])
            if counts.sum()
            else np.zeros(1, dtype=np.int64)
        )
        fn = getattr(lib, f"pa_galerkin3_sub_{_FLOAT_FN[dt]}")
        rc = fn(*args, np.ascontiguousarray(flat), counts)
    if rc < 0:
        # -1: operator outside the 3^d closure. Other negative codes are
        # unreachable with the current elo/ehi formulas, but any kernel
        # decline must stay recoverable — the generic sparse-product
        # fallback always covers it (a hard raise here would turn a
        # box-metadata inconsistency into a crash).
        return None
    return out


def galerkin_classify(indptr, cols, vals, no: int, fbox, ghost_rel, K: int):
    """Row classes of a part's fine operator keyed by its 3^d GRID-OFFSET
    value signature (planning.cpp:galerkin_classify_dim) — the
    precondition check of the classed Galerkin collapse. ``ghost_rel``
    is the (nh, d) int64 table of ghost-lid coordinates relative to the
    part's box lo. Returns ``(table, codes, ok)``; ok=False when native
    is absent, dim > 3, an offset leaves the +-1 cube, or a (K+1)-th
    class appears — callers then run the unclassed collapse."""
    lib = _load()
    dim = len(fbox)
    dt = np.dtype(np.asarray(vals).dtype).name
    if lib is None or dim > 3 or dt not in _FLOAT_FN or len(cols) >= 2**31:
        return None, None, False
    ne = 3**dim
    table = np.empty((K, ne), dtype=np.float64)
    codes = np.empty(max(no, 1), dtype=np.uint8)
    gr = np.ascontiguousarray(
        np.asarray(ghost_rel, dtype=np.int64).reshape(-1, dim)
    )
    if not len(gr):
        gr = np.zeros((1, dim), dtype=np.int64)
    fn = getattr(lib, f"pa_galerkin_classify_{_FLOAT_FN[dt]}")
    cnt = fn(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        no,
        np.asarray(fbox, dtype=np.int64),
        gr,
        dim,
        K,
        table,
        codes,
    )
    if cnt < 0:
        return None, None, False
    return table[:cnt].copy(), codes[:no], True


def galerkin_emit(
    acc, cdims, elo, ehi, clo, chi, ghost_gids, dtype
):
    """Fused CSR emission from the galerkin3 accumulator (see
    planning.cpp:galerkin_emit_dim): returns (indptr, cols, vals) over
    the part's owned coarse box with LOCAL column lids (owned-box
    C-order, then `ghost_gids` ranks offset by n_owned), column-sorted
    rows, structural zeros dropped — or None when the native layer is
    absent / dim > 3 / a nonzero column is missing from `ghost_gids`
    (callers fall back to the COO assembly path)."""
    lib = _load()
    dim = len(cdims)
    dt = np.dtype(dtype).name
    if lib is None or dim > 3 or dt not in _FLOAT_FN:
        return None
    no = 1
    for l, h in zip(clo, chi):
        no *= int(h - l)
    cap = no * 3**dim
    if cap >= 2**31:
        return None
    indptr = np.empty(no + 1, dtype=np.int32)
    cols = np.empty(cap, dtype=np.int32)
    vals = np.empty(cap, dtype=dtype)
    if no == 0:
        indptr[:] = 0
        return indptr, cols[:0], vals[:0]
    gg = np.ascontiguousarray(ghost_gids, dtype=np.int64)
    fn = getattr(lib, f"pa_galerkin_emit_{_FLOAT_FN[dt]}")
    w = fn(
        np.ascontiguousarray(acc, dtype=np.float64),
        np.asarray(cdims, dtype=np.int64),
        np.asarray(elo, dtype=np.int64),
        np.asarray(ehi, dtype=np.int64),
        np.asarray(clo, dtype=np.int64),
        np.asarray(chi, dtype=np.int64),
        gg,
        len(gg),
        dim,
        indptr,
        cols,
        vals,
    )
    if w < 0:
        return None
    if w < (cap * 3) // 4:  # don't pin dead capacity
        return indptr, cols[:w].copy(), vals[:w].copy()
    return indptr, cols[:w], vals[:w]


def stencil_emit(
    dims, lo, hi, center, arm_vals, ghost_gids, dtype, decouple=False,
    xtab=None,
):
    """Fused Dirichlet-identity Cartesian-stencil assembly straight to
    column-sorted per-part CSR with local column ids (owned-box C-order,
    then SORTED `ghost_gids` ranks offset by n_owned — add_gids's append
    order for a sorted input). See planning.cpp:stencil_emit_dim.
    ``decouple`` zeroes interior->boundary coupling VALUES in place
    (pattern preserved), emitting the `decouple_dirichlet`'d operator
    directly. ``xtab`` (a concatenated per-dim float64 table, one entry
    per global coordinate) additionally computes b = A @ x^ in the same
    pass, where x^ is the tables' left-to-right sum cast to `dtype` —
    bit-identical to evaluating the manufactured field and running the
    host's phased mul_into, WITHOUT materializing the owned/ghost block
    split. Returns (indptr, cols, vals[, b]) or None when the native
    layer is absent / dim > 3 / the int32 envelope is exceeded (callers
    fall back to the COO assembly path)."""
    lib = _load()
    dim = len(dims)
    dt = np.dtype(dtype).name
    if lib is None or dim > 3 or dt not in _FLOAT_FN:
        return None
    no = 1
    for l, h in zip(lo, hi):
        no *= int(h - l)
    cap = no * (2 * dim + 1)
    if cap >= 2**31 or no + len(ghost_gids) >= 2**31:
        return None
    indptr = np.empty(no + 1, dtype=np.int32)
    cols = np.empty(cap, dtype=np.int32)
    vals = np.empty(cap, dtype=dtype)
    with_b = xtab is not None
    if with_b:
        xt = np.ascontiguousarray(xtab, dtype=np.float64)
        if len(xt) != int(np.sum(dims)):
            raise ValueError(
                "stencil_emit: xtab must hold one entry per global "
                "coordinate"
            )
        bout = np.empty(max(no, 1), dtype=dtype)
    else:
        xt = np.zeros(1, dtype=np.float64)
        bout = np.empty(1, dtype=dtype)
    if no == 0:
        indptr[:] = 0
        out = (indptr, cols[:0], vals[:0])
        return out + (bout[:0],) if with_b else out
    gg = np.ascontiguousarray(ghost_gids, dtype=np.int64)
    fn = getattr(lib, f"pa_stencil_emit_{_FLOAT_FN[dt]}")
    w = fn(
        np.asarray(dims, dtype=np.int64),
        np.asarray(lo, dtype=np.int64),
        np.asarray(hi, dtype=np.int64),
        dim,
        float(center),
        np.ascontiguousarray(arm_vals, dtype=np.float64),
        gg,
        len(gg),
        1 if decouple else 0,
        indptr,
        cols,
        vals,
        xt,
        bout,
        1 if with_b else 0,
    )
    if w < 0:
        return None
    if w < (cap * 3) // 4:  # boundary-heavy part: don't pin dead capacity
        out = (indptr, cols[:w].copy(), vals[:w].copy())
    else:
        out = (indptr, cols[:w], vals[:w])
    return out + (bout,) if with_b else out


def _interior_prefix(dims, lo, hi, t, d):
    """#cells with ALL coordinates grid-interior among the first ``t``
    cells (C-order) of the box restricted to dims ``d..``."""
    if t <= 0:
        return 0
    if d == len(dims):
        return 1
    inner = 1
    for e in range(d + 1, len(dims)):
        inner *= int(hi[e]) - int(lo[e])
    s, r = divmod(int(t), inner)
    # full leading planes: interior dim-d coords in [lo, lo+s)
    lead = max(0, min(int(lo[d]) + s, int(dims[d]) - 1) - max(int(lo[d]), 1))
    full_inner = 1
    for e in range(d + 1, len(dims)):
        full_inner *= max(
            0, min(int(hi[e]), int(dims[e]) - 1) - max(int(lo[e]), 1)
        )
    cnt = lead * full_inner
    if r and 1 <= int(lo[d]) + s <= int(dims[d]) - 2:
        cnt += _interior_prefix(dims, lo, hi, r, d + 1)
    return cnt


def _range_nnz(dims, lo, hi, row0, row1):
    """Exact nonzero count of box rows [row0, row1): interior grid cells
    emit 2*dim+1 entries, boundary (identity) cells 1 — the closed form
    `parallel_emit.slab_nnz` uses for whole dim-0 slabs, generalized to
    an arbitrary row range via an interior-cell prefix count."""
    dim = len(dims)
    return (row1 - row0) + 2 * dim * (
        _interior_prefix(dims, lo, hi, row1, 0)
        - _interior_prefix(dims, lo, hi, row0, 0)
    )


def stencil_emit_range(
    dims, lo, hi, center, arm_vals, ghost_gids, dtype, row0, row1,
    indptr_out, cols_out, vals_out, b_out=None, decouple=False, xtab=None,
):
    """Row-range form of `stencil_emit`: emit rows
    [row0, row1) of the box DIRECTLY into caller-provided buffers —
    `indptr_out` (row1-row0+1 int32, written relative: [0]=0), `cols_out`
    / `vals_out` (at least the range's nnz), `b_out` (row1-row0, only
    read when `xtab` is given). Column ids stay in the FULL part's
    numbering, so K workers over disjoint ranges fill disjoint slices of
    the one-shot emission's arrays byte-identically. Returns the range's
    nnz, or None when the native layer is absent/ineligible.

    Buffer geometry is validated against the closed-form range nnz
    BEFORE the C++ kernel runs: an undersized caller buffer is a Python
    `ValueError` here, never a native out-of-bounds write."""
    lib = _load()
    dim = len(dims)
    dt = np.dtype(dtype).name
    if lib is None or dim > 3 or dt not in _FLOAT_FN:
        return None
    row0, row1 = int(row0), int(row1)
    no = 1
    for l, h in zip(lo, hi):
        no *= int(h - l)
    if not (0 <= row0 <= row1 <= no):
        raise ValueError(
            f"stencil_emit_range: row range [{row0}, {row1}) outside the "
            f"box's {no} rows"
        )
    if len(indptr_out) != row1 - row0 + 1:
        raise ValueError(
            f"stencil_emit_range: indptr_out has {len(indptr_out)} "
            f"entries, range [{row0}, {row1}) needs {row1 - row0 + 1}"
        )
    need = _range_nnz(dims, lo, hi, row0, row1)
    if len(cols_out) < need or len(vals_out) < need:
        raise ValueError(
            f"stencil_emit_range: cols_out/vals_out hold "
            f"{len(cols_out)}/{len(vals_out)} entries, rows "
            f"[{row0}, {row1}) emit {need} nonzeros"
        )
    with_b = xtab is not None
    if with_b and (b_out is None or len(b_out) < row1 - row0):
        raise ValueError(
            f"stencil_emit_range: b_out holds "
            f"{0 if b_out is None else len(b_out)} entries, "
            f"range [{row0}, {row1}) needs {row1 - row0}"
        )
    if with_b:
        xt = np.ascontiguousarray(xtab, dtype=np.float64)
        if len(xt) != int(np.sum(dims)):
            raise ValueError(
                "stencil_emit_range: xtab must hold one entry per global "
                "coordinate"
            )
    else:
        xt = np.zeros(1, dtype=np.float64)
        b_out = np.empty(1, dtype=dtype)
    gg = np.ascontiguousarray(ghost_gids, dtype=np.int64)
    fn = getattr(lib, f"pa_stencil_emit_range_{_FLOAT_FN[dt]}")
    w = fn(
        np.asarray(dims, dtype=np.int64),
        np.asarray(lo, dtype=np.int64),
        np.asarray(hi, dtype=np.int64),
        dim,
        float(center),
        np.ascontiguousarray(arm_vals, dtype=np.float64),
        gg,
        len(gg),
        1 if decouple else 0,
        indptr_out,
        cols_out,
        vals_out,
        xt,
        b_out,
        1 if with_b else 0,
        int(row0),
        int(row1),
    )
    return None if w < 0 else int(w)


def band_offsets(indptr, cols, m: int, K: int, col_limit: int = 2**31):
    """Sorted distinct band offsets (j - i) of a column-sorted CSR,
    capped at K. Returns ``(offsets, ok)``: ok=False means MORE than K
    distinct offsets exist (offsets=None, scan stopped early).
    ``col_limit`` skips columns >= it (the sorted ghost tail of a
    FULL-row CSR — the no-split lowering analyzes A_oo without ever
    materializing it). Falls back to the NumPy unique (full result, ok
    judged by length) when the native layer is absent."""
    lib = _load()
    if lib is None or len(cols) >= 2**31:
        ip = np.asarray(indptr)
        r = np.repeat(
            np.arange(m, dtype=np.int64), np.diff(ip[: m + 1])
        )
        c = np.asarray(cols, dtype=np.int64)
        keep = c < col_limit
        u = np.unique(c[keep] - r[keep])
        return (u, True) if len(u) <= K else (None, False)
    out = np.empty(K, dtype=np.int64)
    cnt = lib.pa_band_offsets(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        m,
        K,
        out,
        col_limit,
    )
    if cnt < 0:
        return None, False
    return out[:cnt].copy(), True


def count_ge(cols, thr: int):
    """Number of entries with column >= thr (no bool temporary), or None
    when the native layer is absent."""
    lib = _load()
    if lib is None or len(cols) >= 2**31:
        return None
    return int(
        lib.pa_count_ge(
            np.ascontiguousarray(cols, dtype=np.int32), len(cols), thr
        )
    )


def csr_extract_hi(indptr, cols, vals, m: int, thr: int):
    """The (cols >= thr) side of a full-row CSR as its own CSR (columns
    remapped by -thr) WITHOUT materializing the lo side — the A_oh
    boundary block is surface-sized while the split's lo half would be a
    second full copy of the operator. Returns (ip, cols, vals) or None
    when the native layer is absent / dtype out of envelope."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    if lib is None or dt not in _FLOAT_FN or len(cols) >= 2**31:
        return None
    n_hi = count_ge(cols, thr)
    if n_hi is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int32)
    c = np.ascontiguousarray(cols, dtype=np.int32)
    v = np.ascontiguousarray(vals)
    ip_hi = np.empty(m + 1, dtype=np.int32)
    c_hi = np.empty(n_hi, dtype=np.int32)
    v_hi = np.empty(n_hi, dtype=v.dtype)
    fn = getattr(lib, f"pa_csr_extract_hi_{_FLOAT_FN[dt]}")
    fn(ip, c, v, m, thr, ip_hi, c_hi, v_hi)
    return ip_hi, c_hi, v_hi


def dia_classify(
    indptr, cols, vals, m: int, offsets, K: int, col_limit: int = 2**31
):
    """Row classes (distinct per-row diagonal-value tuples, absent
    diagonals 0) of a banded CSR in one fused pass — the dense-DIA-free
    form of `dia_fill` + `row_classes` (planning.cpp:dia_classify_impl,
    identical classes in identical first-touch order). Returns
    ``(class_table, codes, ok)``; ok=False when the native layer is
    absent, a (K+1)-th class appears, or an entry's offset is missing
    from `offsets` — callers then run the dense-DIA path. ``col_limit``
    skips the sorted ghost tail of full-row CSRs (see band_offsets)."""
    lib = _load()
    dt = np.dtype(np.asarray(vals).dtype).name
    D = len(offsets)
    if lib is None or dt not in _FLOAT_FN or D > 64 or len(cols) >= 2**31:
        return None, None, False
    table = np.empty((K, D), dtype=np.float64)
    codes = np.empty(max(m, 1), dtype=np.uint8)
    fn = getattr(lib, f"pa_dia_classify_{_FLOAT_FN[dt]}")
    cnt = fn(
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals),
        m,
        np.ascontiguousarray(offsets, dtype=np.int64),
        D,
        K,
        table,
        codes,
        col_limit,
    )
    if cnt < 0:
        return None, None, False
    return table[:cnt].copy(), codes[:m], True


def unique_small(vals: np.ndarray, K: int):
    """Sorted distinct values of a 1-D float64 array, capped at K.

    Returns ``(values, ok)``: ok=True with the sorted distinct values
    when there are at most K of them; ok=False when there are more (the
    native path then returns values=None, having stopped scanning early;
    the NumPy fallback returns the full oversized unique array). Callers
    must branch on ``ok``, not on values being None."""
    lib = _load()
    v = np.ascontiguousarray(vals, dtype=np.float64)
    if lib is None:
        u = np.unique(v)
        return u, len(u) <= K
    table = np.empty(K, dtype=np.float64)
    cnt = lib.pa_unique_small_f64(v, len(v), K, table)
    if cnt < 0:
        return None, False
    return np.sort(table[:cnt]), True


def ic0(indptr, cols, a_vals, n: int):
    """Zero-fill incomplete Cholesky of the LOWER triangle (diagonal
    last per row, column-sorted CSR). Returns ``(l_vals, fail_row)``:
    on success fail_row is -1; on a non-positive pivot at row i,
    ``(None, i)``. Pure-NumPy fallback when the native layer is absent
    (same algorithm, Python loops — fine at block scale)."""
    lib = _load()
    ip = np.ascontiguousarray(indptr, dtype=np.int32)
    cc = np.ascontiguousarray(cols, dtype=np.int32)
    av = np.ascontiguousarray(a_vals, dtype=np.float64)
    lv = np.empty_like(av)
    if lib is not None:
        rc = lib.pa_ic0_f64(ip, cc, av, n, lv)
        if rc < 0:
            return None, int(-rc - 1)
        return lv, -1
    for i in range(n):
        s_i, e_i = ip[i], ip[i + 1]
        if e_i == s_i or cc[e_i - 1] != i:
            return None, i
        for idx in range(s_i, e_i):
            j = cc[idx]
            s = av[idx]
            pi, pj = s_i, ip[j]
            ej = ip[j + 1]
            while pi < idx and pj < ej - 1:
                ci, cj = cc[pi], cc[pj]
                if ci == cj:
                    if ci >= j:
                        break
                    s -= lv[pi] * lv[pj]
                    pi += 1
                    pj += 1
                elif ci < cj:
                    pi += 1
                else:
                    pj += 1
            if j < i:
                lv[idx] = s / lv[ej - 1]
            else:
                if s <= 0.0:
                    return None, i
                lv[idx] = np.sqrt(s)
    return lv, -1


def row_classes(dia: np.ndarray, n: int, K: int):
    """Row classes (distinct column tuples) of dia[:, :n], a (D, stride)
    float64 array, capped at K classes.

    Returns ``(class_table, codes, ok)``: ok=True with the (cnt, D)
    class table and per-row uint8 class ids when there are at most K
    classes, else ``(None, None, False)``. Native path: first-touch
    class order, early exit on overflow. NumPy fallback: lexicographic
    class order — either order selects identical values downstream."""
    lib = _load()
    if lib is None:
        u, inv = np.unique(dia[:, :n].T, axis=0, return_inverse=True)
        if len(u) > K:
            return None, None, False
        return u, inv.astype(np.uint8), True
    d = np.ascontiguousarray(dia, dtype=np.float64)
    D, stride = d.shape
    table = np.empty((K, D), dtype=np.float64)
    codes = np.empty(n, dtype=np.uint8)
    cnt = lib.pa_row_classes_f64(d, D, n, stride, K, table, codes)
    if cnt < 0:
        return None, None, False
    return table[:cnt].copy(), codes, True
