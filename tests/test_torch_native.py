"""The port's native planning layer (`partitionedarrays_jl_tpu_torch/native/`)
against the JAX package's, on the CPU.

* The build: the library lies under ``build/pa_torch_planning/``, is named
  by the hash of the port's own `planning.cpp` and flags, and a broken
  compiler raises (no NumPy fallback behind the caller's back).
* Every wrapper, on seeded numpy inputs, bit for bit (``tobytes``) the JAX
  package's native function of the same name, and against the port's plain
  (NumPy) version where it has one (`tests/test_native.py`'s cases); `ic0`
  to rtol 1e-14 against its plain version, as test_native.py:162 holds it.
* `stencil_emit` on 3-D, 2-D and 1-D boxes, f32 and f64, decoupled or not,
  with b, and its row-range form; `parallel_emit` with K = 2 byte for byte
  the serial emission (tests/test_multiproc_planning.py:50), its workers
  without torch.
* `galerkin_cartesian`'s levels against the JAX package's `gmg_hierarchy`
  (tests/test_gmg.py:474 and :518's cases), per-part CSR bytes.
* The COO-free assembly against the port's COO route in global id space
  (tests/test_fdm.py:86's five grids, decoupled on and off), and the
  lookups of both index routes (`gids_to_lids` with the layer off).
"""
import os
import stat
from pathlib import Path

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import native as jnative
from partitionedarrays_jl_tpu_torch import native
from partitionedarrays_jl_tpu_torch.ops.sparse import compresscoo, csr_block
import importlib

gpu = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")  # the module (`parallel.gpu` is the backend)

REPO = Path(__file__).resolve().parents[1]


def _bits(x):
    """A value's type and bytes, recursively through tuples."""
    if isinstance(x, (tuple, list)):
        return tuple(_bits(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.dtype.str, x.shape, np.ascontiguousarray(x).tobytes()
    return type(x).__name__, x


def _same(a, b):
    assert _bits(a) == _bits(b)


@pytest.fixture
def plain(monkeypatch):
    """The port with its native layer off (the plain NumPy versions)."""
    def off():
        monkeypatch.setattr(native, "ENABLED", False)

    return off


def _csr(seed, m=60, n=50, nnz=900, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = compresscoo(rng.integers(0, m, nnz), rng.integers(0, n, nnz), rng.standard_normal(nnz).astype(dtype), m, n)
    return A


def _banded(seed, m=400, offsets=(-20, -1, 0, 1, 20), dtype=np.float64):
    """A banded CSR whose rows fall into few classes (a stencil's): row i's
    value on each diagonal is its class's, the class one of four."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, m)
    table = rng.choice([1.0, -1.0, 0.5, 4.0, 0.0], size=(4, len(offsets)))
    I, J, V = [], [], []
    for d, o in enumerate(offsets):
        i = np.arange(max(0, -o), min(m, m - o))
        I.append(i)
        J.append(i + o)
        V.append(table[cls[i], d])
    return compresscoo(np.concatenate(I), np.concatenate(J), np.concatenate(V).astype(dtype), m, m)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_library_is_built_from_the_ports_own_source():
    assert native.available()
    so = native.LIBRARY
    assert so == native.library_path() and so.exists()
    assert so.parent == REPO / "build" / "pa_torch_planning"
    assert native.SOURCE == REPO / "partitionedarrays_jl_tpu_torch" / "native" / "planning.cpp"
    assert "-ffp-contract=off" in native.CXX_FLAGS
    jsrc = REPO / "partitionedarrays_jl_tpu" / "native" / "planning.cpp"
    assert native.SOURCE.resolve() != jsrc.resolve()
    maps = Path("/proc/self/maps").read_text() if Path("/proc/self/maps").exists() else str(so)
    assert str(so) in maps


def _broken_compiler(tmp_path):
    cc = tmp_path / "broken-cxx"
    cc.write_text("#!/bin/sh\necho 'broken compiler: refusing' >&2\nexit 3\n")
    cc.chmod(cc.stat().st_mode | stat.S_IXUSR)
    return str(cc)


def test_a_broken_compiler_raises(tmp_path, monkeypatch):
    cc = _broken_compiler(tmp_path)
    with pytest.raises(RuntimeError, match="broken compiler: refusing"):
        native.build(cxx=cc, build_dir=tmp_path / "b")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build(cxx=str(tmp_path / "no-such-compiler"), build_dir=tmp_path / "c")
    assert not list((tmp_path / "b").glob("*.so"))
    # a wrapper's first use builds, and a failed build raises there too
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", cc)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "d")
    I = np.array([0, 1], dtype=np.int32)
    with pytest.raises(RuntimeError, match="native planning build failed"):
        native.coo_to_csr(I, I, np.ones(2), 2, 2)


def test_every_extern_entry_is_bound():
    src = native.SOURCE.read_text()
    import re

    names = set(re.findall(r"^(?:void|int64_t)\s+(pa_\w+)\(", src, flags=re.M))
    jnames = set(re.findall(r"^(?:void|int64_t)\s+(pa_\w+)\(",
                            (REPO / "partitionedarrays_jl_tpu" / "native" / "planning.cpp").read_text(), flags=re.M))
    assert names == jnames and len(names) == 37
    lib = native._load()
    for name in sorted(names):
        assert getattr(lib, name).argtypes is not None, name


# ---------------------------------------------------------------------------
# the wrappers against the JAX package's and the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("idt", [np.int64, np.int32])
def test_box_gids_to_lids(idt):
    rng = np.random.default_rng(0)
    grid, lo, hi = (13, 9, 17), (3, 0, 5), (11, 4, 16)
    gids = rng.integers(-5, 13 * 9 * 17 + 5, size=4000).astype(idt)
    out, jout = np.full(len(gids), -1, np.int32), np.full(len(gids), -1, np.int32)
    assert native.box_gids_to_lids(gids, grid, lo, hi, out)
    assert jnative.box_gids_to_lids(gids, grid, lo, hi, jout)
    _same(out, jout)
    g = gids.astype(np.int64)
    coords = np.unravel_index(np.clip(g, 0, 13 * 9 * 17 - 1), grid)
    owned = (g >= 0) & (g < 13 * 9 * 17)
    for c, l, h in zip(coords, lo, hi):
        owned &= (c >= l) & (c < h)
    want = np.full(len(g), -1, np.int32)
    want[owned] = np.ravel_multi_index([c[owned] - l for c, l in zip(coords, lo)], tuple(h - l for l, h in zip(lo, hi)))
    _same(out, want)


@pytest.mark.parametrize("idt", [np.int64, np.int32])
def test_lookup_sorted(idt):
    rng = np.random.default_rng(1)
    sg = np.unique(rng.integers(0, 10**6, 500)).astype(np.int64)
    lid_of = rng.permutation(len(sg)).astype(np.int32) + 100
    gids = np.concatenate([rng.choice(sg, 700), rng.integers(0, 10**6, 300)]).astype(idt)
    out, jout = np.full(len(gids), -1, np.int32), np.full(len(gids), -1, np.int32)
    out[:5] = jout[:5] = 7  # set entries are kept
    assert native.lookup_sorted(gids, sg, lid_of, out)
    assert jnative.lookup_sorted(gids, sg, lid_of, jout)
    _same(out, jout)
    pos = np.clip(np.searchsorted(sg, gids[5:]), 0, len(sg) - 1)
    hit = sg[pos] == gids[5:]
    want = np.full(len(gids) - 5, -1, np.int32)
    want[hit] = lid_of[pos[hit]]
    _same(out[5:], want)


@pytest.mark.parametrize("grid", [(2, 2), (1, 1)])
def test_cartesian_lookup_with_and_without_the_layer(plain, grid):
    def run():
        def driver(parts):
            rows = pt.cartesian_partition(parts, (7, 6), pt.with_ghost)
            return rows.partition.get_part(0 if grid == (1, 1) else 2).gids_to_lids(np.arange(-2, 44)).copy()

        return pt.prun(driver, pt.sequential, grid)

    on = run()
    jon = pa.prun(lambda parts: pa.cartesian_partition(parts, (7, 6), pa.with_ghost).partition.get_part(
        0 if grid == (1, 1) else 2).gids_to_lids(np.arange(-2, 44)).copy(), pa.sequential, grid)
    plain()
    _same(on, run())
    _same(on, jon)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("idt", [np.int64, np.int32])
def test_coo_to_csr(plain, idt, vdt):
    rng = np.random.default_rng(7)
    m, n, nnz = 50, 40, 3000  # heavy duplicates and one long row
    I = rng.integers(0, m, size=nnz).astype(idt)
    I[:200] = 7
    J = rng.integers(0, n, size=nnz).astype(idt)
    V = rng.standard_normal(nnz).astype(vdt)
    got, want = native.coo_to_csr(I, J, V, m, n), jnative.coo_to_csr(I, J, V, m, n)
    _same(got, want)
    A = compresscoo(I, J, V, m, n)
    plain()
    B = compresscoo(I, J, V, m, n)
    _same((A.indptr, A.indices, A.data), (B.indptr, B.indices, B.data))
    _same(got, (B.indptr, B.indices, B.data))


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
def test_csr_split_by_col(vdt):
    A = _csr(8, dtype=vdt)
    thr = 33
    got = native.csr_split_by_col(A.indptr, A.indices, A.data, A.shape[0], thr)
    _same(got, jnative.csr_split_by_col(A.indptr, A.indices, A.data, A.shape[0], thr))
    rows = np.arange(A.shape[0])
    lo = csr_block(A, rows, thr, want_upper=False)
    hi = csr_block(A, rows, thr, want_upper=True, col_offset=thr)
    _same(got, ((lo.indptr, lo.indices, lo.data), (hi.indptr, hi.indices, hi.data)))


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
def test_csr_spmv(vdt):
    A = _csr(9, dtype=vdt)
    x = np.random.default_rng(9).standard_normal(A.shape[1]).astype(vdt)
    y, jy = np.empty(A.shape[0], vdt), np.empty(A.shape[0], vdt)
    assert native.csr_spmv(A.indptr, A.indices, A.data, x, y)
    assert jnative.csr_spmv(A.indptr, A.indices, A.data, x, jy)
    _same(y, jy)
    # the plain version: each row folded left to right from 0
    want = np.zeros(A.shape[0], vdt)
    for r in range(A.shape[0]):
        acc = vdt(0)
        for k in range(A.indptr[r], A.indptr[r + 1]):
            acc = vdt(acc + A.data[k] * x[A.indices[k]])
        want[r] = acc
    _same(y, want)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
def test_strict_host_product_is_the_padded_fold(plain, vdt):
    """`csr_spmv(strict=True)` through the native fold equals the ELL
    fold it stands for, -0.0 rows, empty rows and a NaN at x[0] included."""
    from partitionedarrays_jl_tpu_torch.ops.sparse import CSRMatrix, csr_spmv

    A = _csr(10, dtype=vdt)
    data = A.data.copy()
    data[A.indptr[3]:A.indptr[4]] = -1.0  # row 3: -1 * +0.0 terms only
    ip = A.indptr.copy()
    ip[6:] -= ip[6] - ip[5]  # row 5 empty
    cols = np.concatenate([A.indices[: A.indptr[5]], A.indices[A.indptr[6]:]])
    data = np.concatenate([data[: A.indptr[5]], data[A.indptr[6]:]])
    B = CSRMatrix(ip, cols, data, A.shape)
    x = np.random.default_rng(10).standard_normal(A.shape[1]).astype(vdt)
    x[B.indices[B.indptr[3]:B.indptr[4]]] = 0.0
    for xx in (x, np.where(np.arange(len(x)) == 0, np.nan, x).astype(vdt)):
        got = csr_spmv(B, xx, strict=True)
        plain()
        want = csr_spmv(CSRMatrix(B.indptr, B.indices, B.data, B.shape), xx, strict=True)
        native.ENABLED = True
        _same(got, want)


def test_dia_fill_band_offsets_and_classes(plain):
    A = _banded(11)
    m = A.shape[0]
    u, ok = native.band_offsets(A.indptr, A.indices, m, 64)
    ju, jok = jnative.band_offsets(A.indptr, A.indices, m, 64)
    _same((u, ok), (ju, jok))
    pu, pok = gpu.band_offsets(A.indptr, A.indices, m, 64)
    assert ok and pok and np.array_equal(u, pu)
    _same(native.band_offsets(A.indptr, A.indices, m, 3), (None, False))
    # a column limit skips the columns at and past it
    lim = native.band_offsets(A.indptr, A.indices, m, 64, col_limit=300)
    _same(lim, jnative.band_offsets(A.indptr, A.indices, m, 64, col_limit=300))
    # dense diagonals: the native fill against the plain scatter
    dia, jdia = np.zeros((len(u), m + 3)), np.zeros((len(u), m + 3))
    assert native.dia_fill(A.indptr, A.indices, A.data, m, u, dia)
    assert jnative.dia_fill(A.indptr, A.indices, A.data, m, u, jdia)
    _same(dia, jdia)
    want = np.zeros_like(dia)
    r = A.row_of_nz()
    want[np.searchsorted(u, A.indices.astype(np.int64) - r), r] = A.data
    _same(dia, want)
    with pytest.raises(ValueError):
        native.dia_fill(A.indptr, A.indices, A.data, m, u[1:], np.zeros((len(u) - 1, m)))
    # distinct values and row classes
    _same(native.unique_small(dia[1, :m], 8), jnative.unique_small(dia[1, :m], 8))
    assert np.array_equal(native.unique_small(dia[1, :m], 8)[0], gpu.unique_small(dia[1, :m], 8)[0])
    cls = native.row_classes(dia, m, 64)
    _same(cls, jnative.row_classes(dia, m, 64))
    pcls = gpu.row_classes(dia, m, 64)
    assert cls[2] and pcls[2]
    _same(cls[0][cls[1]], pcls[0][pcls[1]])  # first-touch vs lexicographic order: the same rows
    # the fused class analysis: the classes of dia_fill + row_classes
    fused = native.dia_classify(A.indptr, A.indices, A.data, m, u, 64)
    _same(fused, jnative.dia_classify(A.indptr, A.indices, A.data, m, u, 64))
    _same(fused[:2], cls[:2])
    _same(native.dia_classify(A.indptr, A.indices, A.data, m, u, 64, col_limit=300),
          jnative.dia_classify(A.indptr, A.indices, A.data, m, u, 64, col_limit=300))
    # with the layer off the wrappers answer as absent
    plain()
    assert native.dia_classify(A.indptr, A.indices, A.data, m, u, 64) == (None, None, False)
    assert native.dia_fill(A.indptr, A.indices, A.data, m, u, np.zeros_like(dia)) is False
    _same(native.unique_small(dia[1, :m], 8), (np.unique(dia[1, :m]), True))


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
def test_csr_diag_count_ge_and_extract_hi(vdt):
    A = _csr(12, dtype=vdt)
    m = A.shape[0]
    d = native.csr_diag(A.indptr, A.indices, A.data, m)
    _same(d, jnative.csr_diag(A.indptr, A.indices, A.data, m))
    want = np.zeros(m, vdt)
    r = A.row_of_nz()
    hit = A.indices == r
    want[r[hit]] = A.data[hit]
    _same(d, want)
    assert native.count_ge(A.indices, 30) == jnative.count_ge(A.indices, 30) == int((A.indices >= 30).sum())
    hi = native.csr_extract_hi(A.indptr, A.indices, A.data, m, 30)
    _same(hi, jnative.csr_extract_hi(A.indptr, A.indices, A.data, m, 30))
    blk = csr_block(A, np.arange(m), 30, want_upper=True, col_offset=30)
    _same(hi, (blk.indptr, blk.indices, blk.data))


def test_ic0(plain):
    """IC(0): bits against the JAX package's native factor, rtol 1e-14
    against the plain version (test_native.py:162), and the breakdown row."""
    import scipy.sparse as sp

    from partitionedarrays_jl_tpu_torch.models.solvers import ic0_lower

    n = 64
    rng = np.random.default_rng(7)
    A = sp.diags([-np.ones(n - 1), 2.0 + rng.random(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    low = sp.tril(A).tocsr()
    low.sort_indices()
    got = native.ic0(low.indptr, low.indices, low.data, n)
    _same(got, jnative.ic0(low.indptr, low.indices, low.data, n))
    _same(ic0_lower(low.indptr, low.indices, low.data, n), got)
    bad = sp.diags([np.where(np.arange(n) == 5, -1.0, 1.0)], [0]).tocsr()
    assert native.ic0(bad.indptr, bad.indices, bad.data, n) == (None, 5)
    plain()
    lv, fail = ic0_lower(low.indptr, low.indices, low.data, n)
    assert fail == -1
    np.testing.assert_allclose(got[0], lv, rtol=1e-14)
    assert ic0_lower(bad.indptr, bad.indices, bad.data, n) == (None, 5)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
def test_galerkin_kernels(vdt):
    """galerkin3 (full and row-subset), galerkin_classify and galerkin_emit
    on one part of the decoupled Poisson operator, against the JAX
    package's."""
    ns = (11, 10, 9)
    ncs = tuple((n + 1) // 2 for n in ns)

    def driver(parts):
        A = pt.assemble_poisson(parts, ns, dtype=vdt, decoupled=True)[0]
        return A.rows.partition.part_values()[0], A.cols.partition.part_values()[0], A.values.part_values()[0]

    ri, ci, M = pt.prun(driver, pt.sequential, (2, 1, 1))
    flo, fhi = ri.box_lo, ri.box_hi
    elo = [max(0, (flo[d] - 1) // 2) for d in range(3)]
    ehi = [min(ncs[d], fhi[d] // 2 + 1) for d in range(3)]
    args = (M.indptr, M.indices, M.data, ri.num_oids, np.asarray(ci.lid_to_gid, np.int64), ns, flo, fhi, ncs, elo, ehi)
    acc = native.galerkin3(*args)
    _same(acc, jnative.galerkin3(*args))
    sub = [np.arange(flo[d], fhi[d], 2) for d in range(3)]
    _same(native.galerkin3(*args, sub_coords=sub), jnative.galerkin3(*args, sub_coords=sub))
    gg = np.asarray(ci.lid_to_gid[ri.num_oids:], np.int64)
    rel = np.stack([c - l for c, l in zip(np.unravel_index(gg, ns), flo)], axis=1)
    cargs = (M.indptr, M.indices, M.data, ri.num_oids, [h - l for l, h in zip(flo, fhi)], rel, 64)
    cl = native.galerkin_classify(*cargs)
    assert cl[2]
    _same(cl, jnative.galerkin_classify(*cargs))
    # emission over an owned coarse box inside the extended box, its
    # column ghosts the shell one point around it (sorted)
    clo, chi = list(elo), [elo[0] + 2] + list(ehi[1:])
    xlo = [max(0, c - 1) for c in clo]
    xhi = [min(n, c + 1) for c, n in zip(chi, ncs)]
    box = np.zeros(tuple(h - l for l, h in zip(xlo, xhi)), bool)
    box[tuple(slice(a - l, b - l) for a, b, l in zip(clo, chi, xlo))] = True
    ghost = np.sort(np.ravel_multi_index(tuple(c + l for c, l in zip(np.nonzero(~box), xlo)), ncs))
    eargs = (acc, ncs, elo, ehi, clo, chi, ghost, vdt)
    em = native.galerkin_emit(*eargs)
    assert em is not None
    _same(em, jnative.galerkin_emit(*eargs))


def _xtab(ns):
    return np.concatenate([np.sin(0.5 + (d + 1.0) * np.arange(n) / (n + 1.0)) for d, n in enumerate(ns)])


_BOXES = {
    "3d": ((20, 18, 16), (3, 0, 2), (17, 9, 16)),
    "2d": ((13, 11), (0, 4), (7, 11)),
    "1d": ((30,), (8,), (22,)),
}


@pytest.mark.parametrize("decouple", [False, True], ids=["plain", "decoupled"])
@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("box", sorted(_BOXES))
def test_stencil_emit(box, vdt, decouple):
    from partitionedarrays_jl_tpu_torch.models.poisson_fdm import stencil_ghost_slabs

    ns, lo, hi = _BOXES[box]
    dim = len(ns)
    arms = np.array([-1.0 - 0.25 * k for k in range(2 * dim)])
    gg = stencil_ghost_slabs(lo, hi, ns)
    center = 2.0 * dim + 0.5
    for xtab in (None, _xtab(ns)):
        got = native.stencil_emit(ns, lo, hi, center, arms, gg, vdt, decouple=decouple, xtab=xtab)
        _same(got, jnative.stencil_emit(ns, lo, hi, center, arms, gg, vdt, decouple=decouple, xtab=xtab))
    # the row-range form fills the one-shot emission's slices
    indptr, cols, vals, b = got
    no = len(indptr) - 1
    r0, r1 = no // 3, no - 5
    ip = np.empty(r1 - r0 + 1, np.int32)
    c = np.empty(len(cols), np.int32)
    v = np.empty(len(cols), vdt)
    bo = np.empty(r1 - r0, vdt)
    w = native.stencil_emit_range(ns, lo, hi, center, arms, gg, vdt, r0, r1, ip, c, v, b_out=bo,
                                  decouple=decouple, xtab=_xtab(ns))
    assert w == indptr[r1] - indptr[r0]
    _same((ip + indptr[r0], c[:w], v[:w], bo), (indptr[r0:r1 + 1], cols[indptr[r0]:indptr[r1]],
                                                vals[indptr[r0]:indptr[r1]], b[r0:r1]))
    with pytest.raises(ValueError):
        native.stencil_emit_range(ns, lo, hi, center, arms, gg, vdt, r0, r1, ip, c[: w - 1], v, decouple=decouple)


def test_parallel_emit_byte_identical():
    """K = 2 spawned workers over row slabs write the serial emission's CSR
    and b byte for byte (tests/test_multiproc_planning.py:50), and their
    import path leaves torch unloaded."""
    from partitionedarrays_jl_tpu_torch.models.poisson_fdm import stencil_ghost_slabs
    from partitionedarrays_jl_tpu_torch.native import parallel_emit

    ns, lo, hi = _BOXES["3d"]
    arms = np.array([-1.0] * 6)
    gg = stencil_ghost_slabs(lo, hi, ns)
    ser = native.stencil_emit(ns, lo, hi, 6.0, arms, gg, np.float64, decouple=True, xtab=_xtab(ns))
    par = parallel_emit.stencil_emit_parallel(ns, lo, hi, 6.0, arms, gg, np.float64, 2, decouple=True, xtab=_xtab(ns))
    _same(par, ser)
    assert parallel_emit._pool(2).map(parallel_emit._worker_imports, [0, 1]) == [False, False]


def test_plan_procs_assembles_the_same_system(monkeypatch):
    def run():
        return pt.prun(lambda parts: [_bits((M.indptr, M.indices, M.data)) for M in
                                      pt.assemble_poisson(parts, (12, 11, 10))[0].values.part_values()],
                       pt.sequential, (2, 1, 1))

    serial = run()
    monkeypatch.setattr(native, "PLAN_PROCS", 2)
    assert run() == serial


# ---------------------------------------------------------------------------
# the call sites: the hierarchy and the COO-free assembly
# ---------------------------------------------------------------------------


def _levels(m, ns, grid, dtype, thr, cycle_parts=None):
    def driver(parts):
        A = m.assemble_poisson(parts, ns, dtype=dtype, decoupled=True)[0]
        h = m.gmg_hierarchy(parts, A, ns, coarse_threshold=thr)
        return [[_bits((M.indptr, M.indices, M.data)) for M in L.values.part_values()]
                + [_bits(np.asarray(i.lid_to_gid)) for i in L.cols.partition.part_values()]
                for L in [lvl.A for lvl in h.levels] + [h.coarse_A]]

    return m.prun(driver, m.sequential, grid)


@pytest.mark.parametrize("ns,grid,dtype", [((7, 6, 9), (2, 2, 2), np.float64), ((7, 6, 9), (3, 1, 2), np.float64),
                                           ((40, 38, 36), (1, 1, 1), np.float32), ((37, 41, 39), (2, 2, 1), np.float32),
                                           ((48, 50), (2, 2), np.float32)],
                         ids=["7x6x9/2^3", "7x6x9/3x1x2", "40x38x36/1", "37x41x39/2x2x1", "48x50/2x2"])
def test_galerkin_levels_match_the_jax_hierarchy(ns, grid, dtype):
    """test_gmg.py:474 and :518's cases: every level's operator and column
    partition bit for bit the JAX package's `gmg_hierarchy`."""
    assert _levels(pt, ns, grid, dtype, 60) == _levels(pa, ns, grid, dtype, 60)


def test_classed_collapse_is_the_full_collapse(monkeypatch):
    """test_gmg.py:518: the classed collapse's levels are the full native
    collapse's bit for bit."""
    from partitionedarrays_jl_tpu_torch.models import gmg

    want = _levels(pt, (37, 41, 39), (2, 2, 1), np.float32, 60)
    monkeypatch.setattr(gmg, "_classed_collapse", lambda *a: None)
    assert _levels(pt, (37, 41, 39), (2, 2, 1), np.float32, 60) == want


def _triplets(A):
    out = []
    for (i, j, v) in pt.psparse_global_triplets(A).part_values():
        o = np.lexsort((j, i))
        out.append(_bits((np.asarray(i)[o].astype(np.int64), np.asarray(j)[o].astype(np.int64), v[o])))
    return out


@pytest.mark.parametrize("decoupled", [False, True], ids=["plain", "decoupled"])
@pytest.mark.parametrize("ns,grid", [((7, 6, 5), (2, 2, 1)), ((12, 13, 11), (2, 2, 2)), ((9, 8), (3, 2)),
                                     ((30,), (4,)), ((3, 3), (2, 1))])
def test_fast_route_matches_the_coo_route(monkeypatch, ns, grid, decoupled):
    """test_fdm.py:86: the COO-free system against the COO route's in global
    id space (the local layouts differ: sorted ghost slabs against first
    touch), b, x̂ and x0 on their owned values to 1e-12."""
    def run(fast):
        monkeypatch.setattr(native, "STENCIL_FAST", fast)

        def driver(parts):
            A, b, xe, x0 = pt.assemble_poisson(parts, ns, decoupled=decoupled)
            return _triplets(A), [pt.gather_pvector(v) for v in (b, xe, x0)], A.cols

        return pt.prun(driver, pt.sequential, grid)

    (t1, v1, c1), (t2, v2, c2) = run(True), run(False)
    assert t1 == t2
    for a, b in zip(v1, v2):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)
    # the fast route's ghosts are sorted by gid
    for iset in c1.partition.part_values():
        g = np.asarray(iset.lid_to_gid[iset.num_oids:])
        assert np.all(np.diff(g) > 0)


def test_dense_and_fused_analysis_stage_the_same_products():
    """The fused class analysis (``det["dia"]`` None) and the dense one give
    the same codebooks' values row by row."""
    def driver(parts, decoupled):
        A = pt.assemble_poisson(parts, (12, 10, 9), decoupled=decoupled)[0]
        oo = A.owned_owned_values.part_values()
        noids = np.array([i.num_oids for i in A.rows.partition.part_values()])
        f = gpu.DeviceMatrix._detect_dia(A, oo, len(oo), noids, int(noids.max()))
        with pytest.MonkeyPatch.context() as mp:  # the dense analysis
            mp.setattr(gpu.DeviceMatrix, "_analyze_dia_classes", classmethod(lambda *a, **k: None))
            d = gpu.DeviceMatrix._detect_dia(A, oo, len(oo), noids, int(noids.max()))
        assert f["dia"] is None and d["dia"] is not None
        for k in ("kk", "code_row", "offsets", "coded"):
            assert f[k] == d[k], k
        assert (f["cls_uniq"] is None) == (d["cls_uniq"] is None)
        for p in range(len(oo)):
            n = int(noids[p])
            _same(f["uniq"][p], d["uniq"][p])
            # every row's diagonal values, from the class tables
            _same(f["cls_tables"][p][f["cls_codes"][p, :n]].T, d["dia"][p][:, :n])
            if f["cls_uniq"] is not None:
                _same(f["cls_uniq"][p][f["cls_ids"][p, :n]], d["cls_uniq"][p][d["cls_ids"][p, :n]])
        return f["cls_uniq"] is not None

    # one part: two row classes (interior, identity), the class mode;
    # eight parts: the face rows add classes past CODE_MAX_VALUES
    assert pt.prun(driver, pt.sequential, (1, 1, 1), False)
    assert not pt.prun(driver, pt.sequential, (2, 2, 2), False)
    assert not pt.prun(driver, pt.sequential, (2, 2, 2), True)
