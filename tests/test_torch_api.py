"""The reference's host API in the port (`parallel/pvector.py`,
`exchanger.py`, `collectives.py`, `backends.py`, `psparse.py`,
`index_sets.py`, `prange.py`, `ptimers.py`, `ops/sparse.py`, `utils/`)
against the JAX package's.

Each scenario mirrors a test of the JAX package's own suite
(tests/test_pvector.py, test_collectives.py, test_backends.py,
test_psparse.py, test_index_sets.py, test_prange.py, test_sparse_ops.py,
test_table.py, test_aux.py) and is written once against a package
namespace: it runs on the JAX package's sequential backend and on the
port's sequential backend and ``GPUBackend(device="cpu")`` (whose planning
values are host objects too), and returns plain values. Both sides do the
same host arithmetic in the same order, so the comparison is exact: equal
values, equal dtypes, equal raised error types.
"""
import importlib
import operator

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend

CPU = GPUBackend(device="cpu")
PORT_BACKENDS = {"seq": pt.sequential, "gpu_cpu": CPU}


def _sub(m, name):
    return importlib.import_module(f"{m.__name__}.{name}")


def _plain(x):
    """Nested plain form: arrays keep their dtype name beside the values."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if hasattr(x, "ptrs") and hasattr(x, "data"):  # a Table of either package
        return ("table", _plain(np.asarray(x.data)), _plain(np.asarray(x.ptrs)))
    return x


def _raises(f, *args, **kw):
    try:
        f(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__
    return None


def _ghosted_rows(m, parts):
    """4 parts of 3 owned gids, each ghosting the next part's first gid
    (tests/test_pvector.py:ghosted_rows)."""
    noids = m.map_parts(lambda p: 3, parts)
    hid_gid = m.map_parts(lambda p: np.array([(3 * (p + 1)) % 12]), parts)
    hid_part = m.map_parts(lambda p: np.array([(p + 1) % 4]), parts)
    return _sub(m, "parallel.prange").variable_partition(parts, noids, hid_to_gid=hid_gid, hid_to_part=hid_part)


def _vals(v):
    return [np.asarray(x).copy() for x in v.values.part_values()]


def _gid_vector(m, rows, scale=1.0):
    return m.PVector(m.map_parts(lambda i: i.lid_to_gid.astype(float) * scale, rows.partition), rows)


# --- pvector.py ------------------------------------------------------------


def sc_pvector_constructors(m, parts):
    rows = _ghosted_rows(m, parts)
    v = m.PVector.full(2.5, rows)
    u = v.similar()
    w = m.PVector.undef(rows, dtype=np.float32)
    return {
        "len": len(v), "dtype": str(v.dtype),
        "owned": [len(x) for x in v.owned_values], "ghost": [len(x) for x in v.ghost_values],
        "similar": (u.rows is rows, str(u.dtype), [len(x) for x in u.values]),
        "undef": (str(w.dtype), [len(x) for x in w.values]),
        "sum": v.sum(),
    }


def sc_pvector_reductions(m, parts):
    rows = _ghosted_rows(m, parts)
    a = _gid_vector(m, rows)
    b = m.PVector.full(1.0, rows)
    return {
        "sum": a.sum(), "dot": a.dot(b), "norm": a.norm(), "norm1": a.norm(1),
        "max": a.maximum(), "min": a.minimum(), "max_f": a.maximum(lambda x: -x),
        "min_f": a.minimum(np.cos), "any": a.any(lambda x: x > 10.0), "all": a.all(lambda x: x > 0.0),
        "reduce_owned": a.reduce_owned(lambda v: float(np.prod(v + 1.0)), operator.mul, 1.0),
        "eq": (a == a.copy(), a == b),
    }


def sc_pvector_inplace(m, parts):
    rows = _ghosted_rows(m, parts)
    x = m.PVector.full(3.0, rows)
    y = _gid_vector(m, rows)
    out = {"axpy": _vals(y.axpy(2.0, x)), "scale": _vals(y.scale(0.5))}
    out["axpy_rows"] = _raises(y.axpy, 1.0, m.PVector.full(1.0, _ghosted_rows(m, parts)))
    out["fill"] = _vals(y.fill(-1.5))
    return out


def sc_pvector_copy_into(m, parts):
    rows = _sub(m, "parallel.prange").uniform_partition(parts, 8)
    ghosted = m.add_gids(rows, m.map_parts(lambda p: np.array([(2 * p + 2) % 8]), parts))
    src = _gid_vector(m, rows)
    dst = m.PVector.full(-1.0, ghosted)
    same = m.PVector.full(0.0, rows)
    return {"across": _vals(src.copy_into(dst)), "same": _vals(src.copy_into(same))}


def sc_pvector_exchange_assemble(m, parts):
    rows = _ghosted_rows(m, parts)
    v = m.PVector(
        m.map_parts(lambda i: np.where(i.lid_to_part == i.part, i.lid_to_gid.astype(float), -1.0), rows.partition),
        rows,
    )
    out = {"exchange": _vals(m.exchange_pvector(v))}
    w = _gid_vector(m, rows, 2.0)
    out["assemble"] = _vals(m.assemble(w))
    z = _gid_vector(m, rows, -1.0)
    t = m.async_assemble(z, np.maximum)
    out["async_pending"] = _vals(z)  # the unpack waits for the token
    t.wait()
    out["async_max"] = _vals(z)
    u = _gid_vector(m, rows, 3.0)
    out["method"] = _vals(u.assemble(np.add))
    return out


def sc_pvector_from_coo(m, parts):
    I = m.map_parts(lambda p: np.array([(2 * p + 2) % 8, 2 * p, 2 * p]), parts)
    V = m.map_parts(lambda p: np.array([float(p + 1), 0.5, 0.25]), parts)
    v = m.PVector.from_coo(I, V, 8, ids="global")
    before = _vals(v)
    v.assemble()
    return {"ghost": v.rows.ghost, "before": before, "after": _vals(v), "gathered": m.gather_pvector(v)}


def sc_global_view(m, parts):
    rows = _ghosted_rows(m, parts)
    v = m.PVector.full(0.0, rows)
    gv = m.global_view(v)

    def _write(view, iset):
        gids = iset.lid_to_gid[:2]
        view[gids] = [10.0, 20.0]
        view.add_at(gids[:1], [5.0])
        view.add_at(iset.lid_to_gid[-1:], [iset.part + 0.5])
        bad = np.array([(int(iset.lid_to_gid[0]) + 6) % 12])
        return (type(view).__name__, view[int(gids[0])], _raises(view.__getitem__, bad),
                _raises(view.__setitem__, bad, [1.0]))

    res = [_write(*a) for a in zip(gv.part_values(), rows.partition.part_values())]
    return {"views": res, "values": _vals(v)}


def sc_local_view(m, parts):
    rows = _sub(m, "parallel.prange").uniform_partition(parts, 8)
    ghosted = m.add_gids(rows, m.map_parts(lambda p: np.array([(2 * p + 2) % 8]), parts))
    v = _gid_vector(m, rows, 10.0)
    lv = m.local_view(v, ghosted)
    out = []
    for view, iset in zip(lv.part_values(), ghosted.partition.part_values()):
        hlid = int(iset.hid_to_lid[0])
        view[np.array([0])] = [7.0]
        view.add_at(np.array([1]), [0.5])
        out.append((type(view).__name__, len(view), view[np.arange(len(view))],
                    _raises(view.__setitem__, np.array([hlid]), [1.0])))
    return {"views": out, "values": _vals(v)}


def sc_distances(m, parts):
    rows = _sub(m, "parallel.prange").uniform_partition(parts, 12)
    a = _gid_vector(m, rows)
    b = m.PVector(m.map_parts(lambda i: np.cos(i.lid_to_gid.astype(float)), rows.partition), rows)
    return [m.sqeuclidean(a, b), m.euclidean(a, b), m.cityblock(a, b), m.chebyshev(a, b)] + [
        m.minkowski(a, b, p) for p in (1.0, 2.0, 3.5)
    ]


# --- exchanger.py ------------------------------------------------------------


def sc_exchanger(m, parts):
    rows = _ghosted_rows(m, parts)
    ex = rows.exchanger
    rcv = m.allocate_rcv_buffer(np.float32, ex)
    snd = m.allocate_snd_buffer(np.int64, ex)
    vals = m.map_parts(lambda i: np.where(i.lid_to_part == i.part, i.lid_to_gid * 1.5, 0.0), rows.partition)
    m.exchange_values(vals, ex)  # the two-argument in-place form
    dst = m.map_parts(lambda i: np.full(i.num_lids, -1.0), rows.partition)
    m.exchange_values(dst, vals, ex)
    acc = m.map_parts(lambda i: np.ones(i.num_lids), rows.partition)
    m.exchange_values(acc, acc, ex.reverse(), combine=np.add)
    e = m.empty_exchanger(parts)
    return {
        "rcv": list(rcv.part_values()), "snd": list(snd.part_values()),
        "inplace": list(vals.part_values()), "dst": list(dst.part_values()), "add": list(acc.part_values()),
        "empty": [list(e.parts_rcv.part_values()), list(e.lids_snd.part_values())],
    }


# --- collectives.py ----------------------------------------------------------

RCV = [[2, 3], [0], [1, 3], [0, 2]]
SND = [[1, 3], [2], [0, 3], [0, 2]]


def sc_collectives(m, parts):
    vals = m.map_parts(lambda p: 10 * (p + 1), parts)
    small = m.map_parts(lambda p: p + 1, parts)
    arrs = m.map_parts(lambda p: np.arange(3, dtype=np.int64) + p, parts)
    s, tot = m.iscan(operator.add, small, init=0, with_total=True)
    sa, tota = m.iscan_all(operator.add, small, init=0, with_total=True)
    parts_rcv = m.map_parts(lambda p: np.asarray(RCV[p], dtype=np.int32), parts)
    parts_snd = m.map_parts(lambda p: np.asarray(SND[p], dtype=np.int32), parts)
    data_snd = m.map_parts(lambda p, snd: np.full(len(snd), float(p + 1)), parts, parts_snd)
    data_rcv = m.map_parts(lambda rcv: np.zeros(len(rcv)), parts_rcv)
    out = m.exchange_into(data_rcv, data_snd, parts_rcv, parts_snd)
    bad_rcv = m.map_parts(lambda p: np.asarray([[1], [], [], []][p], dtype=np.int32), parts)
    bad_snd = m.map_parts(lambda p: np.asarray([[], [], [0], []][p], dtype=np.int32), parts)
    return {
        "gather_all": list(m.gather_all(vals).part_values()),
        "gather_all_vec": list(m.gather_all(arrs).part_values()),
        "reduce_all": list(m.reduce_all(operator.add, small, 0).part_values()),
        "sum_parts": m.sum_parts(small), "sum_parts_vec": m.sum_parts(arrs),
        "iscan": list(m.iscan(operator.add, small, init=5).part_values()),
        "iscan_total": (list(s.part_values()), tot),
        "iscan_main": list(m.iscan_main(operator.add, small, init=0).part_values()),
        "iscan_all": (list(sa.part_values()), tota),
        "exchange_into": (out is data_rcv, list(data_rcv.part_values())),
        "bad_graph": _raises(m.exchange_into, m.map_parts(lambda r: np.zeros(len(r)), bad_rcv),
                             m.map_parts(lambda s_: np.zeros(len(s_)), bad_snd), bad_rcv, bad_snd),
    }


# --- backends.py -------------------------------------------------------------


def sc_backends(m, parts):
    be = parts.backend
    got = m.prun_debug(lambda p: list(p.part_values()), be, parts.shape)
    main = m.map_main(lambda p: p + 42, parts)
    pairs = m.map_parts(lambda p: (p, 2 * p, str(p)), parts)
    a, b, c = m.unzip(pairs, 3)
    return {
        "prun_debug": got, "backend": m.get_backend(parts) is be, "map_main": list(main.part_values()),
        "unzip": [list(a.part_values()), list(b.part_values()), list(c.part_values())],
    }


# --- psparse.py --------------------------------------------------------------


def _ghost_row_matrix(m, parts):
    """tests/test_psparse.py:129: a matrix with ghost rows, each part
    storing (g, g) = 5 for its ghost row g and (o, o) = p + 1 for its
    first owned o, plus one coupling (o, o + 1)."""
    rows0 = _sub(m, "parallel.prange").uniform_partition(parts, 8)
    ghosts = m.map_parts(lambda p: np.array([(2 * p + 2) % 8]), parts)
    rows = m.add_gids(rows0, ghosts)
    cols = rows.copy()
    I = m.map_parts(lambda p: np.array([(2 * p + 2) % 8, 2 * p, 2 * p]), parts)
    J = m.map_parts(lambda p: np.array([(2 * p + 2) % 8, 2 * p, 2 * p + 1]), parts)
    V = m.map_parts(lambda p: np.array([5.0, float(p + 1), -0.5]), parts)
    return m.PSparseMatrix.from_coo(I, J, V, rows, cols, ids="global"), rows, cols


def sc_matrix_exchanger(m, parts):
    A, rows, cols = _ghost_row_matrix(m, parts)
    ex = m.matrix_exchanger(A.values, rows, cols)
    data = m.map_parts(lambda M: M.data.copy(), A.values)
    m.exchange_values(data, data, ex.reverse(), combine=np.add)  # ghost rows into owners
    assembled = list(data.part_values())
    m.exchange_values(data, ex)  # owners back out to the ghost copies
    return {
        "lids": [list(ex.lids_rcv.part_values()), list(ex.lids_snd.part_values())],
        "assembled": assembled, "halo": list(data.part_values()),
        "local_values": [(M.indptr, M.indices, M.data) for M in m.psparse_local_values(A).part_values()],
    }


def sc_exchange_coo(m, parts):
    rows0 = _sub(m, "parallel.prange").uniform_partition(parts, 8)
    rows = m.add_gids(rows0, m.map_parts(lambda p: np.array([(2 * p + 2) % 8]), parts))
    I = m.map_parts(lambda i: i.oid_to_gid.copy(), rows.partition)
    J = m.map_parts(lambda i: i.oid_to_gid.copy(), rows.partition)
    V = m.map_parts(lambda i: i.oid_to_gid.astype(float) + 1.0, rows.partition)
    I2, J2, V2 = m.exchange_coo(I, J, V, rows)
    return [list(x.part_values()) for x in (I2, J2, V2)]


def sc_owned_triplets(m, parts):
    A, _, _ = _ghost_row_matrix(m, parts)
    out = {"unassembled": _raises(lambda: list(m.psparse_owned_triplets(A).part_values()))}
    for M, iset in zip(A.values.part_values(), A.rows.partition.part_values()):
        for h in iset.hid_to_lid:
            M.data[M.indptr[h]: M.indptr[h + 1]] = 0.0
    out["owned"] = [list(t) for t in m.psparse_owned_triplets(A).part_values()]
    return out


# --- index_sets.py / prange.py -----------------------------------------------


def sc_index_sets(m, parts):
    idx = _sub(m, "parallel.index_sets")
    s = idx.IndexSet(0, np.array([0, 1, 2, 9, 3]), np.array([0, 0, 0, 1, 2], dtype=np.int32))
    out = {
        "get": [getattr(m, f"get_{k}")(s) for k in ("lid_to_gid", "lid_to_part", "oid_to_lid", "hid_to_lid",
                                                   "lid_to_ohid")],
        "gid_to_lid": m.get_gid_to_lid(s)(np.array([9, 3, 1, 42])),
        "touched": m.touched_hids(s, [0, 9, 0, 3, 42]),
        "counts": [m.num_lids(s), m.num_oids(s), m.num_hids(s)],
    }
    out["add_gid"] = (m.add_gid(s, 7, 2), m.add_gid(s, 9, 1), s.lid_to_gid, s.lid_to_part)
    e = m.ExtendedIndexRange(1, 3, 10, np.array([10, 11, 12, 4, 20]), np.array([1, 1, 1, 0, 3], dtype=np.int32))
    out["extended"] = (e.noids_range, e.num_oids, e.hid_to_gid, e.gids_to_lids(np.array([11, 20, 5])))
    rows = _ghosted_rows(m, parts)
    gids = m.map_parts(lambda i: np.array([int(i.hid_to_gid[0]), int(i.oid_to_gid[0]), 99]), rows.partition)
    out["pdata"] = [list(m.touched_hids(rows, gids).part_values())] + [
        list(getattr(m, f"num_{k}")(r).part_values()) for k in ("lids", "oids", "hids")
        for r in (rows, rows.partition)
    ]
    out["num_gids"] = (m.num_gids(rows), _raises(m.num_gids, s))
    return out


def sc_prange_eq(m, parts):
    pr = _sub(m, "parallel.prange")
    a = _ghosted_rows(m, parts)
    b = _ghosted_rows(m, parts)
    c = pr.uniform_partition(parts, 12)
    d = m.add_gids(c, m.map_parts(lambda p: np.array([(3 * (p + 1) + 1) % 12]), parts))
    return [m.hids_are_equal(a, b), m.prange_eq(a, b), m.prange_eq(a, c), m.hids_are_equal(a, d),
            m.prange_eq(c, pr.uniform_partition(parts, 12)), m.prange_eq(c, pr.uniform_partition(parts, 13))]


# --- ops/sparse.py -----------------------------------------------------------


def sc_sparse(m, parts):
    sp = _sub(m, "ops.sparse")
    rng = np.random.default_rng(7)
    I = rng.integers(0, 9, 40)
    J = rng.integers(0, 7, 40)
    V = rng.standard_normal(40)
    A = sp.compresscoo(I, J, V, 9, 7)
    qi, qj = rng.integers(0, 9, 30), rng.integers(0, 7, 30)
    return {
        "indextype": str(m.indextype(A)), "nzindex": m.nzindex(A, qi, qj),
        "nzindex_scalar": m.nzindex(A, int(I[0]), int(J[0])), "triplets": list(m.nz_triplets(A)),
        "iterator": [(i, j, float(v)) for i, j, v in m.nziterator(A)],
    }


# --- utils/ ------------------------------------------------------------------


def sc_table_helpers(m, parts):
    ptrs = m.counts_to_ptrs(np.array([2, 0, 3]))
    adv = ptrs.copy()
    adv[:-1] = adv[1:]
    t = m.Table(np.array([7.0, 8.0, 9.0]), np.array([0, 2, 3], dtype=np.int32))
    e = m.empty_table(np.int32)
    return {
        "ptrs": ptrs, "rewind": m.rewind_ptrs(adv), "data": m.get_data(t), "table_ptrs": m.get_ptrs(t),
        "empty": (len(e), e.data, e.ptrs), "checks": m.checks_enabled(),
        "notimplemented": _raises(m.notimplemented), "unreachable": _raises(m.unreachable, "x"),
    }


# --- ptimers.py --------------------------------------------------------------


def sc_ptimer(m, parts):
    t = m.PTimer(parts)
    m.tic(t)
    m.toc(t, "phase-a")
    with t.section("phase-b"):
        pass
    t.tic(barrier=False)
    t.toc("phase-c")
    data = t.data
    return {
        "sections": sorted(data), "ordered": all(s["min"] <= s["avg"] <= s["max"] for s in data.values()),
        "per_part": [len(list(v.part_values())) for v in t.timings.values()],
        "spans": [s["name"] for s in t.spans], "toc_without_tic": _raises(t.toc, "nope"),
        "json": sorted(t.data_json()), "events": len(t.trace_events()),
    }


# --- the last two names of the host API: the pvector dispatcher and the
# discovery guard (pvector.py:557, collectives.py:418-455) ---------------------


def sc_pvector_dispatch(m, parts):
    rows = _ghosted_rows(m, parts)
    u = m.pvector(rows)
    f = m.pvector(1.5, rows)
    I = m.map_parts(lambda p: np.array([3 * p, (3 * p + 3) % 12]), parts)
    V = m.map_parts(lambda p: np.array([1.0 + p, 10.0]), parts)
    c = m.pvector(I, V, rows)
    return {
        "undef": (str(u.dtype), [len(x) for x in u.values]), "full": [x.tolist() for x in f.values],
        "coo": [np.asarray(x).tolist() for x in c.values], "bad": _raises(m.pvector, "x", 1, 2, 3),
    }


def sc_discover_parts_snd(m, parts):
    parts_rcv = m.map_parts(lambda p: np.asarray(RCV[p], dtype=np.int32), parts)
    flag = m.ERROR_DISCOVER_PARTS_SND
    before = flag[0]
    fallback = [np.asarray(v).tolist() for v in m.discover_parts_snd(parts_rcv).part_values()]
    flag[0] = True
    try:
        guarded = _raises(m.discover_parts_snd, parts_rcv)
    finally:
        flag[0] = before
    out = {"fallback": fallback, "guarded": guarded, "flag": flag[0]}
    if m is not pa:  # the port's keyword sets the guard for one call, either way
        out["keyword"] = _raises(m.discover_parts_snd, parts_rcv, error_discover_parts_snd=True)
        flag[0] = True
        try:
            out["keyword_off"] = len(list(m.discover_parts_snd(parts_rcv, error_discover_parts_snd=False)
                                          .part_values()))
        finally:
            flag[0] = before
    else:
        out["keyword"], out["keyword_off"] = guarded, len(fallback)
    return out


SCENARIOS = {
    f.__name__[3:]: f for f in [
        sc_pvector_constructors, sc_pvector_reductions, sc_pvector_inplace, sc_pvector_copy_into,
        sc_pvector_exchange_assemble, sc_pvector_from_coo, sc_global_view, sc_local_view, sc_distances,
        sc_exchanger, sc_collectives, sc_backends, sc_matrix_exchanger, sc_exchange_coo, sc_owned_triplets,
        sc_index_sets, sc_prange_eq, sc_sparse, sc_table_helpers, sc_ptimer, sc_pvector_dispatch,
        sc_discover_parts_snd,
    ]
}


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_host_api_matches_jax(name, backend):
    """Every scenario on 4 parts: the port (sequential backend and GPU
    backend on the CPU) returns exactly what the JAX package's sequential
    backend returns."""
    f = SCENARIOS[name]
    want = _plain(f(pa, pa.sequential.get_part_ids(4)))
    got = _plain(f(pt, PORT_BACKENDS[backend].get_part_ids(4)))
    assert got == want


def test_print_timer_table_matches_jax(capsys, tmp_path):
    """`print_timer` prints the same max-sorted table layout and writes the
    same JSON keys; the times themselves differ from run to run."""

    def run(m, parts, path):
        t = m.PTimer(parts, verbose=True)
        with t.section("assembly"):
            sum(range(1000))
        m.print_timer(t, json_path=str(path))
        return capsys.readouterr().out.splitlines()

    want = run(pa, pa.sequential.get_part_ids(2), tmp_path / "j.json")
    got = run(pt, CPU.get_part_ids(2), tmp_path / "p.json")
    assert [line.split()[0] for line in got] == [line.split()[0] for line in want]
    assert len(got) == len(want) == 4
    import json

    assert json.loads((tmp_path / "p.json").read_text()).keys() == json.loads((tmp_path / "j.json").read_text()).keys()


#: every name the reference's host layers export that this slice ports
HOST_API = (
    "PVector GlobalViewPart LocalViewPart assemble async_assemble exchange_pvector local_view global_view "
    "sqeuclidean euclidean cityblock chebyshev minkowski "
    "exchange_values allocate_rcv_buffer allocate_snd_buffer empty_exchanger "
    "gather_all reduce_all sum_parts iscan_main iscan iscan_all exchange_into "
    "prun_debug get_backend map_main unzip "
    "matrix_exchanger exchange_coo psparse_local_values psparse_owned_triplets "
    "ExtendedIndexRange get_lid_to_gid get_lid_to_part get_oid_to_lid get_hid_to_lid get_lid_to_ohid "
    "get_gid_to_lid touched_hids add_gid num_gids num_lids num_oids num_hids "
    "hids_are_equal prange_eq indextype nzindex nz_triplets nziterator "
    "counts_to_ptrs empty_table get_data get_ptrs rewind_ptrs checks_enabled notimplemented unreachable "
    "PTimer tic toc print_timer "
    "assemble_poisson_periodic assemble_fem_q1 fem_q1_driver fem_q1_rhs_via_global_view "
    "assemble_heat heat_transient_driver "
    "bicgstab gmres fgmres minres chebyshev_solve lanczos_bounds gershgorin_bounds "
    "assemble_advection_fv advection_fv_driver "
    "pvector ERROR_DISCOVER_PARTS_SND discover_parts_snd"
).split()

PVECTOR_METHODS = ("undef similar copy_into axpy fill scale ghost_values sum reduce_owned maximum minimum "
                   "any all assemble async_assemble").split()


#: The names of ``pa.__all__`` the port does not export, and why:
#: the TPU-named entry points (the port's are ``gpu_*``); the JAX package's
#: environment and XLA-cache switches (the port reads no environment:
#: `SDCConfig` and `TelemetryConfig` carry them); Queue 1 item 5's
#: repartition, elastic and multihost names, still to port; and
#: `ELLFootprintError` (a TPU fault ceiling the card has no use for).
NOT_EXPORTED = {
    "tpu": "TPU-named", "TPUBackend": "TPU-named", "TPUData": "TPU-named",
    "tpu_bicgstab": "TPU-named", "tpu_block_cg": "TPU-named", "tpu_cg": "TPU-named",
    "tpu_chebyshev": "TPU-named", "tpu_fgmres_gmg": "TPU-named", "tpu_gmg_pcg": "TPU-named",
    "tpu_gmg_solve": "TPU-named", "tpu_gmres": "TPU-named", "tpu_lobpcg": "TPU-named",
    "tpu_minres": "TPU-named",
    "abft_enabled": "switch", "health_enabled": "switch", "compilation_cache_dir": "switch",
    "enable_compilation_cache": "switch",
    "multihost_init": "item 5", "is_main_process": "item 5", "fetch_global": "item 5",
    "repartition_psparse": "item 5", "repartition_pvector": "item 5", "shrink_shape": "item 5",
    "shrink_system": "item 5", "survivor_rows": "item 5", "degraded_state": "item 5",
    "elastic_enabled": "item 5", "elastic_min_parts": "item 5",
    "ELLFootprintError": "not ported",
}


def test_host_api_exported():
    """Every name of the JAX package's ``__all__`` is exported by the port
    under the same name, but for the listed `NOT_EXPORTED` set; every
    TPU-named entry point has its ``gpu_*`` counterpart; every ported name
    of `HOST_API` is the JAX package's name (exported there too, but for
    `fem_q1_rhs_via_global_view`, which the JAX package keeps in
    `models/fem_q1.py`); the PVector methods exist on both."""
    from partitionedarrays_jl_tpu.models import fem_q1

    missing = sorted(n for n in pa.__all__ if n not in NOT_EXPORTED and (n not in pt.__all__ or not hasattr(pt, n)))
    assert not missing, missing
    assert set(NOT_EXPORTED) <= set(pa.__all__)
    assert not set(NOT_EXPORTED) & set(pt.__all__)
    for n, why in NOT_EXPORTED.items():
        if why == "TPU-named" and n.startswith("tpu_"):
            assert "gpu_" + n[4:] in pt.__all__, n
    missing = [n for n in HOST_API if n not in pt.__all__ or not hasattr(pt, n)]
    assert not missing, missing
    assert all(n in pa.__all__ or hasattr(fem_q1, n) for n in HOST_API)
    assert all(hasattr(pt.PVector, k) and hasattr(pa.PVector, k) for k in PVECTOR_METHODS)


def test_checks_switch_is_a_module_flag(monkeypatch):
    """The port's `checks_enabled` reads a module switch, not the
    environment: `check` stops asserting when it is off."""
    from partitionedarrays_jl_tpu_torch.utils import helpers

    monkeypatch.setenv("PA_TPU_CHECKS", "0")
    assert pt.checks_enabled()
    with pytest.raises(AssertionError):
        helpers.check(False, "on")
    monkeypatch.setattr(helpers, "CHECKS_ENABLED", False)
    assert not pt.checks_enabled()
    helpers.check(False, "off")
