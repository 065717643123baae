"""The port's box exchange plan (`parallel/gpu_box.py`) and the multigrid
transfer routes it enables (`parallel/gpu_gmg.py`: the matrix-free stencil
route with `ops/stencil.py`, the strided-box embedding ``emb_fast``)
against the JAX package.

Setups mirror tests/test_box_exchange.py and tests/test_gmg.py:605-727.
The port runs on ``GPUBackend(device="cpu")`` (the kernels' plain
versions); the JAX package on ``pa.tpu`` over the 8-device CPU mesh (its
box analysis, being host NumPy, on ``pa.sequential``). The multigrid
cases carry the JAX package's fine operator into the port through
`interop` and build each package's own hierarchy. Tolerances: `BoxInfo`
field by field and the ``set`` exchange exactly (it copies values); the
``add`` exchange to rtol=1e-14 (sums in another order than the generic
plan); the transfers to rtol=1e-13 of f64 rounding; GMG-PCG iterations
equal and solutions to atol=1e-10."""
import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu.parallel.tpu_box as jbox
import partitionedarrays_jl_tpu.parallel.tpu_gmg as jgmg
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import epilogue as ep
from partitionedarrays_jl_tpu_torch.ops import stencil as stn
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel.gpu_loop import GMG_BLOCK
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    device_exchange_plan,
    device_layout,
    device_matrix,
    exchange_,
)
from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan, analyze_box_structure
from partitionedarrays_jl_tpu_torch.parallel.prange import uniform_partition

# the module, not the `tpu` backend instance the package re-exports
jtpu = importlib.import_module("partitionedarrays_jl_tpu.parallel.tpu")
CPU = GPUBackend(device="cpu")


# ---------------------------------------------------------------------------
# box analysis and exchange
# ---------------------------------------------------------------------------

#: (ns, parts, how the range is made): with_ghost ranges as in
#: tests/test_box_exchange.py, the assemble_poisson column range, and the
#: irregular partition that has no box structure
RANGES = {
    "8x8x8-on-2x2x2": ((8, 8, 8), (2, 2, 2), "ghost"),
    "9x7x8-unequal": ((9, 7, 8), (2, 2, 2), "ghost"),
    "12x12-on-2x4": ((12, 12), (2, 4), "ghost"),
    "16-on-4": ((16,), (4,), "ghost"),
    "8x8-periodic": ((8, 8), (2, 2), "periodic"),
    "7x9x11-eight-variants": ((7, 9, 11), (2, 2, 2), "ghost"),
    "poisson-cols": ((8, 8, 8), (2, 2, 2), "poisson"),
    "irregular": ((64,), (4,), "irregular"),
}


def _make_range(mod, parts, ns, how):
    if how == "ghost":
        return mod.prange(parts, ns, mod.with_ghost)
    if how == "periodic":
        return mod.prange(parts, ns, mod.with_ghost, periodic=(True,) * len(ns))
    if how == "poisson":
        return mod.assemble_poisson(parts, ns)[0].cols
    rows = (pa.uniform_partition if mod is pa else uniform_partition)(parts, ns[0])
    gids = mod.map_parts(lambda i: (np.asarray(i.oid_to_gid[:1]) + 17) % ns[0], rows.partition)
    return mod.add_gids(rows, gids)


def _info_fields(rows, analyze):
    """A BoxInfo's fields, the ghost slots keyed by gid (the two packages'
    assemblies may number a part's ghosts in another order)."""
    info = analyze(rows)
    if info is None:
        return None
    slots = []
    for iset, rel in zip(rows.partition.part_values(), info.ghost_rel_slots):
        g = np.asarray(iset.hid_to_gid)
        order = np.argsort(g)
        slots.append((g[order].tolist(), np.asarray(rel)[order].tolist()))
    return {
        "box_shapes": info.box_shapes, "variants": info.variants.tolist(), "nh_total": info.nh_total,
        "dirs": [(d.dir, d.geo, d.off, d.size, d.perm) for d in info.dirs],
        "ghost_slots_by_gid": slots, "seg_mask": info.seg_mask.tolist(), "P": info.P,
    }


def _ramp(mod, rows):
    """gid-derived values per part: a misrouted element changes a value."""
    vals = mod.map_parts(
        lambda i: np.asarray(i.lid_to_gid, dtype=np.float64) * 2.0 + 1.0 + 0.001 * i.part, rows.partition
    )
    return mod.PVector(vals, rows)


@pytest.mark.parametrize("case", [c for c in RANGES if c != "irregular"])
def test_box_exchange_matches_generic_and_jax(case):
    """Both combines through the box plan against the generic plan of the
    same range (per lid) and against the JAX package's box plan (the whole
    frame: both lay the segments out alike)."""
    ns, grid, how = RANGES[case]

    def jax_driver(parts):
        rows = _make_range(pa, parts, ns, how)
        out = {}
        for combine in ("set", "add"):
            dv = jtpu.DeviceVector.from_pvector(_ramp(pa, rows), parts.backend)
            out[combine] = np.asarray(jtpu.make_exchange_fn(rows, parts.backend, combine=combine)(dv.data))
        return out

    def port_driver(parts):
        rows = _make_range(pt, parts, ns, how)
        out = {}
        for combine in ("set", "add"):
            rev = combine == "add"
            plan = device_exchange_plan(rows, parts.backend, reverse=rev)
            assert isinstance(plan, BoxExchangePlan) and plan.reverse_mode == rev
            dv = DeviceVector.from_pvector(_ramp(pt, rows), parts.backend)
            exchange_(plan, dv.data, combine)
            dg = DeviceVector.from_pvector(_ramp(pt, rows), parts.backend, device_layout(rows, box=False))
            exchange_(device_exchange_plan(rows, parts.backend, reverse=rev, box=False), dg.data, combine)
            out[combine] = (dv.data.numpy().copy(), pt.gather_pvector(dv.to_pvector()),
                            pt.gather_pvector(dg.to_pvector()))
            out[combine + "_lids"] = [
                (np.asarray(a), np.asarray(b))
                for a, b in zip(dv.to_pvector().values.part_values(), dg.to_pvector().values.part_values())
            ]
        return out

    want = pa.prun(jax_driver, pa.tpu, grid)
    got = pt.prun(port_driver, CPU, grid)
    for a, b in got["set_lids"]:
        assert np.array_equal(a, b)
    for a, b in got["add_lids"]:
        np.testing.assert_allclose(a, b, rtol=1e-14)
    frame_set, _, _ = got["set"]
    assert np.array_equal(frame_set, want["set"])
    frame_add, _, _ = got["add"]
    np.testing.assert_allclose(frame_add, want["add"], rtol=1e-14)


@pytest.mark.parametrize("case", [c for c in RANGES if c != "irregular"])
def test_box_add_sums_in_direction_order(case):
    """The reversed box plan adds each owner slot's contributions in
    direction order, no slot twice in one round: bitwise equal to a numpy
    loop over the plan's directions and sender -> receiver pairs, orphan
    segment slots left out, the ghost region zeroed after."""
    ns, grid, how = RANGES[case]

    def driver(parts):
        rows = _make_range(pt, parts, ns, how)
        plan = device_exchange_plan(rows, parts.backend, reverse=True)
        for _, _, idx in plan.add_rounds:
            assert len(np.unique(idx.numpy())) == len(idx)
        lay, info = plan.layout, plan.info
        x = np.random.default_rng(5).standard_normal((lay.P, lay.W))
        want = x.copy()
        for d in info.dirs:
            for p, q in d.perm:
                v = int(info.variants[p])
                start, shape = d.geo[v]
                box = want[p, lay.o0 : lay.o0 + math.prod(info.box_shapes[v])].reshape(info.box_shapes[v])
                n = math.prod(shape)
                seg = x[q, lay.g0 + d.off : lay.g0 + d.off + n]
                box[tuple(slice(a, a + s) for a, s in zip(start, shape))] += np.where(
                    info.seg_mask[q, d.off : d.off + n], seg, 0).reshape(shape)
        want[:, lay.g0 :] = 0
        got = exchange_(plan, torch.from_numpy(x.copy()), "add").numpy()
        return np.array_equal(got, want), len(plan.add_rounds)

    equal, rounds = pt.prun(driver, CPU, grid)
    assert equal and rounds >= 1


@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_cg_through_box_plan_matches_jax(box):
    """End-to-end: the fused CG on the box layout (default) and on the
    generic one takes the JAX package's iterations (its box plan) and
    reaches its solution."""
    ns = (8, 8, 8)

    def jax_driver(parts):
        A, b, xe, x0 = pa.assemble_poisson(parts, ns)
        assert isinstance(jtpu.device_exchange_plan(A.cols, False), jbox.BoxExchangePlan)
        x, info = pa.cg(A, b, x0=x0, tol=1e-10, maxiter=400)
        return pa.gather_pvector(x), info["iterations"]

    def port_driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        x, info = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=400, box=box)
        dA = device_matrix(A, parts.backend, box)
        assert isinstance(dA.col_plan, BoxExchangePlan) == box
        assert (dA.col_layout.box_info is not None) == box
        return pt.gather_pvector(x), info["iterations"]

    xj, itj = pa.prun(jax_driver, pa.tpu, (2, 2, 2))
    xp, itp = pt.prun(port_driver, CPU, (2, 2, 2))
    assert itp == itj
    np.testing.assert_allclose(xp, xj, atol=1e-12)


def test_box_layout_keeps_pads_zero_and_slots_mapped():
    """The box layout reorders the ghost region into segments through the
    slot maps only: every hid has a distinct slot in the segment region,
    and a staged vector's owned pads, orphan slots and trash are 0."""

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (9, 7, 8))
        L = device_layout(A.cols)
        info = L.box_info
        assert info is not None and len(info.box_shapes) > 1
        assert L.W == L.no_max + info.nh_total + 1
        dv = DeviceVector.from_pvector(x0, parts.backend, L)
        for p, iset in enumerate(A.cols.partition.part_values()):
            hs = L.hid_slots[p]
            assert len(np.unique(hs)) == len(hs) and (hs >= L.g0).all() and (hs < L.trash).all()
            assert not dv.data[p, L.o0 + iset.num_oids : L.g0].any()
            orphan = np.ones(L.W, dtype=bool)
            orphan[: L.g0] = False
            orphan[hs] = False
            assert not dv.data[p, torch.from_numpy(orphan)].any()
        return True

    assert pt.prun(driver, CPU, (2, 2, 2))


# ---------------------------------------------------------------------------
# multigrid: routes, transfers, GMG-PCG
# ---------------------------------------------------------------------------

#: (ns, operator, coarse_threshold), as tests/test_gmg.py:603-690: equal
#: boxes, unequal boxes (multi-variant descriptors), a periodic torus
#: (wrapped segments masked)
GMG_CASES = {
    "equal": ((16, 16, 16), "dirichlet", 100),
    "unequal": ((17, 14, 10), "dirichlet", 50),
    "periodic": ((12, 12, 12), "periodic", 100),
}
GMG_TOL = 1e-9


def _jax_route(l):
    return "stencil" if "stencil" in l else "emb_fast" if "emb_fast" in l else "structured" if "dS" in l else "assembled"


def _csr(M):
    return (np.asarray(M.indptr), np.asarray(M.indices), np.asarray(M.data), tuple(M.shape))


def _iset_arrays(r):
    isets = r.partition.part_values()
    return {
        "lid_to_gid": [np.asarray(i.lid_to_gid) for i in isets],
        "lid_to_part": [np.asarray(i.lid_to_part) for i in isets],
        "grid_shape": isets[0].grid_shape, "boxes": [(i.box_lo, i.box_hi) for i in isets],
    }


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _jax_transfers(h, backend, seed):
    """Per stencil level of the JAX hierarchy: the restriction of a
    gid-seeded fine frame (`_stencil_apply` + `_box_extract` per part) and
    the prolongation of a gid-seeded coarse vector (`_box_interleave`, the
    box exchange, `_stencil_apply`), with the frames they read."""
    import jax.numpy as jnp

    dh = jgmg._device_hierarchy(h, backend)
    out = []
    for li, lv in enumerate(dh["levels"]):
        if "stencil" not in lv:
            out.append(None)
            continue
        lvl = h.levels[li]
        LA = lv["dA"].col_plan.layout
        crows = h.levels[li + 1].A.rows if li + 1 < len(h.levels) else h.coarse_A.rows
        rng = np.random.default_rng(seed + li)
        xg, eg = rng.standard_normal(math.prod(lvl.nfs)), rng.standard_normal(math.prod(lvl.ncs))
        vals = pa.map_parts(lambda i: xg[np.asarray(i.lid_to_gid)], lvl.A.cols.partition)
        frame = np.asarray(jtpu.DeviceVector.from_pvector(pa.PVector(vals, lvl.A.cols), backend, LA).data)
        descs, shells = lv["stencil"], lv["shell"]
        dsel = np.asarray(lv["dsel"]).reshape(-1) if "dsel" in lv else np.zeros(LA.P, dtype=int)
        shm = np.asarray(lv["shmask"]) if "shmask" in lv else None
        z = np.zeros_like(frame)
        rest = []
        for p, ci in enumerate(crows.partition.part_values()):
            fb, cb, st = descs[dsel[p]]
            dm = None if shm is None else jnp.asarray(shm[p])
            w = jgmg._stencil_apply(jnp, LA, shells[dsel[p]], jnp.asarray(frame[p]), fb, dm)
            rest.append(np.asarray(jgmg._box_extract(jnp, w, fb, cb, st)))
            ec = eg[np.asarray(ci.oid_to_gid)]
            t = np.asarray(jgmg._box_interleave(jnp, jnp.asarray(ec), fb, cb, st))
            z[p, LA.o0 : LA.o0 + len(t)] = t
        zx = np.asarray(jtpu.make_exchange_fn(lvl.A.cols, backend)(jtpu._stage(backend, z, LA.P)))
        prol = [
            np.asarray(jgmg._stencil_apply(jnp, LA, shells[dsel[p]], jnp.asarray(zx[p]), descs[dsel[p]][0],
                                           None if shm is None else jnp.asarray(shm[p])))
            for p in range(LA.P)
        ]
        out.append({"frame": frame, "restrict": rest, "z": zx, "prolong": prol})
    return out


def _port_transfers(h, backend, seed):
    """The port's stencil route on the same inputs: `_extract` of
    `box_stencil_apply`, and `_interleave`, the box exchange,
    `box_stencil_apply`."""
    dh = gpu_gmg.device_hierarchy(h, backend)
    out = []
    for li, lv in enumerate(dh["levels"]):
        if gpu_gmg.route(lv) != "stencil":
            out.append(None)
            continue
        lvl, op = h.levels[li], lv["stencil"]
        LA = lv["dA"].col_layout
        crows = h.levels[li + 1].A.rows if li + 1 < len(h.levels) else h.coarse_A.rows
        rng = np.random.default_rng(seed + li)
        xg, eg = rng.standard_normal(math.prod(lvl.nfs)), rng.standard_normal(math.prod(lvl.ncs))
        vals = lvl.A.cols.partition._like([xg[np.asarray(i.lid_to_gid)] for i in lvl.A.cols.partition.part_values()])
        frame = DeviceVector.from_pvector(pt.PVector(vals, lvl.A.cols), backend, LA).data
        cis = crows.partition.part_values()
        nc = max(i.num_oids for i in cis)
        rc = torch.zeros((LA.P, nc), dtype=frame.dtype)
        gpu_gmg._extract(stn.box_stencil_apply(op, frame), op.groups, rc)
        ec = torch.zeros((LA.P, nc), dtype=frame.dtype)
        for p, ci in enumerate(cis):
            ec[p, : ci.num_oids] = torch.from_numpy(eg[np.asarray(ci.oid_to_gid)])
        z = torch.zeros_like(frame)
        gpu_gmg._interleave(ec, op.groups, z[:, LA.o0 : LA.o0 + LA.no_max])
        exchange_(lv["dA"].col_plan, z)
        ef = stn.box_stencil_apply(op, z)
        out.append({
            "frame": frame.numpy(), "z": z.numpy(),
            "restrict": [rc[p, : ci.num_oids].numpy() for p, ci in enumerate(cis)],
            "prolong": [ef[p, : int(op.table[p, 3])].numpy() for p in range(LA.P)],
            "groups": len(op.groups), "mask": op.mask is not None,
        })
    return out


@pytest.fixture(scope="module", params=list(GMG_CASES))
def gmg_case(request):
    """Both packages' routes per level (default, ``stencil=False`` /
    PA_TPU_GMG_STENCIL=0, ``box=False`` / PA_TPU_BOX=0 PA_TPU_GMG_BOX=0),
    GMG-PCG on the default routes, and the stencil levels' transfers."""
    ns, kind, ct = GMG_CASES[request.param]

    def jax_driver(parts):
        if kind == "periodic":
            A, b, xe, _ = pa.assemble_poisson_periodic(parts, ns, shift=1.0)
        else:
            A0, b0, xe, _ = pa.assemble_poisson(parts, ns)
            A, b = pa.decouple_dirichlet(A0, b0)
        h = pa.gmg_hierarchy(parts, A, ns, coarse_threshold=ct)
        x, info = pa.pcg(A, b, minv=h, tol=GMG_TOL)
        assert info["converged"]

        def routes():
            return [_jax_route(l) for l in jgmg._device_hierarchy(h, parts.backend)["levels"]]

        return {
            "routes": {
                "default": routes(),
                "stencil=False": _with_env({"PA_TPU_GMG_STENCIL": "0"}, routes),
                "box=False": _with_env({"PA_TPU_BOX": "0", "PA_TPU_GMG_BOX": "0"}, routes),
            },
            "it": info["iterations"], "x": pa.gather_pvector(x), "transfers": _jax_transfers(h, parts.backend, 7),
            "rows": _iset_arrays(A.rows), "cols": _iset_arrays(A.cols),
            "csr": [_csr(M) for M in A.values.part_values()], "b": [np.asarray(v) for v in b.values.part_values()],
        }

    j = pa.prun(jax_driver, pa.tpu, (2, 2, 2))

    def port_driver(parts):
        if kind == "periodic":
            # the port's own periodic assembly, the JAX package's arrays bit for bit
            A, b, _, _ = pt.assemble_poisson_periodic(parts, ns, shift=1.0)
            got = _iset_arrays(A.cols)
            assert got["grid_shape"] == j["cols"]["grid_shape"] and got["boxes"] == j["cols"]["boxes"]
            for k in ("lid_to_gid", "lid_to_part"):
                assert all(np.array_equal(u, v) for u, v in zip(got[k], j["cols"][k]))
            for M, c in zip(A.values.part_values(), j["csr"]):
                assert all(np.array_equal(u, v) for u, v in zip(_csr(M)[:3], c[:3]))
            for v, w in zip(b.values.part_values(), j["b"]):
                assert np.asarray(v).tobytes() == np.asarray(w).tobytes()
        else:
            rows = pt.cartesian_partition(parts, ns, pt.no_ghost)
            e = j["cols"]
            cols = interop.prange_from_arrays(parts, rows.ngids, e["lid_to_gid"], e["lid_to_part"],
                                              grid_shape=e["grid_shape"], boxes=e["boxes"])
            A = interop.psparse_from_csr(rows, cols, j["csr"])
            b = interop.pvector_from_values(rows, j["b"])
        h = pt.gmg_hierarchy(parts, A, ns, coarse_threshold=ct)
        x, info = pt.pcg(A, b, minv=h, tol=GMG_TOL)
        _, info_s = pt.pcg(A, b, minv=h, tol=GMG_TOL, stencil=False)
        kw = {"default": {}, "stencil=False": {"stencil": False}, "box=False": {"box": False}}
        return {
            "routes": {k: [gpu_gmg.route(l) for l in gpu_gmg.device_hierarchy(h, parts.backend, **v)["levels"]]
                       for k, v in kw.items()},
            "it": info["iterations"], "it_structured": info_s["iterations"], "x": pt.gather_pvector(x),
            "transfers": _port_transfers(h, parts.backend, 7),
        }

    return request.param, j, pt.prun(port_driver, CPU, (2, 2, 2))


def test_route_per_level_matches_jax(gmg_case):
    name, j, p = gmg_case
    assert p["routes"] == j["routes"]
    assert "stencil" in p["routes"]["default"]
    assert "stencil" not in p["routes"]["stencil=False"] + p["routes"]["box=False"]
    assert "emb_fast" not in p["routes"]["box=False"]


def test_stencil_transfers_match_jax(gmg_case):
    """Restriction and prolongation on every stencil level: the frames
    each package reads are equal slot for slot (the prolongation's after
    the box exchange), and the results agree to f64 rounding."""
    name, j, p = gmg_case
    levels = [(a, b) for a, b in zip(p["transfers"], j["transfers"]) if a is not None or b is not None]
    assert levels and all(a is not None and b is not None for a, b in levels)
    for a, b in levels:
        assert np.array_equal(a["frame"], b["frame"])
        assert np.array_equal(a["z"], b["z"])
        for got, want in zip(a["restrict"] + a["prolong"], b["restrict"] + b["prolong"]):
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    if name == "unequal":
        assert any(a["groups"] > 1 for a, _ in levels)  # multi-descriptor groups ran
    if name == "periodic":
        assert any(a["mask"] for a, _ in levels)  # wrapped segments masked


def test_gmg_pcg_stencil_route_matches_jax(gmg_case):
    name, j, p = gmg_case
    assert p["it"] == j["it"] == p["it_structured"]
    np.testing.assert_allclose(p["x"], j["x"], atol=1e-10)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, and launch counts
# ---------------------------------------------------------------------------


def _emulate_kernel(op, xv):
    """csrc/box_stencil.cu's indexing in numpy: one output point per lane,
    its neighbours read from the frame through the table (core box,
    segment at g0 + off, 0 for an absent direction, the mask), the 27
    terms of the 3-D stencil summed in np.ndindex order with separate
    roundings on every level (a 2-D level is a box with leading extent 1,
    its extra terms zeros). `_emulate_schedule` follows the kernel's order
    of work."""
    x = xv.numpy()
    table = op.table.numpy()
    mask = None if op.mask is None else op.mask.numpy()
    y = np.zeros((x.shape[0], op.n), dtype=x.dtype)
    for p in range(x.shape[0]):
        f0, f1, f2, cnt = (int(v) for v in table[p, :4])
        i = np.arange(cnt)
        c = (i // f2 // f1, i // f2 % f1, i % f2)
        acc = None
        for d in [(a, b, e) for a in (-1, 0, 1) for b in (-1, 0, 1) for e in (-1, 0, 1)]:
            nb = [c[k] + d[k] for k in range(3)]
            e = [np.where(nb[k] < 0, -1, np.where(nb[k] >= (f0, f1, f2)[k], 1, 0)) for k in range(3)]
            core = (e[0] == 0) & (e[1] == 0) & (e[2] == 0)
            v = np.zeros(cnt, dtype=x.dtype)
            v[core] = x[p, op.o0 + ((nb[0] * f1 + nb[1]) * f2 + nb[2])[core]]
            k = (e[0] + 1) * 9 + (e[1] + 1) * 3 + (e[2] + 1)
            off = table[p, 4 + k]
            seg = ~core & (off >= 0)
            s1, s2 = np.where(e[1] != 0, 1, f1), np.where(e[2] != 0, 1, f2)
            q = [np.where(e[j] != 0, 0, nb[j]) for j in range(3)]
            v[seg] = x[p, (op.g0 + off + (q[0] * s1 + q[1]) * s2 + q[2])[seg]]
            if mask is not None:
                v[seg] = v[seg] * mask[p, k[seg]]
            nz = sum(1 for t in d if t != 0)
            term = v if nz == 0 else x.dtype.type(0.5 ** nz) * v
            acc = term if acc is None else acc + term
        y[p, :cnt] = acc
    return y


def _ext_cell(x, mask, tb, op, n):
    """ext[n] of one part as the kernel stages it (stage_cell): the owned
    cell, the segment cell (times the direction's mask), or 0 for an absent
    direction."""
    f = [int(v) for v in tb[:3]]
    e = [-1 if c < 0 else (1 if c >= fj else 0) for c, fj in zip(n, f)]
    if e == [0, 0, 0]:
        return x[op.o0 + (n[0] * f[1] + n[1]) * f[2] + n[2]]
    k = (e[0] + 1) * 9 + (e[1] + 1) * 3 + (e[2] + 1)
    off = int(tb[4 + k])
    if off < 0:
        return x.dtype.type(0)
    s1, s2 = (1 if e[1] else f[1]), (1 if e[2] else f[2])
    q = [0 if ej else c for ej, c in zip(e, n)]
    v = x[op.g0 + off + (q[0] * s1 + q[1]) * s2 + q[2]]
    return v if mask is None else v * mask[k]


def _plane_terms(v, fin, mid, nw):
    """One ext plane's terms for a column of outputs (plane_terms): v[d1][d2]
    the 3x3 neighbourhood, each accumulator in (d1, d2) order."""
    for d1 in range(3):
        for d2 in range(3):
            a = v[d1][d2]
            nz = (d1 != 1) + (d2 != 1)
            t0 = a if nz == 0 else a.dtype.type(0.5 ** nz) * a
            t1 = a.dtype.type(0.5 ** (nz + 1)) * a
            nw = t1 if (d1, d2) == (0, 0) else nw + t1
            mid = mid + t0
            fin = fin + t1
    return fin, mid, nw


def _zero_tail(yp, cnt, n, threads, nb, b):
    for t in range(threads):
        yp[cnt + b * threads + t : n : nb * threads] = 0


def _emulate_tiled(op, x, mask, y, plan, zp, zb, bx, by):
    """One CTA of the tiled form: its fixed copy ops of a ring slot (16-byte
    chunks and rim cells of each staged row; ops inside the owned box copy
    from the frame, the others resolve each cell), the ring of RING slots
    filled AHEAD planes ahead, and the march over ext planes z0-1..z1 with
    three rotating accumulators for each of a thread's RT rows."""
    dt = x.dtype.type
    V = 16 // x.itemsize
    nch, rows = stn.TX // V, stn.TY + 2
    opr, sx = nch + 2, stn.TX + 2 * V
    nops = rows * opr
    tb = op.table.numpy()[zp]
    f0, f1, f2 = (int(v) for v in tb[:3])
    nzb = plan.grid[2] // op.table.shape[0]
    _zero_tail(y[zp], int(tb[3]), op.n, stn.THREADS, plan.grid[0] * plan.grid[1] * nzb,
               (zb * plan.grid[1] + by) * plan.grid[0] + bx)
    x0, y0, z0 = bx * stn.TX, by * stn.TY, zb * plan.tz
    if x0 >= f2 or y0 >= f1 or z0 >= f0:
        return
    z1 = min(z0 + plan.tz, f0)
    ops = []
    for e in range(nops):
        ly, k = divmod(e, opr)
        n1 = y0 - 1 + ly
        n2 = x0 + k * V if k < nch else (x0 - 1 if k == nch else x0 + stn.TX)
        cnt = V if k < nch else 1
        take = max(0, min(cnt, f2 + 1 - n2)) if n1 <= f1 else 0
        core = 0 <= n1 < f1 and n2 >= 0 and n2 + cnt <= f2
        ops.append((ly * sx + n2 - x0 + V, n1, n2, cnt, take, core, op.o0 + n1 * f2 + n2))
    ring = np.full((stn.RING, rows * sx), np.nan, dtype=x.dtype)

    def stage(n0):
        slot = ring[(n0 - z0 + 1) % stn.RING]
        for sh, n1, n2, cnt, take, core, g in ops:
            if take == 0:
                continue
            if core and 0 <= n0 < f0:
                slot[sh : sh + cnt] = x[g + n0 * f1 * f2 : g + n0 * f1 * f2 + cnt]
            else:
                for c in range(take):
                    slot[sh + c] = _ext_cell(x, mask, tb, op, (n0, n1, n2 + c))

    for i in range(stn.AHEAD):
        if z0 - 1 + i <= z1:
            stage(z0 - 1 + i)
    tid = np.arange(stn.THREADS)
    tx, ty = tid & 31, tid >> 5
    c2, c1 = x0 + tx, y0 + stn.RT * ty
    acc = [[np.zeros(stn.THREADS, dtype=x.dtype)] * 3 for _ in range(stn.RT)]
    for n in range(z0 - 1, z1 + 1):
        if n + stn.AHEAD <= z1:
            stage(n + stn.AHEAD)
        slot = ring[(n - z0 + 1) % stn.RING]
        base = stn.RT * ty * sx + V - 1 + tx
        v = [[slot[base + r * sx + d] for d in range(3)] for r in range(stn.RT + 2)]
        acc = [_plane_terms(v[r : r + 3], *acc[r]) for r in range(stn.RT)]
        for r, (fin, mid, nw) in enumerate(acc):
            st = (c2 < f2) & (c1 + r < f1)
            if n > z0:
                y[zp, (((n - 1) * f1 + c1 + r) * f2 + c2)[st]] = fin[st]
            acc[r] = [mid, nw, dt(0)]


def _emulate_slab(op, x, mask, y, plan, zp, zb, bx):
    """One CTA of the slab form: every cell of its tz + 2 ext planes of a
    band of rows (with the rim) staged at once, then each point of the band
    marched over them with three rotating accumulators."""
    tb = op.table.numpy()[zp]
    f0, f1, f2 = (int(v) for v in tb[:3])
    nzb = plan.grid[2] // op.table.shape[0]
    _zero_tail(y[zp], int(tb[3]), op.n, plan.threads, plan.grid[0] * nzb, zb * plan.grid[0] + bx)
    r0, z0 = bx * plan.rows, zb * plan.tz
    if r0 >= f1 or z0 >= f0:
        return
    r1, z1 = min(r0 + plan.rows, f1), min(z0 + plan.tz, f0)
    W, H, L = f2 + 2, r1 - r0 + 2, z1 - z0 + 2
    assert L * H * W * x.itemsize <= plan.smem  # the slab fits the CTA's shared memory
    slab = np.array([_ext_cell(x, mask, tb, op, (z0 - 1 + lz, r0 - 1 + ly, lx - 1))
                     for lz in range(L) for ly in range(H) for lx in range(W)], dtype=x.dtype)
    i = np.arange((r1 - r0) * f2)
    r, c = i // f2, i % f2
    fin = mid = nw = np.zeros(len(i), dtype=x.dtype)
    for lz in range(L):
        v = [[slab[lz * H * W + (r + d1) * W + c + d2] for d2 in range(3)] for d1 in range(3)]
        fin, mid, nw = _plane_terms(v, fin, mid, nw)
        if lz >= 2:
            y[zp, ((z0 + lz - 2) * f1 + r0 + r) * f2 + c] = fin
        fin, mid = mid, nw


def _emulate_schedule(op, xv, plan):
    """csrc/box_stencil.cu's order of work in numpy, CTA by CTA over the
    plan's grid: the form's staging (the tiled form's copy ops and ring,
    the slab form's one-shot slab), each output's 27 terms added plane by
    plane to its rotating accumulator, the stores and the zero tail.
    Slots nothing writes stay NaN."""
    x = xv.numpy()
    mask = None if op.mask is None else op.mask.numpy()
    P = x.shape[0]
    y = np.full((P, op.n), np.nan, dtype=x.dtype)
    gx, gy, gz = plan.grid
    nzb = gz // P
    for bz in range(gz):
        zp, zb = divmod(bz, nzb)
        for by in range(gy):
            for bx in range(gx):
                if plan.form == stn.TILED:
                    _emulate_tiled(op, x[zp], None if mask is None else mask[zp], y, plan, zp, zb, bx, by)
                else:
                    _emulate_slab(op, x[zp], None if mask is None else mask[zp], y, plan, zp, zb, bx)
    return y


def _fake_occupancy(form, threads, smem):
    """CTAs an SM holds, as the occupancy API would give them for the forms'
    register and shared-memory use on an H100 (tiled: 4; slab: threads)."""
    return 4 if form == stn.TILED else min(2048 // threads, (228 * 1024) // max(smem, 1))


#: hierarchies whose every stencil level the emulation is held on: one
#: part (the chip's 192^3 case, cut), stacked equal and unequal boxes, a
#: 2-D grid (the table's padded leading dimension); boxes that cross the
#: tiled form's edges (40x34x33: 34 rows over 16-row tiles, 33 points over
#: 32-point tiles, a last extent not a multiple of 4, 40 planes over
#: chunks of 3 or 14), and one on each side of the slab form's threshold
#: (32x32 = 1024 points a plane takes the slab form, 33x32 the tiled)
EMU_CASES = {
    "24^3-one-part-f32": ((24, 24, 24), (1, 1, 1), np.float32, 100),
    "16^3-2x2x2-f64": ((16, 16, 16), (2, 2, 2), np.float64, 100),
    "17x14x10-unequal-f64": ((17, 14, 10), (2, 2, 2), np.float64, 50),
    "20x18-2x2-f32": ((20, 18), (2, 2), np.float32, 20),
    "40x34x33-one-part-f32": ((40, 34, 33), (1, 1, 1), np.float32, 5000),
    "13x32x32-at-threshold-f64": ((13, 32, 32), (1, 1, 1), np.float64, 5000),
    "7x33x32-above-threshold-f32": ((7, 33, 32), (1, 1, 1), np.float32, 5000),
}


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_kernel_emulation_matches_plain(case):
    ns, grid, dt, ct = EMU_CASES[case]

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, ns, dtype=dt)
        h = pt.gmg_hierarchy(parts, pt.decouple_dirichlet(A), ns, coarse_threshold=ct)
        dh = gpu_gmg.device_hierarchy(h, parts.backend)
        rng = np.random.default_rng(3)
        held = 0
        for lv in dh["levels"]:
            if gpu_gmg.route(lv) == "stencil":
                op = lv["stencil"]
                xv = torch.from_numpy(rng.standard_normal((op.table.shape[0], op.W)).astype(dt))
                want = stn.box_stencil_apply_plain(op, xv).numpy()
                assert np.array_equal(_emulate_kernel(op, xv), want)
                # and with a random mask on every direction slot
                masked = dataclasses.replace(op, mask=torch.from_numpy(
                    rng.integers(0, 2, (op.table.shape[0], 27)).astype(dt)))
                assert np.array_equal(_emulate_kernel(masked, xv), stn.box_stencil_apply_plain(masked, xv).numpy())
                # the kernel's schedule: the form its shape takes, and each
                # form forced, on 132, 5 and 1 SMs (longer plane chunks, ragged)
                P, item = op.table.shape[0], np.dtype(dt).itemsize
                plans = {stn.plan_launch(op.fmax, P, item, _fake_occupancy, n_sm, form)
                         for form in (None, stn.TILED, stn.SLAB) for n_sm in (132, 5, 1)}
                for plan in plans:
                    for o in (op, masked):
                        got = _emulate_schedule(o, xv, plan)
                        assert np.array_equal(got, stn.box_stencil_apply_plain(o, xv).numpy()), plan
                held += 1
        return held

    assert pt.prun(driver, CPU, grid) >= 1


#: the stencil levels of chip_smoke.py's hierarchies (192^3 f32 on one
#: part; 48^3 f64 on (2,2,2) parts: boxes of 12^3 and 6^3) and the launch
#: each takes on 132 SMs: (box, parts, itemsize) -> (form, planes a CTA,
#: rows a CTA, threads, grid)
PLAN_CASES = {
    "192^3-f32": ((192, 192, 192), 1, 4, ("tiled", 28, 16, 256, (6, 12, 7))),
    "96^3-f32": ((96, 96, 96), 1, 4, ("tiled", 4, 16, 256, (3, 6, 24))),
    "48^3-f32": ((48, 48, 48), 1, 4, ("tiled", 1, 16, 256, (2, 3, 48))),
    "24^3-f32": ((24, 24, 24), 1, 4, ("slab", 1, 8, 192, (3, 1, 24))),
    "12^3-f32": ((12, 12, 12), 1, 4, ("slab", 1, 12, 160, (1, 1, 12))),
    "12^3-8-parts-f64": ((12, 12, 12), 8, 8, ("slab", 1, 12, 160, (1, 1, 96))),
    "6^3-8-parts-f64": ((6, 6, 6), 8, 8, ("slab", 1, 6, 64, (1, 1, 48))),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_launch_on_gmg_levels(case):
    """The form and grid `bind_kernel` takes on each stencil level of the
    chip's hierarchies, from shapes and the occupancy alone: the grid
    covers the box, one wave of the tiled form fills the card without
    spilling into a second, a slab fits its shared memory."""
    fmax, P, item, want = PLAN_CASES[case]
    plan = stn.plan_launch(fmax, P, item, _fake_occupancy, 132)
    assert (plan.form, plan.tz, plan.rows, plan.threads, plan.grid) == want
    f0, f1, f2 = fmax
    gx, gy, gz = plan.grid
    assert gz == P * -(-f0 // plan.tz)
    if plan.form == stn.TILED:
        assert gx * stn.TX >= f2 and gy * stn.TY >= f1
        assert gx * gy * gz <= plan.occupancy * 132 or plan.tz == f0
    else:
        assert gx * plan.rows >= f1 and plan.rows * f2 <= stn.THREADS
        assert plan.smem == (plan.tz + 2) * (plan.rows + 2) * (f2 + 2) * item <= stn.SLAB_SMEM
    assert (plan.form == stn.SLAB) == (f1 * f2 <= stn.SLAB_MAX_POINTS)


def test_plan_launch_refuses_what_does_not_fit():
    """A forced slab too wide for its shared memory, or a form the kernel
    has not, raises (no form is swapped in)."""
    with pytest.raises(ValueError, match="does not fit"):
        stn.plan_launch((4, 4, 100000), 1, 8, _fake_occupancy, 132, stn.SLAB)
    with pytest.raises(ValueError, match="no form"):
        stn.plan_launch((4, 4, 4), 1, 4, _fake_occupancy, 132, "wavefront")


def test_stencil_route_launch_counts(monkeypatch):
    """On the stencil route one V-cycle makes 2 SpMVs with each level's
    operator, 2 stencil applies and 3 epilogues (init, residual, smooth)
    on each stencil level, and no SpMV with any S; each PCG iteration one
    more SpMV with the fine operator:
    counted here through the wrappers the device loop calls, per iteration
    the device ran (the frozen ones after the stop included; one part,
    every level on the stencil route, as the chip's 192^3 case)."""
    calls = {"dia_coded_spmv": 0, "dia_stream_spmv": 0, "box_stencil_apply": 0, "vcycle_epilogue": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    counting(dia, "dia_coded_spmv")
    counting(dia, "dia_stream_spmv")
    counting(stn, "box_stencil_apply")
    counting(ep, "vcycle_epilogue")

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (24, 24, 24), dtype=np.float32)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (24, 24, 24), coarse_threshold=100)
        dh = gpu_gmg.device_hierarchy(h, parts.backend)
        for k in calls:
            calls[k] = 0
        info = pt.pcg(Ah, bh, minv=h, tol=1e-5)[1]
        it, dev_it = info["iterations"], info["device_loop"]["device_iterations"]
        return [gpu_gmg.route(l) for l in dh["levels"]], [l["dA"].dia_mode for l in dh["levels"]], it, dev_it

    routes, modes, it, dev_it = pt.prun(driver, CPU, (1, 1, 1))
    L = len(routes)
    assert routes == ["stencil"] * L and L >= 2 and it > 0
    assert dev_it == GMG_BLOCK * (it // GMG_BLOCK + 1)  # whole blocks, the last holding the stop
    n_stream = modes.count("stream")
    assert calls["dia_coded_spmv"] == 1 + dev_it * (1 + 2 * (L - n_stream))  # no S anywhere
    assert calls["dia_stream_spmv"] == dev_it * 2 * n_stream
    assert calls["box_stencil_apply"] == dev_it * 2 * L
    assert calls["vcycle_epilogue"] == dev_it * 3 * L
