"""Block (multi-RHS) solves on the non-band lowerings (supernode-dense,
node blocks, padded ELL) and the slab forms of E1, E2 and E3
(`ops/irregular.py`: `ell_spmm`, `bsr_spmm`, `bsr_spmv_boundary` on
slabs, `pairwise_dot_block`), against the frame forms and the JAX package.

* plain versions, K = 1, 3, 8, f32 and f64: column k of each slab form bit
  for bit its frame form on column k (E2 at bs 2, 3 and 4 with pad blocks
  and a NaN where only pads read x; E3 with signed zeros, a -0.0 sum kept);
* the SpMM of the JAX package's elasticity system on (4,4,4) nodes
  (`decouple_dirichlet`: symmetric, so every column converges from 0),
  carried over as arrays (`test_torch_lowering.carry`), on 2 and 4 parts in
  each lowering on ``GPUBackend(device="cpu")``, against the JAX package's
  `make_spmv_fn` on its TPU backend (the CPU mesh) to 1e-12 and SD against
  BSR to 1e-10 (the tolerances of tests/test_block_cg.py:126: the two sum
  the same terms in other orders); column k bit for bit the port's frame
  product of column k on BSR and ELL (on SD, `torch.bmm` takes its own order
  for K columns: to 1e-12);
* block Jacobi PCG (K = 3, ragged) on that system on 4 parts in each
  lowering against the JAX package's block solve (`pa.pcg(A, B=...)` on
  its TPU backend, `tpu_block_cg`): each column's iterations, solutions to
  1e-10; each column's iterations, history and solution bit for bit the
  port's solo solve on BSR and ELL, to 1e-12 on SD; the slab products
  called by the launch formula of the card (counting wrappers: the SpMM
  and its boundary 1 + 1 a device iteration).

Strict block solves are held in tests/test_torch_strict.py.
"""
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_elasticity_tet as jax_assemble_elasticity_tet
from partitionedarrays_jl_tpu.models import decouple_dirichlet as jax_decouple_dirichlet
from partitionedarrays_jl_tpu.parallel.tpu import DeviceMatrix as JaxDeviceMatrix
from partitionedarrays_jl_tpu.parallel.tpu import _block_on_cols_layout as jax_block_on_cols_layout
from partitionedarrays_jl_tpu.parallel.tpu import make_spmv_fn as jax_make_spmv_fn
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import irregular as irr
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    _block_on_cols_layout,
    device_matrix,
    make_spmv_fn,
)
from test_torch_lowering import ENV, LOWERINGS, carry, export

CPU = GPUBackend(device="cpu")
NODES = (4, 4, 4)
K = 3
TOL = 1e-10
MAXITER = 500


@contextmanager
def _env(env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _gid_values(isets, k):
    """Per part, values over the lids that depend on the gid only (so both
    packages, and every partition, see the same vector)."""
    return [np.cos(1.3 + 0.7 * (k + 1) * np.asarray(i.lid_to_gid, dtype=np.float64)) for i in isets]


def _owned_rows(y, isets):
    """(rows, K): the owned rows of a (P, W, K) product, parts in order."""
    return np.concatenate([np.asarray(y)[p, : i.num_oids] for p, i in enumerate(isets)])


def _ragged(isets, b):
    """The block of tests/test_block_cg.py:_ragged_block over a row range:
    the assembled b, a gid-seeded vector and a 1e-3 constant."""
    return [[np.asarray(v) for v in b.values.part_values()], _gid_values(isets, 5),
            [np.full(i.num_lids, 1e-3) for i in isets]]


def jax_reference(nparts, solve):
    """The JAX package on its TPU backend (the CPU mesh): the system, K
    column vectors, the SpMM of each lowering (owned rows, (rows, K)) and,
    with ``solve``, the block Jacobi PCG of the ragged block in each
    lowering (per-column iterations, solutions gathered)."""

    def driver(parts):
        A, b, xh, x0 = jax_assemble_elasticity_tet(parts, NODES)
        A = jax_decouple_dirichlet(A)  # symmetric: every column converges from 0
        cols = A.cols.partition.part_values()
        X = [_gid_values(cols, k) for k in range(K)]
        Xs = [pa.PVector(A.cols.partition._like(x), A.cols) for x in X]
        B = _ragged(A.rows.partition.part_values(), b)
        out = {"system": export(A, xh), "X": X, "B": B, "y": {}, "solve": {}}
        for name, env in ENV.items():
            with _env(env):
                dA = JaxDeviceMatrix(A, parts.backend)
                out["y"][name] = _owned_rows(jax_make_spmv_fn(dA)(jax_block_on_cols_layout(Xs, dA)),
                                             A.rows.partition.part_values())
                if solve:
                    Bs = [pa.PVector(A.rows.partition._like(v), A.rows) for v in B]
                    xs, info = pa.pcg(A, B=Bs, tol=TOL, maxiter=MAXITER)
                    out["solve"][name] = (info["iterations_per_column"], [pa.gather_pvector(x) for x in xs])
        return out

    return pa.prun(driver, pa.tpu, nparts)


@pytest.fixture(scope="module")
def reference():
    return {2: jax_reference(2, False), 4: jax_reference(4, True)}


# ---------------------------------------------------------------------------
# plain versions: column k of a slab form is the frame form on column k
# ---------------------------------------------------------------------------


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_ell_spmm_plain_columns_are_ell_spmv(k, dtype):
    """E1 on slabs: column k of `ell_spmm` (and of its plain version) is
    `ell_spmv` of column k, bit for bit, rows outside the band 0; -0.0
    rows (all products -0.0) kept."""
    rng = np.random.default_rng(k)
    P, L, n, o0 = 2, 7, 61, 3
    wx, width = o0 + n + 9, o0 + n + 4
    vals = _t(rng.standard_normal((P, L, n)), dtype)
    vals[0, :, 5] = -0.0
    cols = torch.from_numpy(rng.integers(0, wx, (P, L, n)).astype(np.int32))
    x = _t(rng.standard_normal((P, wx, k)), dtype)
    x[:, ::6] = 0.0
    y = irr.ell_spmm(vals, cols, x, o0, width)
    assert torch.equal(y, irr.ell_spmm_plain(vals, cols, x, o0, width))
    for c in range(k):
        want = irr.ell_spmv(vals, cols, x[..., c].contiguous(), o0, width)
        assert y[..., c].numpy().tobytes() == want.numpy().tobytes()
    assert not y[:, :o0].any() and not y[:, o0 + n :].any()


def _padded_blocks(rng, P, nn, Lb, bs):
    """Node-block rows as the staging lays them: counts[p, n] real blocks,
    then pads (value 0, node 0); node 0 full and node 1 empty."""
    counts = rng.integers(0, Lb + 1, (P, nn)).astype(np.int32)
    counts[0, 0], counts[0, 1] = Lb, 0
    keep = np.arange(Lb)[None, None, :] < counts[..., None]
    vals = np.where(keep[..., None, None], rng.standard_normal((P, nn, Lb, bs, bs)), 0.0)
    cols = np.where(keep, rng.integers(0, nn, (P, nn, Lb)), 0)
    return vals, cols.astype(np.int32), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_spmm_plain_columns_are_bsr_spmv(bs, k, dtype):
    """E2 on slabs: column k of `bsr_spmm` (its plain version on the
    row-major operands) is `bsr_spmv` of column k, bit for bit, pads and
    their terms included: an infinity at the node frame's first node (the
    pads' x) makes the rows with pads NaN in every column."""
    rng = np.random.default_rng(bs * 10 + k)
    P, nn, Lb, xo0, yo0 = 2, 23, 5, 2, 1
    wx, width = xo0 + nn * bs + 5, yo0 + nn * bs + 3
    v, c, counts = _padded_blocks(rng, P, nn, Lb, bs)
    vals, cols, counts = _t(v, dtype), torch.from_numpy(c), torch.from_numpy(counts)
    sv, sc = irr.bsr_slot_major(vals), irr.bsr_slot_major(cols)
    x = _t(rng.standard_normal((P, wx, k)), dtype)
    x[1, xo0] = float("inf")
    y = irr.bsr_spmm(sv, sc, counts, x, xo0, yo0, width)
    assert y.numpy().tobytes() == irr.bsr_spmm_plain(vals, cols, x, xo0, yo0, width).numpy().tobytes()
    for col in range(k):
        want = irr.bsr_spmv(sv, sc, counts, x[..., col].contiguous(), xo0, yo0, width)
        assert y[..., col].numpy().tobytes() == want.numpy().tobytes()
    assert torch.isnan(y[1, yo0 : yo0 + nn * bs]).any()
    assert not y[:, :yo0].any() and not y[:, yo0 + nn * bs :].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_boundary_on_slabs_is_the_frame_boundary(bs, k, dtype):
    """E2's boundary mode on (P, W, K) slabs over three width buckets (views
    of one buffer each): column k of y is the frame call on column k, bit
    for bit; pad rows at the trash slot leave it untouched."""
    rng = np.random.default_rng(bs + 100 * k)
    P, nhn, g0, wy = 2, 9, 4, 60
    trash = wy - 1
    shapes = [(5, 2), (3, 4), (2, 7)]  # (nodes, blocks) a bucket
    rows_l, vals_l, cols_l = [], [], []
    slots = rng.permutation(wy - 1)[: sum(nb for nb, _ in shapes) * bs].reshape(-1, bs)
    at = 0
    for nb, Lb in shapes:
        r = np.stack([slots[at : at + nb]] * P)
        r[:, -1, :] = trash  # a pad node
        rows_l.append(r.astype(np.int64))
        vals_l.append(rng.standard_normal((P, nb, Lb, bs, bs)))
        cols_l.append(rng.integers(0, nhn, (P, nb, Lb)).astype(np.int32))
        at += nb

    def flat(arrs, dt):
        buf = torch.cat([torch.from_numpy(a).reshape(-1) for a in arrs]).to(dt)
        views, o = [], 0
        for a in arrs:
            views.append(buf[o : o + a.size].view(a.shape))
            o += a.size
        return tuple(views)

    rows, cols, vals = flat(rows_l, torch.int64), flat(cols_l, torch.int32), flat(vals_l, dtype)
    x = _t(rng.standard_normal((P, g0 + nhn * bs + 2, k)), dtype)
    y0 = _t(rng.standard_normal((P, wy, k)), dtype)
    y = irr.bsr_spmv_boundary(rows, vals, cols, x, g0, nhn, y0.clone(), trash)
    assert torch.equal(y[:, trash], y0[:, trash])
    for c in range(k):
        want = irr.bsr_spmv_boundary(rows, vals, cols, x[..., c].contiguous(), g0, nhn, y0[..., c].clone(), trash)
        assert y[..., c].numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 5, 64, 1000])
def test_pairwise_dot_block_columns_are_pairwise_dot(n, k, dtype):
    """E3's block form: element k is `pairwise_dot` of column k, bytes
    equal (n = 0 and 1, a power of two, odd lengths; 3 parts, a band
    offset); a column whose products are all -0.0 sums to -0.0 on one part
    as the frame form does."""
    rng = np.random.default_rng(n + k)
    P, o0 = 3, 2
    a = _t(rng.standard_normal((P, o0 + n + 3, k)), dtype)
    b = _t(rng.standard_normal((P, o0 + n + 5, k)), dtype)
    got = irr.pairwise_dot_block(a, b, o0, n)
    assert got.shape == (k,)
    for c in range(k):
        want = irr.pairwise_dot(a[..., c].contiguous(), b[..., c].contiguous(), o0, n)
        assert got[c].numpy().tobytes() == want.numpy().tobytes()
    z = -torch.zeros((1, n + 1, k), dtype=dtype)
    one = torch.ones((1, n + 1, k), dtype=dtype)
    zs = irr.pairwise_dot_block(z, one, 0, n)
    for c in range(k):
        assert zs[c].numpy().tobytes() == irr.pairwise_dot(z[..., c].contiguous(), one[..., c].contiguous(), 0,
                                                            n).numpy().tobytes()
    if n == 1:
        assert torch.signbit(zs).all()


# ---------------------------------------------------------------------------
# the SpMM and the block solve against the JAX package
# ---------------------------------------------------------------------------


def _port_spmm(e, X, nparts):
    def driver(parts):
        A, _ = carry(parts, e)
        Xs = [interop.pvector_from_values(A.cols, x) for x in X]
        isets = A.rows.partition.part_values()
        out = {}
        for low in LOWERINGS:
            dA = device_matrix(A, parts.backend, lowering=low)
            spmv = make_spmv_fn(dA)
            y = spmv(_block_on_cols_layout(Xs, dA))
            frames = [spmv(DeviceVector.from_pvector(x, parts.backend, dA.col_layout).data) for x in Xs]
            out[low] = (dA.lowering, _owned_rows(y.numpy(), isets),
                        [_owned_rows(f.numpy()[..., None], isets)[:, 0] for f in frames])
        return out

    return pt.prun(driver, CPU, nparts)


@pytest.mark.parametrize("nparts", [2, 4])
def test_spmm_matches_jax_in_each_lowering(reference, nparts):
    ref = reference[nparts]
    got = _port_spmm(ref["system"], ref["X"], nparts)
    assert [got[low][0] for low in LOWERINGS] == ["sd", "bsr", "ell"]
    for low in LOWERINGS:
        _, y, frames = got[low]
        np.testing.assert_allclose(y, ref["y"][low], rtol=1e-12, atol=1e-12)
        for c in range(K):
            if low == "sd":
                np.testing.assert_allclose(y[:, c], frames[c], rtol=1e-12, atol=1e-12)
            else:
                assert y[:, c].tobytes() == frames[c].tobytes()
    np.testing.assert_allclose(got["auto"][1], got["bsr"][1], rtol=1e-10, atol=1e-10)


def _counting(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        f = getattr(irr, name)

        def wrapped(*a, _f=f, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(irr, name, wrapped)
    return calls


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_block_pcg_matches_jax_and_solo(reference, lowering, monkeypatch):
    ref = reference[4]
    calls = _counting(monkeypatch, ["ell_spmm", "bsr_spmm", "bsr_spmv_boundary", "ell_spmv_boundary"])

    def driver(parts):
        A, _ = carry(parts, ref["system"])
        B = [interop.pvector_from_values(A.rows, v) for v in ref["B"]]
        xs, info = pt.pcg(A, B=B, tol=TOL, maxiter=MAXITER, lowering=lowering)
        counted = dict(calls)
        solo = [pt.pcg(A, bk, tol=TOL, maxiter=MAXITER, lowering=lowering) for bk in B]
        return info, [pt.gather_pvector(x) for x in xs], [(pt.gather_pvector(x), i) for x, i in solo], counted

    info, xs, solo, counted = pt.prun(driver, CPU, 4)
    want_its, want_x = ref["solve"][lowering]
    its = info["iterations_per_column"]
    assert info["lowering"] == {"auto": "sd"}.get(lowering, lowering) and not info["strict"]
    assert info["cg_body"] == "fused" and info["converged"] and len(set(its)) > 1
    assert its == list(want_its)
    for k in range(K):
        np.testing.assert_allclose(xs[k], want_x[k], rtol=0, atol=1e-10)
        xk, ik = solo[k]
        assert ik["iterations"] == its[k]
        if lowering == "auto":
            np.testing.assert_allclose(xs[k], xk, rtol=0, atol=1e-12)
        else:
            assert xs[k].tobytes() == xk.tobytes()
            assert np.asarray(info["columns"][k]["residuals"]).tobytes() == np.asarray(ik["residuals"]).tobytes()
    # the card's formula: the SpMM and its boundary once at the start and
    # once a device iteration (the fused body's fold rides the eager ops)
    spmvs = 1 + info["device_loop"]["device_iterations"]
    spmm = {"auto": None, "bsr": "bsr_spmm", "ell": "ell_spmm"}[lowering]
    boundary = "ell_spmv_boundary" if lowering == "ell" else "bsr_spmv_boundary"
    assert counted[boundary] == spmvs
    if spmm is not None:
        assert counted[spmm] == spmvs
