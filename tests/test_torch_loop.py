"""The port's device-resident solve loops (`parallel/gpu_loop.py`; the loops
of `parallel/gpu.py:make_cg_fn` and `parallel/gpu_gmg.py:make_gmg_pcg_fn`)
and the CG update sweep (`ops/sweep.py`) on ``GPUBackend(device="cpu")``,
where every block runs eagerly with the kernels' plain versions.

* Each loop (fused, standard and pipelined CG on the 10^3 Poisson operator,
  GMG-PCG at 16^3 on the stencil and the structured routes, all on (2,2,2)
  parts, f64) against a reference eager loop written here: the loop as the
  port ran it before, a host read of the stopping test every iteration
  and a Python list for the history, on the same building blocks (the
  SpMV bodies, the part-order dots, the sweep with its flag set). x, rs,
  iterations and history must agree bit for bit (NaN included: a breakdown
  leaves NaN), for blocks of 1, 3 and 8 iterations and a stop on the first,
  a middle and the last iteration of a block, a maxiter cap, a breakdown
  (non-finite rs for CG: a zero operator; rz = 0 for GMG-PCG: a zero
  preconditioner) and a start that already meets tol; the history past the
  last iteration stays NaN.
* Iterations equal the JAX package's (`pa.cg`, `pa.cg(pipelined=True)`,
  `pa.pcg(minv=hierarchy)` on ``pa.tpu`` over the 8-device CPU mesh), the
  histories to rtol=1e-10 (atol 1e-15 of the initial residual), as
  tests/test_torch_pipelined.py holds them: the sweep sums r.r in another
  order than the JAX package's fused sweep.
* The sweep's plain version: x and r torch.equal to the eager update,
  the partial within 1e-12 (f64) or 2e-5 (f32, 8 sequential adds then
  halving trees) of a float64 numpy sum, its order equal bit for bit to a
  numpy emulation of csrc/cg_sweep.cu's CTA sums and fold; with the flag 0
  it writes nothing; K3's plain version with the flag 0 leaves the solution.
* `DeviceLoop`: rebound state written back at the end of a block (a swap
  of two buffers included), blocks counted, the state buffers reused.
"""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import sweep as sw
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel import gpu_loop as gl
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    _b_on_cols_layout,
    _pdot_factory,
    _spmv_body,
    device_matrix,
    make_cg_fn,
)

CPU = GPUBackend(device="cpu")
PARTS = (2, 2, 2)
CG_NS = (10, 10, 10)
GMG_NS = (16, 16, 16)
BODIES = ("fused", "standard", "pipelined", "gmg_stencil", "gmg_structured")
ONE = torch.ones((), dtype=torch.int32)


def _bits(t):
    """A tensor's bits, so that NaN compares equal to the same NaN."""
    t = torch.as_tensor(t)
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the systems and the reference loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def systems():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, CG_NS)
        dA = device_matrix(A, parts.backend)
        Z = pt.PSparseMatrix(A.values._like([M.__class__(M.indptr, M.indices, 0.0 * M.data, M.shape)
                                          for M in A.values.part_values()]), A.rows, A.cols)
        dZ = device_matrix(Z, parts.backend)
        cg = {
            "dA": dA, "dZ": dZ, "b": _b_on_cols_layout(b, dA),
            "x0": DeviceVector.from_pvector(x0, CPU, dA.col_layout).data,
            "xe": DeviceVector.from_pvector(xe, CPU, dA.col_layout).data,
        }
        Ag, bg, xeg, _ = pt.assemble_poisson(parts, GMG_NS)
        Ah, bh = pt.decouple_dirichlet(Ag, bg)
        h = pt.gmg_hierarchy(parts, Ah, GMG_NS, coarse_threshold=100)
        dA0 = device_matrix(Ah, parts.backend)
        gmg = {"h": h, "b": _b_on_cols_layout(bh, dA0), "dA0": dA0,
               "xe": DeviceVector.from_pvector(xeg, CPU, dA0.col_layout).data}
        gmg["x0"] = torch.zeros_like(gmg["b"])
        return {"cg": cg, "gmg": gmg}

    return pt.prun(driver, CPU, PARTS)


def _ref_cg(dA, tol, maxiter, body_kind, b, x0):
    """The CG loop as the port ran it before the device-resident form: a
    host read of the stopping test every iteration, the history a list.
    The pipelined body's last lagged update (the flush) goes through K3's
    plain version, as the loop's first frozen iteration applies it."""
    fused, pipelined = body_kind == "fused", body_kind == "pipelined"
    body = _spmv_body(dA)
    body_pfold = _spmv_body(dA, pfold=True)
    body_axpy = _spmv_body(dA, axpy=True)
    o0, no = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + no)
    pdot = _pdot_factory(o0, no)
    x = x0.clone()
    q = body(x0.clone())
    r = torch.zeros_like(x)
    r[:, sl] = b[:, sl] - q[:, sl]
    rs0 = pdot(r, r)
    thr = tol * torch.clamp(torch.sqrt(rs0), min=1.0)
    rs = rs0
    hist = [torch.sqrt(rs0)]
    part = sw.sweep_partials(r, no)
    zero = torch.zeros((), dtype=x.dtype)
    pprev, beta, alpha_prev = torch.zeros_like(x), zero, zero
    p = torch.zeros_like(x)
    p[:, sl] = r[:, sl]
    it = 0
    while it < maxiter and bool(((torch.sqrt(rs) > thr) & torch.isfinite(rs)).item()):
        if fused:
            q, p = body_pfold(r, pprev, beta)
        elif pipelined:
            q, x = body_axpy(p, x, pprev, alpha_prev)
        else:
            q = body(p)
        alpha = rs / pdot(p, q)
        if pipelined:
            rs_new = sw.cg_sweep_plain(r, q, alpha, ONE, part, o0, no)
        else:
            rs_new = sw.cg_sweep_plain(r, q, alpha, ONE, part, o0, no, x=x, p=p)
        beta = rs_new / rs
        if fused:
            pprev = p
        elif pipelined:
            pnew = torch.zeros_like(p)
            pnew[:, sl] = r[:, sl] + beta * p[:, sl]
            pprev, alpha_prev, p = p, alpha, pnew
        else:
            p[:, sl] = r[:, sl] + beta * p[:, sl]
        rs = rs_new
        it += 1
        hist.append(torch.sqrt(rs))
    if pipelined:
        dia.dia_coded_spmv_axpy_plain(dA.coded, p, x, pprev, alpha_prev, dA.row_layout.W)
    return (x, rs, rs0, it, torch.stack(hist)), r


def _ref_gmg(h, tol, maxiter, b, x0, stencil, vcycle=None):
    """GMG-PCG as the port ran it before: a host read of the stopping test
    and a host branch for the first beta every iteration."""
    dh = gpu_gmg.device_hierarchy(h, CPU, True, stencil)
    dA0 = dh["levels"][0]["dA"]
    L0, L0r = dA0.col_layout, dA0.row_layout
    no = L0.no_max
    sl = slice(L0.o0, L0.o0 + no)
    pdot = _pdot_factory(L0.o0, no)
    body_A0 = _spmv_body(dA0)
    vcycle = vcycle or gpu_gmg.make_vcycle(h, dh)

    def spmv(z):
        out = torch.zeros_like(z)
        out[:, sl] = body_A0(z)[:, L0r.o0 : L0r.o0 + no]
        return out

    x = x0.clone()
    q = spmv(x0.clone())
    r = torch.zeros_like(x0)
    r[:, sl] = b[:, sl] - q[:, sl]
    p = torch.zeros_like(x0)
    part = sw.sweep_partials(r, no)
    rs0 = pdot(r, r)
    thr = tol * torch.clamp(torch.sqrt(rs0), min=1.0)
    rs, rz_prev = rs0, torch.ones((), dtype=x.dtype)
    hist = [torch.sqrt(rs0)]
    it = 0
    while it < maxiter and bool(((torch.sqrt(rs) > thr) & (rz_prev != 0)).item()):
        z = vcycle(r)
        rz = pdot(r, z)
        beta = torch.zeros_like(rz) if it == 0 else rz / rz_prev
        p[:, sl] = z[:, sl] + beta * p[:, sl]
        q = spmv(p)
        alpha = rz / pdot(p, q)
        rs, rz_prev = sw.cg_sweep_plain(r, q, alpha, ONE, part, L0.o0, no, x=x, p=p), rz
        it += 1
        hist.append(torch.sqrt(rs))
    return (x, rs, rs0, it, torch.stack(hist)), r


def _solve(systems, body, tol, maxiter, block, zero_op=False, from_exact=False):
    """(loop result and final r, reference result and final r, the loop's
    stats) for one body."""
    if body.startswith("gmg"):
        g = systems["gmg"]
        stencil = body == "gmg_stencil"
        x0 = g["xe"] if from_exact else g["x0"]
        fn = gpu_gmg.make_gmg_pcg_fn(g["h"], CPU, tol, maxiter, stencil=stencil, block=block)
        got = fn(g["b"], x0)
        return (got, fn.loop.base["r"]), _ref_gmg(g["h"], tol, maxiter, g["b"], x0, stencil), fn.stats
    c = systems["cg"]
    dA = c["dZ"] if zero_op else c["dA"]
    x0 = c["xe"] if from_exact else c["x0"]
    fn = make_cg_fn(dA, tol, maxiter, fused=body == "fused", pipelined=body == "pipelined", block=block)
    got = fn(c["b"], x0)
    return (got, fn.loop.base["r"]), _ref_cg(dA, tol, maxiter, body, c["b"], x0), fn.stats


def _assert_same(got, want, stats, block, maxiter):
    (x, rs, rs0, it, hist), r = got
    (xr, rsr, rs0r, itr, histr), rr = want
    assert it == itr
    assert _same(x, xr) and _same(rs, rsr) and _same(rs0, rs0r)
    assert _same(r, rr)  # the residual the frozen iterations left
    H = min(maxiter + 1, gl.HIST_MAX)
    assert hist.shape == (H,)
    n = min(it + 1, H)
    assert _same(torch.from_numpy(hist[:n]), histr[:n])
    assert np.isnan(hist[n:]).all()  # nothing written past the last iteration
    # whole blocks, the last one holding the first frozen iteration
    assert stats["loop"] == "eager" and stats["block"] == block
    assert stats["device_iterations"] == block * (it // block + 1)


@pytest.fixture(scope="module")
def full_histories(systems):
    """Each body's reference residual history to a tiny tolerance: the
    tolerances that stop it after a chosen iteration come from it."""
    out = {}
    for body in BODIES:
        if body.startswith("gmg"):
            g = systems["gmg"]
            out[body] = _ref_gmg(g["h"], 1e-14, 60, g["b"], g["x0"], body == "gmg_stencil")[0][4].numpy()
        else:
            c = systems["cg"]
            out[body] = _ref_cg(c["dA"], 1e-14, 200, body, c["b"], c["x0"])[0][4].numpy()
    return out


def _tol_stopping_at(hist, position, block):
    """A tolerance whose loop stops after m iterations with m % block at
    `position` ("first" 0, "middle" block // 2, "last" block - 1), m >= 1:
    the threshold lies between hist[m] and every earlier entry (m a new
    low of the history)."""
    want = {"first": 0, "middle": block // 2, "last": block - 1}[position]
    scale = max(1.0, hist[0])
    for m in range(1, len(hist)):
        if m % block == want and hist[m] < hist[:m].min():
            return float(np.sqrt(hist[m] * hist[:m].min()) / scale), m
    raise AssertionError(f"no new low of the history at {want} mod {block}")


# ---------------------------------------------------------------------------
# the loops against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("position", ["first", "middle", "last"])
@pytest.mark.parametrize("block", [1, 3, 8])
@pytest.mark.parametrize("body", BODIES)
def test_loop_matches_reference_at_every_stop_position(systems, full_histories, body, block, position):
    tol, m = _tol_stopping_at(full_histories[body], position, block)
    maxiter = 500
    got, want, stats = _solve(systems, body, tol, maxiter, block)
    assert got[0][3] == m
    _assert_same(got, want, stats, block, maxiter)


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("body", BODIES)
def test_loop_maxiter_cap(systems, body, block):
    maxiter = 5
    got, want, stats = _solve(systems, body, 1e-14, maxiter, block)
    assert got[0][3] == maxiter
    _assert_same(got, want, stats, block, maxiter)


@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("body", BODIES)
def test_loop_zero_iterations_from_a_converged_start(systems, body, block):
    got, want, stats = _solve(systems, body, 1e-6, 50, block, from_exact=True)
    assert got[0][3] == 0
    _assert_same(got, want, stats, block, 50)
    x0 = systems["gmg" if body.startswith("gmg") else "cg"]["xe"]
    assert torch.equal(got[0][0], x0)


@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("body", ["fused", "standard", "pipelined"])
def test_cg_breakdown_on_a_non_finite_rs(systems, body, block):
    """The zero operator: p.q = 0, alpha = inf, r turns NaN after one
    iteration and the loop stops on the non-finite rs; the frozen
    iterations after it leave every NaN where it was."""
    got, want, stats = _solve(systems, body, 1e-8, 50, block, zero_op=True)
    assert got[0][3] == 1 and not torch.isfinite(got[0][1])
    _assert_same(got, want, stats, block, 50)


@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("stencil", [True, False], ids=["stencil", "structured"])
def test_gmg_breakdown_on_rz_zero(systems, monkeypatch, stencil, block):
    """A zero preconditioner: rz = 0 in the first iteration, and the loop
    stops on rz_prev = 0."""
    g = systems["gmg"]
    zero_vcycle = lambda r: torch.zeros_like(r)  # noqa: E731
    monkeypatch.setattr(gpu_gmg, "make_vcycle", lambda h, dh, plain=False: zero_vcycle)
    fn = gpu_gmg.make_gmg_pcg_fn(g["h"], CPU, 1e-8, 50, stencil=stencil, block=block)
    got = (fn(g["b"], g["x0"]), fn.loop.base["r"])
    want = _ref_gmg(g["h"], 1e-8, 50, g["b"], g["x0"], stencil, vcycle=zero_vcycle)
    assert got[0][3] == 1
    _assert_same(got, want, fn.stats, block, 50)


def test_loop_runs_again_on_its_buffers(systems):
    """A second solve through one function restarts from its own init and
    leaves the first solve's returned tensors as they were."""
    c = systems["cg"]
    fn = make_cg_fn(c["dA"], 1e-10, 200, block=3)
    first = fn(c["b"], c["x0"])
    keep = first[0].clone()
    second = fn(c["b"], torch.zeros_like(c["x0"]))
    assert torch.equal(first[0], keep)
    assert first[3] != second[3] or not torch.equal(first[0], second[0])
    again = fn(c["b"], c["x0"])
    assert torch.equal(again[0], first[0]) and again[3] == first[3]


def test_launch_tallies_follow_device_iterations(systems, monkeypatch):
    """Fused CG: the direction-fold SpMV and the sweep once per iteration
    the device ran (frozen ones included), the plain SpMV once."""
    calls = {"pfold": 0, "sweep": 0, "spmv": 0}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    counting(dia, "dia_coded_spmv_pfold_plain", "pfold")
    counting(dia, "dia_coded_spmv_plain", "spmv")
    counting(sw, "cg_sweep_plain", "sweep")
    c = systems["cg"]
    fn = make_cg_fn(c["dA"], 1e-8, 500, plain=True, block=8)
    it = fn(c["b"], c["x0"])[3]
    dev_it = fn.stats["device_iterations"]
    assert dev_it == 8 * (it // 8 + 1)
    assert calls == {"pfold": dev_it, "sweep": dev_it, "spmv": 1}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's fused and pipelined CG at 10^3 and GMG-PCG at
    16^3 (decoupled, coarse_threshold=100) on pa.tpu, (2,2,2) parts."""

    def driver(parts):
        A, b, xe, x0 = pa.assemble_poisson(parts, CG_NS)
        _, info_f = pa.cg(A, b, x0=x0, tol=1e-10, maxiter=500)
        _, info_p = pa.cg(A, b, x0=x0, tol=1e-10, maxiter=500, pipelined=True)
        Ag, bg, _, _ = pa.assemble_poisson(parts, GMG_NS)
        Ah, bh = pa.decouple_dirichlet(Ag, bg)
        h = pa.gmg_hierarchy(parts, Ah, GMG_NS, coarse_threshold=100)
        _, info_g = pa.pcg(Ah, bh, minv=h, tol=1e-10)
        return {"fused": info_f, "pipelined": info_p, "gmg": info_g}

    return pa.prun(driver, pa.tpu, PARTS)


@pytest.mark.parametrize("body", BODIES)
def test_iterations_and_history_match_jax(systems, jax_runs, body):
    """Every body takes the JAX package's iterations (the standard body the
    fused one's: one recurrence); the history agrees to rtol=1e-10."""
    if body.startswith("gmg"):
        g = systems["gmg"]
        fn = gpu_gmg.make_gmg_pcg_fn(g["h"], CPU, 1e-10, 4 * 16**3, stencil=body == "gmg_stencil")
        out = fn(g["b"], g["x0"])
        info = jax_runs["gmg"]
    else:
        c = systems["cg"]
        fn = make_cg_fn(c["dA"], 1e-10, 500, fused=body == "fused", pipelined=body == "pipelined")
        out = fn(c["b"], c["x0"])
        info = jax_runs["pipelined" if body == "pipelined" else "fused"]
    it = out[3]
    assert it == info["iterations"] > 0
    want = np.asarray(info["residuals"])[: it + 1]
    np.testing.assert_allclose(out[4][: it + 1], want, rtol=1e-10, atol=1e-15 * want[0])


def test_gpu_cg_info_cuts_the_history(systems):
    """The public path hands `_run_krylov` the H-entry history; the info
    keeps iterations + 1 entries and the loop's stats."""

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, CG_NS)
        return pt.cg(A, b, x0=x0, tol=1e-10, maxiter=500)[1]

    info = pt.prun(driver, CPU, PARTS)
    assert len(info["residuals"]) == info["iterations"] + 1
    assert np.isfinite(info["residuals"]).all()
    loop = info["device_loop"]
    assert loop["loop"] == "eager" and loop["block"] == gl.CG_BLOCK
    assert loop["device_iterations"] == gl.CG_BLOCK * (info["iterations"] // gl.CG_BLOCK + 1)


# ---------------------------------------------------------------------------
# the sweep's plain version
# ---------------------------------------------------------------------------


def _frames(rng, dtype, P=3, n=5000, w=5011, wq=5003):
    mk = lambda shape: torch.from_numpy(rng.standard_normal(shape)).to(dtype)  # noqa: E731
    return mk((P, w)), mk((P, w)), mk((P, w)), mk((P, wq))


@pytest.mark.parametrize("mode", ["x_and_r", "r_only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweep_plain_matches_eager_update(dtype, mode):
    dia.reset_launches()
    rng = np.random.default_rng(3)
    o0, n = 4, 4999  # an odd band inside the frames, the last chunk ragged
    x, r, p, q = _frames(rng, dtype)
    alpha = torch.tensor(0.3125, dtype=dtype)
    band = slice(o0, o0 + n)
    x_want, r_want = x.clone(), r.clone()
    if mode == "x_and_r":
        x_want[:, band] = x[:, band] + alpha * p[:, band]
    r_want[:, band] = r[:, band] + (-alpha) * q[:, band]
    part = sw.sweep_partials(r, n)
    kw = {"x": x, "p": p} if mode == "x_and_r" else {}
    rs = sw.cg_sweep(r, q, alpha, ONE, part, o0, n, **kw)
    assert torch.equal(x, x_want) and torch.equal(r, r_want)
    ref = float(np.sum(r_want[:, band].numpy().astype(np.float64) ** 2))
    # f32: 8 sequential adds a thread, then halving trees over ~10^4 terms
    rtol = 1e-12 if dtype == torch.float64 else 2e-5
    assert abs(float(rs) - ref) <= rtol * ref
    assert not any(dia.LAUNCHES.values())


def _emulate(rn: np.ndarray, G: int) -> np.ndarray:
    """csrc/cg_sweep.cu's order, thread by thread, in numpy at the band's
    dtype: each chunk's per-thread sums (elements g*C + k*T + t, skipped
    past n), the halving tree; then the fold's per-thread sums over the
    partials, its tree, and the parts left to right."""
    T, K, C, F = sw.THREADS, sw.ITEMS, sw.CHUNK, sw.FOLD_THREADS
    P, n = rn.shape
    dt = rn.dtype

    def tree(v):
        v = v.copy()
        h = len(v) // 2
        while h >= 1:
            v[:h] = v[:h] + v[h : 2 * h]
            h //= 2
        return v[0]

    sums = []
    for p in range(P):
        part = np.zeros(G, dtype=dt)
        for g in range(G):
            acc = np.zeros(T, dtype=dt)
            for k in range(K):
                i = g * C + k * T + np.arange(T)
                ok = i < n
                acc[ok] = acc[ok] + rn[p, i[ok]] * rn[p, i[ok]]
            part[g] = tree(acc)
        acc = np.zeros(F, dtype=dt)
        for j in range(0, G, F):
            m = min(F, G - j)
            acc[:m] = acc[:m] + part[j : j + m]
        sums.append(tree(acc))
    total = sums[0]
    for s in sums[1:]:
        total = dt.type(total + s)
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2047, 2049, 3 * 2048 * 256 + 5], ids=["n1", "n2047", "n2049", "big"])
def test_sweep_plain_order_is_the_kernels(dtype, n):
    rng = np.random.default_rng(n)
    P = 2
    r = torch.from_numpy(rng.standard_normal((P, n + 3))).to(dtype)
    q = torch.from_numpy(rng.standard_normal((P, n + 1))).to(dtype)
    part = sw.sweep_partials(r, n)
    rs = sw.cg_sweep_plain(r, q, torch.tensor(0.75, dtype=dtype), ONE, part, 1, n)
    want = _emulate(r[:, 1 : 1 + n].numpy(), sw.chunks(n))
    assert _same(rs, torch.tensor(want))


@pytest.mark.parametrize("mode", ["x_and_r", "r_only"])
def test_sweep_plain_with_live_zero_writes_nothing(mode):
    rng = np.random.default_rng(5)
    x, r, p, q = _frames(rng, torch.float64)
    x[0, 7] = float("nan")
    p[1, 9] = float("nan")  # x + 0*p would be NaN here: the freeze is not a zero alpha
    alpha = torch.tensor(float("inf"), dtype=torch.float64)
    part = sw.sweep_partials(r, 5000)
    kw = {"x": x, "p": p} if mode == "x_and_r" else {}
    rs1 = sw.cg_sweep_plain(r, q, torch.tensor(0.5, dtype=torch.float64), ONE, part, 0, 5000, **kw)
    before = [t.clone() for t in (x, r, p, q, part)]
    rs0 = sw.cg_sweep_plain(r, q, alpha, torch.zeros((), dtype=torch.int32), part, 0, 5000, **kw)
    for t, b in zip((x, r, p, q, part), before):
        assert _same(t, b)
    assert _same(rs0, rs1)  # the fold of the unchanged partials: rs again


def test_axpy_plain_with_live_zero_leaves_the_solution():
    def driver(parts):
        A = pt.assemble_poisson(parts, (8, 8, 8))[0]
        return device_matrix(A, parts.backend)

    dA = pt.prun(driver, CPU, PARTS)
    rng = np.random.default_rng(9)
    W = dA.col_layout.W
    x, xacc, pprev = (torch.from_numpy(rng.standard_normal((8, W))) for _ in range(3))
    alpha = torch.tensor(-0.625, dtype=torch.float64)
    y_free = dia.dia_coded_spmv_axpy_plain(dA.coded, x, xacc.clone(), pprev, alpha, dA.row_layout.W)
    for live, changed in ((0, False), (1, True)):
        xa = xacc.clone()
        y = dia.dia_coded_spmv_axpy(dA.coded, x, xa, pprev, alpha, dA.row_layout.W,
                                    torch.tensor(live, dtype=torch.int32))
        assert torch.equal(y, y_free)
        assert torch.equal(xa, xacc) != changed
    xa = xacc.clone()
    dia.dia_coded_spmv_axpy(dA.coded, x, xa, pprev, alpha, dA.row_layout.W, ONE)
    xb = xacc.clone()
    dia.dia_coded_spmv_axpy(dA.coded, x, xb, pprev, alpha, dA.row_layout.W)
    assert torch.equal(xa, xb)


# ---------------------------------------------------------------------------
# DeviceLoop
# ---------------------------------------------------------------------------


def test_device_loop_writes_back_rebound_state():
    """A step that swaps two buffers and counts down: the swap survives
    the end of every block (a source that is another key's buffer is read
    before it is overwritten), and the loop runs whole blocks."""

    def step(S):
        go = (S["n"] > 0).to(torch.int32) * S["live"]
        return dict(S, a=S["b"], b=S["a"], n=S["n"] - go, live=go)

    for block in (1, 2, 3):
        loop = gl.DeviceLoop(step, block)
        init = {"a": torch.zeros(3), "b": torch.ones(3), "n": torch.tensor(4), "live": ONE.clone()}
        S, dev_it = loop.run(init)
        # 4 live steps and 1 frozen one (still swapping: a swap is no frozen write)
        assert dev_it == block * (4 // block + 1) and int(S["n"]) == 0
        swaps = dev_it
        assert torch.equal(S["a"], torch.full((3,), float(swaps % 2)))
        assert torch.equal(S["b"], torch.full((3,), float(1 - swaps % 2)))
        buf = S["a"]
        S2, _ = loop.run(init)
        assert S2["a"] is buf  # the buffers are reused
        assert loop.stats == {"loop": "eager", "block": block, "device_iterations": dev_it, "replays": 0,
                              "capture_s": None}


def test_history_is_fixed_shape_and_capped():
    h = gl.history(torch.tensor(2.0, dtype=torch.float64), 3)
    assert h.shape == (4,) and h[0] == 2.0 and torch.isnan(h[1:]).all()
    for it in (1, 2, 3, 4, 5):
        gl.record(h, torch.tensor(it, dtype=torch.int32), ONE, torch.tensor(float(10 * it), dtype=torch.float64))
    assert h.tolist() == [2.0, 10.0, 20.0, 50.0]  # past H - 1 the last entry is rewritten
    gl.record(h, torch.tensor(2, dtype=torch.int32), torch.zeros((), dtype=torch.int32),
              torch.tensor(-1.0, dtype=torch.float64))
    assert h.tolist() == [2.0, 10.0, 20.0, 50.0]  # a frozen step writes nothing new
    assert gl.history(torch.tensor(1.0), 10**6).shape == (gl.HIST_MAX,)
