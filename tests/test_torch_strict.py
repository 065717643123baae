"""Strict-bits mode of the port (``strict=True``, the JAX package's
``PA_TPU_STRICT_BITS=1``) against the JAX package's.

The gate (BASELINE.md): strict CG on the 3-D Poisson driver, 6^3 on
(2,2,2) parts, f64, bit for bit the sequential oracle. Held here:

* the port's strict CG on ``GPUBackend(device="cpu")`` (the ELL lowering,
  E1's and E3's plain versions), the port's sequential strict CG and the
  JAX package's sequential strict CG: the same iterations, residual
  history bits and solution bits (also Jacobi PCG, and the tet-elasticity
  operator);
* one strict SpMV on the card's layout bit for bit the JAX package's
  strict SpMV and the port's host product; the port's strict `csr_spmv`
  bit for bit the JAX package's;
* E3's plain version bit for bit the JAX package's `pairwise_sum` of the
  rounded products, folded left to right, on random, odd-length and -0.0
  inputs; the port's `pairwise_sum` the JAX package's;
* a numpy emulation of E3's one-launch kernel (`csrc/pairwise_dot.cu`:
  a warp's 32 R products (R = 16 float32, 8 float64) as 4 rows of 32
  16-byte vectors, each vector's tree in registers, each row's 32 vectors
  by shuffles at ascending offsets, lane 0's rows pairwise, the 8 warps'
  roots the same way, every add whose span passes m left out; the last
  CTA's tree over each part's partials, a warp a part up to 32 of them,
  else a thread a run of them in chunks of 8 joined by a binary-counter
  stack; the parts added left to right)
  at the real CTA size, bit for bit `pairwise_sum` and the plain version on n from 0 to
  past 2^20 (the last CTA then takes runs of two partials), 1, 3 and 8
  parts, a misaligned band offset, products that cancel and signed zeros;
  a descending-offset butterfly in the warp differs (the test has teeth);
* the block form of E3 (`pairwise_dot_block`), its schedule emulated in
  numpy (a thread's run of 4 f32 / 2 f64 elements of each column, the
  lanes, the warps, the last CTA's tree): every column `pairwise_sum`'s
  bits;
* strict block CG and Jacobi PCG (``cg/pcg(A, B=..., strict=True)``,
  standard and fused bodies, ragged K = 2, 3, 5) on the decoupled
  elasticity system carried from the JAX package: every column's
  iterations, residual history bits and solution bits the JAX package's
  sequential strict solo solve of that column;
* the repair this slice needed first: the device loop's square roots
  (`gpu_loop.sqrt_rn`) bit for bit NumPy's;
* default mode unchanged: the Poisson operator keeps the coded lowering;
* strict GMG-PCG (``pcg(A, b, minv=hierarchy, strict=True)``) on the
  device path and the sequential backend against the JAX package's
  ``pa.tpu`` and ``pa.sequential`` under ``PA_TPU_STRICT_BITS=1``, on
  (12,12,12) and (10,9,7), decoupled, coarse_threshold=30: equal
  iterations, histories and solutions to ``GMG_STRICT_RTOL`` (not bits:
  neither package's V-cycle is the host's); every level on ELL and the
  generic plan; another ``lowering`` raises.
"""
import os

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_poisson as jax_assemble_poisson
from partitionedarrays_jl_tpu.ops.sparse import CSRMatrix as JaxCSR
from partitionedarrays_jl_tpu.ops.sparse import csr_spmv as jax_csr_spmv
from partitionedarrays_jl_tpu.parallel.tpu import DeviceVector as JaxDeviceVector
from partitionedarrays_jl_tpu.parallel.tpu import device_matrix as jax_device_matrix
from partitionedarrays_jl_tpu.parallel.tpu import make_spmv_fn as jax_make_spmv_fn
from partitionedarrays_jl_tpu.utils.helpers import pairwise_sum as jax_pairwise_sum
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import irregular as irr
from partitionedarrays_jl_tpu_torch.ops.sparse import CSRMatrix, csr_spmv
from partitionedarrays_jl_tpu_torch.parallel import gpu_loop as gl
from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, GPUBackend, device_matrix, make_spmv_fn
from partitionedarrays_jl_tpu_torch.utils.helpers import pairwise_sum

CPU = GPUBackend(device="cpu")


@pytest.fixture
def strict_env(monkeypatch):
    """The JAX package in strict mode, assembling the Poisson operator on
    its COO path, the one the port has: its box fast path
    (``PA_TPU_STENCIL_FAST``, native code) numbers each part's ghost
    columns in face-slab order instead of first touch, which reorders the
    A_oh terms a strict row folds (the same values, other bits)."""
    monkeypatch.setenv("PA_TPU_STRICT_BITS", "1")
    monkeypatch.setenv("PA_TPU_STENCIL_FAST", "0")
    yield


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _jax_fdm_cg(parts, ns):
    A, b, xe, x0 = jax_assemble_poisson(parts, ns)
    x, info = pa.cg(A, b, x0=x0, tol=1e-8, maxiter=400)
    return pa.gather_pvector(x), info["iterations"], np.asarray(info["residuals"])


def _port_fdm(parts, ns, solver):
    """The Poisson system with b = A x̂ taken in strict mode, as the JAX
    package assembles it under PA_TPU_STRICT_BITS=1, then the strict solve."""
    A, _, xe, x0 = pt.assemble_poisson(parts, ns)
    b = A.mul_into(pt.PVector.full(0.0, A.rows), xe, strict=True)
    if solver == "cg":
        x, info = pt.cg(A, b, x0=x0, tol=1e-8, maxiter=400, strict=True)
    else:
        x, info = pt.pcg(A, b, x0=x0, tol=1e-8, maxiter=400, strict=True)
    return pt.gather_pvector(x), info


@pytest.mark.parametrize("ns", [(6, 6, 6), (9, 7, 8)], ids=["6^3", "9x7x8"])
def test_strict_cg_bitwise_three_ways(strict_env, ns):
    """The gate on the port: GPU backend (CPU), port sequential and JAX
    sequential strict CG agree bit for bit (iterations, history, x)."""
    xj, itj, hj = pa.prun(_jax_fdm_cg, pa.sequential, (2, 2, 2), ns)
    xs, info_s = pt.prun(_port_fdm, pt.sequential, (2, 2, 2), ns, "cg")
    xg, info_g = pt.prun(_port_fdm, CPU, (2, 2, 2), ns, "cg")
    assert info_g["lowering"] == "ell" and info_g["strict"] and info_g["cg_body"] == "standard"
    assert info_s["cg_body"] == "host"
    assert itj == info_s["iterations"] == info_g["iterations"]
    assert _bits(hj) == _bits(info_s["residuals"]) == _bits(info_g["residuals"])
    assert _bits(xj) == _bits(xs) == _bits(xg)


def test_strict_pcg_bitwise(strict_env):
    """Strict Jacobi PCG: the GPU backend (CPU) against the port's and the
    JAX package's sequential loops, bit for bit."""

    def jax_pcg(parts):
        A, b, xe, x0 = jax_assemble_poisson(parts, (6, 6, 6))
        x, info = pa.pcg(A, b, x0=x0, tol=1e-8, maxiter=400)
        return pa.gather_pvector(x), info["iterations"], np.asarray(info["residuals"])

    xj, itj, hj = pa.prun(jax_pcg, pa.sequential, (2, 2, 2))
    xs, info_s = pt.prun(_port_fdm, pt.sequential, (2, 2, 2), (6, 6, 6), "pcg")
    xg, info_g = pt.prun(_port_fdm, CPU, (2, 2, 2), (6, 6, 6), "pcg")
    assert itj == info_s["iterations"] == info_g["iterations"]
    assert _bits(hj) == _bits(info_s["residuals"]) == _bits(info_g["residuals"])
    assert _bits(xj) == _bits(xs) == _bits(xg)


@pytest.mark.parametrize("body", ["fused", "pipelined"])
def test_strict_other_bodies_follow_the_oracle(body):
    """Asked for explicitly, the fused and the pipelined body also run in
    strict mode (eager folds, each product rounded, E3 dots): the oracle's
    iterations and history bits; the fused body's solution bits too (the
    pipelined body applies x's updates one iteration late, in the same
    order, so its x is the oracle's as well)."""

    def drive(parts, strict_kw):
        A, b, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        x, info = pt.cg(A, b, x0=x0, tol=1e-8, maxiter=400, strict=True, **strict_kw)
        return pt.gather_pvector(x), info

    xs, info_s = pt.prun(drive, pt.sequential, (2, 2, 2), {})
    kw = {"fused": True} if body == "fused" else {"pipelined": True}
    xg, info_g = pt.prun(drive, CPU, (2, 2, 2), kw)
    assert info_g["cg_body"] == body and info_g["iterations"] == info_s["iterations"]
    assert _bits(info_s["residuals"]) == _bits(info_g["residuals"])
    assert _bits(xs) == _bits(xg)


def test_strict_elasticity_pcg_bitwise():
    """Strict Jacobi PCG on the tet-elasticity operator (forced to ELL from
    its SD default) on 4 parts: the GPU backend (CPU) against the port's
    sequential loop, bit for bit."""

    def drive(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (4, 4, 4))
        x, info = pt.pcg(A, b, x0=x0, tol=1e-12, maxiter=500, strict=True)
        return pt.gather_pvector(x), info

    xs, info_s = pt.prun(drive, pt.sequential, 4)
    xg, info_g = pt.prun(drive, CPU, 4)
    assert info_g["lowering"] == "ell" and info_g["iterations"] == info_s["iterations"]
    assert _bits(info_s["residuals"]) == _bits(info_g["residuals"]) and _bits(xs) == _bits(xg)


def test_strict_spmv_bitwise_jax(strict_env):
    """One strict SpMV (boundary rows mix owned and ghost terms) on the
    port's ELL lowering: bit for bit the JAX package's strict device SpMV
    and the port's strict host product."""
    ns = (5, 4, 3)

    def jax_build(parts):
        A, b, xe, x0 = jax_assemble_poisson(parts, ns)
        backend = parts.backend
        dA = jax_device_matrix(A, backend)
        assert dA.dia_mode is None
        dx = JaxDeviceVector.from_pvector(xe, backend, dA.col_layout)
        y = JaxDeviceVector(jax_make_spmv_fn(dA)(dx.data), A.rows, dA.row_layout, backend).to_pvector()
        return pa.gather_pvector(y)

    y_jax = pa.prun(jax_build, pa.tpu, (2, 2, 2))

    def port(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        dA = device_matrix(A, parts.backend, strict=True)
        assert dA.lowering == "ell" and dA.col_layout.box_info is None
        dx = DeviceVector.from_pvector(xe, parts.backend, dA.col_layout)
        y = DeviceVector(make_spmv_fn(dA)(dx.data), A.rows, dA.row_layout, parts.backend).to_pvector()
        host = A.mul_into(pt.PVector.full(0.0, A.rows), xe, strict=True)
        return pt.gather_pvector(y), pt.gather_pvector(host)

    y_dev, y_host = pt.prun(port, CPU, (2, 2, 2))
    assert _bits(y_dev) == _bits(y_host) == _bits(y_jax)


@pytest.mark.parametrize("m,n", [(7, 9), (40, 33), (1, 1)])
def test_strict_csr_spmv_bitwise_jax(strict_env, m, n):
    """The port's strict host csr_spmv (the ELL fold) against the JAX
    package's on one random CSR, with alpha/beta and signed zeros."""
    rng = np.random.default_rng(m * n)
    dense = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.4)
    dense[0, 0] = -0.0 if m > 1 else dense[0, 0]
    r, c = np.nonzero(dense != 0)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=m))])
    x = rng.standard_normal(n)
    x[::3] = -0.0
    A = CSRMatrix(indptr, c, dense[r, c], (m, n))
    J = JaxCSR(indptr, c, dense[r, c], (m, n))
    assert _bits(csr_spmv(A, x, strict=True)) == _bits(jax_csr_spmv(J, x))
    y0 = rng.standard_normal(m)
    got = csr_spmv(A, x, y0.copy(), alpha=0.5, beta=-2.0, strict=True)
    assert _bits(got) == _bits(jax_csr_spmv(J, x, y0.copy(), alpha=0.5, beta=-2.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 64, 1000, 2049, 10007])
def test_pairwise_dot_plain_bitwise_jax(n, dtype):
    """E3's plain version over three parts: bit for bit the JAX package's
    `pairwise_sum` of each part's rounded products, then the parts added
    left to right; the port's `pairwise_sum` equals the JAX package's."""
    rng = np.random.default_rng(n + 11)
    P, o0 = 3, 2
    a = rng.standard_normal((P, o0 + n + 4)).astype(dtype)
    b = rng.standard_normal((P, o0 + n + 4)).astype(dtype)
    a[:, o0::5] = -0.0
    got = irr.pairwise_dot_plain(torch.from_numpy(a), torch.from_numpy(b), o0, n)
    parts = [jax_pairwise_sum(a[p, o0 : o0 + n] * b[p, o0 : o0 + n]) for p in range(P)]
    acc = parts[0]
    for v in parts[1:]:
        acc = acc + v
    assert _bits(got.numpy()) == np.asarray(acc, dtype=dtype).tobytes()
    for p in range(P):
        t = a[p, o0 : o0 + n] * b[p, o0 : o0 + n]
        assert np.asarray(pairwise_sum(t)).tobytes() == np.asarray(jax_pairwise_sum(t)).tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_pairwise_dot_plain_signed_zero(n):
    """An all -0.0 product keeps its sign through the tree exactly where
    numpy's does (a +0.0 pad turns it +0.0), E3's plain version and the
    JAX package's pairwise_sum alike."""
    a = -np.zeros((1, n))
    b = np.ones((1, n))
    got = irr.pairwise_dot_plain(torch.from_numpy(a), torch.from_numpy(b), 0, n)
    want = jax_pairwise_sum(a[0] * b[0])
    assert np.signbit(float(got)) == np.signbit(want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_loop_sqrt_is_correctly_rounded(dtype):
    """The repair: the device loops take their residual norms through
    `gpu_loop.sqrt_rn`, bit for bit NumPy's sqrt (PyTorch's vectorized CPU
    sqrt is an ulp off on about 1% of float64 values, which put the CPU
    device loop's history an ulp away from the host loop's), on 0-d and
    (K,) tensors."""
    v = (np.random.default_rng(4).random(20000) * 10.0 ** np.arange(-6, 6).repeat(2000)[:20000]).astype(dtype)
    assert _bits(gl.sqrt_rn(torch.from_numpy(v)).numpy()) == _bits(np.sqrt(v))
    for x in v[:200]:
        assert _bits(gl.sqrt_rn(torch.tensor(x)).numpy()) == _bits(np.sqrt(x))


def test_default_mode_unaffected():
    """Without ``strict`` the Poisson operator keeps the coded lowering on
    the box layout; with it, the same operator is a second, ELL entry of
    the lowering cache on the generic layout."""

    def drive(parts):
        A = pt.assemble_poisson(parts, (8, 8, 8))[0]
        d0 = device_matrix(A, parts.backend)
        d1 = device_matrix(A, parts.backend, strict=True)
        assert device_matrix(A, parts.backend) is d0 and device_matrix(A, parts.backend, strict=True) is d1
        return d0.dia_mode, d0.lowering, d0.strict, d1.lowering, d1.strict, d1.col_layout.box_info is None

    assert pt.prun(drive, CPU, (2, 2, 2)) == ("coded", "coded", False, "ell", True, True)


# ---------------------------------------------------------------------------
# strict GMG-PCG (tpu_gmg.py:886 under PA_TPU_STRICT_BITS=1)
# ---------------------------------------------------------------------------

#: strict GMG-PCG agrees with the sequential strict solve (and the JAX
#: package's) to rounding, not in bits: the V-cycle's products are not the
#: host's on either side. Solutions to this relative 2-norm, histories to
#: this relative to their first entry
GMG_STRICT_RTOL = 1e-12
GMG_STRICT_CASES = {"12^3": (12, 12, 12), "10x9x7": (10, 9, 7)}


def _jax_strict_gmg(parts, ns):
    A, b, xe, x0 = jax_assemble_poisson(parts, ns)
    Ah, bh = pa.decouple_dirichlet(A, b)
    h = pa.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30)
    x, info = pa.pcg(Ah, bh, minv=h, tol=1e-10)
    return pa.gather_pvector(x), info["iterations"], np.asarray(info["residuals"])


def _port_strict_gmg(parts, ns):
    A, _, xe, x0 = pt.assemble_poisson(parts, ns)
    b = A.mul_into(pt.PVector.full(0.0, A.rows), xe, strict=True)
    Ah, bh = pt.decouple_dirichlet(A, b)
    h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30)
    x, info = pt.pcg(Ah, bh, minv=h, tol=1e-10, strict=True)
    return pt.gather_pvector(x), info


def _close(x, hist, x_ref, hist_ref):
    assert np.linalg.norm(x - x_ref) <= GMG_STRICT_RTOL * np.linalg.norm(x_ref)
    np.testing.assert_allclose(hist, hist_ref, rtol=0, atol=GMG_STRICT_RTOL * hist_ref[0])


@pytest.fixture(scope="module", params=sorted(GMG_STRICT_CASES))
def strict_gmg_case(request):
    """Both packages' strict GMG-PCG on (2,2,2) parts, decoupled,
    coarse_threshold=30: the JAX package on ``pa.tpu`` and ``pa.sequential``,
    the port on ``GPUBackend(device="cpu")`` and its sequential backend."""
    ns = GMG_STRICT_CASES[request.param]
    mp = pytest.MonkeyPatch()
    mp.setenv("PA_TPU_STRICT_BITS", "1")
    mp.setenv("PA_TPU_STENCIL_FAST", "0")
    try:
        jax = {"gpu": pa.prun(_jax_strict_gmg, pa.tpu, (2, 2, 2), ns),
               "seq": pa.prun(_jax_strict_gmg, pa.sequential, (2, 2, 2), ns)}
    finally:
        mp.undo()
    port = {"gpu": pt.prun(_port_strict_gmg, CPU, (2, 2, 2), ns),
            "seq": pt.prun(_port_strict_gmg, pt.sequential, (2, 2, 2), ns)}
    return jax, port


@pytest.mark.parametrize("side", ["gpu", "seq"])
def test_strict_gmg_pcg_matches_jax(strict_gmg_case, side):
    """The port's strict GMG-PCG on the device path (against ``pa.tpu``) and
    on its sequential backend (against ``pa.sequential``): equal iterations,
    histories and solutions to `GMG_STRICT_RTOL`; the device path also
    against the port's sequential strict solve, and its info names the
    device loop, the ELL lowering and strict mode."""
    jax, port = strict_gmg_case
    x, info = port[side]
    xj, itj, hj = jax[side]
    assert info["converged"] and info["iterations"] == itj
    _close(x, np.asarray(info["residuals"]), xj, hj)
    if side == "gpu":
        xs, info_s = port["seq"]
        assert info["iterations"] == info_s["iterations"] and "device_loop" not in info_s
        _close(x, np.asarray(info["residuals"]), xs, np.asarray(info_s["residuals"]))
        assert info["lowering"] == "ell" and info["strict"]
        assert info["device_loop"]["loop"] == "eager" and info["device_loop"]["device_iterations"] >= itj


def test_strict_gmg_pcg_stages_ell_on_the_generic_plan():
    """Every level operator and every S of the strict hierarchy is the ELL
    lowering on the generic plan; no level takes the stencil route; the
    default hierarchy is a separate cache entry."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (12, 12, 12))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=30)
        dh = gpu_gmg.device_hierarchy(h, CPU, strict=True)
        d0 = gpu_gmg.device_hierarchy(h, CPU)
        return ([(l["dA"].lowering, l["dS"].lowering, l["dA"].col_layout.box_info is None, gpu_gmg.route(l))
                 for l in dh["levels"]], [gpu_gmg.route(l) for l in d0["levels"]], dh is d0)

    strict, default, same = pt.prun(drive, CPU, (2, 2, 2))
    assert all(s[:3] == ("ell", "ell", True) and s[3] != "stencil" for s in strict)
    assert "stencil" in default and not same


def test_gmg_pcg_other_lowering_raises():
    """`lowering=` with a hierarchy raised on the device path until the
    solver family was ported; now it names the first non-band lowering of
    every level's staging. The levels here are bands, so the default and
    the strict solves are those of lowering="auto" bit for bit."""

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (8, 8, 8))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (8, 8, 8), coarse_threshold=50)
        out = []
        for strict, lowering in ((False, "bsr"), (True, "ell")):
            x0, i0 = pt.pcg(Ah, bh, minv=h, strict=strict)
            x1, i1 = pt.pcg(Ah, bh, minv=h, lowering=lowering, strict=strict)
            out.append(i0["iterations"] == i1["iterations"]
                       and pt.gather_pvector(x0).tobytes() == pt.gather_pvector(x1).tobytes())
        return out

    assert pt.prun(drive, CPU, (2, 2, 2)) == [True, True]


# ---------------------------------------------------------------------------
# E3: the one-launch kernel's order, emulated
# ---------------------------------------------------------------------------

#: csrc/pairwise_dot.cu: threads a CTA and elements a thread
PW_THREADS, PW_RUN = 256, {np.float32: 16, np.float64: 8}


def _pairs(v, span, m, lanes, descending=False):
    """The shuffle stage over the last axis (32 lanes): at ascending
    offsets the lanes that are multiples of 2 * off add the value off lanes
    up, while the result's span stays within m (``descending``: the
    butterfly at offsets 16 .. 1, lane L < off adding lane L + off)."""
    v = v.copy()
    offs = [o for o in (1, 2, 4, 8, 16) if o < lanes]
    for off in (offs[::-1] if descending else offs):
        if span * 2 * off > m:
            continue
        idx = np.arange(0, off) if descending else np.arange(0, 32, 2 * off)
        v[..., idx] = v[..., idx] + v[..., idx + off]
    return v


def _run_tree(src):
    """run_tree: chunks of up to 8 partials, each chunk's tree, the chunks
    joined by a binary-counter stack in order."""
    chunk = min(len(src), 8)
    st, top = {}, 0
    for c in range(len(src) // chunk):
        v = src[c * chunk : (c + 1) * chunk].copy()
        s = 2
        while s <= chunk:
            v[::s] = v[::s] + v[s // 2 :: s]
            s *= 2
        u, k = v[0], 0
        while (c >> k) & 1:
            u = st[k] + u
            k += 1
        st[k], top = u, k
    return st[top]


def _cta_tree(src, count):
    """cta_tree: runs of r = count / 256 partials (1 if fewer), the warps'
    shuffles, the 8 warps' roots in warp 0."""
    r = count // PW_THREADS if count > PW_THREADS else 1
    lanes = np.zeros(PW_THREADS, dtype=src.dtype)
    for t in range(PW_THREADS):
        if t * r < count:
            lanes[t] = _run_tree(src[t * r : (t + 1) * r])
    w = _pairs(lanes.reshape(PW_THREADS // 32, 32), r, count, 32)[:, 0]
    w32 = np.zeros(32, dtype=src.dtype)
    w32[: len(w)] = w
    return _pairs(w32, r * 32, count, PW_THREADS // 32)[0]


def _emulate_pairwise_dot(a, b, o0, n, descending=False):
    """The kernel's order over (P, W) numpy frames: a warp's 32 R elements
    as Q = 4 rows of 32 vectors of VW elements (vector q of lane L at
    elements (q * 32 + L) * VW + e), each vector's tree, the lanes per row
    by shuffles, lane 0's rows pairwise, the 8 warps, then the last CTA's
    tree over each part's partials and the fold of the parts."""
    dt = a.dtype.type
    R = PW_RUN[dt]
    VW = 16 // a.itemsize
    Q = R // VW
    E = R * PW_THREADS
    P = a.shape[0]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    nblk = max(1, m // E)
    t = np.zeros((P, nblk * E), dtype=dt)
    t[:, :n] = a[:, o0 : o0 + n] * b[:, o0 : o0 + n]
    v = t.reshape(P, nblk, PW_THREADS // 32, Q, 32, VW)
    s = 2
    while s <= VW:
        if s <= m:
            v = v.copy()
            v[..., ::s] = v[..., ::s] + v[..., s // 2 :: s]
        s *= 2
    rows = _pairs(v[..., 0], VW, m, 32, descending)[..., 0]  # (P, nblk, warps, Q)
    s = 2
    while s <= Q:
        if VW * 32 * s <= m:
            rows = rows.copy()
            rows[..., ::s] = rows[..., ::s] + rows[..., s // 2 :: s]
        s *= 2
    w = rows[..., 0]
    w32 = np.zeros((P, nblk, 32), dtype=dt)
    w32[..., : w.shape[-1]] = w
    partials = _pairs(w32, R * 32, m, PW_THREADS // 32, descending)[..., 0]
    fold = None
    for q in range(P):
        if nblk <= 32:  # a warp a part, a lane a partial
            lanes = np.zeros(32, dtype=dt)
            lanes[:nblk] = partials[q]
            root = _pairs(lanes, 1, nblk, 32)[0]
        else:
            root = _cta_tree(partials[q], nblk)
        fold = root if fold is None else fold + root
    return fold


def _pw_case(rng, P, n, o0, dtype):
    """Frames with a band at o0: products of mixed magnitudes that cancel
    (pairs x, -x(1 + 2^-20) across the band), -0.0 entries."""
    w = o0 + n + 5
    a = (rng.standard_normal((P, w)) * 10.0 ** rng.integers(-6, 7, (P, w))).astype(dtype)
    b = rng.standard_normal((P, w)).astype(dtype)
    if n > 1:
        h = n // 2
        a[:, o0 + h : o0 + 2 * h] = -a[:, o0 : o0 + h] * dtype(1 + 2.0**-20)
        b[:, o0 + h : o0 + 2 * h] = b[:, o0 : o0 + h]
    a[:, o0 + 3 :: 7] = -0.0
    return a, b


def _jax_fold(a, b, o0, n):
    parts = [jax_pairwise_sum(a[p, o0 : o0 + n] * b[p, o0 : o0 + n]) for p in range(a.shape[0])]
    acc = parts[0]
    for v in parts[1:]:
        acc = acc + v
    return np.asarray(acc, dtype=a.dtype).tobytes()


def _pw_sizes(dtype):
    E = PW_RUN[dtype] * PW_THREADS
    return [0, 1, 2, 3, E - 1, E, E + 1, 3 * E + 5, 2**14 - 1, 2**14 + 1]


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("k", range(10))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_dot_kernel_order_emulated(dtype, k, P):
    """The kernel's order, emulated at its real CTA size, equals the JAX
    package's pairwise_sum of each part's rounded products, folded left to
    right, and the plain version, bit for bit (n the k-th of 0, 1, 2, 3,
    E - 1, E, E + 1, 3E + 5, 2^14 - 1, 2^14 + 1; E the elements a CTA)."""
    n = _pw_sizes(dtype)[k]
    a, b = _pw_case(np.random.default_rng(100 * k + P), P, n, 3, dtype)
    got = np.asarray(_emulate_pairwise_dot(a, b, 3, n), dtype=dtype).tobytes()
    assert got == _jax_fold(a, b, 3, n)
    assert got == _bits(irr.pairwise_dot_plain(torch.from_numpy(a), torch.from_numpy(b), 3, n).numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_dot_kernel_order_emulated_many_partials(dtype):
    """Past 2^20 elements (f32) a part leaves more partials than the last
    CTA has threads: each thread reduces a run of two; past 2^22 (f64) a
    run of 16, two chunks of 8 joined by the stack; still pairwise_sum's
    bits."""
    n = (2**20 if dtype == np.float32 else 2**22) + 1
    a, b = _pw_case(np.random.default_rng(5), 1, n, 3, dtype)
    assert np.asarray(_emulate_pairwise_dot(a, b, 3, n), dtype=dtype).tobytes() == _jax_fold(a, b, 3, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 17])
def test_pairwise_dot_kernel_order_emulated_signed_zero(n):
    """All -0.0 products: the emulated kernel keeps the sign where numpy's
    tree does and turns it +0.0 where a +0.0 pad enters (no add past m)."""
    a = -np.zeros((1, n))
    b = np.ones((1, n))
    got = _emulate_pairwise_dot(a, b, 0, n)
    assert np.signbit(got) == np.signbit(jax_pairwise_sum(a[0] * b[0]))


def test_pairwise_dot_descending_butterfly_differs():
    """A warp butterfly at descending offsets pairs lanes 16 apart first:
    on products that cancel it gives other bits than the tree, which the
    ascending order keeps."""
    differs = 0
    for seed in range(8):
        a, b = _pw_case(np.random.default_rng(seed), 1, 4096, 0, np.float32)
        want = _jax_fold(a, b, 0, 4096)
        assert np.asarray(_emulate_pairwise_dot(a, b, 0, 4096), dtype=np.float32).tobytes() == want
        differs += np.asarray(_emulate_pairwise_dot(a, b, 0, 4096, descending=True),
                              dtype=np.float32).tobytes() != want
    assert differs > 0


#: csrc/pairwise_dot.cu, the block form: elements a thread (each column),
#: one 16-byte vector of the CTA's product tile
PWB_RUN = {np.float32: 4, np.float64: 2}


def _emulate_pairwise_dot_block(a, b, o0, n):
    """The block form's order over (P, W, K) numpy slabs, per column: a
    thread's RB consecutive products and their tree, the warp's lanes at
    ascending offsets, the 8 warps' roots, then the last CTA's tree over
    each part's partials (as the frame form's) and the fold of the parts.
    Returns the K sums."""
    dt = a.dtype.type
    R = PWB_RUN[dt]
    E = R * PW_THREADS
    P, K = a.shape[0], a.shape[2]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    nblk = max(1, m // E)
    out = []
    for k in range(K):
        t = np.zeros((P, nblk * E), dtype=dt)
        t[:, :n] = a[:, o0 : o0 + n, k] * b[:, o0 : o0 + n, k]
        v = t.reshape(P, nblk, PW_THREADS // 32, 32, R)
        s = 2
        while s <= R:
            if s <= m:
                v = v.copy()
                v[..., ::s] = v[..., ::s] + v[..., s // 2 :: s]
            s *= 2
        w = _pairs(v[..., 0], R, m, 32)[..., 0]  # (P, nblk, warps)
        w32 = np.zeros((P, nblk, 32), dtype=dt)
        w32[..., : w.shape[-1]] = w
        partials = _pairs(w32, R * 32, m, PW_THREADS // 32)[..., 0]
        fold = None
        for q in range(P):
            if nblk <= 32:
                lanes = np.zeros(32, dtype=dt)
                lanes[:nblk] = partials[q]
                root = _pairs(lanes, 1, nblk, 32)[0]
            else:
                root = _cta_tree(partials[q], nblk)
            fold = root if fold is None else fold + root
        out.append(np.asarray(fold, dtype=dt))
    return out


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_dot_block_kernel_order_emulated(dtype, P):
    """The block form's schedule (a thread's run of RB = 4 f32 / 2 f64
    elements of each column, one CTA a column chunk) gives each column the
    bits of `pairwise_sum` of its products, folded left to right: n from 0
    past one CTA's elements and past 32 partials a part, signed zeros and
    cancelling products in every column."""
    E = PWB_RUN[dtype] * PW_THREADS
    for n in (0, 1, 2, 3, E - 1, E, E + 1, 33 * E + 7):
        rng = np.random.default_rng(n + P)
        cols = [_pw_case(rng, P, n, 2, dtype) for _ in range(3)]
        a = np.stack([c[0] for c in cols], axis=2)
        b = np.stack([c[1] for c in cols], axis=2)
        got = _emulate_pairwise_dot_block(a, b, 2, n)
        for k in range(3):
            assert got[k].tobytes() == _jax_fold(a[..., k], b[..., k], 2, n), (n, k)


# ---------------------------------------------------------------------------
# strict block (multi-RHS) CG and PCG against the JAX package's strict
# solo solves
# ---------------------------------------------------------------------------

#: the right-hand sides of the strict block tests (tests/test_block_cg.py:
#: 316's cos(2 + (j + 2) gid) on the owned rows), and the columns of the
#: ragged blocks at K = 2, 3 and 5
STRICT_RHS = 5
STRICT_BLOCKS = {2: [1, 2], 3: [0, 1, 2], 5: [0, 1, 2, 3, 4]}


def _strict_rhs(isets, j):
    return [np.cos(2.0 + (j + 2.0) * np.asarray(i.lid_to_gid, dtype=np.float64)) for i in isets]


@pytest.fixture(scope="module")
def strict_block_reference():
    """The JAX package's sequential strict CG and Jacobi PCG
    (PA_TPU_STRICT_BITS=1) of each right-hand side alone, tol 1e-10, on the
    decoupled (symmetric) elasticity system on (4,4,4) nodes over 4 parts;
    the system and the right-hand sides as arrays for the port."""
    from partitionedarrays_jl_tpu.models import decouple_dirichlet as jax_decouple
    from partitionedarrays_jl_tpu.models import elasticity_tet as jax_el
    from test_torch_lowering import export

    old = os.environ.get("PA_TPU_STRICT_BITS")
    os.environ["PA_TPU_STRICT_BITS"] = "1"
    try:
        def driver(parts):
            A, b, xh, x0 = jax_el.assemble_elasticity_tet(parts, (4, 4, 4))
            A = jax_decouple(A)
            B = [_strict_rhs(A.rows.partition.part_values(), j) for j in range(STRICT_RHS)]
            solos = {}
            for name, solve in (("cg", pa.cg), ("pcg", pa.pcg)):
                solos[name] = []
                for v in B:
                    x, info = solve(A, pa.PVector(A.rows.partition._like(v), A.rows), tol=1e-10, maxiter=200)
                    solos[name].append((info["iterations"], _bits(info["residuals"]), _bits(pa.gather_pvector(x))))
            return export(A, xh), B, solos

        return pa.prun(driver, pa.sequential, 4)
    finally:
        if old is None:
            del os.environ["PA_TPU_STRICT_BITS"]
        else:
            os.environ["PA_TPU_STRICT_BITS"] = old


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "pcg"])
@pytest.mark.parametrize("body", ["standard", "fused"])
@pytest.mark.parametrize("K", sorted(STRICT_BLOCKS))
def test_strict_block_bitwise_matches_jax_solo(strict_block_reference, K, body, precond):
    """Strict block CG and Jacobi PCG on ``GPUBackend(device="cpu")`` (the
    ELL lowering, E1's slab form and E3's block form, plain versions) on
    a ragged block of K = 2, 3 and 5 columns, in the standard body (strict
    mode's default) and the fused one: every column's iterations, residual
    history bits and solution bits those of the JAX package's sequential
    strict solo solve of that column (tests/test_block_cg.py:273, :316),
    nothing logged past a column's freeze."""
    from test_torch_lowering import carry

    system, B, solos = strict_block_reference
    cols = STRICT_BLOCKS[K]

    def driver(parts):
        A, _ = carry(parts, system)
        Bs = [interop.pvector_from_values(A.rows, B[j]) for j in cols]
        kw = {} if body == "standard" else {"fused": True}
        xs, info = (pt.pcg if precond else pt.cg)(A, B=Bs, tol=1e-10, maxiter=200, strict=True, **kw)
        return info, [pt.gather_pvector(x) for x in xs]

    info, xs = pt.prun(driver, CPU, 4)
    assert info["strict"] and info["lowering"] == "ell" and info["cg_body"] == body and info["rhs_batch"] == K
    its = info["iterations_per_column"]
    assert len(set(its)) > 1, f"block is not ragged: {its}"
    for k, j in enumerate(cols):
        it, hist, x = solos["pcg" if precond else "cg"][j]
        assert its[k] == it
        assert _bits(info["columns"][k]["residuals"]) == hist
        assert len(info["columns"][k]["residuals"]) == it + 1
        assert _bits(xs[k]) == x
