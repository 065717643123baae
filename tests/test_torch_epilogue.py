"""The V-cycle epilogue (`ops/epilogue.py:vcycle_epilogue`, the kernel
`csrc/vcycle_epilogue.cu`) and the V-cycle it serves against the JAX
package.

* Each mode's plain version (the only one on the CPU) against the JAX
  expressions it stands for (`partitionedarrays_jl_tpu/parallel/
  tpu_gmg.py:596` init, `:604`/`:799` smooth, `:616`/`:686` residual) on
  numpy-seeded stacked frames whose product frame has another band
  offset and width than the column frame. Tolerance: f32 within 2 ulp,
  f64 within 1e-15 relative, each of the larger term of the expression's
  last add (|x| and |omega*dinv*(b - y)| in smooth, the result in the
  others): XLA contracts smooth's product and add into one FMA, which
  rounds once where the eager expressions round twice, so where the two
  terms nearly cancel the results differ by an ulp of the terms, not of
  the result.
* Each mode bit for bit against the eager sequence the V-cycle ran before
  the kernel (copied below from parallel/gpu_gmg.py as it was), which the
  plain version must repeat unchanged.
* One whole V-cycle (`parallel/gpu_gmg.py:make_vcycle`) on every transfer
  route (stencil, structured with the strided embedding, structured with
  the ``emb`` gather) on (1,1,1) and (2,2,1) parts of 16^3, f64, against
  the JAX package's V-cycle (`GMGHierarchy.vcycle`) at the tolerance of
  tests/test_torch_gmg.py (atol 1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import epilogue as ep
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, GPUBackend, _b_on_cols_layout

CPU = GPUBackend(device="cpu")
OMEGA = 0.8  # gmg_hierarchy's default, not exact in binary
#: the frames of the epilogue cases: P parts, band of N at O0 in the column
#: frame of width WC; the product's band at YO0 in a frame of width WY; the
#: structured route's residual frame: band at SO0 of width WS
P, N, O0, WC, YO0, WY, SO0, WS = 3, 1000, 2, 1011, 0, 1003, 5, 1017


def _frames(dtype, seed=11):
    rng = np.random.default_rng(seed)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    b, dinv, x = (rng.standard_normal((P, WC)).astype(np_dt) for _ in range(3))
    y = rng.standard_normal((P, WY)).astype(np_dt)
    return b, dinv, x, y


def _jax_expression(case, b, dinv, x, y):
    """The JAX package's expression on each part (tpu_gmg.py:580-584 the
    product re-embedded into the column frame, then :596, :604, :616 or
    :686), jitted as there."""
    sl = slice(O0, O0 + N)

    @jax.jit
    def one(b, dinv, x, y):
        q = jnp.zeros_like(b).at[sl].set(y[YO0 : YO0 + N])
        if case == "init":
            return jnp.zeros_like(b).at[sl].set(OMEGA * dinv[sl] * b[sl])
        if case == "smooth":
            return x.at[sl].add(OMEGA * dinv[sl] * (b[sl] - q[sl]))
        if case == "residual_stencil":
            return jnp.zeros_like(b).at[sl].set(b[sl] - q[sl])
        return jnp.zeros(WS, dtype=b.dtype).at[SO0 : SO0 + N].set(b[sl] - q[sl])

    return np.stack([np.asarray(one(b[p], dinv[p], x[p], y[p])) for p in range(P)])


def _port(fn, case, b, dinv, x, y):
    """fn (the plain version or the wrapper) on torch copies of the frames;
    returns the result frame as numpy."""
    b, dinv, x, y = (torch.from_numpy(v.copy()) for v in (b, dinv, x, y))
    if case == "init":
        return fn("init", b, O0, N, dinv=dinv, omega=OMEGA).numpy()
    if case == "smooth":
        out = fn("smooth", b, O0, N, dinv=dinv, y=y, yo0=YO0, x=x, omega=OMEGA)
        assert out is x  # in place
        return x.numpy()
    if case == "residual_stencil":
        return fn("residual", b, O0, N, y=y, yo0=YO0).numpy()
    return fn("residual", b, O0, N, y=y, yo0=YO0, width=WS, out_o0=SO0).numpy()


def _eager_before_kernel(case, b_l, dinv, x, y):
    """The V-cycle's eager sequence before the kernel
    (parallel/gpu_gmg.py: `spmv_A`, `sweep`, the zero-start sweep and the
    residuals of both routes), on the frames as torch tensors."""
    omega, no = OMEGA, N
    sl = slice(O0, O0 + no)
    P_ = b_l.shape[0]

    def spmv_A():
        out = torch.zeros_like(b_l)
        out[:, sl] = y[:, YO0 : YO0 + no]
        return out

    if case == "init":
        x = torch.zeros_like(b_l)
        x[:, sl] = omega * dinv[:, sl] * b_l[:, sl]
        return x
    q = spmv_A()
    if case == "smooth":
        x[:, sl] = x[:, sl] + omega * dinv[:, sl] * (b_l[:, sl] - q[:, sl])
        return x
    if case == "residual_stencil":
        rv = torch.zeros_like(b_l)
        rv[:, sl] = b_l[:, sl] - q[:, sl]
        return rv
    rS = torch.zeros((P_, WS), dtype=b_l.dtype, device=b_l.device)
    rS[:, SO0 : SO0 + no] = b_l[:, sl] - q[:, sl]
    return rS


CASES = ("init", "smooth", "residual_stencil", "residual_structured")
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_plain_epilogue_matches_jax_expressions(case, dtype):
    frames = _frames(dtype)
    want = _jax_expression(case, *frames)
    got = _port(ep.vcycle_epilogue_plain, case, *frames)
    assert got.shape == want.shape and got.dtype == want.dtype
    # the larger term of the last add, slot by slot (see the module's note)
    scale = np.abs(want.astype(np.float64))
    if case == "smooth":
        b, dinv, x, y = (v.astype(np.float64) for v in frames)
        t = np.zeros_like(x)
        t[:, O0 : O0 + N] = OMEGA * dinv[:, O0 : O0 + N] * (b[:, O0 : O0 + N] - y[:, YO0 : YO0 + N])
        scale = np.maximum(np.abs(x), np.abs(t))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if dtype == torch.float32:
        assert (diff <= 2 * np.spacing(scale.astype(np.float32))).all()
    else:
        assert (diff <= 1e-15 * scale).all()
    # every slot off the band exactly 0 (init, residual) or untouched (smooth)
    band = (slice(None), slice(SO0, SO0 + N) if case == "residual_structured" else slice(O0, O0 + N))
    off = np.ones(got.shape, dtype=bool)
    off[band] = False
    expect_off = frames[2][off] if case == "smooth" else 0
    assert np.array_equal(got[off], np.broadcast_to(expect_off, got[off].shape))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_plain_epilogue_is_the_eager_sequence(case, dtype):
    """Bit for bit (the bits, not only the values: -0.0 counts) against the
    eager sequence the V-cycle ran before the kernel; the wrapper on CPU
    tensors is the plain version and launches nothing."""
    frames = _frames(dtype, seed=23)
    want = _eager_before_kernel(case, *(torch.from_numpy(v.copy()) for v in frames)).numpy()
    dia.reset_launches()
    for fn in (ep.vcycle_epilogue_plain, ep.vcycle_epilogue):
        got = _port(fn, case, *frames)
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert dia.LAUNCHES["vcycle_epilogue"] == 0


def test_epilogue_refuses_what_it_does_not_take():
    b = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="no mode"):
        ep.vcycle_epilogue_plain("jacobi", b, 0, 10)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ep.vcycle_epilogue("residual", b.to("meta"), 0, 10, y=b.to("meta"))


#: the routes of one V-cycle: (part grid, route keywords) -> each level's route
VCYCLE_CASES = {
    "1x1x1-stencil": ((1, 1, 1), {}),
    "1x1x1-emb_fast": ((1, 1, 1), {"stencil": False}),
    "1x1x1-structured": ((1, 1, 1), {"box": False}),
    "2x2x1-default": ((2, 2, 1), {}),
    "2x2x1-emb_fast": ((2, 2, 1), {"stencil": False}),
    "2x2x1-structured": ((2, 2, 1), {"box": False}),
}
#: the routes each case must take, level by level (a 7-point level on
#: several parts declines the stencil route, as in the JAX package)
VCYCLE_ROUTES = {
    "1x1x1-stencil": ["stencil", "stencil"],
    "1x1x1-emb_fast": ["emb_fast", "emb_fast"],
    "1x1x1-structured": ["structured", "structured"],
    "2x2x1-default": ["emb_fast", "stencil"],
    "2x2x1-emb_fast": ["emb_fast", "emb_fast"],
    "2x2x1-structured": ["structured", "structured"],
}
NS = (16, 16, 16)


def _rhs(ngids):
    return np.random.default_rng(41).standard_normal(ngids)


@pytest.fixture(scope="module")
def jax_vcycles():
    """The JAX package's V-cycle on a seeded right-hand side, per part grid
    (the host `GMGHierarchy.vcycle`, same hierarchy settings)."""

    def driver(parts):
        A, _, _, _ = pa.assemble_poisson(parts, NS)
        Ah = pa.decouple_dirichlet(A)
        h = pa.gmg_hierarchy(parts, Ah, NS, coarse_threshold=100, pre=1, post=1)
        bg = _rhs(Ah.rows.ngids)
        b = pa.PVector(parts._like([bg[np.asarray(i.lid_to_gid)] for i in Ah.rows.partition.part_values()]), Ah.rows)
        return pa.gather_pvector(h.vcycle(b))

    return {grid: pa.prun(driver, pa.sequential, grid) for grid in {g for g, _ in VCYCLE_CASES.values()}}


@pytest.mark.parametrize("case", list(VCYCLE_CASES))
def test_vcycle_matches_jax(case, jax_vcycles):
    grid, kw = VCYCLE_CASES[case]

    def driver(parts):
        A, _, _, _ = pt.assemble_poisson(parts, NS)
        Ah = pt.decouple_dirichlet(A)
        h = pt.gmg_hierarchy(parts, Ah, NS, coarse_threshold=100, pre=1, post=1)
        dh = gpu_gmg.device_hierarchy(h, parts.backend, **kw)
        dA0 = dh["levels"][0]["dA"]
        bg = _rhs(Ah.rows.ngids)
        b = pt.PVector(parts._like([bg[np.asarray(i.lid_to_gid)] for i in Ah.rows.partition.part_values()]), Ah.rows)
        z = gpu_gmg.make_vcycle(h, dh)(_b_on_cols_layout(b, dA0))
        zv = DeviceVector(z, Ah.cols, dA0.col_layout, parts.backend).to_pvector()
        return [gpu_gmg.route(lv) for lv in dh["levels"]], pt.gather_pvector(zv)

    routes, z = pt.prun(driver, CPU, grid)
    assert routes == VCYCLE_ROUTES[case]
    np.testing.assert_allclose(z, jax_vcycles[grid], atol=1e-8)
