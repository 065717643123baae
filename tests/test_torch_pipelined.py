"""The port's lagged-axpy coded SpMV (K3: `ops/dia.py:dia_coded_spmv_axpy`)
and pipelined CG against the JAX package.

K3's plain version (the only one on the CPU) is held against the Pallas
kernel `dia_coded_padded_pallas(..., axpy=...)` under the Pallas
interpreter on the Poisson staging in both decodes, y and the updated
solution mapped between the padded and compact frames, f64 rtol=1e-13.
Pipelined CG at (2,2,2) 16^3 f64 is held against the JAX package's
`cg(pipelined=True)` on the 8-device CPU mesh: equal iterations, residual
history rtol=1e-10, solution atol=1e-10; and, as tests/test_tpu.py:394
requires of the JAX package, the port's pipelined and standard bodies take
equal iterations."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_poisson as jax_assemble_poisson
from partitionedarrays_jl_tpu.models import gather_pvector as jax_gather_pvector
from partitionedarrays_jl_tpu.ops.pallas_dia import (
    LANES,
    PAD_BLOCK_ROWS,
    dia_coded_padded_pallas,
    pack_nibble_codes as jax_pack_nibble_codes,
    plan_dia_padded,
)
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, device_matrix, make_cg_fn

CPU = GPUBackend(device="cpu")


def _unpack(packed: np.ndarray, n_coded: int) -> np.ndarray:
    """Inverse of `pack_nibble_codes` on (streams, N) bytes."""
    out = np.zeros((n_coded, packed.shape[-1]), dtype=np.uint8)
    for j in range(n_coded):
        out[j] = (packed[j // 2] >> (4 * (j % 2))) & 15
    return out


@pytest.mark.parametrize("decode,nparts", [("row_class", (1, 1, 1)), ("select_chain", (2, 2, 2))])
def test_plain_axpy_matches_pallas(decode, nparts):
    dia.reset_launches()
    op = pt.prun(
        lambda parts: device_matrix(pt.assemble_poisson(parts, (12, 12, 12))[0], parts.backend).coded,
        CPU, nparts,
    )
    assert (op.cls_pattern is not None) == (decode == "row_class")
    rng = np.random.default_rng(13)
    no = int(op.no[0])
    n_coded = 1 if op.cls_pattern is not None else sum(1 for c in op.code_row if c >= 0)
    plan = plan_dia_padded(op.offsets, no, n_coded=n_coded, itemsize=8)
    o0 = plan["o0"]
    total = (plan["n_blocks"] + 3) * PAD_BLOCK_ROWS
    codes = np.zeros((n_coded, plan["code_len"]), dtype=np.uint8)
    codes[:, :no] = _unpack(op.codes[0].numpy(), n_coded)[:, :no]
    packed = jax_pack_nibble_codes(codes)

    # compact frames of part 0 (owned band at 0, then ghost slots) and the
    # padded frames of the Pallas kernel (owned band at o0)
    W = op.n + 40
    x, xacc, pprev = (rng.standard_normal(W) for _ in range(3))
    pprev[no:] = 0.0
    alpha = 0.375

    def padded(v):
        out = np.zeros(total * LANES)
        out[o0 : o0 + no] = v[:no]
        return out.reshape(-1, LANES)

    y_want, xacc_want = (
        np.asarray(a).reshape(-1)
        for a in dia_coded_padded_pallas(
            op.cb[0].numpy(), np.array([no], dtype=np.int32),
            packed.reshape(packed.shape[0], -1, LANES), padded(x), op.offsets, op.kk,
            op.code_row, plan, total, interpret=True, cls_pattern=op.cls_pattern,
            axpy=(padded(pprev), padded(xacc), np.array([alpha])),
        )
    )
    op1 = dia.CodedOperator(
        cb=op.cb[:1], no=op.no[:1], codes=op.codes[:1], offsets=op.offsets, kk=op.kk,
        code_row=op.code_row, cls_pattern=op.cls_pattern, o0=0,
    )
    xacc_t = torch.from_numpy(xacc[None].copy())
    y = dia.dia_coded_spmv_axpy(
        op1, torch.from_numpy(x[None]), xacc_t, torch.from_numpy(pprev[None]),
        torch.tensor(alpha, dtype=torch.float64), W + 3,
    ).numpy()[0]
    np.testing.assert_allclose(y[:no], y_want[o0 : o0 + no], rtol=1e-13, atol=1e-13)
    assert not y[no:].any() and not y_want[o0 + no :].any()
    got = xacc_t.numpy()[0]
    np.testing.assert_allclose(got[:no], xacc_want[o0 : o0 + no], rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(got[no:], xacc[no:])  # untouched outside the band
    assert not any(dia.LAUNCHES.values())


@pytest.fixture(scope="module")
def pipelined_runs():
    ns, tol = (16, 16, 16), 1e-9

    def jax_driver(parts):
        A, b, xe, x0 = jax_assemble_poisson(parts, ns)
        x, info = pa.cg(A, b, x0=x0, tol=tol, maxiter=500, pipelined=True)
        return jax_gather_pvector(x), info

    def port_driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        out = {}
        for name, kw in (("pipelined", {"pipelined": True}), ("standard", {"fused": False})):
            x, info = pt.cg(A, b, x0=x0, tol=tol, maxiter=500, **kw)
            out[name] = (pt.gather_pvector(x), info)
        return out

    return pa.prun(jax_driver, pa.tpu, (2, 2, 2)), pt.prun(port_driver, CPU, (2, 2, 2))


def test_pipelined_cg_matches_jax(pipelined_runs):
    (x_jax, info_jax), port = pipelined_runs
    x, info = port["pipelined"]
    assert info["cg_body"] == "pipelined" and info["converged"]
    assert info["iterations"] == info_jax["iterations"]
    n = info["iterations"] + 1
    # atol: rounding of the dot folds at the scale of the initial residual
    # (the tail of the history sits ~1e-9 below it)
    hist_jax = np.asarray(info_jax["residuals"])[:n]
    np.testing.assert_allclose(info["residuals"][:n], hist_jax, rtol=1e-10, atol=1e-15 * hist_jax[0])
    np.testing.assert_allclose(x, x_jax, atol=1e-10)


def test_pipelined_matches_standard_body(pipelined_runs):
    port = pipelined_runs[1]
    (xp, ip), (xs, is_) = port["pipelined"], port["standard"]
    assert is_["cg_body"] == "standard"
    assert ip["iterations"] == is_["iterations"]
    np.testing.assert_allclose(ip["residuals"], is_["residuals"], rtol=1e-12)
    np.testing.assert_allclose(xp, xs, atol=1e-12)


def test_pipelined_and_fused_are_exclusive():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        with pytest.raises(ValueError, match="mutually exclusive"):
            pt.cg(A, b, x0=x0, pipelined=True, fused=True)
        with pytest.raises(ValueError, match="mutually exclusive"):
            make_cg_fn(device_matrix(A, parts.backend), 1e-8, 10, fused=True, pipelined=True)
        return True

    assert pt.prun(driver, CPU, (1, 1, 1))

    # on the host backend the flag is a no-op, as in the JAX package
    def host(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        return pt.cg(A, b, x0=x0, tol=1e-10, pipelined=True)

    sx, si = pt.prun(host, pt.sequential, (1, 1, 1))
    assert si["cg_body"] == "host" and si["converged"]


def test_pipelined_zero_iterations_leaves_the_start():
    """A start that already meets the tolerance: zero iterations, and the
    final flush of the lagged update adds nothing."""

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        x, info = pt.cg(A, b, x0=xe, tol=1e-6, pipelined=True)
        return info["iterations"], float((x - xe).norm())

    it, err = pt.prun(driver, CPU, (2, 2, 2))
    assert it == 0 and err == 0.0
