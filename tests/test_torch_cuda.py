"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a card, since a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each kernel must equal its plain PyTorch version value for value (both
round every product and sum separately; torch.equal counts -0.0 == +0.0),
and the GPU backend's CG, pipelined CG and GMG-PCG must take the port's
sequential iterations."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.ops import dia

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _operator(mode, dtype, rng):
    """A two-part operand with ragged owned counts: the 7-point offsets of
    a 24^3 grid, in select-chain or row-class decode."""
    n = 24
    rows = n ** 3
    no = np.array([rows, rows - 1000], dtype=np.int32)
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    if mode == "class":
        K = 2
        kk, code_row = (K,) * 7, (0,) * 7
        cb = np.zeros((2, 7, K))
        cb[:, :, 0] = rng.standard_normal((2, 7))
        cb[:, 3, 1] = 1.0
        codes = rng.integers(0, K, (2, 1, rows)).astype(np.uint8)
        pattern = tuple(tuple(bool(np.any(cb[:, d, k] != 0)) for d in range(7)) for k in range(K))
    else:
        kk = (1, 3, 2, 5, 2, 3, 1)
        code_row = (-1, 0, 1, 2, 3, 4, -1)
        cb = rng.standard_normal((2, 7, 5))
        codes = np.zeros((2, 5, rows), dtype=np.uint8)
        for d, k in enumerate(kk):
            if k > 1:
                codes[:, code_row[d]] = rng.integers(0, k, (2, rows))
        pattern = None
    packed = dia.pack_nibble_codes(codes).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).to("cuda", dtype),
        no=torch.from_numpy(no).cuda(),
        codes=torch.from_numpy(np.ascontiguousarray(packed)).cuda(),
        offsets=offsets, kk=kk, code_row=code_row, cls_pattern=pattern, o0=0,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class"])
def test_kernels_match_plain(mode, dtype):
    _need_card()
    rng = np.random.default_rng(7)
    op = _operator(mode, dtype, rng)
    w = op.n + 50
    x, r, pprev = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    beta = torch.tensor(0.375, dtype=dtype, device="cuda")
    dia.reset_launches()
    y = dia.dia_coded_spmv(op, x, w + 3)
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 3)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmv"] == dia.LAUNCHES["dia_coded_spmv_pfold"] == 1
    assert torch.equal(y, dia.dia_coded_spmv_plain(op, x, w + 3))
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, w + 3)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class"])
def test_axpy_kernel_matches_plain(mode, dtype):
    _need_card()
    rng = np.random.default_rng(11)
    op = _operator(mode, dtype, rng)
    w = op.n + 50
    x, pprev, xacc = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    alpha = torch.tensor(-0.625, dtype=dtype, device="cuda")
    xk, xp = xacc.clone(), xacc.clone()
    dia.reset_launches()
    yk = dia.dia_coded_spmv_axpy(op, x, xk, pprev, alpha, w + 3)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmv_axpy"] == 1
    yp = dia.dia_coded_spmv_axpy_plain(op, x, xp, pprev, alpha, w + 3)
    assert torch.equal(yk, yp) and torch.equal(xk, xp)
    # outside each part's owned band xacc is untouched
    assert torch.equal(xk[1, int(op.no[1]) :], xacc[1, int(op.no[1]) :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stream_kernel_matches_plain(dtype):
    _need_card()
    rng = np.random.default_rng(5)
    n = 24
    offsets = tuple(
        int(a * n * n + b * n + c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
    )
    rows = n ** 3
    vals = torch.from_numpy(rng.standard_normal((2, 27, rows))).to("cuda", dtype)
    no = torch.tensor([rows, rows - 777], dtype=torch.int32, device="cuda")
    x = torch.from_numpy(rng.standard_normal((2, rows + 60))).to("cuda", dtype)
    dia.reset_launches()
    yk = dia.dia_stream_spmv(vals, x, offsets, no, 0, rows + 9)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_stream_spmv"] == 1
    assert torch.equal(yk, dia.dia_stream_spmv_plain(vals, x, offsets, no, 0, rows + 9))


def test_stacked_parts_pipelined_and_gmg_match_sequential():
    _need_card()
    ns = (16, 16, 16)

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        _, info_c = pt.cg(A, b, x0=x0, tol=1e-8, pipelined=True)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=100)
        x, info_g = pt.pcg(Ah, bh, minv=h, tol=1e-8)
        return info_c["iterations"], info_g["iterations"], float((x - xe).norm())

    dia.reset_launches()
    it_c, it_g, err = pt.prun(driver, pt.GPUBackend(), (2, 2, 2))
    assert dia.LAUNCHES["dia_coded_spmv_axpy"] == it_c and dia.LAUNCHES["dia_stream_spmv"] > 0
    it_cs, it_gs, err_s = pt.prun(driver, pt.sequential, (2, 2, 2))
    assert (it_c, it_g) == (it_cs, it_gs)
    assert abs(err - err_s) <= 1e-9


def test_stacked_parts_cg_matches_sequential():
    _need_card()
    ns = (12, 12, 12)
    err_g, info_g = pt.prun(pt.poisson_fdm_driver, pt.GPUBackend(), (2, 2, 2), ns, tol=1e-8)
    err_s, info_s = pt.prun(pt.poisson_fdm_driver, pt.sequential, (2, 2, 2), ns, tol=1e-8)
    assert info_g["cg_body"] == "fused" and info_g["converged"]
    assert info_g["iterations"] == info_s["iterations"]
    assert abs(err_g - err_s) <= 1e-12
