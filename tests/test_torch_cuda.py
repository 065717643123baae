"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a card, since a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each kernel must equal its plain PyTorch version value for value (both
round every product and sum separately; torch.equal counts -0.0 == +0.0),
and the GPU backend's CG, pipelined CG and GMG-PCG must take the port's
sequential iterations. The device-resident loops replayed as CUDA graphs
must equal the same loops run eagerly on the card, bit for bit, with the
same launch counts; a capture that fails raises."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.ops import dia

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


#: (stencil points, n, o0): n = 25 starts the operand windows off 16-byte
#: alignment, o0 > 0 moves the owned band inside the frame; at n = 24, 25
#: every window fits one tile and CTAs walk the tiles, at n >= 35 the far
#: planes have windows of their own and CTAs march along the planes (odd
#: n^2: each plane starts at another 16-byte phase; 40^2 = 1600 rows: two
#: columns a plane, the second ragged)
SHAPES = [(7, 24, 0), (7, 25, 3), (27, 24, 1), (27, 25, 0), (7, 40, 2), (7, 41, 0), (27, 35, 1)]
SHAPE_IDS = [f"{p}pt-n{n}-o0{o0}" for p, n, o0 in SHAPES]


def _offsets(points, n):
    r = (-1, 0, 1)
    if points == 7:
        return (-n * n, -n, -1, 0, 1, n, n * n)
    return tuple(a * n * n + b * n + c for a in r for b in r for c in r)


def _operator(mode, dtype, rng, points=7, n=24, o0=0):
    """A two-part operand with ragged owned counts (neither a multiple of
    the kernel's tile): the 7- or 27-point offsets of an n^3 grid, in
    select-chain or row-class decode ("class" with 2 classes, "class4" and
    "class6" with 4 and 6)."""
    rows = n ** 3
    no = np.array([rows, rows - 1000], dtype=np.int32)
    offsets = _offsets(points, n)
    D = len(offsets)
    if mode.startswith("class"):
        K = int(mode[5:] or 2)
        kk, code_row = (K,) * D, (0,) * D
        cb = np.zeros((2, D, K))
        cb[:, :, 0] = rng.standard_normal((2, D))
        cb[:, D // 2, 1:] = rng.standard_normal((2, K - 1))
        # a zero coefficient of class 2 on every part: a masked diagonal
        cb[:, 0, min(2, K - 1)] = 0.0
        codes = rng.integers(0, K, (2, 1, rows)).astype(np.uint8)
        pattern = tuple(tuple(bool(np.any(cb[:, d, k] != 0)) for d in range(D)) for k in range(K))
    else:
        kk = tuple((1, 3, 2, 5, 2, 3, 1)[d % 7] for d in range(D))
        code_row = tuple(int(np.sum(np.array(kk[:d]) > 1)) if kk[d] > 1 else -1 for d in range(D))
        cb = rng.standard_normal((2, D, 5))
        codes = np.zeros((2, max(code_row) + 1, rows), dtype=np.uint8)
        for d, k in enumerate(kk):
            if k > 1:
                # codes up to 15: a code past the codebook reads slot 0
                codes[:, code_row[d]] = rng.integers(0, k + 1 if d % 3 else 16, (2, rows))
        pattern = None
    packed = dia.pack_nibble_codes(codes).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).to("cuda", dtype),
        no=torch.from_numpy(no).cuda(),
        codes=torch.from_numpy(np.ascontiguousarray(packed)).cuda(),
        offsets=offsets, kk=kk, code_row=code_row, cls_pattern=pattern, o0=o0,
    )


def _outside(op, v):
    """The slots of each part's frame outside its owned band."""
    keep = torch.ones_like(v, dtype=torch.bool)
    for p, no in enumerate(op.no.tolist()):
        keep[p, op.o0 : op.o0 + no] = False
    return v[keep]


def _moved(t, by):
    """t's values in a tensor `by` elements further into its storage: the
    same frame at another 16-byte phase."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    out = buf[by:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("pprev_moved", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class", "class4", "class6"])
def test_kernels_match_plain(mode, dtype, shape, pprev_moved):
    _need_card()
    rng = np.random.default_rng(7)
    op = _operator(mode, dtype, rng, *shape)
    w = op.o0 + op.n + 50
    x, r, pprev = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    # pprev at another phase than r: the fold takes its value-by-value path
    pprev = _moved(pprev, pprev_moved)
    beta = torch.tensor(0.375, dtype=dtype, device="cuda")
    dia.reset_launches()
    y = dia.dia_coded_spmv(op, x, w + 3)
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 3)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmv"] == dia.LAUNCHES["dia_coded_spmv_pfold"] == 1
    assert torch.equal(y, dia.dia_coded_spmv_plain(op, x, w + 3))
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, w + 3)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    for v in (y, yk, pk):
        assert not _outside(op, v).any()


@pytest.mark.parametrize("pprev_moved", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class", "class4", "class6"])
def test_axpy_kernel_matches_plain(mode, dtype, shape, pprev_moved):
    _need_card()
    rng = np.random.default_rng(11)
    op = _operator(mode, dtype, rng, *shape)
    w = op.o0 + op.n + 50
    x, pprev, xacc = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    pprev = _moved(pprev, pprev_moved)
    alpha = torch.tensor(-0.625, dtype=dtype, device="cuda")
    xk, xp = xacc.clone(), xacc.clone()
    dia.reset_launches()
    yk = dia.dia_coded_spmv_axpy(op, x, xk, pprev, alpha, w + 3)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmv_axpy"] == 1
    yp = dia.dia_coded_spmv_axpy_plain(op, x, xp, pprev, alpha, w + 3)
    assert torch.equal(yk, yp) and torch.equal(xk, xp)
    assert not _outside(op, yk).any()
    # outside each part's owned band xacc is untouched
    assert torch.equal(_outside(op, xk), _outside(op, xacc))


#: select-chain codebook sizes per diagonal: "shape" the shapes the
#: select-chain sum is specialised for (ops/dia.py:SELECT_SHAPES: 7
#: diagonals all coded, 27 with the centre constant; kk 2), "all2" every
#: diagonal coded with kk 2, "mixed16" sizes 2 to 16, "consts" constants
#: interleaved with kk 2 diagonals
KK_PATTERNS = {
    "shape": lambda D: tuple(1 if d in dia.SELECT_SHAPES[D] else 2 for d in range(D)),
    "all2": lambda D: (2,) * D,
    "mixed16": lambda D: tuple((2, 3, 16, 5, 2, 9, 4)[d % 7] for d in range(D)),
    "consts": lambda D: tuple(1 + d % 2 for d in range(D)),
}


def _select_operator(points, n, pattern, dtype, rng, o0=1):
    """Two parts with ragged owned counts, the 7- or 27-point offsets of
    an n^3 grid, select-chain decode with `pattern`'s codebook sizes, codes
    up to 15 (a code past kk reads slot 0)."""
    rows = n ** 3
    offsets = _offsets(points, n)
    D = len(offsets)
    kk = KK_PATTERNS[pattern](D)
    code_row = tuple(int(np.sum(np.array(kk[:d]) > 1)) if kk[d] > 1 else -1 for d in range(D))
    codes = rng.integers(0, 16, (2, max(code_row) + 1, rows)).astype(np.uint8)
    packed = dia.pack_nibble_codes(codes).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(rng.standard_normal((2, D, max(kk)))).to("cuda", dtype),
        no=torch.tensor([rows, rows - 333], dtype=torch.int32, device="cuda"),
        codes=torch.from_numpy(np.ascontiguousarray(packed)).cuda(),
        offsets=offsets, kk=kk, code_row=code_row, cls_pattern=None, o0=o0,
    )


@pytest.mark.parametrize("n", [25, 41], ids=["n25", "n41"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", sorted(KK_PATTERNS))
@pytest.mark.parametrize("points", [7, 27])
def test_select_chain_shapes_match_plain(points, pattern, dtype, n):
    """The select-chain decode at 7 and 27 diagonals in all three modes,
    odd n (at 41 the CTAs march along the planes), two parts: the
    specialised sums where the shape matches, the run-time loop elsewhere;
    every result torch.equal to the plain version."""
    _need_card()
    rng = np.random.default_rng(points * 100 + n)
    op = _select_operator(points, n, pattern, dtype, rng)
    picked = dia.select_chain_instance(op)
    assert picked == (points if pattern == "shape" or (pattern == "all2" and points == 7) else 0)
    w = op.o0 + op.n + 21
    x, r, pprev, xacc = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(4))
    beta = torch.tensor(0.375, dtype=dtype, device="cuda")
    alpha = torch.tensor(-0.625, dtype=dtype, device="cuda")
    y = dia.dia_coded_spmv(op, x, w + 5)
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 5)
    xk, xp = xacc.clone(), xacc.clone()
    ya = dia.dia_coded_spmv_axpy(op, x, xk, pprev, alpha, w + 5)
    torch.cuda.synchronize()
    assert torch.equal(y, dia.dia_coded_spmv_plain(op, x, w + 5))
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, w + 5)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    assert torch.equal(ya, dia.dia_coded_spmv_axpy_plain(op, x, xp, pprev, alpha, w + 5))
    assert torch.equal(xk, xp)
    for v in (y, yk, pk, ya):
        assert not _outside(op, v).any()


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


#: K4 cases: rows a part (the second part 777 fewer): a multiple of 4 or
#: not (vector or scalar value loads in f32), and on either side of the
#: f32 form crossover (ops/dia.py:stream_form, 132 SMs, two parts: 16
#: CTAs a part, 16 * 1024 rows)
STREAM_ROWS = [13824, 13823, 16 * 1024, 16 * 1024 + 1]


def _stream_offsets(D, m):
    """D band offsets of an m^3 grid: the 27-point and 7-point stencils, or
    (13) the 27-point ones before the centre in scan order, and the
    centre."""
    r = (-1, 0, 1)
    pts = [(a, b, c) for a in r for b in r for c in r]
    if D == 7:
        pts = [p for p in pts if sum(map(abs, p)) <= 1]
    elif D == 13:
        pts = [p for p in pts if p[0] < 0 or (p[0] == 0 and p[1] < 0) or p == (0, 0, 0)]
    return tuple(sorted(a * m * m + b * m + c for a, b, c in pts))


@pytest.mark.parametrize("form", [None, "stream", "small"], ids=["by-shape", "stream", "small"])
@pytest.mark.parametrize("rows", STREAM_ROWS, ids=[f"n{r}" for r in STREAM_ROWS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [7, 27, 13])
def test_stream_kernel_forms_match_plain(D, dtype, rows, form):
    """K4 in each form (and the one its shape takes) against its plain
    version: two parts of unequal owned counts, the band at o0 = 2, a
    result frame wider than the band; the unrolled sums (27, 7) and the
    run-time loop (13); vector and scalar value loads; and the values at
    another 16-byte phase (scalar loads)."""
    _need_card()
    rng = np.random.default_rng(D + rows)
    offsets = _stream_offsets(D, 40)
    vals = torch.from_numpy(rng.standard_normal((2, D, rows))).to("cuda", dtype)
    no = torch.tensor([rows, rows - 777], dtype=torch.int32, device="cuda")
    x = torch.from_numpy(rng.standard_normal((2, rows + 9))).to("cuda", dtype)
    want = dia.dia_stream_spmv_plain(vals, x, offsets, no, 2, rows + 13)
    for v in (vals, _moved(vals, 1)):
        dia.reset_launches()
        got = dia.dia_stream_spmv(v, x, offsets, no, 2, rows + 13, form=form)
        torch.cuda.synchronize()
        assert dia.LAUNCHES["dia_stream_spmv"] == 1
        assert torch.equal(got, want)
        assert not got[1, 2 + rows - 777 :].any() and not got[:, :2].any()


def test_stacked_parts_pipelined_and_gmg_match_sequential():
    _need_card()
    ns = (16, 16, 16)

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, ns)
        _, info_c = pt.cg(A, b, x0=x0, tol=1e-8, pipelined=True)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=100)
        x, info_g = pt.pcg(Ah, bh, minv=h, tol=1e-8)
        dev_it = info_c.get("device_loop", {}).get("device_iterations")
        return info_c["iterations"], info_g["iterations"], float((x - xe).norm()), dev_it

    dia.reset_launches()
    it_c, it_g, err, dev_it = pt.prun(driver, pt.GPUBackend(), (2, 2, 2))
    # one axpy launch per iteration the device ran (the frozen ones included)
    assert dia.LAUNCHES["dia_coded_spmv_axpy"] == dev_it and dia.LAUNCHES["dia_stream_spmv"] > 0
    it_cs, it_gs, err_s, _ = pt.prun(driver, pt.sequential, (2, 2, 2))
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


def test_fast_route_48_cube_cg_on_the_card(monkeypatch):
    """The COO-free 48^3 f64 (2,2,2) system (chip_smoke.py's phase 2b
    system, the native planner's default route) through the fused CG on
    the card: converged within phase 2b's error gate (1e-5), K1 once and K2
    once per device iteration (unchanged from the COO route's system), and
    the COO route's iterations."""
    from partitionedarrays_jl_tpu_torch import native

    _need_card()
    n, be = 48, pt.GPUBackend()

    def solve(fast):
        monkeypatch.setattr(native, "STENCIL_FAST", fast)
        A, b, xe, x0 = pt.prun(lambda parts: pt.assemble_poisson(parts, (n, n, n)), be, (2, 2, 2))
        dia.reset_launches()
        x, info = pt.cg(A, b, x0=x0, tol=1e-8)
        torch.cuda.synchronize()
        err = float((x - xe).norm() / xe.norm())
        return info, dict(dia.LAUNCHES), err

    info, launches, err = solve(True)
    info_c, launches_c, err_c = solve(False)
    dev_it = info["device_loop"]["device_iterations"]
    assert info["converged"] and info["cg_body"] == "fused" and err < 1e-5
    assert launches["dia_coded_spmv"] == 1 and launches["dia_coded_spmv_pfold"] == dev_it
    assert launches_c["dia_coded_spmv_pfold"] == info_c["device_loop"]["device_iterations"]
    assert info["iterations"] == info_c["iterations"] and abs(err - err_c) < 1e-10


#: hierarchies whose stencil levels the box stencil kernel is held on: one
#: part, stacked equal and unequal boxes, a 2-D grid; one-part boxes that
#: cross the tiled form's tile and plane-chunk edges (77x66x70: 66 rows
#: over 16-row tiles, 70 points over 32-point tiles, 77 planes over chunks
#: of several planes, its level 1 39x33x35 tiled too; 40x34x33: an odd
#: last extent, off 16-byte alignment),
#: and one on each side of the slab form's threshold (32 x 32 points a
#: plane takes the slab form, 33 x 32 the tiled)
STENCIL_CASES = {
    "24^3-one-part": ((24, 24, 24), (1, 1, 1), 100),
    "16^3-2x2x2": ((16, 16, 16), (2, 2, 2), 100),
    "17x14x10-unequal": ((17, 14, 10), (2, 2, 2), 50),
    "20x18-2x2": ((20, 18), (2, 2), 20),
    "77x66x70-chunks": ((77, 66, 70), (1, 1, 1), 1000),
    "40x34x33-odd": ((40, 34, 33), (1, 1, 1), 5000),
    "13x32x32-slab": ((13, 32, 32), (1, 1, 1), 5000),
    "7x33x32-tiled": ((7, 33, 32), (1, 1, 1), 5000),
}


_STENCIL_HIERARCHIES = {}


def _stencil_hierarchy(case, dtype):
    """The device hierarchy (default routes, on the card) of a stencil case,
    built once per case and dtype for every test that holds its levels."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    key = (case, np.dtype(dtype).name)
    if key not in _STENCIL_HIERARCHIES:
        ns, grid, ct = STENCIL_CASES[case]

        def driver(parts):
            A, _, _, _ = pt.assemble_poisson(parts, ns, dtype=dtype)
            h = pt.gmg_hierarchy(parts, pt.decouple_dirichlet(A), ns, coarse_threshold=ct)
            return gpu_gmg.device_hierarchy(h, parts.backend)

        _STENCIL_HIERARCHIES[key] = pt.prun(driver, pt.GPUBackend(), grid)
    return _STENCIL_HIERARCHIES[key]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(STENCIL_CASES))
def test_box_stencil_kernel_matches_plain(case, dtype, masked):
    """box_stencil_apply torch.equal to its plain version on every stencil
    level of a real hierarchy (ghost segments refreshed by the box
    exchange), with and without a random 0/1 mask on the directions."""
    import dataclasses

    from partitionedarrays_jl_tpu_torch.ops import stencil as stn
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import exchange_

    _need_card()
    dh = _stencil_hierarchy(case, dtype)
    rng = np.random.default_rng(13)
    held = 0
    for lv in dh["levels"]:
        if gpu_gmg.route(lv) != "stencil":
            continue
        op = lv["stencil"]
        P = op.table.shape[0]
        if masked:
            op = dataclasses.replace(op, mask=torch.from_numpy(rng.integers(0, 2, (P, 27)).astype(dtype)).cuda())
        x = torch.from_numpy(rng.standard_normal((P, op.W)).astype(dtype)).cuda()
        exchange_(lv["dA"].col_plan, x)
        dia.reset_launches()
        y = stn.box_stencil_apply(op, x)
        torch.cuda.synchronize()
        assert dia.LAUNCHES["box_stencil_apply"] == 1
        assert torch.equal(y, stn.box_stencil_apply_plain(op, x))
        held += 1
    assert held >= 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", ["tiled", "slab"])
@pytest.mark.parametrize("case", list(STENCIL_CASES))
def test_box_stencil_forms_match_plain(case, form, dtype):
    """Each form of the box stencil kernel, forced on every stencil level of
    a hierarchy whatever form its shape takes, torch.equal to the plain
    version, with and without a random 0/1 mask."""
    import dataclasses

    from partitionedarrays_jl_tpu_torch.ops import stencil as stn
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import exchange_

    _need_card()
    dh = _stencil_hierarchy(case, dtype)
    rng = np.random.default_rng(29)
    held = 0
    for lv in dh["levels"]:
        if gpu_gmg.route(lv) != "stencil":
            continue
        op = stn.bind_kernel(lv["stencil"], form=form)
        P = op.table.shape[0]
        assert op.launch[torch.float64 if dtype == np.float64 else torch.float32][2].form == form
        x = torch.from_numpy(rng.standard_normal((P, op.W)).astype(dtype)).cuda()
        exchange_(lv["dA"].col_plan, x)
        masked = dataclasses.replace(op, mask=torch.from_numpy(rng.integers(0, 2, (P, 27)).astype(dtype)).cuda())
        for o in (op, masked):
            y = stn.box_stencil_apply(o, x)
            torch.cuda.synchronize()
            assert torch.equal(y, stn.box_stencil_apply_plain(o, x))
        held += 1
    assert held >= 1


@pytest.mark.parametrize("field,value", [("rows", 8), ("threads", 128)])
def test_box_stencil_refuses_a_foreign_tile(field, value):
    """A tiled launch whose rows or threads differ from the tile the source
    was built with raises through dia._raise_on (its grid would leave rows
    of the result unwritten) and counts no launch."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    _need_card()
    dh = _stencil_hierarchy("24^3-one-part", np.float32)
    lv = next(lv for lv in dh["levels"] if gpu_gmg.route(lv) == "stencil")
    op = stn.bind_kernel(lv["stencil"], form="tiled")
    prm = op.launch[torch.float32][0]
    setattr(prm, field, value)
    x = torch.zeros((op.table.shape[0], op.W), dtype=torch.float32, device="cuda")
    dia.reset_launches()
    with pytest.raises(RuntimeError, match="box_stencil_apply"):
        stn.box_stencil_apply(op, x)
    assert dia.LAUNCHES["box_stencil_apply"] == 0


@pytest.mark.parametrize("ns,grid", [((16, 16, 16), (2, 2, 2)), ((9, 7, 8), (2, 2, 2)), ((12, 12), (2, 4))],
                         ids=["16^3", "9x7x8", "12x12"])
def test_box_exchange_matches_generic_on_card(ns, grid):
    """Both combines through the box plan on the card against the generic
    plan: set equal per lid, add to rounding (another summation order)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import (
        DeviceVector, device_exchange_plan, device_layout, exchange_,
    )
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    _need_card()

    def driver(parts):
        r = pt.prange(parts, ns, pt.with_ghost)
        rng = np.random.default_rng(17)
        vals = [rng.standard_normal(i.num_lids) for i in r.partition.part_values()]
        out = []
        for combine in ("set", "add"):
            rev = combine == "add"
            res = []
            for box in (True, False):
                plan = device_exchange_plan(r, parts.backend, reverse=rev, box=box)
                assert isinstance(plan, BoxExchangePlan) == box
                dv = DeviceVector.from_pvector(
                    pt.PVector(parts._like([v.copy() for v in vals]), r), parts.backend, device_layout(r, box)
                )
                exchange_(plan, dv.data, combine)
                res.append(pt.gather_pvector(dv.to_pvector()) if rev else
                           [np.asarray(v) for v in dv.to_pvector().values.part_values()])
            out.append(res)
        return out

    (set_box, set_gen), (add_box, add_gen) = pt.prun(driver, pt.GPUBackend(), grid)
    for a, b in zip(set_box, set_gen):
        assert np.array_equal(a, b)
    # standard normal values, at most 8 contributions a cell: rounding only
    np.testing.assert_allclose(add_box, add_gen, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("ns", [(16, 16, 16), (17, 14, 10)], ids=["equal", "unequal"])
def test_gmg_pcg_routes_match_sequential_on_card(ns):
    """GMG-PCG on the stacked (2,2,2) parts on every route takes the
    sequential backend's iterations; the stencil route launches the stencil
    kernel and the structured routes none (unequal boxes: level 0 takes
    the structured route without emb_fast, through the box plan's add)."""
    _need_card()

    def driver(parts, **kw):
        A, b, xe, _ = pt.assemble_poisson(parts, ns)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=50)
        x, info = pt.pcg(Ah, bh, minv=h, tol=1e-8, **kw)
        return info["iterations"], float((x - xe).norm())

    it_s, err_s = pt.prun(driver, pt.sequential, (2, 2, 2))
    for kw in ({}, {"stencil": False}, {"box": False}):
        dia.reset_launches()
        it, err = pt.prun(driver, pt.GPUBackend(), (2, 2, 2), **kw)
        assert (dia.LAUNCHES["box_stencil_apply"] > 0) == (kw == {})
        assert it == it_s and abs(err - err_s) <= 1e-9


# ---------------------------------------------------------------------------
# the CG update sweep, K3's guard, and the device-resident loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("live", [0, 1])
@pytest.mark.parametrize("mode", ["x_and_r", "r_only"])
@pytest.mark.parametrize("n", [1, 2047, 2049, 100003], ids=["n1", "n2047", "n2049", "n100003"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_sweep_kernel_matches_plain(dtype, n, mode, live):
    """The sweep kernel against its plain version on three stacked parts
    (the band at an odd offset, q in a narrower frame): x, r, the partials
    and rs equal; with the flag 0 nothing is written and rs is the fold of
    the partials it found."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(n)
    P, o0 = 3, 5

    def mk(w):
        return torch.from_numpy(rng.standard_normal((P, w))).to("cuda", dtype)

    x, r, p, q = mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 2)
    part = torch.from_numpy(rng.standard_normal((P, sw.chunks(n))) ** 2).to("cuda", dtype)
    alpha = torch.tensor(-0.4375, dtype=dtype, device="cuda")
    flag = torch.tensor(live, dtype=torch.int32, device="cuda")
    xk, rk, pk = x.clone(), r.clone(), part.clone()
    xp, rp, pp = x.clone(), r.clone(), part.clone()
    with_x = mode == "x_and_r"
    dia.reset_launches()
    rs_k = sw.cg_sweep(rk, q, alpha, flag, pk, o0, n, **({"x": xk, "p": p} if with_x else {}))
    torch.cuda.synchronize()
    assert dia.LAUNCHES["cg_sweep"] == 1
    rs_p = sw.cg_sweep_plain(rp, q, alpha, flag, pp, o0, n, **({"x": xp, "p": p} if with_x else {}))
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(pk, pp) and torch.equal(rs_k, rs_p)
    if not live:
        assert torch.equal(xk, x) and torch.equal(rk, r) and torch.equal(pk, part)
    elif not with_x:
        assert torch.equal(xk, x)


@pytest.mark.parametrize("live", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class"])
def test_axpy_kernel_guard_matches_plain(mode, dtype, live):
    """K3 with its device flag: y always, the lagged update only where the
    flag is set, each equal to the plain version."""
    _need_card()
    rng = np.random.default_rng(17)
    op = _operator(mode, dtype, rng, 7, 25, 3)
    w = op.o0 + op.n + 50
    x, pprev, xacc = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    alpha = torch.tensor(-0.625, dtype=dtype, device="cuda")
    flag = torch.tensor(live, dtype=torch.int32, device="cuda")
    xk, xp = xacc.clone(), xacc.clone()
    yk = dia.dia_coded_spmv_axpy(op, x, xk, pprev, alpha, w + 3, flag)
    yp = dia.dia_coded_spmv_axpy_plain(op, x, xp, pprev, alpha, w + 3, flag)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp) and torch.equal(xk, xp)
    assert torch.equal(xk, xacc) == (live == 0)


LOOP_BODIES = ("fused", "standard", "pipelined", "gmg_stencil", "gmg_structured")


@pytest.fixture(scope="module")
def card_systems():
    """(2,2,2) parts on the card, f64: the 12^3 Poisson operator for CG, the
    decoupled 16^3 one and its hierarchy for GMG-PCG, staged."""
    if not torch.cuda.is_available():
        return None
    from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, _b_on_cols_layout, device_matrix

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (12, 12, 12))
        dA = device_matrix(A, parts.backend)
        Ag, bg, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, bh = pt.decouple_dirichlet(Ag, bg)
        h = pt.gmg_hierarchy(parts, Ah, (16, 16, 16), coarse_threshold=100)
        dA0 = device_matrix(Ah, parts.backend)
        bg_d = _b_on_cols_layout(bh, dA0)
        return {
            "backend": parts.backend, "dA": dA, "b": _b_on_cols_layout(b, dA),
            "x0": DeviceVector.from_pvector(x0, parts.backend, dA.col_layout).data,
            "h": h, "bg": bg_d, "xg0": torch.zeros_like(bg_d),
        }

    return pt.prun(driver, pt.GPUBackend(), (2, 2, 2))


def _make_loop(c, body, graph, tol=1e-10, block=None):
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import make_cg_fn

    if body.startswith("gmg"):
        fn = gpu_gmg.make_gmg_pcg_fn(c["h"], c["backend"], tol, 500, stencil=body == "gmg_stencil",
                                     graph=graph, block=block)
        return fn, c["bg"], c["xg0"]
    fn = make_cg_fn(c["dA"], tol, 500, fused=body == "fused", pipelined=body == "pipelined", graph=graph,
                    block=block)
    return fn, c["b"], c["x0"]


def _bitwise(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("block", [None, 3])
@pytest.mark.parametrize("body", LOOP_BODIES)
def test_graph_loop_matches_eager(card_systems, body, block):
    """Each loop replayed as a CUDA graph against the same loop run eagerly
    on the card: x, rs, iterations, the final r and the history bit for
    bit, and the same launch counts (the graph's tally added on every
    replay); a second run replays only, and a third solve through the same
    function leaves the returned x of the earlier ones as it was."""
    _need_card()
    c = card_systems
    fe, b, x0 = _make_loop(c, body, False, block=block)
    fg, _, _ = _make_loop(c, body, True, block=block)
    dia.reset_launches()
    want = fe(b, x0)
    torch.cuda.synchronize()
    counts = dict(dia.LAUNCHES)
    for run in range(2):
        dia.reset_launches()
        got = fg(b, x0)
        torch.cuda.synchronize()
        assert dict(dia.LAUNCHES) == counts
        assert got[3] == want[3] > 0
        for g, e in zip((got[0], got[1], got[2], fg.loop.base["r"]), (want[0], want[1], want[2], fe.loop.base["r"])):
            assert _bitwise(g, e)
        assert np.array_equal(got[4], want[4], equal_nan=True)
        st = fg.stats
        assert st["loop"] == "graph" and st["device_iterations"] == fe.stats["device_iterations"]
        assert st["replays"] == st["device_iterations"] // st["block"] - (1 if run == 0 else 0)
        assert (st["capture_s"] is not None) == (run == 0)
    keep = got[0].clone()
    fg(b, torch.ones_like(x0))
    torch.cuda.synchronize()
    assert torch.equal(got[0], keep)


def test_failed_capture_raises():
    """A host read inside a step breaks the capture: the run raises, and
    the launch counts are those of the eager block that ran."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop as gl

    def step(S):
        x = S["x"] + 1
        if bool((x > 100).any().item()):  # a host read: not allowed while capturing
            x = x * 0
        return dict(S, x=x)

    loop = gl.DeviceLoop(step, 2)
    init = {"x": torch.zeros(4, device="cuda"), "live": torch.ones((), dtype=torch.int32, device="cuda")}
    dia.reset_launches()
    with pytest.raises(RuntimeError):
        loop.run(init)
    assert loop.cuda_graph is None
    assert not any(dia.LAUNCHES.values())
    torch.cuda.synchronize()



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["init", "residual_column", "residual_other_frame", "smooth"])
def test_vcycle_epilogue_matches_plain_under_capture(case, dtype):
    """The V-cycle epilogue in each mode against its plain version, launched
    eagerly and replayed from a CUDA graph it was captured into: equal bit
    for bit (the bits: -0.0 counts), one launch each, three parts with the
    product's band at another offset and width than the column frame and
    a band of 100,003 rows (a ragged last CTA)."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import epilogue as ep

    rng = np.random.default_rng(3)
    P, n, o0, wc, yo0, wy = 3, 100003, 4, 100011, 1, 100006

    def mk(w):
        return torch.from_numpy(rng.standard_normal((P, w))).to("cuda", dtype)

    b, dinv, x0, y = mk(wc), mk(wc), mk(wc), mk(wy)
    kw = {
        "init": {"dinv": dinv, "omega": 0.8},
        "residual_column": {"y": y, "yo0": yo0},
        "residual_other_frame": {"y": y, "yo0": yo0, "width": wc + 9, "out_o0": 7},
        "smooth": {"dinv": dinv, "y": y, "yo0": yo0, "omega": 0.8},
    }[case]
    mode = case.split("_")[0]

    def run(fn, x):
        return fn(mode, b, o0, n, x=x, **kw) if mode == "smooth" else fn(mode, b, o0, n, **kw)

    ints = torch.int32 if dtype == torch.float32 else torch.int64

    def bitwise(a, b):
        return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))

    want = run(ep.vcycle_epilogue_plain, x0.clone())
    dia.reset_launches()
    got = run(ep.vcycle_epilogue, x0.clone())
    torch.cuda.synchronize()
    assert dia.LAUNCHES["vcycle_epilogue"] == 1
    assert bitwise(got, want)
    xg = x0.clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run(ep.vcycle_epilogue, xg.clone())  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(ep.vcycle_epilogue, xg)
    xg.copy_(x0)
    graph.replay()
    torch.cuda.synchronize()
    assert bitwise(out, want)


@pytest.mark.parametrize("kw", [{}, {"stencil": False}, {"box": False}], ids=["default", "emb_fast", "structured"])
@pytest.mark.parametrize("ns,grid,dtype", [((24, 24, 24), (1, 1, 1), np.float32), ((16, 16, 16), (2, 2, 2), np.float64)],
                         ids=["24^3-one-part-f32", "16^3-2x2x2-f64"])
def test_vcycle_kernels_match_plain_vcycle(ns, grid, dtype, kw):
    """One V-cycle with every kernel (K1, K4, the stencil, the epilogue)
    torch.equal to the same V-cycle through the plain versions, on each
    route; 3 epilogue launches a level."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _b_on_cols_layout

    def driver(parts):
        A, b, _, _ = pt.assemble_poisson(parts, ns, dtype=dtype)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=100)
        dh = gpu_gmg.device_hierarchy(h, parts.backend, **kw)
        bv = _b_on_cols_layout(bh, dh["levels"][0]["dA"])
        want = gpu_gmg.make_vcycle(h, dh, plain=True)(bv)
        dia.reset_launches()
        got = gpu_gmg.make_vcycle(h, dh)(bv)
        torch.cuda.synchronize()
        return torch.equal(got, want), dia.LAUNCHES["vcycle_epilogue"], len(dh["levels"])

    equal, launches, L = pt.prun(driver, pt.GPUBackend(), grid)
    assert equal and launches == 3 * L


# ---------------------------------------------------------------------------
# Jacobi PCG and block CG: K2 with minv, the precond and block sweeps, the
# block SpMMs, and the loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moved", [0, 1], ids=["same-phase", "minv-moved"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class", "class4"])
def test_pfold_minv_kernel_matches_plain(mode, dtype, shape, moved):
    """K2 with minv (p = minv*r + beta*pprev riding the SpMV) against its
    plain version, with minv at r's 16-byte phase (the vector fold) and
    at another one (the value-by-value fold); y and p equal, nothing
    outside the bands."""
    _need_card()
    rng = np.random.default_rng(23)
    op = _operator(mode, dtype, rng, *shape)
    w = op.o0 + op.n + 50
    r, pprev, minv = (torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) for _ in range(3))
    minv = _moved(minv, moved)
    beta = torch.tensor(0.375, dtype=dtype, device="cuda")
    dia.reset_launches()
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, w + 3, minv=minv)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmv_pfold_minv"] == 1 and dia.LAUNCHES["dia_coded_spmv_pfold"] == 0
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, w + 3, minv=minv)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    for v in (yk, pk):
        assert not _outside(op, v).any()


@pytest.mark.parametrize("live", [0, 1])
@pytest.mark.parametrize("n", [1, 2049, 100003], ids=["n1", "n2049", "n100003"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_precond_sweep_kernel_matches_plain(dtype, n, live):
    """The sweep's precond form against its plain version on three stacked
    parts: x, r, both series of partials, rz and rs equal; the flag 0
    writes nothing."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(n + 1)
    P, o0 = 3, 5

    def mk(w):
        return torch.from_numpy(rng.standard_normal((P, w))).to("cuda", dtype)

    x, r, p, minv, q = mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 2)
    part = torch.from_numpy(rng.standard_normal((P, 2, sw.chunks(n))) ** 2).to("cuda", dtype)
    alpha = torch.tensor(-0.4375, dtype=dtype, device="cuda")
    flag = torch.tensor(live, dtype=torch.int32, device="cuda")
    xk, rk, pk = x.clone(), r.clone(), part.clone()
    xp, rp, pp = x.clone(), r.clone(), part.clone()
    dia.reset_launches()
    rz_k, rs_k = sw.cg_sweep(rk, q, alpha, flag, pk, o0, n, x=xk, p=p, minv=minv)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["cg_sweep_precond"] == 1 and dia.LAUNCHES["cg_sweep"] == 0
    rz_p, rs_p = sw.cg_sweep_plain(rp, q, alpha, flag, pp, o0, n, x=xp, p=p, minv=minv)
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(pk, pp)
    assert torch.equal(rz_k, rz_p) and torch.equal(rs_k, rs_p)
    if not live:
        assert torch.equal(xk, x) and torch.equal(rk, r) and torch.equal(pk, part)


@pytest.mark.parametrize("moved", [0, 1], ids=["aligned", "r-moved"])
@pytest.mark.parametrize("with_minv", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 11, 12])
@pytest.mark.parametrize("n", [2049, 100003], ids=["n2049", "n100003"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_sweep_kernel_matches_plain(dtype, n, K, with_minv, moved):
    """The block sweep against its plain version on three stacked parts
    (the band at an odd offset, q in a narrower frame), every other column
    frozen: x, r, the partials and the folds equal, a frozen column
    untouched, and each active column equal to the solo sweep of that
    column; rows as 16-byte vectors where K allows and the slabs are
    aligned, one value at a time with r moved off alignment."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(K * 7 + n)
    P, o0 = 3, 5

    def mk(w, k=K):
        return torch.from_numpy(rng.standard_normal((P, w, k))).to("cuda", dtype)

    x, r, p, q = mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 7), mk(o0 + n + 2)
    r = _moved(r, moved)
    nv = 16 // r.element_size()
    assert dia.block_vec(K, r, q, x, p) == (moved == 0 and K % nv == 0 and dia.block_columns(K) % nv == 0)
    minv = mk(o0 + n + 7, 1)[..., 0].contiguous() if with_minv else None
    S = 2 * K if with_minv else K
    part = torch.from_numpy(rng.standard_normal((P, S, sw.chunks(n))) ** 2).to("cuda", dtype)
    alpha = torch.from_numpy(rng.standard_normal(K)).to("cuda", dtype)
    act = torch.tensor([(k + 1) % 2 for k in range(K)], dtype=torch.int32, device="cuda")
    xk, rk, pk = x.clone(), r.clone(), part.clone()
    xp, rp, pp = x.clone(), r.clone(), part.clone()
    dia.reset_launches()
    got = sw.cg_sweep_block(rk, q, alpha, act, pk, o0, n, x=xk, p=p, minv=minv)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["cg_sweep_block"] == 1
    want = sw.cg_sweep_block_plain(rp, q, alpha, act, pp, o0, n, x=xp, p=p, minv=minv)
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(pk, pp)
    for g, w in zip(got if with_minv else (got,), want if with_minv else (want,)):
        assert torch.equal(g, w)
    for k in range(K):
        if not act[k]:
            assert torch.equal(xk[..., k], x[..., k]) and torch.equal(rk[..., k], r[..., k])
            continue
        xs, rs_ = x[..., k].contiguous(), r[..., k].contiguous()
        solo_part = (part[:, 2 * k : 2 * k + 2] if with_minv else part[:, k]).contiguous()
        one = torch.ones((), dtype=torch.int32, device="cuda")
        solo = sw.cg_sweep(rs_, q[..., k].contiguous(), alpha[k].clone(), one, solo_part, o0, n, x=xs,
                           p=p[..., k].contiguous(), minv=minv)
        assert torch.equal(xs, xk[..., k]) and torch.equal(rs_, rk[..., k])
        if with_minv:
            assert torch.equal(solo[0], got[0][k]) and torch.equal(solo[1], got[1][k])
        else:
            assert torch.equal(solo, got[k])


@pytest.mark.parametrize("moved", [0, 1], ids=["aligned", "x-moved"])
@pytest.mark.parametrize("form", ["plain", "pfold", "pfold_minv"])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("shape", [(7, 25, 3), (27, 24, 1), (7, 41, 0)], ids=["7pt-n25-o03", "27pt-n24-o01", "7pt-n41-o00"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class"])
def test_coded_spmm_matches_plain(mode, dtype, shape, K, form, moved):
    """The coded SpMM in each form against its plain version on two parts
    of unequal owned counts (slabs wider than the band), rows as 16-byte
    vectors where K allows and the slabs are aligned, else (x moved off
    alignment) one value at a time; column k also equal to K1 / K2's plain
    version on column k."""
    _need_card()
    rng = np.random.default_rng(K + shape[1])
    op = _operator(mode, dtype, rng, *shape)
    w = op.o0 + op.n + 50

    def mk(k=K):
        return torch.from_numpy(rng.standard_normal((2, w, k))).to("cuda", dtype)

    x, pprev = _moved(mk(), moved), mk()
    beta = torch.from_numpy(rng.standard_normal(K)).to("cuda", dtype)
    minv = mk(1)[..., 0].contiguous() if form == "pfold_minv" else None
    dia.reset_launches()
    if form == "plain":
        got = (dia.dia_coded_spmm(op, x, w + 3),)
        want = (dia.dia_coded_spmm_plain(op, x, w + 3),)
    else:
        got = dia.dia_coded_spmm_pfold(op, x, pprev, beta, w + 3, minv=minv)
        want = dia.dia_coded_spmm_pfold_plain(op, x, pprev, beta, w + 3, minv=minv)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmm"] == 1
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    for k in range(K):
        xk = x[..., k].contiguous()
        if form == "plain":
            assert torch.equal(got[0][..., k], dia.dia_coded_spmv_plain(op, xk, w + 3))
        else:
            y1, p1 = dia.dia_coded_spmv_pfold_plain(op, xk, pprev[..., k].contiguous(), beta[k], w + 3, minv=minv)
            assert torch.equal(got[0][..., k], y1) and torch.equal(got[1][..., k], p1)


@pytest.mark.parametrize("moved", [0, 1], ids=["aligned", "x-moved"])
@pytest.mark.parametrize("kernel_form", ["row", "staged"])
@pytest.mark.parametrize("form", ["plain", "pfold", "pfold_minv"])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("shape", [(7, 25, 3), (27, 24, 1), (7, 41, 0), (27, 35, 1)],
                         ids=["7pt-n25-o03", "27pt-n24-o01", "7pt-n41-o00", "27pt-n35-o01"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["select", "class"])
def test_coded_spmm_forms_match_plain(mode, dtype, shape, K, form, kernel_form, moved):
    """Each form of the coded SpMM forced (`SPMM_FORMS`: the row form and
    the staged form, whose plan marches along the planes at n = 35 and 41
    and walks the tiles at n = 24, 25) against the plain version, on two
    parts of unequal owned counts, the slabs aligned or x one value off
    (rows a value at a time); every slot outside the owned band 0."""
    _need_card()
    rng = np.random.default_rng(K + shape[1] + 1)
    op = _operator(mode, dtype, rng, *shape)
    w = op.o0 + op.n + 50
    x = _moved(torch.from_numpy(rng.standard_normal((2, w, K))).to("cuda", dtype), moved)
    pprev = torch.from_numpy(rng.standard_normal((2, w, K))).to("cuda", dtype)
    beta = torch.from_numpy(rng.standard_normal(K)).to("cuda", dtype)
    minv = torch.from_numpy(rng.standard_normal((2, w))).to("cuda", dtype) if form == "pfold_minv" else None
    def launch():
        if form == "plain":
            return (dia.dia_coded_spmm(op, x, w + 3, form=kernel_form),)
        return dia.dia_coded_spmm_pfold(op, x, pprev, beta, w + 3, minv=minv, form=kernel_form)

    if kernel_form == "staged":
        try:
            plan = dia.plan_coded_block_windows(op.offsets, x.element_size(), K, form, op.codes.shape[1])
        except ValueError:
            # no staged plan fits (the widest f64 slabs of the 27-point
            # operators): the forced form raises, the planner takes the row form
            with pytest.raises(ValueError, match="shared memory"):
                launch()
            assert dia.spmm_form(op.offsets, x.element_size(), K, form, op.codes.shape[1]) == dia.SPMM_ROW
            return
        assert plan.stride in (0, shape[1] ** 2)
    dia.reset_launches()
    got = launch()
    if form == "plain":
        want = (dia.dia_coded_spmm_plain(op, x, w + 3),)
    else:
        want = dia.dia_coded_spmm_pfold_plain(op, x, pprev, beta, w + 3, minv=minv)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmm"] == 1
    for g, e in zip(got, want):
        assert torch.equal(g, e)
        assert not _outside(op, g).any()


@pytest.mark.parametrize("moved", [0, 1], ids=["aligned", "x-moved"])
@pytest.mark.parametrize("kernel_form", [None, "row", "staged"], ids=["by-shape", "row", "staged"])
@pytest.mark.parametrize("K", [2, 3, 4])
@pytest.mark.parametrize("shape", [(7, 25, 3), (7, 41, 0)], ids=["7pt-n25-o03", "7pt-n41-o00"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coded_spmm_two_slot_select_chain(dtype, shape, K, kernel_form, moved):
    """The staged form's unrolled sum on GMG level 0's shape (7 diagonals,
    each coded with kk = 2 on its own nibble, 4 code bytes a row; codes up
    to 15, a code past the codebook reading slot 0) against the plain
    version, two parts of unequal owned counts."""
    _need_card()
    rng = np.random.default_rng(K + shape[1] + 5)
    points, n, o0 = shape
    rows = n ** 3
    offsets = _offsets(points, n)
    codes = rng.integers(0, 16, (2, 7, rows)).astype(np.uint8)
    codes[:, :, ::3] = rng.integers(0, 2, (2, 7, len(range(0, rows, 3))))
    op = dia.CodedOperator(
        cb=torch.from_numpy(rng.standard_normal((2, 7, 2))).to("cuda", dtype),
        no=torch.tensor([rows, rows - 999], dtype=torch.int32, device="cuda"),
        codes=torch.from_numpy(np.ascontiguousarray(dia.pack_nibble_codes(codes).view(np.uint8))).cuda(),
        offsets=offsets, kk=(2,) * 7, code_row=tuple(range(7)), cls_pattern=None, o0=o0,
    )
    assert dia.spmm_nd(op, K, "plain") == 7
    w = o0 + rows + 20
    x = _moved(torch.from_numpy(rng.standard_normal((2, w, K))).to("cuda", dtype), moved)
    dia.reset_launches()
    got = dia.dia_coded_spmm(op, x, w + 3, form=kernel_form)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["dia_coded_spmm"] == 1
    assert torch.equal(got, dia.dia_coded_spmm_plain(op, x, w + 3))


def test_coded_spmm_form_by_shape_on_card():
    """At 192^3 f32 the s-step pair (K = 2, row class) and the LOBPCG block
    (K = 4, select chain) take the staged form by shape, and its launch
    counts once in ``dia_coded_spmm``; a width with no staged plan worth
    its halo takes the row form."""
    _need_card()
    n = 192
    offsets = _offsets(7, n)
    assert dia.spmm_form(offsets, 4, 2, "plain", 1) == dia.SPMM_STAGED
    assert dia.spmm_form(offsets, 4, 4, "plain", 4) == dia.SPMM_STAGED
    assert dia.spmm_form(_offsets(27, n), 4, 12, "plain", 13) == dia.SPMM_ROW


@pytest.mark.parametrize("K", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("rows", [13824, 16 * 1024 + 1], ids=["n13824", "n16385"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [7, 27])
def test_stream_spmm_matches_plain(D, dtype, rows, K):
    """The streaming SpMM against its plain version: two parts of unequal
    owned counts, the band at o0 = 2, a result frame wider than the band,
    the values and the slab (rows one value at a time) at another 16-byte
    phase too; column k equal to K4's plain version on column k."""
    _need_card()
    rng = np.random.default_rng(D + rows + K)
    offsets = _stream_offsets(D, 40)
    vals = torch.from_numpy(rng.standard_normal((2, D, rows))).to("cuda", dtype)
    no = torch.tensor([rows, rows - 777], dtype=torch.int32, device="cuda")
    x = torch.from_numpy(rng.standard_normal((2, rows + 9, K))).to("cuda", dtype)
    want = dia.dia_stream_spmm_plain(vals, x, offsets, no, 2, rows + 13)
    for v, xv in ((vals, x), (_moved(vals, 1), x), (vals, _moved(x, 1))):
        dia.reset_launches()
        got = dia.dia_stream_spmm(v, xv, offsets, no, 2, rows + 13)
        torch.cuda.synchronize()
        assert dia.LAUNCHES["dia_stream_spmm"] == 1
        assert torch.equal(got, want)
    for k in range(K):
        assert torch.equal(want[..., k], dia.dia_stream_spmv_plain(vals, x[..., k].contiguous(), offsets, no, 2,
                                                                   rows + 13))


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "standard"])
def test_block_and_jacobi_loops_on_card(card_systems, fused, precond):
    """On the card, (2,2,2) parts of the 12^3 Poisson operator: the block
    loop (K = 3: b, a random vector, a constant) replayed as a CUDA graph
    equal to the same loop run eagerly, bit for bit, with the same launch
    counts; each column's iterations equal to its solo solve's (Jacobi
    PCG with minv: the solo loop with precond, graph against eager too)."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import make_block_cg_fn, make_cg_fn

    c = card_systems
    dA, b = c["dA"], c["b"]
    lay = dA.col_layout
    own = torch.zeros(tuple(b.shape), dtype=b.dtype, device=b.device)
    for p, no in enumerate(lay.noids.tolist()):
        own[p, lay.o0 : lay.o0 + no] = 1
    rng = np.random.default_rng(3)
    B = torch.stack([b, torch.from_numpy(rng.standard_normal(tuple(b.shape))).to(b) * own, 1e-3 * own],
                    dim=2).contiguous()
    X0 = torch.zeros_like(B)
    minv = own / 6.0 if precond else None
    kw = {} if minv is None else {"minv": minv}
    runs = {}
    for graph in (False, True):
        dia.reset_launches()
        fn = make_block_cg_fn(dA, 1e-8, 500, 3, precond=precond, fused=fused, graph=graph)
        runs[graph] = fn(B, X0, **kw), dict(dia.LAUNCHES), dict(fn.stats)
        torch.cuda.synchronize()
    (ge, ce, se), (gg, cg_, sg) = runs[False], runs[True]
    assert sg["loop"] == "graph" and se["loop"] == "eager" and ce == cg_
    assert _bitwise(ge[0], gg[0]) and _bitwise(ge[1], gg[1]) and np.array_equal(ge[3], gg[3])
    assert np.array_equal(ge[4], gg[4], equal_nan=True)
    its = gg[3]
    assert len(set(its.tolist())) > 1
    for k in range(3):
        solo = make_cg_fn(dA, 1e-8, 500, fused=fused, precond=precond)
        out = solo(B[..., k].contiguous(), X0[..., k].contiguous(), **kw)
        assert out[3] == its[k]


@pytest.mark.parametrize("moved", [0, 1], ids=["aligned", "a-moved"])
@pytest.mark.parametrize("K", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_products_kernel_matches_plain(dtype, K, moved):
    """The block dot's products kernel against its plain version (the
    transposing torch.mul) on three stacked parts, b in a narrower frame,
    rows as 16-byte vectors where K allows and a is aligned; the block dot
    of the kernel's products equal to the solo dot of each column."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _block_pdot_factory, _pdot_factory

    rng = np.random.default_rng(K + 40)
    P, o0, n = 3, 5, 100003
    a = _moved(torch.from_numpy(rng.standard_normal((P, o0 + n + 7, K))).to("cuda", dtype), moved)
    b = torch.from_numpy(rng.standard_normal((P, o0 + n + 2, K))).to("cuda", dtype)
    dia.reset_launches()
    got = sw.block_products(a, b, o0, n)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["block_products"] == 1
    # the column blocks (their padding to the column stride is not written)
    assert torch.equal(got.view(K, -1)[:, : P * n], sw.block_products_plain(a, b, o0, n).view(K, -1)[:, : P * n])
    dots = _block_pdot_factory(o0, n)(a, b)
    for k in range(K):
        assert torch.equal(dots[k], _pdot_factory(o0, n)(a[..., k].contiguous(), b[..., k].contiguous()))


# ---------------------------------------------------------------------------
# E1-E3: the irregular lowerings' products and the strict dot
# ---------------------------------------------------------------------------


def _gpu(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,n,L,o0", [(1, 1, 1, 0), (2, 1000, 7, 3), (3, 2049, 13, 1), (1, 100003, 81, 0),
                                      (2, 4097, 57, 5)],
                         ids=["n1", "n1000", "n2049", "n100003", "n4097-L57"])
def test_ell_spmv_kernel_matches_plain(dtype, P, n, L, o0):
    """E1's A_oo mode against its plain version, bit for bit (signed zeros
    too): slot-major values and random int32 slot columns (P, L, n) into a
    frame wider than the band, a result frame wider still (every slot
    outside the band 0); L = 57 the elasticity operator's width, L = 81 and
    13 past and off the kernel's slot batch."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(n + L)
    wx, width = o0 + n + 11, o0 + n + 5
    vals = _gpu(rng, (P, L, n), dtype)
    cols = torch.from_numpy(rng.integers(0, wx, (P, L, n)).astype(np.int32)).cuda()
    x = _gpu(rng, (P, wx), dtype)
    x[:, ::7] = 0.0
    dia.reset_launches()
    y = irr.ell_spmv(vals, cols, x, o0, width)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["ell_spmv"] == 1
    assert _bits(y) == _bits(irr.ell_spmv_plain(vals, cols, x, o0, width))
    assert not y[:, :o0].any() and not y[:, o0 + n :].any()
    with pytest.raises(ValueError, match="int32"):
        irr.ell_spmv(vals, cols.long(), x, o0, width)


@pytest.mark.parametrize("K", [None, 3], ids=["frame", "slab3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,L", [(1, 1), (777, 5), (5001, 12)], ids=["nb1", "nb777", "nb5001"])
def test_ell_boundary_kernel_matches_plain(nb, L, dtype, K):
    """E1's boundary mode on frames and (P, W, K) slabs, slot-major operands
    with int32 columns: distinct boundary rows a part, a quarter of the
    staged rows padding at the trash slot (left untouched), y updated in
    place from random values, bit for bit the plain version."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(nb + 7 * L)
    P, wy = 3, 2 * nb + 9
    trash = wy - 1
    rows = np.stack([rng.permutation(wy - 1)[:nb] for _ in range(P)])
    rows[:, nb - nb // 4 :] = trash
    rows = torch.from_numpy(rows).cuda()
    wx = nb + 13
    tail = () if K is None else (K,)
    vals = _gpu(rng, (P, L, nb), dtype)
    cols = torch.from_numpy(rng.integers(0, wx, (P, L, nb)).astype(np.int32)).cuda()
    x = _gpu(rng, (P, wx) + tail, dtype)
    y0 = _gpu(rng, (P, wy) + tail, dtype)
    dia.reset_launches()
    y = irr.ell_spmv_boundary(rows, vals, cols, x, y0.clone(), trash)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["ell_spmv_boundary"] == 1
    assert _bits(y) == _bits(irr.ell_spmv_boundary_plain(rows, vals, cols, x, y0.clone(), trash))
    assert torch.equal(y[:, trash], y0[:, trash])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmv_kernel_keeps_negative_zero(dtype):
    """A row whose every term is -0.0 (negative values against +0.0 operand
    slots) sums to -0.0 on the card, as the plain fold does; a row whose
    pads read a positive operand gets +0.0."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    L, n = 5, 3
    x = torch.tensor([[2.0, 0.0, 0.0, -1.0]], dtype=dtype, device="cuda")
    vals = torch.zeros((1, L, n), dtype=dtype, device="cuda")
    cols = torch.zeros((1, L, n), dtype=torch.int32, device="cuda")
    vals[0, :3, 0], cols[0, :3, 0] = -1.0, 1  # all terms -0.0, pads at x[3] < 0: -0.0
    cols[0, 3:, 0] = 3
    vals[0, :2, 1], cols[0, :2, 1] = -1.0, 2  # terms -0.0, pads at x[0] > 0: +0.0
    vals[0, :, 2], cols[0, :, 2] = 1.5, 0
    y = irr.ell_spmv(vals, cols, x, 0, 4)
    assert _bits(y) == _bits(irr.ell_spmv_plain(vals, cols, x, 0, 4))
    assert torch.signbit(y[0, 0]) and not torch.signbit(y[0, 1]) and y[0, 2] == 15.0


def _padded_blocks(rng, P, nn, Lb, bs, full=False):
    """Node-block rows as the staging lays them: counts[p, n] real blocks
    (random values and nodes; every block with ``full``), then pads (value
    0, node 0); node 0 of part 0 full and node 1 empty where there are
    nodes to spare."""
    counts = np.full((P, nn), Lb, dtype=np.int32) if full else rng.integers(0, Lb + 1, (P, nn)).astype(np.int32)
    if nn > 1 and not full:
        counts[0, 0], counts[0, 1] = Lb, 0
    keep = np.arange(Lb)[None, None, :] < counts[..., None]
    vals = np.where(keep[..., None, None], rng.standard_normal((P, nn, Lb, bs, bs)), 0.0)  # pads +0.0
    cols = np.where(keep, rng.integers(0, nn, (P, nn, Lb)), 0)
    return vals, cols.astype(np.int32), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
@pytest.mark.parametrize("nn,Lb,P,xo0,yo0", [(1, 1, 1, 0, 0), (45, 6, 3, 3, 5), (333, 5, 2, 2, 1),
                                            (4099, 17, 2, 7, 3), (4099, 19, 1, 0, 0), (19, 40, 2, 1, 2)],
                         ids=["nn1", "nn45", "nn333", "nn4099", "nn4099-full", "nn19-Lb40"])
def test_bsr_spmv_kernel_matches_plain(nn, Lb, P, xo0, yo0, bs, dtype):
    """E2's A_oo mode on slot-major operands against its plain version on
    the row-major ones, bit for bit: int32 node columns, per-node counts of
    real blocks (0 to Lb; every block real in the ``full`` case), pads
    value 0 at node 0, the node frame at an odd offset inside x, the band at
    another in a wider y (every slot outside it 0), 1 to 3 parts, rows of
    up to 40 blocks."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(nn * bs + Lb)
    wx, width = xo0 + nn * bs + 7, yo0 + nn * bs + 4
    v, c, k = _padded_blocks(rng, P, nn, Lb, bs, full=nn == 4099 and Lb == 19)
    vals, cols, counts = torch.from_numpy(v).to("cuda", dtype), torch.from_numpy(c).cuda(), torch.from_numpy(k).cuda()
    sv, sc = irr.bsr_slot_major(vals), irr.bsr_slot_major(cols)
    x = _gpu(rng, (P, wx), dtype)
    x[:, ::5] = 0.0
    dia.reset_launches()
    y = irr.bsr_spmv(sv, sc, counts, x, xo0, yo0, width)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["bsr_spmv"] == 1
    assert _bits(y) == _bits(irr.bsr_spmv_plain(vals, cols, x, xo0, yo0, width))
    assert not y[:, :yo0].any() and not y[:, yo0 + nn * bs :].any()
    with pytest.raises(ValueError, match="int32"):
        irr.bsr_spmv(sv, sc.long(), counts, x, xo0, yo0, width)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_spmv_kernel_pad_terms(dtype):
    """The pads' terms, which the kernel adds without reading the pads: a
    row of negative values against +0.0 operands sums to -0.0 and its
    pads against x[xo0 + j] > 0 make it +0.0; against x[xo0 + j] < 0 it
    stays -0.0; a NaN at x[xo0] reaches every row with pads and no other;
    all as the plain version's bytes."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    bs, Lb, nn = 3, 4, 3
    for x0, nan in ((1.5, False), (-1.5, False), (1.5, True)):
        vals = torch.zeros((1, nn, Lb, bs, bs), dtype=dtype, device="cuda")
        cols = torch.zeros((1, nn, Lb), dtype=torch.int32, device="cuda")
        counts = torch.tensor([[2, 0, Lb]], dtype=torch.int32, device="cuda")
        vals[0, 0, :2], cols[0, 0, :2] = -1.0, 2  # node 2's slots of x: +0.0
        vals[0, 2], cols[0, 2] = 0.5, 1
        x = torch.tensor([[x0, x0, x0, 1.0, 2.0, 3.0, 0.0, 0.0, 0.0]], dtype=dtype, device="cuda")
        if nan:
            x[0, 0] = float("nan")
        y = irr.bsr_spmv(irr.bsr_slot_major(vals), irr.bsr_slot_major(cols), counts, x, 0, 0, 9)
        want = irr.bsr_spmv_plain(vals, cols, x, 0, 0, 9)
        assert _bits(y) == _bits(want)
        if nan:
            assert torch.isnan(y[0, :6]).all() and not torch.isnan(y[0, 6:]).any()
        else:
            assert (y[0, :3] == 0).all() and bool(torch.signbit(y[0, :3]).all()) == (x0 < 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
@pytest.mark.parametrize("nb,Lb", [(1, 1), (250, 9)], ids=["nb1", "nb250"])
def test_bsr_boundary_kernel_matches_plain(nb, Lb, bs, dtype):
    """E2's boundary mode on one node-block bucket: distinct boundary rows a
    part, the last nodes padding at the trash slot (left untouched), the
    ghost-node frame at g0."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(nb * bs + 3 * Lb)
    P, g0, nhn = 3, 17, 41
    wx = g0 + nhn * bs + 1
    wy = nb * bs + 11
    trash = wy - 1
    rows = np.stack([rng.permutation(wy - 1)[: nb * bs] for _ in range(P)]).reshape(P, nb, bs)
    rows[:, nb - nb // 5 :] = trash
    rows = torch.from_numpy(rows).cuda()
    vals = _gpu(rng, (P, nb, Lb, bs, bs), dtype)
    cols = torch.from_numpy(rng.integers(0, nhn, (P, nb, Lb)).astype(np.int32)).cuda()
    x = _gpu(rng, (P, wx), dtype)
    y0 = _gpu(rng, (P, wy), dtype)
    dia.reset_launches()
    y = irr.bsr_spmv_boundary(rows, vals, cols, x, g0, nhn, y0.clone(), trash)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["bsr_spmv_boundary"] == 1
    assert torch.equal(y, irr.bsr_spmv_boundary_plain(rows, vals, cols, x, g0, nhn, y0.clone(), trash))
    assert torch.equal(y[:, trash], y0[:, trash])


#: width buckets (nodes a part, blocks a node) of the one-launch tests
BUCKETS = {1: [(37, 4)], 2: [(1, 1), (250, 9)], 5: [(33, 3), (7, 11), (64, 2), (1, 5), (19, 7)],
           8: [(40, 19), (41, 17), (40, 16), (41, 15), (40, 13), (41, 12), (40, 10), (3, 1)]}


def _flat_views(arrs, dtype):
    """Arrays laid end to end in one buffer on the card, handed back as
    views (the staging's form)."""
    buf = torch.from_numpy(np.concatenate([a.ravel() for a in arrs])).to("cuda", dtype)
    views, at = [], 0
    for a in arrs:
        views.append(buf[at : at + a.size].view(a.shape))
        at += a.size
    return tuple(views)


@pytest.mark.parametrize("nbk", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_boundary_buckets_in_one_launch(bs, dtype, nbk):
    """E2's boundary mode over 1 to 8 width buckets, views of one flat
    buffer an array: one launch, bit for bit the plain version's loop over
    the buckets, the trash slot untouched."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(100 * bs + nbk)
    P, g0, nhn = 3, 13, 57
    shapes = BUCKETS[nbk]
    total = sum(nb for nb, _ in shapes)
    wx, wy = g0 + nhn * bs + 3, total * bs + 7
    trash = wy - 1
    perm = np.stack([rng.permutation(wy - 1)[: total * bs] for _ in range(P)]).reshape(P, total, bs)
    rows, cols, vals, at = [], [], [], 0
    for nb, Lb in shapes:
        r = perm[:, at : at + nb].copy()
        r[:, nb - nb // 4 :] = trash
        rows.append(r)
        cols.append(rng.integers(0, nhn, (P, nb, Lb)))
        vals.append(rng.standard_normal((P, nb, Lb, bs, bs)))
        at += nb
    rows, cols, vals = _flat_views(rows, torch.int64), _flat_views(cols, torch.int32), _flat_views(vals, dtype)
    x = _gpu(rng, (P, wx), dtype)
    y0 = _gpu(rng, (P, wy), dtype)
    dia.reset_launches()
    y = irr.bsr_spmv_boundary(rows, vals, cols, x, g0, nhn, y0.clone(), trash)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["bsr_spmv_boundary"] == 1
    assert _bits(y) == _bits(irr.bsr_spmv_boundary_plain(rows, vals, cols, x, g0, nhn, y0.clone(), trash))
    assert torch.equal(y[:, trash], y0[:, trash])


def _bits(t):
    return np.asarray(t.cpu().numpy()).tobytes()


#: (n, P, o0) of the E3 card tests: n under one CTA's elements and over
#: many, 1, 3 and 8 parts, aligned and misaligned band offsets
PW_CASES = ([(n, 3, 2) for n in (0, 1, 2, 3, 2047, 2048, 2049, 4097, 100003, 4194305)]
            + [(n, 1, 0) for n in (1, 4096, 100003, 4194305)] + [(n, 8, 1) for n in (1, 2049, 100003)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,P,o0", PW_CASES, ids=[f"n{n}-P{P}-o{o}" for n, P, o in PW_CASES])
def test_pairwise_dot_kernel_matches_numpy_tree(n, dtype, P, o0):
    """E3 bit for bit against its plain version and against the host's
    `pairwise_sum` of the rounded products a part, folded left to right:
    n under one CTA's elements and over many (4194305: over 256 partials
    a part, so the last CTA takes runs of them), 1, 3 and 8 parts, the
    band at an aligned and at misaligned offsets (b's frame wider), one
    launch a dot."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr
    from partitionedarrays_jl_tpu_torch.utils.helpers import pairwise_sum

    rng = np.random.default_rng(n + P)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = rng.standard_normal((P, o0 + n + 3)).astype(npdt)
    b = rng.standard_normal((P, o0 + n + 9)).astype(npdt)
    ga, gb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    dia.reset_launches()
    got = irr.pairwise_dot(ga, gb, o0, n)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["pairwise_dot"] == 1
    assert _bits(got) == _bits(irr.pairwise_dot_plain(ga, gb, o0, n))
    parts = [pairwise_sum(a[p, o0 : o0 + n] * b[p, o0 : o0 + n]) for p in range(P)]
    acc = parts[0]
    for v in parts[1:]:
        acc = acc + v
    assert _bits(got) == np.asarray(acc, dtype=npdt).tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pairwise_dot_signed_zero_and_nan(dtype):
    """E3 keeps the sign of an exact-zero sum (-0.0 products of one part
    sum to -0.0 in the tree, then +0.0 with the zero padding, as numpy's)
    and propagates NaN."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr
    from partitionedarrays_jl_tpu_torch.utils.helpers import pairwise_sum

    npdt = np.float32 if dtype == torch.float32 else np.float64
    for n in (1, 2, 3, 4, 5):
        a = -np.zeros((1, n), dtype=npdt)
        b = np.ones((1, n), dtype=npdt)
        got = irr.pairwise_dot(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(), 0, n)
        want = np.asarray(pairwise_sum(a[0] * b[0]), dtype=npdt)
        assert _bits(got) == want.tobytes()
    a = np.ones((2, 9), dtype=npdt)
    a[1, 4] = np.nan
    got = irr.pairwise_dot(torch.from_numpy(a).cuda(), torch.from_numpy(a).cuda(), 0, 9)
    assert torch.isnan(got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pairwise_dot_in_a_cuda_graph(dtype):
    """Two E3 dots captured in one CUDA graph (one of 3 parts over many
    CTAs, one of 8 small parts), replayed three times: the same bytes each
    replay as the eager dots, so the kernel leaves its ticket at 0; one
    launch each at capture."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(11)
    a, b = _gpu(rng, (3, 300007), dtype), _gpu(rng, (3, 300009), dtype)
    c, d = _gpu(rng, (8, 2100), dtype), _gpu(rng, (8, 2100), dtype)
    want = (_bits(irr.pairwise_dot_plain(a, b, 5, 300000)), _bits(irr.pairwise_dot_plain(c, d, 1, 2049)))
    irr.pairwise_dot(a, b, 5, 300000), irr.pairwise_dot(c, d, 1, 2049)  # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    dia.reset_launches()
    with torch.cuda.graph(g):
        r1 = irr.pairwise_dot(a, b, 5, 300000)
        r2 = irr.pairwise_dot(c, d, 1, 2049)
    assert dia.LAUNCHES["pairwise_dot"] == 2
    for _ in range(3):
        r1.fill_(7.0), r2.fill_(7.0)
        g.replay()
        torch.cuda.synchronize()
        assert (_bits(r1), _bits(r2)) == want
    assert (_bits(irr.pairwise_dot(a, b, 5, 300000)), _bits(irr.pairwise_dot(c, d, 1, 2049))) == want


def test_pairwise_dot_back_to_back():
    """Dots queued back to back on one stream, of other shapes and parts,
    each its plain version's bytes (each finds the ticket at 0)."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(12)
    cases = [(_gpu(rng, (P, n + 4), dt), _gpu(rng, (P, n + 4), dt), n)
             for P, n, dt in ((1, 7077888, torch.float32), (8, 13824, torch.float64), (3, 5, torch.float32),
                              (1, 7077888, torch.float32), (2, 100003, torch.float64))]
    got = [irr.pairwise_dot(a, b, 2, n) for a, b, n in cases]
    torch.cuda.synchronize()
    for (a, b, n), g in zip(cases, got):
        assert _bits(g) == _bits(irr.pairwise_dot_plain(a, b, 2, n))


def test_strict_cg_matches_sequential_on_card():
    """Strict CG (ELL lowering, E1 and E3) on the card against the port's
    sequential strict loop, 6^3 Poisson on (2,2,2) parts, f64: iterations,
    residual history and solution bit for bit."""
    _need_card()

    def drive(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        x, info = pt.cg(A, b, x0=x0, tol=1e-8, maxiter=400, strict=True)
        return pt.gather_pvector(x), info

    xs, info_s = pt.prun(drive, pt.sequential, (2, 2, 2))
    dia.reset_launches()
    xg, info_g = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))
    assert info_g["lowering"] == "ell" and info_g["cg_body"] == "standard"
    assert dia.LAUNCHES["ell_spmv"] > 0 and dia.LAUNCHES["pairwise_dot"] > 0
    assert info_s["iterations"] == info_g["iterations"]
    assert np.asarray(info_s["residuals"]).tobytes() == np.asarray(info_g["residuals"]).tobytes()
    assert xs.tobytes() == xg.tobytes()


@pytest.mark.parametrize("lowering", ["auto", "bsr", "ell"])
def test_elasticity_lowerings_on_card(lowering):
    """The tet-elasticity operator on 4 stacked parts in each lowering: the
    SpMV against the host product to rounding, Jacobi PCG with the
    sequential backend's iterations and solution to 1e-10."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, device_matrix, make_spmv_fn

    def drive(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (6, 6, 6))
        x, info = pt.pcg(A, b, x0=x0, tol=1e-12, maxiter=500, lowering=lowering)
        y = None
        if isinstance(parts.backend, pt.GPUBackend):
            dA = device_matrix(A, parts.backend, lowering=lowering)
            dx = DeviceVector.from_pvector(xh, parts.backend, dA.col_layout)
            y = pt.gather_pvector(DeviceVector(make_spmv_fn(dA)(dx.data), A.rows, dA.row_layout,
                                               parts.backend).to_pvector())
        return pt.gather_pvector(x), info, y, pt.gather_pvector(A @ xh)

    xs, info_s, _, _ = pt.prun(drive, pt.sequential, 4)
    dia.reset_launches()
    xg, info_g, y, host = pt.prun(drive, pt.GPUBackend(), 4)
    if lowering != "ell":
        # E2's boundary mode: one launch an SpMV, whatever the bucket count
        spmvs = 2 + info_g["device_loop"]["device_iterations"]
        assert dia.LAUNCHES["bsr_spmv_boundary"] == spmvs
    assert info_g["lowering"] == {"auto": "sd"}.get(lowering, lowering)
    np.testing.assert_allclose(y, host, rtol=1e-12, atol=1e-12)
    assert info_g["iterations"] == info_s["iterations"]
    np.testing.assert_allclose(xg, xs, rtol=0, atol=1e-10)


def test_strict_elasticity_pcg_on_card():
    """Strict Jacobi PCG on the tet-elasticity system assembled in strict
    mode, 4 stacked parts (ELL, E1 in both modes, E3): iterations, residual
    history and solution bit for bit the port's sequential strict PCG."""
    _need_card()

    def drive(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (5, 4, 6), strict=True)
        x, info = pt.pcg(A, b, x0=x0, tol=1e-12, maxiter=500, strict=True)
        return pt.gather_pvector(x), info

    xs, info_s = pt.prun(drive, pt.sequential, 4)
    dia.reset_launches()
    xg, info_g = pt.prun(drive, pt.GPUBackend(), 4)
    assert info_g["lowering"] == "ell" and dia.LAUNCHES["ell_spmv"] > 0 and dia.LAUNCHES["ell_spmv_boundary"] > 0
    assert info_s["iterations"] == info_g["iterations"]
    assert np.asarray(info_s["residuals"]).tobytes() == np.asarray(info_g["residuals"]).tobytes()
    assert xs.tobytes() == xg.tobytes()


# ---------------------------------------------------------------------------
# the slab forms of E1-E3 and the block solves on the irregular lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3, 5, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,n,L,o0", [(1, 1, 1, 0), (2, 1000, 7, 3), (1, 4097, 57, 5)],
                         ids=["n1", "n1000", "n4097-L57"])
def test_ell_spmm_kernel_matches_plain_and_frames(dtype, P, n, L, o0, K):
    """E1 on (P, W, K) slabs (K past the kernel's 8 register columns: two
    column chunks): bit for bit its plain version and the frame kernel on
    each column, one launch, rows outside the band 0."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(n + L + K)
    wx, width = o0 + n + 11, o0 + n + 5
    vals = _gpu(rng, (P, L, n), dtype)
    cols = torch.from_numpy(rng.integers(0, wx, (P, L, n)).astype(np.int32)).cuda()
    x = _gpu(rng, (P, wx, K), dtype)
    x[:, ::7] = 0.0
    dia.reset_launches()
    y = irr.ell_spmm(vals, cols, x, o0, width)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["ell_spmm"] == 1
    assert _bits(y) == _bits(irr.ell_spmm_plain(vals, cols, x, o0, width))
    for k in range(K):
        assert _bits(y[..., k]) == _bits(irr.ell_spmv(vals, cols, x[..., k].contiguous(), o0, width))


@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 11, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
@pytest.mark.parametrize("nn,Lb,P,xo0,yo0", [(1, 1, 1, 0, 0), (333, 5, 2, 2, 1), (4099, 19, 1, 0, 0)],
                         ids=["nn1", "nn333", "nn4099"])
def test_bsr_spmm_kernel_matches_plain_and_frames(nn, Lb, P, xo0, yo0, bs, dtype, K, shift):
    """E2 on slabs: bit for bit its plain version (on the row-major
    operands) and the frame kernel on each column, pads and their terms
    included (an infinity at the first node of x makes rows with pads NaN),
    one launch; K = 4, 8 take the kernel's vector loads, K = 3, 5, 11 its
    scalar lanes (11: two column chunks), K = 36 vector lanes in two chunks
    (the second with an idle lane), and a slab that starts one element past
    a 16-byte boundary (``shift``) scalar lanes at every K."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(nn * bs + Lb + K)
    wx, width = xo0 + nn * bs + 7, yo0 + nn * bs + 4
    v, c, k = _padded_blocks(rng, P, nn, Lb, bs)
    vals, cols, counts = torch.from_numpy(v).to("cuda", dtype), torch.from_numpy(c).cuda(), torch.from_numpy(k).cuda()
    sv, sc = irr.bsr_slot_major(vals), irr.bsr_slot_major(cols)
    x = torch.empty(P * wx * K + shift, dtype=dtype, device="cuda")[shift:].view(P, wx, K)
    x.copy_(_gpu(rng, (P, wx, K), dtype))
    assert (x.data_ptr() % 16 == 0) == (shift == 0)
    x[:, ::5] = 0.0
    x[0, xo0, 0] = float("inf")
    dia.reset_launches()
    y = irr.bsr_spmm(sv, sc, counts, x, xo0, yo0, width)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["bsr_spmm"] == 1
    assert _bits(y) == _bits(irr.bsr_spmm_plain(vals, cols, x, xo0, yo0, width))
    for col in range(K):
        assert _bits(y[..., col]) == _bits(irr.bsr_spmv(sv, sc, counts, x[..., col].contiguous(), xo0, yo0, width))


@pytest.mark.parametrize("K", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_boundary_slab_kernel_matches_plain_and_frames(bs, dtype, K):
    """E2's boundary mode on slabs over 5 width buckets in one launch (the
    frame's kernel, counted under its name): bit for bit its plain version
    and the frame call on each column; the trash slot untouched."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(bs * 7 + K)
    P, nhn, g0, wy = 2, 40, 3, 900
    trash = wy - 1
    shapes = [(30, 2), (25, 3), (20, 5), (10, 8), (4, 12)]
    slots = rng.permutation(wy - 1)[: sum(nb for nb, _ in shapes) * bs].reshape(-1, bs)
    rows_l, vals_l, cols_l, at = [], [], [], 0
    for nb, Lb in shapes:
        r = np.stack([slots[at : at + nb]] * P)
        r[:, -1, :] = trash
        rows_l.append(r.astype(np.int64))
        vals_l.append(rng.standard_normal((P, nb, Lb, bs, bs)))
        cols_l.append(rng.integers(0, nhn, (P, nb, Lb)).astype(np.int32))
        at += nb
    rows, cols, vals = _flat_views(rows_l, torch.int64), _flat_views(cols_l, torch.int32), _flat_views(vals_l, dtype)
    x = _gpu(rng, (P, g0 + nhn * bs + 2, K), dtype)
    y0 = _gpu(rng, (P, wy, K), dtype)
    dia.reset_launches()
    y = irr.bsr_spmv_boundary(rows, vals, cols, x, g0, nhn, y0.clone(), trash)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["bsr_spmv_boundary"] == 1
    assert _bits(y) == _bits(irr.bsr_spmv_boundary_plain(rows, vals, cols, x, g0, nhn, y0.clone(), trash))
    assert torch.equal(y[:, trash], y0[:, trash])
    for k in range(K):
        want = irr.bsr_spmv_boundary(rows, vals, cols, x[..., k].contiguous(), g0, nhn, y0[..., k].clone(), trash)
        assert _bits(y[..., k]) == _bits(want)


PWB_CASES = [(n, 3, 2) for n in (0, 1, 2049, 100003)] + [(4194305, 1, 0), (13824, 8, 1)]


@pytest.mark.parametrize("K", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,P,o0", PWB_CASES, ids=[f"n{n}-P{P}-o{o}" for n, P, o in PWB_CASES])
def test_pairwise_dot_block_kernel_matches_plain_and_frames(n, P, o0, dtype, K):
    """E3's block form: bit for bit its plain version and the frame kernel
    on each column (n under one CTA's elements and past 256 partials a
    part, 1, 3 and 8 parts), one launch; then the same bytes replayed in a
    CUDA graph beside a frame dot (the ticket left at 0)."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    rng = np.random.default_rng(n + P + K)
    a = _gpu(rng, (P, o0 + n + 3, K), dtype)
    b = _gpu(rng, (P, o0 + n + 9, K), dtype)
    dia.reset_launches()
    got = irr.pairwise_dot_block(a, b, o0, n)
    torch.cuda.synchronize()
    assert dia.LAUNCHES["pairwise_dot_block"] == 1
    assert _bits(got) == _bits(irr.pairwise_dot_block_plain(a, b, o0, n))
    frames = [irr.pairwise_dot(a[..., k].contiguous(), b[..., k].contiguous(), o0, n) for k in range(K)]
    assert _bits(got) == _bits(torch.stack(frames))
    a0, b0 = a[..., 0].contiguous(), b[..., 0].contiguous()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        r1 = irr.pairwise_dot_block(a, b, o0, n)
        r2 = irr.pairwise_dot(a0, b0, o0, n)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert _bits(r1) == _bits(got) and _bits(r2) == _bits(frames[0])


def test_pairwise_dot_block_signed_zero():
    """A column of -0.0 products keeps the sign where the frame form does."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    for n in (1, 2, 3, 5):
        a = -torch.zeros((1, n, 3), dtype=torch.float64, device="cuda")
        a[..., 1] = 1.0
        b = torch.ones((1, n, 3), dtype=torch.float64, device="cuda")
        got = irr.pairwise_dot_block(a, b, 0, n)
        for k in range(3):
            assert _bits(got[k]) == _bits(irr.pairwise_dot(a[..., k].contiguous(), b[..., k].contiguous(), 0, n))


@pytest.mark.parametrize("lowering", ["auto", "bsr", "ell"])
def test_block_elasticity_pcg_on_card(lowering):
    """Block Jacobi PCG on the tet-elasticity system, 4 stacked parts, K = 3
    (the model's b and two A x̂_k), in each lowering: each column the
    iterations of its solo solve on the card and its solution bit for bit
    (BSR, ELL); on SD, where cuBLAS orders a K-column product its own way,
    within one iteration and 1e-8 of the largest |x| (chip_smoke.py's
    SD_ITERATIONS_APART, SD_X_REL_TOL); the slab kernels launched by the
    formula (SpMM and boundary 1 + 1 a device iteration)."""
    _need_card()

    def drive(parts):
        A, b, xh, x0 = pt.assemble_elasticity_tet(parts, (6, 6, 6))
        B = [b, A @ (xh * 0.5), A @ (xh * 0.25)]
        dia.reset_launches()
        xs, info = pt.pcg(A, B=B, X0=[x0] * 3, tol=1e-12, maxiter=500, lowering=lowering)
        launches = dict(dia.LAUNCHES)
        solo = [pt.pcg(A, bk, x0=x0, tol=1e-12, maxiter=500, lowering=lowering) for bk in B]
        return info, launches, [pt.gather_pvector(x) for x in xs], [(pt.gather_pvector(x), i) for x, i in solo]

    info, launches, xs, solo = pt.prun(drive, pt.GPUBackend(), 4)
    spmvs = 1 + info["device_loop"]["device_iterations"]
    if lowering == "bsr":
        assert launches["bsr_spmm"] == spmvs
    if lowering == "ell":
        assert launches["ell_spmm"] == spmvs and launches["ell_spmv_boundary"] == spmvs
    else:
        assert launches["bsr_spmv_boundary"] == spmvs
    assert launches["cg_sweep_block"] == spmvs - 1
    for k, (xk, ik) in enumerate(solo):
        if lowering == "auto":
            assert abs(info["iterations_per_column"][k] - ik["iterations"]) <= 1
            np.testing.assert_allclose(xs[k], xk, rtol=0, atol=1e-8 * max(1.0, np.abs(xk).max()))
        else:
            assert info["iterations_per_column"][k] == ik["iterations"]
            assert xs[k].tobytes() == xk.tobytes()


def test_strict_block_cg_on_card():
    """Strict block CG on the card (ELL, E1's slab and boundary forms, E3's
    block form), 6^3 Poisson on (2,2,2) parts, f64, K = 2: every column's
    iterations, residual history and solution bit for bit the port's
    sequential strict solo solve; E3 one block launch a dot."""
    _need_card()

    def drive(parts, block):
        A, _, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        B = [A.mul_into(pt.PVector.full(0.0, A.rows), xe * s, strict=True) for s in (1.0, 0.5)]
        X0 = [x0, x0 * 0.5]
        if block:
            xs, info = pt.cg(A, B=B, X0=X0, tol=1e-8, maxiter=400, strict=True)
            return [pt.gather_pvector(x) for x in xs], info
        out = [pt.cg(A, bk, x0=x0k, tol=1e-8, maxiter=400, strict=True) for bk, x0k in zip(B, X0)]
        return [pt.gather_pvector(x) for x, _ in out], [i for _, i in out]

    xs, solo = pt.prun(drive, pt.sequential, (2, 2, 2), False)
    dia.reset_launches()
    xg, info = pt.prun(drive, pt.GPUBackend(), (2, 2, 2), True)
    assert info["strict"] and info["lowering"] == "ell" and info["cg_body"] == "standard"
    dev_it = info["device_loop"]["device_iterations"]
    assert dia.LAUNCHES["ell_spmm"] == 1 + dev_it and dia.LAUNCHES["pairwise_dot_block"] == 1 + 2 * dev_it
    for k in range(2):
        assert info["iterations_per_column"][k] == solo[k]["iterations"]
        assert np.asarray(info["columns"][k]["residuals"]).tobytes() == np.asarray(solo[k]["residuals"]).tobytes()
        assert xg[k].tobytes() == xs[k].tobytes()


def test_strict_gmg_pcg_on_card():
    """Strict GMG-PCG on the card (every level and S on the ELL lowering
    and the generic plan, E1 in both modes, E3's dots), 12^3 Poisson on
    (2,2,2) parts, f64, decoupled, coarse_threshold=30: the port's
    sequential strict solve's iterations, the solution to 1e-12 relative
    (rounding: the V-cycle's products are not the host's); E3 1 + 3 per
    device iteration; the kernel path bit for bit the plain versions'."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    def drive(parts, plain):
        A, _, xe, x0 = pt.assemble_poisson(parts, (12, 12, 12))
        b = A.mul_into(pt.PVector.full(0.0, A.rows), xe, strict=True)
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=30)
        if plain:
            x, info = gpu_gmg.gpu_gmg_pcg(h, bh, tol=1e-10, plain=True, strict=True)
        else:
            x, info = pt.pcg(Ah, bh, minv=h, tol=1e-10, strict=True)
        return pt.gather_pvector(x), info

    xs, info_s = pt.prun(drive, pt.sequential, (2, 2, 2), False)
    dia.reset_launches()
    xg, info = pt.prun(drive, pt.GPUBackend(), (2, 2, 2), False)
    launches = dict(dia.LAUNCHES)
    xp, info_p = pt.prun(drive, pt.GPUBackend(), (2, 2, 2), True)
    assert info["strict"] and info["lowering"] == "ell" and info["device_loop"]["loop"] == "graph"
    assert info["iterations"] == info_s["iterations"] == info_p["iterations"]
    assert np.linalg.norm(xg - xs) <= 1e-12 * np.linalg.norm(xs)
    assert xg.tobytes() == xp.tobytes()
    dev_it = info["device_loop"]["device_iterations"]
    assert launches["pairwise_dot"] == 1 + 3 * dev_it and launches["dia_coded_spmv"] == 0
    assert launches["ell_spmv"] > 0 and launches["box_stencil_apply"] == 0


def test_fem_q1_cg_matches_plain_on_card():
    """The Q1 model's fused CG on the card (the 9-point operator, coded)
    at 64 x 64 nodes on (2,2) parts: the plain path's and the sequential
    backend's iterations, err < 1e-5, the kernel solve bit for bit the
    plain one's."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import gpu_cg

    def drive(parts, plain):
        A, b, xe, x0 = pt.assemble_fem_q1(parts, (64, 64))
        if plain:
            x, info = gpu_cg(A, b, x0=x0, tol=1e-10, maxiter=4000, plain=True)
        else:
            x, info = pt.cg(A, b, x0=x0, tol=1e-10, maxiter=4000)
        return pt.gather_pvector(x), float((x - xe).norm()), info

    x, err, info = pt.prun(drive, pt.GPUBackend(), (2, 2), False)
    xp, err_p, info_p = pt.prun(drive, pt.GPUBackend(), (2, 2), True)
    _, err_s, info_s = pt.prun(drive, pt.sequential, (2, 2), False)
    assert info["lowering"] == "coded" and info["cg_body"] == "fused" and info["converged"]
    assert info["iterations"] == info_p["iterations"] == info_s["iterations"]
    assert err < 1e-5 and abs(err - err_s) < 1e-9
    assert x.tobytes() == xp.tobytes()


def test_heat_march_captures_once_on_card():
    """The heat march at 12^3 on (2,2,2) parts, 8 steps: one staging, one
    solve function, one CUDA graph capture over the march; per-step
    iterations the sequential march's."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg, gpu_loop

    def drive(parts):
        return pt.heat_transient_driver(parts, (12, 12, 12), dt=0.5, nsteps=8)

    before = {**gpu_gmg.STATS, **gpu_loop.STATS}
    err, its = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))
    after = {**gpu_gmg.STATS, **gpu_loop.STATS}
    assert {k: after[k] - before[k] for k in before} == {"stagings": 1, "pcg_fns": 1, "captures": 1}
    err_s, its_s = pt.prun(drive, pt.sequential, (2, 2, 2))
    assert its == its_s
    np.testing.assert_allclose(err, err_s, rtol=1e-6)


@pytest.mark.parametrize("n", [64, 257], ids=["n64", "n257"])
def test_k1_k2_on_the_q1_operator(n):
    """K1 and K2 on the Q1 model's 9-point operator (f64, (2,2) parts of
    equal and unequal boxes, the decode its staging takes) torch.equal to
    their plain versions."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import device_matrix

    A = pt.prun(lambda parts: pt.assemble_fem_q1(parts, (n, n))[0], pt.GPUBackend(), (2, 2))
    dA = device_matrix(A, A.values.backend)
    # 9 diagonals on equal boxes; unequal boxes (n = 257) shift some
    # parts' row strides, so the union of offsets is wider
    assert dA.dia_mode == "coded" and len(dA.coded.offsets) >= 9
    op, P, wx, wy = dA.coded, dA.col_layout.P, dA.col_layout.W, dA.row_layout.W
    rng = np.random.default_rng(n)

    def frame():
        return torch.from_numpy(rng.standard_normal((P, wx))).cuda()

    x, r, pprev = frame(), frame(), frame()
    beta = torch.tensor(0.37, dtype=torch.float64, device="cuda")
    assert torch.equal(dia.dia_coded_spmv(op, x, wy), dia.dia_coded_spmv_plain(op, x, wy))
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy)
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)


def _krylov_system(parts, kind):
    """The small systems of the new device solvers: the advection operator
    (nonsymmetric, BiCGStab and GMRES) or the decoupled Poisson operator
    (symmetric, MINRES and Chebyshev), 10x10x6 f64."""
    if kind == "advection":
        A, b, _, x0 = pt.assemble_advection_fv(parts, (10, 10, 6), velocity=(1.0, -0.5, 0.25))
        return A, b, x0
    A, b, _, _ = pt.assemble_poisson(parts, (10, 10, 6))
    Ah, bh = pt.decouple_dirichlet(A, b)
    return Ah, bh, pt.PVector.full(0.0, Ah.cols)


KRYLOV_CASES = [("bicgstab", "advection", {}), ("bicgstab_jacobi", "advection", {}),
                ("gmres", "advection", {"restart": 7}), ("gmres_jacobi", "advection", {"restart": 7}),
                ("minres", "poisson", {}), ("chebyshev", "poisson", {"lmin": 0.3, "lmax": 12.5})]


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2)], ids=["1part", "8parts"])
@pytest.mark.parametrize("name,kind,opts", KRYLOV_CASES, ids=[c[0] for c in KRYLOV_CASES])
def test_new_krylov_graph_matches_eager_and_plain(name, kind, opts, grid):
    """Each new device solver on the card: the graph loop torch.equal to the
    same loop run eagerly (x, rs, history, iterations), with replays; the
    kernel path's iterations and x equal to the plain path's."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_krylov as kr
    from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, _b_on_cols_layout, device_matrix

    method = name.split("_")[0]
    precond = name.endswith("jacobi")

    def drive(parts):
        A, b, x0 = _krylov_system(parts, kind)
        dA = device_matrix(A, parts.backend)
        db = _b_on_cols_layout(b, dA)
        dx0 = DeviceVector.from_pvector(x0, parts.backend, dA.col_layout).data
        args = (_b_on_cols_layout(pt.jacobi_preconditioner(A), dA),) if precond else ()
        tol, maxiter = (0.0, 70) if method in ("gmres", "chebyshev") else (1e-10, 400)

        def make(graph, plain=False):
            if method == "bicgstab":
                return kr.make_bicgstab_fn(dA, tol, maxiter, precond=precond, plain=plain, graph=graph)
            if method == "gmres":
                return kr.make_gmres_fn(dA, opts["restart"], tol, maxiter, precond=precond, plain=plain, graph=graph)
            if method == "minres":
                return kr.make_minres_fn(dA, tol, maxiter, plain=plain, graph=graph)
            return kr.make_chebyshev_fn(dA, opts["lmin"], opts["lmax"], tol, maxiter, plain=plain, graph=graph)

        fg, fe, fp = make(True), make(False), make(True, plain=True)
        xg, rsg, _, itg, hg = fg(db, dx0, *args)
        xe, rse, _, ite, he = fe(db, dx0, *args)
        xp, _, _, itp, _ = fp(db, dx0, *args)
        torch.cuda.synchronize()
        return (torch.equal(xg, xe), torch.equal(rsg, rse), np.array_equal(hg, he, equal_nan=True), itg == ite,
                fg.stats["loop"], fe.stats["loop"], fg.stats["replays"] > 0, itg == itp, torch.equal(xg, xp))

    got = pt.prun(drive, pt.GPUBackend(), grid)
    assert got == (True, True, True, True, "graph", "eager", True, True, True), got


@pytest.mark.parametrize("stencil", [True, False], ids=["stencil", "structured"])
def test_fgmres_gmg_graph_matches_eager_and_plain(stencil):
    """FGMRES with the V-cycle inlined on the card (12^3 f64, (2,2,2), ct 100,
    restart 4, fixed 12 Arnoldi steps: three cycles): graph torch.equal to
    eager, the kernel path torch.equal to the plain path; to tol 1e-9 within
    one iteration of the host fgmres(minv=h)."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _b_on_cols_layout

    def drive(parts):
        A, b, xe, _ = pt.assemble_poisson(parts, (12, 12, 12))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=100)
        fg = gpu_gmg.make_fgmres_gmg_fn(h, parts.backend, 0.0, 12, restart=4, stencil=stencil)
        fe = gpu_gmg.make_fgmres_gmg_fn(h, parts.backend, 0.0, 12, restart=4, stencil=stencil, graph=False)
        fp = gpu_gmg.make_fgmres_gmg_fn(h, parts.backend, 0.0, 12, restart=4, stencil=stencil, plain=True)
        db = _b_on_cols_layout(bh, fg.staged["levels"][0]["dA"])
        z = torch.zeros_like(db)
        xg, rsg, _, itg, hg = fg(db, z)
        xe, rse, _, ite, he = fe(db, z)
        xp, _, _, itp, _ = fp(db, z)
        _, info = pt.gpu_fgmres_gmg(h, bh, tol=1e-9, restart=10, stencil=stencil)
        _, host = pt.fgmres(Ah, bh, minv=h, tol=1e-9, restart=10)
        return (torch.equal(xg, xe), torch.equal(rsg, rse), np.array_equal(hg, he, equal_nan=True), itg == ite == 12,
                fg.stats["replays"] > 0, itp == itg, torch.equal(xg, xp), info["converged"],
                abs(info["iterations"] - host["iterations"]) <= 1)

    assert pt.prun(drive, pt.GPUBackend(), (2, 2, 2)) == (True,) * 9


def test_diff_solve_on_card():
    """The differentiable solve on the card (decoupled 10x10x6 Poisson,
    (2,2,2)): one capture for forward and backward, the vector-Jacobian
    product torch.equal to a forward solve of the cotangent."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _b_on_cols_layout, device_matrix

    def drive(parts):
        A, b, x0 = _krylov_system(parts, "poisson")
        dA = device_matrix(A, parts.backend)
        before = gpu_loop.STATS["captures"]
        f = pt.make_diff_solve_fn(dA, tol=1e-10)
        bv = _b_on_cols_layout(b, dA).requires_grad_(True)
        x = f(bv)
        xbar = torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=torch.Generator("cuda").manual_seed(0))
        (g,) = torch.autograd.grad(x, bv, grad_outputs=xbar)
        with torch.no_grad():
            again = f(xbar)
        return torch.equal(g, again), gpu_loop.STATS["captures"] - before

    assert pt.prun(drive, pt.GPUBackend(), (2, 2, 2)) == (True, 1)


def test_one_block_solve_captures_at_its_second_run():
    """A cached solve that ends in its first block (FGMRES-GMG whose restart
    exceeds its iterations: one cycle) runs that block eagerly on its first
    run and captures nothing; its second run captures before the block and
    replays it, with the first run's result bit for bit; the third captures
    nothing more."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (12, 12, 12))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (12, 12, 12), coarse_threshold=100)
        out = []
        for _ in range(3):
            before = gpu_loop.STATS["captures"]
            x, info = pt.gpu_fgmres_gmg(h, bh, tol=1e-6, restart=30)
            loop = info["device_loop"]
            out.append((pt.gather_pvector(x).tobytes(), info["iterations"], loop["device_iterations"],
                        loop["replays"], gpu_loop.STATS["captures"] - before))
        return out

    (x1, it1, d1, r1, c1), (x2, it2, d2, r2, c2), (x3, it3, d3, r3, c3) = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))
    assert it1 < 30 and d1 == d2 == d3 == 1
    assert (r1, c1) == (0, 0) and (r2, c2) == (1, 1) and (r3, c3) == (1, 0)
    assert x1 == x2 == x3 and it1 == it2 == it3


# ---------------------------------------------------------------------------
# the rest of the solver family: s-step CG, the overlap tail, the stationary
# GMG solve and the W-cycle, agglomeration, LOBPCG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", [{"sstep": 2}, {"sstep": 4}, {"fused": True}, {"fused": False},
                                  {"pipelined": True}], ids=["sstep2", "sstep4", "fused", "standard", "pipelined"])
@pytest.mark.parametrize("box", [True, False], ids=["box", "generic"])
def test_cg_bodies_overlap_graph_and_plain_on_card(body, box):
    """Every CG body on (2,2,2) stacked parts, 16^3 f64 decoupled Poisson: the
    overlap tail (the halo exchange on a side stream) torch.equal to the
    plain tail, in the captured graph; the graph loop torch.equal to the
    eager loop; the kernel path's iterations and x equal to the plain
    path's."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _b_on_cols_layout, device_matrix, make_cg_fn

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, bh = pt.decouple_dirichlet(A, b)
        dA = device_matrix(Ah, parts.backend, box)
        db = _b_on_cols_layout(bh, dA)
        z = torch.zeros_like(db)
        runs = [make_cg_fn(dA, 1e-9, 400, overlap=ov, graph=g, **body)(db, z)
                for ov, g in ((False, True), (True, True), (False, False))]
        xp, _, _, itp, _ = make_cg_fn(dA, 1e-9, 400, plain=True, **body)(db, z)
        (x0, rs0, _, it0, h0), (x1, rs1, _, it1, h1), (x2, rs2, _, it2, h2) = runs
        return (torch.equal(x0, x1) and torch.equal(rs0, rs1) and it0 == it1 and np.array_equal(h0, h1, equal_nan=True),
                torch.equal(x0, x2) and it0 == it2, it0 == itp and torch.equal(x0, xp))

    assert pt.prun(drive, pt.GPUBackend(), (2, 2, 2)) == (True, True, True)


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_gmg_solve_graph_and_plain_on_card(cycle):
    """The stationary GMG solve on the card (16^3 f64, (2,2,2), ct 30): the
    graph loop torch.equal to the eager loop and the kernel path to the
    plain path; the host loop's iterations; a W-cycle against its plain
    version."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _b_on_cols_layout

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, bh = pt.decouple_dirichlet(A, b)
        h = pt.gmg_hierarchy(parts, Ah, (16, 16, 16), coarse_threshold=30, cycle=cycle)
        fg = gpu_gmg.make_gmg_solve_fn(h, parts.backend, 1e-9, 100)
        fe = gpu_gmg.make_gmg_solve_fn(h, parts.backend, 1e-9, 100, graph=False)
        fp = gpu_gmg.make_gmg_solve_fn(h, parts.backend, 1e-9, 100, plain=True)
        db = _b_on_cols_layout(bh, fg.staged["levels"][0]["dA"])
        z = torch.zeros_like(db)
        (xg, rsg, _, itg, hg), (xe, rse, _, ite, he), (xp, _, _, itp, _) = fg(db, z), fe(db, z), fp(db, z)
        return (torch.equal(xg, xe) and torch.equal(rsg, rse) and itg == ite and np.array_equal(hg, he, equal_nan=True),
                fg.stats["replays"] > 0, itp == itg and torch.equal(xg, xp), itg)

    eq, replayed, plain, it = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))

    def host(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, bh = pt.decouple_dirichlet(A, b)
        return pt.gmg_solve(pt.gmg_hierarchy(parts, Ah, (16, 16, 16), coarse_threshold=30, cycle=cycle), bh,
                            tol=1e-9)[1]["iterations"]

    assert eq and replayed and plain and it == pt.prun(host, pt.sequential, (2, 2, 2))


def test_agglomerated_hierarchy_on_card():
    """An agglomerated hierarchy (24^3 f64, (2,2,2), ct 100, threshold 2000)
    on the card: its assembled route's E1 products and one V-cycle equal to
    their plain versions, and GMG-PCG in the full-mesh hierarchy's
    iterations."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (24, 24, 24))
        Ah, bh = pt.decouple_dirichlet(A, b)
        its = []
        for agg in (0, 2000):
            h = pt.gmg_hierarchy(parts, Ah, (24, 24, 24), coarse_threshold=100, agg_threshold=agg)
            its.append(pt.pcg(Ah, bh, minv=h, tol=1e-9)[1]["iterations"])
        dh = gpu_gmg.device_hierarchy(h, parts.backend)
        L0 = dh["levels"][0]["dA"].col_layout
        r = torch.zeros((L0.P, L0.W), dtype=torch.float64, device="cuda")
        r[:, L0.o0 : L0.o0 + L0.no_max] = torch.randn((L0.P, L0.no_max), dtype=torch.float64, device="cuda")
        equal = torch.equal(gpu_gmg.make_vcycle(h, dh)(r.clone()), gpu_gmg.make_vcycle(h, dh, plain=True)(r.clone()))
        return its, equal, "assembled" in [gpu_gmg.route(lv) for lv in dh["levels"]]

    its, equal, assembled = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))
    assert its[0] == its[1] and equal and assembled


@pytest.mark.parametrize("minv", ["none", "jacobi", "gmg"])
def test_lobpcg_on_card_matches_plain(minv):
    """LOBPCG on the card (the decoupled 16^3 f64 Poisson, (2,2,2), nev 3):
    the kernel path's iterations and eigenvalues equal to the plain path's,
    the eigenvalues within 1e-8 of the host loop's."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu_lobpcg import gpu_lobpcg

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, _ = pt.decouple_dirichlet(A, b)
        m = {"none": None, "jacobi": pt.jacobi_preconditioner(Ah),
             "gmg": pt.gmg_hierarchy(parts, Ah, (16, 16, 16), coarse_threshold=30)}[minv]
        lam, _, info = gpu_lobpcg(Ah, nev=3, minv=m, tol=1e-8, maxiter=400)
        lamp, _, infop = gpu_lobpcg(Ah, nev=3, minv=m, tol=1e-8, maxiter=400, plain=True)
        return lam, info, lamp, infop

    lam, info, lamp, infop = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))

    def host(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, _ = pt.decouple_dirichlet(A, b)
        return pt.lobpcg(Ah, nev=3, tol=1e-8, maxiter=400)[0]

    assert info["converged"] and info["iterations"] == infop["iterations"] and np.array_equal(lam, lamp)
    np.testing.assert_allclose(lam, pt.prun(host, pt.sequential, (2, 2, 2)), rtol=1e-8)


# ---------------------------------------------------------------------------
# the resilience layer: the SDC-defended loops on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", ["fused", "standard", "pcg", "block"])
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_sdc_loops_on_card(body, faulted):
    """The defended loops on (2,2,2) stacked parts, 16^3 f64 decoupled
    Poisson, generic plan, ABFT and audits every 5: the graph loop
    torch.equal to the eager loop and to the plain path (x, iterations, the
    SDC counters); clean, the undefended loop's x bit for bit; faulted at
    trip 9 on part 1, one rollback and the clean x bit for bit."""
    _need_card()
    from partitionedarrays_jl_tpu_torch.parallel.gpu import (
        _b_on_cols_layout, _block_on_cols_layout, device_matrix, make_block_cg_fn, make_cg_fn,
    )
    from partitionedarrays_jl_tpu_torch.utils.health import SDCConfig

    fault = "spmv@trip=9,part=1,factor=1e3" if faulted else None
    sdc = SDCConfig(abft=True, audit_every=5, device_fault=fault)

    def drive(parts):
        A, b, _, _ = pt.assemble_poisson(parts, (16, 16, 16))
        Ah, bh = pt.decouple_dirichlet(A, b)
        dA = device_matrix(Ah, parts.backend, box=False)
        if body == "block":
            db = _block_on_cols_layout([bh, bh * 2.0], dA)

            def make(**kw):
                return make_block_cg_fn(dA, 1e-9, 400, 2, **kw)
        else:
            db = _b_on_cols_layout(bh, dA)

            def make(**kw):
                return make_cg_fn(dA, 1e-9, 400, fused=body == "fused", precond=body == "pcg", **kw)
        args = (db, torch.zeros_like(db)) + ((_b_on_cols_layout(pt.jacobi_preconditioner(Ah), dA),)
                                            if body == "pcg" else ())
        g, e, pl = (make(sdc=sdc, graph=True)(*args), make(sdc=sdc, graph=False)(*args),
                    make(sdc=sdc, plain=True)(*args))
        ref = make(sdc=SDCConfig(abft=True, audit_every=5))(*args)
        und = make()(*args)
        same = [torch.equal(g[0], o[0]) and np.array_equal(np.asarray(g[3]), np.asarray(o[3]))
                and np.array_equal(g[5], o[5]) for o in (e, pl)]
        return same, torch.equal(g[0], ref[0]), torch.equal(ref[0], und[0]), int(g[5][1])

    same, healed, clean, rollbacks = pt.prun(drive, pt.GPUBackend(), (2, 2, 2))
    assert same == [True, True] and healed and clean and rollbacks == int(faulted)
