"""The port's coded-DIA SpMV (partitionedarrays_jl_tpu_torch/ops/dia.py)
against the JAX package's Pallas kernel run by the Pallas interpreter.

On the CPU the port's wrappers take their plain PyTorch versions; the
inputs are those of tests/test_pallas_dia.py (select-chain and row-class
decode), made with numpy from a seed. Tolerance for f32: rtol=atol=1e-6, as
in the JAX package's own kernel tests; rows that take a single product and
every slot outside the owned band must agree exactly."""
import numpy as np
import pytest
import torch

from partitionedarrays_jl_tpu.ops.pallas_dia import (
    LANES,
    PAD_BLOCK_ROWS,
    dia_coded_padded_pallas,
    pack_nibble_codes as jax_pack_nibble_codes,
    plan_dia_padded,
)
from partitionedarrays_jl_tpu_torch.ops import dia

BRL = PAD_BLOCK_ROWS * LANES


def _select_case():
    """tests/test_pallas_dia.py:77 — two constant and three coded
    diagonals, ragged owned tail, ghost values beyond the owned band."""
    rng = np.random.default_rng(11)
    offsets = (-LANES * 16, -1, 0, 1, LANES * 16)
    kk = (1, 3, 2, 3, 1)
    code_row = (-1, 0, 1, 2, -1)
    no = BRL + 7 * LANES + 13
    plan = plan_dia_padded(offsets, no, n_coded=2)
    o0, g0 = plan["o0"], plan["g0"]
    D, Dc, kmax = len(offsets), 3, 3
    cb = rng.standard_normal((D, kmax)).astype(np.float32)
    codes = np.zeros((Dc, plan["code_len"]), dtype=np.uint8)
    for d in range(D):
        if kk[d] > 1:
            codes[code_row[d], :no] = rng.integers(0, kk[d], no)
    total = 5 * PAD_BLOCK_ROWS
    x = np.zeros(total * LANES, dtype=np.float32)
    x[o0 : o0 + no] = rng.standard_normal(no).astype(np.float32)
    x[g0 : g0 + 40] = rng.standard_normal(40).astype(np.float32)
    return dict(offsets=offsets, kk=kk, code_row=code_row, no=no, plan=plan,
                cb=cb, codes=codes, x=x, total=total, cls_pattern=None, rng=rng)


def _class_case():
    """tests/test_pallas_dia.py:140 — two row classes (dense interior
    stencil, diagonal-only identity rows) sharing one code stream."""
    rng = np.random.default_rng(5)
    offsets = (-LANES * 4, -1, 0, 1, LANES * 4)
    D, K = len(offsets), 2
    no = BRL + 3 * LANES + 9
    plan = plan_dia_padded(offsets, no, n_coded=1)
    cb = np.zeros((D, K), dtype=np.float32)
    cb[:, 0] = rng.standard_normal(D).astype(np.float32)
    cb[2, 1] = 1.0
    cls_pattern = tuple(tuple(bool(cb[d, k] != 0) for d in range(D)) for k in range(K))
    codes = np.zeros((1, plan["code_len"]), dtype=np.uint8)
    codes[0, :no] = rng.integers(0, K, no)
    total = (plan["n_blocks"] + 3) * PAD_BLOCK_ROWS
    x = np.zeros(total * LANES, dtype=np.float32)
    x[plan["o0"] : plan["o0"] + no] = rng.standard_normal(no).astype(np.float32)
    return dict(offsets=offsets, kk=(K,) * D, code_row=(0,) * D, no=no, plan=plan,
                cb=cb, codes=codes, x=x, total=total, cls_pattern=cls_pattern, rng=rng)


def _stencil_case(mixed):
    """The shape of the GMG interpolation stencil S (tests of the port's
    27-diagonal select-chain sum): the 27-point offsets of a 37^3 grid, the
    centre constant and the other 26 coded with kk = 2 in 13 streams; or,
    `mixed`, codebook sizes from 2 to 16 with constant diagonals between
    them and codes up to 15, past kk too (read as slot 0). Coefficients
    and operands have few significant bits, so that every product and sum
    is exact: the interpreter's XLA may fuse a product into its sum, and
    27-term sums near cancellation then differ from the port's separately
    rounded ones by a few ulps."""
    rng = np.random.default_rng(23 if mixed else 19)
    n = 37
    offsets = tuple(a * n * n + b * n + c for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    D = len(offsets)
    if mixed:
        kk = tuple((1, 3, 2, 16, 5, 1, 2, 9)[d % 8] for d in range(D))
    else:
        kk = tuple(1 if d == 13 else 2 for d in range(D))
    code_row, Dc = [], 0
    for k in kk:
        code_row.append(Dc if k > 1 else -1)
        Dc += k > 1
    no = BRL + 5 * LANES + 21
    plan = plan_dia_padded(offsets, no, n_coded=-(-Dc // 2))
    cb = (rng.integers(-16, 17, (D, max(kk))) / 8).astype(np.float32)
    codes = np.zeros((Dc, plan["code_len"]), dtype=np.uint8)
    for d in range(D):
        if kk[d] > 1:
            codes[code_row[d], :no] = rng.integers(0, 16 if mixed else 2, no)
    total = 5 * PAD_BLOCK_ROWS
    def draw(m):
        return (rng.integers(-1024, 1025, m) / 64).astype(np.float32)

    x = np.zeros(total * LANES, dtype=np.float32)
    x[plan["o0"] : plan["o0"] + no] = draw(no)
    x[plan["g0"] : plan["g0"] + 40] = draw(40)
    return dict(offsets=offsets, kk=kk, code_row=tuple(code_row), no=no, plan=plan,
                cb=cb, codes=codes, x=x, total=total, cls_pattern=None, rng=rng, draw=draw)


CASES = {
    "select": _select_case, "class": _class_case,
    "stencil": lambda: _stencil_case(False), "stencil_mixed": lambda: _stencil_case(True),
}


def _pallas(c, pfold=None):
    packed = jax_pack_nibble_codes(c["codes"])
    out = dia_coded_padded_pallas(
        c["cb"], np.array([c["no"]], dtype=np.int32),
        packed.reshape(packed.shape[0], -1, LANES), c["x"].reshape(-1, LANES),
        c["offsets"], c["kk"], c["code_row"], c["plan"], c["total"],
        interpret=True, cls_pattern=c["cls_pattern"], pfold=pfold,
    )
    if pfold is None:
        return np.asarray(out).reshape(-1)
    return tuple(np.asarray(o).reshape(-1) for o in out)


def _port_op(c):
    packed = dia.pack_nibble_codes(c["codes"]).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(c["cb"][None]),
        no=torch.tensor([c["no"]], dtype=torch.int32),
        codes=torch.from_numpy(np.ascontiguousarray(packed[None])),
        offsets=c["offsets"], kk=c["kk"], code_row=c["code_row"],
        cls_pattern=c["cls_pattern"], o0=c["plan"]["o0"],
    )


def _assert_band(got, want, c):
    o0, no = c["plan"]["o0"], c["no"]
    np.testing.assert_allclose(got[o0 : o0 + no], want[o0 : o0 + no], rtol=1e-6, atol=1e-6)
    for v in (got, want):
        rest = v.copy()
        rest[o0 : o0 + no] = 0
        assert not rest.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_spmv_matches_pallas(case):
    c = CASES[case]()
    want = _pallas(c)
    x = torch.from_numpy(c["x"][None])
    got = dia.dia_coded_spmv(_port_op(c), x).numpy().reshape(-1)
    _assert_band(got, want, c)
    if case == "class":
        # identity rows take exactly one product: equal bit for bit
        o0, no = c["plan"]["o0"], c["no"]
        one = np.zeros_like(got, dtype=bool)
        one[o0 : o0 + no] = c["codes"][0, :no] == 1
        np.testing.assert_array_equal(got[one], want[one])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pfold_matches_pallas(case):
    c = CASES[case]()
    o0, no = c["plan"]["o0"], c["no"]
    pprev = np.zeros_like(c["x"])
    draw = c.get("draw", lambda m: c["rng"].standard_normal(m).astype(np.float32))
    pprev[o0 : o0 + no] = draw(no)
    beta = np.array([0.375], dtype=np.float32)
    y_want, p_want = _pallas(c, pfold=(pprev.reshape(-1, LANES), beta))
    y, p = dia.dia_coded_spmv_pfold(
        _port_op(c), torch.from_numpy(c["x"][None]), torch.from_numpy(pprev[None]),
        torch.from_numpy(beta),
    )
    _assert_band(y.numpy().reshape(-1), y_want, c)
    _assert_band(p.numpy().reshape(-1), p_want, c)


def test_plain_spmv_does_not_count_launches():
    c = _class_case()
    dia.reset_launches()
    dia.dia_coded_spmv(_port_op(c), torch.from_numpy(c["x"][None]))
    assert set(dia.LAUNCHES) == {
        "dia_coded_spmv", "dia_coded_spmv_pfold", "dia_coded_spmv_axpy", "dia_stream_spmv",
        "box_stencil_apply", "cg_sweep", "vcycle_epilogue", "dia_coded_spmv_pfold_minv", "cg_sweep_precond",
        "cg_sweep_block", "dia_coded_spmm", "dia_stream_spmm", "block_products",
        "ell_spmv", "ell_spmv_boundary", "bsr_spmv", "bsr_spmv_boundary", "pairwise_dot",
        "ell_spmm", "bsr_spmm", "pairwise_dot_block",
    }
    assert not any(dia.LAUNCHES.values())


def test_wrapper_refuses_devices_without_a_kernel():
    c = _class_case()
    x = torch.empty((1, c["x"].size), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        dia.dia_coded_spmv(_port_op(c), x)


@pytest.mark.parametrize("shape", [(1, 10), (5, 33), (2, 3, 17), (4, 0)])
def test_pack_nibble_codes_matches_jax(shape):
    codes = np.random.default_rng(3).integers(0, 16, shape).astype(np.uint8)
    np.testing.assert_array_equal(dia.pack_nibble_codes(codes), jax_pack_nibble_codes(codes))


# ---------------------------------------------------------------------------
# the coded kernel's shared-memory window plan (no card needed)
# ---------------------------------------------------------------------------


def _stencil(points, n):
    r = (-1, 0, 1)
    if points == 7:
        return (-n * n, -n, -1, 0, 1, n, n * n)
    return tuple(a * n * n + b * n + c for a in r for b in r for c in r)


def _far_apart(D=64):
    """The worst case: 64 diagonals, each further from the next than any
    tile, so every one (and 0) takes a window of its own."""
    return tuple(int(o) for o in (np.arange(D) - D // 2) * 5000 + 2500)


def _check_plan(plan, offsets, itemsize, mode, n_streams, budget):
    """The plan's invariants: its schedule (as the kernel runs it) stages
    every value each (row of the tile, diagonal) reads into the buffer the
    read names, no step refills a buffer that step still reads, and the
    shared-memory regions are aligned, disjoint and within budget."""
    vec = 16 // itemsize
    T, nb = plan.tile, len(plan.buf_at)
    past = dia.ROWS_PER_THREAD * dia.THREADS - T
    assert T in dia.TILE_ROWS and plan.smem_bytes >= plan.stage_at + 2 * plan.stage_bytes
    assert plan.smem_bytes <= budget
    lo, span = plan.windows[plan.zero_window]
    assert lo <= 0 <= lo + span
    for (lo_a, span_a), (lo_b, _) in zip(plan.windows, plan.windows[1:]):
        assert lo_b - (lo_a + span_a) >= T
    # step k sums rows [k * step, k * step + T); the last new window staged
    # into each buffer up to step k + 1 (one step ahead) must be one of
    # step k or before, and hold every row the reads of step k take from it
    step = plan.stride or 3 * T

    def holder(k, b):
        for j in range(k + 1, -plan.lead - 1, -1):
            for s, nbuf in enumerate(plan.new_buf):
                if (j * plan.step_bufs + nbuf) % nb == b:
                    return j, s
        raise AssertionError(f"buffer {b} read at step {k} was never staged")

    for k in range(plan.lead + 3):
        for d, off in enumerate(tuple(offsets) + (0,)):
            c = plan.diag_window[d] if d < len(offsets) else plan.zero_window
            b = (k * plan.step_bufs + plan.window_buf[c]) % nb
            j, s = holder(k, b)
            assert j <= k, f"step {k} reads buffer {b} while step {j} refills it"
            g_lo = j * step + plan.new_src[s]
            assert g_lo == k * step + plan.window_src[c]
            assert 0 <= off - plan.window_src[c] and off - plan.window_src[c] + T <= plan.new_len[s]
            # 16-byte copies from any phase, and 16-byte reads past a run
            assert plan.new_len[s] + 2 * vec <= plan.buf_slots[b]
    # (start, size, bytes a thread's rows past the tile read beyond it)
    regions = [(a, n * itemsize, past * itemsize) for a, n in zip(plan.buf_at, plan.buf_slots)]
    if mode in ("pfold", "pfold_minv"):
        regions += [(a + plan.pp_shift, n * itemsize, 0) for a, n in zip(plan.buf_at, plan.buf_slots)]
    if mode == "pfold_minv":  # the minv copy of every buffer
        regions += [(a + 2 * plan.pp_shift, n * itemsize, 0) for a, n in zip(plan.buf_at, plan.buf_slots)]
    for h in (0, 1):
        st = plan.stage_at + h * plan.stage_bytes
        if mode == "axpy":
            regions += [(st + a, (T + 2 * vec) * itemsize, past * itemsize) for a in plan.axpy_at]
        regions += [(st + plan.code_at + s * plan.code_stride, T + 16, past) for s in range(n_streams)]
    regions.sort()
    assert regions[0][0] >= plan.head_bytes >= plan.sidx_at + 4 * (len(offsets) + 1)
    for (a, na, _), (b, _, _) in zip(regions, regions[1:]):
        assert a % 16 == 0 and a + na <= b
    assert regions[-1][0] + regions[-1][1] <= plan.stage_at + 2 * plan.stage_bytes <= plan.smem_bytes
    assert all(a + na + over <= plan.smem_bytes for a, na, over in regions)


def _emulate(plan, offsets, coef, no, x, pprev=None, beta=0.0, ctas=5, xph=1, pph=2, itemsize=8):
    """The coded kernel's tile schedule, staging, fold and band sum as
    csrc/dia_coded.cu runs them, one CTA after another, with constant
    coefficients `coef`, in numpy on one part: returns (y, p) over the
    owned band. Shared memory is a value array (slot = byte offset /
    itemsize); xph and pph are the 16-byte phases of the operand frames.
    A step's copies for the next step land before the step is summed, so a
    schedule that refilled a buffer still read would give wrong sums."""
    vec = 16 // itemsize
    T, nb, D = plan.tile, len(plan.buf_at), len(offsets)
    sm = np.full(plan.smem_bytes // itemsize, np.nan)
    y, p = np.full(no, np.nan), np.full(no, np.nan)

    def buf(k, rel):
        return plan.buf_at[(k * plan.step_bufs + rel) % nb] // itemsize

    def stage(dst, src, ph, g_lo, n):
        g = np.arange(g_lo, g_lo + n)
        ok = (g >= 0) & (g < no)
        vals = np.where(ok, src[np.clip(g, 0, no - 1)], 0.0)
        at = dst + (ph + g_lo) % vec
        sm[at : at + n] = vals

    def stage_step(k, ts):
        for s in range(len(plan.new_src)):
            b = buf(k, plan.new_buf[s])
            stage(b, x, xph, ts + plan.new_src[s], plan.new_len[s])
            if pprev is not None:
                stage(b + plan.pp_shift // itemsize, pprev, pph, ts + plan.new_src[s], plan.new_len[s])

    if plan.stride:
        M = plan.stride
        ncol = -(-M // T)
        nz = -(-no // M)
        chunks = min(max(ctas // ncol, 1), nz)
        planes = -(-nz // chunks)
        grid = ncol * -(-nz // planes)
    else:
        grid = min(ctas, -(-no // T))
    for bx in range(grid):
        if plan.stride:
            col, z0 = bx % ncol, (bx // ncol) * planes
            steps = max(0, min(planes, nz - z0))
            ts0, tstep, rowcap = z0 * M + col * T, M, min(T, M - col * T)
        else:
            ntiles = -(-no // T)
            steps = (ntiles - 1 - bx) // grid + 1 if bx < ntiles else 0
            ts0, tstep, rowcap = bx * T, grid * T, T
        if steps:
            for k in range(-plan.lead, 1):
                stage_step(k, ts0 + k * tstep)
        for k in range(steps):
            ts = ts0 + k * tstep
            sidx = []
            for d, off in enumerate(tuple(offsets) + (0,)):
                c = plan.diag_window[d] if d < D else plan.zero_window
                src = plan.window_src[c]
                sidx.append(buf(k, plan.window_buf[c]) + (xph + ts + src) % vec + off - src)
            if k + 1 < steps:
                stage_step(k + 1, ts + tstep)
            if pprev is not None:
                for j in range(-plan.lead if k == 0 else k, k + 1):
                    for s in range(len(plan.new_src)):
                        b, g = buf(j, plan.new_buf[s]), ts0 + j * tstep + plan.new_src[s]
                        r0 = b + (xph + g) % vec
                        q0 = b + plan.pp_shift // itemsize + (pph + g) % vec
                        n = plan.new_len[s]
                        sm[r0 : r0 + n] = sm[r0 : r0 + n] + beta * sm[q0 : q0 + n]
            nrow = min(no - ts, rowcap)
            if nrow <= 0:
                continue
            i = np.arange(nrow)
            acc = np.full(nrow, -0.0)
            for d in range(D):
                acc = acc + coef[d] * sm[sidx[d] + i]
            assert np.all(np.isnan(y[ts : ts + nrow])), "a row was summed twice"
            y[ts : ts + nrow] = acc
            p[ts : ts + nrow] = sm[sidx[D] + i]
    return y, p


def _reference(offsets, coef, no, x):
    xo = np.concatenate([np.zeros(no), x[:no], np.zeros(no)])
    acc = np.full(no, -0.0)
    for d, off in enumerate(offsets):
        acc = acc + coef[d] * xo[no + off : 2 * no + off]
    return acc


@pytest.mark.parametrize("mode", ["plain", "pfold", "pfold_minv", "axpy"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [24, 25, 193])
@pytest.mark.parametrize("points", [7, 27])
def test_window_plan_covers_every_read(points, n, itemsize, mode):
    offsets = _stencil(points, n)
    n_streams = 1 if points == 7 else 13
    plan = dia.plan_coded_windows(offsets, itemsize, mode, n_streams, 5)
    _check_plan(plan, offsets, itemsize, mode, n_streams, dia.SMEM_BUDGET)
    # the far planes take windows of their own once n^2 is past a tile, and
    # then the CTAs march along the planes
    assert len(plan.windows) == (3 if n * n - n - 1 >= plan.tile else 1)
    assert plan.stride == (n * n if len(plan.windows) == 3 else 0)
    # a smaller budget: a smaller tile, with the far planes apart at n = 24, 25
    small = dia.plan_coded_windows(offsets, itemsize, mode, n_streams, 5, budget=plan.smem_bytes - 1)
    _check_plan(small, offsets, itemsize, mode, n_streams, plan.smem_bytes - 1)
    assert small.tile < plan.tile


@pytest.mark.parametrize("mode", ["plain", "pfold", "axpy"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_window_plan_shrinks_the_tile_for_many_windows(itemsize, mode):
    offsets = _far_apart()
    plan = dia.plan_coded_windows(offsets, itemsize, mode, 32, 16)
    _check_plan(plan, offsets, itemsize, mode, 32, dia.SMEM_BUDGET)
    assert len(plan.windows) == 65 and plan.stride == 0
    poisson = dia.plan_coded_windows(_stencil(7, 193), itemsize, mode, 1, 2)
    assert plan.tile < poisson.tile
    # one byte less gives a smaller tile, or an error at the smallest one
    if plan.tile == dia.TILE_ROWS[-1]:
        with pytest.raises(ValueError, match="over the"):
            dia.plan_coded_windows(offsets, itemsize, mode, 32, 16, budget=plan.smem_bytes - 1)
    else:
        less = dia.plan_coded_windows(offsets, itemsize, mode, 32, 16, budget=plan.smem_bytes - 1)
        _check_plan(less, offsets, itemsize, mode, 32, plan.smem_bytes - 1)
        assert less.tile < plan.tile


@pytest.mark.parametrize("itemsize", [4, 8])
def test_window_plan_raises_when_nothing_fits(itemsize):
    with pytest.raises(ValueError, match="over the"):
        dia.plan_coded_windows(_far_apart(), itemsize, "pfold", 32, 16, budget=16 * 1024)
    with pytest.raises(ValueError, match="diagonals"):
        dia.plan_coded_windows(_far_apart(65), itemsize)


@pytest.mark.parametrize(
    "points,n,budget,ctas,ragged",
    [
        (7, 40, dia.SMEM_BUDGET, 5, 0),  # marching, two columns a plane, one ragged
        (7, 25, 20000, 7, 333),  # odd n^2: plane starts off every 16-byte phase
        (27, 25, 20000, 3, 0),  # 27-point windows; fewer CTAs than columns
        (27, 12, dia.SMEM_BUDGET, 4, 1000),  # one window: tiles walk the part
        (0, 0, dia.SMEM_BUDGET, 6, 17),  # three windows, not translates: staged every tile
    ],
)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_window_schedule_emulated_matches_band_sum(points, n, budget, ctas, ragged, itemsize):
    """Every owned row summed once, from the right operand values, by the
    kernel's schedule (emulated in numpy), with and without the fold."""
    offsets = _stencil(points, n) if points else (-3000, -1, 0, 1, 1700)
    rng = np.random.default_rng(n + points)
    no = (n ** 3 if points else 20000) - ragged
    x, pprev = rng.standard_normal(no), rng.standard_normal(no)
    coef = rng.standard_normal(len(offsets))
    for mode, beta in (("plain", 0.0), ("pfold", 0.375)):
        plan = dia.plan_coded_windows(offsets, itemsize, mode, 1, 2, budget=budget)
        assert bool(plan.stride) == (points in (7, 27) and n > 12)
        y, p = _emulate(plan, offsets, coef, no, x, pprev if mode == "pfold" else None, beta, ctas,
                        itemsize=itemsize)
        pv = x + beta * pprev
        np.testing.assert_array_equal(p, pv)
        np.testing.assert_array_equal(y, _reference(offsets, coef, no, pv))


# ---------------------------------------------------------------------------
# the specialised select-chain band sum (no card needed)
# ---------------------------------------------------------------------------


def _shape_op(points, n, kk=None, code_row=None, dtype=torch.float32, max_code=2, seed=3, parts=2):
    """A select-chain operator on the 7- or 27-point offsets of an n^3 grid
    (default: the shape of SELECT_SHAPES[points], canonical code rows),
    `parts` parts with ragged owned counts, codes in [0, max_code)."""
    rng = np.random.default_rng(seed)
    offsets = _stencil(points, n)
    D, rows = len(offsets), n ** 3
    if kk is None:
        kk = tuple(1 if d in dia.SELECT_SHAPES[D] else 2 for d in range(D))
    if code_row is None:
        code_row = tuple(int(np.sum(np.array(kk[:d]) > 1)) if kk[d] > 1 else -1 for d in range(D))
    Dc = max(code_row) + 1
    codes = rng.integers(0, max_code, (parts, Dc, rows)).astype(np.uint8)
    packed = dia.pack_nibble_codes(codes).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(rng.standard_normal((parts, D, max(kk)))).to(dtype),
        no=torch.tensor([rows - 37 * p for p in range(parts)], dtype=torch.int32),
        codes=torch.from_numpy(np.ascontiguousarray(packed)),
        offsets=offsets, kk=tuple(kk), code_row=tuple(code_row), cls_pattern=None, o0=2,
    )


def test_select_chain_instance_picks_the_specialised_shapes():
    s_kk = tuple(1 if d == 13 else 2 for d in range(27))
    assert dia.select_chain_instance(_shape_op(27, 6)) == 27
    assert dia.select_chain_instance(_shape_op(7, 6)) == 7
    assert dia.select_chain_instance(_shape_op(7, 6, dtype=torch.float64)) == 7
    # anything else takes the run-time loop
    assert dia.select_chain_instance(_shape_op(27, 6, kk=(2,) * 27)) == 0  # the centre coded
    assert dia.select_chain_instance(_shape_op(27, 6, kk=(1,) + s_kk[1:])) == 0  # another constant
    assert dia.select_chain_instance(_shape_op(7, 6, kk=(2, 2, 3, 2, 2, 2, 2), max_code=3)) == 0
    swapped = tuple(1 - c if c in (0, 1) else c for c in range(7))
    assert dia.select_chain_instance(_shape_op(7, 6, code_row=swapped)) == 0  # codes out of order
    assert dia.select_chain_instance(_shape_op(7, 6, code_row=(0,) * 7)) == 0  # one shared stream
    op = _shape_op(7, 6)
    short = dia.CodedOperator(op.cb, op.no, op.codes[:, :3], op.offsets, op.kk, op.code_row, None, op.o0)
    assert dia.select_chain_instance(short) == 0  # fewer code streams than codes
    assert dia.select_chain_instance(_port_op(CASES["class"]())) == 0  # row-class decode
    assert dia.select_chain_instance(_port_op(CASES["stencil"]())) == 27
    assert dia.select_chain_instance(_port_op(CASES["stencil_mixed"]())) == 0


def _emulate_select_sum(op, x):
    """csrc/dia_coded.cu's select_sum in numpy (separately rounded products
    and sums in the operator's dtype): ascending diagonals, a constant one
    reads slot 0, a coded one the nibble of byte code_row // 2 (low nibble
    for an even coded index), `byte ^ 0x11` masked to that nibble is 0
    exactly where the code is 1 (slot 1), else slot 0. Returns the owned
    band of y per part."""
    D = len(op.offsets)
    consts = dia.SELECT_SHAPES[D]
    cb, codes = op.cb.numpy(), op.codes.numpy()
    out = []
    for p, no in enumerate(op.no.tolist()):
        xo = np.zeros(3 * no, dtype=cb.dtype)
        xo[no : 2 * no] = x[p, op.o0 : op.o0 + no]
        acc = np.full(no, -0.0, dtype=cb.dtype)
        ci = 0
        for d, off in enumerate(op.offsets):
            xs = xo[no + off : 2 * no + off]
            if d in consts:
                v = cb[p, d, 0]
            else:
                t = codes[p, ci >> 1, :no].astype(np.uint32) ^ 0x11
                one = (t & (0xF0 if ci & 1 else 0x0F)) == 0
                v = np.where(one, cb[p, d, 1], cb[p, d, 0])
                ci += 1
            acc = acc + v * xs
        out.append(acc)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("points,n", [(7, 9), (27, 8), (27, 11)])
def test_select_sum_emulated_matches_plain(points, n, dtype):
    """The specialised decode (one byte a stream, both nibbles from it, a
    two-slot select) gives the plain version's values, codes up to 15."""
    op = _shape_op(points, n, dtype=dtype, max_code=16, seed=points + n)
    assert dia.select_chain_instance(op) == points
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, op.o0 + op.n + 4))).to(dtype)
    y = dia.dia_coded_spmv_plain(op, x, x.shape[1]).numpy()
    for p, band in enumerate(_emulate_select_sum(op, x.numpy())):
        np.testing.assert_array_equal(y[p, op.o0 : op.o0 + len(band)], band)
