"""The coded SpMM's staged form (csrc/dia_coded_block.cu, form 1) on the
CPU: its shared-memory plan (`ops/dia.py:plan_coded_block_windows`) and a
numpy emulation of its schedule CTA by CTA (tiles, windows, the march
along the plane stride, the ring of buffers, zero staging outside the
owned band, the fold once per staged value, the code stage and the
coefficient table) against the plain version, byte for byte.

The operands are made with numpy from a seed: two parts with unequal
owned counts, the band at o0 > 0, NaN in every slab row outside the owned
band (a staged pad row must never reach y or p), select-chain decode with
codes up to 15 and the row-class decode."""
import numpy as np
import pytest
import torch

from partitionedarrays_jl_tpu_torch.ops import dia


def _stencil(points, n):
    r = (-1, 0, 1)
    if points == 7:
        return (-n * n, -n, -1, 0, 1, n, n * n)
    return tuple(a * n * n + b * n + c for a in r for b in r for c in r)


def _operator(offsets, rows, decode, dtype, rng, o0=3, short=1000):
    """Two parts of `rows` and `rows - short` owned rows, in select-chain
    decode (codebook sizes 1, 3, 2, 5, codes up to 15: a code past kk reads
    slot 0) or row-class decode (2 classes on stream 0's low nibble)."""
    D = len(offsets)
    if decode == "class":
        kk, code_row = (2,) * D, (0,) * D
        cb = np.zeros((2, D, 2))
        cb[:, :, 0] = rng.standard_normal((2, D))
        cb[:, D // 2, 1] = rng.standard_normal(2)
        codes = rng.integers(0, 2, (2, 1, rows)).astype(np.uint8)
        pattern = (tuple(True for _ in range(D)), tuple(d == D // 2 for d in range(D)))
    else:
        kk = tuple((1, 3, 2, 5, 2, 3, 1)[d % 7] for d in range(D))
        code_row = tuple(int(np.sum(np.array(kk[:d]) > 1)) if kk[d] > 1 else -1 for d in range(D))
        cb = rng.standard_normal((2, D, 5))
        codes = np.zeros((2, max(code_row) + 1, rows), dtype=np.uint8)
        for d, k in enumerate(kk):
            if k > 1:
                codes[:, code_row[d]] = rng.integers(0, k + 1 if d % 3 else 16, (2, rows))
        pattern = None
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).to(dtype), no=torch.tensor([rows, rows - short], dtype=torch.int32),
        codes=torch.from_numpy(np.ascontiguousarray(dia.pack_nibble_codes(codes).view(np.uint8))),
        offsets=tuple(int(o) for o in offsets), kk=kk, code_row=code_row, cls_pattern=pattern, o0=o0,
    )


def _slab(op, K, dtype, rng, extra=7):
    """A (2, W, K) slab with NaN on every row outside each part's owned band."""
    x = torch.from_numpy(rng.standard_normal((2, op.o0 + op.n + extra, K))).to(dtype)
    for p, no in enumerate(op.no.tolist()):
        x[p, : op.o0] = float("nan")
        x[p, op.o0 + no :] = float("nan")
    return x


def _plan_under(offsets, itemsize, K, mode, n_streams, max_tile):
    """The staged plan at the largest tile of at most max_tile rows (a
    budget just under the larger plans')."""
    budget = 227 * 1024
    while True:
        plan = dia.plan_coded_block_windows(offsets, itemsize, K, mode, n_streams, budget=budget)
        if plan.tile <= max_tile:
            return plan, budget
        budget = plan.smem_bytes - 1


def _check_block_plan(plan, offsets, itemsize, K, mode, n_streams, budget):
    """The plan's invariants: every value a (row of the tile, diagonal)
    reads is staged into the buffer the read names, by the step that reads
    it or before, and no step refills a buffer that step still reads; the
    items fit a CTA; the shared-memory regions are aligned, disjoint and
    within budget."""
    vec = 16 // itemsize
    T, nb = plan.tile, len(plan.buf_at)
    assert T in dia.TILE_ROWS and T * plan.groups <= dia.spmm_items(K, itemsize) * dia.THREADS
    assert plan.groups & (plan.groups - 1) == 0
    assert plan.groups == -(-K // dia.block_columns(K))
    assert plan.smem_bytes <= budget
    lo, span = plan.windows[plan.zero_window]
    assert lo <= 0 <= lo + span
    step = plan.stride or 3 * T

    def holder(k, b):
        # the last step whose new window went into buffer b by step k's
        # sum: the copies of step k + 1 are issued by then
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
            assert j * step + plan.new_src[s] == k * step + plan.window_src[c]
            assert 0 <= off - plan.window_src[c] and off - plan.window_src[c] + T <= plan.new_len[s]
            # a run of K values a row from any 16-byte phase, 16-byte copies
            assert plan.new_len[s] * K + 2 * vec <= plan.buf_slots[b]
    regions = [(a, n * itemsize) for a, n in zip(plan.buf_at, plan.buf_slots)]
    if mode != "plain":
        regions += [(a + plan.pp_shift, n * itemsize) for a, n in zip(plan.buf_at, plan.buf_slots)]
    if mode == "pfold_minv":
        lens = [(n - 2 * vec) // K for n in plan.buf_slots]
        assert plan.mv_bytes >= (max(lens) + 2 * vec) * itemsize
        regions += [(plan.mv_at + b * plan.mv_bytes, plan.mv_bytes) for b in range(nb)]
    for h in (0, 1):
        regions += [(plan.stage_at + h * plan.stage_bytes + s * plan.code_stride, T + 32)
                    for s in range(max(n_streams, 1))]
    regions.sort()
    D = len(offsets)
    assert plan.beta_at >= plan.ccf_at + D * dia.SPMM_CODES * itemsize
    assert plan.sidx_at >= plan.beta_at + K * itemsize and plan.cidx_at >= plan.sidx_at + 4 * (D + 1)
    assert plan.head_bytes >= plan.csh_at + 4 * D and plan.csh_at >= plan.cidx_at + 4 * D
    assert regions[0][0] >= plan.head_bytes
    for (a, na), (b, _) in zip(regions, regions[1:]):
        assert a % 16 == 0 and a + na <= b
    assert regions[-1][0] + regions[-1][1] <= plan.smem_bytes


def _emulate(op, plan, x, pprev=None, beta=None, minv=None, width=None, ctas=5, phases=(1, 2, 3), cph=5):
    """csrc/dia_coded_block.cu's staged form in numpy, CTA after CTA of
    each part, with the plan given: shared memory is a value array (slot =
    byte offset / itemsize) beside a byte array for the code stage, both
    filled with garbage first. The slabs' band starts lie at the element
    phases `phases` (x, pprev, minv) of their 16-byte chunks and the code
    streams at byte phase cph. A step's copies for the next step land
    before the step is summed, so a schedule that refilled a buffer still
    read would give wrong sums. Returns y (and p) as the kernel writes
    them."""
    dt = np.dtype(str(x.dtype)[6:])
    S, K = dt.itemsize, x.shape[2]
    V = 16 // S
    P, wx = x.shape[:2]
    wy = wx if width is None else width
    T, nb, D = plan.tile, len(plan.buf_at), len(op.offsets)
    KB = dia.block_columns(K)
    G = plan.groups
    cb, codes, no_all = op.cb.numpy(), op.codes.numpy(), op.no.tolist()
    xs_np = x.numpy()
    pp_np = None if pprev is None else pprev.numpy()
    mv_np = None if minv is None else minv.numpy()
    b_np = None if beta is None else beta.numpy()
    y = np.full((P, wy, K), np.nan, dtype=dt)
    p_out = None if pprev is None else np.full((P, wx, K), np.nan, dtype=dt)
    n = op.n
    coded = [op.code_row[d] for d in range(D) if op.kk[d] > 1]
    one_code, code0 = len(set(coded)) <= 1, (coded[0] if coded else 0)
    cr = [op.code_row[d] if op.kk[d] > 1 else code0 for d in range(D)]
    garbage = np.random.default_rng(11)
    for p, no in enumerate(no_all):
        # the owned band of each slab as one run of elements
        xe = xs_np[p, op.o0 : op.o0 + n].reshape(-1)
        pe = None if pp_np is None else pp_np[p, op.o0 : op.o0 + n].reshape(-1)
        me = None if mv_np is None else mv_np[p, op.o0 : op.o0 + n]
        table = np.array([[cb[p, d, c if op.kk[d] > 1 and c < op.kk[d] else 0] for c in range(16)]
                          for d in range(D)], dtype=dt)
        # every slot outside the owned band: 0
        y[p, : op.o0] = 0
        y[p, op.o0 + no :] = 0
        if p_out is not None:
            p_out[p, : op.o0] = 0
            p_out[p, op.o0 + no :] = 0
        if plan.stride:
            M = plan.stride
            ncol = -(-M // T)
            nz = -(-n // M)
            chunks = min(max(ctas // ncol, 1), nz)
            planes = -(-nz // chunks)
            grid = ncol * -(-nz // planes)
        else:
            grid = min(ctas, -(-n // T))
        for bx in range(grid):
            sm = garbage.standard_normal(plan.smem_bytes // S).astype(dt)
            sb = garbage.integers(0, 256, plan.smem_bytes).astype(np.uint8)

            def buf(k, rel):
                return (k * plan.step_bufs + rel) % nb

            def stage(dst, src, ph0, g_lo, cnt, lim):
                g = np.arange(g_lo, g_lo + cnt)
                vals = np.where((g >= 0) & (g < lim), src[np.clip(g, 0, len(src) - 1)], 0)
                at = dst + (ph0 + g_lo) % V
                sm[at : at + cnt] = vals

            def stage_step(k, ts, rows):
                for s in range(len(plan.new_src)):
                    bi = buf(k, plan.new_buf[s])
                    g = ts + plan.new_src[s]
                    stage(plan.buf_at[bi] // S, xe, phases[0], g * K, plan.new_len[s] * K, no * K)
                    if pe is not None:
                        stage((plan.buf_at[bi] + plan.pp_shift) // S, pe, phases[1], g * K, plan.new_len[s] * K,
                              no * K)
                    if me is not None:
                        stage((plan.mv_at + bi * plan.mv_bytes) // S, me, phases[2], g, plan.new_len[s], no)
                if rows:
                    st = plan.stage_at + (k & 1) * plan.stage_bytes
                    for s in range(op.codes.shape[1]):
                        ph = (cph + s * n + ts) % 16
                        r = np.arange(ts, ts + T)
                        vals = np.where(r < no, codes[p, s, np.clip(r, 0, n - 1)], 0)
                        sb[st + s * plan.code_stride + ph : st + s * plan.code_stride + ph + T] = vals

            if plan.stride:
                col, z0 = bx % ncol, (bx // ncol) * planes
                steps = max(0, min(planes, -(-no // M) - z0))
                ts0, tstep, rowcap = z0 * M + col * T, M, min(T, M - col * T)
            else:
                ntiles = -(-no // T)
                steps = (ntiles - 1 - bx) // grid + 1 if bx < ntiles else 0
                ts0, tstep, rowcap = bx * T, grid * T, T
            if steps:
                for k in range(-plan.lead, 1):
                    stage_step(k, ts0 + k * tstep, k == 0)
            for k in range(steps):
                ts = ts0 + k * tstep
                st = plan.stage_at + (k & 1) * plan.stage_bytes
                sidx = []
                for d, off in enumerate(tuple(op.offsets) + (0,)):
                    c = plan.diag_window[d] if d < D else plan.zero_window
                    src = plan.window_src[c]
                    sidx.append(plan.buf_at[buf(k, plan.window_buf[c])] // S + (phases[0] + (ts + src) * K) % V
                                + (off - src) * K)
                cidx = [st + (cr[d] >> 1) * plan.code_stride + (cph + (cr[d] >> 1) * n + ts) % 16 for d in range(D)]
                csh = [4 * (cr[d] & 1) for d in range(D)]
                if k + 1 < steps:
                    stage_step(k + 1, ts + tstep, True)
                if pe is not None:
                    for j in range(-plan.lead if k == 0 else k, k + 1):
                        for s in range(len(plan.new_src)):
                            bi = buf(j, plan.new_buf[s])
                            g = ts0 + j * tstep + plan.new_src[s]
                            cnt = plan.new_len[s] * K
                            r0 = plan.buf_at[bi] // S + (phases[0] + g * K) % V
                            q0 = (plan.buf_at[bi] + plan.pp_shift) // S + (phases[1] + g * K) % V
                            e = np.arange(cnt)
                            bq = (b_np[e % K] * sm[q0 : q0 + cnt]).astype(dt)
                            rr = sm[r0 : r0 + cnt]
                            if me is not None:
                                m0 = (plan.mv_at + bi * plan.mv_bytes) // S + (phases[2] + g) % V
                                rr = (sm[m0 + e // K] * rr).astype(dt)
                            sm[r0 : r0 + cnt] = rr + bq
                nrow = min(no - ts, rowcap)
                if nrow <= 0:
                    continue
                # the thread items: item q is row q // G, columns of group q % G
                q = np.arange(T * G)
                rows, grp = q // G, q % G
                keep = rows < nrow
                rows, grp = rows[keep], grp[keep]
                cols = grp[:, None] * KB + np.arange(KB)[None, :]
                ok = cols < K
                ofs = rows[:, None] * K + np.minimum(cols, K - 1)
                acc = np.full(ofs.shape, -0.0, dtype=dt)
                code1 = (sb[cidx[0] + rows] >> csh[0]) & 15
                for d in range(D):
                    c = code1 if one_code else (sb[cidx[d] + rows] >> csh[d]) & 15
                    v = table[d, c][:, None]
                    acc = acc + v * sm[sidx[d] + ofs]
                for i, row in enumerate(rows):
                    tgt = y[p, op.o0 + ts + row, cols[i][ok[i]]]
                    assert np.all(np.isnan(tgt)), "a row was summed twice"
                    y[p, op.o0 + ts + row, cols[i][ok[i]]] = acc[i][ok[i]]
                    if p_out is not None:
                        p_out[p, op.o0 + ts + row, cols[i][ok[i]]] = sm[sidx[D] + ofs[i][ok[i]]]
    y = torch.from_numpy(y)
    return y if p_out is None else (y, torch.from_numpy(p_out))


def _same(a, b):
    return a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


#: (stencil points or 0, n, max tile): 7-point marching with a ragged
#: second column a plane (400 = 256 + 144), odd 27-point planes (each at
#: another 16-byte phase), one merged window (tiles walk the part), and
#: windows that are not translates (staged every tile)
SCHEDULES = [(7, 20, 256), (27, 15, 128), (7, 9, 1024), (0, 0, 512)]
SCHEDULE_IDS = ["7pt-march", "27pt-march-odd", "one-window", "not-translates"]


def _schedule_op(points, n, decode, dtype, rng):
    if points:
        return _operator(_stencil(points, n), n ** 3, decode, dtype, rng, short=333)
    return _operator((-3000, -1, 0, 1, 1700), 20000, decode, dtype, rng, short=1717)


def _run(op, K, mode, dtype, rng, plan, ctas=5):
    x = _slab(op, K, dtype, rng)
    width = x.shape[1] + 5
    if mode == "plain":
        got = _emulate(op, plan, x, width=width, ctas=ctas)
        return _same(got, dia.dia_coded_spmm_plain(op, x, width))
    pprev = _slab(op, K, dtype, rng)
    beta = torch.from_numpy(rng.standard_normal(K)).to(dtype)
    minv = _slab(op, 1, dtype, rng)[..., 0].contiguous() if mode == "pfold_minv" else None
    y, p = _emulate(op, plan, x, pprev, beta, minv, width=width, ctas=ctas)
    wy, wp = dia.dia_coded_spmm_pfold_plain(op, x, pprev, beta, width, minv)
    return _same(y, wy) and _same(p, wp)


@pytest.mark.parametrize("mode", ["plain", "pfold", "pfold_minv"])
@pytest.mark.parametrize("decode", ["select", "class"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8, 12])
def test_staged_schedule_emulated_matches_plain(K, dtype, decode, mode):
    """Every owned row and column summed once, from the right staged
    values (folded once in pfold), decoded from the code stage and the
    table, on the 7-point operator of a 20^3 grid marching along its planes
    (a tile of at most 256 rows / groups: two columns a plane, the second
    ragged), two parts of unequal counts, NaN outside the owned band."""
    rng = np.random.default_rng(K * 7 + (dtype == torch.float64) + len(mode))
    op = _schedule_op(7, 20, decode, dtype, rng)
    item = torch.finfo(dtype).bits // 8
    plan, budget = _plan_under(op.offsets, item, K, mode, op.codes.shape[1], 256)
    _check_block_plan(plan, op.offsets, item, K, mode, op.codes.shape[1], budget)
    assert _run(op, K, mode, dtype, rng, plan)


@pytest.mark.parametrize("decode", ["select", "class"])
@pytest.mark.parametrize("mode", ["plain", "pfold", "pfold_minv"])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
def test_staged_schedules_emulated_match_plain(schedule, K, mode, decode):
    """The other schedules the planner makes (odd 27-point planes, one
    window, windows staged every tile), f32 and f64, and fewer CTAs than a
    plane's columns."""
    points, n, max_tile = schedule
    for dtype, ctas in ((torch.float32, 5), (torch.float64, 1)):
        rng = np.random.default_rng(n + K + len(mode))
        op = _schedule_op(points, n, decode, dtype, rng)
        item = torch.finfo(dtype).bits // 8
        plan, budget = _plan_under(op.offsets, item, K, mode, op.codes.shape[1], max_tile)
        _check_block_plan(plan, op.offsets, item, K, mode, op.codes.shape[1], budget)
        assert bool(plan.stride) == (points > 0 and n * n >= plan.tile and len(plan.windows) > 1)
        assert _run(op, K, mode, dtype, rng, plan, ctas)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("points", [7, 27])
def test_marching_plan_at_192(points, K, itemsize):
    """At 192^3 the slab widths of s-step CG (K = 2) and LOBPCG (K = 4)
    have a marching plan within the budget (plain mode; pfold where a row
    is at most 8 bytes), and the planner takes the staged form exactly
    where its tile reaches STAGED_MIN_TILE: the s-step pair on both
    7-point operators in f32 and f64, the LOBPCG block on both in f32."""
    n = 192
    offsets = _stencil(points, n)
    streams = {7: (1, 4), 27: (13,)}[points]
    modes = ("plain", "pfold", "pfold_minv") if K * itemsize <= 8 else ("plain",)
    for ns in streams:
        for mode in modes:
            plan = dia.plan_coded_block_windows(offsets, itemsize, K, mode, ns)
            _check_block_plan(plan, offsets, itemsize, K, mode, ns, dia.SPMM_BUDGET)
            assert plan.stride == n * n and len(plan.windows) == 3
            want = dia.SPMM_STAGED if plan.tile >= dia.STAGED_MIN_TILE else dia.SPMM_ROW
            assert dia.spmm_form(offsets, itemsize, K, mode, ns) == want
        if points == 7 and (K, itemsize) != (4, 8):
            assert dia.spmm_form(offsets, itemsize, K, "plain", ns) == dia.SPMM_STAGED


def test_unrolled_sum_takes_the_two_slot_operators():
    """`spmm_nd`: the unrolled two-slot sum for 7 diagonals of codebook
    sizes at most 2 in plain mode at K = 2 to 4, the run-time loop
    otherwise."""
    rng = np.random.default_rng(2)
    cls = _operator(_stencil(7, 6), 216, "class", torch.float32, rng)
    sel = _operator(_stencil(7, 6), 216, "select", torch.float32, rng)
    assert [dia.spmm_nd(cls, K, "plain") for K in (1, 2, 3, 4, 8)] == [0, 7, 7, 7, 0]
    assert dia.spmm_nd(cls, 2, "pfold") == 0
    assert dia.spmm_nd(sel, 2, "plain") == 0  # codebooks of 3 and 5 slots
    two = dia.CodedOperator(sel.cb, sel.no, sel.codes, sel.offsets, tuple(min(k, 2) for k in sel.kk),
                            sel.code_row, None, sel.o0)
    assert dia.spmm_nd(two, 4, "plain") == 7
    assert dia.spmm_nd(_operator(_stencil(27, 4), 64, "class", torch.float32, rng), 2, "plain") == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_planner_takes_the_row_form_where_nothing_fits(itemsize):
    """Where no staged plan fits the budget, the planner raises and the
    form by shape is the row form; where a plan fits only at a tile under
    STAGED_MIN_TILE rows, the row form too."""
    far = tuple(int(o) for o in (np.arange(64) - 32) * 5000 + 2500)
    with pytest.raises(ValueError, match="over the"):
        dia.plan_coded_block_windows(far, itemsize, 8, "pfold_minv", 32)
    assert dia.spmm_form(far, itemsize, 8, "pfold_minv", 32) == dia.SPMM_ROW
    n = 192
    wide = dia.plan_coded_block_windows(_stencil(27, n), itemsize, 12, "plain", 13) if itemsize == 4 else None
    if wide is not None:
        assert wide.tile < dia.STAGED_MIN_TILE
    assert dia.spmm_form(_stencil(27, n), itemsize, 12, "plain", 13) == dia.SPMM_ROW
    # a tighter budget: a smaller tile, or an error at the smallest one
    plan = dia.plan_coded_block_windows(_stencil(7, n), itemsize, 4, "plain", 4)
    less = dia.plan_coded_block_windows(_stencil(7, n), itemsize, 4, "plain", 4, budget=plan.smem_bytes - 1)
    assert less.tile < plan.tile
    with pytest.raises(ValueError, match="diagonals"):
        dia.plan_coded_block_windows(tuple(range(65)), itemsize, 2)
    with pytest.raises(ValueError, match="mode"):
        dia.plan_coded_block_windows(_stencil(7, n), itemsize, 2, "axpy")
    # 20 columns: three groups of 8 a row, not a power of two
    with pytest.raises(ValueError, match="power of two"):
        dia.plan_coded_block_windows(_stencil(7, 9), itemsize, 20)
    assert dia.spmm_form(_stencil(7, 9), itemsize, 20) == dia.SPMM_ROW


def test_row_class_and_constant_diagonals_decode_from_one_nibble():
    """The staged form's decode: every diagonal's table of 16 codes holds
    the value the plain decode gives for that code; a constant diagonal
    reads the first coded diagonal's nibble (its table is flat)."""
    rng = np.random.default_rng(5)
    op = _operator(_stencil(7, 6), 216, "select", torch.float64, rng, short=16)
    D = len(op.offsets)
    cb = op.cb.numpy()
    for d in range(D):
        table = [cb[0, d, c if op.kk[d] > 1 and c < op.kk[d] else 0] for c in range(16)]
        if op.kk[d] == 1:
            assert len(set(table)) == 1
        for c in range(16):
            want = cb[0, d, 0] if op.kk[d] == 1 else cb[0, d, c if c < op.kk[d] else 0]
            assert table[c] == want
