"""E1's slot-major layout and E2's single-launch node-block boundary, on the
CPU (their plain versions, and numpy emulations of the kernels' indexing).

* E1 (`ops/irregular.ell_spmv`, `ell_spmv_boundary`) takes values and int32
  slot columns ``(P, L, n)``, the transpose of the JAX package's ``(P, n,
  L)``: its plain versions equal the row-major fold (the form the port had
  before, written out here) bit for bit, in float32 and float64, on ragged
  rows, a row whose terms sum to -0.0, a part with no rows, frames and
  slabs; a numpy emulation of the kernel's addressing (slot l of row i of
  part p at ``(p * L + l) * n + i``, the fold from -0.0) agrees;
* E2's boundary mode (`bsr_spmv_boundary`) takes every width bucket at once
  as per-bucket views of one flat buffer an array: its plain version over
  the buckets equals the per-bucket calls bit for bit (bs 2, 3, 4; 1 to 8
  buckets); the offsets the wrapper puts in the kernel's bucket table
  address each bucket in the flat buffers, and a numpy emulation of the
  kernel's thread-to-bucket mapping over that table agrees; views of two
  buffers are refused;
* E2's owned-block mode (`bsr_spmv`) reads only the real blocks, given
  each node's count of them: a numpy emulation of `csrc/bsr_spmv.cu`'s
  mode 0 on slot-major operands (a thread a node, block l's column and
  entries at their slot-major addresses, read below the node's count only:
  every pad is poisoned with NaN and column -1; the bs rows folded from
  -0.0, two blocks' loads at a time; one round of pad terms
  0 * x[xo0 + j] where the node has pads; the zeros outside the band)
  gives the plain version's bytes for bs 2, 3 and 4, float32 and float64,
  nodes of 0 and of Lb real blocks, a -0.0 row whose pad terms make it
  +0.0 (the emulation without them differs: the test has teeth), a NaN at
  x[xo0], wide rows, and the staged elasticity operator (counts from the
  staging); `bsr_row_major` inverts `bsr_slot_major`.
"""
import numpy as np
import pytest
import torch

from partitionedarrays_jl_tpu_torch.ops import irregular as irr


def _bits(t):
    return np.ascontiguousarray(t.numpy()).tobytes()


def _row_major_fold(vals, cols, x):
    """The row-major fold: sum_l vals[:, i, l] * x[:, cols[:, i, l]], left to
    right from slot 0 (vals, cols (P, n, L))."""
    idx = lambda l: cols[:, :, l] if x.dim() == 2 else cols[:, :, l, None].expand(*cols.shape[:2], x.shape[2])
    col = (lambda l: vals[:, :, l]) if x.dim() == 2 else (lambda l: vals[:, :, l, None])
    acc = col(0) * x.gather(1, idx(0))
    for l in range(1, vals.shape[2]):
        acc = acc + col(l) * x.gather(1, idx(l))
    return acc


def _ell_case(dtype, rng, P=3, n=37, L=9, wx=60, o0=4):
    """Row-major padded arrays (P, n, L): ragged rows (pads value 0 at the
    owned slot o0), part 1 without rows (every slot a pad at the trash
    slot), row 5 of part 0 summing to -0.0 (negative values against +0.0
    operands, pads against a negative x[o0]), row 6 of part 2 to +0.0 (its
    pads against x[o0] >= 0)."""
    trash = wx - 1
    lens = rng.integers(0, L + 1, (P, n))
    lens[0, 0] = L
    lens[1] = 0
    vals = np.zeros((P, n, L))
    cols = np.full((P, n, L), o0, dtype=np.int64)
    for p in range(P):
        for i in range(n):
            k = lens[p, i]
            vals[p, i, :k] = rng.standard_normal(k)
            cols[p, i, :k] = rng.integers(o0, wx - 1, k)
    cols[1] = trash
    x = rng.standard_normal((P, wx))
    x[:, trash] = 0.0
    zero_cols = np.array([o0 + 1, o0 + 2, o0 + 3])
    x[:, zero_cols] = 0.0
    x[0, o0] = -1.5
    x[2, o0] = 2.0
    for p, i in ((0, 5), (2, 6)):
        vals[p, i] = 0.0
        vals[p, i, :3] = -rng.random(3) - 0.5
        cols[p, i] = o0
        cols[p, i, :3] = zero_cols
    to = lambda a: torch.from_numpy(a).to(dtype)
    return to(vals), torch.from_numpy(cols), to(x), o0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_plain_is_the_row_major_fold(dtype):
    """`ell_spmv_plain` on the slot-major staging equals the row-major fold
    bit for bit; the -0.0 row keeps its sign and the +0.0 row its own."""
    vals, cols, x, o0 = _ell_case(dtype, np.random.default_rng(1))
    P, n, L = vals.shape
    sv, sc = irr.ell_row_major(vals), irr.ell_row_major(cols).to(torch.int32)
    assert sv.shape == (P, L, n) and sc.dtype == torch.int32
    assert torch.equal(irr.ell_row_major(sv), vals)
    width = x.shape[1] + 3
    y = irr.ell_spmv_plain(sv, sc, x, o0, width)
    want = _row_major_fold(vals, cols, x)
    assert _bits(y[:, o0 : o0 + n]) == _bits(want)
    assert not y[:, :o0].any() and not y[:, o0 + n :].any()
    assert torch.signbit(y[0, o0 + 5]) and y[0, o0 + 5] == 0
    assert not torch.signbit(y[2, o0 + 6]) and y[2, o0 + 6] == 0
    assert not y[1, o0 : o0 + n].any()
    # the wrapper on CPU tensors runs the plain version
    assert _bits(irr.ell_spmv(sv, sc, x, o0, width)) == _bits(y)


@pytest.mark.parametrize("K", [None, 3], ids=["frame", "slab3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_boundary_plain_is_the_row_major_fold(dtype, K):
    """The boundary mode on frames and (P, W, K) slabs: y[rows] += the
    row-major fold, pad rows (at the trash slot) adding nothing."""
    rng = np.random.default_rng(2)
    vals, cols, x, _ = _ell_case(dtype, rng)
    P, nb, L = vals.shape
    wy = 2 * nb + 5
    trash = wy - 1
    rows = torch.from_numpy(np.stack([rng.permutation(wy - 1)[:nb] for _ in range(P)]))
    rows[:, nb - 7 :] = trash
    if K is not None:
        x = torch.stack([x * (k + 1) - k for k in range(K)], dim=2)
    y0 = torch.from_numpy(rng.standard_normal((P, wy) + (() if K is None else (K,)))).to(dtype)
    got = irr.ell_spmv_boundary_plain(rows, irr.ell_row_major(vals), irr.ell_row_major(cols).to(torch.int32), x,
                                      y0.clone(), trash)
    acc = _row_major_fold(vals, cols, x)
    want = y0.clone()
    for p in range(P):
        for b in range(nb):
            if rows[p, b] != trash:
                want[p, rows[p, b]] = want[p, rows[p, b]] + acc[p, b]
    assert _bits(got) == _bits(want)


def _emulate_ell(vals, cols, x, o0, width):
    """csrc/ell_spmv.cu, mode 0, in numpy: thread j of part p folds row
    i = j - o0 from -0.0 over the flat slot-major arrays."""
    P, L, n = vals.shape
    fv, fc, fx = vals.numpy().ravel(), cols.numpy().ravel(), x.numpy().ravel()
    wx = x.shape[1]
    y = np.zeros((P, width), dtype=fv.dtype)
    for p in range(P):
        for j in range(width):
            i = j - o0
            if 0 <= i < n:
                acc = fv.dtype.type(-0.0)
                for l in range(L):
                    at = (p * L + l) * n + i
                    acc = acc + fv[at] * fx[p * wx + fc[at]]
                y[p, j] = acc
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_addressing_emulated(dtype):
    """The kernel's addressing and its fold from -0.0, emulated in numpy,
    give the plain version's bits."""
    vals, cols, x, o0 = _ell_case(dtype, np.random.default_rng(3), P=3, n=11, L=5, wx=20, o0=2)
    sv, sc = irr.ell_row_major(vals), irr.ell_row_major(cols).to(torch.int32)
    want = irr.ell_spmv_plain(sv, sc, x, o0, 17)
    assert _emulate_ell(sv, sc, x, o0, 17).tobytes() == _bits(want)


def _buckets(rng, P, bs, shapes, wy, trash, nhn, dtype):
    """Random node-block buckets (nb_c nodes of Lb_c blocks each), each
    array's buckets laid into one flat buffer and handed out as views;
    distinct target rows across a part's buckets, the last node of every
    bucket a pad row at the trash slot."""
    total = sum(nb for nb, _ in shapes)
    perm = np.stack([rng.permutation(wy - 1)[: total * bs] for _ in range(P)]).reshape(P, total, bs)
    rows, cols, vals, at = [], [], [], 0
    for nb, Lb in shapes:
        r = perm[:, at : at + nb].copy()
        r[:, -1] = trash
        rows.append(r)
        cols.append(rng.integers(0, nhn, (P, nb, Lb)))
        vals.append(rng.standard_normal((P, nb, Lb, bs, bs)))
        at += nb

    def flat(arrs, dt):
        buf = torch.from_numpy(np.concatenate([a.ravel() for a in arrs])).to(dt)
        views, k = [], 0
        for a in arrs:
            views.append(buf[k : k + a.size].view(a.shape))
            k += a.size
        return buf, tuple(views)

    return flat(rows, torch.int64), flat(cols, torch.int64), flat(vals, dtype)


def _emulate_bsr_boundary(table, fr, fc, fv, x, g0, bs, wy, y, trash):
    """csrc/bsr_spmv.cu, mode 1, in numpy: thread t of part p finds its
    bucket by scanning the table's first rows, then folds its row from the
    flat buffers at the table's offsets."""
    nbk, row0 = table["nbk"], table["row0"]
    P, wx = x.shape
    fx, fy = x.numpy().ravel(), y.numpy().ravel().copy()
    for p in range(P):
        for t in range(row0[nbk]):
            c = 0
            while c + 1 < nbk and t >= row0[c + 1]:
                c += 1
            r = t - row0[c]
            nb, Lb = table["nb"][c], table["Lb"][c]
            row = fr[table["roff"][c] + p * nb * bs + r]
            if row == trash:
                continue
            node, i = r // bs, r % bs
            at = p * nb + node
            acc = None
            for l in range(Lb):
                for j in range(bs):
                    v = fv[table["voff"][c] + (at * Lb + l) * bs * bs + i * bs + j]
                    xv = fx[p * wx + g0 + fc[table["coff"][c] + at * Lb + l] * bs + j]
                    acc = v * xv if acc is None else acc + v * xv
            fy[p * wy + row] = fy[p * wy + row] + acc
    return fy.reshape(P, wy)


SHAPES = {1: [(5, 3)], 3: [(4, 2), (6, 5), (3, 1)], 8: [(3, 1), (2, 4), (4, 2), (1, 3), (5, 6), (2, 2), (3, 7), (2, 1)]}


@pytest.mark.parametrize("nbk", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_boundary_buckets_in_one_call(bs, dtype, nbk):
    """The plain version over all buckets (views of flat buffers) equals the
    per-bucket calls bit for bit; the wrapper's bucket table addresses each
    bucket in the flat buffers, and the kernel's indexing over that table,
    emulated, gives the same bits."""
    rng = np.random.default_rng(10 * bs + nbk)
    P, g0, nhn = 3, 7, 23
    wx = g0 + nhn * bs + 2
    shapes = SHAPES[nbk]
    wy = sum(nb for nb, _ in shapes) * bs + 9
    trash = wy - 1
    (fr, rows), (fc, cols), (fv, vals) = _buckets(rng, P, bs, shapes, wy, trash, nhn, dtype)
    x = torch.from_numpy(rng.standard_normal((P, wx))).to(dtype)
    y0 = torch.from_numpy(rng.standard_normal((P, wy))).to(dtype)
    got = irr.bsr_spmv_boundary_plain(rows, vals, cols, x, g0, nhn, y0.clone(), trash)
    want = y0.clone()
    for r, v, c in zip(rows, vals, cols):
        irr.bsr_spmv_boundary_plain(r, v, c, x, g0, nhn, want, trash)
    assert _bits(got) == _bits(want)
    assert _bits(irr.bsr_spmv_boundary(rows, vals, cols, x, g0, nhn, y0.clone(), trash)) == _bits(want)
    assert torch.equal(got[:, trash], y0[:, trash])
    # the table the wrapper builds: each bucket at its offset in the buffers
    table = {"nbk": nbk, "nb": [v.shape[1] for v in vals], "Lb": [v.shape[2] for v in vals]}
    for key, buf, views in (("roff", fr, rows), ("coff", fc, cols), ("voff", fv, vals)):
        base, offs = irr._offsets("t", views)
        assert base == buf.untyped_storage().data_ptr()
        for off, v in zip(offs, views):
            assert torch.equal(buf[off : off + v.numel()].view(v.shape), v)
        table[key] = offs
    table["row0"] = list(np.concatenate([[0], np.cumsum([nb * bs for nb in table["nb"]])]))
    emu = _emulate_bsr_boundary(table, fr.numpy(), fc.numpy(), fv.numpy(), x, g0, bs, wy, y0, trash)
    assert emu.tobytes() == _bits(want)


def test_bsr_boundary_refuses_two_buffers():
    """The bucket table addresses one buffer an array: views of two are
    refused."""
    a, b = torch.zeros(6, dtype=torch.int64), torch.zeros(6, dtype=torch.int64)
    with pytest.raises(ValueError, match="views of one buffer"):
        irr._offsets("bsr_spmv_boundary", (a[:3], b[:3]))
    base, offs = irr._offsets("bsr_spmv_boundary", (a[:2], a[2:5], a[5:]))
    assert offs == [0, 2, 5] and base == a.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# E2's owned-block mode: counts, skipped pads, pad terms
# ---------------------------------------------------------------------------

#: csrc/bsr_spmv.cu: threads (nodes) a CTA and blocks a load batch of mode 0
BSR_OO_THREADS, BSR_LB = 256, 2


def _emulate_bsr_oo(vals, cols, counts, x, xo0, yo0, width, pad_terms=True):
    """csrc/bsr_spmv.cu, mode 0, in numpy over the flat slot-major arrays
    (vals (P, Lb, bs, bs, nn), cols (P, Lb, nn)): thread `node` of CTA (b,
    p) loads block l's column at ``(p * Lb + l) * nn + node`` and entry
    (i, j) at ``((p * Lb + l) * bs * bs + i * bs + j) * nn + node``, two
    blocks' loads at a time, for l below its count only (the caller may
    poison every pad), folds its bs rows from -0.0 and (``pad_terms``)
    adds one round of 0 * x[xo0 + j] where the node has pads; the threads
    past the nodes write the zeros outside the band."""
    P, Lb, bs, _, nn = vals.shape
    BB = bs * bs
    T = vals.numpy().dtype.type
    fv, fc, fk = vals.numpy().ravel(), cols.numpy().ravel(), counts.numpy().ravel()
    fx = x.numpy().ravel()
    wx = x.shape[1]
    y = np.full(P * width, np.nan, dtype=fv.dtype)
    band = nn * bs
    work = nn + width - band
    for p in range(P):
        for t in range(-(-work // BSR_OO_THREADS) * BSR_OO_THREADS):
            if t >= nn:
                z = t - nn
                if z < width - band:
                    y[p * width + (z if z < yo0 else z + band)] = 0
                continue
            c = int(fk[p * nn + t])
            xp = p * wx + xo0
            acc = [T(-0.0)] * bs
            for l0 in range(0, c, BSR_LB):
                batch = [l for l in range(l0, l0 + BSR_LB) if l < c]
                xv = {l: [fx[xp + int(fc[(p * Lb + l) * nn + t]) * bs + j] for j in range(bs)] for l in batch}
                vv = {l: [[fv[((p * Lb + l) * BB + i * bs + j) * nn + t] for j in range(bs)] for i in range(bs)]
                      for l in batch}
                for l in batch:
                    for j in range(bs):
                        for i in range(bs):
                            acc[i] = acc[i] + vv[l][i][j] * xv[l][j]
            if pad_terms and c < Lb:
                for j in range(bs):
                    z = T(0) * fx[xp + j]
                    for i in range(bs):
                        acc[i] = acc[i] + z
            for i in range(bs):
                y[p * width + yo0 + t * bs + i] = acc[i]
    return y.reshape(P, width)


def _poisoned(vals, cols, counts):
    """Slot-major copies of the operands with every pad block NaN and its
    column -1 (an emulation that reads one gives NaN or fails)."""
    sv, sc = irr.bsr_slot_major(vals).clone(), irr.bsr_slot_major(cols).clone()
    Lb = sc.shape[1]
    pad = torch.arange(Lb)[None, :, None] >= counts[:, None, :]
    sv[pad[:, :, None, None, :].expand_as(sv)] = float("nan")
    sc[pad] = -1
    return sv, sc


def _bsr_oo_case(rng, P, nn, Lb, bs, dtype, xo0=3, yo0=5):
    """Padded node-block rows as the staging lays them: counts[p, n] real
    blocks (random nonzero values, random nodes), then pads (value 0, node
    0); node 0 of part 0 has Lb real blocks and node 1 none; x with +0.0
    at every node column of node 3's blocks and x[xo0 + j] > 0, so that
    node 3 of part 0, with negative values and pads, sums to -0.0 before
    its pad terms and +0.0 after them."""
    counts = rng.integers(0, Lb + 1, (P, nn)).astype(np.int32)
    counts[0, 0], counts[0, 1], counts[0, 3] = Lb, 0, max(1, Lb - 2)
    vals = np.zeros((P, nn, Lb, bs, bs))
    cols = np.zeros((P, nn, Lb), dtype=np.int32)
    for p in range(P):
        for n in range(nn):
            c = counts[p, n]
            vals[p, n, :c] = rng.standard_normal((c, bs, bs))
            cols[p, n, :c] = rng.integers(1, nn, c)
    vals[0, 3, : counts[0, 3]] = -rng.random((counts[0, 3], bs, bs)) - 0.5
    wx = xo0 + nn * bs + 4
    x = rng.standard_normal((P, wx))
    x[:, xo0 : xo0 + bs] = rng.random((P, bs)) + 0.5
    for c in cols[0, 3, : counts[0, 3]]:
        x[0, xo0 + c * bs : xo0 + (c + 1) * bs] = 0.0
    to = lambda a: torch.from_numpy(a).to(dtype)
    return to(vals), torch.from_numpy(cols), torch.from_numpy(counts), to(x), xo0, yo0, yo0 + nn * bs + 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_oo_kernel_emulated(bs, dtype):
    """The kernel's mode 0 emulated in numpy on slot-major operands whose
    pads are poisoned gives the plain version's bytes on 3 parts of 300
    nodes (a full CTA of 256 and a ragged one); node 3 of part 0 is -0.0
    without the pad terms and +0.0 with them, as the plain version's; the
    wrapper on CPU tensors runs the plain version on `bsr_row_major` of its
    operands, the inverse of `bsr_slot_major`."""
    vals, cols, counts, x, xo0, yo0, width = _bsr_oo_case(np.random.default_rng(bs), 3, 300, 6, bs, dtype)
    want = irr.bsr_spmv_plain(vals, cols, x, xo0, yo0, width)
    sv, sc = _poisoned(vals, cols, counts)
    emu = _emulate_bsr_oo(sv, sc, counts, x, xo0, yo0, width)
    assert emu.tobytes() == _bits(want)
    sv, sc = irr.bsr_slot_major(vals), irr.bsr_slot_major(cols)
    assert torch.equal(irr.bsr_row_major(sv), vals) and torch.equal(irr.bsr_row_major(sc), cols)
    assert _bits(irr.bsr_spmv(sv, sc, counts, x, xo0, yo0, width)) == _bits(want)
    r3 = yo0 + 3 * bs
    assert (want[0, r3 : r3 + bs] == 0).all() and not torch.signbit(want[0, r3 : r3 + bs]).any()
    no_pads = _emulate_bsr_oo(sv, sc, counts, x, xo0, yo0, width, pad_terms=False)
    assert np.signbit(no_pads[0, r3 : r3 + bs]).all()
    assert not want[:, :yo0].any() and not want[:, yo0 + 300 * bs :].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_oo_kernel_emulated_nan_at_node_zero(dtype):
    """A NaN at x[xo0] (node 0's first slot, where every pad points) reaches
    every row with pads and no other, in the kernel's emulation and the
    plain version alike, compared as bytes."""
    vals, cols, counts, x, xo0, yo0, width = _bsr_oo_case(np.random.default_rng(7), 2, 40, 5, 3, dtype)
    x[:, xo0] = float("nan")
    want = irr.bsr_spmv_plain(vals, cols, x, xo0, yo0, width)
    assert _emulate_bsr_oo(*_poisoned(vals, cols, counts), counts, x, xo0, yo0, width).tobytes() == _bits(want)
    rows = want[:, yo0 : yo0 + 40 * 3].reshape(2, 40, 3)
    has_pads = (counts < 5)[..., None].expand(2, 40, 3)
    assert torch.isnan(rows[has_pads]).all()


def test_bsr_oo_kernel_emulated_wide_rows():
    """Wide node rows (bs 4, 40 blocks, f64): the emulation still gives
    the plain version's bytes."""
    vals, cols, counts, x, xo0, yo0, width = _bsr_oo_case(np.random.default_rng(9), 2, 19, 40, 4, torch.float64)
    want = irr.bsr_spmv_plain(vals, cols, x, xo0, yo0, width)
    assert _emulate_bsr_oo(*_poisoned(vals, cols, counts), counts, x, xo0, yo0, width).tobytes() == _bits(want)


def test_bsr_oo_kernel_emulated_on_the_staged_operator():
    """The elasticity operator staged in node blocks (4 parts, (5, 4, 4)
    nodes, counts from the staging): the emulation gives the plain
    version's bytes on a random frame; each node's count is its CSR's
    blocks a node row and every block past it a pad."""
    from scipy.sparse import csr_matrix

    from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, device_matrix
    import partitionedarrays_jl_tpu_torch as pt

    def drive(parts):
        A = pt.assemble_elasticity_tet(parts, (5, 4, 4))[0]
        dA = device_matrix(A, parts.backend, lowering="bsr")
        lens = [np.diff(csr_matrix((m.data, m.indices, m.indptr), shape=m.shape).tobsr((3, 3)).indptr)
                for m in A.owned_owned_values.part_values()]
        return dA, lens

    dA, lens = pt.prun(drive, GPUBackend(device="cpu"), 4)
    assert dA.lowering == "bsr" and dA.bsr_cols.dtype == torch.int32 and dA.bsr_counts.dtype == torch.int32
    counts = dA.bsr_counts.numpy()
    for p, ln in enumerate(lens):
        assert np.array_equal(counts[p, : len(ln)], ln) and not counts[p, len(ln) :].any()
    vals, cols = irr.bsr_row_major(dA.bsr_vals), irr.bsr_row_major(dA.bsr_cols)
    pad = np.arange(vals.shape[2])[None, None, :] >= counts[..., None]
    assert not vals.numpy()[pad].any() and not cols.numpy()[pad].any()
    cl, rl = dA.col_layout, dA.row_layout
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((cl.P, cl.W)))
    want = irr.bsr_spmv_plain(vals, cols, x, cl.o0, rl.o0, rl.W)
    emu = _emulate_bsr_oo(*_poisoned(vals, cols, dA.bsr_counts), dA.bsr_counts, x, cl.o0, rl.o0, rl.W)
    assert emu.tobytes() == _bits(want)


# ---------------------------------------------------------------------------
# E2's owned-block mode on slabs (`bsr_spmm`): the lane schedule
# ---------------------------------------------------------------------------

#: csrc/bsr_spmv.cu mode 2: threads a CTA, most lanes a node
BSR_SLAB_THREADS, BSR_SLAB_GMAX = 256, 8


def _bsr_slab_lanes(K, itemsize, align, bs=3):
    """csrc/bsr_spmv.cu:launch_oo_slab's plan for K columns whose x and y
    addresses are multiples of ``align`` bytes: CL columns a lane (32 bytes
    of them, 16 for 4x4 blocks, or the widest narrower vector, that
    divides K and whose 16-byte (or narrower) loads the alignment allows;
    else 1), G lanes a node (the K / CL lanes in the fewest chunks of at
    most BSR_SLAB_GMAX, spread evenly) and the chunks (blockIdx.z)."""
    cl, v16, v = 1, 16 // itemsize, (16 if bs == 4 else 32) // itemsize
    while v > 1 and cl == 1:
        if K % v == 0 and align % (min(v, v16) * itemsize) == 0:
            cl = v
        v //= 2
    lanes = K // cl
    chunks = -(-lanes // BSR_SLAB_GMAX)
    G = -(-lanes // chunks)
    return cl, G, -(-lanes // G)


def _emulate_bsr_spmm(vals, cols, counts, x, xo0, yo0, width, align=16):
    """csrc/bsr_spmv.cu, mode 2, in numpy over the flat slot-major arrays and
    the flat (P, W, K) slabs, lane by lane as the kernel runs them: lane
    ``lane`` of warp ``wp`` of CTA (b, p, z) serves item t = (b * warps +
    wp) * (32 // G) + lane // G (the lanes past the warp's items idle) and
    the CL columns from k0 = (z * G + lane % G) * CL (a lane past K idle);
    an item below nn is a node: its count; block l's node column at ``(p *
    Lb + l) * nn + t`` read two blocks before block l - 1's products; one
    register set of x rows (CL adjacent columns of node row j) and entries
    ``((p * Lb + l) * bs * bs + i * bs + j) * nn + t``, row j of block l + 1
    read as soon as row j of block l has its products, for l below the
    count only (the caller may poison every pad); the products in
    ascending (l, j) into bs x CL sums from -0.0, one round of 0 * x[xo0 +
    j, k] where the node has pads; an item past the nodes writes the zeros
    outside the band. Every slot of y is written exactly once (checked)."""
    P, Lb, bs, _, nn = vals.shape
    K, wx = x.shape[2], x.shape[1]
    BB = bs * bs
    T = vals.numpy().dtype.type
    fv, fc, fk = vals.numpy().ravel(), cols.numpy().ravel(), counts.numpy().ravel()
    fx = x.numpy().ravel()
    CL, G, chunks = _bsr_slab_lanes(K, vals.element_size(), align, bs)
    npw, warps = 32 // G, BSR_SLAB_THREADS // 32
    band = nn * bs
    work = nn + width - band
    gx = max(1, -(-work // (warps * npw)))
    y = np.full(P * width * K, np.nan, dtype=fv.dtype)
    writes = np.zeros(P * width * K, dtype=np.int64)

    def store(at, vs):
        for q in range(CL):
            y[at + q] = vs[q]
            writes[at + q] += 1

    for z in range(chunks):
        for p in range(P):
            for b in range(gx):
                for thread in range(BSR_SLAB_THREADS):
                    lane, wp = thread % 32, thread // 32
                    w = lane // G
                    k0 = (z * G + lane - w * G) * CL
                    if w >= npw or k0 >= K:
                        continue
                    t = (b * warps + wp) * npw + w
                    if t >= nn:
                        zz = t - nn
                        if zz < width - band:
                            store((p * width + (zz if zz < yo0 else zz + band)) * K + k0, [T(0)] * CL)
                        continue
                    c = int(fk[p * nn + t])
                    xp = (p * wx + xo0) * K + k0

                    def col(l):
                        return int(fc[(p * Lb + l) * nn + t])

                    def row(cn, l, j):
                        # x row j of node cn (CL columns) and entries (i, j) of block l
                        return ([fx[xp + cn * bs * K + j * K + q] for q in range(CL)],
                                [fv[((p * Lb + l) * BB + i * bs + j) * nn + t] for i in range(bs)])

                    acc = [[T(-0.0)] * CL for _ in range(bs)]
                    c1 = col(0) if 0 < c else 0
                    if 0 < c:
                        xr, vr = map(list, zip(*[row(c1, 0, j) for j in range(bs)]))
                    c1 = col(1) if 1 < c else 0
                    c2 = col(2) if 2 < c else 0
                    for l in range(c):
                        for j in range(bs):
                            for i in range(bs):
                                for q in range(CL):
                                    acc[i][q] = acc[i][q] + vr[j][i] * xr[j][q]
                            if l + 1 < c:
                                # row j of block l + 1 replaces block l's, its products done
                                xr[j], vr[j] = row(c1, l + 1, j)
                        c1, c2 = c2, (col(l + 3) if l + 3 < c else 0)
                    if c < Lb:
                        for j in range(bs):
                            for q in range(CL):
                                zt = T(0) * fx[xp + j * K + q]
                                for i in range(bs):
                                    acc[i][q] = acc[i][q] + zt
                    for i in range(bs):
                        store((p * width + yo0 + t * bs + i) * K + k0, acc[i])
    assert (writes == 1).all(), "a slot of y written other than once"
    return y.reshape(P, width, K)


def _bsr_slab_case(rng, P, nn, Lb, bs, dtype, K):
    """`_bsr_oo_case`'s operands with a (P, W, K) slab x of the same
    properties in every column: x[xo0 + j] > 0 and +0.0 at node 3's node
    columns, so that node 3 of part 0 sums to -0.0 in every column before
    its pad terms and +0.0 after them; node 0 of part 0 (Lb real blocks, no
    pads) gets negative values and +0.0 at its node columns too, so that it
    sums to -0.0 only from the fold's -0.0 start."""
    vals, cols, counts, _, xo0, yo0, width = _bsr_oo_case(rng, P, nn, Lb, bs, dtype)
    vals[0, 0] = -vals[0, 0].abs() - 0.5
    wx = xo0 + nn * bs + 4
    x = rng.standard_normal((P, wx, K))
    x[:, xo0 : xo0 + bs] = rng.random((P, bs, K)) + 0.5
    for c in cols[0, 3, : counts[0, 3]].tolist() + cols[0, 0].tolist():
        x[0, xo0 + c * bs : xo0 + (c + 1) * bs] = 0.0
    return vals, cols, counts, torch.from_numpy(x).to(dtype), xo0, yo0, width


@pytest.mark.parametrize("K", [1, 3, 4, 8, 11, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_spmm_kernel_emulated(bs, dtype, K):
    """The kernel's mode 2 emulated lane by lane on slot-major operands with
    every pad poisoned gives `bsr_spmm_plain`'s bytes on 2 parts of 150
    nodes (ragged last CTAs), with vector lanes (K = 36: in two chunks,
    one lane idle) and with the scalar lanes of a slab one element off
    alignment; node 3 of part 0 is -0.0 in every
    column before its pad terms and +0.0 after them, node 0 (no pads) -0.0,
    as the plain version's; the CPU wrapper is the plain version."""
    vals, cols, counts, x, xo0, yo0, width = _bsr_slab_case(np.random.default_rng(bs * 16 + K), 2, 150, 6, bs,
                                                            dtype, K)
    want = irr.bsr_spmm_plain(vals, cols, x, xo0, yo0, width)
    sv, sc = _poisoned(vals, cols, counts)
    item = vals.element_size()
    for align in (16, item):
        assert _emulate_bsr_spmm(sv, sc, counts, x, xo0, yo0, width, align).tobytes() == _bits(want)
    r3 = yo0 + 3 * bs
    assert (want[0, r3 : r3 + bs] == 0).all() and not torch.signbit(want[0, r3 : r3 + bs]).any()
    assert (want[0, yo0 : yo0 + bs] == 0).all() and torch.signbit(want[0, yo0 : yo0 + bs]).all()
    ssv, ssc = irr.bsr_slot_major(vals), irr.bsr_slot_major(cols)
    assert _bits(irr.bsr_spmm(ssv, ssc, counts, x, xo0, yo0, width)) == _bits(want)
    for k in range(K):
        assert _bits(want[..., k]) == _bits(irr.bsr_spmv_plain(vals, cols, x[..., k].contiguous(), xo0, yo0, width))


@pytest.mark.parametrize("K", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_spmm_kernel_emulated_nan_at_node_zero(dtype, K):
    """A NaN at x[xo0] in column 0 (node 0's first slot, where every pad
    points) reaches column 0 of every row with pads and nothing else, in
    the lane emulation and the plain version alike, compared as bytes."""
    vals, cols, counts, x, xo0, yo0, width = _bsr_slab_case(np.random.default_rng(11), 2, 40, 5, 3, dtype, K)
    x[:, xo0, 0] = float("nan")
    want = irr.bsr_spmm_plain(vals, cols, x, xo0, yo0, width)
    emu = _emulate_bsr_spmm(*_poisoned(vals, cols, counts), counts, x, xo0, yo0, width)
    assert emu.tobytes() == _bits(want)
    rows = want[:, yo0 : yo0 + 40 * 3].reshape(2, 40, 3, K)
    has_pads = (counts < 5)[..., None].expand(2, 40, 3)
    assert torch.isnan(rows[..., 0][has_pads]).all() and not torch.isnan(rows[..., 1:]).any()


def test_bsr_spmm_kernel_emulated_on_the_staged_operator():
    """The elasticity operator staged in node blocks (4 parts, (5, 4, 4)
    nodes): the lane emulation gives `bsr_spmm_plain`'s bytes on a random
    (P, W, 8) slab in float64 (vector lanes, 4 a node)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend, device_matrix
    import partitionedarrays_jl_tpu_torch as pt

    dA = pt.prun(lambda parts: device_matrix(pt.assemble_elasticity_tet(parts, (5, 4, 4))[0], parts.backend,
                                             lowering="bsr"), GPUBackend(device="cpu"), 4)
    vals, cols = irr.bsr_row_major(dA.bsr_vals), irr.bsr_row_major(dA.bsr_cols)
    cl, rl = dA.col_layout, dA.row_layout
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((cl.P, cl.W, 8)))
    want = irr.bsr_spmm_plain(vals, cols, x, cl.o0, rl.o0, rl.W)
    emu = _emulate_bsr_spmm(*_poisoned(vals, cols, dA.bsr_counts), dA.bsr_counts, x, cl.o0, rl.o0, rl.W)
    assert emu.tobytes() == _bits(want)
