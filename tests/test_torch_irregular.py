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
  buffers are refused.
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
