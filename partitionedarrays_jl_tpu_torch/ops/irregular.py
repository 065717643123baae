"""The products of the irregular lowerings and the strict dot: the CUDA
kernels E1-E3 and their plain PyTorch versions, and the supernode-dense
product (a batched matrix product, no kernel of the port).

They stand for XLA forms of the JAX package, where no Pallas kernel runs
(`partitionedarrays_jl_tpu/parallel/tpu.py`):

* E1 `ell_spmv` (`csrc/ell_spmv.cu`): the padded-ELL fold `_ell_rowsum`
  (:2916-2924), for A_oo of the ELL lowering and, in its boundary mode
  `ell_spmv_boundary`, for the compact boundary-row A_oh of every lowering
  without node blocks, the band ones included (`_finish`, :3230-3233); the
  boundary mode also takes ``(P, W, K)`` slabs, column k summed as a frame,
  and `ell_spmm` is A_oo on slabs (the fold on a block operand of the block
  program), the operator read once for the K columns.
  Its operands are slot-major: values and int32 slot columns ``(P, L, n)``,
  the transpose of the JAX package's ``(P, n, L)`` (`ell_row_major` gives
  that form back), so that at each slot neighbouring rows lie at
  neighbouring addresses;
* E2 `bsr_spmv` (`csrc/bsr_spmv.cu`): the node-block gather and
  ``einsum("nlij,nlj->ni")`` of the BSR lowering (:3143-3160), bs in {2,
  3, 4}, and in its boundary mode `bsr_spmv_boundary` every width bucket
  of the node-block A_oh (:3201-3229) in one launch, on frames and on
  ``(P, W, K)`` slabs (the node-block A_oh on ``(..., K)`` slabs). Node
  columns are int32. A_oo's operands are slot-major, values ``(P, Lb, bs, bs, nn)``
  and columns ``(P, Lb, nn)``, the transpose of the JAX package's ``(P,
  nn, Lb, bs, bs)`` and ``(P, nn, Lb)`` (`bsr_row_major` gives that form
  back, `bsr_slot_major` takes it there), so that at each block neighbouring
  nodes lie at neighbouring addresses; it also takes each node's count of
  real blocks (the staging's `bsr_counts`), so that the kernel reads no
  pad block (it adds their terms itself). `bsr_spmm` is A_oo on ``(P, W,
  K)`` slabs (``einsum("nlij,nljk->nik")``), the operator read once for
  the K columns;
* E3 `pairwise_dot` (`csrc/pairwise_dot.cu`): strict mode's dot,
  `_strict_pairwise_partial` and `_pdot_factory`'s strict branch
  (:2486-2551): products rounded one by one, the fixed pairwise tree a
  part (`utils/helpers.py:pairwise_sum`), the parts added left to right,
  all in one launch (its last CTA finishes the tree and the fold);
  `pairwise_dot_block` is the dot of each column of two ``(P, W, K)``
  slabs, in one launch, column k's tree the solo tree (the block program's
  strict dot, `_strict_partial_any`, :2501);
* `sd_spmv`: the supernode-dense product (:3096-3142), a gather of the
  groups' external unions and one `torch.bmm` a width bucket, in full
  precision (the JAX package's ``Precision.HIGHEST``): a float32 product
  runs only with TF32 off (`check_full_precision`); on a ``(P, W, K)``
  slab one ``(G*bs, U*bs) @ (U*bs, K)`` product a group
  (``einsum("grc,gck->grk")``), cuBLAS's order, so a column agrees with
  the frame product to rounding.

Order: E1 folds a row's slots left to right from slot 0 and E2 adds a
row's terms in ascending (block, column) order from the first, each
product rounded before its add; the boundary modes round a row's sum once
into y (the host's two-phase ``A_oo`` fold, then ``+=`` of the ``A_oh``
fold). The plain versions repeat that order, so each kernel equals its
plain version bit for bit, and E1 equals the host's strict `csr_spmv`.
Every slab form sums column k as its frame form sums a frame, so column k
equals the frame form on column k bit for bit.
E2 agrees with the JAX einsum to rounding (its order is XLA's).

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises. Launches count in ``dia.LAUNCHES`` under
``ell_spmv``, ``ell_spmv_boundary``, ``bsr_spmv``, ``bsr_spmv_boundary``
and ``pairwise_dot``, the slab forms of A_oo and of the dot under
``ell_spmm``, ``bsr_spmm`` and ``pairwise_dot_block`` (the boundary modes
count frames and slabs under their one name; one a call, each a single
launch); the kernels are built with the others by
`dia.build_kernels`. Slabs hold a row's K columns side by side (column k
at the innermost axis), as the block solves lay them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import dia

#: the block sizes of E2 (its template instances)
BSR_BLOCK_SIZES = (2, 3, 4)
#: elements a CTA of E3 reduces (cta_elems in csrc/pairwise_dot.cu: 256
#: threads of 16 float32 or 8 float64 elements), and a CTA of its block
#: form (cta_elems_block: 256 threads of a 16-byte vector, 4 float32 or 2
#: float64 elements)
PW_CTA_ELEMS = {torch.float32: 4096, torch.float64: 2048}
PWB_CTA_ELEMS = {torch.float32: 1024, torch.float64: 512}


class _EllParams(ctypes.Structure):
    """Mirror of `PaEllParams` in csrc/ell_spmv.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("L", ctypes.c_int),
        ("K", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("trash", ctypes.c_longlong),
    ]


#: most width buckets one launch of E2's boundary mode takes
#: (PA_BSR_MAX_BUCKETS in csrc/bsr_spmv.cu; the staging makes SD_BUCKETS)
BSR_MAX_BUCKETS = 8


class _BsrParams(ctypes.Structure):
    """Mirror of `PaBsrParams` in csrc/bsr_spmv.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("Lb", ctypes.c_int),
        ("bs", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("nn", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("xo0", ctypes.c_longlong),
        ("yo0", ctypes.c_longlong),
        ("trash", ctypes.c_longlong),
        ("nbk", ctypes.c_int),
        ("bk_Lb", ctypes.c_int * BSR_MAX_BUCKETS),
        ("bk_row0", ctypes.c_longlong * (BSR_MAX_BUCKETS + 1)),
        ("bk_nb", ctypes.c_longlong * BSR_MAX_BUCKETS),
        ("bk_roff", ctypes.c_longlong * BSR_MAX_BUCKETS),
        ("bk_coff", ctypes.c_longlong * BSR_MAX_BUCKETS),
        ("bk_voff", ctypes.c_longlong * BSR_MAX_BUCKETS),
        ("K", ctypes.c_int),
    ]


class _PairwiseParams(ctypes.Structure):
    """Mirror of `PaPairwiseParams` in csrc/pairwise_dot.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("K", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("m", ctypes.c_longlong),
        ("wa", ctypes.c_longlong),
        ("wb", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
    ]


def bind(libs: dict) -> None:
    """Set the ctypes signatures of E1-E3 on their built libraries."""
    vp = ctypes.c_void_p
    for dt in ("f32", "f64"):
        for name, params, nptr in (("ell_spmv", _EllParams, 6), ("bsr_spmv", _BsrParams, 7)):
            f = getattr(libs[name], f"pa_{name}_{dt}")
            f.argtypes = [ctypes.POINTER(params)] + [vp] * nptr
            f.restype = ctypes.c_int
        for form in ("pairwise_dot", "pairwise_dot_block"):
            f = getattr(libs["pairwise_dot"], f"pa_{form}_{dt}")
            f.argtypes = [ctypes.POINTER(_PairwiseParams), vp, vp, vp, ctypes.c_longlong, vp, vp, vp]
            f.restype = ctypes.c_int


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    one; raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return True


def _check(name: str, x: torch.Tensor, floats: Sequence[torch.Tensor], ints: Sequence[torch.Tensor],
           ints32: Sequence[torch.Tensor] = ()) -> str:
    """The kernel's type name; raises unless the float operands share x's
    dtype (f32 or f64) and device and the index operands are int64 (those
    of ``ints32`` int32), all contiguous."""
    if x.dtype not in dia._DT:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {x.dtype}")
    for t in floats:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: values and frames must be contiguous, on one device, of one dtype")
    for dt, group in ((torch.int64, ints), (torch.int32, ints32)):
        for t in group:
            if t.device != x.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"{name}: index arrays must be contiguous {dt} on the operand's device")
    return dia._DT[x.dtype]


# ---------------------------------------------------------------------------
# E1: padded ELL
# ---------------------------------------------------------------------------


def _slab_index(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An index over dim 1 of a (P, W) frame, repeated over the columns of
    a (P, W, K) slab."""
    return idx if x.dim() == 2 else idx[..., None].expand(*idx.shape, x.shape[2])


def ell_row_major(t: torch.Tensor) -> torch.Tensor:
    """The row-major ``(P, n, L)`` form of E1's slot-major ``(P, L, n)``
    values or slot columns (the JAX package's staging), and back: the
    layout is a transpose of the last two axes."""
    return t.transpose(1, 2).contiguous()


def _ell_fold(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_l vals[:, l, i] * x[:, cols[:, l, i]], left to right from slot 0."""
    col = (lambda l: vals[:, l]) if x.dim() == 2 else (lambda l: vals[:, l, :, None])
    acc = col(0) * x.gather(1, _slab_index(cols[:, 0].long(), x))
    for l in range(1, vals.shape[1]):
        acc = acc + col(l) * x.gather(1, _slab_index(cols[:, l].long(), x))
    return acc


def _ell_frame_check(name: str, x: torch.Tensor) -> None:
    if x.shape[1] >= 2**31:
        raise ValueError(f"{name}: a frame of {x.shape[1]} slots does not fit the int32 slot columns")


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, o0: int,
                   width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `ell_spmv`."""
    width = x.shape[1] if width is None else int(width)
    P, _, n = vals.shape
    y = x.new_zeros((P, width))
    y[:, o0 : o0 + n] = _ell_fold(vals, cols, x)
    return y


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, o0: int,
             width: Optional[int] = None) -> torch.Tensor:
    """y = A_oo x for a padded-ELL operand staged slot-major: vals (P, L, n)
    and int32 slot columns cols (P, L, n) into x's frame (P, Wx) -> y (P,
    width) with rows ``[o0, o0 + n)`` computed (row i = the fold of staged
    row i) and every other slot 0 (width defaults to Wx)."""
    width = x.shape[1] if width is None else int(width)
    if not _on_cuda("ell_spmv", x):
        return ell_spmv_plain(vals, cols, x, o0, width)
    dt = _check("ell_spmv", x, (vals, x), (), (cols,))
    _ell_frame_check("ell_spmv", x)
    P, L, n = vals.shape
    if x.dim() != 2 or x.shape[0] != P or tuple(cols.shape) != (P, L, n) or L < 1 or width < o0 + n:
        raise ValueError(f"ell_spmv: operand {tuple(x.shape)} or result width {width} does not fit "
                         f"{P} parts of {n} rows at {o0}")
    y = torch.empty((P, width), dtype=x.dtype, device=x.device)
    prm = _EllParams(P=P, L=L, K=1, mode=0, n=n, wx=x.shape[1], wy=width, o0=o0, trash=-1)
    fn = getattr(dia.build_kernels()["ell_spmv"], f"pa_ell_spmv_{dt}")
    rc = fn(ctypes.byref(prm), None, vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), _stream(x))
    dia._raise_on(rc, "ell_spmv")
    dia.LAUNCHES["ell_spmv"] += 1
    return y


def ell_spmm_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, o0: int,
                   width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `ell_spmm`."""
    width = x.shape[1] if width is None else int(width)
    P, _, n = vals.shape
    y = x.new_zeros((P, width, x.shape[2]))
    y[:, o0 : o0 + n] = _ell_fold(vals, cols, x)
    return y


def ell_spmm(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, o0: int,
             width: Optional[int] = None) -> torch.Tensor:
    """`ell_spmv` on a (P, Wx, K) slab x -> y (P, width, K): column k of y
    is `ell_spmv` of column k of x, bit for bit; the operator is read once
    for the K columns."""
    width = x.shape[1] if width is None else int(width)
    if not _on_cuda("ell_spmm", x):
        return ell_spmm_plain(vals, cols, x, o0, width)
    dt = _check("ell_spmm", x, (vals, x), (), (cols,))
    _ell_frame_check("ell_spmm", x)
    P, L, n = vals.shape
    if (x.dim() != 3 or x.shape[0] != P or x.shape[2] < 1 or tuple(cols.shape) != (P, L, n) or L < 1
            or width < o0 + n):
        raise ValueError(f"ell_spmm: slab {tuple(x.shape)} or result width {width} does not fit "
                         f"{P} parts of {n} rows at {o0}")
    K = int(x.shape[2])
    y = torch.empty((P, width, K), dtype=x.dtype, device=x.device)
    prm = _EllParams(P=P, L=L, K=K, mode=2, n=n, wx=x.shape[1], wy=width, o0=o0, trash=-1)
    fn = getattr(dia.build_kernels()["ell_spmv"], f"pa_ell_spmv_{dt}")
    rc = fn(ctypes.byref(prm), None, vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), _stream(x))
    dia._raise_on(rc, "ell_spmm")
    dia.LAUNCHES["ell_spmm"] += 1
    return y


def ell_spmv_boundary_plain(rows: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                            y: torch.Tensor, trash: int) -> torch.Tensor:
    """Plain version of `ell_spmv_boundary` (pad rows add +0.0 to the
    trash slot, which the kernel leaves untouched)."""
    acc = _ell_fold(vals, cols, x)
    keep = rows != trash
    acc = torch.where(keep if x.dim() == 2 else keep[..., None], acc, 0)
    y.scatter_add_(1, _slab_index(rows, y), acc)
    return y


def ell_spmv_boundary(rows: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, trash: int) -> torch.Tensor:
    """y[:, rows[:, b]] += the fold of staged boundary row b, in place:
    rows (P, nb) int64 row slots of y (pads at the ``trash`` slot, skipped),
    vals (P, L, nb) and int32 slot columns cols (P, L, nb) into x, slot-major.
    x and y are (P, W) frames or (P, W, K) slabs (column k summed as a
    frame). Returns y."""
    if not _on_cuda("ell_spmv_boundary", x):
        return ell_spmv_boundary_plain(rows, vals, cols, x, y, trash)
    dt = _check("ell_spmv_boundary", x, (vals, x, y), (rows,), (cols,))
    _ell_frame_check("ell_spmv_boundary", x)
    P, L, nb = vals.shape
    K = 1 if x.dim() == 2 else x.shape[2]
    if (x.dim() not in (2, 3) or y.dim() != x.dim() or x.shape[0] != P or y.shape[0] != P
            or (x.dim() == 3 and y.shape[2] != K) or tuple(cols.shape) != (P, L, nb)
            or tuple(rows.shape) != (P, nb) or L < 1 or nb < 1):
        raise ValueError(f"ell_spmv_boundary: frames {tuple(x.shape)}/{tuple(y.shape)} do not fit {P} parts of "
                         f"{nb} boundary rows of {L} slots")
    if y.data_ptr() == x.data_ptr():
        raise ValueError("ell_spmv_boundary: y is updated in place and must not alias x")
    prm = _EllParams(P=P, L=L, K=K, mode=1, n=nb, wx=x.shape[1], wy=y.shape[1], o0=0, trash=int(trash))
    fn = getattr(dia.build_kernels()["ell_spmv"], f"pa_ell_spmv_{dt}")
    rc = fn(ctypes.byref(prm), rows.data_ptr(), vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            _stream(x))
    dia._raise_on(rc, "ell_spmv_boundary")
    dia.LAUNCHES["ell_spmv_boundary"] += 1
    return y


# ---------------------------------------------------------------------------
# E2: node blocks
# ---------------------------------------------------------------------------


def _bsr_fold(vals: torch.Tensor, cols: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """(P, nn, bs): row i of node n = sum over blocks l and columns j of
    vals[:, n, l, i, j] * xn[:, cols[:, n, l], j], ascending (l, j); xn
    (P, nodes, bs), or (P, nodes, bs, K) for K columns -> (P, nn, bs, K),
    column k summed as a frame."""
    P, nn, Lb, bs, _ = vals.shape
    K = xn.shape[3] if xn.dim() == 4 else 1
    idx = cols.long().reshape(P, nn * Lb, 1).expand(P, nn * Lb, bs * K)
    xg = xn.reshape(P, -1, bs * K).gather(1, idx).view(P, nn, Lb, bs, K)
    acc = None
    for l in range(Lb):
        for j in range(bs):
            t = vals[:, :, l, :, j, None] * xg[:, :, l, j, None, :]
            acc = t if acc is None else acc + t
    return acc if xn.dim() == 4 else acc[..., 0]


def bsr_row_major(t: torch.Tensor) -> torch.Tensor:
    """The row-major form of E2's slot-major A_oo operands (the JAX
    package's staging): values ``(P, Lb, bs, bs, nn)`` -> ``(P, nn, Lb, bs,
    bs)``, columns ``(P, Lb, nn)`` -> ``(P, nn, Lb)``."""
    return (t.permute(0, 4, 1, 2, 3) if t.dim() == 5 else t.transpose(1, 2)).contiguous()


def bsr_slot_major(t: torch.Tensor) -> torch.Tensor:
    """The inverse of `bsr_row_major`: values ``(P, nn, Lb, bs, bs)`` ->
    ``(P, Lb, bs, bs, nn)``, columns ``(P, nn, Lb)`` -> ``(P, Lb, nn)``."""
    return (t.permute(0, 2, 3, 4, 1) if t.dim() == 5 else t.transpose(1, 2)).contiguous()


def bsr_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, xo0: int, yo0: int,
                   width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `bsr_spmv`, on the row-major operands (`bsr_row_major`
    of the kernel's)."""
    width = x.shape[1] if width is None else int(width)
    P, nn, _, bs, _ = vals.shape
    xn = x[:, xo0 : xo0 + nn * bs].reshape(P, nn, bs)
    y = x.new_zeros((P, width))
    y[:, yo0 : yo0 + nn * bs] = _bsr_fold(vals, cols, xn).reshape(P, nn * bs)
    return y


def bsr_spmm_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, xo0: int, yo0: int,
                   width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `bsr_spmm`, on the row-major operands."""
    width = x.shape[1] if width is None else int(width)
    P, nn, _, bs, _ = vals.shape
    K = x.shape[2]
    xn = x[:, xo0 : xo0 + nn * bs].reshape(P, nn, bs, K)
    y = x.new_zeros((P, width, K))
    y[:, yo0 : yo0 + nn * bs] = _bsr_fold(vals, cols, xn).reshape(P, nn * bs, K)
    return y


def _bsr_check(name, vals, cols, x, nodes, xo0, rows=None, y=None, counts=None):
    """The kernel's type name; raises unless the blocks (row-major, or
    slot-major with ``counts``: A_oo's staging), their int32 columns, the
    rows, counts and frames fit one another. x is a (P, W) frame or a (P,
    W, K) slab, and y (where given) the same."""
    if counts is None:
        P, nn, Lb, bs, bs2 = vals.shape
        cshape = (P, nn, Lb)
    else:
        P, Lb, bs, bs2, nn = vals.shape
        cshape = (P, Lb, nn)
    if bs not in BSR_BLOCK_SIZES or bs2 != bs or Lb < 1:
        raise ValueError(f"{name}: blocks {tuple(vals.shape)}: bs must be one of {BSR_BLOCK_SIZES}")
    if x.dim() not in (2, 3) or x.shape[0] != P or tuple(cols.shape) != cshape or xo0 + nodes * bs > x.shape[1]:
        raise ValueError(f"{name}: frame {tuple(x.shape)} does not hold {P} parts of {nodes} nodes at {xo0}")
    if nodes >= 2**31:
        raise ValueError(f"{name}: a node frame of {nodes} nodes does not fit the int32 node columns")
    if rows is not None and (tuple(rows.shape) != (P, nn, bs) or y.dim() != x.dim() or y.shape[0] != P
                             or y.shape[2:] != x.shape[2:]):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} or result {tuple(y.shape)} do not fit the blocks")
    if counts is not None and tuple(counts.shape) != (P, nn):
        raise ValueError(f"{name}: counts {tuple(counts.shape)} do not fit {P} parts of {nn} nodes")
    floats = (vals, x) if y is None else (vals, x, y)
    ints = () if rows is None else (rows,)
    return _check(name, x, floats, ints, (cols,) if counts is None else (cols, counts))


def bsr_spmv(vals: torch.Tensor, cols: torch.Tensor, counts: torch.Tensor, x: torch.Tensor, xo0: int, yo0: int,
             width: Optional[int] = None) -> torch.Tensor:
    """y = A_oo x for a node-block operand staged slot-major: vals (P, Lb,
    bs, bs, nn) and int32 node columns cols (P, Lb, nn) into the node frame
    ``x[:, xo0:]`` (node c at ``xo0 + c*bs``) -> y (P, width) with rows
    ``[yo0, yo0 + nn*bs)`` computed and every other slot 0 (width defaults
    to Wx). counts (P, nn) int32: node n's first counts[:, n] blocks are
    real, the rest pads (value 0, node 0), as the staging lays them; the
    kernel reads no pad and adds their terms itself, the plain version (for
    a CPU tensor, on `bsr_row_major` of the operands) reads them."""
    width = x.shape[1] if width is None else int(width)
    if not _on_cuda("bsr_spmv", x):
        return bsr_spmv_plain(bsr_row_major(vals), bsr_row_major(cols), x, xo0, yo0, width)
    P, Lb, bs, _, nn = vals.shape
    dt = _bsr_check("bsr_spmv", vals, cols, x, nn, xo0, counts=counts)
    if x.dim() != 2:
        raise ValueError(f"bsr_spmv: x is a (P, W) frame, got {tuple(x.shape)} (bsr_spmm takes slabs)")
    if width < yo0 + nn * bs:
        raise ValueError(f"bsr_spmv: result width {width} does not hold {nn * bs} rows at {yo0}")
    y = torch.empty((P, width), dtype=x.dtype, device=x.device)
    prm = _BsrParams(P=P, Lb=Lb, bs=bs, mode=0, nn=nn, wx=x.shape[1], wy=width, xo0=xo0, yo0=yo0, trash=-1)
    fn = getattr(dia.build_kernels()["bsr_spmv"], f"pa_bsr_spmv_{dt}")
    rc = fn(ctypes.byref(prm), None, counts.data_ptr(), vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
            y.data_ptr(), _stream(x))
    dia._raise_on(rc, "bsr_spmv")
    dia.LAUNCHES["bsr_spmv"] += 1
    return y


def bsr_spmm(vals: torch.Tensor, cols: torch.Tensor, counts: torch.Tensor, x: torch.Tensor, xo0: int, yo0: int,
             width: Optional[int] = None) -> torch.Tensor:
    """`bsr_spmv` on a (P, Wx, K) slab x -> y (P, width, K): column k of y
    is `bsr_spmv` of column k of x, bit for bit (its one round of pad terms
    a node, for each column); the blocks, their columns and the counts are
    read once for the K columns."""
    width = x.shape[1] if width is None else int(width)
    if not _on_cuda("bsr_spmm", x):
        return bsr_spmm_plain(bsr_row_major(vals), bsr_row_major(cols), x, xo0, yo0, width)
    P, Lb, bs, _, nn = vals.shape
    dt = _bsr_check("bsr_spmm", vals, cols, x, nn, xo0, counts=counts)
    if x.dim() != 3 or x.shape[2] < 1:
        raise ValueError(f"bsr_spmm: x is a (P, W, K) slab, got {tuple(x.shape)}")
    if width < yo0 + nn * bs:
        raise ValueError(f"bsr_spmm: result width {width} does not hold {nn * bs} rows at {yo0}")
    K = int(x.shape[2])
    y = torch.empty((P, width, K), dtype=x.dtype, device=x.device)
    prm = _BsrParams(P=P, Lb=Lb, bs=bs, mode=2, nn=nn, wx=x.shape[1], wy=width, xo0=xo0, yo0=yo0, trash=-1, K=K)
    fn = getattr(dia.build_kernels()["bsr_spmv"], f"pa_bsr_spmv_{dt}")
    rc = fn(ctypes.byref(prm), None, counts.data_ptr(), vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
            y.data_ptr(), _stream(x))
    dia._raise_on(rc, "bsr_spmm")
    dia.LAUNCHES["bsr_spmm"] += 1
    return y


def _buckets(t) -> tuple:
    """One bucket's tensor, or a sequence of buckets' tensors, as a tuple."""
    return (t,) if isinstance(t, torch.Tensor) else tuple(t)


def bsr_spmv_boundary_plain(rows, vals, cols, x: torch.Tensor, g0: int, nhn: int, y: torch.Tensor,
                            trash: int) -> torch.Tensor:
    """Plain version of `bsr_spmv_boundary`: the buckets one after another
    (pad rows add +0.0 to the trash slot, which the kernel leaves
    untouched)."""
    for rows_c, vals_c, cols_c in zip(_buckets(rows), _buckets(vals), _buckets(cols)):
        P, nb, _, bs, _ = vals_c.shape
        xn = x[:, g0 : g0 + nhn * bs].reshape(P, nhn, bs, *x.shape[2:])
        keep = rows_c != trash
        acc = torch.where(keep if x.dim() == 2 else keep[..., None], _bsr_fold(vals_c, cols_c, xn), 0)
        y.scatter_add_(1, _slab_index(rows_c.reshape(P, nb * bs), y), acc.reshape(P, nb * bs, *x.shape[2:]))
    return y


def _offsets(name: str, ts: Sequence[torch.Tensor]):
    """The base pointer of the one buffer that holds every tensor of ``ts``
    and each tensor's element offset in it; raises unless they share one
    storage."""
    store = ts[0].untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() != store for t in ts):
        raise ValueError(f"{name}: the buckets' arrays must be views of one buffer each")
    return store, [(t.data_ptr() - store) // t.element_size() for t in ts]


def bsr_spmv_boundary(rows, vals, cols, x: torch.Tensor, g0: int, nhn: int, y: torch.Tensor,
                      trash: int) -> torch.Tensor:
    """The node-block A_oh, in place, every width bucket in one launch: for
    bucket c, staged boundary node n and i < bs, ``y[:, rows_c[:, n, i]] +=``
    row i of its blocks vals_c (P, nb_c, Lb_c, bs, bs) against the
    ghost-node frame of x (``nhn`` nodes from ``g0``, int32 node columns
    cols_c (P, nb_c, Lb_c)); rows_c (P, nb_c, bs) int64, pads at the
    ``trash`` slot, skipped. rows, vals and cols are one bucket's tensors or
    sequences of at most BSR_MAX_BUCKETS buckets' tensors, each sequence
    views of one buffer (the staging's flat buffers). x and y are (P, W)
    frames, or (P, W, K) slabs (column k summed as a frame; one kernel
    takes both, a frame as the slab of one column). Returns y."""
    rows, vals, cols = _buckets(rows), _buckets(vals), _buckets(cols)
    if not _on_cuda("bsr_spmv_boundary", x):
        return bsr_spmv_boundary_plain(rows, vals, cols, x, g0, nhn, y, trash)
    nbk = len(vals)
    if not 1 <= nbk <= BSR_MAX_BUCKETS or len(rows) != nbk or len(cols) != nbk:
        raise ValueError(f"bsr_spmv_boundary: 1 to {BSR_MAX_BUCKETS} buckets of rows, vals and cols, "
                         f"got {len(rows)}, {nbk}, {len(cols)}")
    P, _, _, bs, _ = vals[0].shape
    dt = None
    for rows_c, vals_c, cols_c in zip(rows, vals, cols):
        if vals_c.shape[0] != P or vals_c.shape[3] != bs:
            raise ValueError("bsr_spmv_boundary: the buckets differ in parts or block size")
        dt = _bsr_check("bsr_spmv_boundary", vals_c, cols_c, x, nhn, g0, rows_c, y)
    if y.data_ptr() == x.data_ptr():
        raise ValueError("bsr_spmv_boundary: y is updated in place and must not alias x")
    rbase, roff = _offsets("bsr_spmv_boundary", rows)
    cbase, coff = _offsets("bsr_spmv_boundary", cols)
    vbase, voff = _offsets("bsr_spmv_boundary", vals)
    slab = x.dim() == 3
    if slab and x.shape[2] < 1:
        raise ValueError("bsr_spmv_boundary: the slab has no column")
    prm = _BsrParams(P=P, Lb=1, bs=bs, mode=1, nn=0, wx=x.shape[1], wy=y.shape[1], xo0=g0, yo0=0,
                     trash=int(trash), nbk=nbk, K=int(x.shape[2]) if slab else 1)
    row0 = 0
    for c, vals_c in enumerate(vals):
        nb_c, Lb_c = vals_c.shape[1], vals_c.shape[2]
        prm.bk_Lb[c], prm.bk_nb[c], prm.bk_row0[c] = Lb_c, nb_c, row0
        prm.bk_roff[c], prm.bk_coff[c], prm.bk_voff[c] = roff[c], coff[c], voff[c]
        row0 += nb_c * bs
    prm.bk_row0[nbk] = row0
    fn = getattr(dia.build_kernels()["bsr_spmv"], f"pa_bsr_spmv_{dt}")
    rc = fn(ctypes.byref(prm), rbase, None, vbase, cbase, x.data_ptr(), y.data_ptr(), _stream(x))
    dia._raise_on(rc, "bsr_spmv_boundary")
    dia.LAUNCHES["bsr_spmv_boundary"] += 1
    return y


# ---------------------------------------------------------------------------
# E3: the strict dot
# ---------------------------------------------------------------------------


def padded_length(n: int) -> int:
    """The tree's length for n elements: the next power of two (1 for
    n <= 1)."""
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


#: E3's tickets, one uint32 a (device, stream): zeroed once, left zero by
#: every launch, so that dots queued on one stream take turns and dots on
#: two streams never share one (a CUDA graph bakes in its capture
#: stream's: two replays of graphs captured on one stream must not run at
#: once)
_TICKETS: dict = {}


def _ticket(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def pairwise_dot_plain(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """Plain version of `pairwise_dot`: the products of the bands, padded
    with +0.0 to `padded_length`, ``v[:, 0::2] + v[:, 1::2]`` until one
    column, then the parts added left to right."""
    t = a[:, o0 : o0 + n] * b[:, o0 : o0 + n]
    t = torch.nn.functional.pad(t, (0, padded_length(n) - n))
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    s = t[:, 0]
    acc = s[0]
    for i in range(1, s.shape[0]):
        acc = acc + s[i]
    return acc


def pairwise_dot(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """The strict dot of the bands ``[o0, o0 + n)`` of (P, W) frames a and
    b, a 0-d tensor: per part the fixed pairwise tree of the rounded
    products (bit for bit numpy's `utils/helpers.pairwise_sum` of them),
    then the parts added left to right."""
    if not _on_cuda("pairwise_dot", a):
        return pairwise_dot_plain(a, b, o0, n)
    dt = _check("pairwise_dot", a, (a, b), ())
    P = a.shape[0]
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != P or n < 0 or o0 + n > min(a.shape[1], b.shape[1]):
        raise ValueError(f"pairwise_dot: frames {tuple(a.shape)}/{tuple(b.shape)} do not hold a band at {o0} of {n}")
    m = padded_length(n)
    scratch = torch.empty((P * max(1, m // PW_CTA_ELEMS[a.dtype]),), dtype=a.dtype, device=a.device)  # partials
    out = torch.empty((), dtype=a.dtype, device=a.device)
    prm = _PairwiseParams(P=P, K=1, n=n, m=m, wa=a.shape[1], wb=b.shape[1], o0=o0)
    fn = getattr(dia.build_kernels()["pairwise_dot"], f"pa_pairwise_dot_{dt}")
    rc = fn(ctypes.byref(prm), a.data_ptr(), b.data_ptr(), scratch.data_ptr(), scratch.numel(),
            _ticket(a.device).data_ptr(), out.data_ptr(), _stream(a))
    dia._raise_on(rc, "pairwise_dot")
    dia.LAUNCHES["pairwise_dot"] += 1
    return out


def pairwise_dot_block_plain(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """Plain version of `pairwise_dot_block`: `pairwise_dot_plain`'s tree
    over the element axis of the (P, n, K) products, the parts added left
    to right, for every column at once."""
    t = a[:, o0 : o0 + n] * b[:, o0 : o0 + n]
    t = torch.nn.functional.pad(t, (0, 0, 0, padded_length(n) - n))
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    s = t[:, 0]
    acc = s[0]
    for i in range(1, s.shape[0]):
        acc = acc + s[i]
    return acc


def pairwise_dot_block(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """The strict dot of every column of (P, W, K) slabs a and b over the
    bands ``[o0, o0 + n)``, a (K,) tensor: element k is `pairwise_dot` of
    column k bit for bit, all K in one launch."""
    if not _on_cuda("pairwise_dot_block", a):
        return pairwise_dot_block_plain(a, b, o0, n)
    dt = _check("pairwise_dot_block", a, (a, b), ())
    P = a.shape[0]
    if (a.dim() != 3 or b.dim() != 3 or b.shape[0] != P or b.shape[2] != a.shape[2] or a.shape[2] < 1 or n < 0
            or o0 + n > min(a.shape[1], b.shape[1])):
        raise ValueError(f"pairwise_dot_block: slabs {tuple(a.shape)}/{tuple(b.shape)} do not hold a band at {o0} "
                         f"of {n}")
    K = int(a.shape[2])
    m = padded_length(n)
    scratch = torch.empty((K * P * max(1, m // PWB_CTA_ELEMS[a.dtype]),), dtype=a.dtype, device=a.device)
    out = torch.empty((K,), dtype=a.dtype, device=a.device)
    prm = _PairwiseParams(P=P, K=K, n=n, m=m, wa=a.shape[1], wb=b.shape[1], o0=o0)
    fn = getattr(dia.build_kernels()["pairwise_dot"], f"pa_pairwise_dot_block_{dt}")
    rc = fn(ctypes.byref(prm), a.data_ptr(), b.data_ptr(), scratch.data_ptr(), scratch.numel(),
            _ticket(a.device).data_ptr(), out.data_ptr(), _stream(a))
    dia._raise_on(rc, "pairwise_dot_block")
    dia.LAUNCHES["pairwise_dot_block"] += 1
    return out


# ---------------------------------------------------------------------------
# the supernode-dense product (no kernel: torch.bmm at full precision)
# ---------------------------------------------------------------------------


def check_full_precision(dtype: torch.dtype, device: torch.device,
                         what: str = "the SD product", remedy: str = " or take lowering='bsr'") -> None:
    """Raise unless a float32 matrix product on `device` runs in full
    float32 (TF32 off), the counterpart of the JAX package's
    ``Precision.HIGHEST``; the global setting is read, never changed.
    ``what`` names the product in the message, ``remedy`` what else the
    caller may do."""
    if dtype != torch.float32 or torch.device(device).type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            f"{what}: float32 matrix products run in TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 or torch.set_float32_matmul_precision); "
            f"{what} needs full float32: turn TF32 off{remedy}"
        )


def sd_spmv(idx: Sequence[torch.Tensor], vals: Sequence[torch.Tensor], x: torch.Tensor, o0: int, n: int,
            bs: int, G: int, width: int) -> torch.Tensor:
    """y = A_oo x for the supernode-dense staging (tpu.py:3096-3142): a
    group's own nodes arrive by a reshape of the owned band, its external
    union (idx, (P, groups, emax) int64 node ids per width bucket) by a
    gather, and each bucket's group blocks vals (P, groups, G*bs,
    (G + emax)*bs) multiply the gathered operand in one `torch.bmm`. Returns
    (P, width) with the band ``[o0, o0 + n)`` computed and 0 elsewhere; on
    a (P, W, K) slab x, (P, width, K), one ``(G*bs, U*bs) @ (U*bs, K)``
    product a group."""
    check_full_precision(x.dtype, x.device)
    P = x.shape[0]
    K = 1 if x.dim() == 2 else x.shape[2]
    nn = n // bs
    yn = x[:, o0 : o0 + n].reshape(P, nn, bs * K)
    ngr = sum(int(i.shape[1]) for i in idx)
    yp = torch.nn.functional.pad(yn, (0, 0, 0, ngr * G - nn)) if ngr * G > nn else yn
    outs, g = [], 0
    for idx_c, val_c in zip(idx, vals):
        len_c, emax_c = int(idx_c.shape[1]), int(idx_c.shape[2])
        xs = yp[:, g * G : (g + len_c) * G].reshape(P, len_c, G * bs, K)
        xe = yn.gather(1, idx_c.reshape(P, len_c * emax_c, 1).expand(P, len_c * emax_c, bs * K))
        xg = torch.cat([xs, xe.reshape(P, len_c, emax_c * bs, K)], dim=2)
        prod = torch.bmm(val_c.reshape(P * len_c, G * bs, -1), xg.reshape(P * len_c, -1, K))
        outs.append(prod.reshape(P, len_c * G * bs, K))
        g += len_c
    y = x.new_zeros((P, width, K))
    y[:, o0 : o0 + n] = torch.cat(outs, dim=1)[:, :n]
    return y if x.dim() == 3 else y[..., 0]
