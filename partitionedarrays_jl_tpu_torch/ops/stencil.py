"""The matrix-free interpolation stencil S of the multigrid transfers: the
CUDA kernel `box_stencil_apply` (`csrc/box_stencil.cu`) and its plain
PyTorch version.

S is the square d-linear interpolation stencil of the factored transfer
P = S·E: weights 0.5^|δ|₀ over δ in {-1, 0, 1}^d, truncated at the global
boundary. The JAX package applies it without an assembled operator
(`partitionedarrays_jl_tpu/parallel/tpu_gmg.py:_stencil_apply`, :292-319):
each part's owned box and the ghost segments of the box exchange are
embedded into a zero-padded extended box, and the 3^d shifted slices are
summed. XLA fuses those slice ops; no Pallas kernel stands behind them.
Here the kernel reads the owned box and the segments in place from the
stacked ``(P, W)`` frame, all parts in one launch, a level of fewer
dimensions as a 3-D box with leading extents 1; the plain version is the
transcription of `_stencil_apply` over groups of parts with the same box.

The kernel (design and bound at the head of the source). Bound: memory,
the owned box read and the result written (56.6 MB, ~17 us at 192^3 f32
on an H100); its 26 adds and ~14 products a point must not add much to
that. A thread marches along the first axis with three accumulators a
point (the outputs below, in and above the arriving plane), so each
plane's 3x3 neighbourhood is read from shared memory once and every
output still sums its 27 terms in np.ndindex order. Two forms:

* ``tiled``: 32 x 16 tiles (`TX`, `TY`; `RT` rows a thread), planes
  staged by cp.async `AHEAD` ahead in a ring of `RING` slots, one barrier
  a plane; copies inside the owned box go without the table.
* ``slab``: for a plane of at most `SLAB_MAX_POINTS` points, a CTA takes
  a band of whole rows and stages all its tz + 2 planes at once, then
  sums: one memory latency a launch.

Operand: `StencilOperand` (staged by `parallel/gpu_gmg.py`): a per-part
table of the box shape, the owned count and the segment offset of every
direction, and a mask for wrapped segments on periodic partitions;
`bind_kernel` attaches the kernel's launch, per dtype, once at staging:
`plan_launch` picks the form from the box shape and the planes a CTA from
the CUDA occupancy API, so that one wave of CTAs fills the card.

Result: ``(P, n)``, the owned band of the operand's frame (n = the largest
owned count); slots past a part's owned count are 0.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises. Launches count in `dia.LAUNCHES["box_stencil_apply"]`.
The kernel is built with the others by `dia.build_kernels`.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from . import dia

#: ints per part in the table: fb[3], the owned count, 27 segment offsets
TABLE = 32
#: the kernel's forms, by their code (PA_FORM_TILED, PA_FORM_SLAB)
FORMS = ("tiled", "slab")
TILED, SLAB = FORMS
#: threads a CTA (PA_THREADS); the tiled form's rows a thread (PA_RT), its
#: tile, points by rows (PA_TX, PA_TY), its planes in flight ahead of the
#: one summed (PA_AHEAD) and its ring of staged planes (PA_RING), as
#: csrc/box_stencil.cu defines them (its launch refuses other tile rows)
THREADS, RT, TX = 256, 2, 32
TY = THREADS // TX * RT
AHEAD = 4
RING = AHEAD + 1
#: a level takes the slab form where one plane of its box has at most this
#: many points: up to 32 x 32 (the 24^3 and 12^3 levels) a 32 x 16 tile
#: leaves lanes idle and the tiles are too few to fill the card (on an
#: H100 the slab form was the faster on 24^2-, 12^2- and 6^2-point planes,
#: one part and eight, the tiled form from 48^2 up; chip_smoke.py's
#: box_stencil_level lines time both forms on every level)
SLAB_MAX_POINTS = 1024
#: dynamic shared memory a slab CTA may take (the default limit)
SLAB_SMEM = 48 * 1024


def dir_index(e: Tuple[int, ...]) -> int:
    """The table slot of a direction e (entries in {-1, 0, 1}, padded with
    leading zeros to three dimensions): (e0+1)*9 + (e1+1)*3 + (e2+1)."""
    e = (0,) * (3 - len(e)) + tuple(e)
    return (e[0] + 1) * 9 + (e[1] + 1) * 3 + (e[2] + 1)


@dataclass(frozen=True)
class StencilGroup:
    """Parts sharing one box (one descriptor of `_stage_stencil_transfer`):
    their indices (None when the group is every part, in order), the fine
    box ``fb``, the coarse box ``cb`` and the even-point start ``st``."""

    idx: Optional[torch.Tensor]
    fb: Tuple[int, ...]
    cb: Tuple[int, ...]
    st: Tuple[int, ...]


@dataclass(frozen=True)
class StencilOperand:
    """S over one level's box layout. ``table`` (P, TABLE) int32 (module
    docstring of csrc/box_stencil.cu); ``mask`` (P, 27) in the working
    dtype, per direction slot, or None where no segment wraps; ``dirs``
    the plan's directions as ``(direction, segment offset)`` in plan
    order; ``groups`` the parts by box; ``o0``/``g0``/``W`` the operand
    frame; ``n`` the result width; ``fmax`` the largest box extent per
    axis over the parts (padded as the table; the kernel's grid);
    ``launch`` the kernel's parameters and entry points on a CUDA device
    (`bind_kernel`), None on the CPU."""

    dim: int
    table: torch.Tensor
    mask: Optional[torch.Tensor]
    dirs: Tuple[Tuple[Tuple[int, ...], int], ...]
    groups: Tuple[StencilGroup, ...]
    o0: int
    g0: int
    W: int
    n: int
    fmax: Tuple[int, int, int]
    launch: Any = None


def _rows(t: torch.Tensor, idx: Optional[torch.Tensor]) -> torch.Tensor:
    return t if idx is None else t[idx]


def box_stencil_apply_plain(op: StencilOperand, xv: torch.Tensor) -> torch.Tensor:
    """Plain version of `box_stencil_apply` (`_stencil_apply`,
    tpu_gmg.py:292-319, over each group of parts): embed the owned box and
    the ghost segments into the zero-padded extended box, then sum the 3^d
    shifted slices in np.ndindex order with weights 0.5^|δ|₀."""
    P = xv.shape[0]
    y = xv.new_zeros((P, op.n))
    for g in op.groups:
        fb = g.fb
        no = math.prod(fb)
        ng = P if g.idx is None else len(g.idx)
        ext = xv.new_zeros((ng,) + tuple(b + 2 for b in fb))
        ext[(slice(None),) + tuple(slice(1, 1 + b) for b in fb)] = (
            _rows(xv, g.idx)[:, op.o0 : op.o0 + no].reshape((ng,) + fb)
        )
        for e, off in op.dirs:
            shape = tuple(1 if c != 0 else b for c, b in zip(e, fb))
            seg = _rows(xv, g.idx)[:, op.g0 + off : op.g0 + off + math.prod(shape)].reshape((ng,) + shape)
            if op.mask is not None:
                seg = seg * _rows(op.mask, g.idx)[:, dir_index(e)].reshape((ng,) + (1,) * len(fb))
            sl = tuple(
                slice(0, 1) if c == -1 else slice(1 + b, 2 + b) if c == 1 else slice(1, 1 + b)
                for c, b in zip(e, fb)
            )
            ext[(slice(None),) + sl] = seg
        acc = None
        for delta in np.ndindex(*(3,) * len(fb)):
            d = tuple(c - 1 for c in delta)
            w = 0.5 ** sum(1 for c in d if c != 0)
            t = ext[(slice(None),) + tuple(slice(1 + c, 1 + c + b) for c, b in zip(d, fb))]
            term = t if w == 1.0 else w * t
            acc = term if acc is None else acc + term
        if g.idx is None:
            y[:, :no] = acc.reshape(ng, no)
        else:
            y[g.idx, :no] = acc.reshape(ng, no)
    return y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class LaunchPlan:
    """How one operand launches the kernel in one dtype: the form, the
    planes a CTA sums (``tz``), the box rows it sums (``rows``), its
    threads and dynamic shared memory, the grid, and the CTAs the occupancy
    API lets an SM hold at those threads and that shared memory."""

    form: str
    tz: int
    rows: int
    threads: int
    smem: int
    grid: Tuple[int, int, int]
    occupancy: int


def plan_launch(fmax: Tuple[int, int, int], P: int, itemsize: int,
                occupancy: Callable[[str, int, int], int], n_sm: int, form: Optional[str] = None) -> LaunchPlan:
    """The launch of a box of largest extents ``fmax`` over ``P`` stacked
    parts, from shapes alone. ``occupancy(form, threads, smem)`` is the
    CTAs an SM holds (the CUDA occupancy API, through the kernel's C
    interface), ``n_sm`` the card's SM count.

    The form: the slab form where one plane of the box, fmax1 x fmax2, has
    at most `SLAB_MAX_POINTS` points (a 32 x 16 tile would leave most of its
    lanes idle, and the level has too few tiles to fill the card), else
    the tiled form; ``form`` names one instead (the tests and the timing
    hold both forms on every level). Planes a CTA: the tiled form splits
    each tile column's planes into chunks so that one wave of CTAs fills
    every SM to its occupancy; the slab form takes bands of whole rows (at
    most `THREADS` points a band, the bands equal) and as many planes as
    keeps one wave full, at least 1, its slab within `SLAB_SMEM`."""
    f0, f1, f2 = (int(v) for v in fmax)
    if form is None:
        form = SLAB if f1 * f2 <= SLAB_MAX_POINTS else TILED
    if form == TILED:
        tiles = P * _cdiv(f1, TY) * _cdiv(f2, TX)
        occ = occupancy(TILED, THREADS, 0)
        tz = _cdiv(f0, max(1, min(f0, occ * n_sm // tiles)))
        return LaunchPlan(TILED, tz, TY, THREADS, 0, (_cdiv(f2, TX), _cdiv(f1, TY), P * _cdiv(f0, tz)), occ)
    if form != SLAB:
        raise ValueError(f"box stencil kernel: no form {form!r} (tiled, slab)")
    rows = _cdiv(f1, _cdiv(f1, min(f1, max(1, THREADS // f2))))
    bands = _cdiv(f1, rows)
    threads = min(THREADS, 32 * _cdiv(rows * f2, 32))
    plane = (rows + 2) * (f2 + 2) * itemsize
    tz_max = SLAB_SMEM // plane - 2
    if tz_max < 1:
        raise ValueError(f"box stencil kernel: a slab of {rows} rows of {f2} points does not fit {SLAB_SMEM} bytes")
    slots = occupancy(SLAB, threads, 3 * plane) * n_sm
    tz = max(1, min(tz_max, f0, P * bands * f0 // slots))
    smem = (tz + 2) * plane
    return LaunchPlan(SLAB, tz, rows, threads, smem, (bands, 1, P * _cdiv(f0, tz)), occupancy(SLAB, threads, smem))


def _query(lib, name: str, form: str, threads: int, smem: int) -> Tuple[int, int, int, int]:
    out = (ctypes.c_int * 4)()
    rc = getattr(lib, f"pa_box_stencil_query_{name}")(FORMS.index(form), threads, smem, out)
    dia._raise_on(rc, "box_stencil_apply (occupancy query)")
    return tuple(out)


def kernel_attributes(dtype: torch.dtype, plan: LaunchPlan) -> dict:
    """The compiled form of a plan on the current CUDA device: registers a
    thread, static and dynamic shared memory a CTA, local memory a thread
    (spills) and the CTAs an SM holds."""
    occ, regs, static, local = _query(dia.build_kernels()["box_stencil"], dia._DT[dtype], plan.form,
                                      plan.threads, plan.smem)
    return {"registers": regs, "static_smem": static, "dynamic_smem": plan.smem, "local_bytes": local,
            "ctas_per_sm": occ}


def bind_kernel(op: StencilOperand, form: Optional[str] = None) -> StencilOperand:
    """The operand with its kernel's launch parameters and entry point per
    dtype, built (and its table checked) once per operand, when it is
    staged on a CUDA device; a CPU operand is returned as it is. ``form``
    forces a form (`plan_launch`)."""
    if op.table.device.type != "cuda":
        return op
    P = op.table.shape[0]
    if op.table.dtype != torch.int32 or tuple(op.table.shape) != (P, TABLE) or not op.table.is_contiguous():
        raise ValueError("box stencil kernel: the table must be (P, 32) int32 and contiguous")
    if op.n >= 2**31:
        raise ValueError(f"box stencil kernel: result width {op.n} needs 64-bit point indices")
    lib = dia.build_kernels()["box_stencil"]
    dev = op.table.device
    table = op.table.cpu()
    uniform = int(bool((table[:, :3] == torch.tensor(op.fmax, dtype=torch.int32)).all()))
    segs = int(bool((table[:, 4:31] >= 0).any()))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = {}
    with torch.cuda.device(dev):
        for dt, name in dia._DT.items():
            occ = lambda f, t, m, name=name: _query(lib, name, f, t, m)[0]  # noqa: E731
            plan = plan_launch(op.fmax, P, torch.finfo(dt).bits // 8, occ, n_sm, form)
            prm = dia._StencilParams(
                P=P, wx=op.W, n=op.n, o0=op.o0, g0=op.g0, fmax=(ctypes.c_int * 3)(*op.fmax),
                form=FORMS.index(plan.form), tz=plan.tz, rows=plan.rows, threads=plan.threads, smem=plan.smem,
                grid=(ctypes.c_int * 3)(*plan.grid), uniform=uniform, segs=segs,
            )
            launch[dt] = (prm, getattr(lib, f"pa_box_stencil_{name}"), plan)
    return replace(op, launch=launch)


def box_stencil_apply(op: StencilOperand, xv: torch.Tensor) -> torch.Tensor:
    """y = S x: xv (P, W) in the level's box frame, its ghost segments
    refreshed by the box exchange -> y (P, n), the owned band."""
    if xv.device.type == "cpu":
        return box_stencil_apply_plain(op, xv)
    if xv.device.type != "cuda":
        raise RuntimeError(f"box_stencil_apply: no kernel for device {xv.device}")
    if op.launch is None:
        raise ValueError("box stencil kernel: the operand is not bound to the kernel (stencil.bind_kernel)")
    if xv.dtype not in op.launch:
        raise TypeError(f"box stencil kernel takes float32 or float64, got {xv.dtype}")
    prm, fn, _ = op.launch[xv.dtype]
    P = prm.P
    if xv.dim() != 2 or tuple(xv.shape) != (P, op.W) or not xv.is_contiguous() or xv.device != op.table.device:
        raise ValueError(f"box stencil kernel: operand {tuple(xv.shape)} is not a contiguous ({P}, {op.W}) frame "
                         "on the table's device")
    if op.mask is not None and (
        op.mask.device != xv.device or op.mask.dtype != xv.dtype
        or tuple(op.mask.shape) != (P, 27) or not op.mask.is_contiguous()
    ):
        raise ValueError("box stencil kernel: the mask must be (P, 27) in the operand's dtype, on its device")
    y = torch.empty((P, op.n), dtype=xv.dtype, device=xv.device)
    rc = fn(
        ctypes.byref(prm), op.table.data_ptr(), 0 if op.mask is None else op.mask.data_ptr(),
        xv.data_ptr(), y.data_ptr(), torch.cuda.current_stream(xv.device).cuda_stream,
    )
    dia._raise_on(rc, "box_stencil_apply")
    dia.LAUNCHES["box_stencil_apply"] += 1
    return y
