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
stacked ``(P, W)`` frame, all parts in one launch (in tiles marching
through shared memory, a level of fewer dimensions as a 3-D box with
leading extents 1; see the source); the plain version is the
transcription of `_stencil_apply` over groups of parts with the same box.

Operand: `StencilOperand` (staged by `parallel/gpu_gmg.py`): a per-part
table of the box shape, the owned count and the segment offset of every
direction, and a mask for wrapped segments on periodic partitions;
`bind_kernel` attaches the kernel's launch parameters once, at staging.

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
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import dia

#: ints per part in the table: fb[3], the owned count, 27 segment offsets
TABLE = 32


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


def _planes_per_cta(op: StencilOperand) -> int:
    """Planes a CTA of the kernel marches through: 16 (1.5 global reads a
    point) where that still gives every SM of the card its 8 resident
    CTAs, else 4 (more CTAs for a small coarse level)."""
    P, (f0, f1, f2) = op.table.shape[0], op.fmax
    tiles = P * -(-f1 // 8) * -(-f2 // 32)
    full = 8 * torch.cuda.get_device_properties(op.table.device).multi_processor_count
    return 16 if tiles * -(-f0 // 16) >= full else 4


def bind_kernel(op: StencilOperand) -> StencilOperand:
    """The operand with its kernel's launch parameters and entry points,
    built (and its table checked) once per operand, when it is staged on a
    CUDA device; a CPU operand is returned as it is."""
    if op.table.device.type != "cuda":
        return op
    P = op.table.shape[0]
    if op.table.dtype != torch.int32 or tuple(op.table.shape) != (P, TABLE) or not op.table.is_contiguous():
        raise ValueError("box stencil kernel: the table must be (P, 32) int32 and contiguous")
    if op.n >= 2**31:
        raise ValueError(f"box stencil kernel: result width {op.n} needs 64-bit point indices")
    prm = dia._StencilParams(P=P, wx=op.W, n=op.n, o0=op.o0, g0=op.g0, fmax=(ctypes.c_int * 3)(*op.fmax),
                             tz=_planes_per_cta(op))
    lib = dia.build_kernels()["box_stencil"]
    fns = {dt: getattr(lib, f"pa_box_stencil_{name}") for dt, name in dia._DT.items()}
    return replace(op, launch=(prm, fns))


def box_stencil_apply(op: StencilOperand, xv: torch.Tensor) -> torch.Tensor:
    """y = S x: xv (P, W) in the level's box frame, its ghost segments
    refreshed by the box exchange -> y (P, n), the owned band."""
    if xv.device.type == "cpu":
        return box_stencil_apply_plain(op, xv)
    if xv.device.type != "cuda":
        raise RuntimeError(f"box_stencil_apply: no kernel for device {xv.device}")
    if op.launch is None:
        raise ValueError("box stencil kernel: the operand is not bound to the kernel (stencil.bind_kernel)")
    prm, fns = op.launch
    if xv.dtype not in fns:
        raise TypeError(f"box stencil kernel takes float32 or float64, got {xv.dtype}")
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
    rc = fns[xv.dtype](
        ctypes.byref(prm), op.table.data_ptr(), 0 if op.mask is None else op.mask.data_ptr(),
        xv.data_ptr(), y.data_ptr(), torch.cuda.current_stream(xv.device).cuda_stream,
    )
    dia._raise_on(rc, "box_stencil_apply")
    dia.LAUNCHES["box_stencil_apply"] += 1
    return y
