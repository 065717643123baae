"""Banded (DIA) SpMV: the CUDA kernels and their plain PyTorch versions.

Replaces the two TPU kernels of `partitionedarrays_jl_tpu/ops/pallas_dia.py`:

* the coded-diagonal kernel `_padded_kernel` (`csrc/dia_coded.cu`): the
  plain SpMV (`dia_coded_padded_pallas`, pallas_call at :523) becomes
  `dia_coded_spmv`, its CG direction-fold variant (``has_pfold``,
  pallas_call at :500) `dia_coded_spmv_pfold`, its lagged-axpy variant of
  pipelined CG (``has_axpy``, pallas_call at :535) `dia_coded_spmv_axpy`.
  Both decode modes are kept: the select-chain decode and the row-class
  decode (``cls_pattern``);
* the streaming-DIA kernel `_kernel` (`dia_spmv_pallas`, pallas_call at
  :110) becomes `dia_stream_spmv` (`csrc/dia_stream.cu`): dense
  per-diagonal values of a variable-coefficient band.

K2 also takes a shared ``minv`` (Jacobi PCG's fold ``p = minv*r +
beta*pprev``, the jnp fold the JAX package runs beside its Pallas kernel,
`parallel/tpu.py:3284-3286`). The block (multi-RHS) forms stand for the
XLA forms the JAX package takes on a ``(W, K)`` operand, where its Pallas
kernels are K = 1 only: `dia_coded_spmm` (`csrc/dia_coded_block.cu`, for
`_dia_coded_xla` and the block fold, tpu.py:3006-3020, :3284-3290) and
`dia_stream_spmm` (`csrc/dia_stream_block.cu`, for `_dia_rowsum`,
tpu.py:2960-2978). Their slabs are ``(P, W, K)``, the K columns of a row
contiguous, and column k of a product equals the single-vector kernel's
plain version on column k.

Frame: the port's compact ``(P, W)`` stacked vectors, owned band at
``o0``; each part's owned count ``no[p]`` may differ. The result is a whole
frame: owned rows computed, every other slot exactly 0. Reads outside a
part's owned band are predicated to 0 (the compact frame has no zero pads;
`parallel/tpu.py:_dia_coded_xla` zero-pads the same way).

Bound on the card (memory): at 192^3 f32, one part, the row-class SpMV
moves 9 B/row (x, one code byte, y), 63.7 MB, about 19.0 us at 3.35 TB/s;
the pfold variant 17 B/row (r, pprev, code byte, y, p), 120.3 MB, about
35.9 us; the axpy variant 21 B/row (x, code byte, y, pprev, xacc read and
written), 148.6 MB, about 44.4 us. The streaming SpMV at GMG level 1 of
192^3 (96^3 rows, 27 diagonals, f32) moves 116 B/row, 102.6 MB, about
30.6 us. The kernel designs are noted at the head of each `csrc/` file:
the coded kernel stages its operand in shared-memory windows laid out by
`plan_coded_windows`; the streaming kernel sums an unrolled band
(`STREAM_SHAPES`) in one of two forms chosen by shape (`stream_form`).

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises. Each kernel of the port (these, the multigrid
stencil of `ops/stencil.py`, the CG update sweep of `ops/sweep.py` and
the V-cycle epilogue of `ops/epilogue.py`) counts its launches in
`LAUNCHES`. Each
`csrc/*.cu` is built with nvcc at first use into
``build/pa_torch_kernels/`` (all sources at once, one nvcc each) and bound
with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

#: kernel launches since the last reset, per wrapper
LAUNCHES = {
    "dia_coded_spmv": 0, "dia_coded_spmv_pfold": 0, "dia_coded_spmv_axpy": 0,
    "dia_stream_spmv": 0, "box_stencil_apply": 0, "cg_sweep": 0, "vcycle_epilogue": 0,
    "dia_coded_spmv_pfold_minv": 0, "cg_sweep_precond": 0, "cg_sweep_block": 0,
    "dia_coded_spmm": 0, "dia_stream_spmm": 0, "block_products": 0,
    "ell_spmv": 0, "ell_spmv_boundary": 0, "bsr_spmv": 0, "bsr_spmv_boundary": 0, "pairwise_dot": 0,
    "ell_spmm": 0, "bsr_spmm": 0, "pairwise_dot_block": 0,
}

MAX_DIAGS = 64
MAX_CLASSES = 16
MAX_WINDOWS = MAX_DIAGS + 1  # the offsets and 0
MAX_BUFS = 2 * MAX_WINDOWS
#: planes of its stride a marching plan of the coded kernel reads (K)
MAX_PLANES = 3
#: shared memory one CTA of the coded kernel may take: with 96 KB at least
#: two CTAs share an H100 SM (228 KB of shared memory an SM)
SMEM_BUDGET = 96 * 1024
#: rows per tile the planner tries, largest first (multiples of the rows
#: a thread sums)
TILE_ROWS = (1024, 512, 256, 128, 64, 32)
#: rows one thread of the coded kernel sums (PA_ROWS in csrc/dia_coded.cu)
ROWS_PER_THREAD = 4
#: threads of one CTA of the coded kernel (PA_THREADS); a tile has at most
#: ROWS_PER_THREAD * THREADS rows
THREADS = 256

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the kernel sources of the port, one shared library each (box_stencil is
#: the multigrid stencil of ops/stencil.py, cg_sweep the CG update sweep of
#: ops/sweep.py, vcycle_epilogue the V-cycle's smoother and residual of
#: ops/epilogue.py, dia_coded_block and dia_stream_block the block SpMMs,
#: ell_spmv, bsr_spmv and pairwise_dot the irregular lowerings' products and
#: the strict dot of ops/irregular.py)
SOURCES = ("dia_coded", "dia_stream", "box_stencil", "cg_sweep", "vcycle_epilogue",
           "dia_coded_block", "dia_stream_block", "ell_spmv", "bsr_spmv", "pairwise_dot")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pa_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = None
#: nvcc's output (ptxas register / shared-memory report) of the last build
BUILD_LOG = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_nibble_codes(codes: np.ndarray) -> np.ndarray:
    """Pack per-diagonal uint8 codes (< 16) into the kernel's byte streams:
    two diagonals per byte, low nibble = even coded index. codes has the
    coded-diagonal axis at position -2: (..., Dc, N) -> (..., ceil(Dc/2), N)
    int8. This is the ONE definition of the packing convention the
    `_padded_kernel` decode relies on."""
    if codes.size and codes.max() >= 16:
        raise ValueError("nibble packing requires codes < 16 (CODE_MAX_VALUES)")
    Dc = codes.shape[-2]
    Dp = max(-(-Dc // 2), 1)
    packed = np.zeros(codes.shape[:-2] + (Dp,) + codes.shape[-1:], dtype=np.uint8)
    packed[..., : (Dc + 1) // 2, :] = codes[..., 0:Dc:2, :]
    if Dc > 1:
        packed[..., : Dc // 2, :] |= codes[..., 1:Dc:2, :] << 4
    return packed.view(np.int8)


@dataclass
class CodedOperator:
    """The staged coded-DIA operand of one stacked operator.

    cb: (P, D, kmax) codebook; no: (P,) int32 owned counts; codes:
    (P, streams, N) uint8 nibble-packed code bytes, N >= max(no);
    offsets/kk/code_row: per-diagonal band offset, codebook size and coded
    index (-1 for a constant diagonal); cls_pattern: per row class, which
    diagonals may be nonzero (row-class decode), or None (select chain);
    o0: the owned band's offset in every frame."""

    cb: torch.Tensor
    no: torch.Tensor
    codes: torch.Tensor
    offsets: Tuple[int, ...]
    kk: Tuple[int, ...]
    code_row: Tuple[int, ...]
    cls_pattern: Optional[Tuple[Tuple[bool, ...], ...]] = None
    o0: int = 0
    #: the kernel's parameters by (wx, wy, mode, dtype), built at first launch
    kernel_params: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        """Length of the owned band every part's frame reserves."""
        return int(self.codes.shape[-1])


#: the select-chain operators whose band sum csrc/dia_coded.cu specialises
#: at compile time (`SelectShape`), by diagonal count: the diagonals that
#: are constant (kk 1); every other one is coded with kk 2, in the
#: staging's order. 7: the 7-point operator of GMG level 0; 27: the
#: interpolation stencil S, its centre constant.
SELECT_SHAPES = {7: frozenset(), 27: frozenset({13})}


def select_chain_instance(op: CodedOperator) -> int:
    """The band sum `dia_coded_spmv` launches for op: its diagonal count
    when op is a select-chain operator of a `SELECT_SHAPES` shape (kk 1
    exactly on the shape's constant diagonals, 2 on the others, code rows
    0, 1, ... in ascending order), else 0, the run-time loop over any
    diagonals and codebook sizes. Both sum in ascending-offset order with
    the same rounding: the choice moves no result."""
    D = len(op.offsets)
    if op.cls_pattern is not None or D not in SELECT_SHAPES:
        return 0
    consts, ci = SELECT_SHAPES[D], 0
    for d in range(D):
        if d in consts:
            if op.kk[d] != 1:
                return 0
        elif op.kk[d] != 2 or op.code_row[d] != ci:
            return 0
        else:
            ci += 1
    return D if op.codes.shape[1] >= -(-ci // 2) else 0


# ---------------------------------------------------------------------------
# the coded kernel's shared-memory plan
# ---------------------------------------------------------------------------


#: the diagonal counts whose band sum csrc/dia_stream.cu unrolls at
#: compile time: 27, the Galerkin operators of the GMG levels past the
#: first; 7, a 7-point band. Any other count takes the run-time loop.
STREAM_SHAPES = (7, 27)
#: the streaming kernel's forms (`stream_form`): "stream", several rows a
#: thread (128-bit value loads where aligned), for levels that fill the
#: card; "small", one row a thread with every load of a row issued at once
STREAM = "stream"
SMALL = "small"
STREAM_FORMS = (STREAM, SMALL)
#: threads of a CTA of each form (PA_STREAM_THREADS, PA_SMALL_THREADS)
STREAM_THREADS = 256
SMALL_THREADS = 128
#: the stream form's grid from which it is taken, in CTAs a quarter of the
#: SMs: measured on an H100 (132 SMs, chip_smoke.py's `dia_stream_level`
#: lines), the small form is faster at 14 stream-form CTAs (12^3 and 24^3
#: f32), the two tie at 32 (8 stacked parts of 12^3, f64) and the stream
#: form is faster from 108 (48^3 f32) up
STREAM_MIN_SM_SHARE = 4
#: SMs of the card the form is chosen for when no card is at hand (H100 SXM)
DEFAULT_SMS = 132


def stream_rows_per_thread(itemsize: int) -> int:
    """Rows a thread of the stream form sums: one 16-byte vector."""
    return 16 // itemsize


def stream_form(P: int, n: int, itemsize: int, n_sm: int = DEFAULT_SMS) -> str:
    """The form of the streaming kernel for P stacked parts of n rows, from
    shapes alone: "stream" where its grid (P x ceil(n / rows a CTA)) gives
    at least a quarter of the SMs a CTA (`STREAM_MIN_SM_SHARE`), else
    "small" (at 192^3 f32: 96^3 and 48^3 stream, 24^3 and 12^3 small; every
    stacked 48^3 f64 level small)."""
    ctas = P * -(-n // (STREAM_THREADS * stream_rows_per_thread(itemsize)))
    return STREAM if ctas * STREAM_MIN_SM_SHARE >= n_sm else SMALL


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device; `DEFAULT_SMS` for any other device."""
    if device.type != "cuda":
        return DEFAULT_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@dataclass(frozen=True)
class WindowPlan:
    """Shared-memory layout and tile schedule of one CTA of the coded-DIA
    kernel (byte offsets; csrc/dia_coded.cu mirrors it in PaDiaParams).

    A CTA sums tiles of ``tile`` rows; step k sums the tile at row ts(k).
    Diagonal d reads the read window ``diag_window[d]``; ``zero_window``
    holds offset 0. ``windows`` are the offsets grouped, (lowest offset,
    span) each. Read window c of step k starts at row ts(k) +
    ``window_src[c]`` of buffer (k * ``step_bufs`` + ``window_buf[c]``) mod
    len(``buf_at``). Each step stages its new windows one step ahead: new
    window s of step k holds ``new_len[s]`` values from ts(k) +
    ``new_src[s]`` in buffer (k * step_bufs + ``new_buf[s]``) mod
    len(buf_at). Buffer b lies at ``buf_at[b]`` and has ``buf_slots[b]``
    values, the source's 16-byte phase first; in pfold its pprev copy lies
    ``pp_shift`` bytes after it (in pfold_minv its minv copy 2 *
    ``pp_shift`` bytes after it).

    ``stride`` > 0: a marching plan. A CTA walks one column of a plane
    through consecutive planes, ts(k+1) = ts(k) + stride, staging one plane
    a step into a ring of K + 1 buffers from which the K planes a tile
    reads come; ``lead`` = K - 1 steps are staged before the first.
    ``stride`` 0: every step stages every window, in two sets of buffers,
    and CTAs walk the part's tiles by the grid stride.

    The head (codebook at 0, the class coefficients at ``ccf_at``, n_cls
    rounded up to 4 per diagonal, a slot per diagonal and for offset 0 at
    ``sidx_at``) comes first, then the buffers (and their pprev copies),
    then two stages of the tile's own rows from ``stage_at``: the
    code bytes (``code_stride`` bytes per stream from ``code_at``) and, for
    axpy, its pprev and xacc rows (``axpy_at``); then room for the reads of
    rows past a tile smaller than ROWS_PER_THREAD * THREADS."""

    tile: int
    windows: Tuple[Tuple[int, int], ...]
    diag_window: Tuple[int, ...]
    zero_window: int
    stride: int
    lead: int
    step_bufs: int
    window_src: Tuple[int, ...]
    window_buf: Tuple[int, ...]
    new_src: Tuple[int, ...]
    new_buf: Tuple[int, ...]
    new_len: Tuple[int, ...]
    buf_at: Tuple[int, ...]
    buf_slots: Tuple[int, ...]
    pp_shift: int
    axpy_at: Tuple[int, int]
    code_at: int
    code_stride: int
    ccf_at: int
    sidx_at: int
    head_bytes: int
    stage_at: int
    stage_bytes: int
    smem_bytes: int


def _windows(offsets: Tuple[int, ...], tile: int) -> Tuple[Tuple[int, int], ...]:
    """The ascending offsets and 0, grouped: offsets closer than `tile`
    share one window. Returns (lowest offset, span) per window."""
    pts = sorted(set(int(o) for o in offsets) | {0})
    groups = [[pts[0], pts[0]]]
    for o in pts[1:]:
        if o - groups[-1][1] < tile:
            groups[-1][1] = o
        else:
            groups.append([o, o])
    return tuple((lo, hi - lo) for lo, hi in groups)


def _march(wins, zero: int, tile: int):
    """The marching schedule of the windows, or None: the stride M between
    the midpoints of the zero window and its neighbour, the plane k_c of
    each window (its midpoint over M, rounded), and the union U of the
    windows moved onto plane 0 as (lowest offset, span). None unless the
    windows span at most MAX_PLANES planes and one U a step stages fewer
    values than every window a step."""
    if len(wins) < 2:
        return None
    mid2 = [2 * lo + span for lo, span in wins]
    nb = zero + 1 if zero + 1 < len(wins) else zero - 1
    M = abs(mid2[nb] - mid2[zero]) // 2
    if M < tile:
        return None
    planes = tuple(int(np.floor((m - mid2[zero]) / (2 * M) + 0.5)) for m in mid2)
    lo_u = min(lo - k * M for (lo, _), k in zip(wins, planes))
    hi_u = max(lo + span - k * M for (lo, span), k in zip(wins, planes))
    if max(planes) - min(planes) + 1 > MAX_PLANES:
        return None
    if tile + hi_u - lo_u >= sum(tile + span for _, span in wins):
        return None
    return M, planes, lo_u, hi_u - lo_u


@functools.lru_cache(maxsize=256)
def plan_coded_windows(
    offsets: Tuple[int, ...], itemsize: int, mode: str = "plain", n_streams: int = 1,
    kmax: int = 1, budget: int = SMEM_BUDGET, n_cls: int = 0,
) -> WindowPlan:
    """The coded-DIA kernel's resource gate (the port's counterpart of the
    TPU planners `plan_dia_padded` and `pfold_vmem_ok`, sized for Hopper
    shared memory): the schedule and layout (see `WindowPlan`) at the
    largest tile of TILE_ROWS whose head, buffers and two stages fit
    `budget` bytes; a marching schedule where the windows allow one. mode
    is "plain", "pfold" (r and pprev buffers), "pfold_minv" (r, pprev and
    minv buffers) or "axpy" (the tile's pprev and xacc rows too); n_cls the
    row classes (0: select-chain decode).
    Raises ValueError when even the smallest tile does not fit."""
    if mode not in ("plain", "pfold", "pfold_minv", "axpy"):
        raise ValueError(f"plan_coded_windows: unknown mode {mode!r}")
    if itemsize not in (4, 8):
        raise ValueError(f"plan_coded_windows: itemsize {itemsize}, the kernel takes float32 or float64")
    D = len(offsets)
    if not 0 < D <= MAX_DIAGS:
        raise ValueError(f"coded-DIA kernel takes 1 to {MAX_DIAGS} diagonals, got {D}")
    vec = 16 // itemsize
    if not 0 <= n_cls <= MAX_CLASSES:
        raise ValueError(f"coded-DIA kernel takes at most {MAX_CLASSES} row classes, got {n_cls}")
    ccf_at = _round16(D * kmax * itemsize)
    sidx_at = ccf_at + _round16(D * -(-n_cls // 4) * 4 * itemsize)
    head = _round16(sidx_at + 4 * (D + 1))
    for tile in TILE_ROWS:
        wins = _windows(offsets, tile)
        zero = next(c for c, (lo, span) in enumerate(wins) if lo <= 0 <= lo + span)
        march = _march(wins, zero, tile)
        if march is not None:
            stride, planes, lo_u, span_u = march
            k0, K = min(planes), max(planes) - min(planes) + 1
            window_src = tuple(k * stride + lo_u for k in planes)
            window_buf = tuple(k - k0 for k in planes)
            new_src, new_buf, new_len = (max(planes) * stride + lo_u,), (K - 1,), (tile + span_u,)
            lead, step_bufs, lens = K - 1, 1, (tile + span_u,) * (K + 1)
        else:
            stride, lead, step_bufs = 0, 0, len(wins)
            window_src = new_src = tuple(lo for lo, _ in wins)
            window_buf = new_buf = tuple(range(len(wins)))
            new_len = tuple(tile + span for _, span in wins)
            lens = new_len * 2
        # the phase in front, and room for a 16-byte read past the end
        buf_slots = tuple(n + 2 * vec for n in lens)
        buf_at, at = [], head
        for s in buf_slots:
            buf_at.append(at)
            at += _round16(s * itemsize)
        # pfold: a pprev copy of every buffer pp_shift bytes after it;
        # pfold_minv: and a minv copy 2 * pp_shift after it
        copies = {"pfold": 1, "pfold_minv": 2}.get(mode, 0)
        pp_shift = at - head if copies else 0
        stage_at = at + copies * pp_shift
        axpy_at, st = (0, 0), 0
        if mode == "axpy":
            row_bytes = _round16((tile + 2 * vec) * itemsize)
            axpy_at, st = (0, row_bytes), 2 * row_bytes
        code_stride = tile + 32
        stage = st + n_streams * code_stride
        # a thread reads its ROWS_PER_THREAD rows of a region even past a
        # smaller tile (and does not store them): room for that at the end
        past = ROWS_PER_THREAD * THREADS - tile
        ends = [a + (n + past) * itemsize for a, n in zip(buf_at, buf_slots)]
        for h in range(2):
            ends += [stage_at + h * stage + a + (tile + 2 * vec + past) * itemsize for a in axpy_at[: 2 if st else 0]]
            ends += [stage_at + h * stage + st + s * code_stride + tile + 16 + past for s in range(n_streams)]
        total = _round16(max([stage_at + 2 * stage] + ends))
        if total <= budget:
            diag_window = tuple(
                next(c for c, (lo, span) in enumerate(wins) if lo <= o <= lo + span) for o in offsets
            )
            return WindowPlan(
                tile=tile, windows=wins, diag_window=diag_window, zero_window=zero, stride=stride,
                lead=lead, step_bufs=step_bufs, window_src=window_src, window_buf=window_buf,
                new_src=new_src, new_buf=new_buf, new_len=new_len, buf_at=tuple(buf_at),
                buf_slots=buf_slots, pp_shift=pp_shift, axpy_at=axpy_at, code_at=st,
                code_stride=code_stride, ccf_at=ccf_at, sidx_at=sidx_at, head_bytes=head,
                stage_at=stage_at, stage_bytes=stage, smem_bytes=total,
            )
    raise ValueError(
        f"coded-DIA kernel: {D} diagonals in {mode} mode ({itemsize}-byte values, {n_streams} code "
        f"streams) need {total} bytes of shared memory at {TILE_ROWS[-1]} rows a tile, over the "
        f"{budget}-byte budget"
    )


def spmm_items(K: int, itemsize: int) -> int:
    """(row, column group) items a thread of the coded SpMM's staged form
    sums (`spmm_items` in csrc/dia_coded_block.cu): 4, or 2 where a group
    (`block_columns` values) is 32 bytes or more. A tile holds at most
    spmm_items * THREADS items."""
    return 2 if block_columns(K) * itemsize >= 32 else 4


#: coefficient table entries a diagonal of the staged form: one per 4-bit code
SPMM_CODES = 16
#: the coded SpMM's forms (`spmm_form`): "row", a thread a row and its
#: operand rows read from global memory; "staged", K1's windows and march
#: over K columns a row
SPMM_ROW = "row"
SPMM_STAGED = "staged"
SPMM_FORMS = (SPMM_ROW, SPMM_STAGED)
#: the smallest tile (rows) at which the staged form is taken. Measured on
#: an H100 at 192^3 f32 (tools/time_coded_kernels.py --block 2 4 8; PERF.md):
#: at 1024 rows it beats the row form in every width and mode that plans
#: it; at 512 it ties or loses (the halo of a 7-point plane, 2n = 384 rows,
#: is staged beside each tile), at 256 it runs 2.5-3x the row form
STAGED_MIN_TILE = 1024
#: shared memory one CTA of the staged form may take: two CTAs share an
#: H100 SM (228 KB, 1 KB of it reserved a CTA)
SPMM_BUDGET = 113 * 1024


@dataclass(frozen=True)
class BlockWindowPlan:
    """Shared-memory layout and tile schedule of one CTA of the coded SpMM's
    staged form (byte offsets; csrc/dia_coded_block.cu mirrors it in
    PaSpmmParams). The schedule is `WindowPlan`'s over rows of K values:
    ``tile`` rows a step, ``groups`` column groups a row (a power of two;
    tile * groups items at most `spmm_items` * THREADS), the windows, march
    and ring as
    `plan_coded_windows` lays them out. Buffer b lies at ``buf_at[b]`` and
    holds ``buf_slots[b]`` values (its rows' K values each, the source's
    16-byte phase first); in pfold its pprev copy lies ``pp_shift`` bytes
    after it, and in pfold_minv its minv buffer (a value a row) at
    ``mv_at + b * mv_bytes``. The head: the coefficient table at
    ``ccf_at`` (SPMM_CODES a diagonal), beta at ``beta_at``, the operand
    slot of every diagonal and of offset 0 at ``sidx_at``, the code byte
    slot and nibble shift of every diagonal at ``cidx_at`` and ``csh_at``;
    after the buffers two stages of the tile's code bytes (``code_stride``
    bytes a stream) from ``stage_at``."""

    tile: int
    groups: int
    windows: Tuple[Tuple[int, int], ...]
    diag_window: Tuple[int, ...]
    zero_window: int
    stride: int
    lead: int
    step_bufs: int
    window_src: Tuple[int, ...]
    window_buf: Tuple[int, ...]
    new_src: Tuple[int, ...]
    new_buf: Tuple[int, ...]
    new_len: Tuple[int, ...]
    buf_at: Tuple[int, ...]
    buf_slots: Tuple[int, ...]
    pp_shift: int
    mv_at: int
    mv_bytes: int
    ccf_at: int
    beta_at: int
    sidx_at: int
    cidx_at: int
    csh_at: int
    head_bytes: int
    stage_at: int
    stage_bytes: int
    code_stride: int
    smem_bytes: int


def _block_plan(offsets, itemsize, K, mode, n_streams, budget) -> Tuple[Optional[BlockWindowPlan], int]:
    """The largest-tile staged plan within budget, or None; and the bytes
    of the last plan tried."""
    D, vec = len(offsets), 16 // itemsize
    G = -(-K // block_columns(K))
    if G & (G - 1):
        # a thread's column group is threadIdx.x mod G: no plan
        return None, 0
    ccf_at = 0
    beta_at = _round16(D * SPMM_CODES * itemsize)
    sidx_at = beta_at + _round16(K * itemsize)
    cidx_at = sidx_at + _round16(4 * (D + 1))
    csh_at = cidx_at + _round16(4 * D)
    head = csh_at + _round16(4 * D)
    total = head
    for tile in TILE_ROWS:
        if tile * G > spmm_items(K, itemsize) * THREADS:
            continue
        wins = _windows(offsets, tile)
        zero = next(c for c, (lo, span) in enumerate(wins) if lo <= 0 <= lo + span)
        march = _march(wins, zero, tile)
        if march is not None:
            stride, planes, lo_u, span_u = march
            k0, npl = min(planes), max(planes) - min(planes) + 1
            window_src = tuple(k * stride + lo_u for k in planes)
            window_buf = tuple(k - k0 for k in planes)
            new_src, new_buf, new_len = (max(planes) * stride + lo_u,), (npl - 1,), (tile + span_u,)
            lead, step_bufs, lens = npl - 1, 1, (tile + span_u,) * (npl + 1)
        else:
            stride, lead, step_bufs = 0, 0, len(wins)
            window_src = new_src = tuple(lo for lo, _ in wins)
            window_buf = new_buf = tuple(range(len(wins)))
            new_len = tuple(tile + span for _, span in wins)
            lens = new_len * 2
        # a window's K values a row, the phase in front and a 16-byte copy's
        # room past the end
        buf_slots = tuple(n * K + 2 * vec for n in lens)
        buf_at, at = [], head
        for n in buf_slots:
            buf_at.append(at)
            at += _round16(n * itemsize)
        pp_shift = at - head if mode != "plain" else 0
        at += pp_shift
        mv_at, mv_bytes = 0, 0
        if mode == "pfold_minv":
            mv_at, mv_bytes = at, _round16((max(lens) + 2 * vec) * itemsize)
            at += len(lens) * mv_bytes
        code_stride = tile + 32
        stage = max(n_streams, 1) * code_stride
        total = _round16(at + 2 * stage)
        if total <= budget:
            diag_window = tuple(
                next(c for c, (lo, span) in enumerate(wins) if lo <= o <= lo + span) for o in offsets
            )
            return BlockWindowPlan(
                tile=tile, groups=G, windows=wins, diag_window=diag_window, zero_window=zero, stride=stride,
                lead=lead, step_bufs=step_bufs, window_src=window_src, window_buf=window_buf, new_src=new_src,
                new_buf=new_buf, new_len=new_len, buf_at=tuple(buf_at), buf_slots=buf_slots, pp_shift=pp_shift,
                mv_at=mv_at, mv_bytes=mv_bytes, ccf_at=ccf_at, beta_at=beta_at, sidx_at=sidx_at, cidx_at=cidx_at,
                csh_at=csh_at, head_bytes=head, stage_at=at, stage_bytes=stage, code_stride=code_stride,
                smem_bytes=total,
            ), total
    return None, total


def _check_block_plan_args(offsets, itemsize, K, mode) -> None:
    if mode not in ("plain", "pfold", "pfold_minv"):
        raise ValueError(f"plan_coded_block_windows: unknown mode {mode!r}")
    if itemsize not in (4, 8):
        raise ValueError(f"plan_coded_block_windows: itemsize {itemsize}, the kernel takes float32 or float64")
    if not 0 < len(offsets) <= MAX_DIAGS:
        raise ValueError(f"coded SpMM takes 1 to {MAX_DIAGS} diagonals, got {len(offsets)}")
    if K < 1:
        raise ValueError(f"coded SpMM takes at least one column, got {K}")


@functools.lru_cache(maxsize=256)
def plan_coded_block_windows(
    offsets: Tuple[int, ...], itemsize: int, K: int, mode: str = "plain", n_streams: int = 1,
    budget: int = SPMM_BUDGET,
) -> BlockWindowPlan:
    """The staged form's resource gate: `plan_coded_windows`' schedule for
    rows K values wide (K * itemsize bytes), at the largest tile of
    TILE_ROWS whose items fit a CTA (tile * groups <= `spmm_items` *
    THREADS) and whose head, buffers and two code stages fit `budget`
    bytes. mode is "plain", "pfold" (r and pprev buffers) or "pfold_minv"
    (and a minv buffer, a value a row). Raises ValueError when even the
    smallest tile does not fit, or when a row's column groups are not a
    power of two (K > 8 and not a multiple of 8 times one)."""
    _check_block_plan_args(offsets, itemsize, K, mode)
    groups = -(-K // block_columns(K))
    if groups & (groups - 1):
        raise ValueError(f"coded SpMM: {K} columns make {groups} column groups a row, not a power of two")
    plan, total = _block_plan(tuple(int(o) for o in offsets), itemsize, K, mode, n_streams, budget)
    if plan is None:
        raise ValueError(
            f"coded SpMM: {len(offsets)} diagonals, {K} columns in {mode} mode ({itemsize}-byte values, "
            f"{n_streams} code streams) need {total} bytes of shared memory at {TILE_ROWS[-1]} rows a tile, "
            f"over the {budget}-byte budget"
        )
    return plan


def spmm_nd(op: CodedOperator, K: int, mode: str) -> int:
    """The staged form's sum for op: 7, unrolled with each coefficient a
    select between its diagonal's two codebook slots, for 7 diagonals of
    codebook sizes at most 2 in plain mode at K = 2 to 4 (the s-step pair
    and the LOBPCG block on the 7-point operators); else 0, the run-time
    loop over the code table. Both sum in ascending order with the same
    rounding: the choice moves no result."""
    two = len(op.offsets) == 7 and max(op.kk) <= 2
    return 7 if two and mode == "plain" and block_columns(K) in (2, 4) else 0


@functools.lru_cache(maxsize=256)
def spmm_form(offsets: Tuple[int, ...], itemsize: int, K: int, mode: str = "plain", n_streams: int = 1) -> str:
    """The coded SpMM's form for an operator's offsets and a slab of K
    columns, from shapes alone: "staged" where its plan
    (`plan_coded_block_windows`) fits SPMM_BUDGET at a tile of at least
    STAGED_MIN_TILE rows, else "row"."""
    _check_block_plan_args(offsets, itemsize, K, mode)
    plan, _ = _block_plan(offsets, itemsize, K, mode, n_streams, SPMM_BUDGET)
    return SPMM_STAGED if plan is not None and plan.tile >= STAGED_MIN_TILE else SPMM_ROW


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _owned_mask(op: CodedOperator, device) -> torch.Tensor:
    return torch.arange(op.n, device=device)[None, :] < op.no.to(device)[:, None]


def _band_sum(op: CodedOperator, xo: torch.Tensor) -> torch.Tensor:
    """y[:, i] = sum_d v_d(i) * xo[:, i + off_d] over the owned band, in
    ascending-offset order; xo is already zero outside each part's band."""
    n = op.n
    pad = max(abs(int(o)) for o in op.offsets)
    xp = torch.nn.functional.pad(xo, (pad, pad))
    acc = None
    for d, off in enumerate(op.offsets):
        shifted = xp[:, pad + off : pad + off + n]
        if op.kk[d] == 1:
            v = op.cb[:, d, 0:1]
        else:
            ci = op.code_row[d]
            byte = op.codes[:, ci // 2, :n].to(torch.int64)
            c = (byte >> (4 * (ci % 2))) & 15
            c = torch.where(c < op.kk[d], c, 0)
            v = torch.gather(op.cb[:, d, :], 1, c)
        term = v * shifted
        acc = term if acc is None else acc + term
    return acc


def dia_coded_spmv_plain(op: CodedOperator, x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of `dia_coded_spmv` (the `_dia_coded_xla` semantics of
    parallel/tpu.py:3006-3020 on the stacked frame): every diagonal is
    summed, coefficient zeros included."""
    n, o0 = op.n, op.o0
    own = _owned_mask(op, x.device)
    xo = torch.where(own, x[:, o0 : o0 + n], 0)
    y = x.new_zeros((x.shape[0], width))
    y[:, o0 : o0 + n] = torch.where(own, _band_sum(op, xo), 0)
    return y


def _fold(r: torch.Tensor, pprev: torch.Tensor, beta: torch.Tensor,
          minv: Optional[torch.Tensor]) -> torch.Tensor:
    """The CG direction fold ``r + beta*pprev``, or with minv ``minv*r +
    beta*pprev`` (each product rounded, then the add)."""
    return (r if minv is None else minv * r) + beta * pprev


def dia_coded_spmv_pfold_plain(
    op: CodedOperator, r: torch.Tensor, pprev: torch.Tensor, beta: torch.Tensor,
    width: int, minv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `dia_coded_spmv_pfold`: the fold of `body_pfold`'s
    jnp branch (parallel/tpu.py:3284-3290), ``p = r + beta*pprev`` (with
    ``minv``: ``p = minv*r + beta*pprev``) on the owned band, then the band
    sum of p. Returns (y, p)."""
    n, o0 = op.n, op.o0
    own = _owned_mask(op, r.device)
    band = slice(o0, o0 + n)
    pb = torch.where(own, _fold(r[:, band], pprev[:, band], beta, None if minv is None else minv[:, band]), 0)
    p = torch.zeros_like(r)
    p[:, o0 : o0 + n] = pb
    y = r.new_zeros((r.shape[0], width))
    y[:, o0 : o0 + n] = torch.where(own, _band_sum(op, pb), 0)
    return y, p


def dia_coded_spmv_axpy_plain(
    op: CodedOperator, x: torch.Tensor, xacc: torch.Tensor, pprev: torch.Tensor,
    alpha: torch.Tensor, width: int, live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of `dia_coded_spmv_axpy`: the lagged update of
    `_spmv_body(axpy=True)`'s fallback (parallel/tpu.py:3246-3252),
    ``xacc += alpha*pprev`` on each part's owned band, in place (where
    ``live``, if given, is not 0: else a select writes back the same bits),
    then `dia_coded_spmv_plain` of x. Returns y."""
    n, o0 = op.n, op.o0
    own = _owned_mask(op, x.device)
    if live is not None:
        own = own & (live.reshape(()) != 0)
    band = xacc[:, o0 : o0 + n]
    band.copy_(torch.where(own, band + alpha * pprev[:, o0 : o0 + n], band))
    return dia_coded_spmv_plain(op, x, width)


def dia_stream_spmv_plain(
    vals: torch.Tensor, x: torch.Tensor, offsets: Tuple[int, ...], no: torch.Tensor,
    o0: int, width: int,
) -> torch.Tensor:
    """Plain version of `dia_stream_spmv` (`_dia_rowsum`,
    parallel/tpu.py:2960-2975, on the stacked frame): the ascending-offset
    sum of ``vals[:, d] * shift(x, off_d)`` over each part's owned band,
    reads outside it predicated to 0."""
    n = vals.shape[-1]
    own = torch.arange(n, device=x.device)[None, :] < no.to(x.device)[:, None]
    xo = torch.where(own, x[:, o0 : o0 + n], 0)
    pad = max(abs(int(o)) for o in offsets)
    xp = torch.nn.functional.pad(xo, (pad, pad))
    acc = None
    for d, off in enumerate(offsets):
        term = vals[:, d, :] * xp[:, pad + off : pad + off + n]
        acc = term if acc is None else acc + term
    y = x.new_zeros((x.shape[0], width))
    y[:, o0 : o0 + n] = torch.where(own, acc, 0)
    return y


def _band_sum_block(op: CodedOperator, uo: torch.Tensor) -> torch.Tensor:
    """`_band_sum` over K columns: uo (P, n, K), zero outside each part's
    band; each column's terms and order those of `_band_sum`."""
    n = op.n
    pad = max(abs(int(o)) for o in op.offsets)
    up = torch.nn.functional.pad(uo, (0, 0, pad, pad))
    acc = None
    for d, off in enumerate(op.offsets):
        shifted = up[:, pad + off : pad + off + n, :]
        if op.kk[d] == 1:
            v = op.cb[:, d, 0:1]
        else:
            ci = op.code_row[d]
            byte = op.codes[:, ci // 2, :n].to(torch.int64)
            c = (byte >> (4 * (ci % 2))) & 15
            c = torch.where(c < op.kk[d], c, 0)
            v = torch.gather(op.cb[:, d, :], 1, c)
        term = v[:, :, None] * shifted
        acc = term if acc is None else acc + term
    return acc


def dia_coded_spmm_plain(op: CodedOperator, x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of `dia_coded_spmm` on the plain mode: x (P, Wx, K) ->
    y (P, width, K); column k is `dia_coded_spmv_plain` of column k."""
    n, o0 = op.n, op.o0
    own = _owned_mask(op, x.device)[:, :, None]
    xo = torch.where(own, x[:, o0 : o0 + n], 0)
    y = x.new_zeros((x.shape[0], width, x.shape[2]))
    y[:, o0 : o0 + n] = torch.where(own, _band_sum_block(op, xo), 0)
    return y


def dia_coded_spmm_pfold_plain(
    op: CodedOperator, r: torch.Tensor, pprev: torch.Tensor, beta: torch.Tensor, width: int,
    minv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `dia_coded_spmm_pfold`: the block fold ``p = r +
    beta[k]*pprev`` (with a shared ``minv`` (P, Wx): ``p = minv*r +
    beta[k]*pprev``) on the owned band, then its band sum. Column k is
    `dia_coded_spmv_pfold_plain` of column k with beta[k]. Returns (y, p)."""
    n, o0 = op.n, op.o0
    own = _owned_mask(op, r.device)[:, :, None]
    band = slice(o0, o0 + n)
    mv = None if minv is None else minv[:, band, None]
    pb = torch.where(own, _fold(r[:, band], pprev[:, band], beta, mv), 0)
    p = torch.zeros_like(r)
    p[:, band] = pb
    y = r.new_zeros((r.shape[0], width, r.shape[2]))
    y[:, band] = torch.where(own, _band_sum_block(op, pb), 0)
    return y, p


def dia_stream_spmm_plain(
    vals: torch.Tensor, x: torch.Tensor, offsets: Tuple[int, ...], no: torch.Tensor,
    o0: int, width: int,
) -> torch.Tensor:
    """Plain version of `dia_stream_spmm`: x (P, Wx, K) -> y (P, width, K);
    column k is `dia_stream_spmv_plain` of column k."""
    n = vals.shape[-1]
    own = (torch.arange(n, device=x.device)[None, :] < no.to(x.device)[:, None])[:, :, None]
    xo = torch.where(own, x[:, o0 : o0 + n], 0)
    pad = max(abs(int(o)) for o in offsets)
    xp = torch.nn.functional.pad(xo, (0, 0, pad, pad))
    acc = None
    for d, off in enumerate(offsets):
        term = vals[:, d, :, None] * xp[:, pad + off : pad + off + n, :]
        acc = term if acc is None else acc + term
    y = x.new_zeros((x.shape[0], width, x.shape[2]))
    y[:, o0 : o0 + n] = torch.where(own, acc, 0)
    return y


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of `PaDiaParams` in csrc/dia_coded.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("D", ctypes.c_int),
        ("kmax", ctypes.c_int),
        ("n_streams", ctypes.c_int),
        ("code_len", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("n_cls", ctypes.c_int),
        ("off", ctypes.c_int * MAX_DIAGS),
        ("kk", ctypes.c_int * MAX_DIAGS),
        ("code_row", ctypes.c_int * MAX_DIAGS),
        ("cls_mask", ctypes.c_ulonglong * MAX_CLASSES),
        ("stride", ctypes.c_longlong),
        ("T", ctypes.c_int),
        ("ncol", ctypes.c_int),
        ("planes", ctypes.c_int),
        ("lead", ctypes.c_int),
        ("n_buf", ctypes.c_int),
        ("step_bufs", ctypes.c_int),
        ("grid_x", ctypes.c_int),
        ("n_new", ctypes.c_int),
        ("zero_win", ctypes.c_int),
        ("ccf_at", ctypes.c_int),
        ("sidx_at", ctypes.c_int),
        ("pp_shift", ctypes.c_int),
        ("stage_at", ctypes.c_int),
        ("stage_bytes", ctypes.c_int),
        ("code_at", ctypes.c_int),
        ("code_stride", ctypes.c_int),
        ("ax_pp_at", ctypes.c_int),
        ("ax_xa_at", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("win_src", ctypes.c_int * MAX_WINDOWS),
        ("win_buf", ctypes.c_int * MAX_WINDOWS),
        ("new_src", ctypes.c_int * MAX_WINDOWS),
        ("new_buf", ctypes.c_int * MAX_WINDOWS),
        ("new_len", ctypes.c_int * MAX_WINDOWS),
        ("buf_at", ctypes.c_int * MAX_BUFS),
        ("diag_win", ctypes.c_int * MAX_DIAGS),
        ("nd_spec", ctypes.c_int),
    ]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


class _StreamParams(ctypes.Structure):
    """Mirror of `PaStreamParams` in csrc/dia_stream.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("D", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("off", ctypes.c_int * MAX_DIAGS),
        ("form", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("nd", ctypes.c_int),
    ]


class _SpmmParams(ctypes.Structure):
    """Mirror of `PaSpmmParams` in csrc/dia_coded_block.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("D", ctypes.c_int),
        ("kmax", ctypes.c_int),
        ("n_streams", ctypes.c_int),
        ("code_len", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("K", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("off", ctypes.c_int * MAX_DIAGS),
        ("kk", ctypes.c_int * MAX_DIAGS),
        ("code_row", ctypes.c_int * MAX_DIAGS),
        ("KB", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("form", ctypes.c_int),
        ("T", ctypes.c_int),
        ("G", ctypes.c_int),
        ("ncol", ctypes.c_int),
        ("planes", ctypes.c_int),
        ("lead", ctypes.c_int),
        ("n_buf", ctypes.c_int),
        ("step_bufs", ctypes.c_int),
        ("grid_x", ctypes.c_int),
        ("n_new", ctypes.c_int),
        ("zero_win", ctypes.c_int),
        ("one_code", ctypes.c_int),
        ("code0", ctypes.c_int),
        ("nd_spec", ctypes.c_int),
        ("ccf_at", ctypes.c_int),
        ("beta_at", ctypes.c_int),
        ("sidx_at", ctypes.c_int),
        ("cidx_at", ctypes.c_int),
        ("csh_at", ctypes.c_int),
        ("pp_shift", ctypes.c_int),
        ("mv_at", ctypes.c_int),
        ("mv_bytes", ctypes.c_int),
        ("stage_at", ctypes.c_int),
        ("stage_bytes", ctypes.c_int),
        ("code_stride", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("stride", ctypes.c_longlong),
        ("win_src", ctypes.c_int * MAX_WINDOWS),
        ("win_buf", ctypes.c_int * MAX_WINDOWS),
        ("new_src", ctypes.c_int * MAX_WINDOWS),
        ("new_buf", ctypes.c_int * MAX_WINDOWS),
        ("new_len", ctypes.c_int * MAX_WINDOWS),
        ("buf_at", ctypes.c_int * MAX_BUFS),
        ("diag_win", ctypes.c_int * MAX_DIAGS),
    ]


class _StreamSpmmParams(ctypes.Structure):
    """Mirror of `PaStreamSpmmParams` in csrc/dia_stream_block.cu."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("D", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("wx", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("K", ctypes.c_int),
        ("off", ctypes.c_int * MAX_DIAGS),
        ("KB", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


class _StencilParams(ctypes.Structure):
    """Mirror of `PaStencilParams` in csrc/box_stencil.cu (the kernel of
    ops/stencil.py)."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("wx", ctypes.c_longlong),
        ("n", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("g0", ctypes.c_longlong),
        ("fmax", ctypes.c_int * 3),
        ("form", ctypes.c_int),
        ("tz", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("smem", ctypes.c_int),
        ("grid", ctypes.c_int * 3),
        ("uniform", ctypes.c_int),
        ("segs", ctypes.c_int),
    ]


class _SweepParams(ctypes.Structure):
    """Mirror of `PaSweepParams` in csrc/cg_sweep.cu (the kernel of
    ops/sweep.py)."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("G", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("wv", ctypes.c_longlong),
        ("wq", ctypes.c_longlong),
        ("mode", ctypes.c_int),
        ("S", ctypes.c_int),
        ("K", ctypes.c_int),
        ("KB", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


class _EpilogueParams(ctypes.Structure):
    """Mirror of `PaEpilogueParams` in csrc/vcycle_epilogue.cu (the kernel of
    ops/epilogue.py)."""

    _fields_ = [
        ("P", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("o0", ctypes.c_longlong),
        ("wc", ctypes.c_longlong),
        ("yo0", ctypes.c_longlong),
        ("wy", ctypes.c_longlong),
        ("oo0", ctypes.c_longlong),
        ("wo", ctypes.c_longlong),
        ("omega", ctypes.c_double),
    ]


def _bind(lib: ctypes.CDLL, name: str, params, nptr: int) -> None:
    vp = ctypes.c_void_p
    for dt in ("f32", "f64"):
        f = getattr(lib, f"{name}_{dt}")
        f.argtypes = [ctypes.POINTER(params)] + [vp] * nptr
        f.restype = ctypes.c_int


def build_kernels() -> dict:
    """Compile every csrc/*.cu for sm_90a (once per content of all the
    sources; one nvcc per source, all started together) and load them.
    Returns the libraries by source name. Raises if nvcc fails."""
    global _libs, BUILD_LOG
    if _libs is not None:
        return _libs
    srcs = {name: _CSRC / f"{name}.cu" for name in SOURCES}
    blob = b"".join(srcs[n].read_bytes() for n in SOURCES)
    tag = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = {name: BUILD_DIR / f"libpa_{name}_{tag}.so" for name in SOURCES}
    procs = {}
    for name in SOURCES:
        if not sos[name].exists():
            tmp = BUILD_DIR / f".{sos[name].name}.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {name}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, sos[name])
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{BUILD_LOG}")
    libs = {name: ctypes.CDLL(str(sos[name])) for name in SOURCES}
    _bind(libs["dia_coded"], "pa_dia_coded", _Params, 6)
    _bind(libs["dia_coded"], "pa_dia_coded_pfold", _Params, 9)
    _bind(libs["dia_coded"], "pa_dia_coded_axpy", _Params, 10)
    _bind(libs["dia_coded"], "pa_dia_coded_pfold_minv", _Params, 10)
    _bind(libs["dia_stream"], "pa_dia_stream", _StreamParams, 5)
    _bind(libs["box_stencil"], "pa_box_stencil", _StencilParams, 5)
    _bind(libs["cg_sweep"], "pa_cg_sweep", _SweepParams, 10)
    _bind(libs["cg_sweep"], "pa_cg_sweep_block", _SweepParams, 10)
    _bind(libs["cg_sweep"], "pa_block_products", _SweepParams, 4)
    _bind(libs["dia_coded_block"], "pa_dia_coded_spmm", _SpmmParams, 10)
    _bind(libs["dia_stream_block"], "pa_dia_stream_spmm", _StreamSpmmParams, 5)
    _bind(libs["vcycle_epilogue"], "pa_vcycle_epilogue", _EpilogueParams, 6)
    from . import irregular

    irregular.bind(libs)
    for dt in ("f32", "f64"):
        f = getattr(libs["box_stencil"], f"pa_box_stencil_query_{dt}")
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        f.restype = ctypes.c_int
    libs["dia_coded"].pa_dia_null.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    libs["dia_coded"].pa_dia_null.restype = ctypes.c_int
    _libs = libs
    return libs


_DT = {torch.float32: "f32", torch.float64: "f64"}


def _params(op: CodedOperator, wx: int, wy: int, mode: str) -> _Params:
    """The kernel's parameters with its window plan, built once per frame
    widths, mode and dtype of an operator. The launcher writes the grid
    (`grid_x`, `planes`) into them at their first launch."""
    key = (wx, wy, mode, op.cb.dtype)
    prm = op.kernel_params.get(key)
    if prm is not None:
        return prm
    D = len(op.offsets)
    if D > MAX_DIAGS:
        raise ValueError(f"coded-DIA kernel takes at most {MAX_DIAGS} diagonals, got {D}")
    plan = plan_coded_windows(
        tuple(int(o) for o in op.offsets), op.cb.element_size(), mode, op.codes.shape[1], op.cb.shape[2],
        n_cls=len(op.cls_pattern or ()),
    )
    prm = _Params()
    prm.P, prm.D, prm.kmax = op.cb.shape[0], D, op.cb.shape[2]
    prm.n_streams, prm.code_len = op.codes.shape[1], op.codes.shape[2]
    prm.wx, prm.wy, prm.o0 = wx, wy, op.o0
    for d in range(D):
        prm.off[d], prm.kk[d], prm.code_row[d] = op.offsets[d], op.kk[d], op.code_row[d]
        prm.diag_win[d] = plan.diag_window[d]
    prm.nd_spec = select_chain_instance(op) if mode == "plain" else 0
    prm.n_cls = 0
    if op.cls_pattern is not None:
        if len(op.cls_pattern) > MAX_CLASSES:
            raise ValueError(f"at most {MAX_CLASSES} row classes")
        prm.n_cls = len(op.cls_pattern)
        for k, pat in enumerate(op.cls_pattern):
            prm.cls_mask[k] = sum(1 << d for d in range(D) if pat[d])
    prm.stride, prm.T, prm.lead, prm.step_bufs = plan.stride, plan.tile, plan.lead, plan.step_bufs
    prm.ncol = -(-plan.stride // plan.tile)
    prm.n_buf, prm.n_new = len(plan.buf_at), len(plan.new_src)
    prm.zero_win, prm.ccf_at = plan.zero_window, plan.ccf_at
    prm.sidx_at = plan.sidx_at
    prm.pp_shift, prm.stage_at, prm.stage_bytes = plan.pp_shift, plan.stage_at, plan.stage_bytes
    prm.code_at, prm.code_stride = plan.code_at, plan.code_stride
    prm.ax_pp_at, prm.ax_xa_at = plan.axpy_at
    prm.smem_bytes = plan.smem_bytes
    for c in range(len(plan.windows)):
        prm.win_src[c], prm.win_buf[c] = plan.window_src[c], plan.window_buf[c]
    for s in range(len(plan.new_src)):
        prm.new_src[s], prm.new_buf[s], prm.new_len[s] = plan.new_src[s], plan.new_buf[s], plan.new_len[s]
    for b, at in enumerate(plan.buf_at):
        prm.buf_at[b] = at
    op.kernel_params[key] = prm
    return prm


def _check_cuda(op: CodedOperator, width: int, *vecs: torch.Tensor) -> str:
    dev = vecs[0].device
    dt = vecs[0].dtype
    if dt not in _DT:
        raise TypeError(f"coded-DIA kernel takes float32 or float64, got {dt}")
    for t in (op.cb, *vecs):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError("coded-DIA kernel: operands must be contiguous, on one device, of one dtype")
    if (
        op.no.device != dev or op.no.dtype != torch.int32
        or op.codes.device != dev or op.codes.dtype != torch.uint8
        or not op.codes.is_contiguous()
    ):
        raise ValueError("coded-DIA kernel: no must be int32 and codes uint8, contiguous, on the operand's device")
    P = op.cb.shape[0]
    for t in vecs:
        if t.dim() != 2 or t.shape[0] != P or t.shape[1] < op.o0 + op.n:
            raise ValueError(f"coded-DIA kernel: frame {tuple(t.shape)} does not hold {P} parts of {op.n} rows")
    if width < op.o0 + op.n:
        raise ValueError(f"coded-DIA kernel: result width {width} does not hold the owned band at {op.o0} of {op.n} rows")
    return _DT[dt]


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def dia_coded_spmv(op: CodedOperator, x: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
    """y = A_oo x on the stacked frame: x (P, Wx) -> y (P, width) with the
    owned band computed and every other slot 0 (width defaults to Wx)."""
    width = x.shape[1] if width is None else int(width)
    if x.device.type == "cpu":
        return dia_coded_spmv_plain(op, x, width)
    if x.device.type != "cuda":
        raise RuntimeError(f"dia_coded_spmv: no kernel for device {x.device}")
    dt = _check_cuda(op, width, x)
    y = torch.empty((x.shape[0], width), dtype=x.dtype, device=x.device)
    prm = _params(op, x.shape[1], width, "plain")
    fn = getattr(build_kernels()["dia_coded"], f"pa_dia_coded_{dt}")
    rc = fn(
        ctypes.byref(prm), op.cb.data_ptr(), op.no.data_ptr(), op.codes.data_ptr(),
        x.data_ptr(), y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "dia_coded_spmv")
    LAUNCHES["dia_coded_spmv"] += 1
    return y


def dia_null_launch(op: Optional[CodedOperator] = None, x: Optional[torch.Tensor] = None,
                    width: Optional[int] = None) -> None:
    """An empty kernel on the current CUDA device, the launch floor the
    coded kernel is timed against; it counts in no `LAUNCHES` entry. With
    op, x and width it is launched as `dia_coded_spmv(op, x, width)`
    launches the coded kernel (grid, threads, shared memory, parameter
    block), which must have run on that frame first; else one warp, no
    parameters."""
    lib = build_kernels()["dia_coded"]
    if op is None:
        rc = lib.pa_dia_null(None, torch.cuda.current_stream().cuda_stream)
    else:
        width = x.shape[1] if width is None else int(width)
        prm = _params(op, x.shape[1], width, "plain")
        if prm.grid_x == 0:
            raise RuntimeError("dia_null_launch: launch dia_coded_spmv on this frame first (it sets the grid)")
        rc = lib.pa_dia_null(ctypes.byref(prm), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "dia_null_launch")


def dia_coded_spmv_pfold(
    op: CodedOperator, r: torch.Tensor, pprev: torch.Tensor, beta: torch.Tensor,
    width: Optional[int] = None, minv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CG direction fold riding the SpMV pass: p = r + beta*pprev (with
    ``minv``, Jacobi PCG's p = minv*r + beta*pprev; minv shares r's frame)
    on the owned band (0 elsewhere) and y = A_oo p. Returns (y, p); p has
    r's frame, y has `width` slots (default r's width). Launches count in
    ``dia_coded_spmv_pfold``, or ``dia_coded_spmv_pfold_minv`` with minv."""
    width = r.shape[1] if width is None else int(width)
    if r.device.type == "cpu":
        return dia_coded_spmv_pfold_plain(op, r, pprev, beta, width, minv)
    if r.device.type != "cuda":
        raise RuntimeError(f"dia_coded_spmv_pfold: no kernel for device {r.device}")
    beta = beta.reshape(1)
    vecs = (r, pprev) if minv is None else (r, pprev, minv)
    dt = _check_cuda(op, width, *vecs)
    if beta.device != r.device or beta.dtype != r.dtype:
        raise ValueError("dia_coded_spmv_pfold: beta must be a scalar tensor on r's device, of r's dtype")
    if any(t.shape != r.shape for t in vecs):
        raise ValueError("dia_coded_spmv_pfold: pprev (and minv) and r must share one frame")
    y = torch.empty((r.shape[0], width), dtype=r.dtype, device=r.device)
    p = torch.empty_like(r)
    prm = _params(op, r.shape[1], width, "pfold" if minv is None else "pfold_minv")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    lib = build_kernels()["dia_coded"]
    args = (ctypes.byref(prm), op.cb.data_ptr(), op.no.data_ptr(), op.codes.data_ptr(),
            r.data_ptr(), pprev.data_ptr(), beta.data_ptr(), y.data_ptr(), p.data_ptr())
    if minv is None:
        rc = getattr(lib, f"pa_dia_coded_pfold_{dt}")(*args, stream)
    else:
        rc = getattr(lib, f"pa_dia_coded_pfold_minv_{dt}")(*args, minv.data_ptr(), stream)
    key = "dia_coded_spmv_pfold" if minv is None else "dia_coded_spmv_pfold_minv"
    _raise_on(rc, key)
    LAUNCHES[key] += 1
    return y, p


def dia_coded_spmv_axpy(
    op: CodedOperator, x: torch.Tensor, xacc: torch.Tensor, pprev: torch.Tensor,
    alpha: torch.Tensor, width: Optional[int] = None, live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The lagged solution update of pipelined CG riding the SpMV pass:
    y = A_oo x, and in the same pass ``xacc += alpha*pprev`` on each
    part's owned band, in place (every other slot of xacc untouched).
    xacc and pprev share x's frame; y has `width` slots (default x's
    width). ``live``, an int32 scalar tensor on the device, guards the
    update: where it reads 0 the kernel leaves xacc unwritten (y is
    computed all the same). Returns y."""
    width = x.shape[1] if width is None else int(width)
    if x.device.type == "cpu":
        return dia_coded_spmv_axpy_plain(op, x, xacc, pprev, alpha, width, live)
    if x.device.type != "cuda":
        raise RuntimeError(f"dia_coded_spmv_axpy: no kernel for device {x.device}")
    alpha = alpha.reshape(1)
    dt = _check_cuda(op, width, x, xacc, pprev)
    if alpha.device != x.device or alpha.dtype != x.dtype:
        raise ValueError("dia_coded_spmv_axpy: alpha must be a scalar tensor on x's device, of x's dtype")
    if xacc.shape != x.shape or pprev.shape != x.shape:
        raise ValueError("dia_coded_spmv_axpy: xacc, pprev and x must share one frame")
    if live is not None and (live.numel() != 1 or live.device != x.device or live.dtype != torch.int32):
        raise ValueError("dia_coded_spmv_axpy: live must be an int32 scalar tensor on x's device")
    ptrs = {x.data_ptr(), pprev.data_ptr()}
    if xacc.data_ptr() in ptrs:
        raise ValueError("dia_coded_spmv_axpy: xacc is updated in place and must not alias x or pprev")
    y = torch.empty((x.shape[0], width), dtype=x.dtype, device=x.device)
    prm = _params(op, x.shape[1], width, "axpy")
    fn = getattr(build_kernels()["dia_coded"], f"pa_dia_coded_axpy_{dt}")
    rc = fn(
        ctypes.byref(prm), op.cb.data_ptr(), op.no.data_ptr(), op.codes.data_ptr(),
        x.data_ptr(), pprev.data_ptr(), alpha.data_ptr(), y.data_ptr(), xacc.data_ptr(),
        0 if live is None else live.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "dia_coded_spmv_axpy")
    LAUNCHES["dia_coded_spmv_axpy"] += 1
    return y


def stream_launch(vals: torch.Tensor, form: Optional[str] = None) -> Tuple[str, bool, int]:
    """How `dia_stream_spmv` launches on vals (P, D, n): its form (``form``,
    or `stream_form` of the shape on vals' device), whether the stream form
    takes 128-bit value loads (n a multiple of the rows a thread and vals
    16-byte aligned) and the unrolled sum it takes (D if D is one of
    `STREAM_SHAPES`, else 0, the run-time loop)."""
    P, D, n = vals.shape
    item = vals.element_size()
    if form is None:
        form = stream_form(P, n, item, sm_count(vals.device))
    if form not in STREAM_FORMS:
        raise ValueError(f"streaming-DIA kernel: no form {form!r} (forms: {', '.join(STREAM_FORMS)})")
    vec = form == STREAM and n % stream_rows_per_thread(item) == 0 and vals.data_ptr() % 16 == 0
    return form, vec, D if D in STREAM_SHAPES else 0


def dia_stream_spmv(
    vals: torch.Tensor, x: torch.Tensor, offsets: Tuple[int, ...], no: torch.Tensor,
    o0: int, width: Optional[int] = None, form: Optional[str] = None,
) -> torch.Tensor:
    """y = A_oo x for a streaming-DIA operand: vals (P, D, N) dense
    per-diagonal values in ascending-offset order, no (P,) int32 owned
    counts, x (P, Wx) -> y (P, width) with the owned band computed and
    every other slot 0 (width defaults to Wx). ``form`` forces the
    kernel's form (`STREAM_FORMS`; default `stream_form` of the shape);
    every form gives the same values."""
    width = x.shape[1] if width is None else int(width)
    if x.device.type == "cpu":
        return dia_stream_spmv_plain(vals, x, offsets, no, o0, width)
    if x.device.type != "cuda":
        raise RuntimeError(f"dia_stream_spmv: no kernel for device {x.device}")
    if x.dtype not in _DT:
        raise TypeError(f"streaming-DIA kernel takes float32 or float64, got {x.dtype}")
    P, D, n = vals.shape
    if D != len(offsets) or not 1 <= D <= MAX_DIAGS:
        raise ValueError(f"streaming-DIA kernel: {D} value rows for {len(offsets)} offsets (1 to {MAX_DIAGS})")
    for t in (vals, x):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("streaming-DIA kernel: vals and x must be contiguous, on one device, of one dtype")
    if no.device != x.device or no.dtype != torch.int32 or tuple(no.shape) != (P,):
        raise ValueError("streaming-DIA kernel: no must be (P,) int32 on the operand's device")
    if x.dim() != 2 or x.shape[0] != P or x.shape[1] < o0 + n or width < o0 + n:
        raise ValueError(f"streaming-DIA kernel: frame {tuple(x.shape)} does not hold {P} parts of {n} rows")
    form, vec, nd = stream_launch(vals, form)
    prm = _StreamParams()
    prm.P, prm.D, prm.n = P, D, n
    prm.wx, prm.wy, prm.o0 = x.shape[1], width, o0
    for d in range(D):
        prm.off[d] = int(offsets[d])
    prm.form, prm.vec, prm.nd = STREAM_FORMS.index(form), int(vec), nd
    y = torch.empty((P, width), dtype=x.dtype, device=x.device)
    fn = getattr(build_kernels()["dia_stream"], f"pa_dia_stream_{_DT[x.dtype]}")
    rc = fn(
        ctypes.byref(prm), vals.data_ptr(), no.data_ptr(), x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "dia_stream_spmv")
    LAUNCHES["dia_stream_spmv"] += 1
    return y


# ---------------------------------------------------------------------------
# the block (multi-RHS) products
# ---------------------------------------------------------------------------


def _check_slabs(name: str, P: int, rows: int, *slabs: torch.Tensor) -> int:
    """Slabs (P, W >= rows, K), contiguous, on one device, of one float
    dtype and one K. Returns K."""
    x = slabs[0]
    if x.dtype not in _DT:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {x.dtype}")
    for t in slabs:
        if (t.dim() != 3 or t.device != x.device or t.dtype != x.dtype or not t.is_contiguous()
                or t.shape[0] != P or t.shape[1] < rows or t.shape[2] != x.shape[2]):
            raise ValueError(f"{name}: slabs must be contiguous (P={P}, W >= {rows}, K) tensors on one device, "
                             f"of one dtype and K; got {tuple(t.shape)}")
    if x.shape[2] < 1:
        raise ValueError(f"{name}: a slab needs at least one column")
    return int(x.shape[2])


def block_columns(K: int) -> int:
    """Columns a thread (or a CTA of the block sweep) of the block kernels
    takes: the smallest power of two at least min(K, 8)."""
    kb = 1
    while kb < min(K, 8):
        kb *= 2
    return kb


def block_vec(K: int, *tensors: torch.Tensor) -> bool:
    """Whether the block kernels move a row's columns as 16-byte vectors:
    K and the column group (`block_columns`) multiples of the vector, and
    every slab 16-byte aligned."""
    nv = 16 // tensors[0].element_size()
    return K % nv == 0 and block_columns(K) % nv == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def staged_vec(K: int, *tensors: torch.Tensor) -> bool:
    """Whether the staged form moves a row's column group as vectors of
    min(16, KB * itemsize) bytes (KB = `block_columns`): wider than one
    value, dividing a row's K values, every slab aligned to it."""
    item = tensors[0].element_size()
    kb = block_columns(K)
    lw = min(16, kb * item)
    return kb > 1 and lw > item and (K * item) % lw == 0 and all(t.data_ptr() % lw == 0 for t in tensors)


def _spmm_params(op: CodedOperator, wx: int, wy: int, K: int, mode: str, dt, form: str, vec: bool) -> _SpmmParams:
    """The coded SpMM's parameters, built once per frame widths, K, mode,
    dtype, form and vector width of an operator (the staged form's launcher
    writes its grid into them at their first launch)."""
    key = ("spmm", wx, wy, K, mode, dt, form, vec)
    prm = op.kernel_params.get(key)
    if prm is not None:
        return prm
    prm = _SpmmParams()
    D = len(op.offsets)
    prm.P, prm.D, prm.kmax = op.cb.shape[0], D, op.cb.shape[2]
    prm.n_streams, prm.code_len = op.codes.shape[1], op.codes.shape[2]
    prm.wx, prm.wy, prm.o0, prm.K = wx, wy, op.o0, K
    prm.mode = ("plain", "pfold", "pfold_minv").index(mode)
    for d in range(D):
        prm.off[d], prm.kk[d], prm.code_row[d] = op.offsets[d], op.kk[d], op.code_row[d]
    prm.KB, prm.vec, prm.form = block_columns(K), int(vec), SPMM_FORMS.index(form)
    if form == SPMM_STAGED:
        plan = plan_coded_block_windows(tuple(int(o) for o in op.offsets), op.cb.element_size(), K, mode,
                                        op.codes.shape[1])
        coded = [op.code_row[d] for d in range(D) if op.kk[d] > 1]
        prm.one_code, prm.code0 = int(len(set(coded)) <= 1), coded[0] if coded else 0
        prm.nd_spec = spmm_nd(op, K, mode)
        prm.T, prm.G, prm.stride, prm.lead, prm.step_bufs = plan.tile, plan.groups, plan.stride, plan.lead, plan.step_bufs
        prm.ncol = -(-plan.stride // plan.tile)
        prm.n_buf, prm.n_new, prm.zero_win = len(plan.buf_at), len(plan.new_src), plan.zero_window
        prm.ccf_at, prm.beta_at, prm.sidx_at = plan.ccf_at, plan.beta_at, plan.sidx_at
        prm.cidx_at, prm.csh_at, prm.pp_shift = plan.cidx_at, plan.csh_at, plan.pp_shift
        prm.mv_at, prm.mv_bytes = plan.mv_at, plan.mv_bytes
        prm.stage_at, prm.stage_bytes, prm.code_stride = plan.stage_at, plan.stage_bytes, plan.code_stride
        prm.smem_bytes = plan.smem_bytes
        for c in range(len(plan.windows)):
            prm.win_src[c], prm.win_buf[c] = plan.window_src[c], plan.window_buf[c]
        for t in range(len(plan.new_src)):
            prm.new_src[t], prm.new_buf[t], prm.new_len[t] = plan.new_src[t], plan.new_buf[t], plan.new_len[t]
        for b, at in enumerate(plan.buf_at):
            prm.buf_at[b] = at
        for d in range(D):
            prm.diag_win[d] = plan.diag_window[d]
    op.kernel_params[key] = prm
    return prm


def _coded_block(name, op, width, x, pprev=None, beta=None, minv=None, form=None):
    """Launch the coded SpMM (`csrc/dia_coded_block.cu`): plain mode with
    pprev None, else the pfold form; in ``form`` (`SPMM_FORMS`; default
    `spmm_form` of the shapes). Returns y, or (y, p)."""
    P = op.cb.shape[0]
    slabs = (x,) if pprev is None else (x, pprev)
    K = _check_slabs(name, P, op.o0 + op.n, *slabs)
    if pprev is not None and pprev.shape != x.shape:
        raise ValueError(f"{name}: pprev and r must share one slab")
    if width < op.o0 + op.n:
        raise ValueError(f"{name}: result width {width} does not hold the owned band at {op.o0} of {op.n} rows")
    dev, dt = x.device, x.dtype
    if op.cb.device != dev or op.cb.dtype != dt or not op.cb.is_contiguous():
        raise ValueError(f"{name}: the codebook must be contiguous, on the slabs' device, of their dtype")
    if (op.no.device != dev or op.no.dtype != torch.int32 or op.codes.device != dev or op.codes.dtype != torch.uint8
            or not op.codes.is_contiguous()):
        raise ValueError(f"{name}: no must be int32 and codes uint8 and contiguous, on the slabs' device")
    if beta is not None and (beta.device != dev or beta.dtype != dt or tuple(beta.shape) != (K,)
                             or not beta.is_contiguous()):
        raise ValueError(f"{name}: beta must be a contiguous ({K},) tensor on the slabs' device, of their dtype")
    if minv is not None and (minv.device != dev or minv.dtype != dt or not minv.is_contiguous()
                             or tuple(minv.shape) != tuple(x.shape[:2])):
        raise ValueError(f"{name}: minv must be a contiguous {tuple(x.shape[:2])} frame on the slabs' device")
    mode = "plain" if pprev is None else "pfold" if minv is None else "pfold_minv"
    offsets = tuple(int(o) for o in op.offsets)
    if form is None:
        form = spmm_form(offsets, x.element_size(), K, mode, op.codes.shape[1])
    elif form not in SPMM_FORMS:
        raise ValueError(f"{name}: no form {form!r} (forms: {', '.join(SPMM_FORMS)})")
    else:
        _check_block_plan_args(offsets, x.element_size(), K, mode)
    y = torch.empty((P, width, K), dtype=dt, device=dev)
    p = None if pprev is None else torch.empty_like(x)
    slabs = tuple(t for t in (x, pprev, y, p) if t is not None)
    vec = staged_vec(K, *slabs) if form == SPMM_STAGED else block_vec(K, *slabs)
    prm = _spmm_params(op, x.shape[1], width, K, mode, dt, form, vec)
    fn = getattr(build_kernels()["dia_coded_block"], f"pa_dia_coded_spmm_{_DT[dt]}")
    rc = fn(
        ctypes.byref(prm), op.cb.data_ptr(), op.no.data_ptr(), op.codes.data_ptr(), x.data_ptr(),
        0 if pprev is None else pprev.data_ptr(), 0 if beta is None else beta.data_ptr(),
        0 if minv is None else minv.data_ptr(), y.data_ptr(), 0 if p is None else p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, name)
    LAUNCHES["dia_coded_spmm"] += 1
    return y if p is None else (y, p)


def dia_coded_spmm(op: CodedOperator, x: torch.Tensor, width: Optional[int] = None,
                   form: Optional[str] = None) -> torch.Tensor:
    """Y = A_oo X over K columns: x (P, Wx, K) -> y (P, width, K), the owned
    band computed and every other slot 0 (width defaults to Wx). The
    codebook and codes are read once for the K columns. ``form`` forces
    the kernel's form (`SPMM_FORMS`; default `spmm_form` of the shapes);
    every form gives the same values."""
    width = x.shape[1] if width is None else int(width)
    if x.device.type == "cpu":
        return dia_coded_spmm_plain(op, x, width)
    if x.device.type != "cuda":
        raise RuntimeError(f"dia_coded_spmm: no kernel for device {x.device}")
    return _coded_block("dia_coded_spmm", op, width, x, form=form)


def dia_coded_spmm_pfold(
    op: CodedOperator, r: torch.Tensor, pprev: torch.Tensor, beta: torch.Tensor,
    width: Optional[int] = None, minv: Optional[torch.Tensor] = None, form: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block CG direction fold riding the SpMM pass: p = r +
    beta[k]*pprev per column k (with a shared ``minv`` (P, Wx): p = minv*r
    + beta[k]*pprev) on the owned band, 0 elsewhere, and Y = A_oo p.
    ``form`` as for `dia_coded_spmm`. Returns (y, p); launches count in
    ``dia_coded_spmm``."""
    width = r.shape[1] if width is None else int(width)
    if r.device.type == "cpu":
        return dia_coded_spmm_pfold_plain(op, r, pprev, beta, width, minv)
    if r.device.type != "cuda":
        raise RuntimeError(f"dia_coded_spmm_pfold: no kernel for device {r.device}")
    return _coded_block("dia_coded_spmm_pfold", op, width, r, pprev, beta, minv, form=form)


def dia_stream_spmm(
    vals: torch.Tensor, x: torch.Tensor, offsets: Tuple[int, ...], no: torch.Tensor,
    o0: int, width: Optional[int] = None,
) -> torch.Tensor:
    """Y = A_oo X over K columns for a streaming-DIA operand: vals (P, D,
    N), x (P, Wx, K) -> y (P, width, K), the owned band computed and every
    other slot 0. Each diagonal's values are read once for the K columns."""
    width = x.shape[1] if width is None else int(width)
    if x.device.type == "cpu":
        return dia_stream_spmm_plain(vals, x, offsets, no, o0, width)
    if x.device.type != "cuda":
        raise RuntimeError(f"dia_stream_spmm: no kernel for device {x.device}")
    P, D, n = vals.shape
    K = _check_slabs("dia_stream_spmm", P, o0 + n, x)
    if D != len(offsets) or not 1 <= D <= MAX_DIAGS:
        raise ValueError(f"dia_stream_spmm: {D} value rows for {len(offsets)} offsets (1 to {MAX_DIAGS})")
    if vals.device != x.device or vals.dtype != x.dtype or not vals.is_contiguous():
        raise ValueError("dia_stream_spmm: vals must be contiguous, on x's device, of x's dtype")
    if no.device != x.device or no.dtype != torch.int32 or tuple(no.shape) != (P,):
        raise ValueError("dia_stream_spmm: no must be (P,) int32 on x's device")
    if width < o0 + n:
        raise ValueError(f"dia_stream_spmm: result width {width} does not hold the band at {o0} of {n} rows")
    prm = _StreamSpmmParams()
    prm.P, prm.D, prm.n = P, D, n
    prm.wx, prm.wy, prm.o0, prm.K = x.shape[1], width, o0, K
    for d in range(D):
        prm.off[d] = int(offsets[d])
    y = torch.empty((P, width, K), dtype=x.dtype, device=x.device)
    prm.KB, prm.vec = block_columns(K), int(block_vec(K, x, y))
    fn = getattr(build_kernels()["dia_stream_block"], f"pa_dia_stream_spmm_{_DT[x.dtype]}")
    rc = fn(ctypes.byref(prm), vals.data_ptr(), no.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "dia_stream_spmm")
    LAUNCHES["dia_stream_spmm"] += 1
    return y
