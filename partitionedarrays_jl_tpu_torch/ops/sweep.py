"""The CG update sweep: the CUDA kernel `cg_sweep` (`csrc/cg_sweep.cu`) and
its plain PyTorch version.

One pass over the owned band ``[o0, o0 + n)`` of each part of stacked
``(P, W)`` frames: ``x += alpha*p``, ``r += (-alpha)*q`` and the per-part
partials of ``r.r``, then the partials folded into ``rs``. It stands for
the XLA fusion of the JAX package's fused CG update (`step_fused`,
`partitionedarrays_jl_tpu/parallel/tpu.py:4090-4101`), which no Pallas
kernel implements, and serves every loop of `parallel/gpu_loop.py`: the
fused and standard CG bodies, GMG-PCG's level-0 update, and (``x`` and
``p`` left out) the pipelined body, whose x update rides the SpMV kernel.

The device flag ``live`` (an int32 scalar tensor) guards the writes: with
``live == 0`` nothing is written, not x, not r, not the partials, so a
frozen iteration of a device-resident loop leaves its state bit for bit.
The fold always runs: from unchanged partials it gives the previous sum
again. The caller owns the partials (`sweep_partials`).

Order: each product is rounded before its add, as the eager update
``x + alpha*p`` rounds. The partial of chunk g (``CHUNK`` elements) is
summed thread by thread (`THREADS` threads of `ITEMS` elements each, in
order) and then in a halving tree; the fold takes a part's partials the
same way over `FOLD_THREADS` threads, then adds the parts left to right,
as `parallel/gpu.py:_pdot_factory` does. The plain version repeats that
order, so the kernel and the plain version agree bit for bit.

Bound (memory): at 192^3 f32, one part, x, p, r and q read and x and r
written, 24 B a row, 169.9 MB, 50.7 us at 3.35 TB/s.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises. Launches count in ``dia.LAUNCHES["cg_sweep"]``; the
kernel is built with the others by `dia.build_kernels`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import dia

#: threads of a sweep CTA and elements a thread (PA_SWEEP_THREADS,
#: PA_SWEEP_ITEMS in csrc/cg_sweep.cu); a CTA takes one chunk of a part
THREADS = 256
ITEMS = 8
CHUNK = THREADS * ITEMS
#: threads of the fold (PA_FOLD_THREADS)
FOLD_THREADS = 256


def chunks(n: int) -> int:
    """Chunks (CTAs) a part's band of n elements takes."""
    return max(-(-n // CHUNK), 1)


def sweep_partials(v: torch.Tensor, n: int) -> torch.Tensor:
    """A zeroed partials buffer ``(P, chunks(n))`` for sweeps over n rows
    of frames like v (its parts, dtype and device)."""
    return v.new_zeros((v.shape[0], chunks(n)))


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """The kernel's halving tree over the last axis (a power of two): t + h
    into t for h = len/2 .. 1."""
    h = acc.shape[-1] // 2
    while h >= 1:
        acc = acc[..., :h] + acc[..., h : 2 * h]
        h //= 2
    return acc[..., 0]


def _partials(rb: torch.Tensor) -> torch.Tensor:
    """The chunk partials of sum(rb^2) per part, (P, chunks), in the
    kernel's order."""
    P, n = rb.shape
    G = chunks(n)
    sq = torch.nn.functional.pad(rb * rb, (0, G * CHUNK - n)).view(P, G, ITEMS, THREADS)
    acc = rb.new_zeros((P, G, THREADS))
    for k in range(ITEMS):
        acc = acc + sq[:, :, k, :]
    return _tree(acc)


def fold_plain(part: torch.Tensor) -> torch.Tensor:
    """The fold of the partials into one sum, in the kernel's order: each
    part's partials over FOLD_THREADS threads and a halving tree, then the
    parts left to right. Returns a 0-d tensor."""
    P, G = part.shape
    rows = -(-G // FOLD_THREADS)
    v = torch.nn.functional.pad(part, (0, rows * FOLD_THREADS - G)).view(P, rows, FOLD_THREADS)
    acc = part.new_zeros((P, FOLD_THREADS))
    for j in range(rows):
        acc = acc + v[:, j, :]
    s = _tree(acc)
    total = s[0]
    for i in range(1, P):
        total = total + s[i]
    return total


def cg_sweep_plain(r: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, live: torch.Tensor,
                   part: torch.Tensor, o0: int, n: int, x: Optional[torch.Tensor] = None,
                   p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `cg_sweep`: the eager update of the fused CG body
    (`x[:, band] + alpha * p[:, band]`, `r[:, band] + (-alpha) * q[:,
    band]`) and the partials of the new r, each written only where
    ``live != 0`` (a select, so a frozen sweep writes back the same bits),
    then `fold_plain`. Returns rs (0-d)."""
    band = slice(o0, o0 + n)
    on = live.reshape(()) != 0
    rb = r[:, band]
    rn = rb + (-alpha) * q[:, band]
    rb.copy_(torch.where(on, rn, rb))
    if x is not None:
        xb = x[:, band]
        xb.copy_(torch.where(on, xb + alpha * p[:, band], xb))
    part.copy_(torch.where(on, _partials(rn), part))
    return fold_plain(part)


def _check(r, q, alpha, live, part, o0, n, x, p) -> str:
    dt = r.dtype
    if dt not in dia._DT:
        raise TypeError(f"cg_sweep: the kernel takes float32 or float64, got {dt}")
    if (x is None) != (p is None):
        raise ValueError("cg_sweep: x and p go together (mode 0) or are both left out (mode 1)")
    vecs = [t for t in (r, q, x, p) if t is not None]
    for t in vecs + [part]:
        if t.device != r.device or t.dtype != dt or not t.is_contiguous() or t.dim() != 2:
            raise ValueError("cg_sweep: frames must be contiguous 2-D tensors on one device, of one dtype")
    P = r.shape[0]
    for t in vecs:
        if t.shape[0] != P or t.shape[1] < o0 + n:
            raise ValueError(f"cg_sweep: frame {tuple(t.shape)} does not hold {P} parts of a band at {o0} of {n}")
    for t in (x, p):
        if t is not None and t.shape != r.shape:
            raise ValueError("cg_sweep: x, p and r must share one frame")
    if len({t.data_ptr() for t in vecs}) != len(vecs):
        raise ValueError("cg_sweep: x, r, p and q must not alias")
    if tuple(part.shape) != (P, chunks(n)):
        raise ValueError(f"cg_sweep: partials {tuple(part.shape)}, expected {(P, chunks(n))} (sweep_partials)")
    if alpha.numel() != 1 or alpha.device != r.device or alpha.dtype != dt:
        raise ValueError("cg_sweep: alpha must be a scalar tensor on r's device, of r's dtype")
    if live.numel() != 1 or live.device != r.device or live.dtype != torch.int32:
        raise ValueError("cg_sweep: live must be an int32 scalar tensor on r's device")
    if n >= 2**31 * CHUNK:
        raise ValueError(f"cg_sweep: a band of {n} rows needs more than 2^31 CTAs")
    return dia._DT[dt]


def cg_sweep(r: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, live: torch.Tensor,
             part: torch.Tensor, o0: int, n: int, x: Optional[torch.Tensor] = None,
             p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CG update sweep over the band ``[o0, o0 + n)`` of every part:
    where ``live != 0``, ``x += alpha*p`` (with x and p) and ``r +=
    (-alpha)*q`` in place and the partials of r.r into ``part``
    (`sweep_partials`); then the fold of ``part``. r, x and p share one
    frame, q may have another. Returns rs, a new 0-d tensor."""
    if r.device.type == "cpu":
        return cg_sweep_plain(r, q, alpha, live, part, o0, n, x, p)
    if r.device.type != "cuda":
        raise RuntimeError(f"cg_sweep: no kernel for device {r.device}")
    dt = _check(r, q, alpha, live, part, o0, n, x, p)
    prm = dia._SweepParams(P=r.shape[0], G=part.shape[1], n=n, o0=o0, wv=r.shape[1], wq=q.shape[1],
                           mode=0 if x is not None else 1)
    rs = torch.empty((), dtype=r.dtype, device=r.device)
    fn = getattr(dia.build_kernels()["cg_sweep"], f"pa_cg_sweep_{dt}")
    rc = fn(
        ctypes.byref(prm), 0 if x is None else x.data_ptr(), r.data_ptr(), 0 if p is None else p.data_ptr(),
        q.data_ptr(), alpha.data_ptr(), live.data_ptr(), part.data_ptr(), rs.data_ptr(),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    dia._raise_on(rc, "cg_sweep")
    dia.LAUNCHES["cg_sweep"] += 1
    return rs
