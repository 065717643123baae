"""The CG update sweep: the CUDA kernel `cg_sweep` (`csrc/cg_sweep.cu`) and
its plain PyTorch version, in three forms: the solo sweep, its Jacobi
(``precond``) form and its block form over K right-hand sides.

One pass over the owned band ``[o0, o0 + n)`` of each part of stacked
``(P, W)`` frames: ``x += alpha*p``, ``r += (-alpha)*q`` and the per-part
partials of ``r.r``, then the partials folded into ``rs``. It stands for
the XLA fusion of the JAX package's fused CG update (`step_fused`,
`partitionedarrays_jl_tpu/parallel/tpu.py:4090-4101`), which no Pallas
kernel implements, and serves every loop of `parallel/gpu_loop.py`: the
fused and standard CG bodies, GMG-PCG's level-0 update, and (``x`` and
``p`` left out) the pipelined body, whose x update rides the SpMV kernel.

The ``precond`` form (``minv``, Jacobi PCG) also takes the partials of
``r.z`` with ``z = minv*r`` (rounded, never stored) beside those of
``r.r``, each in the solo order, and returns both (``(rz, rs)``): it stands
for `odot2(ro, zo, ro, ro)` of the fused PCG body (tpu.py:4094-4096), whose
two reductions share one gather. Its launches count in
``dia.LAUNCHES["cg_sweep_precond"]``.

The block form (`cg_sweep_block`) takes ``(P, W, K)`` slabs (K columns
contiguous), a per-column ``alpha`` (K,) and a per-column int32 flag ``act``
(K,) in place of ``live``: a column whose flag reads 0 writes nothing, not
x, not r, not its partials. Column k is swept and summed as the solo sweep
sweeps and sums a frame, so a block column follows its solo trajectory bit
for bit. It returns rs (K,), or (rz, rs) with ``minv``; launches count in
``dia.LAUNCHES["cg_sweep_block"]``.

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
written, 24 B a row, 169.9 MB, 50.7 us at 3.35 TB/s; with minv 28 B a row,
198.2 MB, 59.2 us; the block form at K = 8, 24 B a row and column, 1.36 GB,
406 us.

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


def sweep_partials(v: torch.Tensor, n: int, series: Optional[int] = None) -> torch.Tensor:
    """A zeroed partials buffer for sweeps over n rows of frames like v (its
    parts, dtype and device): ``(P, chunks(n))``, or with ``series``
    ``(P, series, chunks(n))``: 2 for the precond form, K (2K with minv)
    for the block form."""
    shape = (v.shape[0], chunks(n)) if series is None else (v.shape[0], series, chunks(n))
    return v.new_zeros(shape)


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """The kernel's halving tree over the last axis (a power of two): t + h
    into t for h = len/2 .. 1."""
    h = acc.shape[-1] // 2
    while h >= 1:
        acc = acc[..., :h] + acc[..., h : 2 * h]
        h //= 2
    return acc[..., 0]


def _partials(rb: torch.Tensor, zb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chunk partials of sum(rb^2) (of sum(rb*zb) with zb) per row of
    rb (a part, or a part's column), (rows, chunks), in the kernel's
    order."""
    P, n = rb.shape
    G = chunks(n)
    sq = torch.nn.functional.pad(rb * (rb if zb is None else zb), (0, G * CHUNK - n)).view(P, G, ITEMS, THREADS)
    acc = rb.new_zeros((P, G, THREADS))
    for k in range(ITEMS):
        acc = acc + sq[:, :, k, :]
    return _tree(acc)


def fold_plain(part: torch.Tensor) -> torch.Tensor:
    """The fold of the partials into one sum, in the kernel's order: each
    part's partials over FOLD_THREADS threads and a halving tree, then the
    parts left to right. Returns a 0-d tensor; partials ``(P, S, G)`` of S
    series fold series by series into an (S,) tensor."""
    if part.dim() == 3:
        return torch.stack([fold_plain(part[:, s]) for s in range(part.shape[1])])
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
                   p: Optional[torch.Tensor] = None, minv: Optional[torch.Tensor] = None):
    """Plain version of `cg_sweep`: the eager update of the fused CG body
    (`x[:, band] + alpha * p[:, band]`, `r[:, band] + (-alpha) * q[:,
    band]`) and the partials of the new r, each written only where
    ``live != 0`` (a select, so a frozen sweep writes back the same bits),
    then `fold_plain`. Returns rs (0-d); with ``minv`` the partials of
    ``r.z`` (z = minv*r) too, and (rz, rs)."""
    band = slice(o0, o0 + n)
    on = live.reshape(()) != 0
    rb = r[:, band]
    rn = rb + (-alpha) * q[:, band]
    rb.copy_(torch.where(on, rn, rb))
    if x is not None:
        xb = x[:, band]
        xb.copy_(torch.where(on, xb + alpha * p[:, band], xb))
    if minv is None:
        part.copy_(torch.where(on, _partials(rn), part))
        return fold_plain(part)
    new = torch.stack([_partials(rn, minv[:, band] * rn), _partials(rn)], dim=1)
    part.copy_(torch.where(on, new, part))
    rz, rs = fold_plain(part).unbind()
    return rz, rs


def cg_sweep_block_plain(r: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, act: torch.Tensor,
                         part: torch.Tensor, o0: int, n: int, x: torch.Tensor, p: torch.Tensor,
                         minv: Optional[torch.Tensor] = None):
    """Plain version of `cg_sweep_block`: column k of the slabs updated as
    `cg_sweep_plain` updates a frame, with alpha[k], where act[k] != 0 (a
    select elsewhere), its partials into series k (with ``minv``: r.z into
    2k, r.r into 2k + 1), then `fold_plain` of every series. Returns rs
    (K,), or (rz, rs) with minv."""
    band = slice(o0, o0 + n)
    on = act.reshape(-1) != 0
    K = on.shape[0]
    rb = r[:, band]
    rn = rb + (-alpha) * q[:, band]
    rb.copy_(torch.where(on, rn, rb))
    xb = x[:, band]
    xb.copy_(torch.where(on, xb + alpha * p[:, band], xb))
    P = r.shape[0]
    cols = rn.permute(0, 2, 1).reshape(P * K, n)  # part p's column k at row p*K + k
    new = _partials(cols).view(P, K, -1)
    if minv is not None:
        z = (minv[:, band, None] * rn).permute(0, 2, 1).reshape(P * K, n)
        new = torch.stack([_partials(cols, z).view(P, K, -1), new], dim=2).view(P, 2 * K, -1)
        on = on.repeat_interleave(2)
    part.copy_(torch.where(on[None, :, None], new, part))
    out = fold_plain(part)
    return (out[0::2], out[1::2]) if minv is not None else out


def _check(r, q, alpha, live, part, o0, n, x, p, minv=None, K=0) -> str:
    """The operands of a sweep: frames (P, W) (block form, K > 0: slabs
    (P, W, K) and a (P, W) minv), the partials (P[, S], G), alpha and the
    flag scalars (block form: (K,) each)."""
    name = "cg_sweep_block" if K else "cg_sweep"
    dt = r.dtype
    if dt not in dia._DT:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {dt}")
    if (x is None) != (p is None):
        raise ValueError(f"{name}: x and p go together (mode 0) or are both left out (mode 1)")
    if minv is not None and x is None:
        raise ValueError(f"{name}: the precond form updates x: pass x and p with minv")
    vecs = [t for t in (r, q, x, p) if t is not None]
    for t in vecs:
        if t.device != r.device or t.dtype != dt or not t.is_contiguous() or t.dim() != (3 if K else 2):
            raise ValueError(f"{name}: frames must be contiguous {3 if K else 2}-D tensors on one device, of one dtype")
        if K and t.shape[2] != K:
            raise ValueError(f"{name}: slab {tuple(t.shape)} does not hold {K} columns")
    P = r.shape[0]
    for t in vecs:
        if t.shape[0] != P or t.shape[1] < o0 + n:
            raise ValueError(f"{name}: frame {tuple(t.shape)} does not hold {P} parts of a band at {o0} of {n}")
    for t in (x, p):
        if t is not None and t.shape != r.shape:
            raise ValueError(f"{name}: x, p and r must share one frame")
    if minv is not None and (minv.device != r.device or minv.dtype != dt or not minv.is_contiguous()
                             or tuple(minv.shape) != tuple(r.shape[:2])):
        raise ValueError(f"{name}: minv must be a contiguous {tuple(r.shape[:2])} frame on r's device, of r's dtype")
    if len({t.data_ptr() for t in vecs}) != len(vecs):
        raise ValueError(f"{name}: x, r, p and q must not alias")
    S = (2 * K if minv is not None else K) if K else (2 if minv is not None else 1)
    want = (P, chunks(n)) if minv is None and not K else (P, S, chunks(n))
    if part.device != r.device or part.dtype != dt or not part.is_contiguous() or tuple(part.shape) != want:
        raise ValueError(f"{name}: partials {tuple(part.shape)}, expected {want} (sweep_partials)")
    m = K if K else 1
    if alpha.numel() != m or alpha.device != r.device or alpha.dtype != dt or not alpha.is_contiguous():
        raise ValueError(f"{name}: alpha must be {m} value(s) on r's device, of r's dtype")
    if live.numel() != m or live.device != r.device or live.dtype != torch.int32 or not live.is_contiguous():
        raise ValueError(f"{name}: the flag must be {m} int32 value(s) on r's device")
    if n >= 2**31 * CHUNK:
        raise ValueError(f"{name}: a band of {n} rows needs more than 2^31 CTAs")
    return dia._DT[dt]


def cg_sweep(r: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, live: torch.Tensor,
             part: torch.Tensor, o0: int, n: int, x: Optional[torch.Tensor] = None,
             p: Optional[torch.Tensor] = None, minv: Optional[torch.Tensor] = None):
    """The CG update sweep over the band ``[o0, o0 + n)`` of every part:
    where ``live != 0``, ``x += alpha*p`` (with x and p) and ``r +=
    (-alpha)*q`` in place and the partials of r.r into ``part``
    (`sweep_partials`); then the fold of ``part``. r, x and p share one
    frame, q may have another. Returns rs, a new 0-d tensor. With ``minv``
    (r's frame; x and p given) the precond form: the partials of r.z and
    r.r (``sweep_partials(r, n, 2)``), returning (rz, rs)."""
    if r.device.type == "cpu":
        return cg_sweep_plain(r, q, alpha, live, part, o0, n, x, p, minv)
    if r.device.type != "cuda":
        raise RuntimeError(f"cg_sweep: no kernel for device {r.device}")
    dt = _check(r, q, alpha, live, part, o0, n, x, p, minv)
    S = 1 if minv is None else 2
    prm = dia._SweepParams(P=r.shape[0], G=part.shape[-1], n=n, o0=o0, wv=r.shape[1], wq=q.shape[1],
                           mode=2 if minv is not None else 0 if x is not None else 1, S=S, K=0, KB=0, vec=0)
    rs = torch.empty((S,) if S > 1 else (), dtype=r.dtype, device=r.device)
    fn = getattr(dia.build_kernels()["cg_sweep"], f"pa_cg_sweep_{dt}")
    rc = fn(
        ctypes.byref(prm), 0 if x is None else x.data_ptr(), r.data_ptr(), 0 if p is None else p.data_ptr(),
        q.data_ptr(), alpha.data_ptr(), live.data_ptr(), part.data_ptr(), rs.data_ptr(),
        0 if minv is None else minv.data_ptr(), torch.cuda.current_stream(r.device).cuda_stream,
    )
    key = "cg_sweep" if minv is None else "cg_sweep_precond"
    dia._raise_on(rc, key)
    dia.LAUNCHES[key] += 1
    if minv is None:
        return rs
    rz, rs = rs.unbind()
    return rz, rs


def cg_sweep_block(r: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, act: torch.Tensor,
                   part: torch.Tensor, o0: int, n: int, x: torch.Tensor, p: torch.Tensor,
                   minv: Optional[torch.Tensor] = None):
    """The block CG update sweep over (P, W, K) slabs: column k updated as
    `cg_sweep` updates a frame, with alpha[k], where act[k] != 0 (int32
    (K,)), and nothing of a column written where it reads 0; the partials
    into ``part`` (``sweep_partials(r, n, K)``, or ``2 * K`` series with
    ``minv``), then the fold of every series. Returns rs (K,), or (rz, rs)
    with minv (a (P, W) frame shared by the columns)."""
    if r.device.type == "cpu":
        return cg_sweep_block_plain(r, q, alpha, act, part, o0, n, x, p, minv)
    if r.device.type != "cuda":
        raise RuntimeError(f"cg_sweep_block: no kernel for device {r.device}")
    if r.dim() != 3:
        raise ValueError(f"cg_sweep_block: slabs are (P, W, K), got {tuple(r.shape)}")
    K = int(r.shape[2])
    dt = _check(r, q, alpha, act, part, o0, n, x, p, minv, K=K)
    S = 2 * K if minv is not None else K
    prm = dia._SweepParams(P=r.shape[0], G=part.shape[-1], n=n, o0=o0, wv=r.shape[1], wq=q.shape[1],
                           mode=0, S=S, K=K, KB=dia.block_columns(K), vec=int(dia.block_vec(K, r, q, x, p)))
    rs = torch.empty((S,), dtype=r.dtype, device=r.device)
    fn = getattr(dia.build_kernels()["cg_sweep"], f"pa_cg_sweep_block_{dt}")
    rc = fn(
        ctypes.byref(prm), x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(), alpha.data_ptr(),
        act.data_ptr(), part.data_ptr(), rs.data_ptr(), 0 if minv is None else minv.data_ptr(),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    dia._raise_on(rc, "cg_sweep_block")
    dia.LAUNCHES["cg_sweep_block"] += 1
    return (rs[0::2], rs[1::2]) if minv is not None else rs


def block_product_stride(P: int, n: int) -> int:
    """The column stride S of `block_products`' buffer: P*n rounded up to
    64 elements, so that every column's block starts on a 256-byte
    boundary, as a fresh tensor does."""
    return -(-(P * n) // 64) * 64


def block_products_plain(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """Plain version of `block_products`: one transposing `torch.mul` of
    the slabs' bands into the column blocks."""
    P, K = a.shape[0], a.shape[2]
    S = block_product_stride(P, n)
    buf = a.new_empty(K * S)
    torch.mul(a[:, o0 : o0 + n].permute(2, 0, 1), b[:, o0 : o0 + n].permute(2, 0, 1),
              out=buf.view(K, S)[:, : P * n].view(K, P, n))
    return buf


def block_products(a: torch.Tensor, b: torch.Tensor, o0: int, n: int) -> torch.Tensor:
    """The products of the block dot (`parallel/gpu.py:_block_pdot_factory`)
    over the band ``[o0, o0 + n)`` of (P, W, K) slabs a and b (widths may
    differ): a flat buffer whose column k holds ``a[p, o0 + i, k] *
    b[p, o0 + i, k]`` at ``k*S + p*n + i`` (S = `block_product_stride`),
    each column's (P, n) block laid out as the solo dot's product is. The
    kernel (`csrc/cg_sweep.cu:block_products_kernel`) reads each slab once;
    launches count in ``dia.LAUNCHES["block_products"]``."""
    if a.device.type == "cpu":
        return block_products_plain(a, b, o0, n)
    if a.device.type != "cuda":
        raise RuntimeError(f"block_products: no kernel for device {a.device}")
    if a.dtype not in dia._DT:
        raise TypeError(f"block_products: the kernel takes float32 or float64, got {a.dtype}")
    for t in (a, b):
        if (t.dim() != 3 or t.device != a.device or t.dtype != a.dtype or not t.is_contiguous()
                or t.shape[0] != a.shape[0] or t.shape[2] != a.shape[2] or t.shape[1] < o0 + n):
            raise ValueError("block_products: slabs must be contiguous (P, W >= o0 + n, K) tensors on one device, "
                             "of one dtype, P and K")
    P, K = a.shape[0], a.shape[2]
    S = block_product_stride(P, n)
    buf = a.new_empty(K * S)
    prm = dia._SweepParams(P=P, G=S, n=n, o0=o0, wv=a.shape[1], wq=b.shape[1], mode=0, S=0, K=K,
                           KB=dia.block_columns(K), vec=int(dia.block_vec(K, a, b)))
    fn = getattr(dia.build_kernels()["cg_sweep"], f"pa_block_products_{dia._DT[a.dtype]}")
    rc = fn(ctypes.byref(prm), a.data_ptr(), b.data_ptr(), buf.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    dia._raise_on(rc, "block_products")
    dia.LAUNCHES["block_products"] += 1
    return buf
