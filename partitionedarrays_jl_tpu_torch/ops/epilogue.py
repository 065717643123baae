"""The V-cycle's smoother and residual epilogue: the CUDA kernel
`vcycle_epilogue` (`csrc/vcycle_epilogue.cu`) and its plain PyTorch
version.

One pass after a level's SpMV in `parallel/gpu_gmg.py:make_vcycle`, in
one of three `MODES`, over the band ``[o0, o0 + n)`` of every part of
stacked ``(P, W)`` frames (n the level's largest owned count):

* ``"init"``: the zero-start pre-smoothing sweep, a new frame with
  ``(omega*dinv)*b`` on the band and 0 elsewhere
  (`partitionedarrays_jl_tpu/parallel/tpu_gmg.py:596`);
* ``"residual"``: a new frame of any width with ``b - y`` on the band at
  any offset and 0 elsewhere: the level's column frame on the stencil
  route, S's column frame on the structured routes (`tpu_gmg.py:616`,
  `:686`);
* ``"smooth"``: ``x += (omega*dinv)*(b - y)`` on the band, in place
  (`tpu_gmg.py:603-604`, `:798-799`).

b, dinv and x share the level's column frame; y is the SpMV product, read
where the SpMV wrote it (the operator's row frame, band at ``yo0``). It
stands for the XLA fusions of those expressions, which no Pallas kernel
implements, as `ops/sweep.py` stands for the fused CG update.

Order: the eager expressions' own (``omega*dinv`` first, omega rounded to
the frames' type, then ``b - y``, their product, the add), each rounded
on its own; the plain version is those expressions, so kernel and plain
version agree bit for bit.

Bound (memory): at 192^3 f32, level 0, init and residual move 12 B a row
(84.9 MB, 25.3 us at 3.35 TB/s), smooth 20 B a row (141.6 MB, 42.3 us).

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises. Launches count in
``dia.LAUNCHES["vcycle_epilogue"]``; the kernel is built with the others by
`dia.build_kernels`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import dia

#: the kernel's modes, in the order of its `mode` parameter
MODES = ("init", "residual", "smooth")


def vcycle_epilogue_plain(mode: str, b: torch.Tensor, o0: int, n: int, *, dinv: Optional[torch.Tensor] = None,
                          y: Optional[torch.Tensor] = None, yo0: int = 0, x: Optional[torch.Tensor] = None,
                          omega: float = 0.0, width: Optional[int] = None,
                          out_o0: Optional[int] = None) -> torch.Tensor:
    """Plain version of `vcycle_epilogue`: the V-cycle's eager expressions
    on the band (parallel/gpu_gmg.py before the kernel)."""
    sl = slice(o0, o0 + n)
    if mode == "smooth":
        x[:, sl] = x[:, sl] + omega * dinv[:, sl] * (b[:, sl] - y[:, yo0 : yo0 + n])
        return x
    width = b.shape[1] if width is None else int(width)
    oo = o0 if out_o0 is None else int(out_o0)
    out = torch.zeros((b.shape[0], width), dtype=b.dtype, device=b.device)
    if mode == "init":
        out[:, oo : oo + n] = omega * dinv[:, sl] * b[:, sl]
    elif mode == "residual":
        out[:, oo : oo + n] = b[:, sl] - y[:, yo0 : yo0 + n]
    else:
        raise ValueError(f"vcycle_epilogue: no mode {mode!r} (modes: {', '.join(MODES)})")
    return out


def _check(mode, b, o0, n, dinv, y, yo0, x, width, oo):
    """The kernel's type name and the operands the mode reads, by name;
    raises on what the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"vcycle_epilogue: no mode {mode!r} (modes: {', '.join(MODES)})")
    dt = b.dtype
    if dt not in dia._DT:
        raise TypeError(f"vcycle_epilogue: the kernel takes float32 or float64, got {dt}")
    args = {"init": {"dinv": dinv}, "residual": {"y": y}, "smooth": {"dinv": dinv, "y": y, "x": x}}[mode]
    missing = [k for k, t in args.items() if t is None]
    if missing:
        raise ValueError(f"vcycle_epilogue: mode {mode} needs {', '.join(missing)}")
    vecs = [b, *args.values()]
    for t in vecs:
        if t.device != b.device or t.dtype != dt or not t.is_contiguous() or t.dim() != 2 or t.shape[0] != b.shape[0]:
            raise ValueError("vcycle_epilogue: frames must be contiguous 2-D tensors of one part count, on one device, "
                             "of one dtype")
    for t in (args.get("dinv"), args.get("x")):
        if t is not None and t.shape != b.shape:
            raise ValueError("vcycle_epilogue: b, dinv and x must share one frame")
    if o0 < 0 or n < 0 or o0 + n > b.shape[1]:
        raise ValueError(f"vcycle_epilogue: frame {tuple(b.shape)} does not hold a band at {o0} of {n}")
    if "y" in args and (yo0 < 0 or yo0 + n > y.shape[1]):
        raise ValueError(f"vcycle_epilogue: product {tuple(y.shape)} does not hold a band at {yo0} of {n}")
    if mode != "smooth" and (oo < 0 or oo + n > width):
        raise ValueError(f"vcycle_epilogue: an output of width {width} does not hold a band at {oo} of {n}")
    if mode == "smooth" and x.data_ptr() in {t.data_ptr() for t in (b, dinv, y)}:
        raise ValueError("vcycle_epilogue: x is updated in place and must not alias b, dinv or y")
    return dia._DT[dt], args


def vcycle_epilogue(mode: str, b: torch.Tensor, o0: int, n: int, *, dinv: Optional[torch.Tensor] = None,
                    y: Optional[torch.Tensor] = None, yo0: int = 0, x: Optional[torch.Tensor] = None,
                    omega: float = 0.0, width: Optional[int] = None,
                    out_o0: Optional[int] = None) -> torch.Tensor:
    """The V-cycle epilogue over the band ``[o0, o0 + n)`` of the level's
    column frames (b, dinv, x), y the SpMV product with its band at
    ``yo0``. ``"init"`` (dinv): a new frame of ``width`` slots (default
    b's) with ``(omega*dinv)*b`` on the band at ``out_o0`` (default o0)
    and 0 elsewhere; ``"residual"`` (y): the same with ``b - y``;
    ``"smooth"`` (dinv, y, x): ``x += (omega*dinv)*(b - y)`` on the band in
    place, x returned."""
    if b.device.type == "cpu":
        return vcycle_epilogue_plain(mode, b, o0, n, dinv=dinv, y=y, yo0=yo0, x=x, omega=omega, width=width,
                                     out_o0=out_o0)
    if b.device.type != "cuda":
        raise RuntimeError(f"vcycle_epilogue: no kernel for device {b.device}")
    width = b.shape[1] if width is None else int(width)
    oo = o0 if out_o0 is None else int(out_o0)
    dt, args = _check(mode, b, o0, n, dinv, y, yo0, x, width, oo)
    out = None if mode == "smooth" else torch.empty((b.shape[0], width), dtype=b.dtype, device=b.device)
    prm = dia._EpilogueParams(P=b.shape[0], mode=MODES.index(mode), n=n, o0=o0, wc=b.shape[1], yo0=yo0,
                              wy=y.shape[1] if "y" in args else 0, oo0=oo, wo=width, omega=float(omega))
    fn = getattr(dia.build_kernels()["vcycle_epilogue"], f"pa_vcycle_epilogue_{dt}")
    ptrs = [0 if t is None else t.data_ptr() for t in (args.get("dinv"), args.get("y"), args.get("x"), out)]
    rc = fn(ctypes.byref(prm), b.data_ptr(), *ptrs, torch.cuda.current_stream(b.device).cuda_stream)
    dia._raise_on(rc, "vcycle_epilogue")
    dia.LAUNCHES["vcycle_epilogue"] += 1
    return x if mode == "smooth" else out
