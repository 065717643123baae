#!/usr/bin/env python3
"""Time the port's DIA kernels of one or more checkouts on one card.

    python3 tools/time_coded_kernels.py [--src DIR ...] [--n 192] [--select] [--block K ...] [--cg N] [--gmg N]
                                        [--gmg-multi N] [--lobpcg N] [--irregular N [--slab-k1 K]]

Each ``--src`` is the root of a checkout that holds
``partitionedarrays_jl_tpu_torch/`` (default: this one); give the same
directory more than once to time it again, e.g. ``--src old --src .
--src . --src old`` to set two versions side by side in one run on one
card. For each checkout the script builds its kernels (into that
checkout's ``build/pa_torch_kernels/``) and times, by CUDA events:

* K1 `dia_coded_spmv`, K2 `dia_coded_spmv_pfold` and K3
  `dia_coded_spmv_axpy` on the n^3 7-point Poisson operator in row-class
  decode, staged as the GPU backend stages it (an interior class, and
  Dirichlet identity rows on the boundary), float32, one part;
* K4 `dia_stream_spmv` on random 27-diagonal values at the shapes of the
  GMG levels it serves (one part of 96^3, 48^3, 24^3 and 12^3 rows in
  float32; eight stacked parts of 12^3 and 6^3 in float64), in each form
  a checkout has (``stream`` and ``small`` since the redesign, forced;
  a checkout from before it: its one form), each checked torch.equal to
  its plain version;
* the empty kernel (`dia_null_launch`, one warp), as a control of the
  card's speed that no checkout changes;
* with ``--select``, K1 on synthetic select-chain operators of the GMG
  shapes (level 0's A at 192^3, the stencil S at 192^3 down to 12^3),
  each also checked torch.equal to its plain version;
* with ``--irregular N`` (a process per checkout, which imports its
  package): E1 `ell_spmv` on the tet-elasticity operator at N^3 nodes in
  float32 (forced ELL) and on the strict lowering of the 192^3 float32
  Poisson operator (7 slots), E2 `bsr_spmv` at N^3 in float64 and float32
  (through `parallel/gpu.py:_irregular_aoo`, so that every checkout runs
  the call its own staging makes) beside torch.sparse.mm on the CSR and,
  in a checkout with slab forms, E2 `bsr_spmm` on (P, W, K) slabs at K =
  2, 8 and ``--slab-k1``'s K (K = 1 is its ``_k1`` row beside the frame
  kernel) with its bytes, its bound and its bytes in whole 32-byte sectors
  (at K = 8 also with the nodes sorted by their count of blocks), the
  boundary modes of both on 4 parts at 32^3 float64 (one SpMV's boundary:
  every node-block bucket), and E3 `pairwise_dot` on a 192^3 float32 band
  (one part) and on 8 parts of 24^3 float64 (the strict 48^3 (2,2,2)
  cell's) beside torch.dot, each checked against its plain version
  (torch.equal; E3 by its bytes); the operators are assembled once and
  kept in ``build/irregular_cache/``, so every checkout times the same
  ones; with ``--slab-k1`` also each slab form at K = 1 beside its frame
  form on the same operand (`ell_spmm`, `bsr_spmm`, `bsr_spmv_boundary`
  on a (P, W, 1) slab, `pairwise_dot_block`, each held torch.equal to the
  frame call; keys ending ``_k1``) and both boundary modes on (P, W,
  ``--slab-k1``) slabs (keys ending ``_slab``), in a checkout that has the
  slab forms;
* with ``--block K [K ...]`` (e.g. ``--block 2 4 8``), in every checkout:
  the coded SpMM `dia_coded_spmm` at each width K on the row-class Poisson
  operator and on a select-chain operator of GMG level 0's shape (7
  diagonals coded with kk = 2, 4 code bytes a row: the decoupled A0's),
  plain, pfold and pfold with minv, in every form the checkout has
  (``row`` and ``staged`` since the staged form, forced, and the form it
  takes by shape; a checkout from before it: its one form), each checked
  torch.equal to its plain version, with its bytes and bound, beside K1
  `dia_coded_spmv` and K2 `dia_coded_spmv_pfold` on a frame of the same
  operator (key ``spmm``); and in this checkout only (its package is
  imported) at the largest K: K2 with minv and the sweep's precond form
  on the n^3 frames, the coded SpMM (plain and pfold forms) on the
  row-class Poisson operator and the streaming SpMM on random 7-diagonal
  values at n^3, and the block sweep (with and without minv) and the
  block dot's products, each checked torch.equal to its plain version;

and prints the checkout's ptxas lines (registers, spills) per kernel.

Two times per kernel: ``flush_ms``, chip_smoke.py's `time_ms` (the median
of single launches, each after an L2 flush and a spin that keeps the card
busy while the launch is queued), and ``loop_ms``, 20 back-to-back
launches over one event pair, divided by 20 (as the CG loop runs them).
``--cg N`` and ``--gmg N`` add, per checkout in a process of its own,
fused, pipelined and standard CG seconds per iteration at N^3 and the fused
body's profile (chip_smoke.py's `phase_profile`), and GMG-PCG seconds per
iteration at N^3 (set up by chip_smoke.py's `gmg_driver`, fixed trips
chip_smoke.py's `GMG_TRIPS`) and its profile on the stencil and the
structured transfer routes (a checkout from before the box plan: its one
route, ``structured_emb``); a checkout with the device-resident loops
(`make_cg_fn(graph=...)`) is timed in its CUDA-graph loop (the plain
keys) and in its eager loop (keys ending ``_eager``), a checkout from
before them in its Python loop (the plain keys),
for each coded operator of the structured route's hierarchy the host and
device microseconds of one K1 launch and chip_smoke.py's
`gmg_coded_operator` line (shape, launches per solve, flushed and
back-to-back µs, plain and torch.sparse.mm µs, the empty kernel launched
as K1 is, the bound), its `box_stencil_level` line per stencil level, its
`dia_stream_level` line per streaming level and `vcycle_epilogue_level`
line per level and mode (a checkout with the two K4 forms and the
epilogue kernel), and the bare empty kernel's `null_launch` line. ``--gmg-multi N`` adds
GMG-PCG seconds per iteration and its profile on (2,2,2) stacked parts
of N^3 in float64 (chip_smoke.py's stacked hierarchy), on the default
routes, in the graph loop where the checkout has one; ``--lobpcg N`` the
GMG-preconditioned LOBPCG loop's seconds per iteration at N^3 float32
(chip_smoke.py's `lobpcg_s_per_iter` on `gmg_driver`'s operator, a
checkout with `parallel/gpu_lobpcg.py`) and the coded SpMM's launches in
one fixed-trip run. The timers and the set-up are this checkout's
chip_smoke.py, so every checkout is timed the same way. One JSON line per
measurement; the nvidia-smi name and power-limit line first. Exits
non-zero without a card.
"""
import argparse
import functools
import importlib.util
import inspect
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LOOP = 20


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_dia(root: Path, alias: str):
    """A checkout's `ops/dia.py` as ``<alias>.ops.dia``, beside stand-in
    parent packages whose paths are the checkout's, so that its relative
    imports (`build_kernels` imports `ops/irregular.py`) resolve inside that
    checkout and several checkouts load in one process."""
    pkg = root / "partitionedarrays_jl_tpu_torch"
    for name, where in ((alias, pkg), (f"{alias}.ops", pkg / "ops")):
        mod = types.ModuleType(name)
        mod.__path__ = [str(where)]
        sys.modules[name] = mod
    return load_module(pkg / "ops" / "dia.py", f"{alias}.ops.dia")


def poisson_operator(dia, n):
    """The n^3 7-point operator in row-class decode: class 0 the interior
    stencil, class 1 the Dirichlet identity rows on the boundary."""
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    cb = np.zeros((1, 7, 2), dtype=np.float32)
    cb[0, :, 0] = -1.0
    cb[0, 3, 0] = 6.0
    cb[0, 3, 1] = 1.0
    i = np.arange(n)
    edge = (i == 0) | (i == n - 1)
    bnd = edge[:, None, None] | edge[None, :, None] | edge[None, None, :]
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).cuda(),
        no=torch.tensor([n ** 3], dtype=torch.int32, device="cuda"),
        codes=torch.from_numpy(bnd.reshape(1, 1, -1).astype(np.uint8)).cuda(),
        offsets=offsets, kk=(2,) * 7, code_row=(0,) * 7,
        cls_pattern=((True,) * 7, tuple(d == 3 for d in range(7))), o0=0,
    )


def timed(smoke, fn, flush):
    flush_ms = smoke.time_ms(fn, flush)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(LOOP):
        fn()
    b.record()
    torch.cuda.synchronize()
    return {"flush_ms": flush_ms, "loop_ms": a.elapsed_time(b) / LOOP}


#: K4's GMG shapes: (parts, box edge, dtype) of 192^3 f32 levels 1-4 and
#: the stacked 48^3 f64 hierarchy's levels 1-2
STREAM_LEVELS = ((1, 96, np.float32), (1, 48, np.float32), (1, 24, np.float32), (1, 12, np.float32),
                 (8, 12, np.float64), (8, 6, np.float64))


def time_stream_levels(smoke, dia, rng, flush):
    """K4 on random 27-diagonal values at each `STREAM_LEVELS` shape, in
    every form the checkout has, flushed and back-to-back ms, torch.equal
    to the plain version."""
    forms = getattr(dia, "STREAM_FORMS", (None,))
    out = {}
    for P, m, dt in STREAM_LEVELS:
        offsets = tuple(a * m * m + b * m + c for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
        rows = m ** 3
        vals = torch.from_numpy(rng.standard_normal((P, 27, rows)).astype(dt)).cuda()
        xs = torch.from_numpy(rng.standard_normal((P, rows)).astype(dt)).cuda()
        no = torch.full((P,), rows, dtype=torch.int32, device="cuda")
        want = dia.dia_stream_spmv_plain(vals, xs, offsets, no, 0, rows)
        line = {}
        for form in forms:
            kw = {} if form is None else {"form": form}
            k4 = lambda: dia.dia_stream_spmv(vals, xs, offsets, no, 0, rows, **kw)  # noqa: E731
            line[form or "only"] = {**timed(smoke, k4, flush), "equal": bool(torch.equal(k4(), want))}
        if forms != (None,):
            line["by_shape"] = dia.stream_form(P, rows, vals.element_size(), torch.cuda.get_device_properties(0).multi_processor_count)
        out[f"{P}x{m}^3-{np.dtype(dt).name}"] = line
    return out


def time_kernels(smoke, dia, n, rng, flush):
    op = poisson_operator(dia, n)
    frame = lambda: torch.from_numpy(rng.standard_normal((1, op.n)).astype(np.float32)).cuda()  # noqa: E731
    x, r, pprev, xacc = frame(), frame(), frame(), frame()
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(-0.61, dtype=torch.float32, device="cuda")
    return {
        "dia_coded_spmv": timed(smoke, lambda: dia.dia_coded_spmv(op, x, op.n), flush),
        "dia_coded_spmv_pfold": timed(smoke, lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, op.n), flush),
        "dia_coded_spmv_axpy": timed(
            smoke, lambda: dia.dia_coded_spmv_axpy(op, x, xacc, pprev, alpha, op.n), flush),
        "null_launch_control": timed(smoke, lambda: dia.dia_null_launch(), flush),
        "dia_stream_spmv": time_stream_levels(smoke, dia, rng, flush),
    }


def time_block(smoke, dia, n, K, rng, flush):
    """The Jacobi and block kernels at n^3 f32, one part, K columns:
    flushed and back-to-back ms, torch.equal to their plain versions. The
    sweep is a module of the package (it imports dia relatively), so these
    are timed with this checkout's package only."""
    sys.path.insert(0, str(ROOT))
    from partitionedarrays_jl_tpu_torch.ops import dia, sweep as sw

    op = poisson_operator(dia, n)
    rows = op.n
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    r, pprev, minv, x, p, q = (f(1, rows) for _ in range(6))
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    live = torch.ones((), dtype=torch.int32, device="cuda")
    out = {}

    def rec(name, fn, plain, timed_fn=None):
        """Time ``timed_fn`` (default fn) and hold fn's outputs against
        plain's; a sweep is timed in place, its check runs on copies."""
        got, want = fn(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        out[name] = {**timed(smoke, timed_fn or fn, flush),
                     "equal": all(bool(torch.equal(a, b)) for a, b in zip(got, want))}

    rec("dia_coded_spmv_pfold_minv", lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, rows, minv=minv),
        lambda: dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, rows, minv=minv))
    part2 = sw.sweep_partials(r, rows, 2)
    rec("cg_sweep_precond", lambda: sw.cg_sweep(r.clone(), q, alpha, live, part2, 0, rows, x=x.clone(), p=p, minv=minv),
        lambda: sw.cg_sweep_plain(r.clone(), q, alpha, live, part2.clone(), 0, rows, x=x.clone(), p=p, minv=minv),
        lambda: sw.cg_sweep(r, q, alpha, live, part2, 0, rows, x=x, p=p, minv=minv))
    X, PP, R, Pb, Q = (f(1, rows, K) for _ in range(5))
    betas = f(K)
    rec("dia_coded_spmm", lambda: dia.dia_coded_spmm(op, X, rows), lambda: dia.dia_coded_spmm_plain(op, X, rows))
    rec("dia_coded_spmm_pfold", lambda: dia.dia_coded_spmm_pfold(op, X, PP, betas, rows),
        lambda: dia.dia_coded_spmm_pfold_plain(op, X, PP, betas, rows))
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    vals = f(1, 7, rows)
    no = torch.tensor([rows], dtype=torch.int32, device="cuda")
    rec("dia_stream_spmm", lambda: dia.dia_stream_spmm(vals, X, offsets, no, 0, rows),
        lambda: dia.dia_stream_spmm_plain(vals, X, offsets, no, 0, rows))
    S = sw.block_product_stride(1, rows)
    out["block_products"] = {
        **timed(smoke, lambda: sw.block_products(X, Q, 0, rows), flush),
        "equal": bool(torch.equal(sw.block_products(X, Q, 0, rows).view(K, S)[:, :rows],
                                  sw.block_products_plain(X, Q, 0, rows).view(K, S)[:, :rows])),
    }
    alphas = torch.full((K,), 1e-3, dtype=torch.float32, device="cuda")
    act = torch.ones((K,), dtype=torch.int32, device="cuda")
    for name, mv in (("cg_sweep_block", None), ("cg_sweep_block_minv", minv)):
        part = sw.sweep_partials(R, rows, 2 * K if mv is not None else K)
        rec(name, lambda: sw.cg_sweep_block(R.clone(), Q, alphas, act, part, 0, rows, x=X.clone(), p=Pb, minv=mv),
            lambda: sw.cg_sweep_block_plain(R.clone(), Q, alphas, act, part.clone(), 0, rows, x=X.clone(), p=Pb,
                                            minv=mv),
            lambda: sw.cg_sweep_block(R, Q, alphas, act, part, 0, rows, x=X, p=Pb, minv=mv))
    return out


def select_operator(dia, n, points, rng):
    """A one-part select-chain operator of a GMG shape at n^3 rows: the
    7-point offsets with every diagonal coded (level 0's A), or the
    27-point offsets with the centre constant and 26 coded diagonals (the
    stencil S); kk = 2, codes 0 or 1 at random."""
    r = (-1, 0, 1)
    if points == 7:
        offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    else:
        offsets = tuple(a * n * n + b * n + c for a in r for b in r for c in r)
    D = len(offsets)
    kk = tuple(1 if points == 27 and d == 13 else 2 for d in range(D))
    code_row = tuple(int(np.sum(np.array(kk[:d]) > 1)) if kk[d] > 1 else -1 for d in range(D))
    codes = rng.integers(0, 2, (1, max(code_row) + 1, n ** 3)).astype(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(rng.standard_normal((1, D, 2)).astype(np.float32)).cuda(),
        no=torch.tensor([n ** 3], dtype=torch.int32, device="cuda"),
        codes=torch.from_numpy(np.ascontiguousarray(dia.pack_nibble_codes(codes).view(np.uint8))).cuda(),
        offsets=offsets, kk=kk, code_row=code_row, cls_pattern=None, o0=0,
    )


def time_select(smoke, dia, rng, flush):
    """K1 on the GMG select-chain shapes at the 192^3 hierarchy's sizes,
    float32: flushed and back-to-back ms, and torch.equal to plain."""
    out = {}
    for points, sizes in ((7, (192,)), (27, (192, 96, 48, 24, 12))):
        for n in sizes:
            op = select_operator(dia, n, points, rng)
            x = torch.from_numpy(rng.standard_normal((1, op.n)).astype(np.float32)).cuda()
            k1 = lambda: dia.dia_coded_spmv(op, x, op.n)  # noqa: E731
            equal = bool(torch.equal(k1(), dia.dia_coded_spmv_plain(op, x, op.n)))
            out[f"{'A' if points == 7 else 'S'}{n}"] = {**timed(smoke, k1, flush), "equal": equal}
    return out


def spmm_bytes(rows, code_bytes, K, mode, item):
    """The bytes the coded SpMM must move over `rows` rows: the code bytes
    once, x read and y written K values a row (pfold: r and pprev read, y
    and p written; minv a value a row more)."""
    per = code_bytes + (2 if mode == "plain" else 4) * K * item + (item if mode == "pfold_minv" else 0)
    return rows * per


def time_spmm(smoke, dia, n, widths, rng, flush):
    """`dia_coded_spmm` at each width of `widths` on the n^3 row-class
    Poisson operator and on a select-chain operator of GMG level 0's shape,
    plain, pfold and pfold with minv, in every form the checkout has
    (forced; and the form it takes by shape), torch.equal to the plain
    version, with its bound; K1 and K2 on a frame of the same operator
    beside them. f32, one part."""
    forms = getattr(dia, "SPMM_FORMS", (None,))
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    out = {}
    for name, op in (("row_class", poisson_operator(dia, n)), ("select_A0", select_operator(dia, n, 7, rng))):
        rows, streams = op.n, op.codes.shape[1]
        r, pprev = f32(1, rows), f32(1, rows)
        beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
        line = {
            "dia_coded_spmv": {**timed(smoke, lambda: dia.dia_coded_spmv(op, r, rows), flush),
                               "bound_ms": rows * (streams + 8) / smoke.HBM_BYTES_PER_S * 1e3},
            "dia_coded_spmv_pfold": {**timed(smoke, lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, rows), flush),
                                     "bound_ms": rows * (streams + 16) / smoke.HBM_BYTES_PER_S * 1e3},
        }
        for K in widths:
            X, PP = f32(1, rows, K), f32(1, rows, K)
            betas, minv = f32(K), f32(1, rows)
            calls = {
                "plain": (lambda **kw: dia.dia_coded_spmm(op, X, rows, **kw),
                          lambda: dia.dia_coded_spmm_plain(op, X, rows)),
                "pfold": (lambda **kw: dia.dia_coded_spmm_pfold(op, X, PP, betas, rows, **kw),
                          lambda: dia.dia_coded_spmm_pfold_plain(op, X, PP, betas, rows)),
                "pfold_minv": (lambda **kw: dia.dia_coded_spmm_pfold(op, X, PP, betas, rows, minv=minv, **kw),
                               lambda: dia.dia_coded_spmm_pfold_plain(op, X, PP, betas, rows, minv=minv)),
            }
            width = {}
            for mode, (kern, plain) in calls.items():
                nbytes = spmm_bytes(rows, streams, K, mode, 4)
                t = {"bytes": nbytes, "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3}
                if forms != (None,):
                    t["by_shape"] = dia.spmm_form(op.offsets, 4, K, mode, streams)
                want = plain()
                want = want if isinstance(want, tuple) else (want,)
                for form in forms:
                    key = form or "only"
                    if form is not None and form == dia.SPMM_STAGED:
                        try:
                            plan = dia.plan_coded_block_windows(op.offsets, 4, K, mode, streams)
                        except ValueError as e:
                            t[key] = {"no_plan": str(e)}
                            continue
                    kw = {} if form is None else {"form": form}
                    got = kern(**kw)
                    got = got if isinstance(got, tuple) else (got,)
                    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
                    t[key] = {**timed(smoke, lambda: kern(**kw), flush), "equal": equal}
                    if form is not None and form == dia.SPMM_STAGED:
                        t[key]["plan"] = {"tile": plan.tile, "marching": bool(plan.stride),
                                          "smem_bytes": plan.smem_bytes}
                width[mode] = t
            line[f"K={K}"] = width
            del X, PP, betas, minv
        out[name] = line
    return out


def host_device_us(fns, reps):
    """Host and device microseconds per call of fns, issued `reps` times
    in turn."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    a.record()
    for _ in range(reps):
        for f in fns:
            f()
    e.record()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    k = reps * len(fns)
    return {"host_us": host * 1e6 / k, "device_us": a.elapsed_time(e) * 1e3 / k}


#: the irregular operators of ``--irregular``: the elasticity operator at
#: N^3 nodes on one part (f64 for E2, scaled to f32 for E1), on 4 parts at
#: IRREGULAR_MULTI^3 (f64, the boundary modes) and the strict lowering of the
#: IRREGULAR_STRICT^3 f32 Poisson operator
IRREGULAR_MULTI = 32
#: the columns of E2's slab-form rows (besides 2 and ``--slab-k1``'s K):
#: the block elasticity solve's
BSR_SPMM_K = 8
IRREGULAR_STRICT = 192


def _cached_system(smoke, kind, n, nparts):
    """(A, x) of an irregular-timing operator: assembled by this checkout's
    package at first use and kept in build/irregular_cache/ as its
    per-part index maps and CSR arrays, so that every checkout of one run
    times the same operator (rebuilt through the checkout's `interop`)."""
    from partitionedarrays_jl_tpu_torch import interop, prun, sequential

    path = ROOT / "build" / "irregular_cache" / f"{kind}_{n}_{nparts}.npz"
    if not path.exists():
        def build(parts):
            if kind == "elasticity":
                from partitionedarrays_jl_tpu_torch import assemble_elasticity_tet
                A, _, xh, _ = assemble_elasticity_tet(parts, (n, n, n))
            else:
                from partitionedarrays_jl_tpu_torch import assemble_poisson
                A, _, xh, _ = assemble_poisson(parts, (n, n, n), dtype=np.float32)
            out = {"ngids": np.array(A.rows.ngids)}
            for p, (ri, ci, M, x) in enumerate(zip(A.rows.partition.part_values(), A.cols.partition.part_values(),
                                                   A.values.part_values(), xh.values.part_values())):
                out.update({f"r_gid{p}": np.asarray(ri.lid_to_gid), f"r_part{p}": np.asarray(ri.lid_to_part),
                            f"c_gid{p}": np.asarray(ci.lid_to_gid), f"c_part{p}": np.asarray(ci.lid_to_part),
                            f"indptr{p}": M.indptr, f"indices{p}": M.indices, f"data{p}": M.data,
                            f"shape{p}": np.array(M.shape), f"x{p}": np.asarray(x)})
            return out

        grid = nparts if kind == "elasticity" else (1, 1, 1)
        arrays = prun(build, sequential, grid)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **arrays)
    z = np.load(path)
    grid = nparts if kind == "elasticity" else (1, 1, 1)

    def carry(parts):
        ng = int(z["ngids"])
        rows = interop.prange_from_arrays(parts, ng, [z[f"r_gid{p}"] for p in range(nparts)],
                                          [z[f"r_part{p}"] for p in range(nparts)])
        cols = interop.prange_from_arrays(parts, ng, [z[f"c_gid{p}"] for p in range(nparts)],
                                          [z[f"c_part{p}"] for p in range(nparts)])
        A = interop.psparse_from_csr(rows, cols, [(z[f"indptr{p}"], z[f"indices{p}"], z[f"data{p}"],
                                                   tuple(z[f"shape{p}"])) for p in range(nparts)])
        return A, interop.pvector_from_values(cols, [z[f"x{p}"] for p in range(nparts)])

    return prun(carry, sequential, grid)


def irregular_worker(root: Path, n: int, slab_k: int = 0) -> list:
    """E1-E3 of checkout `root` on the irregular operators, in a process of
    its own (flushed and back-to-back ms, each held against its plain
    version): E1 on the elasticity operator at n^3 in f32 (forced ELL) and
    on the strict lowering of the 192^3 f32 Poisson operator; E2's A_oo at
    n^3 in f64 and f32 (BSR, through `_irregular_aoo`) with torch.sparse.mm
    on the CSR, and its slab form at K = 2, 8 and ``slab_k`` (at 8 also on
    a count-sorted copy); E1's and E2's boundary modes on 4 parts at 32^3 f64 (forced
    ELL; SD, whose node-block boundary has 8 width buckets), one SpMV's
    boundary (a checkout from before the one-launch boundary: a launch a
    bucket); E3 on the 192^3 f32 band and on 8 parts of 24^3 f64 with
    torch.dot; the empty kernel. With ``slab_k`` (and slab forms in the
    checkout), each slab form at K = 1 beside its frame form, and the
    boundary modes on slabs of ``slab_k`` columns."""
    sys.path.insert(0, str(root))
    from partitionedarrays_jl_tpu_torch import GPUBackend
    from partitionedarrays_jl_tpu_torch.ops import dia
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _irregular_aoo, device_matrix

    smoke = load_module(ROOT / "chip_smoke.py", "chip_smoke")
    backend = GPUBackend()
    dia.build_kernels()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    out = []

    def rec(name, shape, fn, plain, timed_fn=None, **extra):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        same = got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes() if got.dim() == 0 else torch.equal(got, want)
        if not same:
            raise SystemExit(f"{name} at {shape}: kernel differs from its plain version")
        out.append({"kernel": name, "shape": shape, **timed(smoke, timed_fn or fn, flush), **extra})

    def frame(layout, dtype):
        x = torch.from_numpy(rng.standard_normal((layout.P, layout.W))).to("cuda", dtype)
        x[:, layout.trash] = 0
        return x

    slabs = slab_k > 0 and hasattr(irr, "ell_spmm")

    def k1(name, shape, slab_fn, frame_fn):
        # a slab form at K = 1 against its frame form on the same operand
        if slabs:
            rec(f"{name}_k1", shape, slab_fn, lambda: frame_fn()[..., None])

    def col(t):
        return t[..., None].contiguous()

    def slab_rows(irr, dA, dtype, shape, ks):
        # E2's slab form at each K of ks, torch.equal to its plain version,
        # with its bytes (real blocks, their columns, the counts, the owned
        # node rows of the x slab, the whole y slab) and its bound, and the
        # same in whole 32-byte sectors; at BSR_SPMM_K also on a copy of the
        # operand with the nodes sorted by their count of real blocks (no
        # sector shared by nodes of few and of many blocks)
        cl, rl = dA.col_layout, dA.row_layout
        staged = (dA.bsr_vals, dA.bsr_cols, dA.bsr_counts)
        P, _, _, _, nn = dA.bsr_vals.shape
        real, item = int(dA.bsr_counts.sum()), dA.bsr_vals.element_size()
        for K in ks:
            xk = torch.from_numpy(rng.standard_normal((cl.P, cl.W, K))).to("cuda", dtype)
            xk[:, cl.trash] = 0
            args = (xk, cl.o0, rl.o0, rl.W)
            slabs_bytes = (P * nn * dA.bsr_bs + rl.P * rl.W) * K * item
            nbytes = real * (dA.bsr_bs**2 * item + 4) + dA.bsr_counts.numel() * 4 + slabs_bytes
            bound_ms, bound_by = smoke._bound_ms(nbytes, 2 * real * dA.bsr_bs**2 * K,
                                                 smoke.F64_FLOPS_PER_S if item == 8 else smoke.F32_FLOPS_PER_S)
            ops = {"": staged}
            if K == BSR_SPMM_K:
                perm = torch.argsort(dA.bsr_counts, dim=1, stable=True)
                ops["sorted"] = (torch.gather(dA.bsr_vals, 4, perm[:, None, None, None, :].expand_as(dA.bsr_vals)),
                                 torch.gather(dA.bsr_cols, 2, perm[:, None, :].expand_as(dA.bsr_cols)),
                                 torch.gather(dA.bsr_counts, 1, perm))
            for variant, (vals, cols, counts) in ops.items():
                sector_bytes = smoke.bsr_sector_bytes(types.SimpleNamespace(bsr_counts=counts, bsr_bs=dA.bsr_bs), item)
                sector_bytes += slabs_bytes
                rec("bsr_spmm", f"{shape}, K = {K}" + (f", {variant}" if variant else ""),
                    lambda: irr.bsr_spmm(vals, cols, counts, *args),
                    lambda: irr.bsr_spmm_plain(irr.bsr_row_major(vals), irr.bsr_row_major(cols), *args), K=K,
                    operand=variant or "staged", bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                    sector_bytes=sector_bytes, sector_bound_ms=sector_bytes / smoke.HBM_BYTES_PER_S * 1e3)
            del xk, args, ops

    A, _ = _cached_system(smoke, "elasticity", n, 1)
    A32 = smoke._f32_operator(A)
    dA = device_matrix(A32, backend, lowering="ell")
    x = frame(dA.col_layout, torch.float32)
    args = (dA.oo_vals, dA.oo_cols, x, dA.row_layout.o0, dA.row_layout.W)
    shape = f"{n}^3 f32 elasticity, {dA.oo_vals.numel() // dA.row_layout.no_max} slots"
    rec("ell_spmv", shape, lambda: irr.ell_spmv(*args), lambda: irr.ell_spmv_plain(*args))
    x1 = col(x)
    k1("ell_spmm", shape, lambda: irr.ell_spmm(dA.oo_vals, dA.oo_cols, x1, *args[3:]), lambda: irr.ell_spmv(*args))
    del dA, x, x1, args
    for A_, dtype in ((A, torch.float64), (A32, torch.float32)):
        dA = device_matrix(A_, backend, lowering="bsr")
        x = frame(dA.col_layout, dtype)
        W = dA.row_layout.W
        aoo, aoo_plain = _irregular_aoo(dA, False), _irregular_aoo(dA, True)
        M = A_.values.part_values()[0]
        csr = smoke._csr_on(M, "cuda")
        xcol = x[0, dA.col_layout.o0 : dA.col_layout.o0 + M.shape[1]].reshape(-1, 1).contiguous()
        shape = f"{n}^3 {str(dtype)[6:]} elasticity, bs {dA.bsr_bs}"
        rec("bsr_spmv", shape, lambda: aoo(x, W),
            lambda: aoo_plain(x, W), library_ms=smoke.time_ms(lambda: torch.sparse.mm(csr, xcol), flush))
        x1, o0 = col(x), dA.row_layout.o0
        k1("bsr_spmm", shape, lambda: irr.bsr_spmm(dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, x1, o0, o0, W),
           lambda: aoo(x, W))
        if hasattr(irr, "bsr_spmm"):
            slab_rows(irr, dA, dtype, shape, sorted({2, BSR_SPMM_K, slab_k} - {0, 1}))
        del dA, x, x1, aoo, aoo_plain, csr, xcol
    del A, A32
    torch.cuda.empty_cache()
    P, _ = _cached_system(smoke, "poisson", IRREGULAR_STRICT, 1)
    dA = device_matrix(P, backend, strict=True)
    x = frame(dA.col_layout, torch.float32)
    args = (dA.oo_vals, dA.oo_cols, x, dA.row_layout.o0, dA.row_layout.W)
    shape = f"{IRREGULAR_STRICT}^3 f32 strict Poisson, 7 slots"
    rec("ell_spmv", shape, lambda: irr.ell_spmv(*args), lambda: irr.ell_spmv_plain(*args))
    x1 = col(x)
    k1("ell_spmm", shape, lambda: irr.ell_spmm(dA.oo_vals, dA.oo_cols, x1, *args[3:]), lambda: irr.ell_spmv(*args))
    del x1
    # E3 on the strict band of that operator, and on the 8 parts of the
    # strict 48^3 (2,2,2) cell (24^3 rows each, f64)
    for parts, rows, dtype in ((1, IRREGULAR_STRICT**3, torch.float32), (8, 24**3, torch.float64)):
        o0 = dA.row_layout.o0
        a, c = frame(dA.row_layout, dtype)[:, : o0 + rows + 3], frame(dA.row_layout, dtype)[:, : o0 + rows + 3]
        a, c = a.repeat(parts, 1).contiguous(), c.repeat(parts, 1).contiguous()
        av, cv = a[0, o0 : o0 + rows], c[0, o0 : o0 + rows]
        dia.reset_launches()
        irr.pairwise_dot(a, c, o0, rows)
        rec("pairwise_dot", f"{parts} x {rows} {str(dtype)[6:]}", lambda: irr.pairwise_dot(a, c, o0, rows),
            lambda: irr.pairwise_dot_plain(a, c, o0, rows), launches=dia.LAUNCHES["pairwise_dot"],
            library_ms=smoke.time_ms(lambda: torch.dot(av, cv), flush))
        a1, c1 = col(a), col(c)
        k1("pairwise_dot_block", f"{parts} x {rows} {str(dtype)[6:]}",
           lambda: irr.pairwise_dot_block(a1, c1, o0, rows), lambda: irr.pairwise_dot(a, c, o0, rows))
    del dA, x, args, P, a, c, av, cv, a1, c1
    torch.cuda.empty_cache()
    A, _ = _cached_system(smoke, "elasticity", IRREGULAR_MULTI, 4)
    for low in ("ell", "auto"):
        dA = device_matrix(A, backend, lowering=low)
        cl, rl = dA.col_layout, dA.row_layout
        x, y0 = frame(cl, torch.float64), frame(rl, torch.float64)
        if dA.ohb_bs is None:
            kern = lambda k, y: k(dA.oh_rows, dA.oh_vals, dA.oh_cols, x, y, rl.trash)
            name, k_, p_ = "ell_spmv_boundary", irr.ell_spmv_boundary, irr.ell_spmv_boundary_plain
        elif hasattr(irr, "BSR_MAX_BUCKETS"):
            kern = lambda k, y: k(dA.ohb_rows, dA.ohb_vals, dA.ohb_cols, x, cl.g0, dA.ohb_nhn, y, rl.trash)
            name, k_, p_ = "bsr_spmv_boundary", irr.bsr_spmv_boundary, irr.bsr_spmv_boundary_plain
        else:
            def kern(k, y):
                for r, c, v in zip(dA.ohb_rows, dA.ohb_cols, dA.ohb_vals):
                    k(r, v, c, x, cl.g0, dA.ohb_nhn, y, rl.trash)
                return y
            name, k_, p_ = "bsr_spmv_boundary", irr.bsr_spmv_boundary, irr.bsr_spmv_boundary_plain
        dia.reset_launches()
        kern(k_, y0.clone())
        launches = dia.LAUNCHES[name]
        y = y0.clone()  # timed in place: the sums grow, the work does not
        shape = f"{IRREGULAR_MULTI}^3 f64, 4 parts, {low}"
        rec(name, shape, lambda: kern(k_, y0.clone()),
            lambda: kern(p_, y0.clone()), timed_fn=lambda: kern(k_, y), launches=launches,
            buckets=len(dA.ohb_rows or ()))
        if slabs:
            # K copies of the frame: each column must be the frame call's
            want, frame_x = kern(k_, y0.clone()), x
            for K, key in ((1, f"{name}_k1"), (slab_k, f"{name}_slab")):
                x = frame_x[..., None].expand(-1, -1, K).contiguous()  # kern reads x
                yk = y0[..., None].expand(-1, -1, K).contiguous()
                yt, want_k = yk.clone(), want[..., None].expand(-1, -1, K)
                rec(key, f"{shape}, K = {K}", lambda: kern(k_, yk.clone()), lambda: want_k,
                    timed_fn=lambda: kern(k_, yt))
            x = frame_x
    null = smoke.null_launch_us(flush)
    out.append({"kernel": "null_launch", "us": null})
    return out


def solve_worker(root: Path, cg_n: int, gmg_n: int, gmg_multi: int = 0, lobpcg_n: int = 0) -> dict:
    """The solvers' seconds per iteration with the package of checkout
    `root`, in a process of its own: fused, pipelined and standard CG at
    cg_n^3 float32 (fixed trips of 20 and 220; the graph and the eager loop
    where the checkout has both) and the fused body's profile, and GMG-PCG
    at gmg_n^3 float32 on each transfer route with, for the coded operators
    of the structured
    route's hierarchy, the host and device microseconds of one K1 launch, issued
    back to back per operator and in turn over all of them (as a V-cycle
    issues them); the profile, the empty kernel's line and chip_smoke.py's
    `gmg_coded_operator` and `box_stencil_level` lines go to stdout
    first."""
    # the checkout's package first: chip_smoke.py's own imports then find it
    sys.path.insert(0, str(root))
    import partitionedarrays_jl_tpu_torch  # noqa: F401

    smoke = load_module(ROOT / "chip_smoke.py", "chip_smoke")
    from partitionedarrays_jl_tpu_torch.ops import dia

    backend = smoke.GPUBackend()
    dia.build_kernels()
    out = {"package": str(Path(dia.__file__).resolve().parents[2])}
    # a checkout with the device-resident loops: time the graph and the eager loop
    has_graph = "graph" in inspect.signature(smoke.make_cg_fn).parameters
    if cg_n:
        A, b, _, x0 = smoke.prun(
            lambda parts: smoke.assemble_poisson(parts, (cg_n,) * 3, dtype=np.float32), backend, (1, 1, 1))
        dA = smoke.device_matrix(A, backend)
        b = smoke._b_on_cols_layout(b, dA)
        x0 = smoke.DeviceVector.from_pvector(x0, backend, dA.col_layout).data
        out["cg_n"] = cg_n
        loops = (("", {}), ("_eager", {"graph": False})) if has_graph else (("", {}),)
        for body, kw in (("cg", {}), ("pipelined_cg", {"pipelined": True}), ("standard_cg", {"fused": False})):
            for tag, lkw in loops:
                out[f"{body}{tag}_s_per_iter"], _ = smoke.fixed_trip_s_per_iter(
                    lambda m: smoke.make_cg_fn(dA, 0.0, m, **kw, **lkw), b, x0, 20, 220)
        for tag, lkw in loops:
            smoke.phase_profile(f"cg_profile{tag}", smoke.make_cg_fn(dA, 0.0, 48, **lkw), b, x0, 48)
    if lobpcg_n:
        run = smoke.prun(smoke.gmg_driver, backend, (1, 1, 1), lobpcg_n, True)
        dA = smoke.device_matrix(run["Ah"], backend)
        out["lobpcg_n"] = lobpcg_n
        dia.reset_launches()
        out["lobpcg_s_per_iter"], out["lobpcg_fixed_trip_s"] = smoke.lobpcg_s_per_iter(
            dA, run["h"], np.random.default_rng(0))
        out["lobpcg_spmm_launches"] = dia.LAUNCHES["dia_coded_spmm"]
    if gmg_multi:
        run = smoke.prun(smoke.gmg_driver, backend, (2, 2, 2), gmg_multi, False)
        b = smoke._b_on_cols_layout(run["bh"], smoke.device_matrix(run["Ah"], backend))
        x0 = torch.zeros_like(b)
        out["gmg_multi_n"] = gmg_multi
        out["gmg_multi_s_per_iter"], _ = smoke.fixed_trip_s_per_iter(
            lambda m: smoke.gpu_gmg.make_gmg_pcg_fn(run["h"], backend, 0.0, m), b, x0, *smoke.GMG_TRIPS)
        smoke.phase_profile("gmg_pcg_profile_stacked", smoke.gpu_gmg.make_gmg_pcg_fn(run["h"], backend, 0.0, 5),
                            b, x0, 5)
    if not gmg_n:
        return out
    run = smoke.prun(smoke.gmg_driver, backend, (1, 1, 1), gmg_n, True)
    h = run["h"]
    b = smoke._b_on_cols_layout(run["bh"], smoke.device_matrix(run["Ah"], backend))
    x0 = torch.zeros_like(b)
    # a checkout from before the box plan has one route: S coded, E the emb gather
    routes = hasattr(smoke.gpu_gmg, "route")
    kws = (("stencil", {}), ("structured", {"stencil": False})) if routes else (("structured_emb", {}),)
    coded_kw = kws[-1][1]
    if has_graph:
        kws += tuple((f"{name}_eager", {**kw, "graph": False}) for name, kw in kws)
    out.update({"gmg_n": gmg_n, "gmg_pcg_s_per_iter": {}, "fixed_trips": smoke.GMG_TRIPS})
    for name, kw in kws:
        out["gmg_pcg_s_per_iter"][name], _ = smoke.fixed_trip_s_per_iter(
            lambda m: smoke.gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, m, **kw), b, x0, *smoke.GMG_TRIPS)
        smoke.phase_profile(f"gmg_pcg_profile_{name}", smoke.gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, 5, **kw),
                            b, x0, 5)
    # the coded operators of the structured route (its S included)
    dh = smoke.gpu_gmg.device_hierarchy(h, backend, **coded_kw)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    # a solve to tolerance for the launch counts, then one line per coded
    # operator, per stencil level and the empty kernel's (chip_smoke.py's
    # phase 5 lines)
    fn = smoke.gpu_gmg.make_gmg_pcg_fn(h, backend, smoke.TOL_MAIN, 4 * run["Ah"].rows.ngids, **coded_kw)
    iterations = fn(b, x0)[3]
    # launches follow the iterations the device ran (frozen ones included)
    iterations = (getattr(fn, "stats", None) or {}).get("device_iterations", iterations)
    smoke.emit({"phase": "null_launch", "us": smoke.null_launch_us(flush)})
    smoke.coded_operator_times(dh, iterations, flush, np.random.default_rng(0))
    if routes:
        dh_default = smoke.gpu_gmg.device_hierarchy(h, backend)
        smoke.stencil_level_times(dh_default, iterations, flush, np.random.default_rng(0))
    if hasattr(dia, "STREAM_FORMS") and importlib.util.find_spec("partitionedarrays_jl_tpu_torch.ops.epilogue"):
        # a checkout with the two K4 forms and the epilogue kernel
        smoke.stream_level_times(h, dh_default, iterations, flush, np.random.default_rng(0))
        smoke.epilogue_level_times(h, dh_default, iterations, flush, np.random.default_rng(0))
    calls = []
    for lv in dh["levels"]:
        for dM in (lv["dA"], lv["dS"]):
            if dM.dia_mode == "coded":
                x = torch.ones((dM.col_layout.P, dM.col_layout.W), dtype=torch.float32, device=backend.device)
                calls.append(functools.partial(dia.dia_coded_spmv, dM.coded, x, dM.row_layout.W))
    out.update({
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "levels": len(dh["levels"]), "coded_operators": len(calls),
        "each": [host_device_us([f], 50) for f in calls],
        "in_turn": host_device_us(calls, 20),
    })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", type=Path, help="checkout root (repeatable)")
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--cg", type=int, default=0, metavar="N", help="also time fused and pipelined CG at N^3")
    ap.add_argument("--gmg", type=int, default=0, metavar="N", help="also time GMG-PCG at N^3")
    ap.add_argument("--gmg-multi", type=int, default=0, metavar="N",
                    help="also time GMG-PCG on (2,2,2) stacked parts of N^3, float64")
    ap.add_argument("--lobpcg", type=int, default=0, metavar="N",
                    help="also time GMG-preconditioned LOBPCG per iteration at N^3, float32")
    ap.add_argument("--block", type=int, nargs="+", default=[], metavar="K",
                    help="also time the coded SpMM at each width K (every checkout) and the Jacobi and block "
                         "kernels at the largest (this checkout) at n^3")
    ap.add_argument("--select", action="store_true",
                    help="also time K1 on synthetic GMG select-chain operators (A 192^3, S 192^3..12^3)")
    ap.add_argument("--irregular", type=int, default=0, metavar="N",
                    help="time E1-E3 (A_oo at N^3 elasticity, the boundary modes, E1 and E3 strict at 192^3)")
    ap.add_argument("--slab-k1", type=int, default=0, metavar="K",
                    help="with --irregular, also each slab form at K = 1 and the boundary modes at K columns")
    ap.add_argument("--irregular-worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--solve-worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_coded_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.irregular_worker:
        for line in irregular_worker(args.irregular_worker, args.irregular, args.slab_k1):
            print(json.dumps(line), flush=True)
        return 0
    if args.solve_worker:
        print(json.dumps(solve_worker(args.solve_worker, args.cg, args.gmg, args.gmg_multi, args.lobpcg)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    smoke = load_module(ROOT / "chip_smoke.py", "chip_smoke")
    srcs = [s.resolve() for s in args.src or [ROOT]]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    mods = {}
    for k, root in enumerate(srcs):
        if root not in mods:
            mods[root] = load_dia(root, f"pa_checkout_{len(mods)}")
        dia = mods[root]
        dia.build_kernels()
        res = time_kernels(smoke, dia, args.n, np.random.default_rng(args.seed), flush)
        if args.select:
            res["select"] = time_select(smoke, dia, np.random.default_rng(args.seed), flush)
        if args.block:
            res["spmm"] = time_spmm(smoke, dia, args.n, args.block, np.random.default_rng(args.seed), flush)
        if args.block and root == ROOT:
            res["block"] = time_block(smoke, dia, args.n, max(args.block), np.random.default_rng(args.seed), flush)
        res["ptxas"] = smoke._ptxas_lines(dia.BUILD_LOG)
        print(json.dumps({"run": k, "src": str(root), "n": args.n, **res}), flush=True)
    if args.irregular:
        # a process per checkout and run: each imports its own package
        for k, root in enumerate(srcs):
            proc = subprocess.run([sys.executable, __file__, "--irregular-worker", str(root), "--irregular",
                                   str(args.irregular), "--slab-k1", str(args.slab_k1)], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], file=sys.stderr)
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            for line in proc.stdout.strip().splitlines():
                if line.startswith("{"):
                    print(json.dumps({"run": k, "src": str(root), "variant": "irregular", **json.loads(line)}),
                          flush=True)
    if args.cg or args.gmg or args.gmg_multi or args.lobpcg:
        # a process per checkout: each imports its own package
        for k, root in enumerate(srcs):
            proc = subprocess.run(
                [sys.executable, __file__, "--solve-worker", str(root), "--cg", str(args.cg), "--gmg", str(args.gmg),
                 "--gmg-multi", str(args.gmg_multi), "--lobpcg", str(args.lobpcg)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                print(proc.stdout[-4000:], file=sys.stderr)
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            for line in proc.stdout.strip().splitlines():
                print(json.dumps({"run": k, "src": str(root), "variant": "solvers", **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
