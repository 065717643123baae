"""The port's streaming-DIA SpMV (K4: `ops/dia.py:dia_stream_spmv`) and the
stream lowering of `parallel/gpu.py:DeviceMatrix` against the JAX package.

The kernel's plain version (the only one on the CPU) is held against the
Pallas kernel `dia_spmv_pallas` under the Pallas interpreter at the three
shapes of tests/test_pallas_dia.py, f32 rtol=atol=1e-6 as there. The
lowering is held against the JAX package's on a Galerkin coarse operator
of its multigrid hierarchy (27 diagonals of variable coefficients),
carried across as plain arrays: same mode and offsets, and the SpMV equal
to the JAX package's `make_spmv_fn` on the 8-device CPU mesh to f64
rtol=1e-13."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.ops.pallas_dia import LANES, dia_spmv_pallas, plan_dia_pallas
from partitionedarrays_jl_tpu.parallel.tpu import (
    DeviceVector as JaxDeviceVector,
    device_matrix as jax_device_matrix,
    make_spmv_fn as jax_make_spmv_fn,
)
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    device_matrix,
    make_spmv_fn,
)

CPU = GPUBackend(device="cpu")


@pytest.mark.parametrize(
    "n,offsets",
    [
        (6 * LANES * 8, (-LANES * 8, -1, 0, 1, LANES * 8)),
        (4 * LANES * 8, (-3, 0, 5)),
        (2 * LANES * 8, (0,)),
    ],
)
def test_plain_stream_spmv_matches_pallas(n, offsets):
    rng = np.random.default_rng(7)
    block_rows = 8
    plan = plan_dia_pallas(offsets, n, block_rows=block_rows)
    R, H = plan["n_rows"], plan["halo_rows"]
    vals = np.zeros((len(offsets), plan["padded_len"]), dtype=np.float32)
    vals[:, :n] = rng.standard_normal((len(offsets), n)).astype(np.float32)
    for d, off in enumerate(offsets):
        src = np.arange(n) + off
        vals[d, np.arange(n)[(src < 0) | (src >= n)]] = 0.0
    x = rng.standard_normal(n).astype(np.float32)
    xp = np.pad(x, (H * LANES, plan["x_rows"] * LANES - H * LANES - n))
    want = np.asarray(
        dia_spmv_pallas(
            np.ascontiguousarray(vals.reshape(len(offsets), R, LANES)),
            xp.reshape(-1, LANES), offsets, R, H, block_rows, interpret=True,
        )
    ).reshape(-1)[:n]
    # the port's compact frame: owned band at o0 = 0, then ghost values the
    # kernel must not read, then the result's own width
    frame = np.concatenate([x, rng.standard_normal(9).astype(np.float32)])
    got = dia.dia_stream_spmv(
        torch.from_numpy(np.ascontiguousarray(vals[None, :, :n])), torch.from_numpy(frame[None]),
        offsets, torch.tensor([n], dtype=torch.int32), 0, n + 4,
    ).numpy()[0]
    np.testing.assert_allclose(got[:n], want, rtol=1e-6, atol=1e-6)
    assert not got[n:].any()


def test_plain_stream_spmv_masks_short_parts():
    """Two parts of unequal owned counts: reads past a part's band are 0,
    slots outside it are exactly 0."""
    dia.reset_launches()
    rng = np.random.default_rng(3)
    offsets, n = (-2, 0, 3), 10
    vals = torch.from_numpy(rng.standard_normal((2, 3, n)))
    x = torch.from_numpy(rng.standard_normal((2, n + 5)))
    no = torch.tensor([n, 6], dtype=torch.int32)
    y = dia.dia_stream_spmv(vals, x, offsets, no, 0, n + 5).numpy()
    for p, k in enumerate((n, 6)):
        want = np.zeros(k)
        for d, off in enumerate(offsets):
            for i in range(k):
                if 0 <= i + off < k:
                    want[i] += vals[p, d, i].item() * x[p, i + off].item()
        np.testing.assert_allclose(y[p, :k], want, rtol=1e-14)
        assert not y[p, k:].any()
    assert dia.LAUNCHES["dia_stream_spmv"] == 0  # the plain version launches nothing


def _export(A):
    def iset_arrays(r):
        isets = r.partition.part_values()
        return {
            "lid_to_gid": [np.asarray(i.lid_to_gid) for i in isets],
            "lid_to_part": [np.asarray(i.lid_to_part) for i in isets],
            "grid_shape": isets[0].grid_shape,
            "boxes": [(i.box_lo, i.box_hi) for i in isets],
        }

    return {
        "ngids": A.rows.ngids,
        "rows": iset_arrays(A.rows),
        "cols": iset_arrays(A.cols),
        "csr": [(M.indptr, M.indices, M.data, M.shape) for M in A.values.part_values()],
    }


@pytest.fixture(scope="module")
def coarse_operator():
    """Level 1 of the JAX package's hierarchy at 16^3 on (2,2,2) parts,
    its lowering, and its SpMV of a seeded vector on the CPU mesh."""
    ns = (16, 16, 16)

    def driver(parts):
        A, b, _, _ = pa.assemble_poisson(parts, ns)
        Ah = pa.decouple_dirichlet(A)
        h = pa.gmg_hierarchy(parts, Ah, ns, coarse_threshold=100)
        A1 = h.levels[1].A
        xg = np.random.default_rng(29).standard_normal(A1.cols.ngids)
        x = pa.PVector(parts._like([xg[np.asarray(i.lid_to_gid)] for i in A1.cols.partition.part_values()]), A1.cols)
        dA = jax_device_matrix(A1, parts.backend)
        dx = JaxDeviceVector.from_pvector(x, parts.backend, dA.col_layout)
        y = np.asarray(jax_make_spmv_fn(dA)(dx.data))
        owned = np.zeros(A1.rows.ngids)
        for p, iset in enumerate(A1.rows.partition.part_values()):
            owned[np.asarray(iset.oid_to_gid)] = y[p, dA.row_layout.o0 : dA.row_layout.o0 + iset.num_oids]
        return _export(A1), xg, owned, dA.dia_mode, tuple(int(o) for o in dA.dia_offsets)

    return pa.prun(driver, pa.tpu, (2, 2, 2))


def test_stream_lowering_matches_jax(coarse_operator):
    exported, xg, y_jax, jax_mode, jax_offsets = coarse_operator
    assert jax_mode == "stream" and len(jax_offsets) == 27

    def driver(parts):
        def prange_of(e):
            return interop.prange_from_arrays(
                parts, exported["ngids"], e["lid_to_gid"], e["lid_to_part"],
                grid_shape=e["grid_shape"], boxes=e["boxes"],
            )

        rows, cols = prange_of(exported["rows"]), prange_of(exported["cols"])
        A = interop.psparse_from_csr(rows, cols, exported["csr"])
        x = interop.pvector_from_values(cols, [xg[g] for g in exported["cols"]["lid_to_gid"]])
        dA = device_matrix(A, parts.backend)
        dx = DeviceVector.from_pvector(x, parts.backend, dA.col_layout)
        y = DeviceVector(make_spmv_fn(dA)(dx.data), A.rows, dA.row_layout, parts.backend)
        return dA, pt.gather_pvector(y.to_pvector())

    dA, y = pt.prun(driver, CPU, (2, 2, 2))
    assert dA.dia_mode == "stream" and dA.coded is None
    assert dA.dia_offsets == jax_offsets
    assert tuple(dA.stream_vals.shape) == (8, 27, dA.row_layout.no_max)
    np.testing.assert_allclose(y, y_jax, rtol=1e-13, atol=1e-13)


#: the streaming levels of chip_smoke.py's hierarchies and the form each
#: takes on 132 SMs: (parts, rows a part, itemsize) -> form. The stream
#: form takes a level whose CTAs (1024 rows in f32, 512 in f64) number at
#: least a quarter of the SMs (33): 96^3 and 48^3 at 192^3 f32 do; 24^3,
#: 12^3 and the stacked 48^3 f64 hierarchy's levels (8 parts of 12^3 and
#: 6^3: 32 and 8 CTAs) do not; the last two cases sit on either side of
#: the crossover
FORM_CASES = {
    "96^3-f32": (1, 96 ** 3, 4, dia.STREAM),
    "48^3-f32": (1, 48 ** 3, 4, dia.STREAM),
    "24^3-f32": (1, 24 ** 3, 4, dia.SMALL),
    "12^3-f32": (1, 12 ** 3, 4, dia.SMALL),
    "12^3-8-parts-f64": (8, 12 ** 3, 8, dia.SMALL),
    "6^3-8-parts-f64": (8, 6 ** 3, 8, dia.SMALL),
    "crossover-below": (1, 32 * 1024, 4, dia.SMALL),
    "crossover-at": (1, 32 * 1024 + 1, 4, dia.STREAM),
}


@pytest.mark.parametrize("case", list(FORM_CASES))
def test_stream_form_on_gmg_levels(case):
    P, n, item, want = FORM_CASES[case]
    assert dia.stream_form(P, n, item, 132) == want


@pytest.mark.parametrize(
    "D,n,form,shift,want",
    [
        (27, 1024, None, 0, ("small", False, 27)),
        (27, 40 * 1024, None, 0, ("stream", True, 27)),
        (27, 1024, "stream", 0, ("stream", True, 27)),
        (7, 1026, "stream", 0, ("stream", False, 7)),  # n % 4 != 0: scalar loads
        (13, 1024, "stream", 1, ("stream", False, 0)),  # off 16-byte alignment; 13: the run-time loop
        (13, 1024, "small", 0, ("small", False, 0)),
    ],
)
def test_stream_launch_picks_form_loads_and_sum(D, n, form, shift, want):
    """`stream_launch`: the form (forced or by shape), 128-bit value loads
    only where n is a multiple of 4 (f32) and the values 16-byte aligned,
    the unrolled sum for 27 and 7 diagonals, else the run-time loop."""
    buf = torch.zeros(D * n + shift, dtype=torch.float32)
    vals = buf[shift:].view(1, D, n)
    assert dia.stream_launch(vals, form) == want
    with pytest.raises(ValueError, match="no form"):
        dia.stream_launch(vals, "tiled")


def _emulate_stream_kernel(vals, x, offsets, no, o0, wy, form, vec):
    """csrc/dia_stream.cu's indexing in numpy: the grid of each form, the
    rows of each thread (consecutive with `vec`, PA_STREAM_THREADS apart
    without; one in the small form), the predicated value and x reads, the
    ascending-offset sum in the operand's type, the band's store and the
    pad loop. Returns y and how often each slot was written."""
    P, D, n = vals.shape
    item = vals.dtype.itemsize
    R = 1 if form == dia.SMALL else dia.stream_rows_per_thread(item)
    T = dia.SMALL_THREADS if form == dia.SMALL else dia.STREAM_THREADS
    gx = max(1, -(-n // (T * R)))
    y = np.full((P, wy), np.nan, dtype=vals.dtype)
    writes = np.zeros((P, wy), dtype=np.int64)
    bx, t, r = np.meshgrid(np.arange(gx), np.arange(T), np.arange(R), indexing="ij")
    base = bx * (T * R)
    row = base + t * R + r if vec else base + r * T + t
    for p in range(P):
        active = np.broadcast_to(row[..., :1] < no[p], row.shape)  # the thread's first row
        acc = np.zeros(row.shape, dtype=vals.dtype)
        for d, off in enumerate(offsets):
            v = np.where(row < n, vals[p, d, np.minimum(row, n - 1)], 0)
            k = row + off
            xv = np.where((k >= 0) & (k < no[p]), x[p, o0 + np.clip(k, 0, max(no[p] - 1, 0))], 0)
            term = (v * xv).astype(vals.dtype)
            acc = np.where(active, term if d == 0 else (acc + term).astype(vals.dtype), acc)
        st = row < n
        y[p, o0 + row[st]] = np.where(row < no[p], acc, 0)[st]
        np.add.at(writes[p], o0 + row[st], 1)
        pads = wy - n
        j = np.arange(gx * T)
        for m in range(-(-pads // (gx * T)) if pads > 0 else 0):
            jj = j + m * gx * T
            jj = jj[jj < pads]
            slots = np.where(jj < o0, jj, jj + n)
            y[p, slots] = 0
            np.add.at(writes[p], slots, 1)
    return y, writes


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("form", list(dia.STREAM_FORMS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("D", [7, 27, 13])
def test_stream_kernel_emulation_matches_plain(D, dtype, form, vec):
    """The kernel's schedule, emulated, equals the plain version value for
    value on two parts of unequal owned counts with the band off the
    frame's start: every slot written exactly once (NaN in every slot
    nothing writes), rows past a part's count 0, in each form, with and
    without vector loads (the small form has none: its emulation with
    ``vec`` is the one-row case all the same), for the unrolled sums and
    the run-time loop; one row more than the stream form's CTA covers, so
    the last CTA is ragged."""
    rng = np.random.default_rng(D)
    R = dia.stream_rows_per_thread(np.dtype(dtype).itemsize)
    n = dia.STREAM_THREADS * R + R  # a multiple of R: the vector loads apply
    m = 5
    offsets = tuple(sorted(int(o) for o in rng.choice(np.arange(-3 * m, 3 * m + 1), D, replace=False)))
    no = np.array([n, n - 37], dtype=np.int32)
    o0, wy = 3, n + 11
    vals = rng.standard_normal((2, D, n)).astype(dtype)
    x = rng.standard_normal((2, n + 5)).astype(dtype)
    want = dia.dia_stream_spmv_plain(torch.from_numpy(vals), torch.from_numpy(x), offsets,
                                     torch.from_numpy(no), o0, wy).numpy()
    got, writes = _emulate_stream_kernel(vals, x, offsets, no, o0, wy, form, vec and form == dia.STREAM)
    assert (writes == 1).all()
    assert np.array_equal(got, want)
