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
