"""The non-band lowerings of the port (supernode-dense, node-block, padded
ELL, and the node-block boundary) against the JAX package's.

The system: the unstructured tet-elasticity operator of
`models/elasticity_tet.py`, assembled by the JAX package on (4,4,4) nodes
over 4 parts (f64) and carried to the port as plain arrays (`interop`),
so both lower the same CSR. The JAX package lowers it on its TPU backend
(the CPU mesh) by default, with ``PA_TPU_SD=0`` and with ``PA_TPU_SD=0
PA_TPU_BSR=0``; the port on ``GPUBackend(device="cpu")`` with
``lowering="auto"``, ``"bsr"`` and ``"ell"``. Held:

* the lowering each resolves to (SD, BSR, ELL), and the node-block
  boundary on the SD and BSR lowerings, engaged on more than one part;
* the staged arrays field by field (``sd_idx``, the ``sd_vals`` widths and
  values, ``bsr_cols``/``bsr_vals`` through the inverse of E2's slot-major
  layout, with ``bsr_counts`` the real blocks a node row, the ``ohb``
  chunks, each array's chunks views of one buffer; the ELL arrays of A_oo
  and A_oh through the inverse of E1's slot-major layout) exactly;
* the SpMV products against the JAX package's to 1e-12 (both sum the same
  terms in orders that differ: XLA's einsum against the port's ascending
  fold);
* on (8,8,8) nodes, one part: more than one SD width bucket, with the JAX
  package's widths.
"""
import os

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_elasticity_tet as jax_assemble_elasticity_tet
from partitionedarrays_jl_tpu.parallel.tpu import DeviceMatrix as JaxDeviceMatrix
from partitionedarrays_jl_tpu.parallel.tpu import DeviceVector as JaxDeviceVector
from partitionedarrays_jl_tpu.parallel.tpu import make_spmv_fn as jax_make_spmv_fn
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.ops import irregular as irr
from partitionedarrays_jl_tpu_torch.parallel import gpu_irregular as gi
from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceMatrix, DeviceVector, GPUBackend, device_matrix, make_spmv_fn

CPU = GPUBackend(device="cpu")
NODES = (4, 4, 4)
NPARTS = 4
#: the JAX package's switches that stand for the port's ``lowering``
ENV = {"auto": {}, "bsr": {"PA_TPU_SD": "0"}, "ell": {"PA_TPU_SD": "0", "PA_TPU_BSR": "0"}}
LOWERINGS = list(ENV)


def _jax_lowering(A, backend, env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return JaxDeviceMatrix(A, backend)
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _arrays(t):
    return None if t is None else [np.asarray(a) for a in t] if isinstance(t, tuple) else np.asarray(t)


def _export_range(r):
    isets = r.partition.part_values()
    return {"lid_to_gid": [np.asarray(i.lid_to_gid) for i in isets],
            "lid_to_part": [np.asarray(i.lid_to_part) for i in isets]}


def export(A, xh):
    return {"ngids": A.rows.ngids, "rows": _export_range(A.rows), "cols": _export_range(A.cols),
            "csr": [(M.indptr, M.indices, M.data, M.shape) for M in A.values.part_values()],
            "xh": [np.asarray(v) for v in xh.values.part_values()]}


def carry(parts, e):
    """The exported operator and x̂ as port objects (index sets from the lid
    maps: the Morton partition is not Cartesian)."""
    rows = interop.prange_from_arrays(parts, e["ngids"], e["rows"]["lid_to_gid"], e["rows"]["lid_to_part"])
    cols = interop.prange_from_arrays(parts, e["ngids"], e["cols"]["lid_to_gid"], e["cols"]["lid_to_part"])
    return interop.psparse_from_csr(rows, cols, e["csr"]), interop.pvector_from_values(cols, e["xh"])


def _owned(y, isets):
    return np.concatenate([np.asarray(y)[p, : i.num_oids] for p, i in enumerate(isets)])


def jax_reference(nodes, nparts):
    """The JAX package's lowerings of the elasticity operator: the resolved
    lowering, the staged arrays and the SpMV product of x̂ (owned rows in
    part order), per ``lowering``."""

    def driver(parts):
        A, b, xh, x0 = jax_assemble_elasticity_tet(parts, nodes)
        out = {"system": export(A, xh)}
        isets = A.rows.partition.part_values()
        for name, env in ENV.items():
            dA = _jax_lowering(A, parts.backend, env)
            dx = JaxDeviceVector.from_pvector(xh, parts.backend, dA.col_layout)
            out[name] = {
                "lowering": "sd" if dA.sd_bs else "bsr" if dA.bsr_bs else "ell",
                "sd_bs": dA.sd_bs, "sd_g": dA.sd_g, "sd_idx": _arrays(dA.sd_idx), "sd_vals": _arrays(dA.sd_vals),
                "bsr_bs": dA.bsr_bs, "bsr_cols": _arrays(dA.bsr_cols), "bsr_vals": _arrays(dA.bsr_vals),
                "ohb_bs": dA.ohb_bs, "ohb_rows": _arrays(dA.ohb_rows), "ohb_cols": _arrays(dA.ohb_cols),
                "ohb_vals": _arrays(dA.ohb_vals), "oo_vals": _arrays(dA.oo_vals), "oo_cols": _arrays(dA.oo_cols),
                "oh_rows": _arrays(dA.oh_rows), "oh_vals": _arrays(dA.oh_vals), "oh_cols": _arrays(dA.oh_cols),
                "y": _owned(jax_make_spmv_fn(dA)(dx.data), isets),
            }
        return out

    return pa.prun(driver, pa.tpu, nparts)


@pytest.fixture(scope="module")
def reference():
    return jax_reference(NODES, NPARTS)


def port_lowering(e, lowering):
    def driver(parts):
        A, xh = carry(parts, e)
        dA = device_matrix(A, parts.backend, lowering=lowering)
        dx = DeviceVector.from_pvector(xh, parts.backend, dA.col_layout)
        y = _owned(make_spmv_fn(dA)(dx.data).numpy(), A.rows.partition.part_values())
        return dA, y, np.concatenate([np.asarray(v)[: i.num_oids] for i, v in zip(
            A.rows.partition.part_values(), (A @ xh).values.part_values())])

    return pt.prun(driver, CPU, NPARTS)


def _t(seq):
    return [t.numpy() for t in seq]


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_lowering_resolves_as_jax(reference, lowering):
    """auto resolves to SD, ``"bsr"`` to BSR (bs 3), ``"ell"`` to ELL, as
    the JAX package does by default and with PA_TPU_SD=0 / PA_TPU_BSR=0;
    the boundary takes node blocks (bs 3) exactly where it does."""
    ref = reference[lowering]
    dA, _, _ = port_lowering(reference["system"], lowering)
    assert dA.lowering == ref["lowering"] == {"auto": "sd"}.get(lowering, lowering)
    assert dA.dia_mode is None
    assert (dA.sd_bs, dA.bsr_bs, dA.ohb_bs) == (ref["sd_bs"], ref["bsr_bs"], ref["ohb_bs"])
    if lowering != "ell":
        assert dA.ohb_bs == 3 and dA.oh_vals is None
        # the node-block boundary carries real rows on more than one part
        trash = dA.row_layout.trash
        parts_with_rows = {p for rows in dA.ohb_rows for p in range(rows.shape[0]) if (rows[p] != trash).any()}
        assert len(parts_with_rows) > 1
    else:
        assert dA.ohb_bs is None and dA.oh_vals is not None


def test_sd_staging_matches_jax(reference):
    """SD: the group size, the buckets' external unions and their densified
    group blocks (widths and values) equal the JAX package's."""
    ref = reference["auto"]
    dA, _, _ = port_lowering(reference["system"], "auto")
    assert (dA.sd_bs, dA.sd_g) == (ref["sd_bs"], ref["sd_g"]) == (3, gi.SD_GROUP)
    assert len(dA.sd_idx) == len(ref["sd_idx"])
    for mine, theirs in zip(_t(dA.sd_idx), ref["sd_idx"]):
        np.testing.assert_array_equal(mine, theirs)
    assert [v.shape[-1] for v in dA.sd_vals] == [v.shape[-1] for v in ref["sd_vals"]]
    for mine, theirs in zip(_t(dA.sd_vals), ref["sd_vals"]):
        np.testing.assert_array_equal(mine, theirs)


def test_bsr_staging_matches_jax(reference):
    """BSR: the node columns and the 3x3 blocks, through the inverse of E2's
    slot-major layout, equal the JAX package's; the counts are the real
    blocks of each node row, every block past them the JAX package's pad
    (value 0, node 0)."""
    ref = reference["bsr"]
    dA, _, _ = port_lowering(reference["system"], "bsr")
    assert dA.bsr_vals.shape[1:4] == (ref["bsr_vals"].shape[2], 3, 3) and dA.bsr_cols.dtype == torch.int32
    np.testing.assert_array_equal(irr.bsr_row_major(dA.bsr_cols).numpy(), ref["bsr_cols"])
    np.testing.assert_array_equal(irr.bsr_row_major(dA.bsr_vals).numpy(), ref["bsr_vals"])
    Lb = ref["bsr_cols"].shape[2]
    pad = np.arange(Lb)[None, None, :] >= dA.bsr_counts.numpy()[..., None]
    assert not ref["bsr_vals"][pad].any() and not ref["bsr_cols"][pad].any()
    real = ~pad
    assert (np.abs(ref["bsr_vals"]).reshape(*pad.shape, 9).max(axis=3)[real] > 0).all()


@pytest.mark.parametrize("lowering", ["auto", "bsr"])
def test_node_block_boundary_matches_jax(reference, lowering):
    """The node-block A_oh: per bucket the boundary row slots (pads at the
    trash slot), ghost node columns and blocks equal the JAX package's."""
    ref = reference[lowering]
    dA, _, _ = port_lowering(reference["system"], lowering)
    assert len(dA.ohb_rows) == len(ref["ohb_rows"])
    for name in ("ohb_rows", "ohb_cols", "ohb_vals"):
        for mine, theirs in zip(_t(getattr(dA, name)), ref[name]):
            np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("lowering", ["auto", "bsr"])
def test_node_block_boundary_is_one_buffer_an_array(reference, lowering):
    """E2's boundary mode launches once over every bucket: each staged array
    is one flat buffer, the buckets its views laid end to end in bucket
    order, which address every bucket as the per-bucket arrays did."""
    dA, _, _ = port_lowering(reference["system"], lowering)
    assert len(dA.ohb_rows) > 1
    for name in ("ohb_rows", "ohb_cols", "ohb_vals"):
        views = getattr(dA, name)
        base, offs = irr._offsets(name, views)
        assert offs == list(np.cumsum([0] + [v.numel() for v in views[:-1]]))
        assert all(v.is_contiguous() for v in views)


def test_ell_staging_matches_jax(reference):
    """ELL: the padded A_oo values equal the JAX package's (P, no_max, L),
    read through the inverse of E1's slot-major (P, L, no_max) layout."""
    dA, _, _ = port_lowering(reference["system"], "ell")
    assert dA.oo_vals.shape[1:] == reference["ell"]["oo_vals"].shape[:0:-1]
    np.testing.assert_array_equal(irr.ell_row_major(dA.oo_vals).numpy(), reference["ell"]["oo_vals"])


def test_ell_staging_round_trips_to_jax(reference):
    """ELL: the int32 slot columns of A_oo, and the boundary-row A_oh (rows,
    values, int32 columns), read through the inverse of the slot-major
    layout, equal the JAX package's (P, n, L) arrays."""
    dA, _, _ = port_lowering(reference["system"], "ell")
    ref = reference["ell"]
    assert dA.oo_cols.dtype == dA.oh_cols.dtype == torch.int32
    np.testing.assert_array_equal(irr.ell_row_major(dA.oo_cols).numpy(), ref["oo_cols"])
    np.testing.assert_array_equal(dA.oh_rows.numpy(), ref["oh_rows"])
    np.testing.assert_array_equal(irr.ell_row_major(dA.oh_vals).numpy(), ref["oh_vals"])
    np.testing.assert_array_equal(irr.ell_row_major(dA.oh_cols).numpy(), ref["oh_cols"])


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_spmv_matches_jax_and_host(reference, lowering):
    """Each lowering's product of x̂ against the JAX package's in the same
    lowering and against the port's host product, to 1e-12."""
    _, y, host = port_lowering(reference["system"], lowering)
    np.testing.assert_allclose(y, reference[lowering]["y"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, host, rtol=1e-12, atol=1e-12)


def test_sd_buckets_match_jax():
    """(8,8,8) nodes on one part: more than one SD width bucket, the
    bucket widths and unions of the JAX package, and the product."""
    ref = jax_reference((8, 8, 8), 1)
    e = ref["system"]

    def driver(parts):
        A, xh = carry(parts, e)
        dA = device_matrix(A, parts.backend)
        dx = DeviceVector.from_pvector(xh, parts.backend, dA.col_layout)
        return dA, _owned(make_spmv_fn(dA)(dx.data).numpy(), A.rows.partition.part_values())

    dA, y = pt.prun(driver, CPU, 1)
    widths = [v.shape[-1] for v in dA.sd_vals]
    assert dA.lowering == "sd" and len(widths) > 1
    assert widths == [v.shape[-1] for v in ref["auto"]["sd_vals"]]
    assert min(widths) < max(widths)
    for mine, theirs in zip(_t(dA.sd_idx), ref["auto"]["sd_idx"]):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_allclose(y, ref["auto"]["y"], rtol=1e-12, atol=1e-12)


def test_lowering_keyword_is_checked():
    def driver(parts):
        A = pt.assemble_elasticity_tet(parts, (3, 3, 3))[0]
        with pytest.raises(AssertionError, match="lowering is one of"):
            device_matrix(A, parts.backend, lowering="dense")
        with pytest.raises(AssertionError, match="strict mode takes the ELL lowering"):
            DeviceMatrix(A, parts.backend, strict=True, lowering="bsr")
        return True

    assert pt.prun(driver, CPU, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3, 4])
def test_bsr_plain_is_the_ascending_fold(bs, dtype):
    """E2's plain version: row i of node n sums its blocks' row i against
    the gathered node values in ascending (block, column) order, each
    product rounded, agreeing with a float64 einsum to rounding; the
    boundary form adds that sum once into the target rows and leaves the
    trash slot as it was (+0.0 added)."""
    rng = np.random.default_rng(bs)
    P, nn, Lb = 2, 7, 4
    vals = torch.from_numpy(rng.standard_normal((P, nn, Lb, bs, bs))).to(dtype)
    cols = torch.from_numpy(rng.integers(0, nn, (P, nn, Lb)))
    x = torch.from_numpy(rng.standard_normal((P, nn * bs + 5))).to(dtype)
    y = irr.bsr_spmv_plain(vals, cols, x, 2, 1, nn * bs + 3)
    xn = x[:, 2 : 2 + nn * bs].reshape(P, nn, bs)
    want = torch.zeros((P, nn, bs), dtype=dtype)
    for p in range(P):
        for n in range(nn):
            for i in range(bs):
                acc = None
                for l in range(Lb):
                    for j in range(bs):
                        t = vals[p, n, l, i, j] * xn[p, cols[p, n, l], j]
                        acc = t if acc is None else acc + t
                want[p, n, i] = acc
    assert torch.equal(y[:, 1 : 1 + nn * bs], want.reshape(P, -1))
    assert not y[:, :1].any() and not y[:, 1 + nn * bs :].any()
    ref = np.einsum("pnlij,pnlj->pni", vals.double().numpy(), xn.double().numpy()[np.arange(P)[:, None, None],
                                                                                 cols.numpy()])
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(want.double().numpy(), ref, rtol=tol, atol=tol)
    rows = torch.from_numpy(np.stack([rng.permutation(nn * bs)[: nn * bs] for _ in range(P)]).reshape(P, nn, bs))
    rows[:, -1] = nn * bs  # the last node pads at the trash slot
    y0 = torch.from_numpy(rng.standard_normal((P, nn * bs + 1))).to(dtype)
    got = irr.bsr_spmv_boundary_plain(rows, vals, cols, x, 2, nn, y0.clone(), nn * bs)
    exp = y0.clone()
    for p in range(P):
        for n in range(nn - 1):
            for i in range(bs):
                exp[p, rows[p, n, i]] = exp[p, rows[p, n, i]] + want[p, n, i]
    assert torch.equal(got, exp)
