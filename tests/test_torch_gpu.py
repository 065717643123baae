"""The port's DeviceMatrix, SpMV and halo exchange
(partitionedarrays_jl_tpu_torch/parallel/gpu.py) against the JAX package's
TPU backend on the 8-device CPU mesh and against the host oracles.

The port runs on ``GPUBackend(device="cpu")``, where the coded-DIA kernels
take their plain PyTorch versions. Inputs come from numpy with a seed."""
import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_poisson as jax_assemble_poisson
from partitionedarrays_jl_tpu.models import gather_pvector as jax_gather_pvector
from partitionedarrays_jl_tpu.parallel.tpu import (
    DeviceVector as JaxDeviceVector,
    device_matrix as jax_device_matrix,
    make_spmv_fn as jax_make_spmv_fn,
)
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    device_matrix,
    make_exchange_fn,
    make_spmv_fn,
)

CPU = GPUBackend(device="cpu")
NS = (48, 48, 48)


def _random_on(rows, xg):
    return [xg[np.asarray(i.lid_to_gid)] for i in rows.partition.part_values()]


def _owned_by_gid(frame, rows, ngids):
    out = np.zeros(ngids)
    for p, iset in enumerate(rows.partition.part_values()):
        out[np.asarray(iset.oid_to_gid)] = frame[p, : iset.num_oids]
    return out


@pytest.fixture(scope="module")
def spmv_results():
    ngids = int(np.prod(NS))
    xg = np.random.default_rng(17).standard_normal(ngids)

    def jax_driver(parts):
        A, b, xe, x0 = jax_assemble_poisson(parts, NS)
        x = pa.PVector(parts._like(_random_on(A.cols, xg)), A.cols)
        host = jax_gather_pvector(A @ x)
        dA = jax_device_matrix(A, parts.backend)
        dx = JaxDeviceVector.from_pvector(x, parts.backend, dA.col_layout)
        y = np.asarray(jax_make_spmv_fn(dA)(dx.data))
        return host, _owned_by_gid(y, A.rows, ngids), dA

    def port_driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, NS)
        x = pt.PVector(parts._like(_random_on(A.cols, xg)), A.cols)
        host = pt.gather_pvector(A @ x)
        dA = device_matrix(A, parts.backend)
        dx = DeviceVector.from_pvector(x, parts.backend, dA.col_layout)
        y = make_spmv_fn(dA)(dx.data).numpy()
        return host, _owned_by_gid(y, A.rows, ngids), dA

    return {
        "jax": pa.prun(jax_driver, pa.tpu, (2, 2, 2)),
        "port": pt.prun(port_driver, CPU, (2, 2, 2)),
    }


def test_spmv_matches_jax_and_host(spmv_results):
    jax_host, jax_dev, _ = spmv_results["jax"]
    host, dev, _ = spmv_results["port"]
    np.testing.assert_allclose(dev, jax_dev, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(dev, host, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(host, jax_host, rtol=1e-13, atol=1e-13)


def test_lowering_mode_matches_jax(spmv_results):
    jdA = spmv_results["jax"][2]
    dA = spmv_results["port"][2]
    assert jdA.dia_mode == dA.dia_mode == "coded"
    assert (jdA.dia_cls_pattern is None) == (dA.dia_cls_pattern is None)
    assert tuple(jdA.dia_offsets) == dA.dia_offsets
    assert tuple(jdA.dia_kk) == dA.dia_kk
    assert tuple(jdA.dia_code_row) == dA.dia_code_row
    if dA.dia_cls_pattern is not None:
        # class order may differ (first touch vs lexicographic): compare sets
        assert set(jdA.dia_cls_pattern) == set(dA.dia_cls_pattern)


def test_single_part_takes_row_class_mode():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (12, 12, 12))
        dA = device_matrix(A, parts.backend)
        x = DeviceVector.from_pvector(xe, parts.backend, dA.col_layout)
        y = make_spmv_fn(dA)(x.data).numpy()
        return dA, y[0, : A.rows.ngids], pt.gather_pvector(b)

    dA, y, b = pt.prun(driver, CPU, (1, 1, 1))
    assert dA.dia_mode == "coded" and dA.dia_cls_pattern is not None
    assert dA.dia_kk == (2,) * 7 and dA.dia_code_row == (0,) * 7
    np.testing.assert_allclose(y, b, rtol=1e-13, atol=1e-13)


def test_exchange_matches_host():
    def driver(parts):
        r = pt.prange(parts, (12, 12, 12), pt.with_ghost)
        rng = np.random.default_rng(23)
        vals = [
            np.where(np.asarray(i.lid_to_ohid) >= 0, rng.standard_normal(i.num_lids), 0.0)
            for i in r.partition.part_values()
        ]
        v = pt.PVector(parts._like(vals), r)
        dv = DeviceVector.from_pvector(v, parts.backend)
        make_exchange_fn(r, parts.backend)(dv.data)
        got = dv.to_pvector()
        v.exchange()
        for a, b in zip(v.values.part_values(), got.values.part_values()):
            assert np.array_equal(a, b)
        # the trash slot stays an exact zero
        assert not dv.data[:, dv.layout.trash].any()
        return True

    assert pt.prun(driver, CPU, (2, 2, 2))


def test_variable_coefficient_operator_is_refused():
    """A variable-coefficient band (a diagonal with more distinct values
    than the codebook holds) takes the streaming-DIA lowering; an operator
    that is not a band (more than DIA_MAX_OFFSETS diagonals), which the
    band-only lowering refused, takes the padded-ELL lowering (its 2x2 and
    4x4 blocks are too sparse for SD and BSR) and multiplies exactly."""

    def driver(parts):
        rows = pt.prange(parts, 200)
        ids = parts._like([np.arange(p * 100, p * 100 + 100) for p in range(2)])
        V = parts._like([1.0 + np.arange(100.0) for _ in range(2)])
        A = pt.PSparseMatrix.from_coo(ids, parts._like([i.copy() for i in ids.part_values()]), V, rows, rows)
        dA = device_matrix(A, parts.backend)
        assert dA.dia_mode == "stream" and dA.dia_offsets == (0,)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, dA.col_layout.W)))
        y = make_spmv_fn(dA)(x.clone()).numpy()
        np.testing.assert_array_equal(y[:, :100], (1.0 + np.arange(100.0)) * x[:, :100].numpy())
        # each part's rows in reverse: 100 distinct offsets
        rev = parts._like([p * 100 + 99 - np.arange(100) for p in range(2)])
        ids = parts._like([np.arange(p * 100, p * 100 + 100) for p in range(2)])
        B = pt.PSparseMatrix.from_coo(ids, rev, V, pt.prange(parts, 200), pt.prange(parts, 200))
        dB = device_matrix(B, parts.backend)
        assert dB.dia_mode is None and dB.lowering == "ell"
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, dB.col_layout.W)))
        y = make_spmv_fn(dB)(x.clone()).numpy()
        np.testing.assert_array_equal(y[:, :100], (1.0 + np.arange(100.0)) * x.numpy()[:, 99::-1])
        return True

    assert pt.prun(driver, CPU, 2)


def test_spmv_rejects_wrong_frame():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        dA = device_matrix(A, parts.backend)
        with pytest.raises(AssertionError, match="laid out"):
            make_spmv_fn(dA)(torch.zeros(1, 3, dtype=torch.float64))
        return True

    assert pt.prun(driver, CPU, (1, 1, 1))
