"""The port's Poisson CG slice as a whole (partitionedarrays_jl_tpu_torch)
against the JAX package: the same driver on the port's
``GPUBackend(device="cpu")``, on the JAX package's TPU backend (8-device
CPU mesh) and on its sequential oracle must take equal iteration counts and
reach errors within 1e-12. Also: fused against textbook body, the `cg`
dispatch, the interop round trip, and the port's import hygiene."""
import ast
import pathlib

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu.models import assemble_poisson as jax_assemble_poisson
from partitionedarrays_jl_tpu.models import poisson_fdm_driver as jax_poisson_fdm_driver
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch import interop
from partitionedarrays_jl_tpu_torch.parallel.gpu import (
    DeviceVector,
    GPUBackend,
    device_matrix,
    make_spmv_fn,
)

CPU = GPUBackend(device="cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", [10, 48])
def test_driver_matches_jax(n):
    ns = (n, n, n)
    err_p, info_p = pt.prun(pt.poisson_fdm_driver, CPU, (2, 2, 2), ns, tol=1e-8)
    err_t, info_t = pa.prun(jax_poisson_fdm_driver, pa.tpu, (2, 2, 2), ns, tol=1e-8)
    err_s, info_s = pa.prun(jax_poisson_fdm_driver, pa.sequential, (2, 2, 2), ns, tol=1e-8)
    assert info_p["converged"] and info_p["cg_body"] == "fused"
    assert info_p["iterations"] == info_t["iterations"] == info_s["iterations"]
    assert abs(err_p - err_t) <= 1e-12
    assert abs(err_p - err_s) <= 1e-12
    assert err_p < 1e-5


def test_driver_matches_port_sequential():
    err_g, info_g = pt.prun(pt.poisson_fdm_driver, CPU, (2, 2, 2), (16, 16, 16), tol=1e-8)
    err_s, info_s = pt.prun(pt.poisson_fdm_driver, pt.sequential, (2, 2, 2), (16, 16, 16), tol=1e-8)
    assert info_s["cg_body"] == "host"
    assert info_g["iterations"] == info_s["iterations"]
    assert abs(err_g - err_s) <= 1e-12


def test_fused_matches_standard_body():
    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (20, 20, 20))
        xf, inf_f = pt.cg(A, b, x0=x0, tol=1e-10)
        xs, inf_s = pt.cg(A, b, x0=x0, tol=1e-10, fused=False)
        return inf_f, inf_s, float((xf - xs).norm())

    inf_f, inf_s, diff = pt.prun(driver, CPU, (2, 2, 2))
    assert (inf_f["cg_body"], inf_s["cg_body"]) == ("fused", "standard")
    assert inf_f["iterations"] == inf_s["iterations"]
    assert diff <= 1e-10


def test_cg_dispatches_to_gpu_cg(monkeypatch):
    import importlib

    # the module, not the `gpu` backend instance the package re-exports
    gpu_mod = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")

    calls = []
    real = gpu_mod.gpu_cg

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(gpu_mod, "gpu_cg", spy)

    def driver(parts):
        A, b, xe, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        return pt.cg(A, b, x0=x0, tol=1e-10)[1]

    info = pt.prun(driver, CPU, (1, 1, 1))
    assert len(calls) == 1 and info["cg_body"] == "fused" and info["converged"]


def _export(A, x):
    """The JAX package's objects as plain NumPy arrays."""
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
        "x": [np.asarray(v) for v in x.values.part_values()],
    }


@pytest.mark.parametrize("geometry", ["lid_maps", "boxes"])
def test_interop_round_trip(geometry):
    ns = (12, 12, 12)
    exported = pa.prun(
        lambda parts: _export(*jax_assemble_poisson(parts, ns)[::2]), pa.sequential, (2, 2, 2)
    )

    def prange_of(parts, e):
        box = {"grid_shape": e["grid_shape"], "boxes": e["boxes"]} if geometry == "boxes" else {}
        return interop.prange_from_arrays(
            parts, exported["ngids"], e["lid_to_gid"], e["lid_to_part"], **box
        )

    def driver(parts):
        rows = prange_of(parts, exported["rows"])
        cols = prange_of(parts, exported["cols"])
        A = interop.psparse_from_csr(rows, cols, exported["csr"])
        x = interop.pvector_from_values(cols, exported["x"])
        A2, b2, xe2, x02 = pt.assemble_poisson(parts, ns)
        ys = []
        for M, v in ((A, x), (A2, xe2)):
            dA = device_matrix(M, parts.backend)
            dx = DeviceVector.from_pvector(v, parts.backend, dA.col_layout)
            y = DeviceVector(make_spmv_fn(dA)(dx.data), M.rows, dA.row_layout, parts.backend)
            ys.append(pt.gather_pvector(y.to_pvector()))
        return ys

    y_jax_op, y_port = pt.prun(driver, CPU, (2, 2, 2))
    np.testing.assert_allclose(y_jax_op, y_port, rtol=1e-14, atol=1e-14)


def _port_sources():
    files = sorted((ROOT / "partitionedarrays_jl_tpu_torch").rglob("*.py"))
    tools = ("time_coded_kernels.py", "run_phase_4l.py", "run_phase_4m.py", "run_phase_4n.py",
             "time_sstep_forms.py", "probe_eigh_capture.py", "time_sdc_trip.py")
    return files + [ROOT / "chip_smoke.py"] + [ROOT / "tools" / t for t in tools]


def test_port_sources_hold_the_consoles():
    """The package glob picks up the port's consoles, and every listed tool
    exists."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for console in ("patrace", "paprof", "pamon", "paspec", "paserve", "patx"):
        assert f"partitionedarrays_jl_tpu_torch/tools/{console}.py" in names
    assert all(p.exists() for p in _port_sources())


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """The port and chip_smoke.py import neither jax nor the JAX package
    (a sys.modules check cannot tell: the JAX tests import both)."""
    banned = ("jax", "jaxlib", "partitionedarrays_jl_tpu")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name} imports {name}"


def test_default_backend_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default backend runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.prun(pt.poisson_fdm_driver, GPUBackend(), (1, 1, 1), (4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.gpu.get_part_ids(1)
