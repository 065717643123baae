"""The device α/β trace ring of the port's CG loops and the spectrum layer
(`partitionedarrays_jl_tpu_torch.telemetry.spectrum`), against the JAX
package.

The ring runs on ``GPUBackend(device="cpu")`` against ``pa.tpu`` on the
8-device CPU mesh (``PA_TRACE_ITERS`` there, ``trace_iters=`` here), on
tests/test_torch_pcg.py's decoupled 8^3 Poisson system on (2, 2, 2) parts:

* ring on, off, and on with telemetry off: strict-bits x, history and
  iterations bitwise equal;
* α/β obey the CG recurrence against the residual history (β_k =
  h_{k+1}²/h_k², rtol 1e-12);
* the unrolled ring past its depth (it > Ht) equals the JAX package's
  ``rec.alpha``, ``rec.beta`` and ``trace_start`` to 1e-12 (fused CG,
  standard Jacobi PCG, block CG);
* the kernels a device iteration launches with the ring off are today's
  formula (fused CG: K1 once, K2 and the sweep each iteration; standard:
  K1 1 + one an iteration), and the ring changes none of them;
* under strict bits the block ring's per-column spectra equal the solo
  solves' exactly (tests/test_paspec.py:279); the defended loop's ring is
  the undefended loop's, bit for bit.

The spectrum layer: on the same α/β both packages' `ritz_values`,
`estimate_solve` and `predict_iters` agree to 1e-12; κ̂ from the port's
ring on the analytic Poisson fixture lies inside tools/paspec.py:73's
``KAPPA_RATIO_BAND``; the committed ``SPECTRUM.json`` and
``THROUGHPUT_MODEL.json`` load into equal stores in both packages.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu import telemetry as ja_tel
from partitionedarrays_jl_tpu_torch import telemetry as pt_tel
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.ops import sweep as sw
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.utils.health import SDCConfig

from test_torch_pcg import PARTS, carry_system, export_system, jax_systems

CPU = GPUBackend(device="cpu")
ROOT = Path(__file__).resolve().parents[1]
HT = 16  # below the solves' iterations: the ring wraps
TOL = 1e-8
#: tools/paspec.py:73
KAPPA_RATIO_BAND = (0.5, 1.05)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's traced solves of the decoupled 8^3 system (fused
    CG, standard Jacobi PCG, block CG of b and 1.5 b), and the system."""
    import os

    os.environ["PA_TRACE_ITERS"] = str(HT)
    try:
        def driver(parts):
            A, b = jax_systems(parts)["poisson"]
            b2 = pa.PVector(pa.map_parts(lambda v: v * 1.5, b.values), b.rows)
            out = {"system": export_system(A, b)}
            for name, solve in (("cg", lambda: pa.cg(A, b, tol=TOL, fused=True)),
                                ("pcg", lambda: pa.pcg(A, b, tol=TOL, fused=False))):
                _, info = solve()
                rec = info.record
                out[name] = (int(info["iterations"]), rec.alpha, rec.beta, rec.trace_start,
                             np.asarray(info["residuals"]))
            _, info = pa.cg(A, B=[b, b2], tol=TOL)
            rec = info.record
            out["block"] = (info["iterations_per_column"], rec.alpha, rec.beta, rec.trace_start)
            return out

        return pa.prun(driver, pa.tpu, PARTS)
    finally:
        del os.environ["PA_TRACE_ITERS"]


def _port(reference, fn):
    def driver(parts):
        A, b = carry_system(parts, reference["system"])
        return fn(A, b)

    return pt.prun(driver, CPU, PARTS)


@pytest.mark.parametrize("name", ["cg", "pcg"])
def test_unrolled_ring_matches_jax(reference, name):
    """The wrapped ring (it > Ht), unrolled onto the record: the JAX
    package's alpha, beta and trace_start to 1e-12."""
    def fn(A, b):
        if name == "cg":
            _, info = pt.cg(A, b, tol=TOL, fused=True, trace_iters=HT)
        else:
            _, info = pt.pcg(A, b, tol=TOL, fused=False, trace_iters=HT)
        rec = info.record
        return int(info["iterations"]), rec.alpha, rec.beta, rec.trace_start, info["cg_body"]

    it, alpha, beta, start, body = _port(reference, fn)
    want = reference[name]
    assert body == ("fused" if name == "cg" else "standard")
    assert it == want[0] > HT
    assert start == want[3] == it - HT and len(alpha) == len(want[1]) == HT
    np.testing.assert_allclose(alpha, want[1], rtol=1e-12, atol=0)
    np.testing.assert_allclose(beta, want[2], rtol=1e-12, atol=0)


def test_block_ring_matches_jax(reference):
    """The block ring (Ht, 2, K) unrolled per column, frozen trips masked
    None: the JAX package's lists to 1e-12, the same masks."""
    def fn(A, b):
        b2 = pt.PVector(pt.map_parts(lambda v: v * 1.5, b.values), b.rows)
        _, info = pt.cg(A, B=[b, b2], tol=TOL, trace_iters=HT)
        rec = info.record
        return info["iterations_per_column"], rec.alpha, rec.beta, rec.trace_start

    its, alpha, beta, start = _port(reference, fn)
    want_its, want_a, want_b, want_start = reference["block"]
    assert its == want_its and start == want_start
    for got, want in ((alpha, want_a), (beta, want_b)):
        for gk, wk in zip(got, want):
            assert [v is None for v in gk] == [v is None for v in wk]
            np.testing.assert_allclose([v for v in gk if v is not None], [v for v in wk if v is not None],
                                       rtol=1e-12, atol=0)


def test_ring_obeys_cg_recurrence(reference):
    """A whole-solve ring (Ht >= iterations, trace_start 0): β_k equals
    h_{k+1}²/h_k² of the residual history (rtol 1e-12), α_k > 0."""
    def fn(A, b):
        _, info = pt.cg(A, b, tol=TOL, trace_iters=4096)
        return info.record.alpha, info.record.beta, info.record.trace_start, np.asarray(info["residuals"])

    alpha, beta, start, h = _port(reference, fn)
    assert start == 0 and len(alpha) == len(h) - 1
    assert all(a > 0 for a in alpha)
    np.testing.assert_allclose(beta, (h[1:] / h[:-1]) ** 2, rtol=1e-12, atol=0)


def test_ring_changes_no_bit_of_the_solve(reference):
    """Strict bits: ring off, ring on, and ring on with telemetry off give
    the same x, history and iterations, bit for bit (the JAX package's
    "telemetry off is free" pin, here in results)."""
    def fn(A, b):
        out = []
        for ht, metrics in ((0, True), (HT, True), (HT, False)):
            with pt_tel.configure(metrics=metrics):
                x, info = pt.cg(A, b, tol=TOL, strict=True, trace_iters=ht)
            out.append((pt.gather_pvector(x), np.asarray(info["residuals"]), info["iterations"],
                        info.record.alpha is not None))
        return out

    runs = _port(reference, fn)
    assert [r[3] for r in runs] == [False, True, False]  # an inert record keeps no ring
    for x, h, it, _ in runs[1:]:
        np.testing.assert_array_equal(x, runs[0][0])
        np.testing.assert_array_equal(h, runs[0][1])
        assert it == runs[0][2]


@pytest.mark.parametrize("body", ["fused", "standard", "block"])
def test_launch_formula_with_and_without_ring(reference, monkeypatch, body):
    """The kernels a solve launches (counted at their wrappers, which the
    CPU runs as plain versions) with the ring off are today's formula per
    device iteration, and the traced solve launches exactly the same."""
    if body == "block":
        names = {"dia_coded_spmm": dia, "dia_coded_spmm_pfold": dia, "cg_sweep_block": sw, "block_products": sw}
    else:
        names = {"dia_coded_spmv": dia, "dia_coded_spmv_pfold": dia, "cg_sweep": sw}
    counts = {n: 0 for n in names}
    for name, mod in names.items():
        f = getattr(mod, name)

        def wrapped(*a, _f=f, _k=name, **k):
            counts[_k] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    def fn(A, b):
        out = []
        for ht in (0, HT):
            for k in counts:
                counts[k] = 0
            if body == "block":
                b2 = pt.PVector(pt.map_parts(lambda v: v * 1.5, b.values), b.rows)
                _, info = pt.cg(A, B=[b, b2], tol=TOL, trace_iters=ht)
            else:
                _, info = pt.cg(A, b, tol=TOL, fused=body == "fused", trace_iters=ht)
            out.append((dict(counts), info["device_loop"]["device_iterations"]))
        return out

    (off, n_off), (on, n_on) = _port(reference, fn)
    assert off == on and n_off == n_on
    if body == "fused":
        assert off == {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": n_off, "cg_sweep": n_off}
    elif body == "standard":
        assert off == {"dia_coded_spmv": 1 + n_off, "dia_coded_spmv_pfold": 0, "cg_sweep": n_off}
    else:
        assert off["dia_coded_spmm"] == 1 and off["dia_coded_spmm_pfold"] == n_off
        assert off["cg_sweep_block"] == n_off and off["block_products"] >= n_off


def test_block_ring_spectra_equal_solo_strict():
    """Strict bits: each block column's ring is its solo solve's, so the
    reconstructed spectra are equal exactly (tests/test_paspec.py:279)."""
    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (6, 6, 6))
        b2 = pt.PVector(pt.map_parts(lambda v: v * 1.5, b.values), b.rows)
        _, binfo = pt.cg(A, B=[b, b2], X0=[x0, x0], tol=1e-9, maxiter=100, strict=True, trace_iters=128)
        brec = binfo.record
        assert isinstance(brec.alpha[0], list) and len(brec.alpha) == 2
        for k, bk in enumerate((b, b2)):
            _, sinfo = pt.cg(A, bk, x0=x0, tol=1e-9, maxiter=100, strict=True, trace_iters=128)
            eb = pt_tel.estimate_solve(brec.alpha[k], brec.beta[k], binfo["columns"][k]["residuals"])
            es = pt_tel.estimate_solve(sinfo.record.alpha, sinfo.record.beta, sinfo["residuals"])
            assert eb["ritz_k"] == es["ritz_k"] > 0
            assert (eb["lam_min"], eb["lam_max"], eb["kappa"]) == (es["lam_min"], es["lam_max"], es["kappa"])
        return True

    assert pt.prun(driver, CPU, PARTS)


def test_defended_ring_is_the_undefended_ring(reference):
    """The SDC-defended loop writes the ring on commit trips only: a clean
    defended solve's ring (audits every 5 trips) is the undefended one's."""
    def fn(A, b):
        rings = []
        for sdc in (None, SDCConfig(audit_every=5)):
            _, info = pt.cg(A, b, tol=TOL, fused=False, sdc=sdc, trace_iters=HT)
            rings.append((info.record.alpha, info.record.beta, info.record.trace_start))
        return rings, info["sdc"]

    (plain, defended), sdc = _port(reference, fn)
    assert sdc["audit_iterations"] > 0 and sdc["detections"] == 0
    assert plain == defended


def test_trace_unavailable_names_the_body(reference):
    """The pipelined body has no ring: a requested depth emits a typed
    ``trace_unavailable`` event naming it, and the solve has no α/β."""
    def fn(A, b):
        x, info = pt.cg(A, b, tol=TOL, pipelined=True, trace_iters=HT)
        return [(e.kind, e.label) for e in info.record.events], info.record.alpha

    events, alpha = _port(reference, fn)
    assert ("trace_unavailable", "pipelined") in events and alpha is None


# ---------------------------------------------------------------------------
# the spectrum layer against the JAX package's
# ---------------------------------------------------------------------------


def test_spectrum_functions_match_jax(reference):
    """On the JAX package's own recorded α/β and history (whole and
    trailing window): ritz_values, estimate_solve and predict_iters agree
    to 1e-12 (iterations exactly)."""
    _, alpha, beta, start, hist = reference["cg"]
    for a, b, s in ((alpha, beta, start), (alpha, beta, 0), (alpha[:5], beta[:5], 0)):
        rj = ja_tel.ritz_values(a, b, trace_start=s)
        rp = pt_tel.ritz_values(a, b, trace_start=s)
        np.testing.assert_allclose(rp, rj, rtol=1e-12, atol=0)
        ej = ja_tel.estimate_solve(a, b, hist, trace_start=s)
        ep = pt_tel.estimate_solve(a, b, hist, trace_start=s)
        assert ep.keys() == ej.keys()
        for k in ej:
            np.testing.assert_allclose(ep[k], ej[k], rtol=1e-12, atol=0)
        spec = {"rate": ej["rate"], "kappa": ej["kappa"], "samples": 2}
        for tol in (1e-4, 1e-6, 1e-8, 1e-12):
            assert pt_tel.predict_iters(spec, tol, r0_norm=float(hist[0])) == \
                ja_tel.predict_iters(spec, tol, r0_norm=float(hist[0]))
    assert pt_tel.poisson_fdm_analytic_extremes((8, 8, 8)) == ja_tel.poisson_fdm_analytic_extremes((8, 8, 8))
    for kappa in (None, 1.0, 10.0, 1e4):
        assert pt_tel.suggest_s({"kappa": kappa}, "float32") == ja_tel.suggest_s({"kappa": kappa}, "float32")


def test_kappa_from_port_ring_inside_analytic_band():
    """tools/paspec.py's probe on the port: the 8^3 Poisson fixture's CG
    (boundary values in x0, so the Krylov space stays on the interior
    block) traced with depth 256: κ̂ / κ_analytic inside KAPPA_RATIO_BAND,
    the Ritz interval inside the analytic spectrum; the store takes it."""
    pt_tel.reset_store()

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        _, info = pt.cg(A, b, x0=x0, tol=1e-9, maxiter=200, trace_iters=256)
        est = pt_tel.estimate_solve(info.record.alpha, info.record.beta, info["residuals"])
        return est, pt_tel.spectrum_store().spec(pt_tel.spectrum_fingerprint(A), "float64", "none")

    est, spec = pt.prun(driver, CPU, PARTS)
    lo, hi = pt_tel.poisson_fdm_analytic_extremes((8, 8, 8))
    ratio = est["kappa"] / (hi / lo)
    assert KAPPA_RATIO_BAND[0] <= ratio <= KAPPA_RATIO_BAND[1], ratio
    assert est["lam_min"] >= 0.99 * lo and est["lam_max"] <= 1.01 * hi
    assert spec is not None and spec["samples"] == 1 and spec["kappa"] == est["kappa"]


@pytest.mark.parametrize("artifact", ["SPECTRUM.json", "THROUGHPUT_MODEL.json"])
def test_committed_models_load_into_equal_stores(artifact):
    """The JAX package's committed tables load into the port's store and
    model and export what the JAX package's load exports."""
    rec = json.loads((ROOT / artifact).read_text())
    if artifact == "SPECTRUM.json":
        rec = rec.get("store", rec)
        want = ja_tel.SpectrumStore.load(rec).export()
        got = pt_tel.SpectrumStore.load(rec).export()
    else:
        rec = rec.get("model", rec)
        want = ja_tel.ThroughputModel.load(rec).export()
        got = pt_tel.ThroughputModel.load(rec).export()
    assert want["entries"] and got == want
