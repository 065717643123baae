"""The port's stationary GMG solve on the card, the W-cycle, coarse-level
agglomeration and GMG-PCG with ``lowering=``, against the JAX package
(tests/test_gmg.py:88, :248, :405, :729), on ``GPUBackend(device="cpu")``
(the device loops with the kernels' plain versions) and the port's
sequential backend, at the JAX tests' sizes.

Gates: the JAX tests' own (converged, max error < 1e-6, PCG within 20
iterations, W no more iterations than V, four coarse solves in a depth-3
W-cycle); iterations equal to the JAX package's sequential loop and to the
port's host loop; agglomerated and full-mesh hierarchies equal in
iterations and within 1e-10 in x (the Galerkin products of the two
placements round apart); the lowering keyword equal in iterations and x
bit for bit on these band operators, which take their band lowering
whatever it names.
"""
import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg
from partitionedarrays_jl_tpu_torch.parallel.gpu import STATS as GPU_STATS
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

CPU = GPUBackend(device="cpu")


def _system(m, parts, ns):
    A, b, xe, _ = m.assemble_poisson(parts, ns)
    Ah, bh = m.decouple_dirichlet(A, b)
    return Ah, bh, xe


def _err(m, x, xe):
    return float(np.abs(m.gather_pvector(x) - m.gather_pvector(xe)).max())


def test_gmg_solve_on_the_device_loop():
    """tests/test_gmg.py:88: 20^3 on (2,2,2), coarse_threshold 200, pre =
    post = 2: gmg_solve converges to max error < 1e-6 in the JAX package's
    iterations, on the device loop and the host loop alike; the hierarchy
    as PCG's minv in <= 20 iterations; a second solve builds no function."""
    ns = (20, 20, 20)

    def driver(m, parts):
        Ah, bh, xe = _system(m, parts, ns)
        h = m.gmg_hierarchy(parts, Ah, ns, coarse_threshold=200, pre=2, post=2)
        assert len(h.levels) >= 2
        x, info = m.gmg_solve(h, bh, tol=1e-9)
        xp, ip = m.pcg(Ah, bh, minv=h, tol=1e-9)
        out = (info["iterations"], info["converged"], _err(m, x, xe), ip["iterations"], ip["converged"],
               _err(m, xp, xe))
        if m is pt and isinstance(parts.backend, GPUBackend):
            built = GPU_STATS["solve_fns"]
            x2, info2 = m.gmg_solve(h, bh, tol=1e-9)
            assert GPU_STATS["solve_fns"] == built
            assert np.array_equal(m.gather_pvector(x2), m.gather_pvector(x))
            assert info["device_loop"]["loop"] == "eager" and info["cycle"] == "v"
        return out

    want = pa.prun(lambda p: driver(pa, p), pa.sequential, (2, 2, 2))
    for backend in (pt.sequential, CPU):
        it, conv, err, itp, convp, errp = pt.prun(lambda p: driver(pt, p), backend, (2, 2, 2))
        assert conv and err < 1e-6 and convp and itp <= 20 and errp < 1e-6
        assert it == want[0] and itp == want[3], (backend, it, itp, want)


def test_w_cycle_host_and_device():
    """tests/test_gmg.py:248: 20^3 on (2,2,2), coarse_threshold 30 (three
    levels): the W-cycle takes no more stationary iterations than the
    V-cycle, the device loop the host loop's and the JAX package's, error
    < 1e-6; one W-cycle visits the coarse solver 2^(L-1) = 4 times; the
    W-cycle runs under PCG and FGMRES on the card too."""
    ns = (20, 20, 20)

    def driver(m, parts, cycle):
        Ah, bh, xe = _system(m, parts, ns)
        h = m.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30, cycle=cycle)
        assert len(h.levels) >= 3
        x, info = m.gmg_solve(h, bh, tol=1e-9)
        assert info["converged"] and _err(m, x, xe) < 1e-6
        return info["iterations"]

    it_v = pt.prun(lambda p: driver(pt, p, "v"), pt.sequential, (2, 2, 2))
    it_w = pt.prun(lambda p: driver(pt, p, "w"), pt.sequential, (2, 2, 2))
    assert it_w <= it_v, (it_w, it_v)
    assert pt.prun(lambda p: driver(pt, p, "w"), CPU, (2, 2, 2)) == it_w
    assert pa.prun(lambda p: driver(pa, p, "w"), pa.sequential, (2, 2, 2)) == it_w

    def count_coarse(parts):
        Ah, bh, _ = _system(pt, parts, ns)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30, cycle="w")
        assert len(h.levels) == 3
        calls = []
        orig = h.coarse_solver.solve
        h.coarse_solver.solve = lambda v: (calls.append(1), orig(v))[1]
        h.vcycle(bh)
        return len(calls)

    assert pt.prun(count_coarse, pt.sequential, (2, 2, 2)) == 4

    def krylov(m, parts):
        Ah, bh, xe = _system(m, parts, ns)
        h = m.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30)
        hw = h.with_cycle("w") if m is pt else m.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30, cycle="w")
        xp, ip = m.pcg(Ah, bh, minv=hw, tol=1e-9)
        xf, jf = m.fgmres(Ah, bh, minv=hw, restart=10, tol=1e-9)
        return ip["iterations"], _err(m, xp, xe), jf["iterations"], _err(m, xf, xe)

    want = pa.prun(lambda p: krylov(pa, p), pa.sequential, (2, 2, 2))
    for backend in (pt.sequential, CPU):
        itp, errp, itf, errf = pt.prun(lambda p: krylov(pt, p), backend, (2, 2, 2))
        assert errp < 1e-6 and errf < 1e-6
        assert itp == want[0] and abs(itf - want[2]) <= 1, (backend, itp, itf, want)


def test_with_cycle_shares_the_staging():
    """`GMGHierarchy.with_cycle` shares the levels and the device staging:
    the W hierarchy of a staged V hierarchy stages nothing."""
    ns = (16, 16, 16)

    def driver(parts):
        Ah, bh, _ = _system(pt, parts, ns)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30)
        pt.gmg_solve(h, bh, tol=1e-8)
        staged = gpu_gmg.STATS["stagings"]
        hw = h.with_cycle("w")
        assert hw.levels is h.levels and hw.cycle == "w" and h.cycle == "v"
        x, info = pt.gmg_solve(hw, bh, tol=1e-8)
        assert gpu_gmg.STATS["stagings"] == staged and info["converged"] and info["cycle"] == "w"
        return True

    assert pt.prun(driver, CPU, (2, 2, 2))


def _agg_driver(m, parts, agg, ns=(24, 24, 24)):
    Ah, bh, xe = _system(m, parts, ns)
    h = m.gmg_hierarchy(parts, Ah, ns, coarse_threshold=100, agg_threshold=agg)
    if agg:
        assert any(min(i.num_oids for i in lvl.A.rows.partition.part_values()) == 0
                   and lvl.A.rows.ngids >= lvl.A.rows.num_parts for lvl in h.levels[1:]) or \
            min(i.num_oids for i in h.coarse_A.rows.partition.part_values()) == 0
    x, info = m.gmg_solve(h, bh, tol=1e-9)
    xp, ip = m.pcg(Ah, bh, minv=h, tol=1e-9)
    assert info["converged"] and ip["converged"]
    assert _err(m, x, xe) < 1e-6 and _err(m, xp, xe) < 1e-6
    return info["iterations"], ip["iterations"], m.gather_pvector(x), m.gather_pvector(xp)


def test_agglomeration_iteration_parity():
    """tests/test_gmg.py:405: 24^3 on (2,2,2), coarse_threshold 100,
    agg_threshold 2000 against 0: some coarse partition has empty parts,
    and the stationary and PCG iterations and solutions equal the full-mesh
    hierarchy's, on the device loop and the host loop; the JAX package's
    iterations."""
    want = pa.prun(lambda p: _agg_driver(pa, p, 2000), pa.sequential, (2, 2, 2))
    for backend in (pt.sequential, CPU):
        full = pt.prun(lambda p: _agg_driver(pt, p, 0), backend, (2, 2, 2))
        agg = pt.prun(lambda p: _agg_driver(pt, p, 2000), backend, (2, 2, 2))
        assert full[:2] == agg[:2] == want[:2], (backend, full[:2], agg[:2], want[:2])
        np.testing.assert_allclose(agg[2], full[2], atol=1e-10)
        np.testing.assert_allclose(agg[3], full[3], atol=1e-10)


def test_agglomerated_levels_keep_the_box_plan():
    """tests/test_gmg.py:729: 16^3 on (2,2,2), coarse_threshold 30,
    agg_threshold 200, structured transfers (``stencil=False``): every S
    staged on a level keeps the box plan, an agglomerated level takes the
    assembled route, and GMG-PCG converges (error < 1e-6) in the host
    loop's iterations."""
    ns = (16, 16, 16)

    def driver(parts):
        Ah, bh, xe = _system(pt, parts, ns)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30, agg_threshold=200)
        assert any(min(i.num_oids for i in lvl.A.rows.partition.part_values()) == 0 for lvl in h.levels[1:]) or \
            min(i.num_oids for i in h.coarse_A.rows.partition.part_values()) == 0
        if isinstance(parts.backend, GPUBackend):
            dh = gpu_gmg.device_hierarchy(h, parts.backend, stencil=False)
            s_levels = [lv for lv in dh["levels"] if "dS" in lv]
            assert s_levels
            for lv in s_levels:
                assert isinstance(lv["dS"].col_plan, BoxExchangePlan)
            routes = [gpu_gmg.route(lv) for lv in dh["levels"]]
            assert routes[0] == "assembled" and "structured" in routes, routes
            x, info = pt.pcg(Ah, bh, minv=h, tol=1e-9, stencil=False)
        else:
            x, info = pt.pcg(Ah, bh, minv=h, tol=1e-9)
        assert info["converged"] and _err(pt, x, xe) < 1e-6
        return info["iterations"]

    assert pt.prun(driver, CPU, (2, 2, 2)) == pt.prun(driver, pt.sequential, (2, 2, 2))


@pytest.mark.parametrize("lowering", ["sd", "bsr", "ell"])
def test_gmg_pcg_with_lowering(lowering):
    """pcg(A, b, minv=h, lowering=...) on the card (the JAX package's
    lowering switches reach every staging of its GMG-PCG): the band
    operators of the hierarchy keep their band lowering, so iterations and
    x are those of lowering="auto" bit for bit, and the second solve
    reuses the first one's staging and solve function: nothing is staged
    or built twice."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg

    ns = (12, 12, 12)

    def driver(parts):
        Ah, bh, xe = _system(pt, parts, ns)
        h = pt.gmg_hierarchy(parts, Ah, ns, coarse_threshold=30)
        x0, i0 = pt.pcg(Ah, bh, minv=h, tol=1e-9)
        before = dict(gpu_gmg.STATS)
        x1, i1 = pt.pcg(Ah, bh, minv=h, tol=1e-9, lowering=lowering)
        assert gpu_gmg.STATS["stagings"] == before["stagings"]
        assert gpu_gmg.STATS["pcg_fns"] == before["pcg_fns"]
        assert len({id(st) for st in h._device_cache.values()}) == 1
        assert i1["lowering"] == i0["lowering"] == "coded"
        return i0["iterations"], i1["iterations"], pt.gather_pvector(x0), pt.gather_pvector(x1)

    it0, it1, x0, x1 = pt.prun(driver, CPU, (2, 2, 2))
    assert it0 == it1 and x0.tobytes() == x1.tobytes()
