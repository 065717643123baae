"""The silent-corruption (SDC) defense of the port against the JAX package's.

Host loops (`models/solvers.py:_SDCGuard`, 12x12 Poisson on (2,2) parts,
the sequential backend): checksummed exchanges (``SDCConfig(abft=True)``,
the JAX package's ``PA_TPU_ABFT=1``), the true-residual audit and the
in-memory rollback ring. For the same fault spec and seed the port's
``info["sdc"]`` counters equal the JAX package's, the healed x equals the
port's own clean run bit for bit and the JAX package's healed x to 1e-12,
and persistent corruption escalates with the JAX package's counters.

Device loops (`parallel/gpu_sdc.py` on `GPUBackend(device="cpu")`, 8^3
Poisson on (2,2,2) parts, against `pa.tpu` on the 8-device CPU mesh with
``PA_FAULT_DEVICE``): the fused and standard bodies, Jacobi PCG and the
block loop (K = 2) take the JAX package's counters, clean and faulted;
clean equals the undefended solve bit for bit, faulted the clean one; the
escalation raises `SilentCorruptionError` with the JAX package's counters.

Clean-path contracts: under strict mode ABFT on and off give equal bits on
the 4-part conformance fixture (tests/test_abft.py:510) for the standard,
fused and K = 4 block bodies; the launches a trip of K1 are the same with
audits on and off, and the exchanges a trip the same with ABFT on and off
(counting wrappers: the stand-in for tests/test_abft.py:568's HLO count);
ABFT pins the generic plan and ``info["exchange_plan"]`` says so; the solve
cache never hands an SDC solve an undefended loop. The refusals (s-step,
pipelined) raise `LoweringConflictError`. The slab checksums of the host
exchange equal the JAX package's, empty trailing slabs and (L, K) slabs
included.
"""
import contextlib

import numpy as np
import pytest
import torch

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.parallel import collectives as jcol
from partitionedarrays_jl_tpu.parallel.faults import inject_faults as jax_inject
from partitionedarrays_jl_tpu_torch.ops import dia
from partitionedarrays_jl_tpu_torch.parallel import collectives as pcol
from partitionedarrays_jl_tpu_torch.parallel import gpu_sdc
from partitionedarrays_jl_tpu_torch.parallel.faults import inject_faults as port_inject
from partitionedarrays_jl_tpu_torch.parallel.gpu import EXCHANGES, STATS, GPUBackend, device_matrix, make_cg_fn
from partitionedarrays_jl_tpu_torch.utils.health import LoweringConflictError, SDCConfig, SilentCorruptionError

CPU = GPUBackend(device="cpu")
HOST_NS = (12, 12)
DEV_NS = (8, 8, 8)
DEV_PARTS = (2, 2, 2)


def _env(monkeypatch, abft, audit, max_rb=None, device=None):
    monkeypatch.setenv("PA_TPU_ABFT", "1" if abft else "0")
    monkeypatch.setenv("PA_HEALTH_AUDIT_EVERY", str(audit))
    if max_rb is not None:
        monkeypatch.setenv("PA_HEALTH_MAX_ROLLBACKS", str(max_rb))
    if device is not None:
        monkeypatch.setenv("PA_FAULT_DEVICE", device)
    else:
        monkeypatch.delenv("PA_FAULT_DEVICE", raising=False)


def _unset(monkeypatch):
    for k in ("PA_TPU_ABFT", "PA_HEALTH_AUDIT_EVERY", "PA_HEALTH_MAX_ROLLBACKS", "PA_FAULT_DEVICE"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# host loops
# ---------------------------------------------------------------------------

HOST_CASES = {
    "exchange_checksum": dict(method="cg", abft=True, audit=6, spec="bitflip@part=1,call=20,bit=51", seed=5),
    "audit_only": dict(method="cg", abft=False, audit=6, spec="bitflip@part=1,call=20,bit=51", seed=5),
    "nan_slab": dict(method="cg", abft=True, audit=6, spec="nan@part=1,call=20", seed=5),
    "pcg": dict(method="pcg", abft=True, audit=32, spec="bitflip@part=2,call=15,bit=50", seed=2),
}


def _host_run(m, method, spec, seed, **kw):
    def driver(parts):
        A, b, _, x0 = m.assemble_poisson(parts, HOST_NS)
        solve = m.cg if method == "cg" else m.pcg
        x_clean, _ = solve(A, b, x0=x0, tol=1e-10, **kw)
        inject = jax_inject if m is pa else port_inject
        with inject(spec, seed=seed):
            x, info = solve(A, b, x0=x0, tol=1e-10, **kw)
        return m.gather_pvector(x_clean), m.gather_pvector(x), info["sdc"], info["converged"]

    return m.prun(driver, m.sequential, (2, 2))


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_sdc_matches_jax(case, monkeypatch):
    c = HOST_CASES[case]
    _env(monkeypatch, c["abft"], c["audit"])
    want = _host_run(pa, c["method"], c["spec"], c["seed"])
    _unset(monkeypatch)
    got = _host_run(pt, c["method"], c["spec"], c["seed"],
                    sdc=SDCConfig(abft=c["abft"], audit_every=c["audit"]))
    assert got[2] == want[2] and got[2]["rollbacks"] == 1 and got[3]
    np.testing.assert_array_equal(got[0], got[1])  # healed bit for bit
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12 * np.abs(want[1]).max())


def test_host_persistent_corruption_escalates(monkeypatch):
    def run(m, **kw):
        def driver(parts):
            A, b, _, x0 = m.assemble_poisson(parts, HOST_NS)
            inject = jax_inject if m is pa else port_inject
            with inject("bitflip@part=1,after=0,bit=51", seed=5):
                try:
                    m.cg(A, b, x0=x0, tol=1e-10, **kw)
                except Exception as e:  # noqa: BLE001
                    return type(e).__name__, e.diagnostics["sdc"], e.diagnostics["iteration"]

        return m.prun(driver, m.sequential, (2, 2))

    _env(monkeypatch, True, 32, max_rb=2)
    want = run(pa)
    _unset(monkeypatch)
    got = run(pt, sdc=SDCConfig(abft=True, max_rollbacks=2))
    assert want[0] == "SilentCorruptionError" and got == want


# ---------------------------------------------------------------------------
# device loops
# ---------------------------------------------------------------------------


def _dev_run(m, backend, kind, **kw):
    def driver(parts):
        A, b, _, x0 = m.assemble_poisson(parts, DEV_NS)
        if kind == "pcg":
            Ad, bd = m.decouple_dirichlet(A, b)
            x, info = m.pcg(Ad, bd, tol=1e-9, **kw)
            return [m.gather_pvector(x)], info
        if kind == "block":
            xs, info = m.cg(A, B=[b, b.copy()], X0=[x0, x0.copy()], tol=1e-9, **kw)
            return [m.gather_pvector(x) for x in xs], info
        x, info = m.cg(A, b, x0=x0, tol=1e-9, **kw)
        return [m.gather_pvector(x)], info

    return m.prun(driver, backend, DEV_PARTS)


DEV_CASES = {
    "fused": ("cg", {"fused": True}, "spmv@trip=8,part=1,factor=1e3", 5, True),
    "standard": ("cg", {"fused": False}, "spmv@trip=8,part=1,factor=1e3", 5, True),
    "audit_only": ("cg", {"fused": True}, "spmv@trip=8,part=1,factor=1e3", 5, False),
    "pcg": ("pcg", {"fused": False}, "spmv@trip=8,part=1,factor=1e3", 5, True),
    "block": ("block", {"fused": True}, "spmv@trip=7,part=1,factor=1e3", 5, True),
    "block_standard": ("block", {"fused": False}, "spmv@trip=7,part=1,factor=1e3", 5, True),
}


@pytest.mark.parametrize("case", sorted(DEV_CASES))
def test_device_sdc_matches_jax(case, monkeypatch):
    kind, kw, fault, audit, abft = DEV_CASES[case]
    out = {}
    for faulted in (False, True):
        _env(monkeypatch, abft, audit, device=fault if faulted else None)
        out[("jax", faulted)] = _dev_run(pa, pa.tpu, kind, **kw)
        _unset(monkeypatch)
        cfg = SDCConfig(abft=abft, audit_every=audit, device_fault=fault if faulted else None)
        out[("port", faulted)] = _dev_run(pt, CPU, kind, sdc=cfg, **kw)
    plain = _dev_run(pt, CPU, kind, box=not abft, **kw)
    for faulted in (False, True):
        want, got = out[("jax", faulted)][1]["sdc"], out[("port", faulted)][1]["sdc"]
        assert got == want, (faulted, got, want)
    assert out[("port", False)][1]["sdc"]["detections"] == 0
    assert out[("port", True)][1]["sdc"]["rollbacks"] == 1 and out[("port", True)][1]["converged"]
    for xc, xf, xu, xj in zip(out[("port", False)][0], out[("port", True)][0], plain[0], out[("jax", True)][0]):
        np.testing.assert_array_equal(xc, xu)  # clean: the undefended solve's bits
        np.testing.assert_array_equal(xc, xf)  # faulted: healed to the clean bits
        np.testing.assert_allclose(xf, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    np.testing.assert_array_equal(out[("port", False)][1]["residuals"], plain[1]["residuals"])


@pytest.mark.parametrize("fused", [True, False])
def test_device_escalation_matches_jax(fused, monkeypatch):
    fault = "spmv@trip=8,part=1,factor=1e3"

    def run(m, backend, **kw):
        def driver(parts):
            A, b, _, x0 = m.assemble_poisson(parts, DEV_NS)
            try:
                m.cg(A, b, x0=x0, tol=1e-9, fused=fused, **kw)
            except Exception as e:  # noqa: BLE001
                return type(e).__name__, e.diagnostics["sdc"]

        return m.prun(driver, backend, DEV_PARTS)

    _env(monkeypatch, True, 5, max_rb=0, device=fault)
    want = run(pa, pa.tpu)
    _unset(monkeypatch)
    got = run(pt, CPU, sdc=SDCConfig(abft=True, audit_every=5, max_rollbacks=0, device_fault=fault))
    assert want[0] == "SilentCorruptionError" and got == want and got[1]["escalations"] == 1


# ---------------------------------------------------------------------------
# clean-path contracts
# ---------------------------------------------------------------------------

# the 10-gid 4-part conformance fixture (tests/test_abft.py:457)
LID_TO_GID = [[0, 1, 2, 4, 6, 7], [3, 4, 1, 9], [5, 6, 7, 4, 3, 9], [8, 9, 0, 2, 6]]
LID_TO_PART = [[0, 0, 0, 1, 2, 2], [1, 1, 0, 3], [2, 2, 2, 1, 1, 3], [3, 3, 0, 0, 2]]


def _fixture_system(parts):
    from partitionedarrays_jl_tpu_torch.parallel.index_sets import IndexSet

    owner = {g: p for p, (gids, ps) in enumerate(zip(LID_TO_GID, LID_TO_PART)) for g, q in zip(gids, ps) if q == p}
    visible = [set(g) for g in LID_TO_GID]
    pairs = {(a, b) for a in range(10) for b in range(10)
             if a != b and b in visible[owner[a]] and a in visible[owner[b]]}

    def triplets(p):
        I, J, V = [], [], []
        for g, q in zip(LID_TO_GID[p], LID_TO_PART[p]):
            if q != p:
                continue
            I.append(g), J.append(g), V.append(40.0 + g)
            for b in sorted(visible[p]):
                if (g, b) in pairs:
                    I.append(g), J.append(b), V.append(-(1.0 + (g + b) % 3))
        return np.array(I), np.array(J), np.array(V, dtype=np.float64)

    partition = pt.map_parts(lambda p: IndexSet(p, LID_TO_GID[p], LID_TO_PART[p]), parts)
    rows = pt.PRange(10, partition)
    I, J, V = (pt.map_parts(lambda p, k=k: triplets(p)[k], parts) for k in range(3))
    A = pt.PSparseMatrix.from_coo(I, J, V, rows, rows.copy(), ids="global")
    b = pt.PVector(pt.map_parts(
        lambda i: np.where(np.asarray(i.lid_to_part) == i.part, np.sin(1.0 + np.asarray(i.lid_to_gid, float)), 0.0),
        A.rows.partition), A.rows)
    return A, b


@pytest.mark.parametrize("mode", ["standard", "fused", "block_k4"])
def test_strict_abft_on_off_identity(mode):
    """Under strict mode ABFT on and off give equal bits: the checksum lanes
    ride beside E3's dots and never move them (audits run: they change no
    state)."""

    def driver(parts):
        A, b = _fixture_system(parts)
        out = []
        for sdc in (None, SDCConfig(abft=True, audit_every=3)):
            if mode == "block_k4":
                B = [b, b * 2.0, b * -0.5, b * 3.0]
                xs, info = pt.cg(A, B=B, tol=1e-12, strict=True, sdc=sdc)
                out.append(([pt.gather_pvector(x) for x in xs], info["residuals"]))
            else:
                x, info = pt.cg(A, b, tol=1e-12, strict=True, fused=mode == "fused", sdc=sdc)
                out.append(([pt.gather_pvector(x)], info["residuals"]))
        return out, info.get("sdc")

    (off, on), sdc = pt.prun(driver, CPU, 4)
    assert sdc["audit_iterations"] > 0 and sdc["detections"] == 0
    for a, c in zip(off[0], on[0]):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(off[1], on[1])


def _count(monkeypatch):
    """Counting wrappers over the kernels the CG loops launch on the CPU
    (which runs their plain versions): K1, K2 and the sweep. They bump the
    global `dia.LAUNCHES`: use them through the `counted` fixture, whose
    teardown resets the counts for the tests that run after."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    for mod, name in ((dia, "dia_coded_spmv"), (dia, "dia_coded_spmv_pfold"), (sw, "cg_sweep")):
        f = getattr(mod, name)

        def wrapped(*a, _f=f, _k=name, **k):
            dia.LAUNCHES[_k] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)


@contextlib.contextmanager
def _counting(monkeypatch):
    """`_count`'s wrappers for a scope; `dia.LAUNCHES` is reset when it
    ends, so whatever runs after in the same process starts from zero."""
    _count(monkeypatch)
    try:
        yield
    finally:
        dia.reset_launches()


@pytest.fixture
def counted(monkeypatch):
    """`_counting` for one test: the counts are reset at its teardown."""
    with _counting(monkeypatch):
        yield


@pytest.mark.parametrize("fused", [True, False])
def test_launch_and_exchange_parity(fused, counted):
    """One K1 a trip with audits on and off (an audit trip streams A x
    through the one SpMV), no K2 on the defended fused body, one sweep a
    trip; the exchange calls and rounds a trip the same with ABFT on and off
    (the checksums ride the same rounds)."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, DEV_NS)
        dA = device_matrix(A, CPU, box=False)
        from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceVector, _b_on_cols_layout

        bd = _b_on_cols_layout(b, dA)
        xd = DeviceVector.from_pvector(x0, CPU, dA.col_layout).data
        rows = {}
        for tag, cfg in (("abft_audit", SDCConfig(abft=True, audit_every=5)),
                         ("abft_only", SDCConfig(abft=True, audit_every=0)),
                         ("audit_only", SDCConfig(abft=False, audit_every=5))):
            fn = make_cg_fn(dA, 1e-9, 4 * A.rows.ngids, fused=fused, sdc=cfg)
            dia.reset_launches()
            for k in EXCHANGES:
                EXCHANGES[k] = 0
            fn(bd, xd)
            trips = fn.stats["device_iterations"]
            rows[tag] = (dia.LAUNCHES["dia_coded_spmv"] - 1, dia.LAUNCHES["dia_coded_spmv_pfold"],
                         dia.LAUNCHES["cg_sweep"], EXCHANGES["calls"] - 1, trips)
        return rows

    rows = pt.prun(driver, CPU, DEV_PARTS)
    for k1, k2, sweep, calls, trips in rows.values():
        assert (k1, k2, sweep, calls) == (trips, 0, trips, trips)
    assert len({r[3] / r[4] for r in rows.values()}) == 1


def test_abft_pins_the_generic_plan():
    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, DEV_NS)
        _, i_box = pt.cg(A, b, x0=x0, tol=1e-9)
        _, i_abft = pt.cg(A, b, x0=x0, tol=1e-9, sdc=SDCConfig(abft=True))
        _, i_aud = pt.cg(A, b, x0=x0, tol=1e-9, sdc=SDCConfig(audit_every=5))
        return i_box["exchange_plan"], i_abft["exchange_plan"], i_aud["exchange_plan"]

    assert pt.prun(driver, CPU, DEV_PARTS) == ("box", "generic", "box")


def test_solve_cache_keys_the_defense():
    """A defended solve builds its own function (never an undefended loop's
    graph) and a second one with the same config replays it."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, DEV_NS)
        n0 = STATS["solve_fns"]
        cfg = SDCConfig(audit_every=5)
        pt.cg(A, b, x0=x0, tol=1e-9)
        pt.cg(A, b, x0=x0, tol=1e-9, sdc=cfg)
        pt.cg(A, b, x0=x0, tol=1e-9, sdc=SDCConfig(audit_every=5))
        pt.cg(A, b, x0=x0, tol=1e-9, sdc=SDCConfig(audit_every=6))
        return STATS["solve_fns"] - n0

    assert pt.prun(driver, CPU, DEV_PARTS) == 3


@pytest.mark.parametrize("where,form", [("device", "sstep"), ("device", "pipelined"), ("host", "sstep")])
def test_refusals(where, form):
    """The s-step and pipelined bodies have no defended form
    (tpu.py:3525-3547): `LoweringConflictError` naming the defense (the
    host loop refuses the s-step request too; pipelined is a host
    no-op)."""

    def driver(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, DEV_NS)
        kw = {"sstep": 2} if form == "sstep" else {"pipelined": True}
        with pytest.raises(LoweringConflictError) as ei:
            pt.cg(A, b, x0=x0, tol=1e-9, sdc=SDCConfig(abft=True), **kw)
        return ei.value.diagnostics["conflict"]

    conflict = pt.prun(driver, CPU if where == "device" else pt.sequential, DEV_PARTS)
    assert any("sdc" in str(c) or "SDC" in str(c) for c in conflict)


def test_slab_checksums_match_jax():
    """The sender-side checksums and the receiver verify of the JAX
    package (collectives.py:193-278), on a part whose trailing slab is
    empty and an (L, K) block slab; a flipped word raises."""
    from partitionedarrays_jl_tpu.parallel.sequential import SequentialData as JData
    from partitionedarrays_jl_tpu.utils.table import Table as JTable
    from partitionedarrays_jl_tpu_torch.parallel.sequential import SequentialData as PData
    from partitionedarrays_jl_tpu_torch.utils.table import Table as PTable

    def make(Data, Table, flip=0.0):
        t0 = Table(np.array([1.0, 2.0, 3.0]), np.array([0, 3, 3]))
        t1 = Table(np.arange(8.0).reshape(4, 2), np.array([0, 4]))
        t2 = Table(np.empty((0,)), np.array([0]))
        snd = Data([t0, t1, t2])
        parts_snd = Data([np.array([1, 2]), np.array([0]), np.empty(0, dtype=int)])
        parts_rcv = Data([np.array([1]), np.array([0]), np.array([0])])
        block = np.arange(8.0).reshape(4, 2) + np.eye(4, 2) * flip
        rcv = Data([Table(block, np.array([0, 4])), Table(np.array([1.0, 2.0, 3.0]), np.array([0, 3])),
                    Table(np.empty((0,)), np.array([0, 0]))])
        return snd, parts_snd, parts_rcv, rcv

    js, ps = jcol._slab_checksums(make(JData, JTable)[0]), pcol._slab_checksums(make(PData, PTable)[0])
    for a, c in zip(js, ps):
        np.testing.assert_array_equal(a[0], c[0])
        np.testing.assert_array_equal(a[1], c[1])
    snd, parts_snd, parts_rcv, rcv = make(PData, PTable)
    pcol._verify_slab_checksums(rcv, parts_rcv, parts_snd, ps, 1e-12)
    snd, parts_snd, parts_rcv, rcv = make(PData, PTable, flip=0.5)
    with pytest.raises(SilentCorruptionError):
        pcol._verify_slab_checksums(rcv, parts_rcv, parts_snd, ps, 1e-12)


def test_sdc_lanes_order():
    """The decode's lane order is the JAX package's (tpu.py:3789-3794)."""
    assert gpu_sdc.SDC_LANES == ("detections", "rollbacks", "audit_iterations", "escalations", "trips")
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _decode_sdc_outputs

    info = _decode_sdc_outputs("cg", torch.tensor([1, 1, 3, 0, 30]).numpy())
    assert info == {"detections": 1, "rollbacks": 1, "escalations": 0, "audit_iterations": 3, "trips": 30}
    with pytest.raises(SilentCorruptionError) as ei:
        _decode_sdc_outputs("cg", np.array([2, 1, 3, 1, 30]), it=12)
    assert ei.value.diagnostics["sdc"]["escalations"] == 1 and ei.value.diagnostics["iteration"] == 12


def test_counted_launches_leave_no_count_behind():
    """The counting wrappers' launches do not leak into a later test of the
    same process: the ABFT launch-parity test runs under `_counting` (the
    `counted` fixture's body), then the pipelined test's zero-launch
    assertion runs in this process, the order xdist may give the files."""
    import test_torch_pipelined

    with pytest.MonkeyPatch.context() as mp:
        with _counting(mp):
            test_launch_and_exchange_parity(True, None)
            assert any(dia.LAUNCHES.values())
    assert not any(dia.LAUNCHES.values())
    test_torch_pipelined.test_plain_axpy_matches_pallas("row_class", (1, 1, 1))
