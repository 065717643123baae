"""The port's checkpoints and recovery drivers against the JAX package's.

`parallel/checkpoint.py` keeps the JAX package's on-disk format, so a
checkpoint either package writes loads in the other bit for bit: PVectors
and PSparseMatrices, whole-object and sharded, onto another part count too.
The sharded form's two generations and the CRC checks behave alike (a
bit-rotted newest generation falls back to the previous one, no clean one
raises `CheckpointCorruptError`, a truncated whole-object file too); a
solver-state restore onto another part count raises `CheckpointShapeError`.

Solver states (12x12 Poisson on (2,2) parts, the sequential backend): a host
`cg` checkpointed every 5 iterations and continued by `resume_solve` lands
on the uninterrupted run bit for bit in the writing package, and within
1e-12 (the two host loops agree to an ulp) with the same iterations when
the other package resumes it. `solve_with_recovery`'s ledger equals the JAX
package's for a NaN fault restarted from the exact-recurrence checkpoint,
for a bit flip healed in memory with no disk write, and the escalation
reaches the checkpoint tier. On the device loop (`GPUBackend(device="cpu")`
against `pa.tpu`, 8^3 on (2,2,2)) the chunked recovery takes the JAX
package's iterations and x, and `resume_solve` on the sequential backend
continues from the device run's checkpoint.
"""
import json
import os

import numpy as np
import pytest

import partitionedarrays_jl_tpu as pa
import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu.models import resume_solve as jax_resume
from partitionedarrays_jl_tpu.models import solve_with_recovery as jax_recovery
from partitionedarrays_jl_tpu.parallel import checkpoint as jc
from partitionedarrays_jl_tpu.parallel.faults import inject_faults as jax_inject
from partitionedarrays_jl_tpu_torch.parallel import checkpoint as pc
from partitionedarrays_jl_tpu_torch.parallel.faults import inject_faults as port_inject
from partitionedarrays_jl_tpu_torch.parallel.gpu import GPUBackend
from partitionedarrays_jl_tpu_torch.utils.health import SDCConfig

CPU = GPUBackend(device="cpu")
NS = (12, 12)
PKG = {"jax": (pa, jc), "port": (pt, pc)}


def _system(m, parts):
    return m.assemble_poisson(parts, NS)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("read_parts", [(2, 2), (3, 1)])
def test_objects_cross_packages(writer, reader, sharded, read_parts, tmp_path):
    """A PVector and a PSparseMatrix written by one package load in the
    other bit for bit, onto the same or another partition."""
    mw, cw = PKG[writer]
    mr, cr = PKG[reader]
    d = str(tmp_path / "ck")

    def dense(m, A):
        M = m.gather_psparse(A)
        out = np.zeros(M.shape)
        np.add.at(out, (M.row_of_nz(), M.indices), M.data)
        return out

    def write(parts):
        A, b, _, _ = _system(mw, parts)
        cw.save_checkpoint(d, {"b": b, "A": A}, meta={"it": 7, "tag": writer}, sharded=sharded)
        return mw.gather_pvector(b), dense(mw, A)

    b_w, A_w = mw.prun(write, mw.sequential, (2, 2))

    def read(parts):
        _, b0, _, _ = _system(mr, parts)
        st = cr.load_checkpoint(d, {"b": b0.rows, "A": b0.rows})
        return mr.gather_pvector(st["b"]), dense(mr, st["A"]), st["meta"]

    b_r, A_r, meta = mr.prun(read, mr.sequential, read_parts)
    assert b_r.tobytes() == b_w.tobytes()
    assert A_r.tobytes() == A_w.tobytes()
    assert meta == {"it": 7, "tag": writer}


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_generations_and_crc(loader, tmp_path):
    """Two generations of a sharded vector: the newest loads; a bit-rotted
    newest shard falls back to the previous generation; both rotted raise
    `CheckpointCorruptError`; a truncated whole-object file too. The port
    writes, each package loads."""
    m, c = PKG[loader]
    d = str(tmp_path / "v")

    def save(parts, scale):
        _, b, _, _ = _system(pt, parts)
        pc.save_pvector_sharded(d, b * scale)
        return pt.gather_pvector(b * scale)

    g1 = pt.prun(lambda parts: save(parts, 1.0), pt.sequential, (2, 2))
    g2 = pt.prun(lambda parts: save(parts, 2.0), pt.sequential, (2, 2))

    def load(parts):
        _, b, _, _ = _system(m, parts)
        return m.gather_pvector(c.load_pvector_sharded(d, b.rows))

    assert m.prun(load, m.sequential, (2, 2)).tobytes() == g2.tobytes()
    idx = json.load(open(os.path.join(d, "index.json")))
    gens = [g["gen"] for g in idx["generations"]]
    assert len(gens) == 2

    def rot(gen):
        f = os.path.join(d, f"shard00000-{gen}.npz")
        raw = bytearray(open(f, "rb").read())
        raw[-20] ^= 0xFF
        open(f, "wb").write(bytes(raw))

    rot(gens[0])
    assert m.prun(load, m.sequential, (2, 2)).tobytes() == g1.tobytes()
    rot(gens[1])
    with pytest.raises(c.CheckpointCorruptError):
        m.prun(load, m.sequential, (2, 2))

    w = str(tmp_path / "w")

    def save_whole(parts):
        _, b, _, _ = _system(pt, parts)
        pc.save_checkpoint(w, {"b": b})

    pt.prun(save_whole, pt.sequential, (2, 2))
    f = os.path.join(w, "b.npz")
    open(f, "r+b").truncate(os.path.getsize(f) // 2)
    with pytest.raises(c.CheckpointCorruptError):
        m.prun(lambda parts: c.load_checkpoint(w, {"b": _system(m, parts)[1].rows}), m.sequential, (2, 2))


def _host_checkpointed(m, c, d, every=5):
    def driver(parts):
        A, b, _, x0 = _system(m, parts)
        x_full, i_full = m.cg(A, b, x0=x0, tol=1e-10)
        ck = c.SolverCheckpointer(d, every=every, async_write=False)
        m.cg(A, b, x0=x0, tol=1e-10, maxiter=12, checkpoint=ck)
        return m.gather_pvector(x_full), i_full["iterations"]

    return m.prun(driver, m.sequential, (2, 2))


@pytest.mark.parametrize("writer,resumer", [("port", "port"), ("jax", "jax"), ("port", "jax"), ("jax", "port")])
def test_solver_state_resume(writer, resumer, tmp_path):
    """A host cg checkpointed every 5 iterations (stopped at 12: the last
    checkpoint is iteration 10) continues through `resume_solve` onto the
    uninterrupted run: bit for bit in the writing package, within 1e-12 and
    with its iterations across packages."""
    d = str(tmp_path / "ck")
    mw, cw = PKG[writer]
    _host_checkpointed(mw, cw, d)
    mr, _ = PKG[resumer]
    resume = pt.resume_solve if resumer == "port" else jax_resume

    def driver(parts):
        A, b, _, x0 = _system(mr, parts)
        x_full, i_full = mr.cg(A, b, x0=x0, tol=1e-10)
        x, info = resume(d, A, b, maxiter=1000)  # the writer recorded its own maxiter, 12
        return mr.gather_pvector(x_full), i_full["iterations"], mr.gather_pvector(x), info

    x_full, it_full, x, info = mr.prun(driver, mr.sequential, (2, 2))
    assert info["resumed_from_iteration"] == 10 and info["converged"]
    assert info["iterations"] == it_full
    if writer == resumer:
        assert x.tobytes() == x_full.tobytes()
    else:
        np.testing.assert_allclose(x, x_full, rtol=0, atol=1e-12 * np.abs(x_full).max())


def test_solver_state_other_part_count_raises(tmp_path):
    d = str(tmp_path / "ck")
    _host_checkpointed(pt, pc, d)

    def driver(parts):
        A, b, _, _ = _system(pt, parts)
        with pytest.raises(pc.CheckpointShapeError):
            pt.resume_solve(d, A, b)
        return True

    assert pt.prun(driver, pt.sequential, (1, 2))


def _ledger(m, d, spec, seed, recover, inject, **kw):
    def driver(parts):
        A, b, _, x0 = _system(m, parts)
        x_clean, _ = m.cg(A, b, x0=x0, tol=1e-10)
        with inject(spec, seed=seed):
            x, info = recover(A, b, method="cg", x0=x0, tol=1e-10, checkpoint_dir=d, **kw)
        return m.gather_pvector(x_clean), m.gather_pvector(x), info["restarts"], info["recovery"]

    return m.prun(driver, m.sequential, (2, 2))


@pytest.mark.parametrize("case", ["nan_checkpoint_restart", "bitflip_in_memory"])
def test_recovery_ledger_matches(case, tmp_path, monkeypatch):
    """The ledger of `solve_with_recovery` (solvers.py:2247) for a NaN fault
    restarted from the exact-recurrence checkpoint, and for a bit flip the
    in-memory tier heals with no disk write: the JAX package's, and x the
    clean run's bit for bit."""
    if case == "nan_checkpoint_restart":
        spec, seed, every, jkw, pkw = "nan@part=1,call=20", 5, 6, {}, {}
    else:
        spec, seed, every = "bitflip@part=1,call=20,bit=51", 5, 10_000
        monkeypatch.setenv("PA_TPU_ABFT", "1")
        jkw, pkw = {}, {"sdc": SDCConfig(abft=True)}
    want = _ledger(pa, str(tmp_path / "j"), spec, seed, jax_recovery, jax_inject, every=every, **jkw)
    monkeypatch.delenv("PA_TPU_ABFT", raising=False)
    got = _ledger(pt, str(tmp_path / "p"), spec, seed, pt.solve_with_recovery, port_inject, every=every, **pkw)
    assert got[2:] == want[2:]
    assert got[0].tobytes() == got[1].tobytes()
    if case == "bitflip_in_memory":
        assert not os.path.exists(str(tmp_path / "p" / "manifest.json"))
        assert got[3]["rollbacks"] == 1 and got[2] == 0


def test_escalation_reaches_the_checkpoint_tier(tmp_path):
    """Persistent corruption exhausts the in-memory budget, escalates to
    `solve_with_recovery`, whose restarts fail again until the budget:
    the last raise is typed."""

    def driver(parts):
        A, b, _, x0 = _system(pt, parts)
        with port_inject("bitflip@part=1,after=0,bit=51", seed=5):
            with pytest.raises(pt.SilentCorruptionError):
                pt.solve_with_recovery(A, b, x0=x0, tol=1e-10, checkpoint_dir=str(tmp_path / "ck"), every=5,
                                       max_restarts=1, sdc=SDCConfig(abft=True, max_rollbacks=1))
        return True

    assert pt.prun(driver, pt.sequential, (2, 2))


def test_device_chunked_recovery(tmp_path):
    """The device loop in chunks of 10 iterations: the JAX package's
    iterations and x (to 1e-10), no restart; `resume_solve` on the
    sequential backend continues from the device run's checkpoint."""

    def run(m, backend, recover, d):
        def driver(parts):
            A, b, _, x0 = m.assemble_poisson(parts, (8, 8, 8))
            x, info = recover(A, b, method="cg", x0=x0, tol=1e-9, checkpoint_dir=d, every=10)
            return m.gather_pvector(x), info["iterations"], info["restarts"], info["converged"]

        return m.prun(driver, backend, (2, 2, 2))

    want = run(pa, pa.tpu, jax_recovery, str(tmp_path / "j"))
    got = run(pt, CPU, pt.solve_with_recovery, str(tmp_path / "p"))
    assert got[1:] == want[1:] and got[2] == 0 and got[3]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-10 * np.abs(want[0]).max())

    def resume(parts):
        A, b, _, x0 = pt.assemble_poisson(parts, (8, 8, 8))
        x, info = pt.resume_solve(str(tmp_path / "p"), A, b)
        return info["converged"], info["resumed_from_iteration"]

    converged, frm = pt.prun(resume, pt.sequential, (2, 2, 2))
    assert converged and frm > 0
