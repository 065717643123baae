"""Host planning of the port's band lowering: `gpu.row_classes`, the row
classes of a coded-DIA operator, takes the classes of a random projection
and checks every row against its class's first row, sorting only the few
representatives. Its table and codes must equal the exact lexicographic
sort of all the rows (`_row_classes_exact`) bit for bit, on the
operators the port stages (Poisson, advection, the decoupled GMG levels,
Q1 and heat), on random class patterns, and where the projection merges
two distinct rows (the exact sort then decides)."""
import numpy as np
import pytest

import partitionedarrays_jl_tpu_torch as pt
from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceMatrix, _row_classes_exact, row_classes

KMAX = DeviceMatrix.CODE_MAX_VALUES


def _same(got, want):
    (u, c, ok), (ue, ce, oke) = got, want
    assert ok == oke
    if ok:
        assert u.dtype == ue.dtype and u.tobytes() == ue.tobytes()
        assert c.dtype == ce.dtype and c.tobytes() == ce.tobytes()


def _dias(A):
    """Each part's (D, no) per-diagonal values, as `DeviceMatrix._detect_dia`
    builds them, with its owned row count."""
    oo = A.owned_owned_values.part_values()
    noids = np.array([i.num_oids for i in A.rows.partition.part_values()])
    det = DeviceMatrix._detect_dia(A, oo, len(oo), noids, int(noids.max()))
    assert det is not None
    return [(det["dia"][p], int(noids[p])) for p in range(len(oo))]


def _systems(parts):
    A, b, _, _ = pt.assemble_poisson(parts, (12, 10, 9))
    Ah, _ = pt.decouple_dirichlet(A, b)
    h = pt.gmg_hierarchy(parts, Ah, (12, 10, 9), coarse_threshold=60)
    out = [A, pt.assemble_advection_fv(parts, (12, 10, 9))[0], Ah] + [lvl.A for lvl in h.levels[1:]]
    return [_dias(M) for M in out]


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2)], ids=["1part", "8parts"])
def test_row_classes_match_the_exact_sort_on_staged_operators(grid):
    for parts_dias in pt.prun(_systems, pt.sequential, grid):
        for dia, n in parts_dias:
            _same(row_classes(dia, n, KMAX), _row_classes_exact(dia[:, :n].T, KMAX))


@pytest.mark.parametrize("driver", ["q1", "heat"])
def test_row_classes_on_the_2d_and_heat_operators(driver):
    def drive(parts):
        if driver == "q1":
            A = pt.assemble_fem_q1(parts, (9, 7))[0]
            return _dias(A)
        return _dias(pt.assemble_heat(parts, (8, 8, 8), 0.5)[0])

    grid = (2, 2) if driver == "q1" else (2, 2, 2)
    for dia, n in pt.prun(drive, pt.sequential, grid):
        _same(row_classes(dia, n, KMAX), _row_classes_exact(dia[:, :n].T, KMAX))


@pytest.mark.parametrize("k", [1, 2, 5, 8, 9])
def test_row_classes_on_random_patterns(k):
    rng = np.random.default_rng(k)
    table = rng.integers(-3, 4, size=(k, 7)).astype(float)
    table[0] = -0.0
    dia = table[rng.integers(0, k, size=5000)].T.copy()
    _same(row_classes(dia, 4000, KMAX), _row_classes_exact(dia[:, :4000].T, KMAX))


def test_row_classes_when_the_projection_merges_rows(monkeypatch):
    """A direction orthogonal to the difference of two rows: the projection
    gives one class for two, the check finds it, and the exact sort
    answers."""
    class Fixed:
        def standard_normal(self, d):
            return np.array([1.0, 1.0] + [0.0] * (d - 2))

    dia = np.zeros((3, 6))
    dia[0, ::2] = 1.0  # rows (1, 0, 0) and (0, 1, 0): equal projections
    dia[1, 1::2] = 1.0
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: Fixed())
    got = row_classes(dia, 6, KMAX)
    assert got[2] and len(got[0]) == 2
    _same(got, _row_classes_exact(dia.T, KMAX))
