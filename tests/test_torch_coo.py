"""The port's COO compression (`ops/sparse.compresscoo`) against the
reference's.

The reference's `sparse()` folds each group of duplicate triplets left to
right in input order from its first value; the JAX package's default path,
its native `coo_to_csr` (`partitionedarrays_jl_tpu/native/planning.cpp`),
does so too. Held here, on 20,000 random triplets on a 50x50 matrix (seed
0), in float32 and float64 with int32 and int64 indices:

* the port's CSR equals an explicit Python left fold of each group, in
  structure and bits;
* it equals the native `coo_to_csr` and the JAX package's `compresscoo` bit
  for bit (the native comparison is skipped, alone, where the native
  library is not built);
* the ``combine`` branch keeps its own loop; inputs without duplicates and
  empty inputs pass through.
"""
import numpy as np
import pytest

from partitionedarrays_jl_tpu import native
from partitionedarrays_jl_tpu.ops.sparse import compresscoo as jax_compresscoo
from partitionedarrays_jl_tpu_torch.ops.sparse import compresscoo

M = N = 50
NNZ = 20_000


def _triplets(dtype, itype, seed=0):
    rng = np.random.default_rng(seed)
    I = rng.integers(0, M, NNZ).astype(itype)
    J = rng.integers(0, N, NNZ).astype(itype)
    V = rng.standard_normal(NNZ).astype(dtype)
    return I, J, V


def _left_fold(I, J, V, combine=lambda a, b: a + b):
    """The CSR of the triplets by an explicit loop: each (i, j) group folded
    left to right in input order from its first value."""
    groups = {}
    for i, j, v in zip(I.tolist(), J.tolist(), V):
        key = (i, j)
        groups[key] = v if key not in groups else combine(groups[key], v)
    keys = sorted(groups)
    indptr = np.zeros(M + 1, dtype=np.int64)
    for i, _ in keys:
        indptr[i + 1] += 1
    return np.cumsum(indptr), np.array([j for _, j in keys]), np.array([groups[k] for k in keys], dtype=V.dtype)


def _bits(a):
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("itype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compresscoo_is_the_left_fold(dtype, itype):
    """Structure and value bits equal the explicit left fold of each group
    (the random triplets carry groups of up to ~20 duplicates)."""
    I, J, V = _triplets(dtype, itype)
    A = compresscoo(I, J, V, M, N)
    indptr, cols, vals = _left_fold(I, J, V)
    np.testing.assert_array_equal(A.indptr, indptr)
    np.testing.assert_array_equal(A.indices, cols)
    assert A.data.dtype == dtype and _bits(A.data) == _bits(vals)


@pytest.mark.parametrize("itype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compresscoo_matches_jax(dtype, itype):
    """Bit for bit the JAX package's compresscoo; and its native
    `coo_to_csr` where the native library returns a result."""
    I, J, V = _triplets(dtype, itype)
    A = compresscoo(I, J, V, M, N)
    R = jax_compresscoo(I, J, V, M, N)
    np.testing.assert_array_equal(A.indptr, R.indptr)
    np.testing.assert_array_equal(A.indices, R.indices)
    assert _bits(A.data) == _bits(R.data)
    res = native.coo_to_csr(I, J, V, M, N)
    if res is None:
        pytest.skip("the native library is not built: coo_to_csr returned no result")
    indptr, cols, vals = res
    np.testing.assert_array_equal(A.indptr, indptr)
    np.testing.assert_array_equal(A.indices, cols)
    assert _bits(A.data) == _bits(vals)


def test_compresscoo_combine_keeps_its_loop():
    """A combine other than np.add folds each group left to right through
    its own loop; np.add given explicitly takes the vectorised fold."""
    I, J, V = _triplets(np.float64, np.int64, seed=1)
    mx = compresscoo(I, J, V, M, N, combine=max)
    np.testing.assert_array_equal(mx.data, _left_fold(I, J, V, combine=max)[2])
    explicit = compresscoo(I, J, V, M, N, combine=np.add)
    assert _bits(explicit.data) == _bits(compresscoo(I, J, V, M, N).data)


def test_compresscoo_without_duplicates_and_empty():
    """Triplets without duplicates come back sorted with their values
    untouched (signed zeros kept); no triplets give an empty CSR."""
    I = np.array([3, 0, 3, 1])
    J = np.array([2, 4, 0, 1])
    V = np.array([1.5, -0.0, 2.5, -3.0])
    A = compresscoo(I, J, V, 5, 5)
    np.testing.assert_array_equal(A.indptr, [0, 1, 2, 2, 4, 4])
    np.testing.assert_array_equal(A.indices, [4, 1, 0, 2])
    assert _bits(A.data) == _bits(np.array([-0.0, -3.0, 2.5, 1.5]))
    E = compresscoo(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0), 3, 3)
    assert E.nnz == 0 and E.shape == (3, 3) and not E.indptr.any()
