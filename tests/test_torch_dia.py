"""The port's coded-DIA SpMV (partitionedarrays_jl_tpu_torch/ops/dia.py)
against the JAX package's Pallas kernel run by the Pallas interpreter.

On the CPU the port's wrappers take their plain PyTorch versions; the
inputs are those of tests/test_pallas_dia.py (select-chain and row-class
decode), made with numpy from a seed. Tolerance for f32: rtol=atol=1e-6, as
in the JAX package's own kernel tests; rows that take a single product and
every slot outside the owned band must agree exactly."""
import numpy as np
import pytest
import torch

from partitionedarrays_jl_tpu.ops.pallas_dia import (
    LANES,
    PAD_BLOCK_ROWS,
    dia_coded_padded_pallas,
    pack_nibble_codes as jax_pack_nibble_codes,
    plan_dia_padded,
)
from partitionedarrays_jl_tpu_torch.ops import dia

BRL = PAD_BLOCK_ROWS * LANES


def _select_case():
    """tests/test_pallas_dia.py:77 — two constant and three coded
    diagonals, ragged owned tail, ghost values beyond the owned band."""
    rng = np.random.default_rng(11)
    offsets = (-LANES * 16, -1, 0, 1, LANES * 16)
    kk = (1, 3, 2, 3, 1)
    code_row = (-1, 0, 1, 2, -1)
    no = BRL + 7 * LANES + 13
    plan = plan_dia_padded(offsets, no, n_coded=2)
    o0, g0 = plan["o0"], plan["g0"]
    D, Dc, kmax = len(offsets), 3, 3
    cb = rng.standard_normal((D, kmax)).astype(np.float32)
    codes = np.zeros((Dc, plan["code_len"]), dtype=np.uint8)
    for d in range(D):
        if kk[d] > 1:
            codes[code_row[d], :no] = rng.integers(0, kk[d], no)
    total = 5 * PAD_BLOCK_ROWS
    x = np.zeros(total * LANES, dtype=np.float32)
    x[o0 : o0 + no] = rng.standard_normal(no).astype(np.float32)
    x[g0 : g0 + 40] = rng.standard_normal(40).astype(np.float32)
    return dict(offsets=offsets, kk=kk, code_row=code_row, no=no, plan=plan,
                cb=cb, codes=codes, x=x, total=total, cls_pattern=None, rng=rng)


def _class_case():
    """tests/test_pallas_dia.py:140 — two row classes (dense interior
    stencil, diagonal-only identity rows) sharing one code stream."""
    rng = np.random.default_rng(5)
    offsets = (-LANES * 4, -1, 0, 1, LANES * 4)
    D, K = len(offsets), 2
    no = BRL + 3 * LANES + 9
    plan = plan_dia_padded(offsets, no, n_coded=1)
    cb = np.zeros((D, K), dtype=np.float32)
    cb[:, 0] = rng.standard_normal(D).astype(np.float32)
    cb[2, 1] = 1.0
    cls_pattern = tuple(tuple(bool(cb[d, k] != 0) for d in range(D)) for k in range(K))
    codes = np.zeros((1, plan["code_len"]), dtype=np.uint8)
    codes[0, :no] = rng.integers(0, K, no)
    total = (plan["n_blocks"] + 3) * PAD_BLOCK_ROWS
    x = np.zeros(total * LANES, dtype=np.float32)
    x[plan["o0"] : plan["o0"] + no] = rng.standard_normal(no).astype(np.float32)
    return dict(offsets=offsets, kk=(K,) * D, code_row=(0,) * D, no=no, plan=plan,
                cb=cb, codes=codes, x=x, total=total, cls_pattern=cls_pattern, rng=rng)


CASES = {"select": _select_case, "class": _class_case}


def _pallas(c, pfold=None):
    packed = jax_pack_nibble_codes(c["codes"])
    out = dia_coded_padded_pallas(
        c["cb"], np.array([c["no"]], dtype=np.int32),
        packed.reshape(packed.shape[0], -1, LANES), c["x"].reshape(-1, LANES),
        c["offsets"], c["kk"], c["code_row"], c["plan"], c["total"],
        interpret=True, cls_pattern=c["cls_pattern"], pfold=pfold,
    )
    if pfold is None:
        return np.asarray(out).reshape(-1)
    return tuple(np.asarray(o).reshape(-1) for o in out)


def _port_op(c):
    packed = dia.pack_nibble_codes(c["codes"]).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(c["cb"][None]),
        no=torch.tensor([c["no"]], dtype=torch.int32),
        codes=torch.from_numpy(np.ascontiguousarray(packed[None])),
        offsets=c["offsets"], kk=c["kk"], code_row=c["code_row"],
        cls_pattern=c["cls_pattern"], o0=c["plan"]["o0"],
    )


def _assert_band(got, want, c):
    o0, no = c["plan"]["o0"], c["no"]
    np.testing.assert_allclose(got[o0 : o0 + no], want[o0 : o0 + no], rtol=1e-6, atol=1e-6)
    for v in (got, want):
        rest = v.copy()
        rest[o0 : o0 + no] = 0
        assert not rest.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_spmv_matches_pallas(case):
    c = CASES[case]()
    want = _pallas(c)
    x = torch.from_numpy(c["x"][None])
    got = dia.dia_coded_spmv(_port_op(c), x).numpy().reshape(-1)
    _assert_band(got, want, c)
    if case == "class":
        # identity rows take exactly one product: equal bit for bit
        o0, no = c["plan"]["o0"], c["no"]
        one = np.zeros_like(got, dtype=bool)
        one[o0 : o0 + no] = c["codes"][0, :no] == 1
        np.testing.assert_array_equal(got[one], want[one])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pfold_matches_pallas(case):
    c = CASES[case]()
    o0, no = c["plan"]["o0"], c["no"]
    pprev = np.zeros_like(c["x"])
    pprev[o0 : o0 + no] = c["rng"].standard_normal(no).astype(np.float32)
    beta = np.array([0.375], dtype=np.float32)
    y_want, p_want = _pallas(c, pfold=(pprev.reshape(-1, LANES), beta))
    y, p = dia.dia_coded_spmv_pfold(
        _port_op(c), torch.from_numpy(c["x"][None]), torch.from_numpy(pprev[None]),
        torch.from_numpy(beta),
    )
    _assert_band(y.numpy().reshape(-1), y_want, c)
    _assert_band(p.numpy().reshape(-1), p_want, c)


def test_plain_spmv_does_not_count_launches():
    c = _class_case()
    dia.reset_launches()
    dia.dia_coded_spmv(_port_op(c), torch.from_numpy(c["x"][None]))
    assert set(dia.LAUNCHES) == {
        "dia_coded_spmv", "dia_coded_spmv_pfold", "dia_coded_spmv_axpy", "dia_stream_spmv",
    }
    assert not any(dia.LAUNCHES.values())


def test_wrapper_refuses_devices_without_a_kernel():
    c = _class_case()
    x = torch.empty((1, c["x"].size), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        dia.dia_coded_spmv(_port_op(c), x)


@pytest.mark.parametrize("shape", [(1, 10), (5, 33), (2, 3, 17), (4, 0)])
def test_pack_nibble_codes_matches_jax(shape):
    codes = np.random.default_rng(3).integers(0, 16, shape).astype(np.uint8)
    np.testing.assert_array_equal(dia.pack_nibble_codes(codes), jax_pack_nibble_codes(codes))
