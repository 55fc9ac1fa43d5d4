"""The port's SpGEMM against the JAX reference's on the reference test
file's cases (``tests/test_spgemm.py``).

Limits: float64 within 1e-13 relative, float32 within 1e-6 (the same
products summed in another order); output diagonals and CSR patterns
exactly the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import utils
from tpu_spmv.ops.spgemm import spgemm as j_spgemm
from tpu_spmv.ops.spgemm import spgemm_csr as j_spgemm_csr
from tpu_spmv_torch.kernels import dia_stream as tds

from _solver_reference import rel

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-13}


def _pair(m, dtype):
    """The same matrix as a DIA in both packages."""
    m = m.astype(dtype)
    return (tt.convert(tt.COO.from_scipy(m, device="cpu"), "dia"),
            ts.convert(ts.COO.from_scipy(m.tocoo(), dtype=dtype), "dia"))


def _shifted(m, dtype):
    (a, ja), n = _pair(m, dtype), m.shape[0]
    return ((tt.shift_diagonal(a, 2.0), ts.shift_diagonal(ja, 2.0)),
            (tt.shift_diagonal(a, -3.0), ts.shift_diagonal(ja, -3.0)),
            (m + 2 * sp.identity(n)) @ (m - 3 * sp.identity(n)))


#: case -> (A pair, B pair, scipy A @ B, value type)
DIA_CASES = {
    "laplacian squared": lambda: (
        *[_pair(utils.laplacian_2d(12), np.float32)] * 2,
        utils.laplacian_2d(12) @ utils.laplacian_2d(12), np.float32),
    "different bands": lambda: (_pair(utils.banded(300, 2, seed=41),
                                      np.float64),
                                _pair(utils.banded(300, 4, seed=42),
                                      np.float64),
                                utils.banded(300, 2, seed=41)
                                @ utils.banded(300, 4, seed=42), np.float64),
    "shift composition": lambda: (*_shifted(utils.laplacian_2d(10),
                                            np.float32), np.float32),
}


@pytest.mark.parametrize("case", DIA_CASES)
def test_spgemm_dia_matches_reference(case):
    """DIA x DIA: the reference's output diagonals and structural nnz, its
    values within the limit, and scipy's product; A^2 of the Poisson
    (13 diagonals) runs through K1's pack (its plain version here)."""
    (A, jA), (B, jB), ref, dtype = DIA_CASES[case]()
    C, jC = tt.spgemm(A, B), j_spgemm(jA, jB)
    assert isinstance(C, tt.DIA) and C.offsets == jC.offsets
    assert C.nnz == jC.nnz and C.dtype == A.dtype
    assert rel(C.data, np.asarray(jC.data)) <= TOL[dtype]
    assert rel(C.todense(), ref.toarray()) <= 2 * TOL[dtype]
    if case == "laplacian squared":
        assert len(C.offsets) == 13
        x = np.random.default_rng(1).random(C.shape[0]).astype(np.float32)
        y = tds.spmv_sdia(tds.pack_sdia(C), torch.from_numpy(x))
        assert rel(y, ref @ x.astype(np.float64)) <= 2e-5


def test_spgemm_structurally_zero_products():
    """A nilpotent shift squared is the empty DIA, ``offsets=(0,)`` and
    ``nnz=0``, as in the reference; disjoint supports give an empty CSR
    of the right shape."""
    A = tt.DIA(data=torch.ones(1, 4), offsets=(3,), shape=(4, 4), nnz=1)
    jA = ts.DIA(data=jnp.ones((1, 4), jnp.float32), offsets=(3,),
                shape=(4, 4), nnz=1)
    C, jC = tt.spgemm(A, A), j_spgemm(jA, jA)
    assert C.offsets == jC.offsets == (0,) and C.nnz == jC.nnz == 0
    assert not torch.any(C.data) and C.data.shape == (1, 4)
    a = sp.csr_matrix((np.ones(5), (np.arange(5), np.arange(5))),
                      shape=(200, 200))
    b = sp.csr_matrix((np.ones(5), (np.arange(150, 155), np.arange(5))),
                      shape=(200, 200))
    Z = tt.spgemm_csr(a, b, device="cpu")
    assert Z.nnz == 0 and Z.shape == (200, 200)
    assert Z.indptr.shape == (201,) and not torch.any(Z.indptr)
    assert np.asarray(j_spgemm_csr(a, b).data).size == 0


#: case -> (A, B, value type)
CSR_CASES = {
    "random square": lambda: (utils.random_sparse(300, 300, 0.02, seed=0),
                              utils.random_sparse(300, 300, 0.02, seed=10),
                              np.float64),
    "rectangular": lambda: (utils.random_sparse(200, 350, 0.03, seed=3),
                            utils.random_sparse(350, 120, 0.03, seed=4),
                            np.float64),
    "power law": lambda: (utils.power_law(400, 400, avg_nnz_per_row=6,
                                          seed=5),) * 2 + (np.float32,),
}


@pytest.mark.parametrize("case", CSR_CASES)
def test_spgemm_csr_matches_reference(case):
    """General operands: the reference's pattern exactly, its values
    within the limit, bitwise the same on a second call."""
    a, b, dtype = CSR_CASES[case]()
    a, b = a.tocsr().astype(dtype), b.tocsr().astype(dtype)
    C = tt.spgemm_csr(a, b, device="cpu")
    jC = j_spgemm_csr(a, b)
    assert C.shape == jC.shape and C.dtype == torch.from_numpy(
        np.zeros(0, dtype)).dtype
    for f in ("indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(getattr(C, f).numpy(),
                                      np.asarray(getattr(jC, f)))
    assert rel(C.data, np.asarray(jC.data)) <= TOL[dtype]
    assert torch.equal(C.data, tt.spgemm_csr(a, b, device="cpu").data)


def test_spgemm_routes_other_pairs_and_port_formats():
    """spgemm of two non-DIA operands is spgemm_csr, port formats taken
    as operands (on their device), and the product feeds the SpMV."""
    m = utils.laplacian_2d(8)
    csr = tt.convert(tt.COO.from_scipy(m, dtype=torch.float64,
                                       device="cpu"), "csr")
    coo = tt.COO.from_scipy(m, dtype=torch.float64, device="cpu")
    ref = (m @ m).tocsr()
    jcoo = ts.COO.from_scipy(m.tocoo(), dtype=jnp.float64)
    jC = j_spgemm(ts.convert(jcoo, "csr"), jcoo)
    for C in (tt.spgemm(csr, coo), tt.spgemm_csr(coo, csr)):
        assert isinstance(C, tt.CSR) and C.data.device.type == "cpu"
        assert abs(C.to_scipy() - ref).max() < 1e-13
        np.testing.assert_array_equal(C.indices.numpy(),
                                      np.asarray(jC.indices))
    x = np.random.default_rng(2).random(64)
    assert rel(tt.spmv(C, torch.from_numpy(x)), ref @ x) <= 1e-13


def test_spgemm_csr_guards():
    """Both packages refuse mismatched inner dimensions and an expansion
    above ``max_pairs``."""
    a = utils.random_sparse(50, 60, 0.2, seed=1).tocsr()
    b = utils.random_sparse(61, 50, 0.2, seed=2).tocsr()
    b2 = utils.random_sparse(60, 50, 0.5, seed=2).tocsr()
    for fn, kw in ((tt.spgemm_csr, {"device": "cpu"}),
                   (j_spgemm_csr, {})):
        with pytest.raises(ValueError, match="inner dimensions"):
            fn(a, b, **kw)
        with pytest.raises(ValueError, match="max_pairs"):
            fn(a, b2, max_pairs=10, **kw)
