"""Port sliced ELL against the JAX reference's packed-ELL Pallas kernel
(interpret mode here), the side COO for rows over 128 entries, and the
carry-over of a reference pack."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from tpu_spmv import utils
from tpu_spmv.kernels import ell_pallas
from tpu_spmv_torch.bench.roofline import spmv_bytes
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import ell_packed as tell

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
OPERANDS = {
    "laplacian_2d(40)": lambda: utils.laplacian_2d(40),
    "bus420": lambda: sio.mmread(os.path.join(FIX, "bus420.mtx")).tocsr(),
}


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.mark.parametrize("name", OPERANDS)
def test_spmv_matches_reference(name):
    """Port and reference products agree, each within the f32 gate of
    scipy float64; a reference pack carried over gives the same y."""
    m = OPERANDS[name]()
    x = np.random.default_rng(3).random(m.shape[1]).astype(np.float32)
    P = ell_pallas.pack_ell(m.astype(np.float32))
    y_j = np.asarray(ell_pallas.spmv_pallas(P, jnp.asarray(x),
                                            interpret=True))
    A = tell.pack_ell(m, dtype=torch.float32, device="cpu")
    y = tell.spmv_ell_packed(A, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m.shape[0],)
    ref = m @ x.astype(np.float64)
    assert _rel(y, y_j) <= 1e-6
    assert _rel(y, ref) <= 2e-5 and _rel(y_j, ref) <= 2e-5
    carried = from_reference(P, device="cpu")
    assert isinstance(carried, tell.PackedELL) and carried.nnz == m.nnz
    assert _rel(tell.spmv_ell_packed(carried, torch.from_numpy(x)), y_j) \
        <= 1e-6


@pytest.mark.parametrize("name", OPERANDS)
def test_float64_against_scipy(name):
    m = OPERANDS[name]()
    x = np.random.default_rng(4).standard_normal(m.shape[1])
    A = tell.pack_ell(m, device="cpu")
    assert A.dtype == torch.float64 and A.side.nnz == 0
    assert _rel(tell.spmv_ell_packed(A, torch.from_numpy(x)), m @ x) <= 1e-12


def test_side_coo_for_rows_over_128():
    """Entries past 128 in a row go to the side COO; the sum still holds."""
    n = 70
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.full(200, 3), np.full(150, 40),
                           rng.integers(0, n, 300)])
    cols = np.concatenate([np.arange(200), rng.permutation(400)[:150],
                           rng.integers(0, 400, 300)])
    m = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, 400))
    counts = np.diff(m.indptr)
    A = tell.pack_ell(m, device="cpu")
    assert A.side.nnz == int(np.maximum(counts - 128, 0).sum()) > 0
    assert sorted(set(A.side.row.tolist())) == [3, 40]
    assert A.slots + A.side.nnz >= m.nnz
    x = rng.standard_normal(400)
    assert _rel(tell.spmv_ell_packed(A, torch.from_numpy(x)), m @ x) <= 1e-12
    y0 = torch.from_numpy(rng.random(n))
    assert _rel(tell.spmv_ell_packed(A, torch.from_numpy(x), y0),
                y0.numpy() + m @ x) <= 1e-12
    assert spmv_bytes(A) == (A.slots * 12 + A.nslices * 8 + 8
                             + A.side.nnz * 16 + 400 * 8 + n * 8)


def test_layout():
    """32-row slices as wide as their longest row, slots column-major,
    pads value 0 and column 0, a short last slice."""
    n = 40
    lengths = np.zeros(n, np.int64)
    lengths[5], lengths[6], lengths[33] = 3, 1, 2
    rows = np.repeat(np.arange(n), lengths)
    cols = np.array([7, 8, 9, 4, 1, 2])
    m = sp.csr_matrix((np.arange(1.0, 7.0), (rows, cols)), shape=(n, 10))
    A = tell.pack_ell(m, device="cpu")
    assert A.slice_ptr.tolist() == [0, 96, 160]
    vals = A.vals.numpy()
    assert [vals[5 + 32 * j] for j in range(3)] == [1.0, 2.0, 3.0]
    assert [A.cols[5 + 32 * j].item() for j in range(3)] == [7, 8, 9]
    assert vals[6] == 4.0 and vals[6 + 32] == 0.0 and A.cols[6 + 32] == 0
    assert [vals[96 + 1], vals[96 + 32 + 1]] == [5.0, 6.0]
    assert np.count_nonzero(vals) == 6
    x = torch.arange(10, dtype=torch.float64)
    np.testing.assert_array_equal(tell.spmv_ell_main(A, x).numpy(),
                                  m @ x.numpy())


def test_wrapper_checks():
    m = utils.random_sparse(40, 50, 0.1, seed=1)
    A = tell.pack_ell(m, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        tell.spmv_ell_packed(A, torch.zeros(50, dtype=torch.float64))
    with pytest.raises(ValueError, match="ncol=50"):
        tell.spmv_ell_packed(A, torch.zeros(49))
    with pytest.raises(ValueError, match="matrix on cpu"):
        tell.spmv_ell_packed(A, torch.zeros(50, device="meta"))
    assert tell.LAUNCHES["ell"] == 0       # plain versions are not counted
    moved = A.to("cpu")
    assert moved.side.device == torch.device("cpu")
