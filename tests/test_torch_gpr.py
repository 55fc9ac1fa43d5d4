"""Port GPR (class-sorted CSR, hub rows split into virtual rows) against the
JAX reference's gather–permute–reduce pipeline, which runs its Pallas
kernels in interpret mode here.  The JAX products come from
``_gpr_reference`` (one compiled pack for every GPR test: each operand's
product is its block of a block-diagonal stack)."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _gpr_reference import OPERANDS, block
from tpu_spmv import utils
from tpu_spmv.kernels import gpr as jgpr
from tpu_spmv_torch.bench.roofline import spmv_bytes
from tpu_spmv_torch.kernels import gpr as tgpr

torch.set_num_threads(1)


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@functools.cache
def _reference(name):
    """(matrix, x, JAX pack, JAX f32 product) of one operand."""
    m, x, y = block(name)
    return m, x, jgpr.pack_gpr(m, dtype=np.float32), y


@pytest.mark.parametrize("name", OPERANDS)
def test_spmv_matches_reference(name):
    m, x, _, y_j = _reference(name)
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    y = tgpr.spmv_gpr(A, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m.shape[0],)
    ref = m @ x.astype(np.float64)
    assert _rel(y, y_j) <= 1e-6
    assert _rel(y, ref) <= 2e-5 and _rel(y_j, ref) <= 2e-5


@pytest.mark.parametrize("name", OPERANDS)
def test_pack_matches_reference(name):
    """The hub split (nv, hub_owner) and the width-class row counts are
    the reference pack's exactly."""
    m, _, A_j, _ = _reference(name)
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    assert A.nv == A_j.nv
    owner_j = (np.zeros(0, np.int32) if A_j.hub_owner is None
               else np.asarray(A_j.hub_owner))
    np.testing.assert_array_equal(A.hub_owner.numpy(), owner_j)
    assert A.class_rows == tuple(rows for _, _, rows in A_j.class_tiles)
    if name == "powerlaw800":
        assert A.nv > 0
    # a class-sorted CSR: rows is a permutation of the internal rows, and
    # each sorted row fits its class
    n_int = m.shape[0] + A.nv
    assert sorted(A.rows.tolist()) == list(range(n_int))
    lengths = np.diff(A.indptr.numpy())
    assert lengths.max() <= tgpr.LANES and A.nnz == m.nnz
    bounds = np.cumsum((0,) + A.class_rows)
    for c, W in enumerate(tgpr.CLASS_W):
        seg = lengths[bounds[c]:bounds[c + 1]]
        assert np.all(seg <= W)
        if c:
            assert np.all(seg > tgpr.CLASS_W[c - 1])


@pytest.mark.parametrize("name", OPERANDS)
def test_float64_against_scipy(name):
    m = OPERANDS[name]()
    x = np.random.default_rng(6).standard_normal(m.shape[1])
    A = tgpr.pack_gpr(m, device="cpu")
    assert A.dtype == torch.float64
    y = tgpr.spmv_gpr(A, torch.from_numpy(x))
    assert _rel(y, m @ x) <= 1e-12
    # y + A @ x
    y0 = torch.from_numpy(np.random.default_rng(7).random(m.shape[0]))
    assert _rel(tgpr.spmv_gpr(A, torch.from_numpy(x), y0),
                y0.numpy() + m @ x) <= 1e-12


def test_hub_split_and_fold():
    """A row of 300 entries splits into 128 + two virtual rows (128, 44);
    the kernel's row space holds their partial sums, and the fold adds
    them into the owner."""
    n = 6
    rows = np.concatenate([np.full(300, 2), [0, 5, 5]])
    cols = np.concatenate([np.arange(300), [1, 0, 299]])
    vals = np.random.default_rng(8).standard_normal(len(rows))
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, 300))
    A = tgpr.pack_gpr(m, device="cpu")
    assert A.nv == 2 and A.hub_owner.tolist() == [2, 2]
    assert A.hub_rows.tolist() == [2] and A.hub_ptr.tolist() == [0, 2]
    assert A.class_rows == (5, 0, 0, 1, 2)   # the 44-entry tail is class 64
    x = np.random.default_rng(9).standard_normal(300)
    y_int = tgpr.spmv_gpr_rows(A, torch.from_numpy(x)).numpy()
    d = m.toarray()
    parts = [d[2, :128] @ x[:128], d[2, 128:256] @ x[128:256],
             d[2, 256:] @ x[256:]]
    np.testing.assert_allclose(y_int[[2, 6, 7]], parts, rtol=1e-12)
    y = tgpr.fold_hub_rows(A, torch.from_numpy(y_int)).numpy()
    np.testing.assert_allclose(y, d @ x, rtol=1e-12, atol=1e-12)
    assert spmv_bytes(A) == (A.nnz * 12 + 8 * 12 + 8 + 8 * 3
                             + 300 * 8 + 6 * 8)


def test_wrapper_checks_and_envelope():
    m = utils.random_sparse(40, 50, 0.1, seed=1)
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        tgpr.spmv_gpr(A, torch.zeros(50, dtype=torch.float64))
    with pytest.raises(ValueError, match="ncol=50"):
        tgpr.spmv_gpr(A, torch.zeros(49))
    with pytest.raises(ValueError, match="matrix on cpu"):
        tgpr.spmv_gpr(A, torch.zeros(50, device="meta"))
    assert tgpr.LAUNCHES["gpr"] == 0       # plain versions are not counted
    assert tgpr.supports((10, 2**31 - 1), 10**10)
    assert not tgpr.supports((10, 2**31), 10)
    empty = tgpr.pack_gpr(sp.csr_matrix((3, 4)), device="cpu")
    assert empty.class_rows == (3, 0, 0, 0, 0)
    assert tgpr.spmv_gpr(empty, torch.ones(4, dtype=torch.float64)).tolist() \
        == [0.0, 0.0, 0.0]
