"""Port RCM reordering against the JAX package and scipy.

Operand: ``tests/test_reorder.py``'s banded matrix in a random node order
(``banded(300, 4, seed=81)``), float64.  The RCM permutation and both
bandwidths must equal the reference's exactly; products agree to rel 1e-13
(the same sums in the same order up to FMA contraction).  The port's
planner takes the streaming DIA at every size, where the reference on the
CPU picks plain DIA below its TPU VMEM threshold, so the strategies differ
by that name only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_spmv import reorder as jreorder
from tpu_spmv import utils
from tpu_spmv_torch import reorder as treorder
from tpu_spmv_torch.formats import COO, convert
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import permute as tp
from tpu_spmv_torch.ops.auto import plan_spmv

torch.set_num_threads(1)

TOL = 1e-13


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))


def _shuffled_banded(n=300, bw=4, seed=81):
    rng = np.random.default_rng(seed)
    A = utils.banded(n, bw, seed=seed)
    p = rng.permutation(n)
    return A[p][:, p].tocsr()


@pytest.fixture(scope="module")
def ops():
    A = _shuffled_banded()
    return A, jreorder.reorder_plan(A), treorder.reorder_plan(A,
                                                               device="cpu")


def test_rcm_matches_reference(ops):
    A, jro, tro = ops
    np.testing.assert_array_equal(treorder.rcm_permutation(A),
                                  jreorder.rcm_permutation(A))
    np.testing.assert_array_equal(tro.perm.numpy(), np.asarray(jro.perm))
    np.testing.assert_array_equal(tro.inv_perm.numpy(),
                                  np.asarray(jro.inv_perm))
    assert (tro.bandwidth_before, tro.bandwidth_after) == \
        (jro.bandwidth_before, jro.bandwidth_after)
    assert tro.bandwidth_before > 50 and tro.bandwidth_after <= 14
    assert tro.perm.dtype == torch.int64


def test_strategy_differs_only_by_the_stream_threshold(ops):
    _, jro, tro = ops
    assert tro.strategy == "rcm+dia_stream"
    # the reference streams only past its 32 MiB VMEM threshold
    assert jro.strategy == "rcm+dia"
    direct = plan_spmv(_shuffled_banded(), device="cpu")
    assert direct.strategy in ("gpr", "pallas_ell")


def test_reordered_operator_matches_reference(ops):
    A, jro, tro = ops
    rng = np.random.default_rng(82)
    x = rng.standard_normal(A.shape[0])
    y0 = rng.standard_normal(A.shape[0])
    before = dict(tp.LAUNCHES)
    y = tro(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(jro(jnp.asarray(x)))) <= TOL
    assert _rel(y, A @ x) <= TOL
    acc = tro(torch.from_numpy(x), torch.from_numpy(y0)).numpy()
    assert _rel(acc, np.asarray(jro(jnp.asarray(x), jnp.asarray(y0)))) <= TOL
    assert _rel(acc, y0 + A @ x) <= TOL
    assert tp.LAUNCHES == before


def test_permuted_space_usage(ops):
    """Permute once, solve in permuted space, permute the result back."""
    A, _, tro = ops
    x = np.random.default_rng(83).standard_normal(A.shape[0])
    xp = torch.from_numpy(x)[tro.perm]
    assert torch.equal(xp, tp.apply_permutation(tro.perm_plan,
                                                torch.from_numpy(x)))
    y = tro.plan(xp)[tro.inv_perm].numpy()
    assert _rel(y, A @ x) <= TOL


def test_from_reference_reordered_operator(ops):
    A, jro, _ = ops
    ro = from_reference(jro, device="cpu")
    assert ro.strategy == jro.strategy
    np.testing.assert_array_equal(ro.perm.numpy(), np.asarray(jro.perm))
    x = np.random.default_rng(84).standard_normal(A.shape[0])
    assert _rel(ro(torch.from_numpy(x)).numpy(), A @ x) <= TOL


def test_reorder_port_format_and_float32():
    A = _shuffled_banded(200, 3, seed=85)
    coo = COO.from_scipy(A, dtype=torch.float32)
    ro = treorder.reorder_plan(convert(coo, "csr"), device="cpu")
    assert ro.plan.strategy == "dia_stream"
    assert ro.bandwidth_after == treorder.bandwidth(A[ro.perm.numpy()][
        :, ro.perm.numpy()])
    x = np.random.default_rng(86).random(200).astype(np.float32)
    y = ro(torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), A @ x.astype(np.float64)) <= 2e-6


def test_rcm_requires_square():
    with pytest.raises(ValueError, match="square"):
        treorder.rcm_permutation(utils.random_sparse(10, 20, 0.2, seed=82))


def test_bandwidth_helper():
    assert treorder.bandwidth(sp.csr_matrix(np.diag(np.ones(5)))) == 0
    B = sp.csr_matrix(([1.0], ([0], [4])), shape=(5, 5))
    assert treorder.bandwidth(B) == 4
    assert treorder.bandwidth(COO.from_scipy(B)) == 4
    assert treorder.bandwidth(sp.csr_matrix((5, 5))) == 0
