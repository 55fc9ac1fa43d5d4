"""Port multi-RHS CG (``cg_multi``, ``cg_multi_runner``) against the JAX
reference's, float64 unless a test says otherwise.  The JAX side runs its
XLA tier (a CSR operator, no interpret-mode kernel in the loop); the port
runs its plan's SpMM (plain versions on the CPU), a port format through
``ops/spmm.py`` or a matmat closure.

Limits: X against JAX rel 1e-10 in float64 and 1e-6 in float32 (k
independent recurrences, the same as the reference's up to rounding);
iteration counts within ±1; ``converged`` flags equal.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv_torch import COO as TCOO
from tpu_spmv_torch import convert as t_convert
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.ops.spmm import spmm as t_spmm
from tpu_spmv_torch.solvers import CGMultiResult, cg_multi, cg_multi_runner

# the solvers package exports a function named cg_multi over the module
jbcg = importlib.import_module("tpu_spmv.solvers.block_cg")

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _jax_csr(m, dtype=np.float64):
    return ts.convert(ts.COO.from_scipy(m, dtype=dtype), "csr")


def _jacobi(m, module):
    """The same Jacobi closure for both sides, from the host diagonal."""
    inv = 1.0 / m.diagonal()
    if module is torch:
        t = torch.from_numpy(inv)
        return lambda r: t * r
    j = jnp.asarray(inv)
    return lambda r: j * r


def _B(n, k, seed=0):
    return np.random.default_rng(seed).random((n, k))


def _check(res, ref, tol=1e-10):
    assert isinstance(res, CGMultiResult)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    assert res.x.shape == np.asarray(ref.x).shape
    assert _rel(res.x, ref.x) <= tol


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("mode", ["fixed", "tol"])
def test_cg_multi_matches_reference(mode, jacobi):
    """laplacian_2d(16) through the port's plan (PSDIA SpMM) against the
    reference on its CSR, k = 3."""
    m = utils.laplacian_2d(16)
    B = _B(m.shape[0], 3)
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    assert plan.strategy == "pdia_stream"
    kw = dict(tol=None, iters=25) if mode == "fixed" else dict(tol=1e-10,
                                                               iters=500)
    pt = _jacobi(m, torch) if jacobi else None
    pj = _jacobi(m, jnp) if jacobi else None
    res = cg_multi_runner(plan, precond=pt, **kw)(torch.from_numpy(B))
    ref = jbcg.cg_multi_runner(_jax_csr(m), precond=pj, **kw)(jnp.asarray(B))
    _check(res, ref)
    if mode == "tol":
        assert bool(res.converged.all())
        assert np.all(np.linalg.norm(B - m @ res.x.numpy(), axis=0)
                      <= 1e-9 * np.linalg.norm(B, axis=0))
    else:
        assert res.iterations == 25
        assert _rel(res.residual_norm, ref.residual_norm) <= 1e-8


def test_cg_multi_bus420_every_operator_form():
    """bus420 (the SPD power-network fixture) in tol mode with Jacobi:
    the plan, the port's CSR through ``ops/spmm.py`` and a matmat closure
    give the reference's solve."""
    m = sio.mmread(os.path.join(FIX, "bus420.mtx")).tocsr()
    B = _B(m.shape[0], 4, seed=1)
    ref = jbcg.cg_multi(_jax_csr(m), jnp.asarray(B), tol=1e-10, maxiter=2000,
                        precond=_jacobi(m, jnp))
    csr = t_convert(TCOO.from_scipy(m, dtype=torch.float64), "csr")
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    for A in (plan, csr, lambda X: t_spmm(csr, X)):
        res = cg_multi(A, torch.from_numpy(B), tol=1e-10, maxiter=2000,
                       precond=_jacobi(m, torch))
        _check(res, ref)
        assert bool(res.converged.all())


def test_cg_multi_float32_matches_reference():
    m = utils.laplacian_2d(16)
    B = _B(m.shape[0], 2, seed=2).astype(np.float32)
    plan = plan_spmv(m, dtype=torch.float32, device="cpu")
    res = cg_multi_runner(plan, iters=20, report_tol=1e-5)(
        torch.from_numpy(B))
    ref = jbcg.cg_multi_runner(_jax_csr(m, np.float32), iters=20,
                               report_tol=1e-5)(jnp.asarray(B))
    assert res.x.dtype == torch.float32
    _check(res, ref, tol=1e-6)


def test_converged_column_stays_frozen():
    """A column that converges first keeps its iterate and its search
    direction while the others run on: the SpMM sees the same column every
    later iteration, and its answer is the one-column solve's."""
    m = utils.laplacian_2d(16)
    n = m.shape[0]
    w, V = np.linalg.eigh(m.toarray())
    easy = V[:, :3] @ np.array([1.0, 2.0, 3.0])     # 3 eigencomponents
    B = np.stack([easy, _B(n, 1, seed=3)[:, 0]], axis=1)
    A = t_convert(TCOO.from_scipy(m, dtype=torch.float64), "csr")
    seen = []

    def matmat(P):
        seen.append(P[:, 0].clone())
        return t_spmm(A, P)

    res = cg_multi(matmat, torch.from_numpy(B), tol=1e-10, maxiter=500)
    alone = cg_multi(A, torch.from_numpy(B[:, :1].copy()), tol=1e-10,
                     maxiter=500)
    assert bool(res.converged.all()) and bool(alone.converged.all())
    k = alone.iterations
    assert k <= 4 and res.iterations > k + 10
    # calls: the initial residual, then iteration i's direction; the
    # column's last active iteration k sets the direction that every later
    # iteration passes unchanged
    assert len(seen) == res.iterations + 1
    assert not torch.equal(seen[k], seen[k + 1])
    assert all(torch.equal(p, seen[k + 1]) for p in seen[k + 2:])
    assert _rel(res.x[:, 0], alone.x[:, 0]) <= 1e-12
    assert float(res.residual_norm[0]) == pytest.approx(
        float(alone.residual_norm[0]), rel=1e-6)
    ref = jbcg.cg_multi(_jax_csr(m), jnp.asarray(B), tol=1e-10, maxiter=500)
    _check(res, ref)


def test_runner_checks():
    m = utils.laplacian_2d(8)
    A = t_convert(TCOO.from_scipy(m, dtype=torch.float64), "csr")
    with pytest.raises(ValueError, match="iters"):
        cg_multi_runner(A, iters=0)
    with pytest.raises(ValueError, match=r"\[n, k\]"):
        cg_multi(A, torch.ones(64, dtype=torch.float64))
    zero = cg_multi(A, torch.zeros(64, 2, dtype=torch.float64))
    assert zero.iterations == 0 and bool(zero.converged.all())
