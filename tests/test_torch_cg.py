"""Port CG against the JAX reference CG, float64, through the streaming-DIA
plans' padded solver space (the JAX plans run Pallas in interpret mode)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv import utils
from tpu_spmv.ops import auto as jauto
from tpu_spmv_torch.formats import COO, convert
from tpu_spmv_torch.ops.auto import plan_spmv

# the solvers packages export a function named cg over the module's name
jcg = importlib.import_module("tpu_spmv.solvers.cg")
tcg = importlib.import_module("tpu_spmv_torch.solvers.cg")

torch.set_num_threads(1)


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture
def plans(monkeypatch):
    """(scipy matrix, port plan, JAX plan) of a grid Poisson, float64."""
    monkeypatch.setattr(jauto, "_stream_on_cpu", True)
    monkeypatch.setattr(jauto, "_STREAM_MIN_BYTES", 1024)

    def make(g):
        m = utils.laplacian_2d(g)
        plan = plan_spmv(m, dtype=torch.float64, device="cpu")
        plan_j = jauto.plan_spmv(m, dtype=np.float64)
        assert plan.strategy == plan_j.strategy == "pdia_stream"
        return m, plan, plan_j

    return make


def _b(n, seed=0):
    return np.random.default_rng(seed).random(n)


def test_cg_matches_reference(plans):
    m, plan, plan_j = plans(16)
    b = _b(m.shape[0])
    res = tcg.cg(plan, torch.from_numpy(b), tol=1e-10)
    ref = jcg.cg(plan_j, jnp.asarray(b), tol=1e-10)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) and bool(ref.converged)
    assert res.x.shape == (m.shape[0],)
    assert _rel(res.x, ref.x) <= 1e-8
    assert np.linalg.norm(b - m @ res.x.numpy()) <= 1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("case", ["restarts", "stall"])
def test_cg_true_tol_restart_accounting(plans, case):
    """true_tol restarts from the current iterate until the TRUE residual
    holds; with the inner tol above true_tol an inner pass takes 0
    iterations and the restarts stop (the reference's accounting)."""
    m, plan, plan_j = plans(32)
    b = _b(m.shape[0], 1)
    kw = (dict(tol=1e-11, true_tol=1e-10, maxiter=30, max_restarts=20)
          if case == "restarts" else
          dict(tol=1e-4, true_tol=1e-14, maxiter=2000, max_restarts=50))
    res = tcg.cg(plan, torch.from_numpy(b), **kw)
    ref = jcg.cg(plan_j, jnp.asarray(b), **kw)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) == bool(ref.converged) == (case == "restarts")
    r_true = np.linalg.norm(b - m @ res.x.numpy())
    np.testing.assert_allclose(float(res.residual_norm), r_true, rtol=1e-6)
    if case == "restarts":
        assert res.iterations > 30
        assert r_true <= 1e-10 * np.linalg.norm(b)


def test_cg_runners_match_reference(plans):
    m, plan, plan_j = plans(16)
    b = _b(m.shape[0], 2)
    res = tcg.cg_runner(plan, iters=20)(torch.from_numpy(b))
    ref = jcg.cg_runner(plan_j, iters=20)(jnp.asarray(b))
    assert res.iterations == 20
    assert _rel(res.x, ref.x) <= 1e-10
    assert abs(float(res.residual_norm) - float(ref.residual_norm)) <= \
        1e-10 * float(ref.residual_norm)
    res_k = tcg.cg_runner_k(plan)(torch.from_numpy(b), 20)
    ref_k = jcg.cg_runner_k(plan_j)(jnp.asarray(b), 20)
    assert _rel(res_k.x, ref_k.x) <= 1e-10
    assert torch.equal(res_k.x, res.x)
    tol_run = tcg.cg_runner(plan, iters=500, tol=1e-9)(torch.from_numpy(b))
    tol_ref = jcg.cg_runner(plan_j, iters=500, tol=1e-9)(jnp.asarray(b))
    assert abs(tol_run.iterations - int(tol_ref.iterations)) <= 1
    assert bool(tol_run.converged)
    with pytest.raises(ValueError, match="iters"):
        tcg.cg_runner(plan, iters=0)


def test_jacobi_pcg_converges():
    m = utils.laplacian_2d(16) + 3.0 * utils.banded(256, 0, seed=1).multiply(
        utils.banded(256, 0, seed=1))            # SPD, varied diagonal
    A = convert(COO.from_scipy(m, dtype=torch.float64), "csr")
    np.testing.assert_array_equal(A.diagonal().numpy(), m.diagonal())
    b = _b(256, 3)
    M = tcg.jacobi_preconditioner(A)
    res = tcg.cg(A, torch.from_numpy(b), tol=1e-10, precond=M)
    plain = tcg.cg(A, torch.from_numpy(b), tol=1e-10)
    assert bool(res.converged)
    assert res.iterations <= plain.iterations
    assert np.linalg.norm(b - m @ res.x.numpy()) <= 1e-9 * np.linalg.norm(b)
    np.testing.assert_array_equal(
        tcg.safe_dinv(torch.tensor([2.0, 0.0, -4.0])).numpy(),
        [0.5, 1.0, -0.25])
    np.testing.assert_array_equal(tcg.safe_dinv_host([2.0, 0.0]), [0.5, 1.0])


def test_cg_through_the_general_arm():
    """f64 CG on bus420 through the port's general-arm plan against the
    reference's CG through its XLA tier (no interpret-mode kernel in the
    loop)."""
    import os

    import scipy.io as sio

    m = sio.mmread(os.path.join(os.path.dirname(__file__), "fixtures",
                                "bus420.mtx")).tocsr()
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    assert plan.strategy in ("gpr", "pallas_ell")
    plan_j = jauto.plan_spmv(m, use_pallas=False, dtype=np.float64)
    b = _b(m.shape[0], 4)
    res = tcg.cg(plan, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    ref = jcg.cg(plan_j, jnp.asarray(b), tol=1e-10, maxiter=2000)
    assert bool(res.converged) and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert _rel(res.x, ref.x) <= 1e-10
    assert np.linalg.norm(b - m @ res.x.numpy()) <= 1e-9 * np.linalg.norm(b)
