"""Port Chebyshev iteration, the Chebyshev preconditioner and Lanczos
against the JAX reference, float64, on the screened 16 x 16 Poisson (the
JAX plans run Pallas in interpret mode).

Limits: Chebyshev's ``x`` within 1e-10 relative and the same iteration
count; Lanczos from the same ``v0``: alphas and betas within 1e-10
relative; CG with the Chebyshev preconditioner at a given ``lmax``: ``x``
within 1e-10 and iterations within +-1; the power estimate of ``lmax``
(different start vectors) within 2% of the reference's and below the true
one, and CG on it within +-1 iteration of the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as J
from tpu_spmv_torch import solvers as T
from tpu_spmv_torch.formats import COO
from tpu_spmv_torch.ops.auto import plan_spmv

from _solver_reference import reference_planning, rel, rhs, screened

torch.set_num_threads(1)

G = 16
N = G * G


@pytest.fixture(scope="module")
def case():
    m = screened(G)
    b = rhs(N)
    v0 = np.random.default_rng(1).random(N) - 0.5
    dinv = 1.0 / m.diagonal()
    with reference_planning() as jauto:
        pj = jauto.plan_spmv(m, dtype=np.float64)
    bj, dj = jnp.asarray(b), jnp.asarray(dinv)
    lam_j, _ = J.power_iteration(lambda v: dj * pj(v), n=N, iters=20)

    def chebcg(lmax):
        P = J.chebyshev_preconditioner(pj, dinv=dj, n=N, lmax=lmax)
        return J.cg(pj, bj, tol=1e-10, precond=P)

    ref = {
        "cheby": J.chebyshev(pj, bj, lmin=1.0, lmax=9.0, tol=1e-10),
        "lanczos": J.lanczos(pj, k=30, v0=jnp.asarray(v0), n=N),
        "lanczos_reorth": J.lanczos(pj, k=30, v0=jnp.asarray(v0), n=N,
                                    full_reorth=True),
        "eigsh": J.eigsh_lanczos(pj, k=60, v0=jnp.asarray(v0), n=N),
        "lmax_est": float(lam_j),
        "chebcg_given": chebcg(1.8),
        "chebcg_est": chebcg(None),
    }
    return {"m": m, "b": b, "v0": v0, "dinv": dinv, "ref": ref,
            "plan": plan_spmv(m, dtype=torch.float64, device="cpu")}


def test_chebyshev_matches_reference(case):
    res = T.chebyshev(case["plan"], torch.from_numpy(case["b"]), lmin=1.0,
                      lmax=9.0, tol=1e-10)
    ref = case["ref"]["cheby"]
    assert res.iterations == int(ref.iterations)
    assert bool(res.converged) and bool(ref.converged)
    assert rel(res.x, ref.x) <= 1e-10


def test_chebyshev_refuses_a_bad_interval(case):
    with pytest.raises(ValueError, match="lmin < lmax"):
        T.chebyshev(case["plan"], torch.from_numpy(case["b"]), lmin=2.0,
                    lmax=2.0)


def test_chebcg_given_lmax_matches_reference(case):
    P = T.chebyshev_preconditioner(case["plan"],
                                   dinv=torch.from_numpy(case["dinv"]),
                                   n=N, lmax=1.8)
    res = T.cg(case["plan"], torch.from_numpy(case["b"]), tol=1e-10,
               precond=P)
    ref = case["ref"]["chebcg_given"]
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) and bool(ref.converged)
    assert rel(res.x, ref.x) <= 1e-10


def test_chebcg_power_estimate(case):
    dinv = torch.from_numpy(case["dinv"])
    plan = case["plan"]
    lam, _ = T.power_iteration(lambda v: dinv * plan(v), n=N, iters=20,
                               dtype=torch.float64, device="cpu")
    true = np.linalg.eigvalsh(
        case["m"].multiply(case["dinv"][:, None]).toarray()).max()
    assert abs(float(lam) - case["ref"]["lmax_est"]) \
        <= 0.02 * case["ref"]["lmax_est"]
    assert float(lam) <= true * (1 + 1e-12)
    P = T.chebyshev_preconditioner(plan, dinv=dinv, n=N)
    res = T.cg(plan, torch.from_numpy(case["b"]), tol=1e-10, precond=P)
    ref = case["ref"]["chebcg_est"]
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) and bool(ref.converged)


@pytest.mark.parametrize("full_reorth", [False, True])
def test_lanczos_coefficients_match_reference(case, full_reorth):
    res = T.lanczos(case["plan"], k=30, v0=torch.from_numpy(case["v0"]),
                    full_reorth=full_reorth)
    ref = case["ref"]["lanczos_reorth" if full_reorth else "lanczos"]
    assert res.alphas.shape == (30,) and res.betas.shape == (29,)
    assert rel(res.alphas, ref.alphas) <= 1e-10
    assert rel(res.betas, ref.betas) <= 1e-10
    assert (res.V is None) == (not full_reorth)
    if full_reorth:
        np.testing.assert_allclose(res.V.numpy() @ res.V.numpy().T,
                                   np.eye(30), atol=1e-12)


def test_eigsh_lanczos_ends(case):
    """Both ends against the reference's and the analytic spectrum of the
    screened Poisson, 1 + 8 sin^2(pi j / (2 (g + 1))) at j = 1 and g."""
    lmin, lmax = T.eigsh_lanczos(case["plan"], k=60,
                                 v0=torch.from_numpy(case["v0"]))
    ref_min, ref_max = case["ref"]["eigsh"]
    assert rel(lmin, ref_min) <= 1e-10 and rel(lmax, ref_max) <= 1e-10
    s = lambda j: np.sin(np.pi * j / (2 * (G + 1))) ** 2
    assert abs(lmin - (1 + 8 * s(1))) <= 1e-8
    assert abs(lmax - (1 + 8 * s(G))) <= 1e-8
    assert T.eigsh_lanczos(case["plan"], k=60, which="LM",
                           v0=torch.from_numpy(case["v0"])) == lmax


def test_lanczos_breakdown_is_cut():
    """diag(2, 3, 4) from e1 breaks down at the first step: the
    tridiagonal is cut there, so no spurious eigenvalue 0 appears."""
    m = sp.diags([2.0, 3.0, 4.0]).tocoo()
    A = COO.from_arrays(m.row, m.col, m.data, m.shape, dtype=torch.float64,
                        device="cpu")
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    assert T.eigsh_lanczos(A, k=3, v0=e1) == (2.0, 2.0)
    with pytest.raises(ValueError, match="which"):
        T.eigsh_lanczos(A, k=3, v0=e1, which="XX")
