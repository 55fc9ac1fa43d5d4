"""Port geometric multigrid against the JAX reference, float64, at 16^2
and 16^3.

Limits: the stencil equals the matrix of ``laplacian_2d/_3d`` (+ shift)
to 1e-14; the restriction is the adjoint of the prolongation, ``<P u, r>
= 2^d <u, R r>``, to 1e-12 relative; ``mg_preconditioner(r)`` against the
reference's to 1e-12; MG-PCG iterations within +-1 of the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as J
from tpu_spmv import utils
from tpu_spmv_torch import solvers as T
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.solvers import multigrid

from _solver_reference import reference_planning, rel, rhs

torch.set_num_threads(1)

SHAPES = {"2d": (16, 16), "3d": (16, 16, 16)}


def _laplacian(shape):
    return (utils.laplacian_2d(*shape) if len(shape) == 2
            else utils.laplacian_3d(*shape))


@pytest.fixture(scope="module")
def mgpcg():
    """The reference's MG-PCG iteration counts and preconditioner outputs
    (its CG through its interpret-mode PSDIA plan), computed once."""
    out = {}
    with reference_planning() as jauto:
        for name, shape in SHAPES.items():
            m = _laplacian(shape)
            b = rhs(m.shape[0])
            r = rhs(m.shape[0], 2)
            pj = jauto.plan_spmv(m, dtype=np.float64)
            P = J.mg_preconditioner(shape)
            res = J.cg(pj, jnp.asarray(b), tol=1e-10, precond=P)
            out[name] = (int(res.iterations), bool(res.converged),
                         np.asarray(P(jnp.asarray(r))))
    return out


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_stencil_is_the_laplacian(dim):
    shape = SHAPES[dim]
    m = (_laplacian(shape) + 0.5 * sp.identity(np.prod(shape))).tocsr()
    u = rhs(m.shape[0], 5)
    y = T.poisson_stencil_apply(torch.from_numpy(u).reshape(shape), 0.5)
    assert rel(y.reshape(-1), m @ u) <= 1e-14


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_restriction_is_the_scaled_adjoint(dim):
    shape = SHAPES[dim]
    coarse = tuple(g // 2 for g in shape)
    gen = np.random.default_rng(7)
    u = torch.from_numpy(gen.random(coarse))
    r = torch.from_numpy(gen.random(shape))
    lhs = float((multigrid._prolong(u) * r).sum())
    rhs_ = 2 ** len(shape) * float((u * multigrid._restrict(r)).sum())
    assert abs(lhs - rhs_) <= 1e-12 * abs(lhs)
    # rows of R sum to 1: a constant restricts to the same constant
    ones = torch.ones(shape, dtype=torch.float64)
    assert torch.allclose(multigrid._restrict(ones),
                          torch.ones(coarse, dtype=torch.float64),
                          rtol=0, atol=1e-15)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_preconditioner_matches_reference(mgpcg, dim):
    shape = SHAPES[dim]
    r = rhs(int(np.prod(shape)), 2)
    z = T.mg_preconditioner(shape)(torch.from_numpy(r))
    assert rel(z, mgpcg[dim][2]) <= 1e-12


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_mgpcg_iterations_match_reference(mgpcg, dim):
    shape = SHAPES[dim]
    m = _laplacian(shape)
    b = rhs(m.shape[0])
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    res = T.cg(plan, torch.from_numpy(b), tol=1e-10,
               precond=T.mg_preconditioner(shape))
    iters, converged, _ = mgpcg[dim]
    assert abs(res.iterations - iters) <= 1
    assert bool(res.converged) and converged
    plain = T.cg(plan, torch.from_numpy(b), tol=1e-10)
    assert res.iterations < plain.iterations
    assert np.linalg.norm(b - m @ res.x.numpy()) \
        <= 1e-9 * np.linalg.norm(b)
