"""Port BiCGSTAB, GMRES, LSQR and power iteration against the JAX
reference, float64 (the JAX plans run Pallas in interpret mode), and
GMRES in float32.

Limits: ``x`` within 1e-10 relative, iteration counts within +-1 and the
same ``converged``; the power iteration's eigenvalue within 1e-10 relative
(the two packages draw different start vectors, so it is taken on an
operand whose top eigenvalue has a gap).  Float32 GMRES: the same
``converged`` and a true residual within ``tol``, in no more steps than
the reference (its count is not held: see the test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as J
from tpu_spmv.formats import COO as JCOO, convert as jconvert
from tpu_spmv_torch import solvers as T
from tpu_spmv_torch.formats import COO, convert
from tpu_spmv_torch.ops.auto import plan_spmv

from _solver_reference import convection, reference_planning, rel, rhs, screened

torch.set_num_threads(1)

X_TOL = 1e-10
G = 16


def _jacobi(m, lib):
    inv = 1.0 / m.diagonal()
    if lib is torch:
        inv = torch.from_numpy(inv)
    else:
        inv = jnp.asarray(inv)
    return lambda r: inv * r


@pytest.fixture(scope="module")
def case():
    """Operators, right-hand sides and every JAX result, computed once."""
    ns, sym = convection(G), screened(G)
    b = rhs(ns.shape[0])
    with reference_planning() as jauto:
        pj_ns = jauto.plan_spmv(ns, dtype=np.float64)
        pj_sym = jauto.plan_spmv(sym, dtype=np.float64)
    bj = jnp.asarray(b)
    rect = sp.random(300, 120, density=0.05, random_state=3, format="csr")
    rect = (rect + sp.eye(300, 120)).tocsr()
    br = rhs(300, 1)
    jrect = jconvert(JCOO.from_scipy(rect), "csr")
    ref = {
        "bicgstab": J.bicgstab(pj_ns, bj, tol=1e-10),
        "bicgstab_jacobi": J.bicgstab(pj_ns, bj, tol=1e-10,
                                      precond=_jacobi(ns, jnp)),
        "gmres10": J.gmres(pj_ns, bj, tol=1e-10, restart=10),
        "gmres30": J.gmres(pj_ns, bj, tol=1e-10, restart=30),
        "lsqr_plan": J.lsqr(pj_sym, bj, tol=1e-10),
        "lsqr_rect": J.lsqr(jrect, jnp.asarray(br), tol=1e-10),
    }
    return {"ns": ns, "sym": sym, "b": b, "rect": rect, "br": br,
            "pt_ns": plan_spmv(ns, dtype=torch.float64, device="cpu"),
            "pt_sym": plan_spmv(sym, dtype=torch.float64, device="cpu"),
            "ref": ref}


def _same(res, ref):
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) == bool(ref.converged)
    assert rel(res.x, ref.x) <= X_TOL


def test_bicgstab_matches_reference(case):
    res = T.bicgstab(case["pt_ns"], torch.from_numpy(case["b"]), tol=1e-10)
    _same(res, case["ref"]["bicgstab"])
    assert bool(res.converged)
    r = case["b"] - case["ns"] @ res.x.numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(case["b"])


def test_bicgstab_preconditioned_matches_reference(case):
    res = T.bicgstab(case["pt_ns"], torch.from_numpy(case["b"]), tol=1e-10,
                     precond=_jacobi(case["ns"], torch))
    _same(res, case["ref"]["bicgstab_jacobi"])


@pytest.mark.parametrize("restart", [10, 30])
def test_gmres_matches_reference(case, restart):
    res = T.gmres(case["pt_ns"], torch.from_numpy(case["b"]), tol=1e-10,
                  restart=restart)
    _same(res, case["ref"][f"gmres{restart}"])
    assert bool(res.converged)
    r = case["b"] - case["ns"] @ res.x.numpy()
    np.testing.assert_allclose(float(res.residual_norm), np.linalg.norm(r),
                               rtol=1e-6)


def test_lsqr_plan_transpose_matches_reference(case):
    """A plan's own transpose() (K2 on the transposed PSDIA) as A^T."""
    res = T.lsqr(case["pt_sym"], torch.from_numpy(case["b"]), tol=1e-10)
    _same(res, case["ref"]["lsqr_plan"])
    assert bool(res.converged)


def test_lsqr_overdetermined_matches_reference(case):
    """A 300 x 120 least-squares problem on a CSR format (its transpose
    from ops.transpose)."""
    rect = case["rect"].tocoo()
    A = convert(COO.from_arrays(rect.row, rect.col, rect.data, rect.shape,
                                dtype=torch.float64, device="cpu"), "csr")
    res = T.lsqr(A, torch.from_numpy(case["br"]), tol=1e-10)
    ref = case["ref"]["lsqr_rect"]
    _same(res, ref)
    x_ls = np.linalg.lstsq(case["rect"].toarray(), case["br"], rcond=None)[0]
    assert rel(res.x, x_ls) <= 1e-8
    np.testing.assert_allclose(float(res.atr_norm), float(ref.atr_norm),
                               rtol=1e-3, atol=1e-12)


def test_power_iteration_on_a_gap():
    """diag(1 .. 5) with a top eigenvalue of 10: both packages' estimates
    agree with each other and with 10 to 1e-10, whatever their starts."""
    d = np.linspace(1.0, 5.0, 200)
    d[77] = 10.0
    m = sp.diags(d).tocoo()
    A = COO.from_arrays(m.row, m.col, m.data, m.shape, dtype=torch.float64,
                        device="cpu")
    lam, v = T.power_iteration(A, iters=200,
                               generator=torch.Generator().manual_seed(4))
    lam_j, _ = J.power_iteration(jconvert(JCOO.from_scipy(m), "csr"),
                                 iters=200)
    assert rel(float(lam), float(lam_j)) <= X_TOL
    assert abs(float(lam) - 10.0) <= 1e-9
    assert abs(abs(float(v[77])) - 1.0) <= 1e-9


def test_power_iteration_closure_needs_n(case):
    plan = case["pt_sym"]
    with pytest.raises(ValueError, match="n="):
        T.power_iteration(lambda v: plan(v))
    lam, _ = T.power_iteration(lambda v: plan(v), n=G * G, device="cpu",
                               dtype=torch.float64, iters=400)
    assert 8.5 < float(lam) <= 9.0


def test_solvers_take_a_matvec_closure(case):
    """A matvec closure gives the same iterates as the plan itself."""
    plan = case["pt_ns"]
    b = torch.from_numpy(case["b"])
    via_plan = T.bicgstab(plan, b, tol=1e-10)
    via_closure = T.bicgstab(lambda v: plan(v), b, tol=1e-10)
    assert via_plan.iterations == via_closure.iterations
    assert torch.equal(via_plan.x, via_closure.x)


def test_gmres_float32_converges_as_the_reference():
    """Float32 GMRES(30) on the screened ``laplacian_2d(128) + I``, tol
    1e-6 (the reference's plan: XLA ``dia`` on the CPU).  Both rotate the
    Hessenberg column in float32 and both converge.  The step counts
    differ (the reference 33: a whole cycle and 3 steps; the port 21): the
    reference's float32 dot products and norms of 16384 values are
    reductions XLA adds in an order that loses about 1e-6 of their
    value on the CPU, where torch's lose about 1e-8, and at tol 1e-6 that
    stalls its Givens estimate above tol for the rest of the first cycle.
    The port's estimate passes tol at step 20 with the true residual a
    hair above it, and its restart test (the true residual, the next
    cycle's start) adds one step."""
    import jax

    from tpu_spmv.ops import auto as jauto

    m = screened(128)
    b = rhs(m.shape[0]).astype(np.float32)
    pj = jauto.plan_spmv(m, dtype=np.float32)
    ref = jax.jit(lambda v: J.gmres(pj, v, tol=1e-6, restart=30))(
        jnp.asarray(b))
    res = T.gmres(plan_spmv(m, dtype=torch.float32, device="cpu"),
                  torch.from_numpy(b), tol=1e-6, restart=30)
    assert bool(res.converged) == bool(ref.converged) is True
    assert res.iterations <= int(ref.iterations)
    r = b - m @ res.x.numpy().astype(np.float64)
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b)
