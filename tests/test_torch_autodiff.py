"""Port gradients against ``jax.grad`` of the JAX package.

- ``spmv_sdia`` / ``spmv_psdia``: the reference's custom VJPs (Pallas in
  interpret mode, transposed pack for ``x``) against the port's autograd
  Functions (plain versions on CPU tensors): ``x_bar``, ``data_bar`` and
  ``pattern_bar`` within rel 1e-13 in float64 (the same products; the
  pattern fold sums its tiles in another order);
- ``torch.autograd.gradcheck`` of both Functions against finite
  differences;
- ``SpmvPlan.matvec_differentiable``: a GPR plan with an explicit
  transpose plan, held against ``jax.grad`` of the reference's
  ``matvec_differentiable`` on its XLA plan (``use_pallas=False``, no
  interpret-mode GPR compile), and the automatic transpose of a streaming
  plan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv.ops.auto import plan_spmv as jplan_spmv
from tpu_spmv_torch import COO, convert
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import gpr
from tpu_spmv_torch.ops.auto import plan_from_matrix, plan_spmv

torch.set_num_threads(1)

TOL = 1e-13


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _operand(kind):
    """(scipy matrix, JAX pack, port pack, coefficient field): an
    asymmetric random-valued band for SDIA, an asymmetric periodic
    stencil (period 12) for PSDIA."""
    if kind == "sdia":
        m = utils.banded(300, 3, seed=31)
    else:
        c = utils.laplacian_2d(12).tocoo()
        m = sp.csr_matrix((c.data * (1.0 + 0.1 * (c.col - c.row)),
                           (c.row, c.col)), shape=c.shape)
    dj = ts.convert(ts.COO.from_scipy(m.tocoo()), "dia")
    dt = convert(COO.from_scipy(m, dtype=torch.float64), "dia")
    if kind == "sdia":
        return m, jds.pack_sdia(dj, rb=256), tds.pack_sdia(dt, rb=256), "data"
    return (m, jds.pack_psdia(dj, period=12), tds.pack_psdia(dt, period=12),
            "pattern")


@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_streaming_grads_match_reference(kind):
    """d/d(A, x) of <w, A x>: x_bar = A^T w and the coefficient
    cotangent, against jax.grad through the reference's custom VJP."""
    m, Pj, Pt, coef = _operand(kind)
    rng = np.random.default_rng(32)
    x = rng.standard_normal(m.shape[1])
    w = rng.standard_normal(m.shape[0])
    jfn = jds.spmv_sdia if kind == "sdia" else jds.spmv_psdia
    tfn = tds.spmv_sdia if kind == "sdia" else tds.spmv_psdia

    gA, gx = jax.grad(lambda A, v: jnp.vdot(jnp.asarray(w),
                                            jfn(A, v, interpret=True)),
                      argnums=(0, 1))(Pj, jnp.asarray(x))
    c = getattr(Pt, coef).clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(dataclasses.replace(Pt, **{coef: c}), xt)
    torch.dot(torch.from_numpy(w), y).backward()
    assert _rel(xt.grad.numpy(), np.asarray(gx)) <= TOL
    assert _rel(xt.grad.numpy(), m.T @ w) <= TOL
    assert _rel(c.grad.numpy(), np.asarray(getattr(gA, coef))) <= TOL
    if kind == "sdia":
        # pads and out-of-range slots carry exactly zero gradient
        g = c.grad
        assert not g[:, :Pt.L].any() and not g[:, Pt.L + m.shape[0]:].any()


@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_streaming_gradcheck(kind):
    n = 6
    m = (utils.laplacian_2d(n) if kind == "psdia"
         else utils.banded(n * n, 2, seed=33))
    dt = convert(COO.from_scipy(m, dtype=torch.float64), "dia")
    # small row tiles keep the coefficient count (gradcheck's columns) low
    A = (tds.pack_sdia(dt, rb=8) if kind == "sdia"
         else tds.pack_psdia(dt, period=n, rb=2 * n))
    coef = "data" if kind == "sdia" else "pattern"
    fn = tds.spmv_sdia if kind == "sdia" else tds.spmv_psdia
    c = getattr(A, coef).clone().requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(34).standard_normal(
        n * n)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda cc, xx: fn(dataclasses.replace(A, **{coef: cc}), xx), (c, x))


def test_no_graph_without_grad():
    m = utils.laplacian_2d(8)
    A = tds.pack_psdia(convert(COO.from_scipy(m, dtype=torch.float64),
                               "dia"), period=8)
    y = tds.spmv_psdia(A, torch.ones(64, dtype=torch.float64))
    assert y.grad_fn is None


def test_matvec_differentiable_gpr_matches_reference():
    mat = utils.random_sparse(300, 260, 0.05, seed=21)
    plan = plan_from_matrix(gpr.pack_gpr(mat, device="cpu"), "gpr")
    plan_T = plan_spmv(mat.T.tocsr(), device="cpu")
    mv = plan.matvec_differentiable(plan_T)
    rng = np.random.default_rng(3)
    x, w = rng.random(260), rng.random(300)

    jmv = jplan_spmv(mat, use_pallas=False).matvec_differentiable(
        jplan_spmv(mat.T.tocsr(), use_pallas=False))
    gj = jax.grad(lambda v: jnp.vdot(jnp.asarray(w), jmv(v)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.dot(torch.from_numpy(w), mv(xt)).backward()
    assert _rel(xt.grad.numpy(), np.asarray(gj)) <= TOL
    assert _rel(xt.grad.numpy(), mat.T @ w) <= TOL
    with pytest.raises(TypeError, match="plan_spmv"):
        plan.matvec_differentiable()


def test_matvec_differentiable_auto_transpose():
    """A streaming plan derives plan_T itself (transpose_psdia)."""
    mat = utils.laplacian_2d(12)
    plan = plan_spmv(mat, device="cpu")
    assert plan.strategy == "pdia_stream"
    mv = plan.matvec_differentiable()
    x = torch.from_numpy(np.random.default_rng(5).random(144)
                         ).requires_grad_(True)
    (mv(x) ** 2).sum().backward()
    xv = x.detach().numpy()
    assert _rel(x.grad.numpy(), 2.0 * (mat.T @ (mat @ xv))) <= TOL
