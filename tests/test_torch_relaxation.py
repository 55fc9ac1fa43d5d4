"""Port multicolor Gauss-Seidel, SOR and SymGS against the JAX reference,
float64 (the JAX plans run Pallas in interpret mode).

Limits: the colourings are equal (native and Python); one sweep agrees to
1e-13 relative; SOR and SymGS-preconditioned CG: iterations within +-1,
``x`` within 1e-10 relative."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

import tpu_spmv.solvers as J
from tpu_spmv_torch import solvers as T
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.solvers import relaxation

from _solver_reference import reference_planning, rel, rhs, screened

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
G = 16


def _bus420():
    return sio.mmread(os.path.join(FIX, "bus420.mtx")).tocsr()


@pytest.fixture(scope="module")
def case():
    m = screened(G)
    b = rhs(m.shape[0])
    with reference_planning() as jauto:
        pj = jauto.plan_spmv(m, dtype=np.float64)
    bj = jnp.asarray(b)
    P = J.symgs_preconditioner(pj, m)
    ref = {
        "sor": J.sor(pj, bj, host_mat=m, tol=1e-10, maxiter=2000),
        "ssor": J.sor(pj, bj, host_mat=m, omega=1.3, tol=1e-10,
                      maxiter=2000, symmetric=True),
        "symgs_cg": J.cg(pj, bj, tol=1e-10, precond=P),
    }
    return {"m": m, "b": b, "ref": ref,
            "plan": plan_spmv(m, dtype=torch.float64, device="cpu")}


@pytest.mark.parametrize("operand", ["laplacian", "bus420"])
def test_colours_equal_reference(operand):
    m = screened(G) if operand == "laplacian" else _bus420()
    color = T.multicolor(m)
    np.testing.assert_array_equal(color, J.multicolor(m))
    S = abs(m) + abs(m.T)
    rows, cols = S.nonzero()
    off = rows != cols
    assert not np.any(color[rows[off]] == color[cols[off]])
    if operand == "laplacian":
        assert color.max() + 1 == 2          # red-black


def test_python_colouring_equals_native(monkeypatch):
    m = _bus420()
    native = T.multicolor(m)
    monkeypatch.setattr(relaxation, "_router", lambda: None)
    np.testing.assert_array_equal(T.multicolor(m), native)


@pytest.mark.parametrize("symmetric", [False, True])
def test_gauss_seidel_sweep_matches_reference(case, symmetric):
    m, plan = case["m"], case["plan"]
    color = T.multicolor(m)
    x0 = np.random.default_rng(3).random(m.shape[0])
    dinv = 1.0 / m.diagonal()
    kw = dict(ncolors=int(color.max()) + 1, omega=1.2, symmetric=symmetric)
    got = T.gauss_seidel_sweep(plan, torch.from_numpy(case["b"]),
                               torch.from_numpy(x0),
                               color=torch.from_numpy(color),
                               dinv=torch.from_numpy(dinv), **kw)
    with reference_planning() as jauto:
        pj = jauto.plan_spmv(m, dtype=np.float64)
    want = J.gauss_seidel_sweep(pj, jnp.asarray(case["b"]), jnp.asarray(x0),
                                color=jnp.asarray(color),
                                dinv=jnp.asarray(dinv), **kw)
    assert rel(got, want) <= 1e-13


@pytest.mark.parametrize("kind", ["sor", "ssor"])
def test_sor_matches_reference(case, kind):
    kw = (dict(tol=1e-10, maxiter=2000) if kind == "sor" else
          dict(omega=1.3, tol=1e-10, maxiter=2000, symmetric=True))
    res = T.sor(case["plan"], torch.from_numpy(case["b"]),
                host_mat=case["m"], **kw)
    ref = case["ref"][kind]
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) and bool(ref.converged)
    assert rel(res.x, ref.x) <= 1e-10


def test_symgs_preconditioned_cg_matches_reference(case):
    P = T.symgs_preconditioner(case["plan"], case["m"])
    res = T.cg(case["plan"], torch.from_numpy(case["b"]), tol=1e-10,
               precond=P)
    ref = case["ref"]["symgs_cg"]
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged)
    assert rel(res.x, ref.x) <= 1e-10
    with pytest.raises(ValueError, match="host_mat"):
        T.sor(case["plan"], torch.from_numpy(case["b"]))
