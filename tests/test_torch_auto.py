"""Port planner against the JAX reference planner.

The JAX planner takes its streaming arms on the CPU only through its test
hooks (``_stream_on_cpu``, ``_STREAM_MIN_BYTES``), as ``tests/test_auto.py``
does; the port takes them at every size.  Its JAX plans run the Pallas
kernels in interpret mode on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv import utils
from tpu_spmv.ops import auto as jauto
from tpu_spmv_torch.bench.roofline import spmv_bytes
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.ops.auto import analyze, plan_spmv

torch.set_num_threads(1)

MATS = {
    "laplacian_2d(32)": (lambda: utils.laplacian_2d(32), "pdia_stream"),
    "laplacian_3d(8)": (lambda: utils.laplacian_3d(8), "pdia_stream"),
    "banded(4000,3)": (lambda: utils.banded(4000, 3, seed=11), "dia_stream"),
}


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture
def jax_streaming(monkeypatch):
    monkeypatch.setattr(jauto, "_stream_on_cpu", True)
    monkeypatch.setattr(jauto, "_STREAM_MIN_BYTES", 1024)


@pytest.mark.parametrize("name", MATS)
def test_plan_matches_reference(name, jax_streaming):
    make, strategy = MATS[name]
    m = make()
    plan_j = jauto.plan_spmv(m, dtype=np.float32)
    plan = plan_spmv(m, dtype=torch.float32, device="cpu")
    assert plan.strategy == plan_j.strategy == strategy
    assert dataclasses.asdict(plan.stats) == dataclasses.asdict(plan_j.stats)
    A, A_j = plan.matrix, plan_j.matrix
    assert (A.offsets, A.L, A.rb, A.npad) == (A_j.offsets, A_j.L, A_j.rb,
                                             A_j.npad)
    assert getattr(A, "period", None) == getattr(A_j, "period", None)
    coef = "pattern" if strategy == "pdia_stream" else "data"
    np.testing.assert_array_equal(getattr(A, coef).numpy(),
                                  np.asarray(getattr(A_j, coef)))

    x = np.random.default_rng(0).random(m.shape[1]).astype(np.float32)
    y_j = np.asarray(plan_j(jnp.asarray(x)))
    y = plan(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m.shape[0],)
    assert _rel(y, y_j) <= 1e-6
    assert _rel(y, m @ x.astype(np.float64)) <= 2e-5
    # a reference plan carried over runs the same product
    carried = from_reference(plan_j, device="cpu")
    assert carried.strategy == strategy
    assert _rel(carried(torch.from_numpy(x)), y_j) <= 1e-6
    # the byte model agrees with the reference's
    from tpu_spmv.bench.roofline import spmv_bytes as jbytes

    assert spmv_bytes(A, torch.float32) == jbytes(A_j, jnp.float32)


@pytest.mark.parametrize("name", MATS)
def test_solver_space_round_trips(name):
    m = MATS[name][0]()
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    enc, matvec, dec = plan.solver_space()
    x = torch.from_numpy(np.random.default_rng(1).random(m.shape[0]))
    v = enc(x)
    assert v.shape == (plan.matrix.npad,)
    assert torch.equal(dec(v), x)
    w = matvec(v)
    assert bool((w[:plan.matrix.L] == 0).all())
    assert bool((w[plan.matrix.L + m.shape[0]:] == 0).all())
    assert torch.equal(dec(w), plan(x))


def test_general_arm_is_csr_until_ported():
    """The reference plans a scattered pattern to BSR / ELL / CSR (or its
    Pallas kernels on a TPU); the port's general arm is CSR until the
    general-sparsity kernels are ported, so only the outputs compare."""
    m = utils.random_sparse(300, 300, 0.02, seed=3)
    plan_j = jauto.plan_spmv(m, dtype=np.float64)
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    assert plan.strategy == "csr"
    assert analyze(m) == plan.stats
    enc, matvec, dec = plan.solver_space()
    x = np.random.default_rng(2).standard_normal(300)
    y = plan(torch.from_numpy(x))
    assert _rel(y, np.asarray(plan_j(jnp.asarray(x)))) <= 1e-13
    assert torch.equal(dec(matvec(enc(torch.from_numpy(x)))), y)
    with pytest.raises(ValueError, match="not ported"):
        from_reference(dataclasses.replace(plan_j, strategy="gpr"),
                       device="cpu")


def test_dia_arm_without_a_feasible_tile():
    """A band wider than any streaming tile stays plain DIA."""
    import scipy.sparse as sp

    n = 300_000
    offs = [-140_000, 0, 140_000]
    m = sp.diags([np.arange(1.0, n - 140_000 + 1), np.full(n, 4.0),
                  -np.arange(1.0, n - 140_000 + 1)], offs, shape=(n, n),
                 format="csr")
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    assert plan.strategy == "dia"
    x = np.random.default_rng(4).random(n)
    assert _rel(plan(torch.from_numpy(x)), m @ x) <= 1e-13
