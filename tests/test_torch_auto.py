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
from tpu_spmv_torch.ops.auto import analyze, general_strategy, plan_spmv

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
    """The reference plans a scattered pattern to BSR / ELL / CSR on the
    CPU (or its Pallas kernels on a TPU); the port's general arm runs its
    own GPR or sliced-ELL kernels, so only the outputs compare.  Only an
    empty matrix still plans to CSR, and a reference plan of an arm the
    port lacks does not carry over."""
    m = utils.random_sparse(300, 300, 0.02, seed=3)
    plan_j = jauto.plan_spmv(m, dtype=np.float64)
    plan = plan_spmv(m, dtype=torch.float64, device="cpu")
    assert plan.strategy in ("gpr", "pallas_ell")
    assert analyze(m) == plan.stats
    enc, matvec, dec = plan.solver_space()
    x = np.random.default_rng(2).standard_normal(300)
    y = plan(torch.from_numpy(x))
    assert _rel(y, np.asarray(plan_j(jnp.asarray(x)))) <= 1e-13
    assert torch.equal(dec(matvec(enc(torch.from_numpy(x)))), y)
    import scipy.sparse as sp

    assert plan_spmv(sp.csr_matrix((4, 4)), device="cpu").strategy == "csr"
    with pytest.raises(ValueError, match="not ported"):
        from_reference(dataclasses.replace(plan_j, strategy="bsr"),
                       device="cpu")


def test_powerlaw_fixture_plans_gpr_in_both():
    """Rows over 128 entries take GPR in both planners (the hub rule)."""
    import os

    import scipy.io as sio

    m = sio.mmread(os.path.join(os.path.dirname(__file__), "fixtures",
                                "powerlaw800.mtx")).tocsr()
    plan_j = jauto.plan_spmv(m, use_pallas=True, dtype=np.float32)
    plan = plan_spmv(m, dtype=torch.float32, device="cpu")
    assert plan.strategy == plan_j.strategy == "gpr"
    assert plan.matrix.nv == plan_j.matrix.nv > 0
    x = np.random.default_rng(3).random(800).astype(np.float32)
    assert _rel(plan(torch.from_numpy(x)), m @ x.astype(np.float64)) <= 2e-5
    with pytest.raises(TypeError, match="re-plan"):
        from_reference(plan_j, device="cpu")


def test_irregular_plan_matches_reference():
    """The operand where the reference picks its packed-ELL kernel: the
    port picks by its own byte rule (GPR here) and computes the same y."""
    m = utils.random_sparse(256, 256, 0.05, seed=20)
    plan_j = jauto.plan_spmv(m, use_pallas=True, dtype=np.float32)
    assert plan_j.strategy == "pallas_ell"
    plan = plan_spmv(m, dtype=torch.float32, device="cpu")
    counts = np.diff(m.indptr)
    assert plan.strategy == general_strategy(counts, m.nnz, 4) == "gpr"
    x = np.random.default_rng(2).random(256).astype(np.float32)
    y_j = np.asarray(plan_j(jnp.asarray(x)))
    y = plan(torch.from_numpy(x))
    assert _rel(y, y_j) <= 1e-6
    assert _rel(y, m @ x.astype(np.float64)) <= 2e-5
    carried = from_reference(plan_j, device="cpu")
    assert carried.strategy == "pallas_ell"
    assert _rel(carried(torch.from_numpy(x)), y_j) <= 1e-6


@pytest.mark.parametrize("counts,itemsize,strategy", [
    ([5] * 64, 4, "pallas_ell"),             # equal rows: no pads
    ([5] * 63 + [129], 4, "gpr"),            # a hub row
    ([1, 20] * 32, 4, "gpr"),                # half the slots are pads
    ([2] + [1] * 15 + [0] * 16, 4, "pallas_ell"),   # tie: 47 pad slots
    ([2] + [1] * 14 + [0] * 17, 4, "gpr"),   # 48 pad slots
    ([6] + [5] * 31, 8, "pallas_ell"),       # 31 pads x 12 + 8 < 384
    ([6] + [5] * 30 + [4], 8, "gpr"),        # 32 pads x 12 + 8 > 384
])
def test_byte_rule(counts, itemsize, strategy):
    """ELL: slots x (itemsize + 4) + slices x 8 against GPR: nnz x
    (itemsize + 4) + rows x 12, ties to ELL; rows over 128 force GPR."""
    counts = np.asarray(counts)
    assert general_strategy(counts, int(counts.sum()), itemsize) == strategy


def test_entry_points_default_to_the_card():
    import inspect

    from tpu_spmv_torch.kernels.ell_packed import pack_ell
    from tpu_spmv_torch.kernels.gpr import pack_gpr

    for fn in (plan_spmv, pack_gpr, pack_ell):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


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
