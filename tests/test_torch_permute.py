"""Port permutation engine (K7a–K7e as one gather) against the JAX package.

The JAX side routes each permutation as a Clos network and applies it with
its Pallas kernels in interpret mode, as ``tests/test_permute.py`` does;
the port's plan is the index vector and its wrappers take the plain
versions (``index_select``) for CPU tensors.  Data movement only, so every
comparison is bitwise.  A JAX plan carried over with ``from_reference``
gives back the permutation it routes, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.kernels import permute as jp
from tpu_spmv_torch.interop import (compose_permutation, from_reference,
                                    tile_plan_from_planes)
from tpu_spmv_torch.kernels import permute as tp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    """JAX plans and interpret-mode outputs, shared by the tests (each
    interpret call costs seconds): n -> (perm, x, JAX plan, JAX out)."""
    rng = np.random.default_rng(61)
    out = {}
    for n in (1000, 16384):
        perm = rng.permutation(n)
        x = rng.random(n).astype(np.float32)
        plan = jp.plan_permutation(perm)
        out[n] = (perm, x, plan, np.asarray(
            jp.apply_permutation(plan, jnp.asarray(x), interpret=True)))
    return out


@pytest.mark.parametrize("n", [1000, 16384])
def test_apply_permutation_matches_reference(reference, n):
    perm, x, jplan, yj = reference[n]
    before = dict(tp.LAUNCHES)
    plan = tp.plan_permutation(perm, device="cpu")
    assert plan.n == n and plan.perm.dtype == torch.int32
    y = tp.apply_permutation(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(y, tp.permute_reference(x, perm))
    assert tp.LAUNCHES == before          # CPU tensors take the plain version
    # the JAX plan carried over routes the same permutation
    np.testing.assert_array_equal(from_reference(jplan, device="cpu").perm,
                                  perm)


def test_apply_permutation_batched_matches_reference(reference):
    perm, _, jplan, _ = reference[1000]
    X = np.random.default_rng(62).random((3, 1000))
    Yj = np.asarray(jp.apply_permutation_batched(jplan, jnp.asarray(X),
                                                 interpret=True))
    plan = tp.plan_permutation(perm, device="cpu")
    Y = tp.apply_permutation_batched(plan, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(Y, Yj)
    np.testing.assert_array_equal(Y, X[:, perm])


@pytest.mark.parametrize("nrhs", [1, 40])
def test_apply_permutation_batched_rows(nrhs):
    rng = np.random.default_rng(63)
    perm = rng.permutation(777)
    X = torch.from_numpy(rng.random((nrhs, 777)).astype(np.float32))
    plan = tp.plan_permutation(perm, device="cpu")
    Y = tp.apply_permutation_batched(plan, X)
    assert torch.equal(Y, X[:, perm])
    for q in range(nrhs):
        assert torch.equal(Y[q], tp.apply_permutation(plan, X[q]))


def test_apply_tile_permutation_matches_reference():
    rng = np.random.default_rng(64)
    perm = rng.permutation(tp.TILE)
    planes = jp.plan_tile_permutation(perm)
    x = rng.random((128, 128)).astype(np.float32)
    yj = np.asarray(jp.apply_tile_permutation(jnp.asarray(x), planes,
                                              interpret=True))
    carried = tile_plan_from_planes(planes, device="cpu")
    np.testing.assert_array_equal(carried.perm, perm)
    for plan in (carried, tp.plan_tile_permutation(perm, device="cpu")):
        y = tp.apply_tile_permutation(torch.from_numpy(x), plan).numpy()
        np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.int64,
                                   torch.float16, torch.uint8])
def test_any_dtype_bitwise(dtype):
    rng = np.random.default_rng(65)
    perm = rng.permutation(1000)
    x = torch.from_numpy(rng.integers(0, 100, (10, 100))).to(dtype)
    plan = tp.plan_permutation(perm, device="cpu")
    y = tp.apply_permutation(plan, x)
    assert y.shape == x.shape and y.dtype == dtype
    assert torch.equal(y.reshape(-1), x.reshape(-1)[perm])


def test_dont_care_slots():
    """Negative entries are don't-care slots: the port writes zero there
    and the real slots still hold x[perm]; the JAX plan routes the real
    slots to the same sources."""
    rng = np.random.default_rng(66)
    n = 5000
    perm = rng.permutation(n)
    perm[rng.random(n) < 0.2] = -1
    real = perm >= 0
    x = rng.random(n) + 1.0
    plan = tp.plan_permutation(perm, device="cpu")
    y = tp.apply_permutation(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y[real], x[perm[real]])
    assert not y[~real].any()
    Y = tp.apply_permutation_batched(plan, torch.from_numpy(
        np.stack([x, 2 * x]))).numpy()
    np.testing.assert_array_equal(Y[:, real],
                                  np.stack([x, 2 * x])[:, perm[real]])
    assert not Y[:, ~real].any()
    composed = compose_permutation(jp.plan_permutation(perm, device=False))
    np.testing.assert_array_equal(composed[real], perm[real])


def test_from_reference_two_level():
    """A two-level JAX plan composes to its permutation exactly (routing
    planes only, no interpret run)."""
    perm = np.random.default_rng(67).permutation(30_000)
    jplan = jp.plan_permutation_two_level(perm, device=False)
    assert type(jplan).__name__ == "TwoLevelPlan"
    plan = from_reference(jplan, device="cpu")
    np.testing.assert_array_equal(plan.perm, perm)
    assert plan.n == 30_000


def test_plan_auto_and_checks():
    perm = np.random.default_rng(68).permutation(2000)
    auto = tp.plan_permutation_auto(perm, device="cpu")
    assert torch.equal(auto.perm, tp.plan_permutation(perm, device="cpu").perm)
    with pytest.raises(ValueError, match="< n"):
        tp.plan_permutation(np.array([0, 3, 1]), device="cpu")
    with pytest.raises(ValueError, match="16384 entries"):
        tp.plan_tile_permutation(np.arange(100), device="cpu")
    with pytest.raises(ValueError, match="elements"):
        tp.apply_permutation(auto, torch.zeros(1999))
    with pytest.raises(ValueError, match="nrhs"):
        tp.apply_permutation_batched(auto, torch.zeros(2000))
