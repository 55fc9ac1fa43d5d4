"""Port distributed multigrid (``solvers/dist_multigrid.py``) against the
port's serial ``mg_preconditioner`` (which ``test_torch_multigrid.py``
holds against the JAX reference's) and once against the JAX reference's
``dist_mg_preconditioner``.

The V-cycle on slabs must apply the serial operator (the same hierarchy,
smoother and coarsest solve; the port's does the serial elementwise steps
in the serial order, so it is bitwise the serial one on the CPU), stay
symmetric across shards (exact-adjoint transfers: PCG validity) and give
``dist_cg`` the serial MG-PCG's iteration count.  The JAX V-cycle takes
about a minute a call outside ``jax.jit`` (its ``shard_map`` runs eagerly),
so its one call here runs inside one module-scoped ``jax.jit``.  Limits:
rtol 2e-5, atol 1e-6 in float32 (the reference's,
``tests/test_dist_multigrid.py:40``); symmetry to 1e-12 in float64.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_spmv import dist as jdist
from tpu_spmv.solvers import dist_mg_preconditioner as jax_dist_mg
from tpu_spmv_torch import COO, convert
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch import utils
from tpu_spmv_torch.solvers import (cg, dist_cg, dist_mg_preconditioner,
                                    mg_preconditioner)

torch.set_num_threads(1)


def _sharded(r, ndev):
    return tdist.ShardedVector.from_global(
        r, tdist.plan_uniform(r.shape[0], ndev))


@pytest.mark.parametrize("shape,ndev,kw", [
    ((32, 32), 1, {}), ((32, 32), 2, {}), ((32, 32), 4, {}),
    ((32, 24), 4, {}),
    # slabs of 4 rows < min_local: nothing sharded, the whole cycle runs
    # on shard 0 behind one gather
    ((32, 32), 8, {}),
    # 3-D: the default coarsest (8) would leave (16, 8, 8) one level
    ((16, 8, 8), 2, {"coarsest": 2, "min_local": 2}),
    ((32, 32), 4, {"shift": 0.5})])
def test_dist_vcycle_matches_serial(shape, ndev, kw):
    n = int(np.prod(shape))
    r = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    serial_kw = {k: v for k, v in kw.items() if k != "min_local"}
    z_ser = mg_preconditioner(shape, **serial_kw)(
        torch.from_numpy(r)).numpy()
    M = dist_mg_preconditioner(tdist.make_mesh(ndev, device="cpu"), shape,
                               **kw)
    z = M(_sharded(r, ndev))
    assert z.dtype == torch.float32 and z.starts == _sharded(r, ndev).starts
    z_dist = z.to_global()
    np.testing.assert_allclose(z_dist, z_ser, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(z_dist, z_ser)


def test_dist_vcycle_symmetric_and_checks():
    """``<M u, v> = <u, M v>`` in float64 at 4 shards (the restriction is
    the sharded prolongation's exact adjoint), and the reference's
    errors."""
    g = 32
    rng = np.random.default_rng(9)
    u, v = (_sharded(rng.standard_normal(g * g), 4) for _ in range(2))
    mesh = tdist.make_mesh(4, device="cpu")
    M = dist_mg_preconditioner(mesh, (g, g))
    lhs, rhs = float(tdist.blas.dot(M(u), v)), float(tdist.blas.dot(u, M(v)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs))
    with pytest.raises(ValueError, match="2-D/3-D"):
        dist_mg_preconditioner(mesh, (64,))
    with pytest.raises(ValueError, match="divisible"):
        dist_mg_preconditioner(mesh, (30, 32))
    with pytest.raises(ValueError, match="nu1 \\+ nu2"):
        dist_mg_preconditioner(mesh, (g, g), nu1=0, nu2=0)
    with pytest.warns(UserWarning, match="non-symmetric"):
        dist_mg_preconditioner(mesh, (g, g), nu1=1, nu2=2)
    with pytest.raises(ValueError, match="uniform"):
        M(tdist.ShardedVector.from_global(np.ones(g * g),
                                          tdist.plan_rows(
                                              utils.laplacian_2d(g).indptr,
                                              3, balance="rows")))


@pytest.fixture(scope="module")
def jax_vcycle():
    """The reference's V-cycle at (16, 16) on 2 shards and its input, in
    one ``jax.jit`` (compiled once)."""
    mesh = jdist.make_mesh(2)
    M = jax_dist_mg(mesh, (16, 16))
    r = np.random.default_rng(8).standard_normal(256).astype(np.float32)
    rj = jdist.ShardedVector.from_global(r, jdist.plan_uniform(256, 2))
    run = jax.jit(lambda c: M(jdist.ShardedVector(
        chunks=c, starts=rj.starts, length=rj.length)).chunks)
    return r, np.asarray(run(rj.chunks)).reshape(-1)


def test_dist_vcycle_matches_reference(jax_vcycle):
    r, z_ref = jax_vcycle
    M = dist_mg_preconditioner(tdist.make_mesh(2, device="cpu"), (16, 16))
    np.testing.assert_allclose(M(_sharded(r, 2)).to_global(), z_ref,
                               rtol=2e-5, atol=1e-6)


def test_dist_mgpcg_matches_serial_count():
    """``dist_cg(precond=dist_mg_preconditioner)`` over the NeighborCSR of
    the 32^2 Poisson at 4 shards (``balance="rows"``: the uniform split):
    the serial MG-PCG's iteration count, converged, and far fewer
    iterations than plain CG."""
    g = 32
    lap = utils.laplacian_2d(g).tocsr()
    b = np.random.default_rng(5).standard_normal(g * g)
    mesh = tdist.make_mesh(4, device="cpu")
    A = tdist.NeighborCSR.build(lap, 4, balance="rows", square=True)
    bs = tdist.ShardedVector.from_global(b, A.row_plan)
    res = dist_cg(mesh, A, bs, tol=1e-8, maxiter=200,
                  precond=dist_mg_preconditioner(mesh, (g, g)))
    ser = cg(convert(COO.from_scipy(lap), "csr"), torch.from_numpy(b),
             tol=1e-8, maxiter=200,
             precond=mg_preconditioner((g, g)))
    plain = dist_cg(mesh, A, bs, tol=1e-8, maxiter=500)
    assert bool(res.converged) and bool(ser.converged)
    assert res.iterations == ser.iterations < plain.iterations // 3
    x = res.x.to_global()
    assert np.linalg.norm(b - lap @ x) <= 1e-7 * np.linalg.norm(b)
    np.testing.assert_allclose(x, ser.x.numpy(), rtol=1e-9, atol=1e-12)
