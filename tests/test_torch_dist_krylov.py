"""Port distributed Krylov solvers against the JAX reference's:
``dist_gmres``, ``dist_bicgstab``, and ``dist_cg`` / ``dist_cg_ca`` with a
preconditioner.

The operand is the reference tests' nonsymmetric ``laplacian_2d(12, 12) +
0.5 (P - P^T) + 2 I`` (``tests/test_solvers.py:736-738``), in float64.
The port runs every CSR container (``ShardedCSR``, ``HaloCSR``,
``NeighborCSR``) at 1 and 4 shards on the CPU, with and without a sharded
Jacobi scale.  The JAX side runs on its virtual CPU devices; each of its
calls compiles anew (0.3-1 s), so it runs once a solver and shard count
(:data:`JAX_RUNS`: each container and each Jacobi setting once a solver),
computed once per module, and every port run is held to the JAX run of its
solver and shard count.  The operand's diagonal is constant, so the Jacobi
scale leaves each solver's iterates a scaling of the plain ones and its
counts the same.  Limits: x within 1e-8 relative; BiCGSTAB's
iterations equal; GMRES's flag equal and its count within one restart
cycle (the reference's own allowance, ``tests/test_solvers.py:779``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as jsolvers
import tpu_spmv_torch.solvers as tsolvers
from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.bench.dist_bench import sharded_jacobi

torch.set_num_threads(1)

TOL, RESTART = 1e-10, 40
KINDS = {"ShardedCSR": (tdist.ShardedCSR, jdist.ShardedCSR),
         "HaloCSR": (tdist.HaloCSR, jdist.HaloCSR),
         "NeighborCSR": (tdist.NeighborCSR, jdist.NeighborCSR)}
#: the JAX runs: (solver, ndev) -> (container, Jacobi?); each container
#: and each Jacobi setting once a solver
JAX_RUNS = {("dist_gmres", 4): ("NeighborCSR", True),
            ("dist_bicgstab", 4): ("HaloCSR", False),
            ("dist_gmres", 1): ("ShardedCSR", False),
            ("dist_bicgstab", 1): ("NeighborCSR", True)}


def _rel(y, ref) -> float:
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _nonsym() -> sp.csr_matrix:
    lap = utils.laplacian_2d(12, 12)
    pert = sp.random(144, 144, density=0.02, random_state=7, format="csr")
    return (lap + 0.5 * (pert - pert.T)
            + 2.0 * sp.eye(144, format="csr")).tocsr()


def _rhs() -> np.ndarray:
    return np.random.default_rng(5).standard_normal(144)


def _kw(solver):
    kw = {"tol": TOL, "maxiter": 2000}
    return {**kw, "restart": RESTART} if solver == "dist_gmres" else kw


def _jax_jacobi(m, plan):
    ds = jdist.ShardedVector.from_global(1.0 / m.diagonal(), plan)
    return lambda r: jdist.ShardedVector(chunks=r.chunks * ds.chunks,
                                         starts=r.starts, length=r.length)


def _port(solver, m, b, kind, ndev, jacobi):
    mesh = tdist.make_mesh(ndev, device="cpu")
    A = tdist.place(KINDS[kind][0].build(m, ndev, square=True), mesh)
    bs = tdist.place(tdist.ShardedVector.from_global(b, A.row_plan), mesh)
    pc = (sharded_jacobi(tdist.place(tdist.ShardedVector.from_global(
        1.0 / m.diagonal(), A.row_plan), mesh)) if jacobi else None)
    return getattr(tsolvers, solver)(mesh, A, bs, precond=pc, **_kw(solver))


@pytest.fixture(scope="module")
def reference():
    """Each JAX run of :data:`JAX_RUNS`: (iterations, converged, x)."""
    m, b = _nonsym(), _rhs()
    out = {}
    for (solver, ndev), (kind, jacobi) in JAX_RUNS.items():
        A = KINDS[kind][1].build(m, ndev, square=True)
        res = getattr(jsolvers, solver)(
            jdist.make_mesh(ndev), A,
            jdist.ShardedVector.from_global(b, A.row_plan),
            precond=_jax_jacobi(m, A.row_plan) if jacobi else None,
            **_kw(solver))
        out[solver, ndev] = (int(res.iterations), bool(res.converged),
                             res.x.to_global())
    return out


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("solver", ["dist_gmres", "dist_bicgstab"])
def test_dist_krylov_matches_reference(reference, solver, ndev):
    """Every container, with and without the Jacobi scale: converged, x
    against the JAX run and scipy, the counts as the module docstring
    says."""
    m, b = _nonsym(), _rhs()
    xs = sp.linalg.spsolve(m.tocsc(), b)
    for kind in KINDS:
        for jacobi in (False, True):
            res = _port(solver, m, b, kind, ndev, jacobi)
            it, ok, xj = reference[solver, ndev]
            x = res.x.to_global()
            assert bool(res.converged) == ok is True, (kind, jacobi)
            if solver == "dist_bicgstab":
                assert res.iterations == it, (kind, jacobi)
            else:
                assert abs(res.iterations - it) <= RESTART, (kind, jacobi)
            assert _rel(x, xj) <= 1e-8 and _rel(x, xs) <= 1e-8, (kind,
                                                                 jacobi)
            assert _rel(m @ x, b) <= 1e-9
            assert float(res.residual_norm) <= TOL * np.linalg.norm(b)


def test_dist_bicgstab_exact_mid_step():
    """On ``A = 2I`` the first half step solves exactly (``s = 0``): that
    is success after one step, and x keeps ``x + alpha ph`` = b / 2."""
    mesh = tdist.make_mesh(4, device="cpu")
    A = tdist.NeighborCSR.build(2.0 * sp.eye(36, format="csr"), 4,
                                square=True)
    b = np.random.default_rng(1).standard_normal(36)
    bs = tdist.ShardedVector.from_global(b, A.row_plan)
    res = tsolvers.dist_bicgstab(mesh, A, bs, tol=1e-10)
    assert res.iterations == 1 and bool(res.converged)
    np.testing.assert_array_equal(res.x.to_global(), b / 2)
    assert float(res.residual_norm) == 0.0


@pytest.mark.parametrize("solver", ["dist_cg", "dist_cg_ca"])
def test_dist_cg_jacobi_matches_reference(solver):
    """``precond=`` on the SPD ``laplacian_2d(12, 12) + diag(1 + u)`` (a
    Jacobi scale that varies by row) at 4 shards: equal counts, x within
    1e-10 of the reference's, and fewer iterations than without it."""
    u = np.random.default_rng(3).random(144)
    m = (utils.laplacian_2d(12, 12) + sp.diags(1.0 + 4.0 * u)).tocsr()
    b = _rhs()
    tmesh, jmesh = tdist.make_mesh(4, device="cpu"), jdist.make_mesh(4)
    A = tdist.place(tdist.NeighborCSR.build(m, 4, square=True), tmesh)
    J = jdist.NeighborCSR.build(m, 4, square=True)
    bs = tdist.place(tdist.ShardedVector.from_global(b, A.row_plan), tmesh)
    pc = sharded_jacobi(tdist.place(tdist.ShardedVector.from_global(
        1.0 / m.diagonal(), A.row_plan), tmesh))
    res = getattr(tsolvers, solver)(tmesh, A, bs, tol=TOL, maxiter=2000,
                                    precond=pc)
    plain = getattr(tsolvers, solver)(tmesh, A, bs, tol=TOL, maxiter=2000)
    ref = getattr(jsolvers, solver)(
        jmesh, J, jdist.ShardedVector.from_global(b, J.row_plan), tol=TOL,
        maxiter=2000, precond=_jax_jacobi(m, J.row_plan))
    assert bool(res.converged) and bool(ref.converged)
    assert res.iterations == int(ref.iterations) < plain.iterations
    assert _rel(res.x.to_global(), ref.x.to_global()) <= 1e-10


def test_dist_krylov_checks():
    """The shared validation; ``maxiter`` stops unconverged."""
    m = _nonsym()
    mesh = tdist.make_mesh(2, device="cpu")
    A = tdist.HaloCSR.build(m, 2, square=True)
    b = tdist.ShardedVector.from_global(_rhs(), A.row_plan)
    for solver, kw in ((tsolvers.dist_gmres, {"restart": 3}),
                       (tsolvers.dist_bicgstab, {})):
        # GMRES tests maxiter between cycles, as the reference does
        res = solver(mesh, A, b, tol=1e-12, maxiter=3, **kw)
        assert res.iterations == 3 and not bool(res.converged)
        with pytest.raises(ValueError, match="row plan"):
            solver(mesh, A, tdist.ShardedVector.from_global(
                _rhs(), tdist.RowPlan((0, 10, 144), 2, 144)))
        rect = tdist.ShardedCSR.build(
            utils.random_sparse(36, 40, 0.1).tocsr(), 2)
        with pytest.raises(ValueError, match="square"):
            solver(mesh, rect, tdist.ShardedVector.from_global(
                np.ones(36), rect.row_plan))
