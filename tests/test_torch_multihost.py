"""The port's distribution layer across processes: four Gloo ranks on the
CPU against the single controller and the JAX reference.

One module fixture spawns four ranks on ``127.0.0.1`` once
(:func:`tpu_spmv_torch.dist.dryrun.spawn`, a free port, a 60 s deadline
and process-group timeout, so a hang fails fast).  Each rank runs
:func:`~tpu_spmv_torch.dist.dryrun.parity_cases` on process meshes of 1, 2
and 4 ranks (subgroups of the one group) and the reference's dry run over
all four; meanwhile this process runs the same cases on the single
controller's meshes of 1, 2 and 4 shards and the JAX ``dist_cg`` on a
4-device virtual mesh inside one ``jax.jit``.  Limits: every product, dot,
solver iterate and V-cycle bitwise the single controller's (the process
mesh sums in shard order); the V-cycle bitwise the serial one; ``dist_cg``
against JAX's: the same iterations, x within 1e-10 relative.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_spmv.solvers as jsolvers
from tpu_spmv import dist as jdist
from tpu_spmv import utils as jutils
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.dist import dryrun
from tpu_spmv_torch.dist import mesh as tmesh
from tpu_spmv_torch.solvers import mg_preconditioner

torch.set_num_threads(1)

SIZES = (1, 2, 4)
PRODUCTS = ("exchanges", "halo", "allgather", "neighbor", "colsplit",
            "spmm_neighbor", "dia", "dia_stream", "pdia_stream", "gpr",
            "bdia")
SOLVERS = ("dist_cg", "dist_cg_ca", "dist_gmres", "dist_bicgstab")


def _jax_dist_cg():
    """JAX's ``dist_cg`` on parity_cases' SPD operand at 4 shards, in one
    ``jax.jit``: (iterations, x)."""
    spd = jutils.laplacian_2d(12, 12).tocsr()
    b = np.random.default_rng(5).standard_normal(144)
    mesh = jdist.make_mesh(4)
    A = jdist.NeighborCSR.build(spd, 4, square=True)
    bj = jdist.ShardedVector.from_global(b, A.row_plan)
    run = jax.jit(lambda c: (lambda r: (r.iterations, r.x.chunks))(
        jsolvers.dist_cg(mesh, A, jdist.ShardedVector(
            chunks=c, starts=bj.starts, length=bj.length), tol=1e-10,
            maxiter=2000)))
    it, chunks = run(bj.chunks)
    x = jdist.ShardedVector(chunks=chunks, starts=bj.starts,
                            length=bj.length).to_global()
    return int(it), np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the single controller's cases by size, its dry
    run at 4 shards, JAX's dist_cg)."""
    ranks = dryrun.spawn(dryrun.parity_rank, 4, args=(SIZES,), timeout=60)
    single = {k: dryrun.parity_cases(tdist.make_mesh(k, device="cpu"))
              for k in SIZES}
    dry = dryrun.dryrun_multichip(4, mesh=tdist.make_mesh(4, device="cpu"))
    ref = _jax_dist_cg()
    return ranks.join(), single, dry, ref


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k", SIZES)
def test_products_bitwise(runs, k):
    """Every exchange and every distributed product (the CSR strategies,
    the sharded DIA, K8a, K8b, GPR and BDIA plans, one SpMM) on k ranks:
    each rank's chunk bitwise the single controller's shard."""
    procs, single, _, _ = runs
    for rank in range(k):
        for case in PRODUCTS:
            assert _same(procs[rank][k][case][0], single[k][case][rank]), \
                (k, rank, case)
    for rank in range(k, 4):
        assert k not in procs[rank]


def test_reductions_replicated(runs):
    """dot, dot_stack and norm2: the same bits on every rank, the single
    controller's."""
    procs, single, _, _ = runs
    for k in SIZES:
        for rank in range(k):
            for got, want in zip(procs[rank][k]["dots"], single[k]["dots"]):
                assert _same(got, want), (k, rank)
    for rank in range(4):
        assert _same(procs[rank]["dryrun"]["dot"], procs[0]["dryrun"]["dot"])


def test_solvers_bitwise(runs):
    """f64 dist_cg, dist_cg_ca (Jacobi), dist_gmres (Jacobi) and
    dist_bicgstab on 1, 2 and 4 ranks: the single controller's
    iterations, flag, residual norm and iterates, bit for bit."""
    procs, single, _, _ = runs
    for k in SIZES:
        for name in SOLVERS:
            want = single[k][name]
            assert want["converged"], (k, name)
            for rank in range(k):
                got = procs[rank][k][name]
                assert got["iterations"] == want["iterations"], (k, name)
                assert got["converged"] == want["converged"]
                assert _same(got["residual_norm"], want["residual_norm"])
                assert _same(got["x"][0], want["x"][rank]), (k, name, rank)


def test_vcycle_bitwise_serial(runs):
    """dist_mg_preconditioner on 1, 2 and 4 ranks (sharded down to 2-row
    slabs): the ranks' slabs concatenated are the serial V-cycle's bits."""
    procs, _, _, _ = runs
    g = 32
    r = np.random.default_rng(9).standard_normal(g * g)
    z = mg_preconditioner((g, g))(torch.from_numpy(r)).numpy()
    for k in SIZES:
        got = np.concatenate([procs[rank][k]["vcycle"][0]
                              for rank in range(k)])
        assert _same(got, z), k


def test_dist_cg_matches_jax(runs):
    """f64 dist_cg on the 4-rank mesh against the JAX reference's on a
    4-device virtual mesh: the same iterations, x within 1e-10."""
    procs, _, _, (it, x_ref) = runs
    assert all(procs[r][4]["dist_cg"]["iterations"] == it for r in range(4))
    plan = tdist.NeighborCSR.build(jutils.laplacian_2d(12, 12).tocsr(), 4,
                                   square=True).row_plan
    x = tdist.ShardedVector(chunks=tuple(
        torch.from_numpy(procs[r][4]["dist_cg"]["x"][0]) for r in range(4)),
        starts=plan.starts, length=plan.length).to_global()
    assert np.max(np.abs(x - x_ref)) <= 1e-10 * np.max(np.abs(x_ref))


def test_dryrun_multichip(runs):
    """The reference's dry run on four ranks passed its scipy checks on
    every rank, each product bitwise the single controller's at 4 shards,
    and nothing was staged through the host (the CPU needs no staging)."""
    procs, _, dry, _ = runs
    for rank in range(4):
        got = procs[rank]["dryrun"]
        assert "on 4 processes" in got["line"] and "OK" in got["line"]
        for case in ("halo", "allgather", "colsplit", "dia", "gpr",
                     "pdia_stream", "axpy", "vcycle"):
            assert _same(got[case][0], dry[case][rank]), (rank, case)
        assert procs[rank]["staged"] == {}


def test_init_multihost_forwards_and_survives(monkeypatch):
    """As the reference's test (``tests/test_dist.py:175``): the arguments
    reach ``init_process_group``; an existing group or an empty
    environment makes the call a no-op."""
    import torch.distributed as tdistributed

    calls = []

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1,
                  **kw):
        calls.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(tdistributed, "init_process_group", fake_init)
    monkeypatch.setattr(tdistributed, "is_initialized", lambda: False)
    tdist.init_multihost("10.0.0.1:8476", 4, 2, backend="gloo")
    assert calls == [("gloo", "tcp://10.0.0.1:8476", 4, 2)]
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tdist.init_multihost()                    # nothing to read: no call
    for var, value in (("MASTER_ADDR", "h"), ("MASTER_PORT", "1"),
                       ("WORLD_SIZE", "3"), ("RANK", "1")):
        monkeypatch.setenv(var, value)
    tdist.init_multihost(backend="gloo")
    assert calls[-1] == ("gloo", "env://", 3, 1)
    monkeypatch.setattr(tdistributed, "is_initialized", lambda: True)
    tdist.init_multihost("10.0.0.1:8476", 4, 2)   # a group exists: no call
    assert len(calls) == 2
    # without a group, a group= mesh is refused and the mesh is the single
    # controller's
    monkeypatch.setattr(tdistributed, "is_initialized", lambda: False)
    assert not tdist.make_mesh(device="cpu").is_process
    with pytest.raises(ValueError, match="init_multihost"):
        tdist.make_mesh(device="cpu", group=object())
    assert set(tmesh.STAGED) == {"ring", "shift", "neighbors", "all_gather",
                                 "psum", "reduce_scatter"}
