"""The port's distributed SpMMs (``spmm_allgather``, ``spmm_halo``,
``spmm_neighbor``) and its distributed planner on bf16 data against the
JAX reference's.

The JAX side runs on its 8 virtual CPU devices, every call jitted; its
streaming arms run their ring kernels in interpret mode.  The port runs
``ndev`` shards on the CPU.  Limits, rel = max|y - ref| / max|ref|: the
SpMMs against JAX and scipy 1e-13 in float64; a bf16 plan (float32
vectors) within 1e-6 of the reference's bf16 plan of the same matrix
(float32 sums of the same products, in another order) and within 2e-5 of
scipy on the bf16-rounded matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv.dist import planned as jplanned
from tpu_spmv.ops import auto as jauto
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.kernels import dist_stream as tdst

from _solver_reference import rel

torch.set_num_threads(1)

#: reference container, reference SpMM, port container, port SpMM
SPMM_KINDS = {
    "allgather": (jdist.ShardedCSR, jdist.spmm_allgather, tdist.ShardedCSR,
                  tdist.spmm_allgather),
    "halo": (jdist.HaloCSR, jdist.spmm_halo, tdist.HaloCSR, tdist.spmm_halo),
    "neighbor": (jdist.NeighborCSR, jdist.spmm_neighbor, tdist.NeighborCSR,
                 tdist.spmm_neighbor),
}
RB = 256


def _mesh(ndev):
    return tdist.make_mesh(ndev, device="cpu")


@pytest.mark.parametrize("kind", SPMM_KINDS)
def test_dist_spmm_matches_reference(kind):
    """Each SpMM at 1, 2 and 4 shards on a square operand: ``[R, nrhs]``
    chunks at the row plan's starts, the product against scipy and the
    reference's, chained once (the result's chunks fed back as X), and
    each column equal to the SpMV of that column."""
    jcls, jspmm, tcls, tspmm = SPMM_KINDS[kind]
    m = utils.random_sparse(300, 300, 0.03, seed=69).tocsr()
    X = np.random.default_rng(3).standard_normal((300, 5))
    for ndev in (1, 2, 4):
        mesh = _mesh(ndev)
        A = tdist.place(tcls.build(m, ndev, square=True), mesh)
        Xs = tdist.place(tdist.ShardedVector.from_global(X, A.col_plan),
                         mesh)
        Y = tspmm(mesh, A, Xs)
        Y2 = tspmm(mesh, A, Y)
        assert Y.starts == A.row_plan.starts and Y.length == 300
        assert tuple(Y.chunks[0].shape) == (Xs.chunk_size, 5)
        assert rel(Y.to_global(), m @ X) <= 1e-13
        assert rel(Y2.to_global(), m @ (m @ X)) <= 1e-13
        spmv = {"allgather": tdist.spmv_allgather, "halo": tdist.spmv_halo,
                "neighbor": tdist.spmv_neighbor}[kind]
        for q in (0, 4):
            xq = tdist.ShardedVector.from_global(X[:, q].copy(), A.col_plan)
            assert rel(Y.to_global()[:, q],
                       spmv(mesh, A, xq).to_global()) <= 1e-13
        J = jcls.build(m, ndev, square=True)
        jmesh = jdist.make_mesh(ndev)
        step = jax.jit(lambda B, V: jspmm(jmesh, B, V))
        Yj = step(J, jdist.ShardedVector.from_global(X, J.col_plan))
        assert rel(Y.to_global(), Yj.to_global()) <= 1e-13
    with pytest.raises(ValueError, match="nrhs"):
        tspmm(mesh, A, tdist.place(tdist.ShardedVector.from_global(
            X[:, 0].copy(), A.col_plan), mesh))


def _rounded(m):
    r = m.astype(np.float64)
    r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
    return r


#: arm -> (operand, shards, the reference's SpMV of its container; None:
#: the reference's single-chip bf16 plan instead, for GPR (its sharded
#: pack runs the GPR pipeline in interpret mode), BDIA (its sharded einsum
#: sums and returns bf16) and CSR)
BF16_ARMS = {
    "pdia_stream": (lambda: utils.laplacian_2d(16), 2,
                    lambda mesh, A, v: jplanned.spmv_psdia_sharded(
                        mesh, A, v, interpret=True)),
    "dia_stream": (lambda: utils.banded(777, 5, seed=2), 2,
                   lambda mesh, A, v: jplanned.spmv_sdia_sharded(
                       mesh, A, v, interpret=True)),
    "dia": (lambda: utils.banded(203, 3, seed=6), 4,
            jplanned.spmv_dia_sharded),
    "bdia": (lambda: utils.block_laplacian(4, bs=8, seed=1), 4, None),
    "gpr": (lambda: utils.power_law(650, 650, 7, seed=6), 4, None),
    "csr": (lambda: utils.random_sparse(300, 300, 0.03, seed=3), 4, None),
}


@pytest.mark.parametrize("arm", BF16_ARMS)
def test_bf16_dist_plans_match_reference(arm):
    """``plan_dist_spmv(dtype=bfloat16)`` forced to each arm (``csr``: the
    three CSR strategies): bf16 values in the shards, float32 x and y, no
    launch on the CPU, the product within 1e-6 of the reference's bf16
    plan (its sharded container on the streaming and DIA arms, its
    single-chip bf16 plan on the others) and within 2e-5 of scipy on the
    rounded matrix; the sharded coefficients equal the reference's."""
    make, ndev, jspmv = BF16_ARMS[arm]
    m = make().astype(np.float32).tocsr()
    m.data = np.random.default_rng(1).standard_normal(m.nnz).astype(
        np.float32)
    if arm == "pdia_stream":            # a periodic pattern of values
        m = utils.laplacian_2d(16).astype(np.float32).tocsr()
        m.data = m.data * np.float32(1.3)
    x = np.random.default_rng(2).random(m.shape[1]).astype(np.float32)
    mesh = _mesh(ndev)
    strategies = (("csr_neighbor", "csr_allgather", "csr_halo")
                  if arm == "csr" else (arm,))
    before = dict(tdst.LAUNCHES)
    for strategy in strategies:
        plan = tdist.plan_dist_spmv(m, mesh, dtype=torch.bfloat16,
                                    strategy=strategy, sdia_rb=RB)
        A = plan.matrix
        values = [t for f in ("data", "pattern", "data_int", "data_bnd")
                  for t in getattr(A, f, ())]
        if arm == "gpr":
            values = [p.data for p in A.gpcsr]
        assert values and all(t.dtype == torch.bfloat16 for t in values)
        xs = plan.shard_x(x)
        assert xs.dtype == torch.float32
        ys = plan.spmv(xs)
        assert ys.dtype == torch.float32
        y = plan.y_to_global(ys)
        assert rel(y, _rounded(m) @ x.astype(np.float64)) <= 2e-5
        if jspmv is None:
            pj = jauto.plan_spmv(m, dtype=jnp.bfloat16)
            yj = jax.jit(lambda v: pj(v))(jnp.asarray(x))
        else:
            jplan = jdist.plan_dist_spmv(m, ndev, dtype=jnp.bfloat16,
                                         strategy=strategy, sdia_rb=RB)
            J = jplan.matrix
            jcoef = np.asarray(getattr(J, "data", getattr(J, "pattern", 0)),
                               np.float32)
            tcoef = (A.data if hasattr(A, "data") else A.pattern)
            for s in range(ndev):
                np.testing.assert_array_equal(tcoef[s].float().numpy(),
                                              jcoef[s])
            jmesh = jdist.make_mesh(ndev)
            yj = jplan.y_to_global(jax.jit(lambda B, v: jspmv(jmesh, B, v))(
                J, jplan.shard_x(x)))
        assert rel(y, np.asarray(yj, np.float64)) <= 1e-6
    assert tdst.LAUNCHES == before


def test_bench_dist_spmv_bf16_gate(capsys):
    """``bench_dist_spmv`` at bf16 plans bf16 coefficients for float32
    vectors and holds the product to the oracle's bf16 gate: within 2e-2
    of the unrounded matrix (above the float32 gate there), within 2e-5 of
    the rounded one."""
    m = utils.random_sparse(400, 400, 0.02, seed=5).tocsr()
    mesh = _mesh(2)
    r = tdist.bench_dist_spmv(m, mesh, dtype=torch.bfloat16, iters=2)
    assert r["strategy"] == "gpr" and 2e-5 < r["rel_err"] <= 2e-2
    assert "DIST2: strategy=gpr |" in capsys.readouterr().out
    plan = tdist.plan_dist_spmv(m, mesh, dtype=torch.bfloat16)
    r = tdist.bench_dist_spmv(_rounded(m), mesh, dtype=torch.bfloat16,
                              iters=2, plan=plan, quiet=True)
    assert r["rel_err"] <= 2e-5
