"""Port distribution layer against the JAX reference's: partition plans,
sharded vectors, the general-CSR strategies and their containers, sharded
BLAS-1 and distributed CG.

The JAX side runs on its 8 virtual CPU devices (``tpu_spmv.dist.make_mesh``,
XLA, no Pallas), jitted (an eager ``shard_map`` traces anew on every call
and takes seconds); the port runs ``ndev`` shards on the CPU (``make_mesh(ndev,
device="cpu")``).  Limits, rel = max|y - ref| / max|ref|: against JAX and
scipy 1e-13 in float64 (the same products, summed in another order); the
container layouts are equal exactly.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as jsolvers
import tpu_spmv_torch.solvers as tsolvers
from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.interop import from_reference

torch.set_num_threads(1)

NDEV = (1, 2, 4)
TOL = 1e-13
#: reference container -> (port container, reference SpMV, port SpMV)
CSR_KINDS = {
    "csr_allgather": (tdist.ShardedCSR, jdist.spmv_allgather,
                      tdist.spmv_allgather),
    "csr_halo": (tdist.HaloCSR, jdist.spmv_halo, tdist.spmv_halo),
    "csr_neighbor": (tdist.NeighborCSR, jdist.spmv_neighbor,
                     tdist.spmv_neighbor),
    "colsplit": (tdist.ColShardedCSR, jdist.spmv_colsplit,
                 tdist.spmv_colsplit),
}
_JCLS = {"csr_allgather": jdist.ShardedCSR, "csr_halo": jdist.HaloCSR,
         "csr_neighbor": jdist.NeighborCSR, "colsplit": jdist.ColShardedCSR}


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _mesh(ndev):
    return tdist.make_mesh(ndev, device="cpu")


def _fields(plan):
    return plan.starts, plan.ndev, plan.length


def test_make_mesh():
    m = tdist.make_mesh(4, device="cpu")
    assert m.ndev == 4 and m.devices == (torch.device("cpu"),) * 4
    assert tdist.make_mesh(device="cpu").ndev == 1
    if torch.cuda.device_count() == 0:
        assert tdist.device_count() == 0
        with pytest.raises(ValueError, match="only 0 available"):
            tdist.make_mesh(1)
        with pytest.raises(ValueError, match="only 0 available"):
            tdist.make_mesh(1, device="cuda")


@pytest.mark.parametrize("ndev", NDEV)
def test_partition_plans_match_reference(ndev):
    indptr = utils.power_law(300, 300, 7, seed=8).tocsr().indptr
    for length in (0, 1, 5, 97, 1000):
        for plan in ("plan_even", "plan_uniform"):
            assert _fields(getattr(tdist, plan)(length, ndev)) == \
                _fields(getattr(jdist, plan)(length, ndev))
    for balance in ("nnz", "rows"):
        t = tdist.plan_rows(indptr, ndev, balance=balance)
        j = jdist.plan_rows(indptr, ndev, balance=balance)
        assert _fields(t) == _fields(j) and t.max_count == j.max_count
        idx = np.arange(300)
        np.testing.assert_array_equal(t.owner_of(idx), j.owner_of(idx))
    with pytest.raises(ValueError, match="balance"):
        tdist.plan_rows(indptr, ndev, balance="bogus")


@pytest.mark.parametrize("ndev", NDEV)
def test_sharded_vector_roundtrip(ndev):
    x = np.random.default_rng(1).standard_normal(203)
    plan = tdist.plan_even(203, ndev)
    xs = tdist.ShardedVector.from_global(x, plan)
    js = jdist.ShardedVector.from_global(x, jdist.plan_even(203, ndev))
    assert xs.ndev == ndev and xs.chunk_size == js.chunk_size
    for s in range(ndev):
        np.testing.assert_array_equal(xs.chunks[s].numpy(),
                                      np.asarray(js.chunks[s]))
    np.testing.assert_array_equal(xs.to_global(), x)
    placed = tdist.place(xs, _mesh(ndev))
    np.testing.assert_array_equal(placed.to_global(), x)
    f32 = tdist.ShardedVector.from_global(x, plan, dtype=np.float32)
    assert f32.dtype == torch.float32
    with pytest.raises(ValueError, match="plan expects"):
        tdist.ShardedVector.from_global(x[:-1], plan)
    with pytest.raises(ValueError, match="shards"):
        tdist.place(xs, _mesh(ndev + 1))


#: the row strategies' square operand (chained) and colsplit's rectangular
#: one
CSR_OPERANDS = {"random_sparse(300,300)":
                lambda: utils.random_sparse(300, 300, 0.03, seed=69).tocsr(),
                "power_law(257,300)":
                lambda: utils.power_law(257, 300, 7, seed=8).tocsr()}


def _operand(kind):
    name = "power_law(257,300)" if kind == "colsplit" else \
        "random_sparse(300,300)"
    return CSR_OPERANDS[name]()


def _kw(kind, m):
    return {} if kind == "colsplit" else {"square": m.shape[0] == m.shape[1]}


def _jax_csr(ndev, kind):
    """One CSR kind's x and reference products ``A x`` and, for the row
    strategies, ``A (A x)`` (one jitted step, compiled once)."""
    m = _operand(kind)
    J = _JCLS[kind].build(m, ndev, **_kw(kind, m))
    x = np.random.default_rng(3).standard_normal(m.shape[1])
    mesh, jspmv = jdist.make_mesh(ndev), CSR_KINDS[kind][1]
    step = jax.jit(lambda A, v: jspmv(mesh, A, v))
    y = step(J, jdist.ShardedVector.from_global(x, J.col_plan))
    y2 = step(J, y) if kind != "colsplit" else y
    return x, y.to_global(), y2.to_global()


@pytest.mark.parametrize("kind", CSR_KINDS)
@pytest.mark.parametrize("ndev", NDEV)
def test_csr_strategies_match_reference(ndev, kind):
    """Each CSR container laid out bucket for bucket as the reference's
    (on a square and a rectangular operand), its products equal to scipy's
    and, past one shard, to the reference's; the row strategies chain on a
    square plan."""
    tcls, _, tspmv = CSR_KINDS[kind]
    for m in (f() for f in CSR_OPERANDS.values()):
        A = tcls.build(m, ndev, **_kw(kind, m))
        J = _JCLS[kind].build(m, ndev, **_kw(kind, m))
        assert (A.shape, A.row_starts, A.col_starts, A.nnz) == \
            (tuple(J.shape), J.row_starts, J.col_starts, J.nnz)
        for f in ("data", "cols", "rows", "data_int", "cols_int",
                  "rows_int", "data_bnd", "cols_bnd", "rows_bnd"):
            if hasattr(J, f):
                for s in range(ndev):
                    np.testing.assert_array_equal(
                        getattr(A, f)[s].numpy(), np.asarray(getattr(J, f))[s])
        if kind == "csr_neighbor":
            assert A.offsets == J.offsets
    m = _operand(kind)
    x = np.random.default_rng(3).standard_normal(m.shape[1])
    mesh = _mesh(ndev)
    A = tdist.place(tcls.build(m, ndev, **_kw(kind, m)), mesh)
    xs = tdist.place(tdist.ShardedVector.from_global(x, A.col_plan), mesh)
    y = tspmv(mesh, A, xs).to_global()
    y2 = (tspmv(mesh, A, tspmv(mesh, A, xs)).to_global()
          if kind != "colsplit" else y)
    assert _rel(y, m @ x) <= TOL
    assert _rel(y2, m @ (m @ x) if kind != "colsplit" else m @ x) <= TOL
    if ndev > 1:        # at one shard every strategy is the plain product
        _, yj, yj2 = _jax_csr(ndev, kind)
        assert _rel(y, yj) <= TOL and _rel(y2, yj2) <= TOL


def test_blas_matches_reference():
    """Sharded BLAS-1 at 1, 2 and 4 shards against numpy, and against the
    reference's at 4 shards."""
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal(500), rng.standard_normal(500)
    b, jb = tdist.blas, jdist.blas
    for ndev in NDEV:
        tp = tdist.plan_even(500, ndev)
        xs, ys = (tdist.ShardedVector.from_global(v, tp) for v in (x, y))
        assert abs(float(b.dot(xs, ys)) - x @ y) <= TOL * abs(x @ y)
        np.testing.assert_allclose(b.dot_stack((xs, ys), (xs, xs)).numpy(),
                                   [x @ y, x @ x], rtol=TOL)
        np.testing.assert_allclose(float(b.norm2(xs)), np.linalg.norm(x),
                                   rtol=TOL)
        three = torch.tensor(3.0, dtype=torch.float64)
        vecs = (b.axpby(2.0, xs, -0.5, ys), b.axpy(three, xs, ys),
                b.scale(xs, 0.25))
        for v, ref in zip(vecs, (2.0 * x - 0.5 * y, y + 3.0 * x, 0.25 * x)):
            np.testing.assert_array_equal(v.to_global(), ref)
    jp = jdist.plan_even(500, ndev)
    xj, yj = (jdist.ShardedVector.from_global(v, jp) for v in (x, y))
    assert abs(float(b.dot(xs, ys)) - float(jb.dot(xj, yj))) <= \
        TOL * abs(x @ y)
    np.testing.assert_allclose(b.dot_stack((xs, ys), (xs, xs)).numpy(),
                               np.asarray(jb.dot_stack((xj, yj), (xj, xj))),
                               rtol=TOL)
    np.testing.assert_array_equal(vecs[0].to_global(),
                                  jb.axpby(2.0, xj, -0.5, yj).to_global())
    other = tdist.ShardedVector.from_global(np.zeros(499),
                                            tdist.plan_even(499, ndev))
    with pytest.raises(ValueError, match="mismatched partitions"):
        b.dot(xs, other)


@pytest.mark.parametrize("ndev,kind,solver", [
    (1, "csr_allgather", "dist_cg"), (2, "csr_halo", "dist_cg_ca"),
    (4, "csr_neighbor", "dist_cg"), (4, "csr_neighbor", "dist_cg_ca")])
def test_dist_cg_matches_reference(ndev, kind, solver):
    """Iteration counts within 1 of the reference's, the same convergence
    flag, and the solution against scipy."""
    spd = utils.laplacian_2d(12, 12)
    tcls = CSR_KINDS[kind][0]
    A = tcls.build(spd.tocsr(), ndev, square=True)
    J = _JCLS[kind].build(spd.tocsr(), ndev, square=True)
    b = np.random.default_rng(5).standard_normal(144)
    tmesh, jmesh = _mesh(ndev), jdist.make_mesh(ndev)
    bs = tdist.place(tdist.ShardedVector.from_global(b, A.row_plan), tmesh)
    res = getattr(tsolvers, solver)(tmesh, tdist.place(A, tmesh), bs,
                                    tol=1e-10, maxiter=2000)
    ref = getattr(jsolvers, solver)(
        jmesh, J, jdist.ShardedVector.from_global(b, J.row_plan),
        tol=1e-10, maxiter=2000)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert bool(res.converged) == bool(ref.converged) is True
    x = res.x.to_global()
    assert _rel(spd @ x, b) <= 1e-9
    assert _rel(x, ref.x.to_global()) <= 1e-8


def test_dist_cg_checks():
    mesh = _mesh(2)
    A = tdist.NeighborCSR.build(utils.laplacian_2d(6).tocsr(), 2,
                                square=True)
    b = tdist.ShardedVector.from_global(np.ones(36), A.row_plan)
    res = tsolvers.dist_cg(mesh, A, b, tol=1e-10, maxiter=3)
    assert res.iterations == 3 and not bool(res.converged)
    with pytest.raises(ValueError, match="row plan"):
        tsolvers.dist_cg(mesh, A, tdist.ShardedVector.from_global(
            np.ones(36), tdist.RowPlan((0, 10, 36), 2, 36)))
    rect = tdist.ShardedCSR.build(utils.random_sparse(36, 40, 0.1).tocsr(), 2)
    with pytest.raises(ValueError, match="square"):
        tsolvers.dist_cg_ca(mesh, rect, b)
    skew = tdist.HaloCSR.build(utils.power_law(36, 36, 5, seed=1).tocsr(), 2)
    assert skew.col_starts != skew.row_starts
    with pytest.raises(ValueError, match="column partition"):
        tsolvers.dist_cg(mesh, skew, tdist.ShardedVector.from_global(
            np.ones(36), skew.row_plan))


@pytest.mark.parametrize("ndev", NDEV)
def test_from_reference_csr_containers(ndev):
    """Reference CSR containers and vectors carry over onto a port mesh,
    field for field, with the port's row pointers; products equal."""
    m = utils.power_law(257, 257, 7, seed=8).tocsr()
    mesh = _mesh(ndev)
    x = np.random.default_rng(6).standard_normal(257)
    for kind, (tcls, _, tspmv) in CSR_KINDS.items():
        kw = {} if kind == "colsplit" else {"square": True}
        J = _JCLS[kind].build(m, ndev, **kw)
        A = from_reference(J, mesh=mesh)
        built = tcls.build(m, ndev, **kw)
        assert type(A) is tcls
        for f in ("rowptr", "rowptr_int", "rowptr_bnd", "data", "cols"):
            if hasattr(built, f):
                for a, c in zip(getattr(A, f), getattr(built, f)):
                    assert torch.equal(a, c)
        xs = from_reference(jdist.ShardedVector.from_global(x, J.col_plan),
                            mesh=mesh)
        assert _rel(tspmv(mesh, A, xs).to_global(), m @ x) <= TOL
    with pytest.raises(ValueError, match="mesh="):
        from_reference(jdist.ShardedCSR.build(m, ndev))
    with pytest.raises(ValueError, match="does not fit"):
        from_reference(jdist.ShardedCSR.build(m, ndev), mesh=_mesh(ndev + 1))


def test_rowptr_leaves_padding_out():
    """A bucket's row pointer ends at its last live entry; an empty shard
    sums to zeros."""
    m = sp.csr_matrix((np.ones(3), ([0, 0, 2], [1, 2, 0])), shape=(3, 3))
    A = tdist.ShardedCSR.build(m, 2)            # nnz split: rows 0 | 1, 2
    assert A.rowptr[0].tolist() == [0, 2, 2]
    assert A.rowptr[1].tolist() == [0, 0, 1]
    mesh = _mesh(2)
    x = np.array([1.0, 2.0, 4.0])
    y = tdist.spmv_allgather(mesh, A, tdist.ShardedVector.from_global(
        x, A.col_plan))
    np.testing.assert_array_equal(y.to_global(), m @ x)
