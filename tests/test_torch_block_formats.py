"""The block formats ELL, BSR and BDIA against the JAX reference package:
the same seeded operands give the same fields, the same products, the
planner's and the distributed planner's BDIA arms, CG over the BDIA plan,
and ``from_reference`` of each.

Both sides are XLA-level / torch code (no Pallas), so nothing runs in
interpret mode.  Limits, rel = max|y - ref| / max|ref|: against JAX 1e-6
in float32 and 1e-13 in float64 (the same sums in another order); against
scipy float64 2e-5 and 1e-10; fields and carried-over operators bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv.bench.roofline import spmv_bytes as j_spmv_bytes
from tpu_spmv.ops import auto as jauto
from tpu_spmv.solvers import cg as jcg
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.bench.roofline import spmv_bytes
from tpu_spmv_torch.cli import main
from tpu_spmv_torch.formats import BDIA, BSR, ELL
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.ops import plan_spmv, spmm, spmv
from tpu_spmv_torch.solvers import cg, dist_cg

torch.set_num_threads(1)

JAX_TOL = {"float32": 1e-6, "float64": 1e-13}
DTYPES = {"float32": (torch.float32, jnp.float32, np.float32),
          "float64": (torch.float64, jnp.float64, np.float64)}
MATS = {
    "block_laplacian(5)": lambda: utils.block_laplacian(5, bs=8, seed=1),
    "random_sparse(90,70)": lambda: utils.random_sparse(90, 70, 0.05,
                                                        seed=1),
    "banded(100,3)": lambda: utils.banded(100, 3, seed=4),
}
FORMATS = ("ell", "bsr", "bdia")


#: the reference's products, jitted: one compile per operand and shape
#: instead of one per eager op
_JSPMV = jax.jit(ts.spmv)
_JSPMM = jax.jit(ts.spmm)


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _same_fields(ref, got):
    for f in dataclasses.fields(got):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f.name)
        else:
            assert g == r, f.name


@functools.cache
def _pair(name, fmt, dname):
    """The reference's and the port's conversion of one operand."""
    m = MATS[name]()
    tdt, jdt, _ = DTYPES[dname]
    return (ts.convert(ts.COO.from_scipy(m, dtype=jdt), fmt),
            tt.convert(tt.COO.from_scipy(m, dtype=tdt), fmt))


def _spd(B):
    """``B + B^T + diag(row sums of |B + B^T| + 1)``: SPD, the pattern of
    ``B`` made symmetric."""
    S = (B + B.T).tocsr()
    return (S + sp.diags(np.asarray(abs(S).sum(axis=1)).ravel() + 1.0)
            ).tocsr()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", MATS)
def test_fields_match_reference_and_round_trip(name, fmt):
    ref, got = _pair(name, fmt, "float64")
    _same_fields(ref, got)
    m = MATS[name]()
    assert (got.nrow, got.ncol) == m.shape
    back = tt.to_coo(got).to_scipy().tocsr()
    assert back.shape == m.shape and abs(back - m).max() == 0
    np.testing.assert_array_equal(got.todense().numpy(), m.toarray())
    low = got.astype(torch.float32)
    assert low.dtype == torch.float32 and type(low) is type(got)


def test_convert_passes_options_on():
    """``width=`` and ``block_size=`` reach ``from_coo``, as in the
    reference; duplicates are summed as ``np.add.at`` sums them."""
    m = utils.random_sparse(60, 50, 0.08, seed=7)
    for fmt, kw in (("ell", {"width": 12}), ("bsr", {"block_size": 4}),
                    ("bdia", {"block_size": 3})):
        ref = ts.convert(ts.COO.from_scipy(m, dtype=jnp.float64), fmt, **kw)
        got = tt.convert(tt.COO.from_scipy(m, dtype=torch.float64), fmt,
                         **kw)
        _same_fields(ref, got)
    with pytest.raises(ValueError, match="width"):
        tt.convert(tt.COO.from_scipy(m), "ell", width=1)
    rng = np.random.default_rng(3)
    row, col = rng.integers(0, 30, 400), rng.integers(0, 40, 400)
    val = rng.standard_normal(400)
    jcoo = ts.COO.from_arrays(row, col, val, (30, 40), sort=False)
    tcoo = tt.COO.from_arrays(row, col, val, (30, 40), dtype=torch.float64,
                              sort=False)
    for fmt in ("bsr", "bdia"):
        _same_fields(ts.convert(jcoo, fmt), tt.convert(tcoo, fmt))


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_products_match_reference(fmt, dname):
    """``spmv`` (also ``y + A x``) and ``spmm`` with 1 and 3 right-hand
    sides against the reference's on every operand."""
    tdt, jdt, ndt = DTYPES[dname]
    rng = np.random.default_rng(5)
    for name in MATS:
        ref, got = _pair(name, fmt, dname)
        ncol = got.shape[1]
        x = rng.standard_normal(ncol).astype(ndt)
        y0 = rng.standard_normal(got.shape[0]).astype(ndt)
        yt = spmv(got, torch.from_numpy(x), torch.from_numpy(y0))
        yj = _JSPMV(ref, jnp.asarray(x), jnp.asarray(y0))
        assert yt.dtype == tdt
        assert _rel(yt, yj) <= JAX_TOL[dname], (name, "spmv")
        for nrhs in (1, 3):
            X = rng.standard_normal((ncol, nrhs)).astype(ndt)
            Yt = spmm(got, torch.from_numpy(X))
            assert tuple(Yt.shape) == (got.shape[0], nrhs)
            assert _rel(Yt, _JSPMM(ref, jnp.asarray(X))) <= JAX_TOL[dname], \
                (name, nrhs)


def test_planner_picks_bdia_as_reference():
    """``tests/test_auto.py``'s block PDE: both planners pick BDIA; the
    plan's SpMV and SpMM against the reference's and scipy; no in-place
    transpose; the solver space is the identity."""
    m = utils.block_laplacian(6, bs=8, seed=2)
    plan_j = jauto.plan_spmv(m)
    plan = plan_spmv(tt.COO.from_scipy(m), device="cpu")
    assert plan.strategy == plan_j.strategy == "bdia"
    assert isinstance(plan.matrix, BDIA)
    _same_fields(plan_j.matrix, plan.matrix)
    x = np.random.default_rng(2).standard_normal(m.shape[1])
    y = plan(torch.from_numpy(x))
    assert _rel(y, plan_j(jnp.asarray(x))) <= 1e-13
    X = np.random.default_rng(3).standard_normal((m.shape[1], 4))
    assert _rel(plan.spmm(torch.from_numpy(X)), m @ X) <= 1e-13
    enc, matvec, dec = plan.solver_space()
    assert torch.equal(dec(matvec(enc(torch.from_numpy(x)))), y)
    with pytest.raises(TypeError, match="re-plan"):
        plan.transpose()
    plan32 = plan_spmv(m, dtype=torch.float32, device="cpu")
    assert plan32.strategy == "bdia" and plan32.matrix.dtype == torch.float32


def test_cg_over_the_bdia_plan_matches_reference():
    """CG on the SPD form of a block PDE through both BDIA plans: the same
    iteration count within one, the same ``converged``, the same x."""
    S = _spd(utils.block_laplacian(6, bs=8, seed=2))
    b = np.random.default_rng(4).standard_normal(S.shape[0])
    plan_j = jauto.plan_spmv(S)
    plan = plan_spmv(S, device="cpu")
    assert plan.strategy == plan_j.strategy == "bdia"
    rj = jcg(plan_j, jnp.asarray(b), tol=1e-10, maxiter=500)
    rt = cg(plan, torch.from_numpy(b), tol=1e-10, maxiter=500)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert bool(rt.converged) == bool(rj.converged) is True
    assert _rel(rt.x, rj.x) <= 1e-9
    assert np.linalg.norm(b - S @ rt.x.numpy()) <= 1e-9 * np.linalg.norm(b)


def test_from_reference_block_formats_and_plan():
    for fmt in FORMATS:
        ref, got = _pair("block_laplacian(5)", fmt, "float64")
        moved = from_reference(ref, device="cpu")
        assert type(moved) is type(got)
        _same_fields(ref, moved)
        low = from_reference(ref, device="cpu", dtype=torch.float32)
        assert low.dtype == torch.float32
    m = utils.block_laplacian(6, bs=8, seed=2)
    plan_j = jauto.plan_spmv(m)
    plan = from_reference(plan_j, device="cpu")
    assert plan.strategy == "bdia" and plan.stats == plan_spmv(
        m, device="cpu").stats
    x = np.random.default_rng(6).standard_normal(m.shape[1])
    assert _rel(plan(torch.from_numpy(x)), plan_j(jnp.asarray(x))) <= 1e-13


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_plan_dist_picks_bdia_as_reference(ndev):
    """``tests/test_dist_planned.py``'s block PDE at 1, 2 and 4 shards:
    both distributed planners pick BDIA, the shards' blocks are the
    reference's, and the products agree; ``from_reference`` of the
    reference's plan runs on the port's mesh."""
    m = utils.block_laplacian(12, bs=8, seed=2)
    mesh = tdist.make_mesh(ndev, device="cpu")
    plan = tdist.plan_dist_spmv(m, mesh, dtype=np.float32)
    plan_j = jdist.plan_dist_spmv(m, ndev, dtype=np.float32)
    assert plan.strategy == plan_j.strategy == "bdia"
    J = plan_j.matrix
    for s in range(ndev):
        np.testing.assert_array_equal(plan.matrix.data[s].numpy(),
                                      np.asarray(J.data)[s])
    assert plan.x_plan == plan.row_plan and plan.row_plan.starts == tuple(
        plan_j.row_plan.starts)
    x = np.random.default_rng(3).random(m.shape[1]).astype(np.float32)
    y = plan.y_to_global(plan.spmv(plan.shard_x(x)))
    jmesh = jdist.make_mesh(ndev)
    yj = plan_j.y_to_global(jax.jit(lambda v: plan_j.spmv(jmesh, v))(
        plan_j.shard_x(x, dtype=np.float32)))
    assert _rel(y, yj) <= 1e-6
    assert _rel(y, m @ x.astype(np.float64)) <= 2e-5
    moved = from_reference(plan_j, mesh=mesh)
    assert moved.strategy == "bdia"
    assert torch.equal(torch.from_numpy(moved.y_to_global(moved.spmv(
        moved.shard_x(x)))), torch.from_numpy(y))


def test_dist_cg_over_sharded_bdia():
    """f64 ``dist_cg`` at 4 shards over the BDIA plan of an SPD block PDE:
    converged, its true residual at most 1e-10, x as the single-chip
    plan's CG."""
    S = _spd(utils.block_laplacian(8, bs=8, seed=0))
    mesh = tdist.make_mesh(4, device="cpu")
    plan = tdist.plan_dist_spmv(S, mesh, dtype=np.float64)
    assert plan.strategy == "bdia"
    b = np.random.default_rng(3).random(S.shape[0])
    res = dist_cg(mesh, plan.matrix, plan.shard_x(b), tol=1e-12,
                  maxiter=2000)
    xs = res.x.to_global()
    assert bool(res.converged)
    assert np.linalg.norm(b - S @ xs) <= 1e-10 * np.linalg.norm(b)
    single = cg(plan_spmv(S, device="cpu"), torch.from_numpy(b), tol=1e-12,
                maxiter=2000)
    assert _rel(xs, single.x) <= 1e-9


def test_byte_model_matches_reference():
    for fmt in FORMATS:
        for dname in ("float32", "float64"):
            ref, got = _pair("block_laplacian(5)", fmt, dname)
            assert spmv_bytes(got) == j_spmv_bytes(ref), (fmt, dname)
    A = tt.convert(tt.COO.from_scipy(utils.block_laplacian(4, bs=8)), "bsr")
    assert isinstance(A, BSR) and spmv_bytes(A, torch.float32) == (
        A.data.numel() * 8 + A.nblocks * 4 + 2 * A.shape[0] * 4)
    assert isinstance(tt.convert(tt.COO.from_scipy(
        utils.banded(40, 2)), "ell"), ELL)


def test_cli_sweeps_block_formats_and_forces_bdia(capsys):
    """The default sweep is the reference's ``coo,csr,csc,ell,dia,bsr``;
    ``bdia`` is accepted; ``--dist-strategy bdia`` shards block
    diagonals."""
    assert main(["--synthetic", "laplacian:12", "--device", "cpu",
                 "--iters", "2", "--spmm", "2"]) == 0
    out = capsys.readouterr().out
    for name in ("COO", "CSR", "CSC", "ELL", "DIA", "BSR"):
        assert f"### {name} CPU GFLOPS =" in out, name
        assert f"### {name} SPMM2 GFLOPS =" in out, name
    assert main(["--synthetic", "laplacian:12", "--device", "cpu",
                 "--iters", "2", "--formats", "bdia", "--dist", "2",
                 "--dist-strategy", "bdia"]) == 0
    out = capsys.readouterr().out
    assert "### BDIA CPU GFLOPS =" in out
    assert "DIST2: strategy=bdia" in out
