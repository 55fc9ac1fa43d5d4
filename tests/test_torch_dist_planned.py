"""Port planned distributed SpMV against the JAX reference's: the sharded
streaming DIA (K8a, K8b), the sharded DIA and GPR, the distributed planner,
``from_reference`` of the planned containers, ``bench_dist_spmv`` and the
CLI's ``--dist``.

The JAX side runs its ring kernels in interpret mode on its 8 virtual CPU
devices, jitted, so a chain reuses one compiled step (interpret mode costs
about half a second per distinct call); the port runs the
plain versions that its wrappers take for CPU tensors, ``ndev`` shards on
the CPU.  Every streaming case runs against scipy and the port's
single-chip plain version on the same pack, four of them against JAX.
Limits,
rel = max|y - ref| / max|ref|: against JAX 1e-6 in float32 and 1e-13 in
float64 (the same sums; FMA rounding may differ); against scipy float64
2e-5 and 1e-10; against the single-chip version bitwise (a wrapped sliver
read times zero data adds exactly zero).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv.dist import planned as jplanned
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import COO as TCOO
from tpu_spmv_torch import convert as t_convert
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.bench.roofline import spmv_bytes
from tpu_spmv_torch.cli import main
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import dist_stream as tdst
from tpu_spmv_torch.kernels import gpr as tgpr

torch.set_num_threads(1)

JAX_TOL = {"float32": 1e-6, "float64": 1e-13}
ORACLE_TOL = {"float32": 2e-5, "float64": 1e-10}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
MATS = {"laplacian_2d(32)": lambda: utils.laplacian_2d(32),
        "banded(777,5)": lambda: utils.banded(777, 5)}
KINDS = {"sdia": "banded(777,5)", "psdia": "laplacian_2d(32)"}
#: (kind, ndev, dtype) held against JAX: each kernel in both dtypes, each
#: ndev; every (kind, ndev, dtype) runs on the port side
#: (test_streaming_shards_match_single_chip).  At ndev 4 the last shard is
#: all pad tiles (6 row tiles of 256 over 4 shards of 2)
STREAM_CASES = [("sdia", 1, "float32"), ("sdia", 4, "float64"),
                ("psdia", 2, "float64"), ("psdia", 4, "float32")]
RB = 256


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _mesh(ndev):
    return tdist.make_mesh(ndev, device="cpu")


@functools.cache
def _jpack(kind, name, dname):
    """The JAX pack of one operand (row tile RB)."""
    m = MATS[name]()
    jdia = ts.convert(ts.COO.from_scipy(m, dtype=DTYPES[dname][1]), "dia")
    return (jds.pack_sdia(jdia, rb=RB) if kind == "sdia"
            else jds.pack_psdia(jdia, rb=RB))


@functools.cache
def _packs(kind, name, dname):
    """(matrix, port pack) with the JAX pack's row tile."""
    m = MATS[name]()
    tdia = t_convert(TCOO.from_scipy(m, dtype=DTYPES[dname][0]), "dia")
    return m, (tds.pack_sdia(tdia, rb=RB) if kind == "sdia"
               else tds.pack_psdia(tdia, rb=RB, device="cpu"))


def _sharded(kind):
    return ((jplanned.ShardedSDIA, tdist.ShardedSDIA,
             jplanned.spmv_sdia_sharded, tdist.spmv_sdia_sharded)
            if kind == "sdia" else
            (jplanned.ShardedPSDIA, tdist.ShardedPSDIA,
             jplanned.spmv_psdia_sharded, tdist.spmv_psdia_sharded))


def _x(m, dname):
    return np.random.default_rng(0).random(m.shape[1]).astype(dname)


def _port_products(kind, ndev, dname):
    """The port's sharded container on ``ndev`` CPU shards, x, and its
    chained products ``A x`` and ``A (A x)``; each checked against scipy
    and (concatenated) bitwise against the single-chip plain version on
    the same pack."""
    name = KINDS[kind]
    m, pack = _packs(kind, name, dname)
    mesh = _mesh(ndev)
    A = tdist.place(_sharded(kind)[1].build(pack, ndev), mesh)
    x = _x(m, dname)
    xpad = tds.pad_x(pack, torch.from_numpy(x))
    spmv = _sharded(kind)[3]
    y1 = spmv(mesh, A, tdist.place(A.shard_xpad(xpad), mesh))
    y2 = spmv(mesh, A, y1)
    assert y1.dtype == DTYPES[dname][0]
    ref = m @ x.astype(np.float64)
    assert _rel(A.unshard_y(y1), ref) <= ORACLE_TOL[dname]
    assert _rel(A.unshard_y(y2), m @ ref) <= ORACLE_TOL[dname]
    single = (tds.spmv_sdia_padded_ref if kind == "sdia"
              else tds.spmv_psdia_padded_ref)
    s1 = single(pack, xpad)
    for y, ys in ((y1, s1), (y2, single(pack, s1))):
        flat = torch.cat(y.chunks)
        assert torch.equal(flat[:pack.npad], ys)
        assert not flat[pack.npad:].any()
    return A, x, y1, y2


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_streaming_shards_match_single_chip(kind, dname):
    """K8a / K8b's plain versions at 1, 2 and 4 shards, chained twice:
    scipy, and the single-chip product bitwise (a wrapped sliver read
    times zero data adds exactly zero)."""
    for ndev in (1, 2, 4):
        _port_products(kind, ndev, dname)
    assert tdst.LAUNCHES == {"sdia_ring": 0, "sdia_ring_bf16": 0,
                            "psdia_ring": 0}


@pytest.mark.parametrize("kind,ndev,dname", STREAM_CASES)
def test_streaming_shards_match_reference(kind, ndev, dname):
    """The sharded container equals the reference's field for field; the
    chained products equal the reference's interpret-mode ring kernels."""
    jcls, _, jspmv, _ = _sharded(kind)
    m = MATS[KINDS[kind]]()
    J = jcls.build(_jpack(kind, KINDS[kind], dname), ndev)
    jmesh = jdist.make_mesh(ndev)
    xpad = np.zeros(J.npad, dname)
    xpad[J.L:J.L + m.shape[1]] = _x(m, dname)
    step = jax.jit(lambda A, v: jspmv(jmesh, A, v, interpret=True))
    y1j = step(J, J.shard_xpad(jnp.asarray(xpad)))
    y2j = step(J, y1j)                   # the compiled step again
    A, _, y1, y2 = _port_products(kind, ndev, dname)
    assert (A.L, A.rb, A.rows_per_shard, A.npad, A.halo) == (
        J.L, J.rb, J.rows_per_shard, J.npad, jds._halo_size(J.offsets, J.rb))
    coef = (A.data, J.data) if kind == "sdia" else (A.pattern, J.pattern)
    for s in range(ndev):
        np.testing.assert_array_equal(coef[0][s].numpy(),
                                      np.asarray(coef[1])[s])
    for y, yj in ((y1, y1j), (y2, y2j)):
        assert _rel(torch.cat(y.chunks),
                    np.asarray(yj.chunks).reshape(-1)) <= JAX_TOL[dname]


def test_ring_kernels_plain_versions():
    """The window semantics with nonzero data everywhere (so the wrapped
    reads count): ``xw(j)`` is ``left[h + j]``, ``x[j]`` or ``right[j -
    cp]``; PSDIA's pattern phase is the local row's, its mask the global
    row's; the wrappers check their operands."""
    rng = np.random.default_rng(1)
    cp, h, rb = 16, 4, 8
    offsets = (-4, -1, 0, 3, 4)
    data = rng.standard_normal((5, cp))
    pattern = rng.standard_normal((5, rb))
    x, left, right = (rng.standard_normal(n) for n in (cp, h, h))
    xw = np.concatenate([left, x, right])
    ref = np.array([sum(data[d, k] * xw[h + k + o]
                        for d, o in enumerate(offsets)) for k in range(cp)])
    T = torch.from_numpy
    y = tdst.spmv_sdia_ring(T(data), offsets, T(x), T(left), T(right))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-13, atol=1e-13)
    base, L, nrow = 24, 30, 6            # global rows 24..39, valid 30..35
    refp = np.array([sum(pattern[d, k % rb] * xw[h + k + o]
                         for d, o in enumerate(offsets))
                     if L <= base + k < L + nrow else 0.0
                     for k in range(cp)])
    yp = tdst.spmv_psdia_ring(T(pattern), offsets, T(x), T(left), T(right),
                              base=base, L=L, nrow=nrow)
    np.testing.assert_allclose(yp.numpy(), refp, rtol=1e-13, atol=1e-13)
    with pytest.raises(TypeError, match="left is torch.float32"):
        tdst.spmv_sdia_ring(T(data), offsets, T(x), T(left).float(),
                            T(right))
    with pytest.raises(ValueError, match="cover the band"):
        tdst.spmv_sdia_ring(T(data), (-5, 0), T(x), T(left), T(right))
    with pytest.raises(ValueError, match="multiple of the row tile"):
        tdst.spmv_psdia_ring(T(pattern[:, :5].copy()), offsets, T(x), T(left),
                             T(right), base=0, L=0, nrow=1)
    assert tdst.LAUNCHES == {"sdia_ring": 0, "sdia_ring_bf16": 0,
                            "psdia_ring": 0}
    assert tdst.halo_size((-32, 0, 32), 256) == 256
    assert tdst.halo_size((-3, 3), 4096) == 1024
    assert tdst.halo_size((-1500, 0), 4096) == 2048


def _interior_case(case, rng):
    """A shard of ``cp`` rows and an offset set for ``case``."""
    cp = int(rng.integers(1, 3000))
    k = int(rng.integers(1, 20))
    if case == "random":
        offs = rng.integers(-cp, cp + 1, k)
    elif case == "no interior":          # the band spans the shard
        lo = int(rng.integers(-cp, 1))
        offs = np.r_[lo, lo + cp + rng.integers(0, 40),
                     rng.integers(lo, lo + cp, k)]
    elif case == "one row":              # a span of cp - 1
        lo = int(rng.integers(-cp + 1, 1))
        offs = np.r_[lo, lo + cp - 1, rng.integers(lo, lo + cp, k)]
    elif case == "offsets >= 0":
        offs = rng.integers(0, cp + 1, k)
    elif case == "offsets <= 0":
        offs = rng.integers(-cp, 1, k)
    else:                                # the main diagonal alone
        offs = np.zeros(1, dtype=np.int64)
    return cp, tuple(int(o) for o in offs)


@pytest.mark.parametrize("case", ["random", "no interior", "one row",
                                  "offsets >= 0", "offsets <= 0",
                                  "main diagonal"])
def test_ring_interior_matches_brute_force(case):
    """``ring_interior``, the rows that K8a runs without the slivers: on
    random shards and offset sets, exactly the rows whose every ``k +
    off`` lies in ``[0, cp)`` (numpy over every row), an empty range
    (``lo == hi``) where there are none."""
    rng = np.random.default_rng(len(case))
    for _ in range(40):
        cp, offs = _interior_case(case, rng)
        lo, hi = tdst.ring_interior(offs, cp)
        j = np.arange(cp)[:, None] + np.array(offs)[None, :]
        inside = np.flatnonzero(((j >= 0) & (j < cp)).all(axis=1))
        assert 0 <= lo <= hi <= cp, (cp, offs, lo, hi)
        assert np.array_equal(inside, np.arange(lo, hi)), (cp, offs, lo, hi)
        if case == "no interior":
            assert lo == hi
        elif case == "one row":
            assert hi == lo + 1
        elif case != "random":
            assert hi - lo == cp - max(abs(o) for o in offs)


def test_sharded_dia_matches_reference():
    """ShardedDIA (K8a's plain version with whole chunks as slivers) on a
    band whose rows do not divide evenly: the reference's layout at 1, 2
    and 4 shards, its product at 4 (the ring with a ragged last shard)."""
    m = utils.banded(203, 3, seed=6)
    jdia = ts.convert(ts.COO.from_scipy(m.tocoo(), dtype=jnp.float64), "dia")
    tdia = t_convert(TCOO.from_scipy(m, dtype=torch.float64), "dia")
    x = np.random.default_rng(2).standard_normal(203)
    for ndev in (1, 2, 4):
        J = jplanned.ShardedDIA.build(jdia, ndev)
        A = tdist.ShardedDIA.build(tdia, ndev)
        for s in range(ndev):
            np.testing.assert_array_equal(A.data[s].numpy(),
                                          np.asarray(J.data)[s])
        mesh = _mesh(ndev)
        y = tdist.spmv_dia_sharded(mesh, tdist.place(A, mesh), tdist.place(
            tdist.ShardedVector.from_global(x, A.x_plan), mesh)).to_global()
        assert _rel(y, m @ x) <= 1e-13
    jmesh = jdist.make_mesh(4)
    yj = jax.jit(lambda A, v: jplanned.spmv_dia_sharded(jmesh, A, v))(
        J, jdist.ShardedVector.from_global(x, J.x_plan))
    assert _rel(y, yj.to_global()) <= 1e-13
    with pytest.raises(ValueError, match="band"):
        tdist.ShardedDIA.build(t_convert(TCOO.from_scipy(
            utils.banded(64, 40, seed=5)), "dia"), 8)


def test_plan_dist_spmv_picks():
    """The port's picks and each divergence from the reference's, as the
    port's stated rules: streaming at every size (the reference streams
    only past 32 MiB per device and plans small bands to "dia"), BDIA for
    block-banded patterns as in the reference, csr_neighbor for an empty
    matrix (as the reference's cost model picks there)."""
    mesh = _mesh(4)
    cases = [("laplacian_2d(24)", utils.laplacian_2d(24), "dia",
              "pdia_stream"),
             ("banded(777,5)", utils.banded(777, 5), "dia", "dia_stream"),
             ("block_laplacian(12)", utils.block_laplacian(12, bs=8, seed=2),
              "bdia", "bdia"),
             ("random_sparse(300,300)",
              utils.random_sparse(300, 300, 0.03, seed=3), "gpr", "gpr"),
             ("empty", sp.csr_matrix((10, 10)), "csr_neighbor",
              "csr_neighbor")]
    for name, m, jpick, tpick in cases:
        if jpick != "gpr":          # the reference's GPR pack is the slow one
            assert jdist.plan_dist_spmv(m, 4, dtype=np.float32).strategy \
                == jpick, name
        plan = tdist.plan_dist_spmv(m, mesh, dtype=np.float32)
        assert plan.strategy == tpick, name
        assert plan.mesh == mesh
        if m.nnz:
            x = np.random.default_rng(3).random(m.shape[1]).astype(
                np.float32)
            y = plan.y_to_global(plan.spmv(plan.shard_x(x)))
            assert _rel(y, m @ x.astype(np.float64)) <= 2e-5, name
    # every forced strategy runs and verifies
    lap = utils.laplacian_2d(16)
    x = np.random.default_rng(4).standard_normal(256)
    for strategy in ("dia", "dia_stream", "pdia_stream", "bdia", "gpr",
                     "csr_halo", "csr_neighbor", "csr_allgather"):
        plan = tdist.plan_dist_spmv(lap, mesh, strategy=strategy,
                                    sdia_rb=RB)
        assert plan.strategy == strategy
        y = plan.y_to_global(plan.spmv(plan.shard_x(x)))
        assert _rel(y, lap @ x) <= 1e-13, strategy
    with pytest.raises(ValueError, match="distributed strategy"):
        tdist.plan_dist_spmv(lap, mesh, strategy="bogus")
    with pytest.raises(ValueError, match="periodic"):
        tdist.plan_dist_spmv(utils.banded(3000, 4, seed=33), mesh,
                             strategy="pdia_stream", sdia_rb=RB)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="only 0 available"):
            tdist.plan_dist_spmv(lap, 1)


@pytest.mark.parametrize("ndev", (1, 2, 4))
def test_sharded_gpr(ndev):
    """Each shard packs its own rows (hub rows split per shard); the
    product against scipy and the port's single-chip GPR."""
    m = utils.power_law(650, 650, 7, seed=6).tocsr()
    assert np.diff(m.indptr).max() > tgpr.LANES
    mesh = _mesh(ndev)
    for dtype, tol in ((np.float32, 1e-6), (np.float64, 1e-13)):
        plan = tdist.plan_dist_spmv(m, mesh, dtype=dtype, strategy="gpr")
        A = plan.matrix
        assert A.rows_per_shard == -(-650 // ndev)
        assert sum(p.nv for p in A.gpcsr) > 0
        x = np.random.default_rng(5).random(650).astype(dtype)
        y = plan.y_to_global(plan.spmv(plan.shard_x(x)))
        single = tgpr.spmv_gpr(tgpr.pack_gpr(m, dtype=dtype, device="cpu"),
                               torch.from_numpy(x))
        assert _rel(y, single) <= tol
        assert _rel(y, m @ x.astype(np.float64)) <= 2e-5


@pytest.mark.parametrize("strategy,ndev", [("dia", 1), ("dia_stream", 2),
                                            ("pdia_stream", 4)])
def test_from_reference_planned(strategy, ndev):
    """A reference DistPlan over a ShardedDIA, ShardedSDIA or ShardedPSDIA
    carries over onto a port mesh and computes what the port's own plan
    does; a ShardedGPR is refused."""
    mesh = _mesh(ndev)
    m = utils.laplacian_2d(16)
    x = np.random.default_rng(6).standard_normal(256)
    jplan = jdist.plan_dist_spmv(m, ndev, dtype=np.float64,
                                 strategy=strategy, sdia_rb=RB)
    plan = from_reference(jplan, mesh=mesh)
    tplan = tdist.plan_dist_spmv(m, mesh, dtype=np.float64,
                                 strategy=strategy, sdia_rb=RB)
    assert type(plan.matrix) is type(tplan.matrix)
    assert plan.x_plan == tplan.x_plan and plan.row_plan == tplan.row_plan
    y = plan.y_to_global(plan.spmv(plan.shard_x(x)))
    assert _rel(y, tplan.y_to_global(tplan.spmv(tplan.shard_x(x)))) == 0
    assert _rel(y, m @ x) <= 1e-13
    G = jplanned.ShardedGPR.build(utils.random_sparse(40, 40, 0.1, seed=1)
                                  .tocsr(), ndev)
    with pytest.raises(TypeError, match="re-plan from the host matrix"):
        from_reference(G, mesh=mesh)


def test_bench_dist_spmv_and_cli(capsys):
    mesh = _mesh(2)
    r = tdist.bench_dist_spmv(utils.laplacian_2d(16), mesh, iters=3)
    assert r["strategy"] == "pdia_stream" and r["ndev"] == 2
    assert r["rel_err"] <= 2e-5 and r["gflops"] > 0
    out = capsys.readouterr().out
    assert "### CSR DIST2 GFLOPS =" in out
    assert "DIST2: strategy=pdia_stream |" in out
    plan = tdist.plan_dist_spmv(utils.laplacian_2d(16), mesh,
                                dtype=np.float64, strategy="csr_halo")
    r = tdist.bench_dist_spmv(utils.laplacian_2d(16), mesh, dtype=np.float64,
                              iters=2, plan=plan, quiet=True)
    assert r["strategy"] == "csr_halo" and r["rel_err"] <= 1e-10
    with pytest.raises(ValueError, match="another mesh"):
        tdist.bench_dist_spmv(utils.laplacian_2d(16), _mesh(1), plan=plan)
    assert main(["--synthetic", "laplacian:64", "--device", "cpu", "--dist",
                 "4", "--formats", "csr", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "### CSR DIST4 GFLOPS =" in out
    assert "DIST4: strategy=pdia_stream |" in out
    assert main(["--synthetic", "powerlaw:500,9", "--device", "cpu",
                 "--dist", "2", "--dist-strategy", "csr_neighbor",
                 "--formats", "coo", "--iters", "2", "--json"]) == 0
    import json
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    dist = [r for r in recs if r.get("mode") == "DIST2"]
    assert dist and dist[0]["strategy"] == "csr_neighbor"


def test_sharded_stream_bytes():
    """What a single-chip pack counts (the data or the pattern, x and y;
    at one shard exactly its count; the replicated pattern once on each
    device that holds it), plus ``band`` values each side of every
    boundary between shards."""
    _, pack = _packs("psdia", "laplacian_2d(32)", "float32")
    assert spmv_bytes(tdist.ShardedPSDIA.build(pack, 1)) == spmv_bytes(pack)
    A = tdist.ShardedPSDIA.build(pack, 4)
    assert spmv_bytes(A) == 5 * RB * 4 + (2 * 1024 + 2 * 32 * 3) * 4
    _, pack = _packs("sdia", "banded(777,5)", "float64")
    assert spmv_bytes(tdist.ShardedSDIA.build(pack, 1)) == spmv_bytes(pack)
    S = tdist.ShardedSDIA.build(pack, 2)
    nd, band = len(S.offsets), max(abs(o) for o in S.offsets)
    assert spmv_bytes(S) == 2 * nd * 768 * 8 + (2 * 777 + 2 * band) * 8
