"""Port multi-RHS products (SpMM) against the JAX reference package.

The JAX side runs its Pallas kernels in interpret mode (K3a/K3b, the GPR
SpMM, ``spmm_pallas``) or its XLA tier (``ops.spmm``); the port runs the
plain PyTorch versions that its wrappers take for CPU tensors.  Each JAX
product is computed once for 33 right-hand sides; the port's products with
1, 3 and 33 of the same columns are held against its first columns (a
column of ``A @ X`` depends on that column of ``X`` alone).

Limits, rel = max|Y - ref| / max|ref|: against JAX 1e-6 in float32 and
1e-13 in float64 (the same sums, in another order for GPR and ELL);
against scipy float64 2e-5 in float32 and 1e-10 in float64.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from _gpr_reference import spmm_block
from tpu_spmv import ops as jops
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv.kernels import ell_pallas
from tpu_spmv.kernels import gpr as jgpr
from tpu_spmv_torch import COO as TCOO
from tpu_spmv_torch import convert as t_convert
from tpu_spmv_torch.bench.roofline import spmm_bytes, spmv_bytes
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import ell_packed as tell
from tpu_spmv_torch.kernels import gpr as tgpr
from tpu_spmv_torch.ops.spmm import spmm as t_spmm
from tpu_spmv_torch.ops.auto import plan_from_matrix, plan_spmv

torch.set_num_threads(1)

JAX_TOL = {"float32": 1e-6, "float64": 1e-13}
ORACLE_TOL = {"float32": 2e-5, "float64": 1e-10}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
NRHS = (1, 3, 33)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MATS = {"laplacian_2d(32)": lambda: utils.laplacian_2d(32),
        "laplacian_3d(8)": lambda: utils.laplacian_3d(8)}


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _X(n, dname, nrhs=max(NRHS), seed=0):
    return np.random.default_rng(seed).random((n, nrhs)).astype(dname)


def _pack(mod, kind, dia, nrhs):
    return (mod.pack_sdia(dia, nrhs=nrhs) if kind == "sdia"
            else mod.pack_psdia(dia, nrhs=nrhs))


@functools.cache
def _dias(name, dname):
    """(matrix, JAX DIA, port DIA) of one streaming operand."""
    m = MATS[name]()
    return (m, ts.convert(ts.COO.from_scipy(m, dtype=DTYPES[dname][1]), "dia"),
            t_convert(TCOO.from_scipy(m, dtype=DTYPES[dname][0]), "dia"))


@functools.cache
def _streaming_reference(name, kind, dname):
    """(matrix, X, JAX pack, JAX ``A @ X``) of one streaming operand with
    33 right-hand sides: through the reference's padded-t kernel call in
    float32 and through its plain-layout wrapper in float64 (which pads,
    calls the same kernel and slices)."""
    m, dia_j, _ = _dias(name, dname)
    A_j = _pack(jds, kind, dia_j, max(NRHS))
    X = _X(m.shape[0], dname)
    if dname == "float64":
        fn = jds.spmm_sdia if kind == "sdia" else jds.spmm_psdia
        return m, X, A_j, np.asarray(fn(A_j, jnp.asarray(X), interpret=True))
    fn = (jds.spmm_sdia_padded_t if kind == "sdia"
          else jds.spmm_psdia_padded_t)
    Yt = np.asarray(fn(A_j, jnp.asarray(_pad_t(A_j, X)), interpret=True))
    return m, X, A_j, Yt[:, A_j.L:A_j.L + m.shape[0]].T


def _pad_t(A, X):
    """``[n, nrhs]`` → the padded transposed ``[nrhs, npad]`` layout."""
    Xt = np.zeros((X.shape[1], A.npad), X.dtype)
    Xt[:, A.L:A.L + X.shape[0]] = X.T
    return Xt


@functools.cache
def _poisson256():
    m = utils.laplacian_2d(256)
    return (m, ts.convert(ts.COO.from_scipy(m, dtype=jnp.float32), "dia"),
            t_convert(TCOO.from_scipy(m, dtype=torch.float32), "dia"))


@pytest.mark.parametrize("nrhs", [1, 33])
@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_pack_rules_follow_nrhs(kind, nrhs):
    """The nrhs arm of the row-tile rules gives the reference's tile where
    it engages (a 65,536-row Poisson: SDIA 65536 -> 32768, PSDIA 65536 ->
    63488 at 33 RHS)."""
    m, dia_j, dia_t = _poisson256()
    A_j, A_t = _pack(jds, kind, dia_j, nrhs), _pack(tds, kind, dia_t, nrhs)
    assert (A_t.rb, A_t.L, A_t.npad) == (A_j.rb, A_j.L, A_j.npad)
    assert A_t.rb == {("sdia", 1): 65536, ("sdia", 33): 32768,
                      ("psdia", 1): 65536, ("psdia", 33): 63488}[kind, nrhs]
    assert tds._auto_rb(5, (-4096, -1, 0, 1, 4096), 4096**2, nrhs=32) == \
        jds._auto_rb(5, (-4096, -1, 0, 1, 4096), 4096**2, nrhs=32) == 65536
    assert tds.supports_sdia(dia_t.offsets, m.shape, nrhs=nrhs)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("kind", ["sdia", "psdia"])
@pytest.mark.parametrize("name", MATS)
def test_streaming_spmm_matches_interpret(name, kind, dname):
    """K3a/K3b: the port's own pack (same nrhs, same rb, L, npad as the
    reference's) and the JAX pack carried over, padded-t and plain-layout
    wrappers, against the interpret-mode kernel."""
    m, X, A_j, Y_j = _streaming_reference(name, kind, dname)
    _, dia_j, dia_t = _dias(name, dname)
    n = m.shape[0]
    padded_t, plain = ((tds.spmm_sdia_padded_t, tds.spmm_sdia)
                       if kind == "sdia"
                       else (tds.spmm_psdia_padded_t, tds.spmm_psdia))
    for nrhs in NRHS:
        A_t = _pack(tds, kind, dia_t, nrhs)
        A_jq = _pack(jds, kind, dia_j, nrhs)
        assert (A_t.rb, A_t.L, A_t.npad) == (A_jq.rb, A_jq.L, A_jq.npad)
        for A in (A_t, from_reference(A_j, device="cpu")):
            Yt = padded_t(A, torch.from_numpy(_pad_t(A, X[:, :nrhs])))
            assert Yt.shape == (nrhs, A.npad)
            assert Yt.dtype == DTYPES[dname][0]
            assert bool((Yt[:, :A.L] == 0).all()
                        and (Yt[:, A.L + n:] == 0).all())
            assert _rel(Yt[:, A.L:A.L + n].T, Y_j[:, :nrhs]) \
                <= JAX_TOL[dname]
            Y = plain(A, torch.from_numpy(X[:, :nrhs]))
            assert Y.shape == (n, nrhs) and Y.is_contiguous()
            assert _rel(Y, Y_j[:, :nrhs]) <= JAX_TOL[dname]
    assert _rel(Y_j, m @ X.astype(np.float64)) <= ORACLE_TOL[dname]


@functools.cache
def _gpr_reference():
    """powerlaw800 (4 rows over 128 entries: the hub split and the fold
    engage), X [800, 3], the JAX interpret-mode SpMM (its rows of the
    SpMM that ``_gpr_reference.py`` shares with ``test_torch_gpr.py``)."""
    m, X, Y_j = spmm_block()
    return m, X, jgpr.pack_gpr(m, dtype=np.float32), Y_j


def test_gpr_spmm_matches_reference():
    m, X, A_j, Y_j = _gpr_reference()
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    assert A.nv == A_j.nv > 0
    Y_int = tgpr.spmm_gpr_rows(A, torch.from_numpy(X))
    assert Y_int.shape == (m.shape[0] + A.nv, 3)
    Y = tgpr.spmm_gpr(A, torch.from_numpy(X))
    assert Y.shape == (m.shape[0], 3) and Y.dtype == torch.float32
    assert _rel(Y, Y_j) <= JAX_TOL["float32"]
    assert _rel(Y, m @ X.astype(np.float64)) <= ORACLE_TOL["float32"]


@pytest.mark.parametrize("nrhs", NRHS)
@pytest.mark.parametrize("name", ["powerlaw800", "random_sparse(300,2000)"])
def test_gpr_spmm_against_scipy_and_spmv(name, nrhs):
    """f64 against scipy, and each column against the port's SpMV: the
    fold of 2-D virtual-row sums adds each owner's run once."""
    m = (sio.mmread(os.path.join(FIX, "powerlaw800.mtx")).tocsr()
         if name == "powerlaw800"
         else utils.random_sparse(300, 2000, 8 / 2000, seed=7))
    X = np.random.default_rng(2).standard_normal((m.shape[1], nrhs))
    A = tgpr.pack_gpr(m, device="cpu")
    Y = tgpr.spmm_gpr(A, torch.from_numpy(X))
    assert _rel(Y, m @ X) <= ORACLE_TOL["float64"]
    for q in range(nrhs):
        x = torch.from_numpy(np.ascontiguousarray(X[:, q]))
        assert _rel(Y[:, q], tgpr.spmv_gpr(A, x)) <= JAX_TOL["float64"]


def _ell_operands():
    """A 300² random matrix with one 200-entry row (the port's side COO
    engages) and bus420."""
    m = utils.random_sparse(300, 300, 8 / 300, seed=3).tolil()
    m[7, :200] = np.arange(1, 201) / 100.0
    return {"random_sparse(300,300)+row": m.tocsr(),
            "bus420": sio.mmread(os.path.join(FIX, "bus420.mtx")).tocsr()}


@pytest.mark.parametrize("name", list(_ell_operands()))
def test_ell_spmm_matches_reference(name):
    """The port's sliced-ELL SpMM (side COO added once) and a reference
    PackedELL carried over against the reference's ``spmm_pallas``."""
    m = _ell_operands()[name]
    X = _X(m.shape[1], "float32", 3, seed=4)
    P = ell_pallas.pack_ell(m.astype(np.float32))
    Y_j = np.asarray(ell_pallas.spmm_pallas(P, jnp.asarray(X),
                                            interpret=True))
    A = tell.pack_ell(m, dtype=torch.float32, device="cpu")
    assert (A.side.nnz > 0) == (name != "bus420")
    for B in (A, from_reference(P, device="cpu")):
        Y = tell.spmm_ell_packed(B, torch.from_numpy(X))
        assert Y.shape == (m.shape[0], 3) and Y.dtype == torch.float32
        assert _rel(Y, Y_j) <= JAX_TOL["float32"]
    ref = m @ X.astype(np.float64)
    assert _rel(Y_j, ref) <= ORACLE_TOL["float32"]
    X64 = np.random.default_rng(5).standard_normal((m.shape[1], 33))
    A64 = tell.pack_ell(m, device="cpu")
    Y64 = tell.spmm_ell_packed(A64, torch.from_numpy(X64))
    assert _rel(Y64, m @ X64) <= ORACLE_TOL["float64"]
    x5 = torch.from_numpy(np.ascontiguousarray(X64[:, 5]))
    assert _rel(tell.spmm_ell_main(A64, torch.from_numpy(X64))[:, 5],
                tell.spmv_ell_main(A64, x5)) <= JAX_TOL["float64"]


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_ops_spmm_matches_reference(fmt):
    m = utils.laplacian_2d(16) + utils.banded(256, 3, seed=2)
    X = np.random.default_rng(6).standard_normal((256, 5))
    A_j = ts.convert(ts.COO.from_scipy(m, dtype=jnp.float64), fmt)
    A_t = t_convert(TCOO.from_scipy(m, dtype=torch.float64), fmt)
    Y = t_spmm(A_t, torch.from_numpy(X))
    assert Y.shape == (256, 5)
    assert _rel(Y, np.asarray(jops.spmm(A_j, jnp.asarray(X)))) \
        <= JAX_TOL["float64"]
    assert _rel(Y, m @ X) <= ORACLE_TOL["float64"]
    with pytest.raises(ValueError, match="ncol, nrhs"):
        t_spmm(A_t, torch.from_numpy(X[:, 0]))


def _plans():
    lap = utils.laplacian_2d(20)
    p = np.random.default_rng(0).permutation(lap.shape[0])
    band = utils.banded(500, 5, seed=1)
    plans = {strategy: plan_spmv(mat, dtype=torch.float64, device="cpu")
             for strategy, mat in (
                 ("pdia_stream", lap), ("dia_stream", band),
                 ("gpr", utils.power_law(800, 800, 12, seed=2)),
                 ("pallas_ell", lap[p][:, p].tocsr()))}
    for strategy, mat in (("dia", band), ("csr", lap)):
        plans[strategy] = plan_from_matrix(
            t_convert(TCOO.from_scipy(mat, dtype=torch.float64), strategy),
            strategy)
    return plans


def test_plan_spmm_every_strategy():
    for strategy, plan in _plans().items():
        assert plan.strategy == strategy
        X = np.random.default_rng(8).standard_normal((plan.matrix.shape[1],
                                                      4))
        Y = plan.spmm(torch.from_numpy(X))
        # the f64 SpMV of each column is the oracle-checked reference
        cols = np.stack([plan(torch.from_numpy(np.ascontiguousarray(
            X[:, q]))).numpy() for q in range(4)], axis=1)
        assert Y.shape == cols.shape and Y.is_contiguous(), strategy
        assert _rel(Y, cols) <= JAX_TOL["float64"], strategy
        # a transposed view is taken in the kernels' row-major layout
        Xv = torch.from_numpy(np.ascontiguousarray(X.T)).T
        assert torch.equal(plan.spmm(Xv), Y), strategy


def test_plan_spmm_against_scipy():
    lap = utils.laplacian_2d(20)
    plaw = utils.power_law(800, 800, 12, seed=2)
    for mat in (lap, plaw):
        for dname in DTYPES:
            plan = plan_spmv(mat, dtype=DTYPES[dname][0], device="cpu")
            X = _X(mat.shape[1], dname, 33, seed=9)
            assert _rel(plan.spmm(torch.from_numpy(X)),
                        mat @ X.astype(np.float64)) <= ORACLE_TOL[dname]


def test_spmm_bytes():
    """The matrix once plus nrhs x and y vectors; the streaming-DIA
    kernels move padded ``[nrhs, npad]`` blocks."""
    m = utils.laplacian_2d(32)
    dia = t_convert(TCOO.from_scipy(m, dtype=torch.float32), "dia")
    P = tds.pack_psdia(dia, nrhs=32)
    assert spmm_bytes(P, 32) == P.pattern.numel() * 4 + 32 * 2 * P.npad * 4
    S = tds.pack_sdia(dia, nrhs=32)
    assert spmm_bytes(S, 32) == S.data.numel() * 4 + 32 * 2 * S.npad * 4
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    assert spmm_bytes(A, 1) == spmv_bytes(A)
    assert spmm_bytes(A, 32) - spmm_bytes(A, 1) == 31 * 2 * 1024 * 4


def test_wrappers_reject_what_the_kernels_do_not_take():
    m = utils.power_law(300, 300, 10, seed=4)
    G = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    E = tell.pack_ell(m, dtype=torch.float32, device="cpu")
    dia = t_convert(TCOO.from_scipy(utils.laplacian_2d(16),
                                    dtype=torch.float32), "dia")
    P, S = tds.pack_psdia(dia, nrhs=3), tds.pack_sdia(dia, nrhs=3)
    X = torch.zeros(300, 3)
    launches = (dict(tds.LAUNCHES), dict(tgpr.LAUNCHES), dict(tell.LAUNCHES))
    for fn, A in ((tgpr.spmm_gpr_rows, G), (tell.spmm_ell_main, E)):
        with pytest.raises(TypeError, match="float32"):
            fn(A, X.double())
        with pytest.raises(ValueError, match="nrhs"):
            fn(A, X[:, 0])
        with pytest.raises(ValueError, match="contiguous"):
            fn(A, torch.zeros(3, 300).T)
        with pytest.raises(ValueError, match="matrix on cpu"):
            fn(A, X.to("meta"))
        with pytest.raises(ValueError, match="no kernel for meta"):
            fn(A.to("meta"), X.to("meta"))
    for fn, A in ((tds.spmm_psdia_padded_t, P), (tds.spmm_sdia_padded_t, S)):
        Xt = torch.zeros(3, A.npad)
        with pytest.raises(TypeError, match="float64"):
            fn(A, Xt.double())
        with pytest.raises(ValueError, match="nrhs, npad"):
            fn(A, Xt[0])
        with pytest.raises(ValueError, match="contiguous"):
            fn(A, torch.zeros(A.npad, 3).T)
        with pytest.raises(ValueError, match="no kernel for meta"):
            fn(A.to("meta"), Xt.to("meta"))
    with pytest.raises(ValueError, match="ncol, nrhs"):
        tds.spmm_psdia(P, torch.zeros(256))
    # the plain versions ran on CPU tensors: nothing counted
    tgpr.spmm_gpr(G, X)
    tell.spmm_ell_packed(E, X)
    tds.spmm_psdia(P, torch.zeros(256, 3))
    assert (tds.LAUNCHES, tgpr.LAUNCHES, tell.LAUNCHES) == launches
    assert set(tds.LAUNCHES) >= {"sdia_spmm", "psdia_spmm"}
    assert "gpr_spmm" in tgpr.LAUNCHES and "ell_spmm" in tell.LAUNCHES
    empty = tgpr.pack_gpr(sp.csr_matrix((3, 4)), device="cpu")
    assert tgpr.spmm_gpr(empty, torch.ones(4, 2, dtype=torch.float64)) \
        .tolist() == [[0.0, 0.0]] * 3
