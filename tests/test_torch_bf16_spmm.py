"""bf16 coefficients on the multi-RHS path against the JAX reference:
every arm's ``plan.spmm`` on a bf16 plan with a float32 X, K3a's plain
bf16 version against the reference's interpret-mode kernel, the plain
bf16 SpMMs against a scalar emulation of the kernels' order, ``cg_multi``
on a bf16 plan and the CLI's ``--dtype bfloat16`` with ``--spmm``,
``--dist`` and ``--solve-nrhs``.

Limits: each bf16 plan's product within 1e-6 relative of the reference's
bf16 plan's ``spmm`` of the same matrix (float32 sums of the same
products, in another order), and within 2e-5 of scipy on the rounded
matrix; K3a's plain version within 1e-6 of the reference's kernel (which
adds rounded products where the card fuses them); the plain versions
equal, bit for bit, the scalar emulation."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv.ops import auto as jauto
from tpu_spmv_torch import COO as TCOO
from tpu_spmv_torch import convert as t_convert
from tpu_spmv_torch.bench.harness import verify_against_oracle
from tpu_spmv_torch.cli import main
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import dist_stream as tdst
from tpu_spmv_torch.kernels import ell_packed as tell
from tpu_spmv_torch.kernels import gpr as tgpr
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.solvers import cg_multi

from _solver_reference import rel

torch.set_num_threads(1)

NRHS = 4


def _shuffled_poisson(g: int) -> sp.csr_matrix:
    m = utils.laplacian_2d(g)
    perm = np.random.default_rng(3).permutation(m.shape[0])
    return m[perm][:, perm].tocsr()


def _wide_band(n: int = 140_000, off: int = 135_000) -> sp.csr_matrix:
    """Three diagonals too far apart for any streaming tile: plain DIA."""
    rng = np.random.default_rng(4)
    return sp.diags([rng.standard_normal(n - off), rng.standard_normal(n),
                     rng.standard_normal(n - off)], [-off, 0, off],
                    shape=(n, n), format="csr")


def _random_band(n: int, half: int, seed: int) -> sp.csr_matrix:
    m = utils.banded(n, half, seed=seed).tocsr()
    m.data = np.random.default_rng(seed).standard_normal(m.nnz)
    return m


#: the port's strategy at bf16 -> its operand (values float32 first, so
#: both packages round them to bf16 once, alike)
OPERANDS = {"pdia_stream": lambda: utils.laplacian_2d(24),
            "dia_stream": lambda: _random_band(2000, 3, 5),
            "gpr": lambda: utils.power_law(3000, 3000, 8, seed=1),
            "pallas_ell": lambda: _shuffled_poisson(40),
            "dia": _wide_band,
            "bdia": lambda: utils.block_laplacian(6, bs=8, seed=0),
            "csr": lambda: sp.csr_matrix((500, 500))}


def _rounded(m):
    r = m.astype(np.float64)
    r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
    return r


@pytest.fixture(scope="module")
def case():
    """Each operand, a float32 X and the reference's bf16 plan's ``spmm``
    of it, computed once (XLA arms on the CPU)."""
    out = {}
    for name, make in OPERANDS.items():
        m = make().astype(np.float32).tocsr()
        X = np.random.default_rng(7).random((m.shape[1], NRHS)).astype(
            np.float32)
        pj = jauto.plan_spmv(m, dtype=jnp.bfloat16)
        Y_j = jax.jit(lambda V: pj.spmm(V))(jnp.asarray(X))
        out[name] = dict(m=m, X=X, Y_j=np.asarray(Y_j, np.float64))
    return out


@pytest.mark.parametrize("name", OPERANDS)
def test_bf16_plan_spmm_matches_reference(case, name):
    """Every arm's SpMM takes bf16 data with a float32 X: the strategy,
    float32 out, the product against the reference's bf16 plan and
    against scipy on the rounded matrix; each column against the plan's
    SpMV (bitwise where the SpMV and the SpMM sum in one order)."""
    c = case[name]
    plan = plan_spmv(c["m"], dtype=torch.bfloat16, device="cpu")
    assert plan.strategy == name
    assert plan.matrix.dtype == torch.bfloat16
    X = torch.from_numpy(c["X"])
    Y = plan.spmm(X)
    assert Y.dtype == torch.float32 and tuple(Y.shape) == c["Y_j"].shape
    assert rel(Y, c["Y_j"]) <= 1e-6
    verify_against_oracle(plan.matrix, X, Y, oracle=_rounded(c["m"]),
                          rounded=True)
    for q in range(NRHS):
        y = plan(X[:, q].contiguous())
        if name in ("dia_stream", "pallas_ell"):
            assert torch.equal(Y[:, q], y), q
        else:
            assert rel(Y[:, q], y.numpy()) <= 1e-6, q


def test_k3a_bf16_plain_matches_reference_interpret():
    """The reference's ``pack_sdia(data_dtype=bfloat16)`` and the port's
    hold the same bf16 data at the same tile, and K3a's plain bf16 version
    (the kernel's exact fma a diagonal) agrees with the reference's
    interpret-mode ``spmm_sdia_padded_t`` on it."""
    m = _random_band(1500, 4, 8)
    jdia = ts.convert(ts.COO.from_scipy(m.tocoo(), dtype=jnp.float32), "dia")
    J = jds.pack_sdia(jdia, rb=512, data_dtype=jnp.bfloat16)
    tdia = t_convert(TCOO.from_scipy(m, dtype=torch.float32), "dia")
    A = tds.pack_sdia(tdia, rb=512, data_dtype=torch.bfloat16)
    assert (A.L, A.rb, A.npad, A.offsets) == (J.L, J.rb, J.npad,
                                              tuple(J.offsets))
    assert A.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(A.data.float().numpy(),
                                  np.asarray(J.data, np.float32))
    Xt = np.zeros((3, A.npad), np.float32)
    Xt[:, A.L:A.L + m.shape[0]] = np.random.default_rng(2).random(
        (3, m.shape[0]))
    Yj = jds.spmm_sdia_padded_t(J, jnp.asarray(Xt), interpret=True)
    Y = tds.spmm_sdia_padded_t(A, torch.from_numpy(Xt))
    assert Y.dtype == torch.float32
    assert rel(Y, np.asarray(Yj, np.float64)) <= 1e-6
    ref = _rounded(m) @ Xt[:, A.L:A.L + m.shape[0]].T.astype(np.float64)
    assert rel(Y[:, A.L:A.L + m.shape[0]].T, ref) <= 2e-5


def _fma32(a, b, c) -> np.float32:
    """a * b + c rounded once to float32, to nearest, ties to even, from
    the exact rational value."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(ex))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - ex) for v in near]
    best = min(dist)
    ties = [v for v, d in zip(near, dist) if d == best]
    return min(ties, key=lambda v: int(np.array(v).view(np.int32)) & 1)


def test_bf16_plain_spmms_sum_in_the_kernels_order():
    """The plain bf16 versions equal, bit for bit, a scalar emulation of
    the kernels' loops: ``gpr_spmm`` and ``ell_spmm`` add each output's
    rounded products (float32) in entry (slot) order from zero; K3a and
    K8a add one exact fma a diagonal from zero (in K8a the slivers' values
    too)."""
    f32 = np.float32
    rng = np.random.default_rng(3)
    lens = np.concatenate([np.arange(0, 200, 7), [0, 0, 150]])
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(300, k, replace=False) for k in lens])
    m = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(len(lens), 300))
    X = rng.standard_normal((300, 2)).astype(f32)
    Xt = torch.from_numpy(X)

    A = tgpr.pack_gpr(m, dtype=torch.bfloat16, device="cpu")
    assert A.nv > 0
    data, ind = A.data.float().numpy(), A.indices.numpy()
    ptr, ids = A.indptr.numpy(), A.rows.numpy()
    want = np.empty((A.nrow_internal, 2), f32)
    for r in range(A.nrow_internal):
        for q in range(2):
            a = f32(0)
            for j in range(ptr[r], ptr[r + 1]):
                a = f32(a + f32(data[j] * X[ind[j], q]))
            want[ids[r], q] = a
    assert np.array_equal(tgpr.spmm_gpr_ref(A, Xt).numpy(), want)

    E = tell.pack_ell(m, dtype=torch.bfloat16, device="cpu")
    vals, ecols, sptr = (E.vals.float().numpy(), E.cols.numpy(),
                         E.slice_ptr.numpy())
    want = np.empty((m.shape[0], 2), f32)
    for row in range(m.shape[0]):
        s = row // 32
        for q in range(2):
            a = f32(0)
            for j in range((sptr[s + 1] - sptr[s]) // 32):
                k = sptr[s] + 32 * j + row % 32
                a = f32(a + f32(vals[k] * X[ecols[k], q]))
            want[row, q] = a
    assert np.array_equal(tell.spmm_ell_packed_ref(E, Xt).numpy(), want)

    band = _random_band(40, 2, 9)
    S = tds.pack_sdia(t_convert(TCOO.from_scipy(band, dtype=torch.float32),
                                "dia"), rb=64, data_dtype=torch.bfloat16)
    coef = S.data.float().numpy()
    Xp = np.zeros((2, S.npad), f32)
    Xp[:, S.L:S.L + 40] = rng.standard_normal((2, 40))
    want = np.zeros((2, S.npad), f32)
    for q in range(2):
        for k in range(S.npad):
            a = f32(0)
            for d, off in enumerate(S.offsets):
                x = Xp[q, k + off] if 0 <= k + off < S.npad else f32(0)
                a = _fma32(coef[d, k], x, a)
            want[q, k] = a
    assert np.array_equal(
        tds.spmm_sdia_padded_t_ref(S, torch.from_numpy(Xp)).numpy(), want)

    h = 4
    x, left, right = (rng.standard_normal(n).astype(f32)
                      for n in (S.npad, h, h))
    xw = np.concatenate([left, x, right])
    want = np.array([_fma32_chain(coef[:, k], [xw[h + k + o]
                                               for o in S.offsets])
                     for k in range(S.npad)], f32)
    got = tdst.spmv_sdia_ring_ref(S.data, S.offsets, torch.from_numpy(x),
                                  torch.from_numpy(left),
                                  torch.from_numpy(right))
    assert np.array_equal(got.numpy(), want)


def _fma32_chain(coefs, xs) -> np.float32:
    a = np.float32(0)
    for c, x in zip(coefs, xs):
        a = _fma32(c, x, a)
    return a


def test_cg_multi_and_the_cli_on_bf16_plans(capsys):
    """``cg_multi`` on a bf16 plan (K3a's bf16 form: the random values
    leave no period) with float32 B takes the steps of the float32 plan
    of the rounded matrix, to within 1e-6 (the bf16 form fuses each
    product into its sum);
    the CLI runs ``--dtype bfloat16`` with ``--spmm``, ``--dist`` and
    ``--solve cg --solve-nrhs`` and passes its gates."""
    m = (utils.laplacian_2d(16) + sp.identity(256)).tocsr()
    m.data = m.data * np.random.default_rng(1).uniform(0.9, 1.1, m.nnz)
    m = ((m + m.T) / 2).tocsr()
    p16 = plan_spmv(m, dtype=torch.bfloat16, device="cpu")
    p32 = plan_spmv(_rounded(m), dtype=torch.float32, device="cpu")
    assert p16.strategy == p32.strategy
    B = torch.from_numpy(np.random.default_rng(2).random((256, 3)).astype(
        np.float32))
    r16, r32 = (cg_multi(p, B, tol=1e-6, maxiter=500) for p in (p16, p32))
    assert bool(r16.converged.all()) and r16.x.dtype == torch.float32
    assert p16.strategy == "dia_stream"
    assert r16.iterations == r32.iterations
    assert rel(r16.x, r32.x.numpy()) <= 1e-6
    assert main(["--synthetic", "laplacian:64", "--auto", "--dtype",
                 "bfloat16", "--spmm", "4", "--dist", "2", "--solve", "cg",
                 "--solve-nrhs", "3", "--formats", "csr", "--device", "cpu",
                 "--iters", "2"]) == 0
    out = capsys.readouterr().out
    for line in ("### PSDIA SPMM4 GFLOPS =", "### CSR SPMM4 GFLOPS =",
                 "DIST2: strategy=pdia_stream |", "CG x3 (pdia_stream):"):
        assert line in out, line
    assert "converged=True" in out
