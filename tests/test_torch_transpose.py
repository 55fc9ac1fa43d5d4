"""Port operator transforms against the JAX package: transpose (COO, CSR,
CSC, DIA and the streaming packs), ``SpmvPlan.transpose``, the CSC format
and ``shift_diagonal``.

Float64 products agree to rel 1e-13 (the same entries summed per row; the
reference's CSC sum is an unsorted segment sum, the port's a row-owned one).
Transposed and shifted packs are data movement and one add, so they equal
the reference's field for field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv.ops import spmv as jspmv
from tpu_spmv.ops import transpose as jtranspose
from tpu_spmv.ops.auto import plan_spmv as jplan_spmv
from tpu_spmv.ops.shift import shift_diagonal as jshift
from tpu_spmv_torch import COO, convert, spmv
from tpu_spmv_torch.formats import CSC
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import ell_packed, gpr
from tpu_spmv_torch.ops import shift_diagonal, spmm, transpose
from tpu_spmv_torch.ops.auto import plan_spmv

torch.set_num_threads(1)

TOL = 1e-13
RB = 256


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture(scope="module")
def rect():
    return utils.random_sparse(120, 80, 0.08, seed=5).tocsr()


def _band_dia():
    return sp.diags([np.arange(1, 91.0), -np.ones(89), 2 * np.ones(85)],
                    [0, 1, -5]).tocsr()


def _periodic():
    """A non-symmetric periodic stencil: the 16x16-grid Poisson with each
    diagonal scaled by a factor of its offset (period 16)."""
    m = utils.laplacian_2d(16).tocoo()
    return sp.csr_matrix((m.data * (1.0 + 0.1 * (m.col - m.row)),
                          (m.row, m.col)), shape=m.shape)


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "dia"])
def test_transpose_matches_reference(fmt, rect):
    m = rect if fmt != "dia" else _band_dia()
    Aj = ts.convert(ts.COO.from_scipy(m.tocoo()), fmt)
    At = transpose(convert(COO.from_scipy(m, dtype=torch.float64), fmt))
    assert At.shape == (m.shape[1], m.shape[0])
    x = np.random.default_rng(3).random(m.shape[0])
    y = spmv(At, torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(jspmv(jtranspose(Aj), jnp.asarray(x)))) <= TOL
    assert _rel(y, m.T @ x) <= TOL
    X = np.random.default_rng(4).random((m.shape[0], 3))
    assert _rel(spmm(At, torch.from_numpy(X)).numpy(), m.T @ X) <= TOL


def test_csr_csc_share_arrays(rect):
    A = convert(COO.from_scipy(rect, dtype=torch.float64), "csr")
    At = transpose(A)
    assert isinstance(At, CSC)
    for a, b in ((At.data, A.data), (At.indices, A.indices),
                 (At.indptr, A.indptr), (At.col_ids, A.row_ids)):
        assert a.data_ptr() == b.data_ptr()
    Att = transpose(At)
    assert type(Att) is type(A) and Att.shape == A.shape
    assert torch.equal(Att.data, A.data)


def test_csc_is_row_owned(rect):
    """CSC SpMV sums each row in column order: bitwise CSR's, and equal
    to the reference's CSC carried over."""
    csr = convert(COO.from_scipy(rect, dtype=torch.float64), "csr")
    csc = convert(COO.from_scipy(rect, dtype=torch.float64), "csc")
    x = torch.from_numpy(np.random.default_rng(5).random(rect.shape[1]))
    assert torch.equal(spmv(csc, x), spmv(csr, x))
    jcsc = ts.convert(ts.COO.from_scipy(rect.tocoo()), "csc")
    carried = from_reference(jcsc, device="cpu")
    assert torch.equal(spmv(carried, x), spmv(csc, x))
    assert _rel(spmv(csc, x).numpy(),
                np.asarray(jspmv(jcsc, jnp.asarray(x.numpy())))) <= TOL
    assert (csc.to_scipy() != rect).nnz == 0
    assert (convert(csc, "coo").to_scipy() != rect).nnz == 0


@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_transposed_packs_equal_reference(kind):
    m = _band_dia() if kind == "sdia" else _periodic()
    dj = ts.convert(ts.COO.from_scipy(m.tocoo()), "dia")
    dt = convert(COO.from_scipy(m, dtype=torch.float64), "dia")
    if kind == "sdia":
        Pj, Pt = jds.pack_sdia(dj, rb=RB), tds.pack_sdia(dt, rb=RB)
        Tj, Tt = jds.transpose_sdia(Pj), tds.transpose_sdia(Pt)
        coef = "data"
    else:
        Pj, Pt = jds.pack_psdia(dj, period=16), tds.pack_psdia(dt, period=16)
        Tj, Tt = jds.transpose_psdia(Pj), tds.transpose_psdia(Pt)
        coef = "pattern"
    for f in dataclasses.fields(Tt):
        a, b = getattr(Tt, f.name), getattr(Tj, f.name)
        if f.name == coef:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a == (tuple(b) if isinstance(a, tuple) else b), f.name
    assert Tt.npad == Tj.npad
    x = np.random.default_rng(6).random(m.shape[0])
    y = (tds.spmv_sdia if kind == "sdia" else tds.spmv_psdia)(
        Tt, torch.from_numpy(x)).numpy()
    assert _rel(y, m.T @ x) <= TOL
    # transpose(transpose(A)) is A again
    T2 = transpose(Tt)
    assert T2.offsets == Pt.offsets
    assert torch.equal(getattr(T2, coef), getattr(Pt, coef))


def test_transpose_unsupported_raises(rect):
    for pack in (gpr.pack_gpr(rect, device="cpu"),
                 ell_packed.pack_ell(rect, device="cpu")):
        with pytest.raises(TypeError, match="convert"):
            transpose(pack)


def test_plan_transpose_matches_reference():
    n = 81
    m = sp.diags([np.arange(1.0, n + 1), -np.ones(n - 1),
                  2 * np.ones(n - 9)], [0, 1, -9]).tocsr()
    plan = plan_spmv(m, device="cpu")
    assert plan.strategy == "dia_stream"
    pt = plan.transpose()
    assert pt.strategy == "dia_stream"
    x = np.random.default_rng(11).random(n)
    y = pt(torch.from_numpy(x)).numpy()
    assert _rel(y, m.T @ x) <= TOL
    assert _rel(y, np.asarray(jplan_spmv(m).transpose()(jnp.asarray(x)))) \
        <= TOL
    csr_plan = dataclasses.replace(
        plan, matrix=convert(COO.from_scipy(m), "csr"), strategy="csr",
        _kernel=spmv)
    assert csr_plan.transpose().strategy == "csc"
    assert _rel(csr_plan.transpose()(torch.from_numpy(x)).numpy(),
                m.T @ x) <= TOL


def test_plan_transpose_unsupported():
    m = utils.random_sparse(600, 600, 0.01, seed=9)
    plan = plan_spmv(m, device="cpu")
    assert plan.strategy in ("gpr", "pallas_ell")
    with pytest.raises(TypeError, match="plan_spmv"):
        plan.transpose()


def _oracle(m, c, x):
    return (m.astype(np.float64) + c * sp.identity(m.shape[0])) @ x


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo"])
def test_shift_matches_reference(fmt):
    m = utils.laplacian_2d(12)
    Aj = jshift(ts.convert(ts.COO.from_scipy(m.tocoo()), fmt), 2.5)
    A = shift_diagonal(convert(COO.from_scipy(m, dtype=torch.float64), fmt),
                       2.5)
    assert type(A).__name__ == type(Aj).__name__
    np.testing.assert_array_equal(A.data.numpy(), np.asarray(Aj.data))
    x = np.random.default_rng(12).random(m.shape[0])
    y = spmv(A, torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(jspmv(Aj, jnp.asarray(x)))) <= TOL
    assert _rel(y, _oracle(m, 2.5, x)) <= TOL


@pytest.mark.parametrize("kind", ["dia", "sdia", "psdia"])
def test_shift_inserts_missing_diagonal(kind):
    """A strictly off-diagonal band gains a main diagonal, spliced in at
    its sorted offset, exactly as the reference's."""
    n = 256
    m = sp.diags([np.ones(n - 1), 2 * np.ones(n - 1)], [-1, 1]).tocsr()
    dj = ts.convert(ts.COO.from_scipy(m.tocoo()), "dia")
    dt = convert(COO.from_scipy(m, dtype=torch.float64), "dia")
    pack_j = {"dia": lambda d: d, "sdia": lambda d: jds.pack_sdia(d, rb=RB),
              "psdia": lambda d: jds.pack_psdia(d, period=1)}[kind]
    pack_t = {"dia": lambda d: d, "sdia": lambda d: tds.pack_sdia(d, rb=RB),
              "psdia": lambda d: tds.pack_psdia(d, period=1)}[kind]
    Aj, A = jshift(pack_j(dj), -1.5), shift_diagonal(pack_t(dt), -1.5)
    coef = "pattern" if kind == "psdia" else "data"
    assert A.offsets == tuple(Aj.offsets) == (-1, 0, 1)
    assert A.nnz == Aj.nnz
    np.testing.assert_array_equal(getattr(A, coef).numpy(),
                                  np.asarray(getattr(Aj, coef)))
    x = np.random.default_rng(13).random(n)
    kern = {"dia": spmv, "sdia": tds.spmv_sdia, "psdia": tds.spmv_psdia}[kind]
    assert _rel(kern(A, torch.from_numpy(x)).numpy(),
                _oracle(m, -1.5, x)) <= TOL


@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_shift_streaming_packs_match_reference(kind):
    m = utils.laplacian_2d(16)
    dj = ts.convert(ts.COO.from_scipy(m.tocoo()), "dia")
    dt = convert(COO.from_scipy(m, dtype=torch.float64), "dia")
    if kind == "sdia":
        Aj = jshift(jds.pack_sdia(dj, rb=RB), 3.0)
        A = shift_diagonal(tds.pack_sdia(dt, rb=RB), 3.0)
        coef, kern = "data", tds.spmv_sdia
        d0 = A.data[A.offsets.index(0)]
        # the pad rows stay structural zeros (the kernels rely on it)
        assert not d0[:A.L].any() and not d0[A.L + m.shape[0]:].any()
    else:
        Aj = jshift(jds.pack_psdia(dj, period=16), 3.0)
        A = shift_diagonal(tds.pack_psdia(dt, period=16), 3.0)
        coef, kern = "pattern", tds.spmv_psdia
    np.testing.assert_array_equal(getattr(A, coef).numpy(),
                                  np.asarray(getattr(Aj, coef)))
    x = np.random.default_rng(14).random(m.shape[0])
    assert _rel(kern(A, torch.from_numpy(x)).numpy(),
                _oracle(m, 3.0, x)) <= TOL


@pytest.mark.parametrize("case", ["missing", "duplicate", "rectangular",
                                  "packed"])
def test_shift_raises_as_reference(case, rect):
    n = 32
    if case == "missing":
        m = sp.diags([np.ones(n - 1)], [1]).tocsr()
    elif case == "duplicate":
        m = sp.coo_matrix((np.ones(n + 1), (np.r_[np.arange(n), 0],
                                            np.r_[np.arange(n), 0])),
                          shape=(n, n))
    else:
        m = rect if case == "rectangular" else utils.laplacian_2d(6)
    err = ValueError if case == "rectangular" else TypeError
    match = {"rectangular": "square", "packed": "no in-place"}.get(
        case, "diagonal entry per row")
    fmt = "coo" if case == "duplicate" else "csr"
    if case != "packed":
        with pytest.raises(err, match=match):
            jshift(ts.COO.from_scipy(m.tocoo()) if fmt == "coo" else
                   ts.convert(ts.COO.from_scipy(m.tocoo()), fmt), 1.0)
        A = convert(COO.from_arrays(m.tocoo().row, m.tocoo().col,
                                    m.tocoo().data, m.shape, sort=False), fmt)
    else:
        A = gpr.pack_gpr(m, device="cpu")
    with pytest.raises(err, match=match):
        shift_diagonal(A, 1.0)
