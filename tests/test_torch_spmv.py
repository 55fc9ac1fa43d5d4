"""Port SpMV arms (COO, CSR, DIA) and BLAS-1 against the JAX reference
package, plus determinism and the single-chip entry point's product."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import utils

torch.set_num_threads(1)

#: rel = max|y - ref| / max|ref| limits between the two packages
TOL = {"float32": 1e-6, "float64": 1e-13}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_spmv_matches_reference(fmt, dname):
    tdt, jdt = DTYPES[dname]
    m = utils.random_sparse(150, 120, 0.05, seed=7)   # rectangular
    rng = np.random.default_rng(7)
    x = rng.standard_normal(120).astype(dname)
    y0 = rng.standard_normal(150).astype(dname)
    A_j = ts.convert(ts.COO.from_scipy(m, dtype=jdt), fmt)
    A_t = tt.convert(tt.COO.from_scipy(m, dtype=tdt), fmt)
    ref = ts.spmv(A_j, jnp.asarray(x))
    ref_acc = ts.spmv(A_j, jnp.asarray(x), jnp.asarray(y0))
    got = tt.spmv(A_t, torch.from_numpy(x))
    got_acc = tt.spmv(A_t, torch.from_numpy(x), torch.from_numpy(y0))
    assert got.dtype == tdt and got.shape == (150,)
    assert _rel(got, ref) <= TOL[dname]
    assert _rel(got_acc, ref_acc) <= TOL[dname]


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_spmv_deterministic(fmt):
    m = utils.random_sparse(200, 200, 0.05, seed=41)
    A = tt.convert(tt.COO.from_scipy(m, dtype=torch.float64), fmt)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(200))
    assert torch.equal(tt.spmv(A, x), tt.spmv(A, x))


def test_unsorted_coo_and_empty_rows():
    dense = np.zeros((6, 5))
    dense[0, 1] = 2.0
    dense[4, 3] = -1.5
    row, col = np.nonzero(dense)
    A = tt.COO.from_arrays(row[::-1], col[::-1], dense[row, col][::-1],
                           (6, 5), dtype=torch.float64, sort=False)
    x = torch.arange(1.0, 6.0, dtype=torch.float64)
    np.testing.assert_array_equal(tt.spmv(A, x).numpy(), dense @ x.numpy())


def test_entry_analogue_csr_laplacian64():
    """The reference's single-chip entry point: CSR SpMV on the 64x64-grid
    Poisson in float32 — the port's product against the JAX one."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).resolve().parent.parent /
        "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, (csr_j, x_j) = mod.entry()
    ref = fn(csr_j, x_j)
    csr = tt.convert(tt.COO.from_scipy(utils.laplacian_2d(64),
                                       dtype=torch.float32), "csr")
    x = torch.tensor(np.asarray(x_j))
    np.testing.assert_array_equal(x.numpy(), np.random.default_rng(0).random(
        csr.shape[1]).astype(np.float32))
    y = tt.ops.spmv_csr(csr, x)
    assert y.dtype == torch.float32
    assert _rel(y, ref) <= TOL["float32"]


def test_blas1_matches_reference():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(64), rng.standard_normal(64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (tt.dot(ta, tb), ts.dot(ja, jb)),
        (tt.axpby(0.5, ta, -2.0, tb), ts.axpby(0.5, ja, -2.0, jb)),
        (tt.axpy(3.0, ta, tb), ts.axpy(3.0, ja, jb)),
        (tt.ops.add2scaled(ta, 2.0, tb, -1.0, ta),
         ts.ops.add2scaled(ja, 2.0, jb, -1.0, ja)),
        (tt.scale(ta, 1.5), ts.scale(ja, 1.5)),
        (tt.shift(ta, 0.25), ts.shift(ja, 0.25)),
        (tt.norm2(ta), ts.norm2(ja)),
    ]
    for got, ref in pairs:
        assert _rel(got, ref) <= TOL["float64"]
    assert tt.check_vector(ta, ta + 1e-7) and not tt.check_vector(ta, ta + 1)
    assert tt.allclose(ta, ta * (1 + 1e-12))
    assert tt.fill(3, 2.0).tolist() == [2.0, 2.0, 2.0]
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    r = tt.fill_random(g1, 8)
    assert torch.equal(r, tt.fill_random(g2, 8))
    assert bool(((r >= 0) & (r < 1)).all())
