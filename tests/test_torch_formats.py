"""Port formats and MatrixMarket I/O against the JAX reference package:
the same scipy operand gives the same arrays, offsets and file contents."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import utils

torch.set_num_threads(1)

MATS = {
    "laplacian_2d(8)": lambda: utils.laplacian_2d(8),
    "banded(200,3)": lambda: utils.banded(200, 3),
    "random_sparse(300,300,.02)": lambda: utils.random_sparse(300, 300, .02),
}
FIXTURES = Path(__file__).parent / "fixtures"


def _same_fields(ref, got):
    for f in dataclasses.fields(got):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f.name)
        else:
            assert g == r, f.name


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
@pytest.mark.parametrize("name", MATS)
def test_convert_matches_reference_and_round_trips(name, fmt):
    m = MATS[name]()
    ref = ts.convert(ts.COO.from_scipy(m, dtype=jnp.float64), fmt)
    got = tt.convert(tt.COO.from_scipy(m, dtype=torch.float64), fmt)
    _same_fields(ref, got)
    back = tt.to_coo(got).to_scipy().tocsr()
    assert back.shape == m.shape
    assert abs(back - m).max() == 0 and back.nnz == m.nnz


def test_dia_host_arrays_sum_duplicates_like_reference():
    rng = np.random.default_rng(3)
    row = rng.integers(0, 40, 300)
    col = rng.integers(0, 50, 300)           # duplicates and a wide band
    val = rng.standard_normal(300)
    ref_data, ref_offs = ts.DIA.host_arrays(
        ts.COO.from_arrays(row, col, val, (40, 50), sort=False))
    coo = tt.COO.from_arrays(row, col, val, (40, 50), dtype=torch.float64,
                             sort=False)
    data, offs = tt.DIA.host_arrays(coo)
    assert offs == ref_offs and list(offs) == sorted(offs)
    np.testing.assert_allclose(data, ref_data, rtol=1e-15, atol=1e-15)
    dense = np.zeros((40, 50))
    np.add.at(dense, (row, col), val)
    np.testing.assert_allclose(tt.convert(coo, "dia").todense().numpy(),
                               dense, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("fixture", ["bus420.mtx", "bus420_pattern.mtx"])
def test_read_mtx_matches_reference(fixture):
    path = FIXTURES / fixture
    ref = ts.io.read_mtx_arrays(path)
    got = tt.io.read_mtx_arrays(path)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3]
    A = tt.read_matrix(path, dtype=torch.float64)
    _same_fields(ts.read_matrix(path, dtype=jnp.float64), A)


def test_write_read_round_trip(tmp_path):
    m = utils.random_sparse(60, 45, 0.1, seed=4)
    path = tmp_path / "m.mtx"
    tt.write_matrix(path, tt.COO.from_scipy(m, dtype=torch.float64))
    back = tt.read_matrix(path, dtype=torch.float64).to_scipy().tocsr()
    assert abs(back - m).max() == 0
    # the reference reads the port's file to the same matrix
    assert abs(ts.read_matrix(path).to_scipy().tocsr() - m).max() == 0
    # symmetric storage expands to both triangles
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "2 2 2\n1 1 2.0\n2 1 -1.0\n")
    np.testing.assert_array_equal(tt.read_matrix(path).todense().numpy(),
                                  [[2.0, -1.0], [-1.0, 0.0]])
