"""The host-layer names the port adds, against the JAX reference's on the
same inputs: ``read_dense`` / ``write_dense``, ``read_matrix(sort=)``,
``COO.from_dense``, ``CSR.row_lengths``, ``CSC.from_arrays`` /
``from_scipy`` / ``todense`` / ``astype``, ``DIA.astype`` (bf16 rounding
once) and the ``nrow`` / ``ncol`` properties."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import utils
from tpu_spmv.io import mmio as jmm
from tpu_spmv_torch.io import mmio as tmm

torch.set_num_threads(1)


def test_dense_io_matches_reference(tmp_path):
    """write_dense writes the reference's text (tensors too); read_dense
    reads plain vectors and array .mtx as the reference does, and raises
    its error on a short file."""
    v = np.random.default_rng(0).standard_normal(17)
    ours, ref = tmp_path / "t.txt", tmp_path / "j.txt"
    tmm.write_dense(ours, torch.from_numpy(v))
    jmm.write_dense(ref, v)
    assert ours.read_text() == ref.read_text()
    np.testing.assert_array_equal(tmm.read_dense(ours), jmm.read_dense(ref))
    np.testing.assert_array_equal(tmm.read_dense(ours), v)
    arr = ("%%MatrixMarket matrix array real general\n3 2\n"
           "1\n2\n3\n4\n5\n6\n")
    np.testing.assert_array_equal(tmm.read_dense(io.StringIO(arr)),
                                  jmm.read_dense(io.StringIO(arr)))
    col = "%%MatrixMarket matrix array real general\n3 1\n1\n2\n3\n"
    assert tmm.read_dense(io.StringIO(col)).shape == (3,)
    for mod in (tmm, jmm):
        with pytest.raises(ValueError, match="declares 4 values, has 3"):
            mod.read_dense(io.StringIO("4\n1\n2\n3\n"))


def test_read_matrix_sort_matches_reference():
    """read_matrix keeps the file's order with sort=False and sorts by
    (row, col) by default, as the reference."""
    text = ("%%MatrixMarket matrix coordinate real general\n3 3 4\n"
            "3 1 4.0\n1 2 1.5\n2 2 -2.0\n1 1 3.0\n")
    for sort in (False, True):
        t = tmm.read_matrix(io.StringIO(text), sort=sort)
        j = jmm.read_matrix(io.StringIO(text), sort=sort)
        assert t.rows_sorted == j.rows_sorted == sort
        for f in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


def test_format_names_match_reference():
    """COO.from_dense, CSR.row_lengths, CSC.from_arrays / from_scipy /
    todense and nrow / ncol against the reference's."""
    m = utils.random_sparse(40, 30, 0.1, seed=4).tocsr()
    dense = m.toarray()
    t, j = tt.COO.from_dense(dense), ts.COO.from_dense(dense)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    csr_t = tt.CSR.from_scipy(m)
    csr_j = ts.CSR.from_scipy(m, dtype=jnp.float64)
    np.testing.assert_array_equal(csr_t.row_lengths(), csr_j.row_lengths())
    c = m.tocsc()
    for build_t, build_j in (
            (lambda: tt.CSC.from_arrays(c.data, c.indices, c.indptr, c.shape),
             lambda: ts.CSC.from_arrays(c.data, c.indices, c.indptr,
                                        c.shape, dtype=jnp.float64)),
            (lambda: tt.CSC.from_scipy(m), lambda: ts.CSC.from_scipy(
                m, dtype=jnp.float64))):
        ct, cj = build_t(), build_j()
        for f in ("data", "indices", "indptr", "col_ids"):
            np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                          np.asarray(getattr(cj, f)))
        np.testing.assert_array_equal(ct.todense().numpy(),
                                      np.asarray(cj.todense()))
        x = torch.ones(30, dtype=torch.float64)
        assert torch.equal(tt.spmv(ct, x), tt.spmv(csr_t, x))
    with pytest.raises(ValueError, match=r"indptr must have shape \(31,\)"):
        tt.CSC.from_arrays(c.data, c.indices, c.indptr[:-1], c.shape)
    dia_t = tt.convert(tt.COO.from_scipy(m), "dia")
    for A in (t, csr_t, ct, dia_t):
        assert (A.nrow, A.ncol) == (40, 30)


def test_astype_rounds_once_like_the_reference():
    """CSC.astype and DIA.astype to bfloat16 round each value once (the
    reference's bits, from float32 values), keep the pattern, and back to
    float32 exactly; the products of the bf16 formats sum in float32."""
    m = utils.banded(200, 3, seed=5).astype(np.float32).tocsr()
    ct = tt.CSC.from_scipy(m).astype(torch.bfloat16)
    cj = ts.CSC.from_scipy(m, dtype=jnp.float32).astype(jnp.bfloat16)
    dt = tt.convert(tt.COO.from_scipy(m), "dia").astype(torch.bfloat16)
    dj = ts.convert(ts.COO.from_scipy(m.tocoo(), dtype=jnp.float32),
                    "dia").astype(jnp.bfloat16)
    for t, j in ((ct, cj), (dt, dj)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.data.view(torch.int16).numpy(),
                                      np.asarray(j.data).view(np.int16))
        x = torch.rand(200, generator=torch.Generator().manual_seed(0))
        y = tt.spmv(t, x)
        assert y.dtype == torch.float32
        back = t.astype(torch.float32)
        assert torch.equal(back.data, t.data.float())
    assert dt.offsets == dj.offsets and dt.nnz == dj.nnz
    np.testing.assert_array_equal(ct.indices.numpy(), np.asarray(cj.indices))
