"""Port bench harness and roofline on the CPU: the oracle gates, the timing
protocol's control flow and the byte model against the reference's."""

import jax.numpy as jnp
import pytest
import torch

import tpu_spmv as ts
import tpu_spmv_torch as tt
from tpu_spmv import utils
from tpu_spmv.bench.roofline import spmv_bytes as ref_bytes
from tpu_spmv_torch.bench import (bench_spmv, format_name, measured_copy_gbps,
                                  roofline, spmv_bytes, time_chained, time_fn,
                                  verify_against_oracle)

torch.set_num_threads(1)


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_spmv_bytes_match_reference(fmt):
    m = utils.random_sparse(90, 70, 0.1, seed=2)
    A = tt.convert(tt.COO.from_scipy(m, dtype=torch.float32), fmt)
    A_j = ts.convert(ts.COO.from_scipy(m, dtype=jnp.float32), fmt)
    assert spmv_bytes(A) == ref_bytes(A_j)
    assert format_name(A) == fmt.upper()


def test_oracle_gates_and_timing_protocol():
    m = utils.laplacian_2d(8)
    A = tt.convert(tt.COO.from_scipy(m, dtype=torch.float64), "csr")
    x = torch.rand(64, dtype=torch.float64)
    y = tt.spmv(A, x)
    assert verify_against_oracle(A, x, y) <= 1e-15
    with pytest.raises(AssertionError, match="rel err"):
        verify_against_oracle(A, x, y * (1 + 1e-9))       # f64 gate 1e-10
    y32 = tt.spmv(A.astype(torch.float32), x.float())
    verify_against_oracle(A, x.float(), y32 * (1 + 1e-5))  # f32 gate 2e-5
    t = time_chained(lambda v: tt.spmv(A, v) / 8, x, iters=3, repeats=2)
    assert t.iters == 3 and 0 < t.best_s <= t.median_s
    assert time_fn(tt.spmv, A, x, iters=2, repeats=2).median_s > 0
    rec = bench_spmv(A, x, mode="CPU", iters=2, quiet=True)
    assert rec["format"] == "CSR" and rec["roofline_fraction"] is None
    rf = roofline(A, 1e-3, peak_gbps=100.0)
    assert rf.flops == 2 * A.nnz and rf.fraction == rf.bw_gbps / 100.0
    with pytest.raises(ValueError, match="CUDA"):
        measured_copy_gbps("cpu")
