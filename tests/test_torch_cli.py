"""Port CLI on the CPU (``--device cpu``): planner and sweep protocol
lines, SpMM, CG through the planner (one or several right-hand sides),
clean errors, and no JAX at import."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_spmv_torch as tt
from tpu_spmv_torch import utils
from tpu_spmv_torch.cli import main

torch.set_num_threads(1)


def test_cli_auto_psdia(capsys):
    assert main(["--synthetic", "laplacian:32", "--auto", "--device", "cpu",
                 "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "planner: strategy=pdia_stream" in out
    assert "### PSDIA CPU-AUTO GFLOPS =" in out


def test_cli_auto_general_arm(tmp_path, capsys):
    """--synthetic powerlaw plans to GPR; a 2-D Poisson in a shuffled node
    order (equal row lengths, scattered columns) plans to sliced ELL."""
    assert main(["--synthetic", "powerlaw:3000,20", "--auto", "--device",
                 "cpu", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "planner: strategy=gpr" in out
    assert "### GPR CPU-AUTO GFLOPS =" in out
    lap = utils.laplacian_2d(20)
    p = np.random.default_rng(0).permutation(lap.shape[0])
    path = tmp_path / "shuffled.mtx"
    tt.write_matrix(path, lap[p][:, p].tocsr())
    assert main([str(path), "--auto", "--device", "cpu", "--iters", "2",
                 "--solve", "cg", "--tol", "1e-8"]) == 0
    out = capsys.readouterr().out
    assert "planner: strategy=pallas_ell" in out
    assert "### PALLAS_ELL CPU-AUTO GFLOPS =" in out
    assert "CG (pallas_ell)" in out and "converged=True" in out


def test_cli_spmm_and_multi_rhs_solve(capsys):
    """--spmm runs the plan's SpMM and the sweep's ops/spmm; --solve cg
    --solve-nrhs K runs cg_multi through the plan."""
    assert main(["--synthetic", "laplacian:24", "--auto", "--device", "cpu",
                 "--formats", "csr", "--iters", "5", "--spmm", "3",
                 "--solve", "cg", "--solve-nrhs", "4", "--tol", "1e-8"]) == 0
    out = capsys.readouterr().out
    assert "### PSDIA SPMM3 GFLOPS =" in out
    assert "### CSR SPMM3 GFLOPS =" in out
    assert "PSDIA SPMM3:" in out and "rel_err=" in out
    assert "CG x4 (pdia_stream):" in out and "converged=True" in out
    assert main(["--synthetic", "powerlaw:2000,12", "--auto", "--device",
                 "cpu", "--formats", "coo", "--iters", "5", "--spmm", "2",
                 "--json"]) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    spmm = [r for r in recs if r["mode"] == "SPMM2"]
    assert [r["format"] for r in spmm] == ["GPR", "COO"]
    assert all(r["rel_err"] <= 2e-5 for r in spmm)


@pytest.mark.parametrize("solver", ["cg", "pcg"])
def test_cli_solve_json(capsys, solver):
    assert main(["--synthetic", "laplacian:12", "--device", "cpu",
                 "--formats", "csr", "--iters", "2", "--solve", solver,
                 "--tol", "1e-6", "--json"]) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    solve = [r for r in recs if r.get("solver") == solver]
    assert solve and solve[0]["converged"]
    assert solve[0]["rel_residual"] < 1e-5
    assert solve[0]["strategy"] == "pdia_stream"


def test_cli_file_sweep_float64(tmp_path, capsys):
    path = tmp_path / "m.mtx"
    tt.write_matrix(path, utils.laplacian_2d(6, 5))
    assert main([str(path), "--formats", "coo,csr,dia", "--device", "cpu",
                 "--iters", "2", "--dtype", "float64", "--json"]) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    assert [r["format"] for r in recs] == ["COO", "CSR", "DIA"]
    assert all(r["mode"] == "CPU" and r["rel_err"] <= 1e-10
               and r["roofline_fraction"] is None for r in recs)


@pytest.mark.parametrize("argv,match", [
    (["--synthetic", "laplacian:4", "--formats", "bogus"], "unknown format"),
    (["/does/not/exist.mtx"], "not found"),
    (["--synthetic", "bogus:1"], "unknown synthetic"),
])
def test_cli_clean_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--device", "cpu"])


def test_cli_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--synthetic", "laplacian:4"])


def test_cli_drops_explosive_dia():
    import scipy.sparse as sp

    from tpu_spmv_torch.cli import _drop_explosive_formats

    n = 200_000
    hub = sp.coo_matrix((np.ones(50_000), (np.zeros(50_000, np.int64),
                                           np.arange(50_000))), shape=(n, n))
    assert _drop_explosive_formats(["csr", "dia", "coo"], hub, 8) == \
        ["csr", "coo"]
    band = utils.banded(500, 3).tocoo()
    assert _drop_explosive_formats(["dia"], band, 8) == ["dia"]


def test_import_leaves_jax_out():
    code = ("import sys, tpu_spmv_torch, tpu_spmv_torch.cli, "
            "tpu_spmv_torch.ops.spmm, tpu_spmv_torch.solvers.block_cg, "
            "tpu_spmv_torch.dist, tpu_spmv_torch.solvers.dist_cg, "
            "tpu_spmv_torch.dist.dryrun; "
            "assert 'jax' not in sys.modules; "
            "assert 'tpu_spmv' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
