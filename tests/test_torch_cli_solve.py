"""Port CLI ``--solve`` choices beyond CG on the CPU (``--device cpu``,
``--json``): each on the 16 x 16 Poisson through the planner's PSDIA plan,
to a relative residual of 1e-5 in float32 (the analytic spectrum ends for
power and Lanczos, within 1e-3)."""

import json

import numpy as np
import pytest
import torch

from tpu_spmv_torch.cli import SOLVERS, main

torch.set_num_threads(1)

G = 16
LMAX = 8 * np.sin(np.pi * G / (2 * (G + 1))) ** 2
LMIN = 8 * np.sin(np.pi / (2 * (G + 1))) ** 2


def _run(capsys, *extra) -> dict:
    assert main(["--synthetic", f"laplacian:{G}", "--auto", "--device", "cpu",
                 "--json", "--iters", "2", "--tol", "1e-5", *extra]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("solver", [s for s in SOLVERS
                                    if s not in ("cg", "pcg")])
def test_solve_choice(capsys, solver):
    line = _run(capsys, "--solve", solver)
    assert line["solver"] == solver and line["strategy"] == "pdia_stream"
    if solver == "power":
        assert abs(line["eigenvalue"] - LMAX) <= 1e-3 * LMAX
    elif solver == "lanczos":
        assert abs(line["eigenvalue_max"] - LMAX) <= 1e-3 * LMAX
        assert abs(line["eigenvalue_min"] - LMIN) <= 1e-3 * LMAX
    else:
        assert line["converged"] and line["rel_residual"] <= 1e-5
        assert line["iterations"] >= 1


def test_inner_iters_and_mgpcg_scope(capsys):
    """--inner-iters sets the bf16 inner-CG steps of --solve ir (fewer
    steps, more refinement cycles); --solve mgpcg needs a grid synthetic."""
    many = _run(capsys, "--solve", "ir", "--inner-iters", "100")
    few = _run(capsys, "--solve", "ir", "--inner-iters", "3")
    assert few["converged"] and few["iterations"] > many["iterations"]
    with pytest.raises(SystemExit, match="grid operator"):
        main(["--synthetic", "banded:3000,5", "--auto", "--device", "cpu",
              "--iters", "2", "--solve", "mgpcg"])
