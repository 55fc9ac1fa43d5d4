"""Port ``predict_dist_costs``, the distributed planner's general-CSR
fallback and ``bench/dist_bench.py`` against the JAX reference's.

The cost model's counts and formulas are the reference's, so with the
reference's constants passed explicitly every key and the pick are equal
(``laplacian_2d(16)``, ``random_sparse(200, 200, 0.05)`` and a
rectangular matrix at 1, 3, 4 and 8 shards, both balances, square or
not).  The port's own defaults are the H100's (``GATHER_GVALS``,
``LINK_GBPS``).  The benchmark runs in process on the CPU at a 16^2 grid.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from tpu_spmv import dist as jdist
from tpu_spmv import utils
from tpu_spmv.dist import planned as jplanned
from tpu_spmv_torch import COO, convert
from tpu_spmv_torch import dist as tdist
from tpu_spmv_torch.bench import dist_bench
from tpu_spmv_torch.dist import planned as tplanned

#: the reference's constants (its TPU numbers), passed explicitly
REF_CONSTANTS = {"link_gbps": jplanned.LINK_GBPS,
                 "gather_gvals": jplanned.GATHER_GVALS}
OPERANDS = {"laplacian_2d(16)": lambda: utils.laplacian_2d(16),
            "random_sparse(200,200,0.05)":
            lambda: utils.random_sparse(200, 200, 0.05, seed=2),
            "random_sparse(150,230,0.04)":
            lambda: utils.random_sparse(150, 230, 0.04, seed=4)}


@pytest.mark.parametrize("name", OPERANDS)
def test_predict_dist_costs_matches_reference(name):
    m = OPERANDS[name]().tocsr()
    for ndev in (1, 3, 4, 8):
        for balance in ("nnz", "rows"):
            for square in (True, False):
                kw = {"balance": balance, "square": square, **REF_CONSTANTS}
                got = tdist.predict_dist_costs(m, ndev, **kw)
                assert got == jdist.predict_dist_costs(m, ndev, **kw), (
                    ndev, balance, square)
                assert got["pick"] in ("csr_neighbor", "csr_allgather",
                                       "csr_halo")


def test_cost_model_defaults_and_fallback():
    """The defaults are the measured H100 constants (not the reference's),
    a port CSR gives the scipy matrix's counts, and the planner's
    fallback on an empty square matrix takes the model's pick, as the
    reference's does."""
    assert tplanned.GATHER_GVALS > 0 and tplanned.LINK_GBPS > 0
    assert (tplanned.GATHER_GVALS, tplanned.LINK_GBPS) != \
        (jplanned.GATHER_GVALS, jplanned.LINK_GBPS)
    m = utils.laplacian_2d(16).tocsr()
    assert tdist.predict_dist_costs(convert(COO.from_scipy(m), "csr"), 4) \
        == tdist.predict_dist_costs(m, 4)
    empty = sp.csr_matrix((40, 40))
    plan = tdist.plan_dist_spmv(empty, tdist.make_mesh(4, device="cpu"))
    assert plan.strategy == jdist.plan_dist_spmv(empty, 4).strategy
    assert plan.strategy == tdist.predict_dist_costs(
        empty, 4, square=True)["pick"]


def test_dist_bench_single_point_json(capsys):
    """One point a strategy at 2 shards on the CPU: the reference's keys,
    the products checked against scipy, the model's prediction beside."""
    assert dist_bench.main(["--grid", "16", "--ndev", "2", "--device",
                            "cpu", "--json"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["strategy"] for ln in lines] == dist_bench.STRATS
    costs = tdist.predict_dist_costs(
        utils.laplacian_2d(16).astype(np.float32), 2, square=True)
    for ln in lines:
        assert set(ln) == {"strategy", "ndev", "grid", "n", "nnz",
                           "us_per_spmv", "gnnz_per_s", "gflops", "rel_err",
                           "model_predicted_us"}
        assert (ln["ndev"], ln["grid"], ln["n"], ln["nnz"]) == \
            (2, 16, 256, utils.laplacian_2d(16).nnz)
        assert ln["rel_err"] < 2e-5 and ln["us_per_spmv"] > 0
        assert ln["model_predicted_us"] == \
            costs["csr_" + ln["strategy"]]["predicted_us"]
