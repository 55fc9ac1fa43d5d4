"""Checkpoints of the port's packs: SDIA and PSDIA (float32 and bf16
data), GPCSR with hub rows, PackedELL (with a side COO, bf16) and a two-pass
PermutationPlan round-trip field for field, and each reloaded plan's
product is bitwise the original's (the state the kernels derive at first
use is keyed by the pack's static fields, so it is rebuilt alike)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_spmv import utils
from tpu_spmv_torch.io import checkpoint as ck
from tpu_spmv_torch.kernels import ell_packed as tell
from tpu_spmv_torch.kernels import permute as tp
from tpu_spmv_torch.ops.auto import plan_from_matrix, plan_spmv

from test_torch_checkpoint import assert_same

torch.set_num_threads(1)


def _shuffled_poisson(g):
    m = utils.laplacian_2d(g)
    perm = np.random.default_rng(3).permutation(m.shape[0])
    return m[perm][:, perm].tocsr()


def _screened(g):
    m = utils.laplacian_2d(g)
    return (m + sp.identity(m.shape[0])).tocsr()


#: case -> (matrix, dtype, the strategy it plans to)
PLANS = {
    "psdia bf16": (lambda: _screened(24), torch.bfloat16, "pdia_stream"),
    "sdia f32": (lambda: utils.banded(3000, 5, seed=2), torch.float32,
                 "dia_stream"),
    "sdia bf16": (lambda: utils.banded(3000, 5, seed=2), torch.bfloat16,
                  "dia_stream"),
    "gpr bf16": (lambda: utils.power_law(3000, 3000, 8, seed=1),
                 torch.bfloat16, "gpr"),
    "pallas_ell f32": (lambda: _shuffled_poisson(40), torch.float32,
                       "pallas_ell"),
}


@pytest.mark.parametrize("case", PLANS)
def test_plan_roundtrip(tmp_path, case):
    """A planned pack saved with its strategy reloads into a plan whose
    product is bitwise the original's."""
    make, dtype, strategy = PLANS[case]
    m = make()
    plan = plan_spmv(m, dtype=dtype, device="cpu")
    assert plan.strategy == strategy
    f = tmp_path / "plan.npz"
    ck.save_matrix(f, plan.matrix, extra={"strategy": plan.strategy})
    A, extra = ck.load_matrix(f, with_extra=True, device="cpu")
    assert_same(plan.matrix, A)
    if strategy == "gpr":
        assert A.nv > 0
    x = torch.from_numpy(np.random.default_rng(1).random(m.shape[1]).astype(
        np.float32))
    again = plan_from_matrix(A, extra["strategy"])
    assert torch.equal(plan(x), again(x))
    if strategy == "pallas_ell":
        # sliced ELL forced on hub rows: bf16 slots and a side COO
        m = utils.power_law(2000, 2000, 8, seed=3)
        E = tell.pack_ell(m, dtype=torch.bfloat16, device="cpu")
        assert E.side.nnz > 0
        ck.save_matrix(f, E)
        back = ck.load_matrix(f, device="cpu")
        assert_same(E, back)
        x = torch.rand(2000, generator=torch.Generator().manual_seed(2))
        assert torch.equal(tell.spmv_ell_packed(E, x),
                           tell.spmv_ell_packed(back, x))


def test_permutation_plan_roundtrip(tmp_path):
    """A two-pass PermutationPlan (its offset and bucket tables) and a
    direct one round-trip; the reloaded plans gather the same bits."""
    perm = np.random.default_rng(5).permutation(5000)
    x = torch.from_numpy(np.random.default_rng(6).random(5000))
    for plan in (tp._plan(perm, "cpu", "two_pass", 256),
                 tp.plan_permutation(perm, device="cpu")):
        ck.save_matrix(tmp_path / "p.npz", plan)
        back = ck.load_matrix(tmp_path / "p.npz", device="cpu")
        assert_same(plan, back)
        assert torch.equal(tp.apply_permutation(back, x), x[perm])
    assert back.method == "direct" and back.src_off is None
