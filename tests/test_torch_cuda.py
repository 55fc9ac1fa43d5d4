"""Tests of the port that need a CUDA card (the CUDA kernels have no CPU
mode).  Each skips without a card.  The file imports no JAX, so it also
runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_spmv_torch import COO, convert, spmv, utils
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.ops.auto import plan_spmv

torch.set_num_threads(1)

#: kernel against plain version: same summation order, FMA rounding may
#: differ in the last bits
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(y, ref) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(card, dtype):
    """K1 and K2 against their plain versions: within the limits, bitwise
    reproducible, pads zero, each launch counted."""
    m = utils.laplacian_2d(32)
    dia = convert(COO.from_scipy(m, dtype=dtype, device=card), "dia")
    x = torch.tensor(np.random.default_rng(2).random(m.shape[0]),
                     dtype=dtype, device=card)
    for A, kern, plain, key in (
            (tds.pack_sdia(dia), tds.spmv_sdia_padded,
             tds.spmv_sdia_padded_ref, "sdia"),
            (tds.pack_psdia(dia, period=32), tds.spmv_psdia_padded,
             tds.spmv_psdia_padded_ref, "psdia")):
        before = tds.LAUNCHES[key]
        xp = tds.pad_x(A, x)
        y1, y2 = kern(A, xp), kern(A, xp)
        assert tds.LAUNCHES[key] == before + 2
        assert torch.equal(y1, y2)
        assert bool((y1[:A.L] == 0).all() and (y1[A.L + m.shape[0]:] == 0).all())
        assert _rel(y1, plain(A, xp)) <= TOL[dtype]


@pytest.mark.cuda
def test_plan_and_csr_on_card(card):
    """The planner's pick runs K2 on the card and matches scipy; CSR SpMV
    on the card is bitwise reproducible (no atomics)."""
    m = utils.laplacian_2d(64)
    plan = plan_spmv(m, dtype=torch.float32, device=card)
    assert plan.strategy == "pdia_stream"
    x64 = np.random.default_rng(3).random(m.shape[0])
    before = tds.LAUNCHES["psdia"]
    y = plan(torch.tensor(x64, dtype=torch.float32, device=card))
    assert tds.LAUNCHES["psdia"] == before + 1
    ref = m @ x64
    assert np.max(np.abs(y.cpu().double().numpy() - ref)) <= \
        2e-5 * np.max(np.abs(ref))
    csr = convert(COO.from_scipy(utils.random_sparse(500, 500, 0.05),
                                 dtype=torch.float32, device=card), "csr")
    xr = torch.rand(500, device=card)
    assert torch.equal(spmv(csr, xr), spmv(csr, xr))
