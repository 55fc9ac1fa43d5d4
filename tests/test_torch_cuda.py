"""Tests of the port that need a CUDA card (the CUDA kernels have no CPU
mode).  Each skips without a card.  The file imports no JAX, so it also
runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_spmv_torch import COO, convert, dist, spmv, utils
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import dist_stream as tdst
from tpu_spmv_torch.kernels import ell_packed as tell
from tpu_spmv_torch.kernels import gpr as tgpr
from tpu_spmv_torch.kernels import permute as tperm
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.reorder import reorder_plan

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_kernels_match_plain_on_card(card, dtype):
    """gpr_spmv and ell_spmv against their plain versions on a power-law
    operand with hub rows: within the limits, bitwise reproducible, each
    launch counted; the folded and side-COO products match scipy."""
    m = utils.power_law(3000, 3000, 12, seed=2)
    x64 = np.random.default_rng(4).random(3000)
    x = torch.tensor(x64, dtype=dtype, device=card)
    ref = m @ x64
    for A, kern, plain, full, key, launches in (
            (tgpr.pack_gpr(m, dtype=dtype, device=card), tgpr.spmv_gpr_rows,
             tgpr.spmv_gpr_ref, tgpr.spmv_gpr, "gpr", tgpr.LAUNCHES),
            (tell.pack_ell(m, dtype=dtype, device=card), tell.spmv_ell_main,
             tell.spmv_ell_packed_ref, tell.spmv_ell_packed, "ell",
             tell.LAUNCHES)):
        before = launches[key]
        y1, y2 = kern(A, x), kern(A, x)
        assert launches[key] == before + 2
        assert torch.equal(y1, y2)
        assert _rel(y1, plain(A, x)) <= TOL[dtype]
        y = full(A, x).cpu().double().numpy()
        gate = 2e-5 if dtype == torch.float32 else 1e-10
        assert np.max(np.abs(y - ref)) <= gate * np.max(np.abs(ref))


@pytest.mark.cuda
def test_general_plans_on_card(card):
    """The planner's general arm on the card: GPR for hub rows, sliced ELL
    for a shuffled grid stencil."""
    lap = utils.laplacian_2d(64)
    p = np.random.default_rng(5).permutation(lap.shape[0])
    for m, strategy in ((utils.power_law(5000, 5000, 10, seed=3), "gpr"),
                        (lap[p][:, p].tocsr(), "pallas_ell")):
        plan = plan_spmv(m, dtype=torch.float32)
        assert plan.strategy == strategy
        x64 = np.random.default_rng(6).random(m.shape[1])
        y = plan(torch.tensor(x64, dtype=torch.float32, device=card))
        assert y.is_cuda
        ref = m @ x64
        assert np.max(np.abs(y.cpu().double().numpy() - ref)) <= \
            2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 40])
def test_streaming_spmm_kernels_match_plain_on_card(card, dtype, nrhs):
    """K3a and K3b against their plain versions: within the limits,
    bitwise reproducible, pads zero, each column equal to the SpMV
    kernel's within the limit, each launch counted."""
    m = utils.laplacian_2d(32)
    dia = convert(COO.from_scipy(m, dtype=dtype, device=card), "dia")
    X = torch.tensor(np.random.default_rng(7).random((m.shape[0], nrhs)),
                     dtype=dtype, device=card)
    for A, kern, plain, spmv_kern, key in (
            (tds.pack_sdia(dia, nrhs=nrhs), tds.spmm_sdia_padded_t,
             tds.spmm_sdia_padded_t_ref, tds.spmv_sdia_padded, "sdia_spmm"),
            (tds.pack_psdia(dia, period=32, nrhs=nrhs),
             tds.spmm_psdia_padded_t, tds.spmm_psdia_padded_t_ref,
             tds.spmv_psdia_padded, "psdia_spmm")):
        Xt = torch.nn.functional.pad(X.T, (A.L, A.npad - A.L - m.shape[0]))
        before = tds.LAUNCHES[key]
        Y1, Y2 = kern(A, Xt.contiguous()), kern(A, Xt.contiguous())
        assert tds.LAUNCHES[key] == before + 2
        assert torch.equal(Y1, Y2)
        assert bool((Y1[:, :A.L] == 0).all()
                    and (Y1[:, A.L + m.shape[0]:] == 0).all())
        assert _rel(Y1, plain(A, Xt)) <= TOL[dtype]
        assert _rel(Y1[-1], spmv_kern(A, Xt[-1].contiguous())) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 40])
def test_general_spmm_kernels_match_plain_on_card(card, dtype, nrhs):
    """gpr_spmm and ell_spmm against their plain versions on a power-law
    operand with hub rows (the fold and the side COO engage): within the
    limits, bitwise reproducible, each launch counted; the full products
    match scipy."""
    m = utils.power_law(3000, 3000, 12, seed=2)
    X64 = np.random.default_rng(8).random((3000, nrhs))
    X = torch.tensor(X64, dtype=dtype, device=card)
    ref = m @ X64
    for A, kern, plain, full, key, launches in (
            (tgpr.pack_gpr(m, dtype=dtype, device=card), tgpr.spmm_gpr_rows,
             tgpr.spmm_gpr_ref, tgpr.spmm_gpr, "gpr_spmm", tgpr.LAUNCHES),
            (tell.pack_ell(m, dtype=dtype, device=card), tell.spmm_ell_main,
             tell.spmm_ell_packed_ref, tell.spmm_ell_packed, "ell_spmm",
             tell.LAUNCHES)):
        before = launches[key]
        Y1, Y2 = kern(A, X), kern(A, X)
        assert launches[key] == before + 2
        assert torch.equal(Y1, Y2)
        assert _rel(Y1, plain(A, X)) <= TOL[dtype]
        Y = full(A, X).cpu().double().numpy()
        gate = 2e-5 if dtype == torch.float32 else 1e-10
        assert np.max(np.abs(Y - ref)) <= gate * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_ring_kernels_match_plain_on_card(card, dtype, ndev):
    """K8a and K8b with ``ndev`` shards on one card: each shard's launch
    against its plain version within the limits, bitwise reproducible and
    counted; the concatenated shards bitwise equal to K1 / K2 on the same
    pack (zero past it), the unpadded product against scipy."""
    m = utils.laplacian_2d(48)
    dia = convert(COO.from_scipy(m, dtype=dtype, device=card), "dia")
    x64 = np.random.default_rng(9).random(m.shape[0])
    mesh = dist.make_mesh(ndev, device="cuda:0")    # all shards on one card
    for pack, cls, spmv_sharded, plain_single, key in (
            (tds.pack_sdia(dia, rb=1024), dist.ShardedSDIA,
             dist.spmv_sdia_sharded, tds.spmv_sdia_padded, "sdia_ring"),
            (tds.pack_psdia(dia, period=48, rb=1536), dist.ShardedPSDIA,
             dist.spmv_psdia_sharded, tds.spmv_psdia_padded, "psdia_ring")):
        A = dist.place(cls.build(pack, ndev), mesh)
        xpad = tds.pad_x(pack, torch.tensor(x64, dtype=dtype, device=card))
        xs = dist.place(A.shard_xpad(xpad), mesh)
        before = tdst.LAUNCHES[key]
        y1, y2 = spmv_sharded(mesh, A, xs), spmv_sharded(mesh, A, xs)
        assert tdst.LAUNCHES[key] == before + 2 * ndev
        err = top = 0.0                 # pad shards hold exact zeros
        for s in range(ndev):
            left = xs.chunks[(s - 1) % ndev][-A.halo:]
            right = xs.chunks[(s + 1) % ndev][:A.halo]
            if key == "sdia_ring":
                ref = tdst.spmv_sdia_ring_ref(A.data[s], A.offsets,
                                              xs.chunks[s], left, right)
            else:
                ref = tdst.spmv_psdia_ring_ref(
                    A.pattern[s], A.offsets, xs.chunks[s], left, right,
                    base=s * A.rows_per_shard, L=A.L, nrow=A.shape[0])
            assert torch.equal(y1.chunks[s], y2.chunks[s])
            err = max(err, float((y1.chunks[s] - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
        assert err <= TOL[dtype] * top
        flat = torch.cat(y1.chunks)
        assert torch.equal(flat[:pack.npad], plain_single(pack, xpad))
        assert not flat[pack.npad:].any()
        y = A.unshard_y(y1)
        ref = m @ x64
        gate = 2e-5 if dtype == torch.float32 else 1e-10
        assert np.max(np.abs(y - ref)) <= gate * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 4])
def test_sharded_dia_runs_ring_kernel_on_card(card, ndev):
    """The ``dia`` strategy launches K8a once per shard with whole
    neighbour chunks as slivers (a ragged last shard at 4): the product
    against the same shards' plain versions on the CPU and scipy."""
    m = utils.banded(2003, 7, seed=6)
    x = np.random.default_rng(4).standard_normal(m.shape[1])
    plans = [dist.plan_dist_spmv(m, dist.make_mesh(ndev, device=d),
                                 dtype=np.float64, strategy="dia")
             for d in ("cuda:0", "cpu")]
    before = tdst.LAUNCHES["sdia_ring"]
    y = plans[0].y_to_global(plans[0].spmv(plans[0].shard_x(x)))
    assert tdst.LAUNCHES["sdia_ring"] == before + ndev
    ref = plans[1].y_to_global(plans[1].spmv(plans[1].shard_x(x)))
    assert np.max(np.abs(y - ref)) <= TOL[torch.float64] * np.max(np.abs(ref))
    assert np.max(np.abs(y - m @ x)) <= 1e-10 * np.max(np.abs(m @ x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64,
                                   torch.float16])
@pytest.mark.parametrize("nrhs", [0, 1, 3, 40])
def test_permute_kernels_match_plain_on_card(card, dtype, nrhs):
    """permute_gather (nrhs 0: the single gather) and
    permute_gather_batched against their plain versions and x[perm]:
    bitwise, reproducible, zero at don't-care slots, each launch counted."""
    rng = np.random.default_rng(7)
    n = 60_013
    perm = rng.permutation(n)
    perm[rng.random(n) < 0.05] = -1
    real = torch.from_numpy(perm >= 0).to(card)
    plan = tperm.plan_permutation(perm, device=card)
    shape = (n,) if nrhs == 0 else (nrhs, n)
    x = torch.from_numpy(rng.integers(1, 1000, shape)).to(dtype).to(card)
    kern, plain, key = ((tperm.apply_permutation,
                         tperm.apply_permutation_ref, "permute")
                        if nrhs == 0 else
                        (tperm.apply_permutation_batched,
                         tperm.apply_permutation_batched_ref,
                         "permute_batched"))
    before = tperm.LAUNCHES[key]
    y1, y2 = kern(plan, x), kern(plan, x)
    torch.cuda.synchronize()
    assert tperm.LAUNCHES[key] == before + 2
    assert torch.equal(y1, y2) and torch.equal(y1, plain(plan, x))
    idx = torch.from_numpy(np.where(perm >= 0, perm, 0)).to(card)
    assert torch.equal(y1[..., real], x[..., idx][..., real])
    assert not y1[..., ~real].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transposed_packs_and_grads_on_card(card, dtype):
    """K1/K2 on transpose_sdia/psdia, and the backward of spmv_sdia /
    spmv_psdia on the card, against the same on the CPU (plain versions)
    and scipy."""
    import dataclasses

    m = utils.laplacian_2d(24).tocoo()
    m = type(utils.laplacian_2d(24))(
        (m.data * (1.0 + 0.1 * (m.col - m.row)), (m.row, m.col)),
        shape=m.shape)
    rng = np.random.default_rng(8)
    x64, w64 = rng.random(m.shape[0]), rng.random(m.shape[0])
    tol = 2e-5 if dtype == torch.float32 else 1e-10
    for pack, fn, coef in (
            (tds.pack_sdia, tds.spmv_sdia, "data"),
            (lambda d: tds.pack_psdia(d, period=24), tds.spmv_psdia,
             "pattern")):
        grads = []
        for dev in (card, torch.device("cpu")):
            A = pack(convert(COO.from_scipy(m, dtype=dtype, device=dev),
                             "dia"))
            At = (tds.transpose_sdia(A) if coef == "data"
                  else tds.transpose_psdia(A))
            yt = fn(At, torch.tensor(w64, dtype=dtype, device=dev))
            ref = m.T @ w64
            assert np.max(np.abs(yt.cpu().double().numpy() - ref)) <= \
                tol * np.max(np.abs(ref))
            c = getattr(A, coef).clone().requires_grad_(True)
            x = torch.tensor(x64, dtype=dtype, device=dev,
                             requires_grad=True)
            y = fn(dataclasses.replace(A, **{coef: c}), x)
            torch.dot(torch.tensor(w64, dtype=dtype, device=dev), y).backward()
            grads.append((x.grad.cpu(), c.grad.cpu()))
        for a, b in zip(*grads):
            assert float((a - b).abs().max()) <= \
                TOL[dtype] * float(b.abs().max())


@pytest.mark.cuda
def test_reordered_operator_on_card(card):
    """ro(x) launches the gather twice and K1 once, and matches scipy."""
    n = 5000
    band = utils.banded(n, 4, seed=9)
    p = np.random.default_rng(9).permutation(n)
    shuffled = band[p][:, p].tocsr()
    ro = reorder_plan(shuffled, dtype=torch.float32, device=card)
    assert ro.strategy == "rcm+dia_stream" and ro.bandwidth_after == 4
    x64 = np.random.default_rng(10).random(n)
    before = (tperm.LAUNCHES["permute"], tds.LAUNCHES["sdia"])
    y = ro(torch.tensor(x64, dtype=torch.float32, device=card))
    assert (tperm.LAUNCHES["permute"], tds.LAUNCHES["sdia"]) == \
        (before[0] + 2, before[1] + 1)
    ref = shuffled @ x64
    assert np.max(np.abs(y.cpu().double().numpy() - ref)) <= \
        2e-5 * np.max(np.abs(ref))
