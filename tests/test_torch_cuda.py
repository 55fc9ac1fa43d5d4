"""Tests of the port that need a CUDA card (the CUDA kernels have no CPU
mode).  Each skips without a card.  The file imports no JAX, so it also
runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
from pathlib import Path

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
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
def test_streaming_spmm_kernels_match_plain_on_card(card, dtype, nrhs):
    """K3a and K3b against their plain versions: within the limits,
    bitwise reproducible, pads zero, every column bitwise the SpMV
    kernel's (K1, K2) on the same pack, each launch counted."""
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
        for q in range(nrhs):
            assert torch.equal(Y1[q], spmv_kern(A, Xt[q].contiguous())), q


def _every_width(seed: int = 0):
    """Rows of every length 0..300: every width class, empty rows and hub
    rows (more than 128 entries)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.arange(301), np.zeros(7, int)])
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(4000, k, replace=False) for k in lens])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(len(lens), 4000))


def _gpr_operand(name: str):
    import scipy.sparse as sp

    from tpu_spmv_torch.io.mmio import read_mtx_arrays

    if name == "every width":
        return _every_width()
    if name == "two classes":           # classes 16, 32 and 64 empty
        return sp.csr_matrix(sp.vstack([_every_width()[1:8],
                                        _every_width()[120:128]]))
    row, col, val, shape = read_mtx_arrays(
        Path(__file__).resolve().parent / "fixtures" / name, use_native=False)
    return sp.csr_matrix((val, (row, col)), shape=shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["every width", "two classes",
                                  "powerlaw800.mtx"])
def test_gpr_spmv_every_width_class_on_card(card, dtype, name):
    """``gpr_spmv`` (a quarter of the class width in lanes per row) against
    its plain version on rows of every width class, with empty classes,
    empty rows and hub rows: within the limit, bitwise reproducible, one
    launch each; the folded product matches scipy."""
    m = _gpr_operand(name)
    A = tgpr.pack_gpr(m, dtype=dtype, device=card)
    x64 = np.random.default_rng(5).standard_normal(m.shape[1])
    x = torch.tensor(x64, dtype=dtype, device=card)
    before = tgpr.LAUNCHES["gpr"]
    y1, y2 = tgpr.spmv_gpr_rows(A, x), tgpr.spmv_gpr_rows(A, x)
    assert tgpr.LAUNCHES["gpr"] == before + 2
    assert torch.equal(y1, y2)
    assert _rel(y1, tgpr.spmv_gpr_ref(A, x)) <= TOL[dtype]
    ref = m @ x64
    y = tgpr.spmv_gpr(A, x).cpu().double().numpy()
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    assert np.max(np.abs(y - ref)) <= gate * np.max(np.abs(ref))


def _toeplitz_band(n: int, half: int):
    import scipy.sparse as sp

    rng = np.random.default_rng(half)
    offs = list(range(-half, half + 1))
    return sp.diags([rng.standard_normal() for _ in offs], offs,
                    shape=(n, n), format="csr")


_SPMM_OPERANDS = ["laplacian_2d(40)", "laplacian_2d(40), rb 80",
                  "laplacian_2d(128)", "laplacian_2d(256), rb 512",
                  "laplacian_2d(300, 101)", "laplacian_3d(10)",
                  "band of 301 diagonals"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
@pytest.mark.parametrize("name", _SPMM_OPERANDS)
def test_psdia_spmm_windows_match_plain_and_k2_on_card(card, dtype, nrhs,
                                                      name):
    """K3b with its shared-memory windows, the plan's walk and the
    cluster walk on every operand: the 2-D and 3-D Poisson, a row tile
    shorter than the kernel's tile, a band whose clusters the plan cuts,
    ragged last tiles and columns of the stride walk of unequal length,
    each with Xt's rows 16-byte aligned and not (a view one value into its
    buffer): within the limit of the plain version, rows outside [L, L +
    nrow) zero, bitwise reproducible, and every column bitwise equal to K2
    on the same pack."""
    m, rb = {"laplacian_2d(40)": (utils.laplacian_2d(40), None),
             "laplacian_2d(40), rb 80": (utils.laplacian_2d(40), 80),
             "laplacian_2d(128)": (utils.laplacian_2d(128), None),
             "laplacian_2d(256), rb 512": (utils.laplacian_2d(256), 512),
             "laplacian_2d(300, 101)": (utils.laplacian_2d(300, 101), None),
             "laplacian_3d(10)": (utils.laplacian_3d(10), None),
             "band of 301 diagonals": (_toeplitz_band(1500, 150), None)}[name]
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    A = tds.pack_psdia(dia, period=tds.detect_period(dia), nrhs=nrhs, rb=rb,
                       device=card)
    n = m.shape[0]
    X = torch.tensor(np.random.default_rng(nrhs).random((nrhs, n)),
                     dtype=dtype, device=card)
    for shift in (0, 1):
        buf = torch.zeros(nrhs * A.npad + 1, dtype=dtype, device=card)
        Xt = buf[shift:shift + nrhs * A.npad].view(nrhs, A.npad)
        Xt[:, A.L:A.L + n] = X
        before = tds.LAUNCHES["psdia_spmm"]
        Y1, Y2 = tds.spmm_psdia_padded_t(A, Xt), tds.spmm_psdia_padded_t(A, Xt)
        Yc = tds._spmm_launch(A, Xt, tds._cluster_walk(
            A.offsets, nrhs, A.pattern.element_size()))
        assert tds.LAUNCHES["psdia_spmm"] == before + 3
        assert torch.equal(Y1, Y2) and torch.equal(Y1, Yc)
        assert bool((Y1[:, :A.L] == 0).all() and (Y1[:, A.L + n:] == 0).all())
        assert _rel(Y1, tds.spmm_psdia_padded_t_ref(A, Xt)) <= TOL[dtype]
        for q in range(nrhs):
            assert torch.equal(Y1[q], tds.spmv_psdia_padded(
                A, Xt[q].contiguous())), q


#: K3a's operands: K3b's, packed as SDIA, and a row tile of 87 rows whose
#: npad (1827) and L (87) are odd, so the data rows take one-value copies
_SDIA_SPMM_OPERANDS = ["laplacian_2d(40)", "laplacian_2d(40), rb 87",
                       "laplacian_2d(128)", "laplacian_2d(300, 101)",
                       "laplacian_3d(10)", "band of 301 diagonals"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
@pytest.mark.parametrize("name", _SDIA_SPMM_OPERANDS)
def test_sdia_spmm_windows_match_plain_and_k1_on_card(card, dtype, nrhs,
                                                     name):
    """K3a on K3b's walks, the plan's and the cluster walk, with the data
    rows as the coefficients: the 2-D and 3-D Poisson, an odd npad, a
    band whose clusters the plan cuts, 40 RHS in two chunks (the data rows
    read twice), Xt's rows 16-byte aligned and not: within the limit of
    the plain version, rows outside [L, L + nrow) zero, bitwise
    reproducible, every column bitwise K1 on the same pack."""
    m, rb = {"laplacian_2d(40)": (utils.laplacian_2d(40), None),
             "laplacian_2d(40), rb 87": (utils.laplacian_2d(40), 87),
             "laplacian_2d(128)": (utils.laplacian_2d(128), None),
             "laplacian_2d(300, 101)": (utils.laplacian_2d(300, 101), None),
             "laplacian_3d(10)": (utils.laplacian_3d(10), None),
             "band of 301 diagonals": (_toeplitz_band(1500, 150), None)}[name]
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    A = tds.pack_sdia(dia, rb=rb, nrhs=nrhs, device=card)
    n = m.shape[0]
    if rb == 87:
        assert A.npad % 2 and A.L % 2
    X = torch.tensor(np.random.default_rng(nrhs).random((nrhs, n)),
                     dtype=dtype, device=card)
    clusters = tds._cluster_walk(A.offsets, nrhs, A.data.element_size())
    for shift in (0, 1):
        buf = torch.zeros(nrhs * A.npad + 1, dtype=dtype, device=card)
        Xt = buf[shift:shift + nrhs * A.npad].view(nrhs, A.npad)
        Xt[:, A.L:A.L + n] = X
        before = tds.LAUNCHES["sdia_spmm"]
        Y1, Y2 = tds.spmm_sdia_padded_t(A, Xt), tds.spmm_sdia_padded_t(A, Xt)
        Yc = tds._spmm_launch(A, Xt, clusters)
        assert tds.LAUNCHES["sdia_spmm"] == before + 3
        assert torch.equal(Y1, Y2) and torch.equal(Y1, Yc)
        assert bool((Y1[:, :A.L] == 0).all() and (Y1[:, A.L + n:] == 0).all())
        assert _rel(Y1, tds.spmm_sdia_padded_t_ref(A, Xt)) <= TOL[dtype]
        for q in range(nrhs):
            assert torch.equal(Y1[q], tds.spmv_sdia_padded(
                A, Xt[q].contiguous())), q


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_spmm_refuses_a_plan_that_does_not_fit_on_card(card, kind):
    """K3a and K3b launch only a plan whose ring fits the shared memory a
    block may have and whose tile is the kernel's: a plan with a larger
    slot, or another tile height, raises and is not counted; nothing
    falls back to another kernel."""
    m = utils.laplacian_2d(64)
    dia = convert(COO.from_scipy(m, dtype=torch.float32), "dia")
    A = (tds.pack_sdia(dia, nrhs=8, device=card) if kind == "sdia" else
         tds.pack_psdia(dia, period=64, nrhs=8, device=card))
    Xt = torch.zeros(8, A.npad, device=card)
    plan = tds.psdia_spmm_plan(A.offsets, 8, 4)
    key = f"{kind}_spmm"
    for bad in (dataclasses.replace(plan, slot=tds.SPMM_SMEM_MAX // 4),
                dataclasses.replace(plan, tk=2 * plan.tk)):
        before = tds.LAUNCHES[key]
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            tds._spmm_launch(A, Xt, bad)
        assert tds.LAUNCHES[key] == before
    assert torch.equal(tds._spmm_launch(A, Xt, plan), torch.zeros_like(Xt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 32, 40])
def test_ell_spmm_sums_its_slots_in_order_on_card(card, dtype, nrhs):
    """ell_spmm bitwise against every row's slots summed in order for each
    RHS, emulated on the host as for ell_spmv (exact dyadic products),
    on widths 0 to MAX_WIDTH, an empty slice, a ragged last slice and the
    side COO's row, X 16-byte aligned and not."""
    rng = np.random.default_rng(13)
    bits, npt = ((12, np.float32) if dtype == torch.float32
                 else (26, np.float64))
    m = _ell_widths(rng)
    m.data = _dyadic(rng, m.nnz, bits)
    X64 = _dyadic(rng, m.shape[1] * nrhs, bits).reshape(m.shape[1], nrhs)
    A = tell.pack_ell(m, dtype=dtype, device=card)
    vals, cols = A.vals.cpu().numpy(), A.cols.cpu().numpy()
    ptr = A.slice_ptr.cpu().numpy()
    widths = np.diff(ptr) // 32
    r = np.arange(m.shape[0])
    base, w = ptr[r // 32] + r % 32, widths[r // 32]
    Xh = X64.astype(npt)
    acc = np.zeros((m.shape[0], nrhs), dtype=npt)
    for j in range(int(widths.max())):
        at = np.where(j < w, base + 32 * j, 0)
        term = np.where((j < w)[:, None], vals[at, None] * Xh[cols[at]], 0)
        acc = (acc + term.astype(npt)).astype(npt)
    for shift in (0, 1):
        buf = torch.zeros(Xh.size + 1, dtype=dtype, device=card)
        X = buf[shift:shift + Xh.size].view(Xh.shape)
        X.copy_(torch.from_numpy(Xh))
        assert np.array_equal(tell.spmm_ell_main(A, X).cpu().numpy(), acc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 32, 40])
def test_general_spmm_kernels_match_plain_on_card(card, dtype, nrhs):
    """gpr_spmm and ell_spmm against their plain versions on a power-law
    operand with hub rows (the fold and the side COO engage), X 16-byte
    aligned and not (a view one value into its buffer): within the
    limits, bitwise reproducible and equal on both, each launch counted;
    every column of ell_spmm bitwise ell_spmv's; the full products match
    scipy."""
    m = utils.power_law(3000, 3000, 12, seed=2)
    X64 = np.random.default_rng(8).random((3000, nrhs))
    ref = m @ X64
    for shift in (0, 1):
        buf = torch.zeros(3000 * nrhs + 1, dtype=dtype, device=card)
        X = buf[shift:shift + 3000 * nrhs].view(3000, nrhs)
        X.copy_(torch.from_numpy(X64))
        for A, kern, plain, full, key, launches in (
                (tgpr.pack_gpr(m, dtype=dtype, device=card),
                 tgpr.spmm_gpr_rows, tgpr.spmm_gpr_ref, tgpr.spmm_gpr,
                 "gpr_spmm", tgpr.LAUNCHES),
                (tell.pack_ell(m, dtype=dtype, device=card),
                 tell.spmm_ell_main, tell.spmm_ell_packed_ref,
                 tell.spmm_ell_packed, "ell_spmm", tell.LAUNCHES)):
            before = launches[key]
            Y1, Y2 = kern(A, X), kern(A, X)
            assert launches[key] == before + 2
            assert torch.equal(Y1, Y2)
            assert torch.equal(Y1, kern(A, X.contiguous().clone()))
            assert _rel(Y1, plain(A, X)) <= TOL[dtype]
            if key == "ell_spmm":
                for q in range(nrhs):
                    assert torch.equal(Y1[:, q], tell.spmv_ell_main(
                        A, X[:, q].contiguous())), q
            Y = full(A, X).cpu().double().numpy()
            gate = 2e-5 if dtype == torch.float32 else 1e-10
            assert np.max(np.abs(Y - ref)) <= gate * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
@pytest.mark.parametrize("name", ["every width", "two classes",
                                  "powerlaw800.mtx"])
def test_gpr_spmm_every_width_class_on_card(card, dtype, nrhs, name):
    """``gpr_spmm`` (G lanes a row, V RHS a lane) against its plain version
    on rows of every width class, with empty classes, empty rows and
    128-entry virtual rows of hub rows: within the limit, bitwise
    reproducible, one launch each, and bitwise equal with X and Y one
    value off their 16-byte alignment (one RHS a lane: the same sums in the
    same order); the folded product matches scipy."""
    m = _gpr_operand(name)
    A = tgpr.pack_gpr(m, dtype=dtype, device=card)
    assert A.nv > 0 or name == "two classes"
    X64 = np.random.default_rng(nrhs).standard_normal((m.shape[1], nrhs))
    X = torch.tensor(X64, dtype=dtype, device=card)
    before = tgpr.LAUNCHES["gpr_spmm"]
    Y1, Y2 = tgpr.spmm_gpr_rows(A, X), tgpr.spmm_gpr_rows(A, X)
    buf = torch.empty(X.numel() + 1, dtype=dtype, device=card)
    Xs = buf[1:].view(X.shape)
    Xs.copy_(X)
    Ys = tgpr.spmm_gpr_rows(A, Xs)
    assert tgpr.LAUNCHES["gpr_spmm"] == before + 3
    assert torch.equal(Y1, Y2) and torch.equal(Y1, Ys)
    assert _rel(Y1, tgpr.spmm_gpr_ref(A, X)) <= TOL[dtype]
    ref = m @ X64
    Y = tgpr.spmm_gpr(A, X).cpu().double().numpy()
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    assert np.max(np.abs(Y - ref)) <= gate * np.max(np.abs(ref))


def _ring_fused(data, offsets, x, left, right):
    """K8a's order on a float32 x (float32 or bf16 data): the plain
    version's sum with one exact fma a diagonal from zero, as the kernel
    fuses it."""
    acc = torch.zeros_like(x)
    for d, xs in enumerate(tdst._shifted(x, left, right, offsets)):
        acc = tds.fma_f32(data[d].to(x.dtype), xs, acc)
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
def test_ring_kernels_match_plain_on_card(card, dtype, ndev):
    """K8a and K8b with ``ndev`` shards on one card: each shard's launch
    against its plain version within the limits (K8a in float32 bitwise
    the plain order fused, one fma a diagonal), bitwise reproducible and
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
                if dtype == torch.float32:
                    assert torch.equal(y1.chunks[s], _ring_fused(
                        A.data[s], A.offsets, xs.chunks[s], left, right)), s
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


_RING_OPERANDS = ["laplacian_2d(2048, 40)", "laplacian_2d(48)",
                  "laplacian_3d(16)", "band of 81 diagonals"]


def _ring_walks(A, itemsize):
    """K8b's walks on a sharded pack: the pack's own plan, the stride walk
    (if any) with the coefficients staged per tile (period taken as rb),
    and the cluster walk."""
    return {"plan": A.ring_plan,
            "per tile": tdst.psdia_ring_plan(A.offsets, A.rb, itemsize),
            "clusters": tdst.ring_cluster_walk(A.offsets, itemsize)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _RING_OPERANDS)
def test_psdia_ring_walks_match_k2_bitwise_on_card(card, dtype, name):
    """K8b's walks (stride walk with the coefficients once per segment or
    per tile, cluster walk) at 1, 2 and 4 shards on one card, with the
    chunks 16-byte aligned and not: the concatenated shards bitwise equal
    to K2 on the same pack (at one shard, K8b itself), zero past it, each
    launch within the limit of its plain version, bitwise reproducible and
    counted."""
    m = {"laplacian_2d(2048, 40)": utils.laplacian_2d(2048, 40),
         "laplacian_2d(48)": utils.laplacian_2d(48),
         "laplacian_3d(16)": utils.laplacian_3d(16),
         "band of 81 diagonals": _toeplitz_band(3000, 40)}[name]
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    pack = tds.pack_psdia(dia, period=tds.detect_period(dia), device=card)
    x64 = np.random.default_rng(11).standard_normal(m.shape[0])
    xpad = tds.pad_x(pack, torch.tensor(x64, dtype=dtype, device=card))
    k2 = tds.spmv_psdia_padded(pack, xpad)
    isz = pack.pattern.element_size()
    if name.startswith("laplacian_2d(2048"):
        assert pack.period == 2048
        assert _ring_walks(dist.ShardedPSDIA.build(pack, 1), isz)[
            "plan"].stride * tdst.RING_TILE == 2048
    for ndev in (1, 2, 4):
        mesh = dist.make_mesh(ndev, device="cuda:0")
        A = dist.place(dist.ShardedPSDIA.build(pack, ndev), mesh)
        for shift in (0, 1):
            buf = torch.zeros(A.npad + 1, dtype=dtype, device=card)
            buf[shift:shift + pack.npad] = xpad
            chunks = buf[shift:shift + A.npad].split(A.rows_per_shard)
            for walk, plan in _ring_walks(A, isz).items():
                before = tdst.LAUNCHES["psdia_ring"]
                ys = []
                for s in range(ndev):
                    args = (A.pattern[s], A.offsets, chunks[s],
                            chunks[(s - 1) % ndev][-A.halo:],
                            chunks[(s + 1) % ndev][:A.halo])
                    kw = dict(base=s * A.rows_per_shard, L=A.L,
                              nrow=A.shape[0])
                    y1 = tdst.spmv_psdia_ring(*args, **kw, plan=plan)
                    y2 = tdst.spmv_psdia_ring(*args, **kw, plan=plan)
                    ref = tdst.spmv_psdia_ring_ref(*args, **kw)
                    assert torch.equal(y1, y2), (walk, ndev, s)
                    top = max(float(ref.abs().max()), 1e-300)
                    assert float((y1 - ref).abs().max()) <= TOL[dtype] * top
                    ys.append(y1)
                assert tdst.LAUNCHES["psdia_ring"] == before + 2 * ndev
                flat = torch.cat(ys)
                assert torch.equal(flat[:pack.npad], k2), (walk, ndev, shift)
                assert not flat[pack.npad:].any()
        # the sharded chain runs the pack's own walk
        xs = dist.place(A.shard_xpad(xpad), mesh)
        flat = torch.cat(dist.spmv_psdia_sharded(mesh, A, xs).chunks)
        assert torch.equal(flat[:pack.npad], k2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_psdia_ring_refuses_a_walk_that_does_not_fit_on_card(card, dtype):
    """On a CUDA tensor K8b launches only with a walk, and only with one
    that fits the offsets: a missing plan and a stride walk whose ``jd``
    reach a window two tiles back (more windows than its ring holds)
    raise ``ValueError`` before any launch; the pack's walk then runs,
    bitwise K2."""
    m = utils.laplacian_2d(2048, 40)
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    pack = tds.pack_psdia(dia, period=tds.detect_period(dia), device=card)
    xpad = tds.pad_x(pack, torch.rand(m.shape[0], dtype=dtype, device=card))
    A = dist.place(dist.ShardedPSDIA.build(pack, 1),
                   dist.make_mesh(1, device="cuda:0"))
    x0 = A.shard_xpad(xpad).chunks[0]
    args = (A.pattern[0], A.offsets, x0, x0[-A.halo:], x0[:A.halo])
    kw = dict(base=0, L=A.L, nrow=A.shape[0])
    bad = dataclasses.replace(A.ring_plan, jd=(-2, 0, 0, 0, 1))
    before = tdst.LAUNCHES["psdia_ring"]
    with pytest.raises(ValueError, match="needs the walk"):
        tdst.spmv_psdia_ring(*args, **kw)
    with pytest.raises(ValueError, match="outside"):
        tdst.spmv_psdia_ring(*args, **kw, plan=bad)
    assert tdst.LAUNCHES["psdia_ring"] == before
    y = tdst.spmv_psdia_ring(*args, **kw, plan=A.ring_plan)
    assert torch.equal(y[:pack.npad], tds.spmv_psdia_padded(pack, xpad))


def _k2_packs(name, dtype, card):
    """K2's operands on the card: the pack of ``name``, its transpose,
    the screened pack ``A + I`` and the pack with its period taken as rb
    (the stride walk with the coefficient rows per tile)."""
    import scipy.sparse as sp

    from tpu_spmv_torch.ops.shift import shift_diagonal

    m = {"laplacian_2d(2048, 40)": utils.laplacian_2d(2048, 40),
         "laplacian_2d(48)": utils.laplacian_2d(48),
         "laplacian_3d(16)": utils.laplacian_3d(16),
         "band of 81 diagonals": _toeplitz_band(3000, 40)}[name]
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    pack = tds.pack_psdia(dia, period=tds.detect_period(dia), device=card)
    return m, {"pack": (pack, m), "transposed": (tds.transpose_psdia(pack),
                                                 m.T.tocsr()),
               "screened": (shift_diagonal(pack, 1.0),
                            m + sp.identity(m.shape[0])),
               "period rb": (dataclasses.replace(pack, period=pack.rb), m)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _RING_OPERANDS)
def test_psdia_walks_match_k8b_k3b_and_plain_on_card(card, dtype, name):
    """K2 on its walk (the plan's: by bulk copy where xpad is 16-byte
    aligned, else by cp.async, the kernel's V = 1 branch), the stride walk
    with the coefficients per tile and the cluster walk, on each pack, its
    transpose, the screened pack and the pack whose period is taken as rb,
    with xpad 16-byte aligned and not (a view one value into its buffer):
    all bitwise equal, bitwise K8b at one shard and every column of K3b at
    3 RHS on the same pack, within the limit of the plain version and
    scipy's gate, pads zero, each launch counted."""
    _, packs = _k2_packs(name, dtype, card)
    isz = torch.tensor([], dtype=dtype).element_size()
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    for label, (P, mat) in packs.items():
        n = mat.shape[0]
        x64 = np.random.default_rng(n).standard_normal(n)
        walks = {"per tile": tds.psdia_walk_plan(P.offsets, P.rb, isz),
                 "clusters": tds.psdia_cluster_walk(P.offsets, isz)}
        for shift in (0, 1):
            buf = torch.zeros(P.npad + 1, dtype=dtype, device=card)
            xp = buf[shift:shift + P.npad]
            xp[P.L:P.L + n] = torch.tensor(x64, dtype=dtype, device=card)
            before = tds.LAUNCHES["psdia"]
            y, y2 = tds.spmv_psdia_padded(P, xp), tds.spmv_psdia_padded(P, xp)
            assert tds.LAUNCHES["psdia"] == before + 2
            assert torch.equal(y, y2), (label, shift)
            for wname, wplan in walks.items():
                assert torch.equal(tds._spmv_psdia_launch(P, xp, wplan), y), \
                    (label, wname, shift)
            ref = tds.spmv_psdia_padded_ref(P, xp)
            assert _rel(y, ref) <= TOL[dtype], (label, shift)
            assert not y[:P.L].any() and not y[P.L + n:].any()
            yv = y[P.L:P.L + n].cpu().double().numpy()
            want = mat @ x64
            assert np.max(np.abs(yv - want)) <= gate * np.max(np.abs(want))
        # K8b at one shard of the same pack, and K3b's columns
        A = dist.place(dist.ShardedPSDIA.build(P, 1),
                       dist.make_mesh(1, device="cuda:0"))
        xp = tds.pad_x(P, torch.tensor(x64, dtype=dtype, device=card))
        y = tds.spmv_psdia_padded(P, xp)
        x0 = A.shard_xpad(xp).chunks[0]
        y8 = tdst.spmv_psdia_ring(A.pattern[0], A.offsets, x0, x0[-A.halo:],
                                  x0[:A.halo], base=0, L=A.L, nrow=A.shape[0],
                                  plan=A.ring_plan)
        assert torch.equal(y8[:P.npad], y), label
        Xt = torch.stack([xp, xp.flip(0), 2 * xp]).contiguous()
        Y = tds.spmm_psdia_padded_t(P, Xt)
        for q in range(3):
            assert torch.equal(Y[q], tds.spmv_psdia_padded(P, Xt[q])), \
                (label, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_one_thread_a_row_on_few_tiles_on_card(card, dtype):
    """K2's walks take only the tiles that hold rows of [L, L + nrow), and
    its wrapper runs one thread a row where there are no more such tiles
    than four per SM of the card: on the 2-D Poisson below and above that
    count,
    and on each with its rows moved to the start of the row space (L = 0:
    the first tile's windows clipped at column 0), aligned and one value
    off, the wrapper's product is bitwise the plan's walk and the cluster
    walk asked for by name, within the tolerance of the plain version,
    and its valid rows within the gate of scipy."""
    import math

    limit = 4 * torch.cuda.get_device_properties(card).multi_processor_count
    assert tds._direct_tiles(card) == limit
    isz = torch.tensor([], dtype=dtype).element_size()
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    for f, rnd in ((0.92, math.floor), (1.08, math.ceil)):
        nx = 16 * rnd(math.sqrt(limit * tds.WALK_TILE * f) / 16)
        m = utils.laplacian_2d(nx)
        n = m.shape[0]
        P0 = tds.pack_psdia(convert(COO.from_scipy(m, dtype=dtype), "dia"),
                            device=card)
        tiles = -(-(P0.L + n) // tds.WALK_TILE) - P0.L // tds.WALK_TILE
        assert (tiles <= limit) == (f < 1), (nx, tiles, limit)
        x64 = np.random.default_rng(nx).standard_normal(n)
        for P in (P0, dataclasses.replace(P0, L=0)):
            for shift in (0, 1):
                buf = torch.zeros(P.npad + 1, dtype=dtype, device=card)
                xp = buf[shift:shift + P.npad]
                xp[P.L:P.L + n] = torch.tensor(x64, dtype=dtype, device=card)
                y = tds.spmv_psdia_padded(P, xp)
                for plan in (tds.psdia_walk_plan(P.offsets, P.period, isz),
                             tds.psdia_cluster_walk(P.offsets, isz)):
                    assert torch.equal(tds._spmv_psdia_launch(P, xp, plan),
                                       y), (nx, P.L, shift, plan.stride)
                assert _rel(y, tds.spmv_psdia_padded_ref(P, xp)) \
                    <= TOL[dtype], (nx, P.L, shift)
                assert not y[:P.L].any() and not y[P.L + n:].any()
                if P is P0:
                    got = y[P.L:P.L + n].cpu().double().numpy()
                    want = m @ x64
                    assert np.max(np.abs(got - want)) <= \
                        gate * np.max(np.abs(want))


@pytest.mark.cuda
def test_psdia_walk_refuses_a_walk_that_does_not_fit_on_card(card):
    """K2 launches only with a walk that fits the offsets: a stride walk
    whose jd reach a window two tiles back raises before any launch."""
    import dataclasses as dc

    _, packs = _k2_packs("laplacian_2d(2048, 40)", torch.float32, card)
    P = packs["pack"][0]
    xp = tds.pad_x(P, torch.rand(P.shape[0], device=card))
    bad = dc.replace(tds.psdia_walk_plan(P.offsets, P.period, 4),
                     jd=(-2, 0, 0, 0, 1))
    before = tds.LAUNCHES["psdia"]
    with pytest.raises(ValueError, match="outside"):
        tds._spmv_psdia_launch(P, xp, bad)
    assert tds.LAUNCHES["psdia"] == before


def _random_tile_program(rng, itype, device, T: int = 3):
    """A random tile_permute program of 1 to 8 steps on ``T`` tiles: index
    slots shared or per tile, tiles loaded directly or through a row index
    (with or without lane gathers), with or without ``mul`` and
    ``psum8``."""
    from tpu_spmv_torch.bench import probes as pr

    Q = pr.Q
    nsteps = int(rng.integers(1, 9))
    K = int(rng.integers(1, 5))
    steps = "".join(rng.choice(["S", "G", "T"]) + str(rng.integers(0, K))
                    for _ in range(nsteps)).replace("T0", "T").replace(
        "T1", "T").replace("T2", "T").replace("T3", "T")
    Ti = 1 if rng.random() < 0.5 else T
    idx = rng.integers(0, Q, (K, Ti, Q, Q)).astype(itype)
    kind = rng.choice(["direct", "rows", "rows+lanes"])
    if kind == "direct":
        prog = pr.plan_tile_program(steps, idx, device=device)
        src = torch.rand(T, Q, Q, device=device)
    else:
        nload = int(rng.integers(1, Q + 1))
        rows = rng.integers(0, 300, T * nload)
        lidx = (rng.integers(0, Q, (T * nload, Q)).astype(itype)
                if kind == "rows+lanes" else None)
        prog = pr.plan_tile_program(steps, idx, rowsrc=rows, lidx=lidx,
                                    nload=nload, device=device)
        src = torch.rand(300, Q, device=device)
    mul = torch.rand(T, Q, Q, device=device) if rng.random() < 0.5 else None
    return prog, src, mul, bool(rng.random() < 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("itype", [np.int8, np.int32])
def test_tile_permute_random_programs_on_card(card, itype):
    """Random programs of up to 8 steps (every mode: S-only, G-only and
    mixed, with transposes), both index types, shared and per-tile index
    tiles, direct and row-loaded tiles, with and without mul and psum8,
    src 16-byte aligned and not: bitwise the plain version, each launch
    counted."""
    from tpu_spmv_torch.bench import probes as pr

    rng = np.random.default_rng(int(np.dtype(itype).itemsize))
    for trial in range(24):
        prog, src, mul, psum8 = _random_tile_program(rng, itype, card)
        if trial % 3 == 2:                 # one value into a buffer
            buf = torch.empty(src.numel() + 1, device=card)
            buf[1:] = src.reshape(-1)
            src = buf[1:].view(src.shape)
        before = pr.LAUNCHES["tile_permute"]
        got = pr.tile_permute(prog, src, mul, psum8)
        assert pr.LAUNCHES["tile_permute"] == before + 1
        assert torch.equal(got, pr.tile_permute_ref(prog, src, mul, psum8)), \
            (trial, prog.steps, prog.mode)


def _diagonals(n, offsets, seed=0):
    """An ``n``-square matrix of random values on ``offsets``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n - abs(o)) for o in offsets],
                    offsets, shape=(n, n)).tocsr()


#: K8a's split of a shard into the interior (rows that read x alone) and
#: the edges, under the ``dia`` strategy (chunks of R = ceil(n / ndev)
#: rows, odd at 1203 / 4 = 301 and 2003 / 4 = 501; the interior
#: ``kernels/dist_stream.py:ring_interior``): none at 3 and 4 shards of
#: "no interior", one row at 4 shards of "one row", one-sided bands, the
#: main diagonal alone, and 15 and 17 diagonals (more than the kernel's
#: diagonals a group)
_DIA_SPLITS = {
    "band": lambda: utils.banded(2003, 7, seed=6),
    "no interior": lambda: _diagonals(1203, (-300, 0, 250)),
    "one row": lambda: _diagonals(1203, (-150, 0, 150)),
    "offsets >= 0": lambda: _diagonals(1203, (0, 3, 40)),
    "offsets <= 0": lambda: _diagonals(1203, (-40, -3, 0)),
    "main diagonal": lambda: _diagonals(1203, (0,)),
    "17 diagonals": lambda: _diagonals(4099, tuple(range(-8, 9))),
}


def _bf16_rounded_f32(m):
    """``m`` with its values rounded to bf16 (held in float32)."""
    m = m.copy()
    m.data = torch.from_numpy(m.data).to(torch.bfloat16).float().numpy()
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(_DIA_SPLITS))
def test_sharded_dia_runs_ring_kernel_on_card(card, name, ndev, dtype):
    """The ``dia`` strategy launches K8a once per shard with whole
    neighbour chunks as slivers (chunks of any length; a ragged last
    shard): every shard bitwise reproducible and against its plain
    version (bitwise on bf16 data and, fused as the kernel fuses, in
    float32; within the limit in float64), the product against the CPU
    plan's and scipy, and at one shard bitwise K1 on the same matrix."""
    m = _DIA_SPLITS[name]()
    bf16 = dtype == torch.bfloat16
    xt = torch.float64 if dtype == torch.float64 else torch.float32
    x = np.random.default_rng(4).standard_normal(m.shape[1])
    x = x.astype(np.float64 if xt == torch.float64 else np.float32)
    mesh = dist.make_mesh(ndev, device="cuda:0")
    plans = [dist.plan_dist_spmv(m, dist.make_mesh(ndev, device=d),
                                 dtype=dtype, strategy="dia")
             for d in ("cuda:0", "cpu")]
    A = plans[0].matrix
    key = "sdia_ring_bf16" if bf16 else "sdia_ring"
    xs = plans[0].shard_x(x)
    before = tdst.LAUNCHES[key]
    y1, y2 = plans[0].spmv(xs), plans[0].spmv(xs)
    assert tdst.LAUNCHES[key] == before + 2 * ndev
    for s, (left, right) in enumerate(_ring_slivers(xs, A.rows_per_shard)):
        args = (A.data[s], A.offsets, xs.chunks[s], left, right)
        assert torch.equal(y1.chunks[s], y2.chunks[s]), s
        if dtype == torch.float64:
            ref = tdst.spmv_sdia_ring_ref(*args)
            assert _rel(y1.chunks[s], ref) <= TOL[dtype], s
        else:
            assert torch.equal(y1.chunks[s], _ring_fused(*args)), s
    y = plans[0].y_to_global(y1)
    ref = plans[1].y_to_global(plans[1].spmv(plans[1].shard_x(x)))
    assert np.max(np.abs(y - ref)) <= TOL[xt] * np.max(np.abs(ref))
    exact = (_bf16_rounded_f32(m) if bf16 else m) @ x.astype(np.float64)
    gate = 1e-10 if dtype == torch.float64 else 2e-5
    assert np.max(np.abs(y - exact)) <= gate * np.max(np.abs(exact))
    if ndev == 1:
        dia = convert(COO.from_scipy(_bf16_rounded_f32(m) if bf16 else m,
                                     dtype=xt), "dia")
        S = tds.pack_sdia(dia, device=card,
                          data_dtype=torch.bfloat16 if bf16 else None)
        k1 = tds.spmv_sdia(S, torch.from_numpy(x).to(card))
        assert np.array_equal(y, k1.cpu().numpy())


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


def _perm_cases(n: int, rng):
    """Index vectors of ``n`` slots: name -> perm (negative = don't care)."""
    local = np.argsort(np.arange(n) + rng.integers(-16, 17, n), kind="stable")
    dc = rng.permutation(n)
    dc[rng.random(n) < 0.1] = -1
    return {"identity": np.arange(n), "random": rng.permutation(n),
            "banded RCM-like": local, "repeated": rng.integers(0, n, n),
            "don't care": dc}


#: word types of 1, 2, 4 and 8 bytes
_WORDS = [torch.uint8, torch.int16, torch.float32, torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("word", _WORDS)
@pytest.mark.parametrize("chunk,n", [(1024, 1), (1024, 31), (1024, 1023),
                                     (1024, 1024), (1024, 1025),
                                     (1024, 5 * 1024 + 77),
                                     (16384, 3 * 16384 + 5)])
def test_permute_forms_match_x_perm_on_card(card, word, chunk, n):
    """The direct gather (int32 and int64 indices) and the two-pass gather
    (both passes, chunks of ``chunk`` words: one, several with a ragged
    last one; 16384 words of 4 bytes need 64 KiB of shared memory; each
    pass alone too) against ``x[perm]`` and the plain version, bitwise, on
    identity, random, banded, repeated and don't-care perms (int32 and
    int64 input), each call counted under its form (a two-pass plan
    gathers 8-byte words directly)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(1, 100, n)).to(word).to(card)
    for name, perm in _perm_cases(n, rng).items():
        real = perm >= 0
        want = x[torch.from_numpy(np.where(real, perm, 0)).to(card)]
        want[torch.from_numpy(~real).to(card)] = 0
        for itype in (np.int32, np.int64):
            p = perm.astype(itype)
            two = tperm._plan(p, card, "two_pass", chunk)
            direct = tperm._plan(p, card, "direct", chunk)
            assert (two.method, direct.method) == ("two_pass", "direct")
            wide = dataclasses.replace(direct, perm=direct.perm.long())
            staged = x.element_size() <= 4
            for plan, key in ((two, "permute_two_pass" if staged
                               else "permute"),
                              (direct, "permute"), (wide, "permute")):
                before = tperm.LAUNCHES[key]
                y = tperm.apply_permutation(plan, x)
                torch.cuda.synchronize()
                assert tperm.LAUNCHES[key] == before + 1
                assert torch.equal(y, want), (name, itype, plan.method)
                assert torch.equal(y, tperm.apply_permutation_ref(plan, x))
            if staged:
                before = tperm.LAUNCHES["permute_pass"]
                stage = tperm._one_pass(two, x, 1)
                y = tperm._one_pass(two, stage, 2)
                torch.cuda.synchronize()
                assert tperm.LAUNCHES["permute_pass"] == before + 2
                assert torch.equal(stage, tperm.two_pass_ref(two, x)[0])
                assert torch.equal(y, want), (name, itype, "one pass")


def _batched_cases(n: int, rng):
    """Index vectors for the batched forms: the single gather's cases and
    one of don't-care slots only."""
    return {**_perm_cases(n, rng), "all don't care": np.full(n, -1)}


def _batched_forms(card, perm, chunk):
    """``(plan, launch key)`` of the batched forms on ``perm``: a forced
    two-pass plan, a direct plan with int32 and with int64 indices."""
    two = tperm._plan(perm, card, "two_pass", chunk)
    direct = tperm._plan(perm, card, "direct", chunk)
    wide = dataclasses.replace(direct, perm=direct.perm.long())
    return two, direct, wide


@pytest.mark.cuda
@pytest.mark.parametrize("word", _WORDS)
@pytest.mark.parametrize("chunk,n", [(1024, 1), (1024, 1023),
                                     (1024, 5 * 1024 + 77),
                                     (16384, 3 * 16384 + 5)])
def test_batched_forms_match_x_perm_on_card(card, word, chunk, n):
    """apply_permutation_batched on a two-pass plan (permute_rows_two_pass
    for 1-, 2- and 4-byte words, in groups of two_pass_rows rows; 8-byte
    words take permute_gather_batched) and on a direct plan with int32
    and int64 indices (permute_gather_batched, four rows a thread),
    bitwise X[:, perm], the plain version, index_select (perms without
    don't-care slots) and each other: 1, 3, R + 1 and 40 rows, one chunk
    and ragged chunks, n = 1 and n not a multiple of 4; each call counted
    under its form."""
    rng = np.random.default_rng(n)
    w = torch.empty(0, dtype=word).element_size()
    staged = w <= 4
    R = tperm.two_pass_rows(w) if staged else 1
    for name, perm in _batched_cases(n, rng).items():
        real = perm >= 0
        idx = torch.from_numpy(np.where(real, perm, 0)).to(card)
        forms = _batched_forms(card, perm.astype(np.int32), chunk)
        for nrhs in (1, 3, R + 1, 40):
            X = torch.from_numpy(rng.integers(1, 100, (nrhs, n))).to(
                word).to(card)
            want = X[:, idx]
            want[:, torch.from_numpy(~real).to(card)] = 0
            ys = []
            for plan in forms:
                key = ("permute_batched_two_pass" if plan.method == "two_pass"
                       and staged else "permute_batched")
                before = tperm.LAUNCHES[key]
                y = tperm.apply_permutation_batched(plan, X)
                torch.cuda.synchronize()
                assert tperm.LAUNCHES[key] == before + 1
                assert torch.equal(y, want), (name, nrhs, plan.method)
                assert torch.equal(
                    y, tperm.apply_permutation_batched_ref(plan, X))
                if real.all():
                    assert torch.equal(y, torch.index_select(X, 1, idx))
                ys.append(y)
            assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("word", _WORDS)
def test_batched_direct_groups_on_card(card, word, monkeypatch):
    """permute_gather_batched with groups of 1, 2 and 4 rows (the rows
    a group holds follow BATCH_L2_BYTES, set here so that small rows take
    each), bitwise X[:, perm] on a random and a don't-care perm, n not a
    multiple of 4, 1, 3, 5 and 40 rows."""
    rng = np.random.default_rng(17)
    n = 5 * 1024 + 77
    w = torch.empty(0, dtype=word).element_size()
    for name, perm in _batched_cases(n, rng).items():
        if name not in ("random", "don't care"):
            continue
        real = perm >= 0
        idx = torch.from_numpy(np.where(real, perm, 0)).to(card)
        plan = tperm._plan(perm, card, "direct", 1024)
        for group in (1, 2, 4):
            monkeypatch.setattr(tperm, "BATCH_L2_BYTES", group * n * w)
            assert tperm.direct_rows(n, w) == group
            for nrhs in (1, 3, 5, 40):
                X = torch.from_numpy(rng.integers(1, 100, (nrhs, n))).to(
                    word).to(card)
                want = X[:, idx]
                want[:, torch.from_numpy(~real).to(card)] = 0
                y = tperm.apply_permutation_batched(plan, X)
                torch.cuda.synchronize()
                assert torch.equal(y, want), (name, group, nrhs)


@pytest.mark.cuda
@pytest.mark.parametrize("word", _WORDS)
def test_batched_forms_on_many_rows_on_card(card, word):
    """65,537 rows of a small n (the direct form's groups of rows along
    gridDim.y; the two-pass form's 65,537 / R groups, their counters and a
    stage row a row): both forms bitwise X[:, perm]."""
    rng = np.random.default_rng(3)
    n, nrhs = 37, 65_537
    perm = rng.permutation(n)
    perm[5] = -1
    X = torch.from_numpy(rng.integers(1, 100, (nrhs, n))).to(word).to(card)
    want = X[:, torch.from_numpy(np.where(perm >= 0, perm, 0)).to(card)]
    want[:, 5] = 0
    for plan in _batched_forms(card, perm, 256):
        y = tperm.apply_permutation_batched(plan, X)
        torch.cuda.synchronize()
        assert torch.equal(y, want), plan.method


@pytest.mark.cuda
def test_batched_two_pass_on_a_side_stream_and_in_a_graph_on_card(card):
    """permute_rows_two_pass zeroes its counters on the current stream:
    on a side stream, and captured once in a CUDA graph and replayed
    three times (on new values of X), it gives X[:, perm]."""
    rng = np.random.default_rng(5)
    n = 5 * 1024 + 77
    perm = rng.permutation(n)
    plan = tperm._plan(perm, card, "two_pass", 1024)
    idx = torch.from_numpy(perm).to(card)
    X = torch.rand(9, n, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = tperm.apply_permutation_batched(plan, X)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(y, X[:, idx])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = tperm.apply_permutation_batched(plan, X)
    for seed in range(3):
        X.copy_(torch.rand(9, n, device=card,
                           generator=torch.Generator(device=card).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yg, X[:, idx]), seed


@pytest.mark.cuda
def test_permute_plan_on_card_equals_the_cpu_plan(card):
    """The plan built on the card with torch ops is the plan built on the
    CPU, array for array, and picks the same form."""
    rng = np.random.default_rng(11)
    n = (1 << 21) + 333
    for perm in (rng.permutation(n), np.arange(n)):
        a = tperm.plan_permutation(perm, device=card)
        b = tperm.plan_permutation(perm, device="cpu")
        assert (a.method, a.chunk) == (b.method, b.chunk)
        for f in ("perm", "src_off", "dst_off", "bucket_ptr"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None)
            if va is not None:
                assert torch.equal(va.cpu(), vb), f


def _ell_widths(rng):
    """A matrix whose 32-row slices are 0, 1, ..., 128 slots wide, then an
    empty slice, a slice with a 200-entry row (128 slots and a side COO)
    and 7 rows of a last slice; values ``m * 2**e`` with 12-bit (f32) or
    26-bit (f64) integers ``m``, so that every product is exact and the
    kernel's sums can be emulated in the value type, and x the same."""
    import scipy.sparse as sp

    ncol = 5000
    lens = []
    for w in range(129):
        row = rng.integers(0, w + 1, 32)
        row[rng.integers(0, 32)] = w
        lens += list(row)
    lens += [0] * 32
    lens += [200] + list(rng.integers(0, 40, 31))
    lens += list(rng.integers(0, 14, 7))
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(ncol, k, replace=False) for k in lens])
    m = sp.csr_matrix((np.ones(len(cols)), (rows, cols)),
                      shape=(len(lens), ncol))
    m.sort_indices()
    return m


def _dyadic(rng, k, bits):
    return (rng.integers(1, 2**bits, k) * rng.choice([-1.0, 1.0], k)
            * np.exp2(rng.integers(-20, 21, k)))


def _bf16_rounded(m):
    """``m`` with its values rounded to bf16 as the packs round them."""
    r = m.tocsr().astype(np.float64)
    r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["every width", "two classes",
                                  "powerlaw800.mtx"])
def test_gpr_spmv_bf16_bitwise_plain_on_card(card, name):
    """``gpr_spmv`` on bf16 data (``tsp_gpr_spmv_bf16f32``) bitwise its
    plain version, on the card and on the CPU, over every width class,
    empty classes and rows and hub rows; reproducible, one launch each,
    counted apart; the folded product within 2e-5 of scipy on the
    bf16-rounded matrix."""
    m = _gpr_operand(name)
    A = tgpr.pack_gpr(m, dtype=torch.bfloat16, device=card)
    assert A.data.dtype == torch.bfloat16
    x64 = np.random.default_rng(5).standard_normal(m.shape[1])
    x = torch.tensor(x64, dtype=torch.float32, device=card)
    before = dict(tgpr.LAUNCHES)
    y1, y2 = tgpr.spmv_gpr_rows(A, x), tgpr.spmv_gpr_rows(A, x)
    assert tgpr.LAUNCHES["gpr_bf16"] == before["gpr_bf16"] + 2
    assert tgpr.LAUNCHES["gpr"] == before["gpr"]
    assert torch.equal(y1, y2)
    assert torch.equal(y1, tgpr.spmv_gpr_ref(A, x))
    assert torch.equal(y1.cpu(), tgpr.spmv_gpr_ref(A.to("cpu"), x.cpu()))
    ref = _bf16_rounded(m) @ x.cpu().double().numpy()
    y = tgpr.spmv_gpr(A, x).cpu().double().numpy()
    assert np.max(np.abs(y - ref)) <= 2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
def test_ell_spmv_bf16_bitwise_plain_on_card(card):
    """``ell_spmv`` on bf16 data (``tsp_ell_spmv_bf16f32``) bitwise its
    plain version, on the card and on the CPU: slices 0 to 128 slots wide
    (every remainder of the slot batch), an empty slice, a ragged last
    slice and a side COO; reproducible, counted apart; the full product
    within 2e-5 of scipy on the bf16-rounded matrix."""
    rng = np.random.default_rng(13)
    m = _ell_widths(rng)
    m.data = rng.standard_normal(m.nnz)
    A = tell.pack_ell(m, dtype=torch.bfloat16, device=card)
    assert A.vals.dtype == A.side.data.dtype == torch.bfloat16
    assert A.side.nnz > 0
    x = torch.tensor(rng.standard_normal(m.shape[1]), dtype=torch.float32,
                     device=card)
    before = dict(tell.LAUNCHES)
    y1, y2 = tell.spmv_ell_main(A, x), tell.spmv_ell_main(A, x)
    assert tell.LAUNCHES["ell_bf16"] == before["ell_bf16"] + 2
    assert tell.LAUNCHES["ell"] == before["ell"]
    assert torch.equal(y1, y2)
    assert torch.equal(y1, tell.spmv_ell_packed_ref(A, x))
    assert torch.equal(y1.cpu(), tell.spmv_ell_packed_ref(A.to("cpu"),
                                                          x.cpu()))
    ref = _bf16_rounded(m) @ x.cpu().double().numpy()
    full = tell.spmv_ell_packed(A, x).cpu().double().numpy()
    assert np.max(np.abs(full - ref)) <= 2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmv_sums_its_slots_in_order_on_card(card, dtype):
    """ell_spmv bitwise against its slots summed in order, slot 0 to the
    slice's width - 1, emulated on the host from the pack's own arrays
    (exact products: the FMA rounds only the sum, as the emulation's add
    does): widths 0 to MAX_WIDTH (every remainder of the slot batch), an
    empty slice, nrow not a multiple of 32, and the side COO's row; the
    full product against scipy."""
    rng = np.random.default_rng(12)
    bits, npt = ((12, np.float32) if dtype == torch.float32
                 else (26, np.float64))
    m = _ell_widths(rng)
    assert m.shape[0] % 32 and m.getnnz(axis=1).max() > tell.MAX_WIDTH
    m.data = _dyadic(rng, m.nnz, bits)
    x64 = _dyadic(rng, m.shape[1], bits)
    A = tell.pack_ell(m, dtype=dtype, device=card)
    widths = np.diff(A.slice_ptr.cpu().numpy()) // 32
    assert set(range(tell.MAX_WIDTH + 1)) <= set(widths.tolist())
    assert A.side.nnz > 0
    x = torch.tensor(x64, dtype=dtype, device=card)
    y = tell.spmv_ell_main(A, x)
    # the emulation: row r of slice s adds slot j at slice_ptr[s] + 32 j + r
    vals, cols = A.vals.cpu().numpy(), A.cols.cpu().numpy()
    ptr, xh = A.slice_ptr.cpu().numpy(), x.cpu().numpy()
    nrow = m.shape[0]
    r = np.arange(nrow)
    base, w = ptr[r // 32] + r % 32, widths[r // 32]
    acc = np.zeros(nrow, dtype=npt)
    for j in range(int(widths.max())):
        at = np.where(j < w, base + 32 * j, 0)
        term = np.where(j < w, vals[at] * xh[cols[at]], 0).astype(npt)
        acc = (acc + term).astype(npt)
    assert np.array_equal(y.cpu().numpy(), acc)
    assert torch.equal(y, tell.spmv_ell_main(A, x))
    full = tell.spmv_ell_packed(A, x).cpu().double().numpy()
    ref = m @ x64
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    assert np.max(np.abs(full - ref)) <= gate * np.max(np.abs(ref))


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
    """ro(x) launches the gather twice and K1 once, and matches scipy: on
    a small shuffled band (the direct gather) and on one of 2**21 + 4097
    rows (the planned two-pass gather)."""
    for n, key in ((5000, "permute"), ((1 << 21) + 4097, "permute_two_pass")):
        band = utils.banded(n, 4, seed=9)
        p = np.random.default_rng(9).permutation(n)
        shuffled = band[p][:, p].tocsr()
        ro = reorder_plan(shuffled, dtype=torch.float32, device=card)
        assert ro.strategy == "rcm+dia_stream" and ro.bandwidth_after == 4
        x64 = np.random.default_rng(10).random(n)
        before = (tperm.LAUNCHES[key], tds.LAUNCHES["sdia"])
        y = ro(torch.tensor(x64, dtype=torch.float32, device=card))
        assert (tperm.LAUNCHES[key], tds.LAUNCHES["sdia"]) == \
            (before[0] + 2, before[1] + 1)
        ref = shuffled @ x64
        assert np.max(np.abs(y.cpu().double().numpy() - ref)) <= \
            2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(card):
    """copy_scale, launch_probe, segsum8 and every tile_permute variant
    bitwise against their plain versions, each launch counted."""
    from tpu_spmv_torch.bench import probes as pr

    x = torch.rand((1 << 20) + 3, device=card)
    tile = torch.rand(pr.Q, pr.Q, device=card)
    v = torch.from_numpy(pr.t2_operand()).to(card)
    odd = x[1:1 + 64 * pr.Q].view(64, pr.Q)     # 4 bytes past alignment
    for kern, plain, arg, key in (
            (pr.copy_scale, pr.copy_scale_ref, x, "copy_scale"),
            (pr.copy_scale, pr.copy_scale_ref, x[1:], "copy_scale"),
            (pr.launch_probe, pr.launch_probe_ref, tile, "launch_probe"),
            (pr.segsum8, pr.segsum8_ref, v, "segsum8"),
            (pr.segsum8, pr.segsum8_ref, odd, "segsum8")):
        before = pr.LAUNCHES[key]
        assert torch.equal(kern(arg), plain(arg))
        assert pr.LAUNCHES[key] == before + 1
    for name, (prog, src, mul, psum8) in pr.tile_variants(
            pr.t3_operands(), pr.t4_operands(T=4), card).items():
        before = pr.LAUNCHES["tile_permute"]
        got = pr.tile_permute(prog, src, mul, psum8)
        assert pr.LAUNCHES["tile_permute"] == before + 1
        assert torch.equal(got, pr.tile_permute_ref(prog, src, mul, psum8)), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell", "bsr", "bdia"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_formats_on_card(card, fmt, dtype):
    """ELL, BSR and BDIA SpMV and SpMM (1, 3 and 32 RHS) on the card
    against the same products on the CPU; bitwise reproducible."""
    from tpu_spmv_torch.ops import spmm as t_spmm

    m = utils.block_laplacian(12, bs=8, seed=3)
    rng = np.random.default_rng(11)
    A = convert(COO.from_scipy(m, dtype=dtype), fmt)
    Ac = A.to(card)
    x = torch.tensor(rng.standard_normal(m.shape[1]), dtype=dtype)
    y1, y2 = spmv(Ac, x.to(card)), spmv(Ac, x.to(card))
    assert y1.is_cuda and torch.equal(y1, y2)
    assert _rel(y1.cpu(), spmv(A, x)) <= TOL[dtype]
    for nrhs in (1, 3, 32):
        X = torch.tensor(rng.standard_normal((m.shape[1], nrhs)), dtype=dtype)
        Y = t_spmm(Ac, X.to(card))
        assert torch.equal(Y, t_spmm(Ac, X.to(card)))
        assert _rel(Y.cpu(), t_spmm(A, X)) <= TOL[dtype]


@pytest.mark.cuda
def test_block_products_ignore_tf32(card):
    """With torch's TF32 matmul flag on, float32 spmv_bdia and spmv_bsr on
    standard-normal blocks stay within 2e-5 of scipy and bitwise equal to
    the run with the flag off (no product goes through a matmul)."""
    m = utils.block_laplacian(16, bs=8, seed=4)
    x64 = np.random.default_rng(12).standard_normal(m.shape[1])
    x = torch.tensor(x64, dtype=torch.float32, device=card)
    ref = m @ x64
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for fmt in ("bdia", "bsr"):
            A = convert(COO.from_scipy(m, dtype=torch.float32, device=card),
                        fmt)
            torch.backends.cuda.matmul.allow_tf32 = False
            off = spmv(A, x)
            torch.backends.cuda.matmul.allow_tf32 = True
            on = spmv(A, x)
            assert torch.equal(on, off), fmt
            assert np.max(np.abs(on.cpu().double().numpy() - ref)) <= \
                2e-5 * np.max(np.abs(ref)), fmt
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _launch_cases(card):
    """T1, T2, K2, ``gpr_spmv``, ``permute_gather`` (both forms) and K3b
    on small operands: name -> (input, kernel, plain version, launch
    counter, key, bitwise)."""
    from tpu_spmv_torch.bench import probes as pr

    rng = np.random.default_rng(13)
    dia = convert(COO.from_scipy(utils.laplacian_2d(32), dtype=torch.float32,
                                 device=card), "dia")
    P = tds.pack_psdia(dia, period=32)
    P8 = tds.pack_psdia(dia, period=32, nrhs=8)
    G = tgpr.pack_gpr(utils.power_law(3000, 3000, 12, seed=2),
                      dtype=torch.float32, device=card)
    plan = tperm.plan_permutation(rng.permutation(60_013), device=card)
    two = tperm._plan(rng.permutation(60_013), card, "two_pass", 1024)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card)

    return {
        "launch_probe": (dev(rng.random((pr.Q, pr.Q))), pr.launch_probe,
                         pr.launch_probe_ref, pr.LAUNCHES, "launch_probe",
                         True),
        "segsum8": (dev(rng.random((16, 64, pr.Q))), pr.segsum8,
                    pr.segsum8_ref, pr.LAUNCHES, "segsum8", True),
        "psdia_spmv": (tds.pad_x(P, dev(rng.random(dia.shape[0]))),
                       lambda v: tds.spmv_psdia_padded(P, v),
                       lambda v: tds.spmv_psdia_padded_ref(P, v),
                       tds.LAUNCHES, "psdia", False),
        "gpr_spmv": (dev(rng.random(3000)), lambda v: tgpr.spmv_gpr_rows(G, v),
                     lambda v: tgpr.spmv_gpr_ref(G, v), tgpr.LAUNCHES, "gpr",
                     False),
        "psdia_spmm": (torch.nn.functional.pad(
                           dev(rng.random((8, dia.shape[0]))),
                           (P8.L, P8.npad - P8.L - dia.shape[0])),
                       lambda v: tds.spmm_psdia_padded_t(P8, v),
                       lambda v: tds.spmm_psdia_padded_t_ref(P8, v),
                       tds.LAUNCHES, "psdia_spmm", False),
        "permute_gather": (dev(rng.random(60_013)),
                           lambda v: tperm.apply_permutation(plan, v),
                           lambda v: tperm.apply_permutation_ref(plan, v),
                           tperm.LAUNCHES, "permute", True),
        "permute_two_pass": (dev(rng.random(60_013)),
                             lambda v: tperm.apply_permutation(two, v),
                             lambda v: tperm.apply_permutation_ref(two, v),
                             tperm.LAUNCHES, "permute_two_pass", True),
    }


_LAUNCH_NAMES = ["launch_probe", "segsum8", "psdia_spmv", "gpr_spmv",
                 "permute_gather", "permute_two_pass", "psdia_spmm"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _LAUNCH_NAMES)
def test_launch_goes_to_the_current_side_stream(card, name):
    """On a side stream, after a producer kernel held back by a spin on
    that stream: the kernel reads what the producer wrote (a launch on any
    other stream would run first and read garbage) and equals its plain
    version and its launch on the default stream."""
    x, kern, plain, launches, key, bitwise = _launch_cases(card)[name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = launches[key]
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)       # ~10 ms of device time
        v = x * 2.0                         # the producer
        y = kern(v)
    torch.cuda.current_stream().wait_stream(side)
    assert launches[key] == before + 1
    want = plain(x * 2.0)
    torch.cuda.synchronize()
    if bitwise:
        assert torch.equal(y, want)
    else:
        assert _rel(y, want) <= TOL[torch.float32]
    assert torch.equal(y, kern(x * 2.0))


@pytest.mark.cuda
def test_launches_replay_from_one_cuda_graph(card):
    """The seven kernels captured in one CUDA graph: each wrapper call is
    counted once at capture (a replay is no launch of the wrapper), and
    every replay equals the eager results bitwise, also after the inputs
    change in place."""
    cases = _launch_cases(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        for x, kern, *_ in cases.values():
            kern(x)
    torch.cuda.current_stream().wait_stream(side)
    before = {n: c[3][c[4]] for n, c in cases.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = {n: c[1](c[0]) for n, c in cases.items()}
    for n, c in cases.items():
        assert c[3][c[4]] == before[n] + 1, n
    for scale in (1.0, 0.5):
        for c in cases.values():
            c[0].mul_(scale)
        for out in outs.values():
            out.zero_()
        graph.replay()
        eager = {n: c[1](c[0]) for n, c in cases.items()}
        torch.cuda.synchronize()
        for n in cases:
            assert torch.equal(outs[n], eager[n]), n
    for n, c in cases.items():
        assert c[3][c[4]] == before[n] + 3, n      # capture + two eager


@pytest.mark.cuda
def test_launch_switches_to_the_tensors_card(card):
    """A tensor on a card that is not the current one launches on its own
    card, and the current device stays as it was."""
    from tpu_spmv_torch.bench import probes as pr

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    tile = torch.rand(pr.Q, pr.Q, device=other)
    v = torch.rand(4, pr.Q, device=other)
    assert torch.cuda.current_device() == 0
    y, s = pr.launch_probe(tile), pr.segsum8(v)
    assert torch.cuda.current_device() == 0
    assert y.device == other and torch.equal(y, tile)
    assert torch.equal(s, pr.segsum8_ref(v))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["laplacian_2d(48)", "banded(50000,5)",
                                  "banded(70001,40)"])
def test_k1_bf16_data_matches_plain_on_card(card, name):
    """K1 on bf16 coefficients against float32 x: within 1e-6 of its plain
    version (the data widened), bitwise reproducible, pads zero, counted
    apart from K1 f32; K2 on the pack's bf16 pattern (widened once) for
    the Poisson; bf16 data against a float64 x refused."""
    m = (utils.laplacian_2d(48) if name.startswith("laplacian")
         else utils.banded(*map(int, name[7:-1].split(",")), seed=6))
    dia = convert(COO.from_scipy(m, dtype=torch.float32, device=card), "dia")
    A = tds.pack_sdia(dia, data_dtype=torch.bfloat16)
    assert A.data.dtype == torch.bfloat16
    x = torch.tensor(np.random.default_rng(4).random(m.shape[0]),
                     dtype=torch.float32, device=card)
    xp = tds.pad_x(A, x)
    before = dict(tds.LAUNCHES)
    y1, y2 = tds.spmv_sdia_padded(A, xp), tds.spmv_sdia_padded(A, xp)
    assert tds.LAUNCHES["sdia_bf16"] == before["sdia_bf16"] + 2
    assert tds.LAUNCHES["sdia"] == before["sdia"]
    assert y1.dtype == torch.float32 and torch.equal(y1, y2)
    assert bool((y1[:A.L] == 0).all() and (y1[A.L + m.shape[0]:] == 0).all())
    plain = tds.spmv_sdia_padded_ref(
        dataclasses.replace(A, data=A.data.float()), xp)
    assert _rel(y1, plain) <= 1e-6
    with pytest.raises(TypeError, match="bfloat16"):
        tds.spmv_sdia_padded(A, xp.double())
    if name.startswith("laplacian"):
        P = tds.pack_psdia(dia, period=48, data_dtype=torch.bfloat16)
        yp = tds.spmv_psdia_padded(P, tds.pad_x(P, x))
        assert _rel(yp, tds.spmv_psdia_padded_ref(P, tds.pad_x(P, x))) \
            <= 1e-6


@pytest.mark.cuda
def test_solvers_on_card(card):
    """The solver path on the card: ir_solve with a bf16 SDIA low plan
    (K1 bf16) and a bf16 PSDIA low plan (K2), BiCGSTAB, GMRES, multicolor
    SOR and MG-PCG on the screened 64 x 64 Poisson, each to a true
    residual <= 1e-5 against scipy; GMRES's own flag reads True (it
    restarts while its true residual is above tol and falls)."""
    import scipy.sparse as sp

    from tpu_spmv_torch import solvers as T
    from tpu_spmv_torch.ops.auto import plan_from_matrix

    m = (utils.laplacian_2d(64) + sp.identity(64 * 64)).tocsr()
    b64 = np.random.default_rng(8).random(m.shape[0])
    b = torch.tensor(b64, dtype=torch.float32, device=card)
    hi = plan_spmv(m, dtype=torch.float32, device=card)
    lo = plan_spmv(m, dtype=torch.bfloat16, device=card)
    dia = convert(COO.from_scipy(m, dtype=torch.float32, device=card), "dia")
    hi_s = plan_from_matrix(tds.pack_sdia(dia), "dia_stream")
    lo_s = plan_from_matrix(tds.pack_sdia(dia, data_dtype=torch.bfloat16),
                            "dia_stream")

    def true_rel(x):
        x = x.cpu().double().numpy()
        return np.linalg.norm(b64 - m @ x) / np.linalg.norm(b64)

    before = tds.LAUNCHES["sdia_bf16"]
    assert true_rel(T.ir_solve(hi_s, b, low=lo_s, inner_iters=20,
                               tol=1e-6).x) <= 1e-5
    assert tds.LAUNCHES["sdia_bf16"] > before
    assert true_rel(T.ir_solve(hi, b, low=lo, inner_iters=20,
                               tol=1e-6).x) <= 1e-5
    assert bool(T.gmres(hi, b, tol=1e-6).converged)
    for res in (T.bicgstab(hi, b, tol=1e-6), T.gmres(hi, b, tol=1e-6),
                T.sor(hi, b, host_mat=m, tol=1e-6),
                T.cg(hi, b, tol=1e-6,
                     precond=T.mg_preconditioner((64, 64), shift=1.0))):
        assert true_rel(res.x) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 3, 32, 40])
@pytest.mark.parametrize("name", _SDIA_SPMM_OPERANDS)
def test_sdia_spmm_bf16_bitwise_plain_and_k1_on_card(card, nrhs, name):
    """K3a on bf16 data (``tsp_sdia_spmm_bf16f32``) on its walks, the
    plan's and the cluster walk, on K3a's operands: tiles whose windows
    cross the pads (the first tile's left of L, the last one's past npad),
    an odd npad and L (one-value loads of the data rows), Xt aligned and
    not: bitwise its plain version (an exact fma a diagonal), reproducible,
    rows outside [L, L + nrow) zero, every column bitwise K1 bf16 on the
    same pack, counted apart; within 2e-5 of scipy on the rounded
    matrix."""
    m, rb = {"laplacian_2d(40)": (utils.laplacian_2d(40), None),
             "laplacian_2d(40), rb 87": (utils.laplacian_2d(40), 87),
             "laplacian_2d(128)": (utils.laplacian_2d(128), None),
             "laplacian_2d(300, 101)": (utils.laplacian_2d(300, 101), None),
             "laplacian_3d(10)": (utils.laplacian_3d(10), None),
             "band of 301 diagonals": (_toeplitz_band(1500, 150), None)}[name]
    m = m.astype(np.float64)
    m.data = np.random.default_rng(3).standard_normal(m.nnz)
    dia = convert(COO.from_scipy(m, dtype=torch.float32), "dia")
    A = tds.pack_sdia(dia, rb=rb, nrhs=nrhs, device=card,
                      data_dtype=torch.bfloat16)
    assert A.data.dtype == torch.bfloat16
    n = m.shape[0]
    X = torch.tensor(np.random.default_rng(nrhs).random((nrhs, n)),
                     dtype=torch.float32, device=card)
    clusters = tds._cluster_walk(A.offsets, nrhs, 4)
    for shift in (0, 1):
        buf = torch.zeros(nrhs * A.npad + 1, device=card)
        Xt = buf[shift:shift + nrhs * A.npad].view(nrhs, A.npad)
        Xt[:, A.L:A.L + n] = X
        before = dict(tds.LAUNCHES)
        Y1, Y2 = tds.spmm_sdia_padded_t(A, Xt), tds.spmm_sdia_padded_t(A, Xt)
        Yc = tds._spmm_launch(A, Xt, clusters)
        assert tds.LAUNCHES["sdia_spmm_bf16"] == before["sdia_spmm_bf16"] + 3
        assert tds.LAUNCHES["sdia_spmm"] == before["sdia_spmm"]
        assert Y1.dtype == torch.float32
        assert torch.equal(Y1, Y2) and torch.equal(Y1, Yc)
        assert bool((Y1[:, :A.L] == 0).all() and (Y1[:, A.L + n:] == 0).all())
        assert torch.equal(Y1, tds.spmm_sdia_padded_t_ref(A, Xt))
        for q in range(nrhs):
            assert torch.equal(Y1[q], tds.spmv_sdia_padded(
                A, Xt[q].contiguous())), q
    ref = _bf16_rounded(m) @ X.cpu().double().numpy().T
    Y = Y1[:, A.L:A.L + n].T.cpu().double().numpy()
    assert np.max(np.abs(Y - ref)) <= 2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 2, 3, 8, 32, 40])
@pytest.mark.parametrize("name", ["every width", "two classes",
                                  "powerlaw800.mtx"])
def test_gpr_spmm_bf16_bitwise_plain_on_card(card, nrhs, name):
    """``gpr_spmm`` on bf16 data (``tsp_gpr_spmm_bf16f32``) on every width
    class, empty classes and rows and hub rows, at 1 to 40 RHS (one RHS a
    lane on 2 and 4 lanes, 2 and 4 RHS a lane), X 16-byte aligned and not
    (one RHS a lane): bitwise its plain version on the card and on the
    CPU, reproducible, counted apart; the folded product within 2e-5 of
    scipy on the bf16-rounded matrix."""
    m = _gpr_operand(name)
    A = tgpr.pack_gpr(m, dtype=torch.bfloat16, device=card)
    X64 = np.random.default_rng(nrhs).standard_normal((m.shape[1], nrhs))
    X = torch.tensor(X64, dtype=torch.float32, device=card)
    buf = torch.empty(X.numel() + 1, device=card)
    Xs = buf[1:].view(X.shape)
    Xs.copy_(X)
    before = dict(tgpr.LAUNCHES)
    Y1, Y2, Ys = (tgpr.spmm_gpr_rows(A, X), tgpr.spmm_gpr_rows(A, X),
                  tgpr.spmm_gpr_rows(A, Xs))
    assert tgpr.LAUNCHES["gpr_spmm_bf16"] == before["gpr_spmm_bf16"] + 3
    assert tgpr.LAUNCHES["gpr_spmm"] == before["gpr_spmm"]
    assert torch.equal(Y1, Y2) and torch.equal(Y1, Ys)
    assert torch.equal(Y1, tgpr.spmm_gpr_ref(A, X))
    assert torch.equal(Y1.cpu(), tgpr.spmm_gpr_ref(A.to("cpu"), X.cpu()))
    ref = _bf16_rounded(m) @ X64.astype(np.float32).astype(np.float64)
    Y = tgpr.spmm_gpr(A, X).cpu().double().numpy()
    assert np.max(np.abs(Y - ref)) <= 2e-5 * np.max(np.abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 2, 3, 32, 40])
def test_ell_spmm_bf16_bitwise_plain_and_ell_spmv_on_card(card, nrhs):
    """``ell_spmm`` on bf16 data (``tsp_ell_spmm_bf16f32``) on slices 0 to
    128 slots wide, an empty slice, a ragged last slice and a side COO, X
    aligned and not: bitwise its plain version on the card and on the CPU,
    reproducible, every column bitwise ``ell_spmv`` bf16's, counted apart;
    the full product within 2e-5 of scipy on the bf16-rounded matrix."""
    rng = np.random.default_rng(13)
    m = _ell_widths(rng)
    m.data = rng.standard_normal(m.nnz)
    A = tell.pack_ell(m, dtype=torch.bfloat16, device=card)
    X64 = rng.standard_normal((m.shape[1], nrhs))
    for shift in (0, 1):
        buf = torch.zeros(X64.size + 1, device=card)
        X = buf[shift:shift + X64.size].view(X64.shape)
        X.copy_(torch.from_numpy(X64))
        before = dict(tell.LAUNCHES)
        Y1, Y2 = tell.spmm_ell_main(A, X), tell.spmm_ell_main(A, X)
        assert tell.LAUNCHES["ell_spmm_bf16"] == before["ell_spmm_bf16"] + 2
        assert tell.LAUNCHES["ell_spmm"] == before["ell_spmm"]
        assert torch.equal(Y1, Y2)
        assert torch.equal(Y1, tell.spmm_ell_packed_ref(A, X))
        assert torch.equal(Y1.cpu(), tell.spmm_ell_packed_ref(A.to("cpu"),
                                                              X.cpu()))
        for q in range(nrhs):
            assert torch.equal(Y1[:, q], tell.spmv_ell_main(
                A, X[:, q].contiguous())), q
    ref = _bf16_rounded(m) @ X.cpu().double().numpy()
    Y = tell.spmm_ell_packed(A, X).cpu().double().numpy()
    assert np.max(np.abs(Y - ref)) <= 2e-5 * np.max(np.abs(ref))


#: K8a's split on SDIA packs (rows per shard a multiple of the tile rb):
#: (matrix, rb); "no interior" has none at 4 shards (256 rows, a band of
#: 500), "one row" one row there, "band" 15 diagonals
_SDIA_SPLITS = {
    "band": (lambda: utils.banded(5000, 7, seed=2), 512),
    "no interior": (lambda: _diagonals(600, (-250, 0, 250), 1), 256),
    "one row": (lambda: _diagonals(600, (-127, 0, 128), 1), 256),
    "offsets >= 0": (lambda: _diagonals(1000, (0, 3, 40), 1), 256),
    "offsets <= 0": (lambda: _diagonals(1000, (-40, -3, 0), 1), 256),
    "main diagonal": (lambda: _diagonals(1000, (0,), 1), 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(_SDIA_SPLITS))
def test_sdia_ring_bf16_bitwise_plain_and_k1_on_card(card, name, ndev):
    """K8a on bf16 data (``tsp_sdia_ring_bf16f32``) with ``ndev`` shards on
    one card, on random values: each shard bitwise its plain version and
    reproducible, the concatenated shards bitwise K1 bf16 on the same
    pack, counted apart; on the band, K8b on the bf16 pattern of the
    Poisson (widened once) bitwise K8b on the float32 pattern of the same
    values."""
    make, rb = _SDIA_SPLITS[name]
    m = make()
    dia = convert(COO.from_scipy(m, dtype=torch.float32), "dia")
    S = tds.pack_sdia(dia, rb=rb, device=card, data_dtype=torch.bfloat16)
    A = dist.ShardedSDIA.build(S, ndev)
    mesh = dist.make_mesh(ndev, device="cuda:0")    # all shards on one card
    x = torch.tensor(np.random.default_rng(ndev).random(m.shape[0]),
                     dtype=torch.float32, device=card)
    xp = tds.pad_x(S, x)
    xs = A.shard_xpad(xp)
    before = dict(tdst.LAUNCHES)
    y, y2 = dist.spmv_sdia_sharded(mesh, A, xs), dist.spmv_sdia_sharded(
        mesh, A, xs)
    assert tdst.LAUNCHES["sdia_ring_bf16"] == \
        before["sdia_ring_bf16"] + 2 * ndev
    assert tdst.LAUNCHES["sdia_ring"] == before["sdia_ring"]
    for s, (left, right) in enumerate(_ring_slivers(xs, A.halo)):
        assert torch.equal(y.chunks[s], y2.chunks[s]), s
        assert torch.equal(y.chunks[s], tdst.spmv_sdia_ring_ref(
            A.data[s], A.offsets, xs.chunks[s], left, right)), s
    assert torch.equal(torch.cat(y.chunks)[:S.npad],
                       tds.spmv_sdia_padded(S, xp))
    if name != "band":
        return
    lap = utils.laplacian_2d(64)
    ldia = convert(COO.from_scipy(lap, dtype=torch.float32), "dia")
    P16 = tds.pack_psdia(ldia, period=64, rb=512, device=card,
                         data_dtype=torch.bfloat16)
    P32 = dataclasses.replace(P16, pattern=P16.pattern.float())
    xl = tds.pad_x(P16, torch.rand(lap.shape[0], device=card))
    ys = [dist.spmv_psdia_sharded(mesh, B, B.shard_xpad(xl))
          for B in (dist.ShardedPSDIA.build(P, ndev) for P in (P16, P32))]
    assert all(torch.equal(a, b) for a, b in zip(ys[0].chunks, ys[1].chunks))


def _ring_slivers(x, h):
    """Each shard's (left, right) slivers: the tail of the previous
    chunk and the head of the next one (ring order)."""
    n = x.ndev
    return [(x.chunks[(s - 1) % n][-h:], x.chunks[(s + 1) % n][:h])
            for s in range(n)]


def _arms_bf16():
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    n, off = 300_000, 140_000
    perm = np.random.default_rng(3).permutation(40 * 40)
    return {"pdia_stream": utils.laplacian_2d(48),
            "dia_stream": utils.banded(6000, 5, seed=1),
            "gpr": utils.power_law(3000, 3000, 8, seed=1),
            "pallas_ell": utils.laplacian_2d(40)[perm][:, perm].tocsr(),
            "dia": sp.diags([rng.standard_normal(n - off),
                             rng.standard_normal(n),
                             rng.standard_normal(n - off)], [-off, 0, off],
                            shape=(n, n), format="csr"),
            "bdia": utils.block_laplacian(6, bs=8, seed=0),
            "csr": sp.csr_matrix((500, 500))}


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["pdia_stream", "dia_stream", "gpr",
                                      "pallas_ell", "dia", "bdia", "csr"])
def test_bf16_plan_spmm_on_card(card, strategy):
    """``plan_spmv(dtype=bfloat16).spmm(X)`` with a float32 X on every arm
    on the card: float32 out, within 2e-5 of scipy on the bf16-rounded
    matrix; bitwise the CPU plan's (the plain versions) on the bf16-data
    forms (K3a, ``gpr_spmm``, ``ell_spmm``), within 1e-6 of it elsewhere
    (K3b on the widened pattern, torch code); ``cg_multi`` with float32 B
    on the Poisson's bf16 plan; a float64 X refused by every kernel."""
    m = _arms_bf16()[strategy].astype(np.float32).tocsr()
    plan = plan_spmv(m, dtype=torch.bfloat16, device=card)
    cpu = plan_spmv(m, dtype=torch.bfloat16, device="cpu")
    assert plan.strategy == cpu.strategy == strategy
    X64 = np.random.default_rng(9).random((m.shape[1], 8))
    X = torch.tensor(X64, dtype=torch.float32, device=card)
    Y = plan.spmm(X)
    Yc = cpu.spmm(X.cpu())
    assert Y.dtype == torch.float32 and Y.is_cuda
    if strategy in ("dia_stream", "gpr", "pallas_ell"):
        assert torch.equal(Y.cpu(), Yc)
    elif strategy != "csr":
        assert _rel(Y.cpu(), Yc) <= 1e-6
    ref = _bf16_rounded(m) @ X64.astype(np.float32).astype(np.float64)
    assert np.max(np.abs(Y.cpu().double().numpy() - ref)) <= \
        2e-5 * max(np.max(np.abs(ref)), 1e-300)
    if strategy in ("pdia_stream", "dia_stream", "gpr", "pallas_ell"):
        with pytest.raises(TypeError, match="bfloat16"):
            plan.spmm(X.double())
    if strategy == "pdia_stream":
        from tpu_spmv_torch.solvers import cg_multi

        B = torch.tensor(np.random.default_rng(2).random((m.shape[0], 4)),
                         dtype=torch.float32, device=card)
        res = cg_multi(plan, B, tol=1e-5, maxiter=2000)
        assert bool(res.converged.all()) and res.x.dtype == torch.float32


def _dist_on(device, fn):
    """``fn(mesh)`` on a 4-shard mesh whose shards all lie on ``device``."""
    return fn(dist.make_mesh(4, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dist_gmres", "dist_bicgstab"])
def test_dist_krylov_on_card_matches_cpu(card, solver):
    """``dist_gmres`` (restart 30) and ``dist_bicgstab`` with a sharded
    Jacobi over NeighborCSR at 4 shards on ``cuda:0``, float32, against
    the same call on the CPU: both converged, x within 1e-5 (tol 1e-6 on
    an operand of condition about 5)."""
    import scipy.sparse as sp

    from tpu_spmv_torch import solvers as T
    from tpu_spmv_torch.bench.dist_bench import sharded_jacobi

    lap = utils.laplacian_2d(48)
    n = lap.shape[0]
    P = sp.random(n, n, density=2 / n, random_state=7, format="csr")
    m = (lap + 0.5 * (P - P.T) + 2.0 * sp.eye(n)).tocsr().astype(np.float32)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    kw = {"restart": 30} if solver == "dist_gmres" else {}

    def run(mesh):
        A = dist.place(dist.NeighborCSR.build(m, 4, square=True), mesh)
        bs = dist.place(dist.ShardedVector.from_global(b, A.row_plan), mesh)
        dinv = dist.place(dist.ShardedVector.from_global(
            1.0 / m.diagonal(), A.row_plan), mesh)
        return getattr(T, solver)(mesh, A, bs, tol=1e-6, maxiter=1000,
                                  precond=sharded_jacobi(dinv), **kw)

    on_card, on_cpu = _dist_on("cuda:0", run), _dist_on("cpu", run)
    assert on_card.x.chunks[0].is_cuda
    assert bool(on_card.converged) and bool(on_cpu.converged)
    x, xc = on_card.x.to_global(), on_cpu.x.to_global()
    assert np.max(np.abs(x - xc)) <= 1e-5 * np.max(np.abs(xc))


@pytest.mark.cuda
def test_dist_vcycle_on_card_matches_cpu(card):
    """``dist_mg_preconditioner`` at 4 shards on ``cuda:0`` (two sharded
    levels, then the tail on shard 0) against the same V-cycle on the CPU,
    float32, within 1e-5; and ``dist_cg`` with it converges on the card."""
    from tpu_spmv_torch import solvers as T

    g = 128
    r = np.random.default_rng(6).standard_normal(g * g).astype(np.float32)
    plan = dist.plan_uniform(g * g, 4)

    def vcycle(mesh):
        rs = dist.place(dist.ShardedVector.from_global(r, plan), mesh)
        return T.dist_mg_preconditioner(mesh, (g, g))(rs)

    z, zc = _dist_on("cuda:0", vcycle), _dist_on("cpu", vcycle)
    assert z.chunks[3].is_cuda
    zg, zcg = z.to_global(), zc.to_global()
    assert np.max(np.abs(zg - zcg)) <= 1e-5 * np.max(np.abs(zcg))
    mesh = dist.make_mesh(4, device="cuda:0")
    lap = utils.laplacian_2d(g).astype(np.float32)
    A = dist.place(dist.NeighborCSR.build(lap, 4, balance="rows",
                                          square=True), mesh)
    bs = dist.place(dist.ShardedVector.from_global(r, A.row_plan), mesh)
    res = T.dist_cg(mesh, A, bs, tol=1e-5, maxiter=100,
                    precond=T.dist_mg_preconditioner(mesh, (g, g)))
    assert bool(res.converged) and res.iterations < 30
