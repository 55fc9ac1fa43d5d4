"""Host-side plans of the port's hand-written kernels, on the CPU.

K3a and K3b (``sdia_spmm`` and ``psdia_spmm``, one body in
``tpu_spmv_torch/csrc/dia_stream.cu``) stage one window of ``Xt`` per
cluster of nearby diagonal offsets in shared memory, or one a tile along
the stride walk, with the tile's coefficient rows (K3b's pattern at ``k
mod rb``, K3a's SDIA data rows at ``k``); :func:`psdia_spmm_plan` picks
the tile, the clusters and the windows on the host.  These tests hold the
plan to what the kernel relies on (every read ``k + off_d`` of every row
of a tile inside its cluster's window, 16-byte window edges, the
shared-memory budget), for the 2-D and 3-D Poisson, a wide band and
random offset sets, and run a numpy emulation of the kernel's tiling on
PSDIA and SDIA packs against the plain versions (and, on one SDIA pack,
the JAX package's K3a in interpret mode).  ``gpr_spmv``
(``csrc/general.cu``) keeps its lane table in the kernel; the pack's
width classes that the table relies on are checked here too.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpu_spmv as ts
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import COO, convert, utils
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import gpr as tgpr

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _check_plan(offsets, nrhs, itemsize, plan=None):
    """The invariants the kernel relies on; returns the plan (by default
    :func:`psdia_spmm_plan`'s)."""
    if plan is None:
        plan = tds.psdia_spmm_plan(tuple(offsets), nrhs, itemsize)
    vec = 16 // itemsize
    # the thread tile: kSpmmRows x kSpmmRhs outputs of 256 threads
    assert plan.qt in (1, 2, 4, 8)
    assert plan.tk == 4 * 256 // plan.qt and plan.qcap == 4 * plan.qt
    assert plan.nchunks * plan.qcap >= nrhs > (plan.nchunks - 1) * plan.qcap
    # the clusters partition the diagonals into runs, in stored order
    assert plan.starts[0] == 0 and plan.starts[-1] == len(offsets)
    assert all(a < b for a, b in zip(plan.starts, plan.starts[1:]))
    assert len(plan.a0) == len(plan.width) == plan.nclusters
    nq = min(nrhs, plan.qcap)
    for c in range(plan.nclusters):
        d0, d1 = plan.starts[c], plan.starts[c + 1]
        a0, w = plan.a0[c], plan.width[c]
        # 16-byte edges for the kernel's copies
        assert a0 % vec == 0 and w % vec == 0
        # the coefficient rows and the window fit the slot, 16-byte aligned
        assert (d1 - d0) * plan.tk + nq * w <= plan.slot
        assert (d1 - d0) * plan.tk * itemsize % 16 == 0
    if plan.stride:
        # one window a tile; diagonal d reads the window jd[d] * stride
        # tiles away; the ring holds the span of jd and the copies ahead
        assert plan.nclusters == 1 and len(plan.jd) == len(offsets)
        span = max(plan.jd) - min(plan.jd) + 1
        assert span <= 3 and 1 <= plan.lookahead <= 3
        assert plan.nslot == span + plan.lookahead
        assert plan.table == ((min(plan.jd), span, plan.a0[0],
                               plan.width[0], plan.lookahead) + plan.jd)
        reads = [(off - j * plan.stride * plan.tk, 0)
                 for off, j in zip(offsets, plan.jd)]
    else:
        assert plan.jd == () and plan.nslot == tds.SPMM_STAGES
        assert plan.table == plan.starts + plan.a0 + plan.width
        reads = [(off, c) for c in range(plan.nclusters)
                 for off in offsets[plan.starts[c]:plan.starts[c + 1]]]
    for off, c in reads:
        # rows k0 .. k0 + tk - 1 read k + off inside their window
        assert plan.a0[c] <= off
        assert off + plan.tk <= plan.a0[c] + plan.width[c]
    assert plan.slot * itemsize % 16 == 0
    assert plan.smem_bytes == plan.nslot * plan.slot * itemsize
    assert plan.smem_bytes <= tds.SPMM_SMEM_MAX
    return plan


def _clusters(plan, offsets):
    return [tuple(offsets[a:b]) for a, b in zip(plan.starts, plan.starts[1:])]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
def test_plan_poisson_2d_walks_the_grid_stride(nrhs, itemsize):
    """The 4096x4096 grid (phase 4c's 32 RHS, ``cg_multi``'s 8): the
    stride walk, tiles 4096 rows apart, one window of tk + 2 vec columns a
    tile that serves as the -4096, the middle and the +4096 window.  (In
    f64 with 3 RHS the 1024-row tile's four slots do not fit: three
    windows, one per cluster.)"""
    offsets = (-4096, -1, 0, 1, 4096)
    plan = _check_plan(offsets, nrhs, itemsize)
    vec = 16 // itemsize
    if (nrhs, itemsize) == (3, 8):
        assert plan.stride == 0
        assert _clusters(plan, offsets) == [(-4096,), (-1, 0, 1), (4096,)]
        return
    assert plan.stride * plan.tk == 4096
    assert plan.jd == (-1, 0, 0, 0, 1)
    assert (plan.a0, plan.width) == ((-vec,), (plan.tk + 2 * vec,))


def test_plan_poisson_2d_at_32_rhs_fits_two_blocks_an_sm():
    plan = tds.psdia_spmm_plan((-4096, -1, 0, 1, 4096), 32, 4)
    assert (plan.tk, plan.qcap, plan.nchunks) == (128, 32, 1)
    assert 2 * (plan.smem_bytes + 1024) <= 233472


def test_plan_merges_offsets_closer_than_a_tile():
    """On a 64x64 grid at one RHS (1024-row tiles) the +-64 diagonals are
    closer than a tile: one window of tk + 128 columns."""
    offsets = tuple(int(o) for o in tds.DIA.from_coo(COO.from_scipy(
        utils.laplacian_2d(64))).offsets)
    plan = _check_plan(offsets, 1, 4)
    assert plan.stride == 0
    assert _clusters(plan, offsets) == [(-64, -1, 0, 1, 64)]
    assert plan.width == (plan.tk + 128,)


def test_plan_walks_neighbouring_tiles_on_a_small_grid():
    """The same grid at 32 RHS (128-row tiles): one window of 196 columns
    a tile, whose next tile's window the +64 diagonal reads (a walk of
    stride 1), against two clusters' 196 + 128."""
    offsets = (-64, -1, 0, 1, 64)
    plan = _check_plan(offsets, 32, 4)
    assert (plan.stride, plan.jd) == (1, (0, 0, 0, 0, 1))
    assert plan.width == (196,)


@pytest.mark.parametrize("nrhs", [1, 8, 32])
def test_plan_poisson_3d_walks_the_plane_stride(nrhs):
    """The 128^3 grid: tiles a plane (16384 rows) apart; the +-128 and
    +-1 diagonals read the middle window, which they widen by 256."""
    n = 128
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    plan = _check_plan(offsets, nrhs, 4)
    assert plan.stride * plan.tk == n * n
    assert plan.jd == (-1, 0, 0, 0, 0, 0, 1)
    assert plan.width == (plan.tk + 2 * n,)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_clusters_where_no_stride_fits(itemsize):
    """Offsets no stride of whole tiles brings within three windows: one
    window per cluster."""
    offsets = (-50000, -7, 0, 3, 20000, 90000)
    plan = _check_plan(offsets, 32, itemsize)
    assert plan.stride == 0
    assert _clusters(plan, offsets) == [(-50000,), (-7, 0, 3), (20000,),
                                        (90000,)]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_cuts_a_band_wider_than_a_slot(itemsize):
    """601 consecutive diagonals: one window would pass the budget, so the
    plan cuts the band into clusters that each fit."""
    offsets = tuple(range(-300, 301))
    plan = _check_plan(offsets, 32, itemsize)
    assert plan.nclusters > 1
    assert sum(len(c) for c in _clusters(plan, offsets)) == 601


@settings(max_examples=150, deadline=None)
@given(offsets=st.lists(st.integers(-200_000, 200_000), min_size=1,
                        max_size=40, unique=True).map(sorted),
       nrhs=st.integers(1, 80), itemsize=st.sampled_from([4, 8]))
def test_plan_covers_every_read_and_fits(offsets, nrhs, itemsize):
    """Both walks, where the stride walk exists, and the plan's pick."""
    offsets = tuple(offsets)
    plan = _check_plan(offsets, nrhs, itemsize)
    _check_plan(offsets, nrhs, itemsize,
                tds._cluster_walk(offsets, nrhs, itemsize))
    stride = tds._stride_walk(offsets, nrhs, itemsize)
    if stride is not None:
        _check_plan(offsets, nrhs, itemsize, stride)
        assert plan.width[0] <= stride.width[0] or plan.stride == 0


def _emulate(A, Xt: np.ndarray, plan) -> np.ndarray:
    """The kernel's tiling in numpy (float64): per (chunk, tile), each
    window staged with zeros outside ``[0, npad)`` and the coefficient
    rows read at ``k mod rb`` (PSDIA: K3b) or ``k`` (SDIA: K3a, zero from
    ``L + nrow`` on), summed over the diagonals in stored order; rows
    outside ``[L, L + nrow)`` stay zero.  The cluster walk reads
    cluster ``c``'s window of the tile, the stride walk diagonal ``d``'s
    window of the tile ``jd[d] * stride`` tiles away (which exists for
    every tile, pads and all, the kernel reads it at a window position
    outside the column, zero outside ``[0, npad)``).  Every tile of a
    chunk at once: the same sums, element for element, as one tile at a
    time."""
    nrhs, npad = Xt.shape
    Y = np.zeros_like(Xt)
    ntiles = -(-A.shape[0] // plan.tk)
    k0 = A.L + plan.tk * np.arange(ntiles)             # [ntiles]
    rows = k0[:, None] + np.arange(plan.tk)            # [ntiles, tk]
    keep = rows < A.L + A.shape[0]
    if isinstance(A, tds.SDIA):
        data = A.data.numpy()

        def coef(d):
            return np.where(keep, data[d, np.where(keep, rows, 0)], 0.0)
    else:
        pat = A.pattern.numpy()

        def coef(d):
            return pat[d, rows % A.rb]

    def windows(q0, nq, start, w):
        """The windows of every tile: [nq, ntiles, w]."""
        cols = start[:, None] + np.arange(w)
        inside = (cols >= 0) & (cols < npad)
        return np.where(inside, Xt[q0:q0 + nq][:, np.where(inside, cols, 0)],
                        0.0)

    for chunk in range(plan.nchunks):
        q0 = chunk * plan.qcap
        nq = min(plan.qcap, nrhs - q0)
        acc = np.zeros((nq, ntiles, plan.tk))
        for c in range(plan.nclusters):
            a0, w = plan.a0[c], plan.width[c]
            staged = {}                 # the cluster's windows, by shift
            for d in range(plan.starts[c], plan.starts[c + 1]):
                shift = (plan.jd[d] * plan.stride * plan.tk
                         if plan.stride else 0)
                if shift not in staged:
                    staged[shift] = windows(q0, nq, k0 + shift + a0, w)
                win = staged[shift]
                idx = np.arange(plan.tk) + A.offsets[d] - shift - a0
                assert idx.min() >= 0 and idx.max() < w
                acc = acc + coef(d) * win[:, :, idx]
        Y[q0:q0 + nq, rows[keep]] = acc[:, keep]
    return Y


def _toeplitz_band(n: int, half: int) -> sp.csr_matrix:
    rng = np.random.default_rng(half)
    offs = list(range(-half, half + 1))
    return sp.diags([rng.standard_normal() for _ in offs], offs,
                    shape=(n, n), format="csr")


#: K3b's operands (also the card tests'): name -> (matrix, rb).  The 2-D
#: grids of 128, 256 and 300 x 101 take the stride walk at some RHS
#: counts (300 x 101 at 32 RHS: stride 2, columns of 119 and 118 tiles, a
#: ragged last tile), the cluster walk at others; the band's clusters are
#: cut by the budget
SPMM_OPERANDS = {
    "laplacian_2d(40)": (utils.laplacian_2d(40), None),
    "laplacian_2d(40), rb 80": (utils.laplacian_2d(40), 80),
    "laplacian_2d(128)": (utils.laplacian_2d(128), None),
    "laplacian_2d(256), rb 512": (utils.laplacian_2d(256), 512),
    "laplacian_2d(300, 101)": (utils.laplacian_2d(300, 101), None),
    "laplacian_3d(10)": (utils.laplacian_3d(10), None),
    "band of 301 diagonals": (_toeplitz_band(1500, 150), None),
}


#: K3a's operands, SDIA packs: the 2-D Poisson's stride walk at 32 and 40
#: RHS, the band's clusters cut by the budget, and an odd npad (1827) and
#: L (87) whose tiles run past npad
SDIA_SPMM_OPERANDS = {
    "SDIA laplacian_2d(128), rb 1024": (utils.laplacian_2d(128), 1024),
    "SDIA band of 301 diagonals, rb 160": (_toeplitz_band(1500, 150), 160),
    "SDIA laplacian_2d(40), rb 87": (utils.laplacian_2d(40), 87),
}


def _spmm_pack(name, nrhs):
    """The pack of a K3b (PSDIA) or K3a (SDIA) operand for ``nrhs``."""
    if name in SDIA_SPMM_OPERANDS:
        m, rb = SDIA_SPMM_OPERANDS[name]
        return tds.pack_sdia(convert(COO.from_scipy(m), "dia"), rb=rb,
                             nrhs=nrhs)
    m, rb = SPMM_OPERANDS[name]
    dia = convert(COO.from_scipy(m), "dia")
    return tds.pack_psdia(dia, period=tds.detect_period(dia), nrhs=nrhs, rb=rb)


@pytest.mark.parametrize("walk", ["plan", "clusters"])
@pytest.mark.parametrize("nrhs", [1, 3, 8, 32, 40])
@pytest.mark.parametrize("name",
                         list(SPMM_OPERANDS) + list(SDIA_SPMM_OPERANDS))
def test_emulated_tiling_matches_the_plain_version(name, nrhs, walk):
    """A ragged last tile, rows masked outside ``[L, L + nrow)``, a row
    tile ``rb`` shorter than the kernel's tile (the pattern slot wraps;
    K3a's tiles run past npad), clusters cut by the budget, and the stride
    walk; the plan's pick and the cluster walk on every operand, PSDIA
    (K3b) and SDIA (K3a)."""
    A = _spmm_pack(name, nrhs)
    sdia = isinstance(A, tds.SDIA)
    if name.endswith("rb 87"):
        assert A.npad % 2 and A.L % 2
    plan = _check_plan(A.offsets, nrhs, 8, None if walk == "plan" else
                       tds._cluster_walk(A.offsets, nrhs, 8))
    if name.startswith("SDIA laplacian_2d(128)") and nrhs >= 32:
        assert plan.stride == 1 or walk == "clusters"
    if name.startswith("SDIA band"):
        assert plan.nclusters > 1
    rng = np.random.default_rng(nrhs)
    Xt = np.zeros((nrhs, A.npad))
    Xt[:, A.L:A.L + A.shape[0]] = rng.random((nrhs, A.shape[0]))
    ref = tds.spmm_sdia_padded_t_ref if sdia else tds.spmm_psdia_padded_t_ref
    want = ref(A, torch.from_numpy(Xt)).numpy()
    got = _emulate(A, Xt, plan)
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
    assert not got[:, :A.L].any() and not got[:, A.L + A.shape[0]:].any()


def test_emulated_sdia_tiling_matches_the_jax_k3a():
    """K3a's tiling (the plan's walk) on the 40x40 Poisson's SDIA pack
    with 3 RHS against the JAX package's K3a (Pallas, interpret mode) on
    the same pack."""
    m = utils.laplacian_2d(40)
    A = tds.pack_sdia(convert(COO.from_scipy(m), "dia"), nrhs=3)
    J = jds.pack_sdia(ts.convert(ts.COO.from_scipy(m, dtype=jnp.float64),
                                 "dia"), nrhs=3)
    assert (J.rb, J.L, J.npad, tuple(J.offsets)) == (A.rb, A.L, A.npad,
                                                      A.offsets)
    Xt = np.zeros((3, A.npad))
    Xt[:, A.L:A.L + m.shape[0]] = np.random.default_rng(5).random(
        (3, m.shape[0]))
    want = np.asarray(jds.spmm_sdia_padded_t(J, jnp.asarray(Xt),
                                             interpret=True))
    got = _emulate(A, Xt, tds.psdia_spmm_plan(A.offsets, 3, 8))
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))


def test_psdia_spmm_plans_before_it_refuses_a_meta_tensor():
    """Off the card the wrapper builds its plan and its table (on the
    tensor's device), then the launcher refuses: nothing is counted."""
    dia = convert(COO.from_scipy(utils.laplacian_2d(32)), "dia")
    A = tds.pack_psdia(dia, period=32, nrhs=8)
    A = A.to("meta")
    before = dict(tds.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tds.spmm_psdia_padded_t(A, torch.zeros(8, A.npad, dtype=A.dtype,
                                               device="meta"))
    assert tds.LAUNCHES == before


def _every_width(seed: int = 0) -> sp.csr_matrix:
    """Rows of every length 0..300: every width class, empty rows and hub
    rows (more than 128 entries)."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.arange(301), np.zeros(7, int)])
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(4000, k, replace=False) for k in lens])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(len(lens), 4000))


@pytest.mark.parametrize("name", ["every width", "powerlaw800.mtx",
                                  "two classes"])
def test_gpr_pack_rows_fit_their_class(name):
    """``gpr_spmv`` gives a class of width W a quarter of W lanes per row,
    each lane at most four entries of its row: every sorted row is at most
    its class's width, and the classes are consecutive runs."""
    from tpu_spmv_torch.io.mmio import read_mtx_arrays

    if name == "every width":
        m = _every_width()
    elif name == "two classes":         # classes 16, 32 and 64 empty
        m = sp.csr_matrix(sp.vstack([_every_width()[1:8],
                                     _every_width()[120:128]]))
    else:
        row, col, val, shape = read_mtx_arrays(FIXTURES / name,
                                               use_native=False)
        m = sp.csr_matrix((val, (row, col)), shape=shape)
    A = tgpr.pack_gpr(m, device="cpu")
    widths = np.diff(A.indptr.numpy())
    cls = np.repeat(np.arange(len(tgpr.CLASS_W)), A.class_rows)
    assert len(cls) == len(widths) == A.nrow_internal
    assert (widths <= np.asarray(tgpr.CLASS_W)[cls]).all()
    if name == "two classes":
        assert A.class_rows[1:4] == (0, 0, 0)
    else:
        assert A.nv > 0 and all(A.class_rows)
