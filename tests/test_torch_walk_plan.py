"""K2's walk (``psdia_walk_plan`` in ``tpu_spmv_torch/kernels/
dia_stream.py``, the kernel body ``csrc/psdia_walk.cuh``), on the CPU.

K2 runs K8b's walks on the padded row space of one pack: windows of
``xpad`` (zero outside ``[0, npad)``) and the pattern's coefficient rows
staged in shared memory, by bulk copies that clip a window to ``[0,
npad)`` and cut a coefficient row where it wraps at ``rb``.  These tests
emulate that walk in torch (the windows copied as the bulk copies clip
them, the coefficient rows once per segment or per tile, each row's
diagonals summed in stored order from zero, the row mask) and hold it
bitwise against the plain version ``spmv_psdia_padded_ref``; hold the
port's K2 (its plain version on the CPU) and the emulated walk against
the JAX package's ``spmv_psdia_padded`` (its Pallas kernel in interpret
mode) within 1e-6 relative in float32 and 1e-13 in float64 (the same sums;
the kernel's FMA rounding may differ) on three operands and their
transposed packs; and check that the plan moved from ``dist_stream`` is
what the old names return.
"""

import ctypes
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import COO, convert, utils
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import dist_stream as tdst

torch.set_num_threads(1)

TILE = tds.WALK_TILE
JAX_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
DTYPES = [torch.float32, torch.float64]


def _periodic_band(n: int, period: int, seed: int):
    """Offsets -1024, -1, 0, 1 and 1024 with values that repeat every
    ``period`` rows (a five-point band of a 1024-wide grid)."""
    rng = np.random.default_rng(seed)
    offs = (-1024, -1, 0, 1, 1024)
    pat = rng.standard_normal((len(offs), period))
    rows, cols, vals = [], [], []
    for d, o in enumerate(offs):
        i = np.arange(max(0, -o), n - max(0, o))
        rows.append(i)
        cols.append(i + o)
        vals.append(pat[d, i % period])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


#: the operands, their period and the walk the plan must pick: (stride,
#: coefficient reuse)
OPERANDS = {
    # the stride walk at M = 1, every stride a multiple of the period
    "band, period 1024": (lambda: _periodic_band(16384, 1024, 0), 1024,
                          (1, True)),
    # the same walk; a period that does not divide the stride
    "band, period 3": (lambda: _periodic_band(16384, 3, 1), 3, (1, False)),
    # offsets +-1, +-16, +-256: one window a tile, consecutive tiles
    "laplacian_3d(16)": (lambda: utils.laplacian_3d(16), 256, (1, True)),
}


@functools.cache
def _operand(name: str, dtype, transposed: bool):
    """The port's CPU pack of ``name`` (or its transposed pack), the
    matrix it computes and a padded x."""
    make, period, _ = OPERANDS[name]
    m = make()
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    A = tds.pack_psdia(dia, period=period, device="cpu")
    if transposed:
        A, m = tds.transpose_psdia(A), m.T.tocsr()
    x = np.random.default_rng(len(name)).standard_normal(m.shape[1])
    return A, m, x, tds.pad_x(A, torch.tensor(x, dtype=dtype))


@functools.cache
def _jax_pack(name: str, transposed: bool):
    """The JAX package's float64 pack of ``name`` (or its transposed
    pack), made once for both value types: a pack and its transpose only
    place values, so a float32 pack is this one's pattern rounded."""
    make, period, _ = OPERANDS[name]
    J = jds.pack_psdia(ts.convert(ts.COO.from_scipy(make(),
                                                    dtype=jnp.float64),
                                  "dia"), period=period)
    return jds.transpose_psdia(J) if transposed else J


@functools.cache
def _jax_k2(name: str, dtype, transposed: bool) -> np.ndarray:
    """The JAX package's K2 (Pallas, interpret mode) on the same operand
    and padded x, as float64 (a pack and its transpose of the same offsets
    share one compiled program)."""
    J = _jax_pack(name, transposed)
    if dtype == torch.float32:
        J = dataclasses.replace(J, pattern=J.pattern.astype(jnp.float32))
    A, _, _, xpad = _operand(name, dtype, transposed)
    assert (J.rb, J.L, J.npad, tuple(J.offsets)) == (A.rb, A.L, A.npad,
                                                      A.offsets)
    y = jds.spmv_psdia_padded(J, jnp.asarray(xpad.numpy()), interpret=True)
    return np.asarray(y, np.float64)


def _window(xpad, j0, w):
    """Window columns j0 .. j0 + w of the padded row space as K2's bulk
    copy stages it: the columns inside [0, npad) copied in one piece, the
    clipped ones zero."""
    npad = xpad.shape[0]
    win = torch.zeros(w, dtype=xpad.dtype)
    lo, hi = max(j0, 0), min(j0 + w, npad)
    if hi > lo:
        win[lo - j0:hi - j0] = xpad[lo:hi]
    return win


def _coef(pattern, k0):
    """Every diagonal's coefficient rows for the tile at k0, copied from
    pattern slot k0 mod rb in pieces cut where a row wraps at rb."""
    rb = pattern.shape[1]
    out = torch.empty(pattern.shape[0], TILE, dtype=pattern.dtype)
    s, e = k0 % rb, 0
    while e < TILE:
        n = min(TILE - e, rb - s)
        out[:, e:e + n] = pattern[:, s:s + n]
        e, s = e + n, 0
    return out


def emulate_k2_walk(plan, A, xpad, *, seg):
    """K2's walk in torch, tile by tile as the kernel stages it, over the
    tiles of the padded row space that hold rows of [L, L + nrow) (the
    others zero): the windows of each segment of ``seg`` tiles of a
    stride column (or each tile's cluster windows), the coefficient rows
    once per segment (the plan's ``reuse``) or per tile, each row's
    diagonals summed in stored order from zero; rows outside [L, L + nrow)
    zero."""
    npad, offsets, nd = A.npad, A.offsets, A.ndiags
    t0 = A.L // TILE
    ntiles = min(-(-(A.L + A.shape[0]) // TILE), -(-npad // TILE)) - t0
    y = torch.full((-(-npad // TILE) * TILE,), float("nan"),
                   dtype=xpad.dtype)
    y[:t0 * TILE] = 0
    y[(t0 + ntiles) * TILE:] = 0
    r = torch.arange(TILE)

    def tile_sum(k0, parts):
        acc = torch.zeros(TILE, dtype=xpad.dtype)
        for coef, xs in parts:           # diagonals in stored order
            acc = acc + coef * xs
        row = k0 + r
        y[k0:k0 + TILE] = torch.where((row >= A.L) & (row < A.L + A.shape[0]),
                                      acc, torch.zeros((), dtype=acc.dtype))

    if plan.stride:
        M, jd = plan.stride, plan.jd
        span, a0, w = M * TILE, plan.a0[0], plan.width[0]
        for col in range(M):
            length = -(-(ntiles - col) // M)
            for i0 in range(0, length, seg):
                i1 = min(i0 + seg, length)
                wins = {p: _window(xpad, (t0 + col + p * M) * TILE + a0, w)
                        for p in range(i0 + min(jd), i1 + max(jd))}
                seg_coef = _coef(A.pattern, (t0 + col + i0 * M) * TILE)
                for i in range(i0, i1):
                    k0 = (t0 + col + i * M) * TILE
                    coef = seg_coef if plan.reuse else _coef(A.pattern, k0)
                    tile_sum(k0, [(coef[d], wins[i + jd[d]][
                        r + offsets[d] - jd[d] * span - a0])
                        for d in range(nd)])
    else:
        for t in range(ntiles):
            k0 = (t0 + t) * TILE
            coef = _coef(A.pattern, k0)
            parts = []
            for c in range(plan.nclusters):
                d0, d1 = plan.starts[c], plan.starts[c + 1]
                win = _window(xpad, k0 + plan.a0[c], plan.width[c])
                parts += [(coef[d], win[r + offsets[d] - plan.a0[c]])
                          for d in range(d0, d1)]
            tile_sum(k0, parts)
    return y[:npad]


def _walks(A, itemsize):
    return {"plan": tds.psdia_walk_plan(A.offsets, A.period, itemsize),
            "per tile": tds.psdia_walk_plan(A.offsets, A.rb, itemsize),
            "clusters": tds.psdia_cluster_walk(A.offsets, itemsize)}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(OPERANDS))
def test_plan_picks_the_stride_walk(name, itemsize):
    """Each operand's walk: the stride walk at M = 1 (one window a tile,
    tiles consecutive), with the coefficient rows once per segment where
    the stride is a multiple of the period; the plan fits
    (``check_walk``), and the bulk ring keeps three windows in
    flight where the coefficients are reused (two blocks an SM still
    fit), one where each slot holds a tile's rows."""
    A = _operand(name, torch.float32, False)[0]
    plan = tds.psdia_walk_plan(A.offsets, A.period, itemsize)
    assert (plan.stride, plan.reuse) == OPERANDS[name][2]
    assert plan.jspan == (3 if name.startswith("band") else 1)
    tds.check_walk(plan, A.offsets, itemsize)
    ahead = plan.ahead
    coef = A.ndiags * TILE if plan.reuse else 0
    assert ((plan.jspan + ahead) * plan.slot + coef) * itemsize \
        <= 233472 // 2 - 1024 or ahead == 1
    if plan.reuse:
        assert ahead == tds.BULK_AHEAD
    assert tds.psdia_cluster_walk(A.offsets, itemsize).ahead == 0


@pytest.mark.parametrize("itemsize,reuse,ahead", [(4, True, 3), (8, True, 3),
                                                  (4, False, 1),
                                                  (8, False, 1)])
def test_bulk_ring_of_the_4096_poisson(itemsize, reuse, ahead):
    """The 4096^2 Poisson's stride walk: three windows in flight with the
    coefficients once per segment (f32 and f64); with the rows in every
    slot, one (a deeper ring would leave room for one block an SM)."""
    offsets = (-4096, -1, 0, 1, 4096)
    plan = tds.psdia_walk_plan(offsets, 4096 if reuse else 8192, itemsize)
    assert plan.stride * TILE == 4096 and plan.reuse == reuse
    assert plan.ahead == ahead


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("walk", ["plan", "per tile", "clusters"])
@pytest.mark.parametrize("name", list(OPERANDS))
def test_emulated_k2_walk_is_the_plain_version(name, walk, dtype,
                                               transposed):
    """Every walk on every operand (and its transposed pack), at segments
    of 1, 3 and every tile of a column: bitwise the plain version of K2,
    the pads zero."""
    A, m, _, xpad = _operand(name, dtype, transposed)
    plan = _walks(A, xpad.element_size())[walk]
    ref = tds.spmv_psdia_padded_ref(A, xpad)
    for seg in ((1, 3, 1 << 20) if plan.stride else (1,)):
        y = emulate_k2_walk(plan, A, xpad, seg=seg)
        assert torch.equal(y, ref), seg
    assert not y[:A.L].any() and not y[A.L + m.shape[0]:].any()
    assert tds.LAUNCHES["psdia"] == 0


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(OPERANDS))
def test_k2_walk_matches_reference(name, dtype, transposed):
    """The port's K2 (the plain version on a CPU tensor) and the emulated
    walk against the JAX package's K2 in interpret mode: within 1e-6
    relative in float32, 1e-13 in float64; the valid rows against
    scipy."""
    A, m, x, xpad = _operand(name, dtype, transposed)
    yj = _jax_k2(name, dtype, transposed)
    plan = tds.psdia_walk_plan(A.offsets, A.period, xpad.element_size())
    scale = np.max(np.abs(yj))
    for y in (tds.spmv_psdia_padded(A, xpad),
              emulate_k2_walk(plan, A, xpad, seg=2)):
        assert np.max(np.abs(y.double().numpy() - yj)) <= \
            JAX_TOL[dtype] * scale
    want = m @ x
    got = tds.unpad_y(A, tds.spmv_psdia_padded(A, xpad)).double().numpy()
    gate = 2e-5 if dtype == torch.float32 else 1e-10
    assert np.max(np.abs(got - want)) <= gate * np.max(np.abs(want))


def test_clipped_windows_are_the_first_and_last():
    """The walk takes only the tiles that hold rows of [L, L + nrow): on
    the band of period 1024 the pack's pads keep every window it stages
    inside [0, npad), so the bulk copies clip nothing.  With the rows
    moved to the start of the row space (L = 0) the windows of the first
    tile and of the one before it reach below column 0: those columns,
    clipped and zero (the threads zero them), give the plain version bit
    for bit."""
    A, _, _, xpad = _operand("band, period 1024", torch.float32, False)
    plan = tds.psdia_walk_plan(A.offsets, A.period, 4)
    a0, w = plan.a0[0], plan.width[0]

    def clipped(P):
        t0, t1 = P.L // TILE, -(-(P.L + P.shape[0]) // TILE)
        return [t for t in range(t0 + min(plan.jd), t1 + max(plan.jd))
                if t * TILE + a0 < 0 or t * TILE + a0 + w > P.npad]

    assert clipped(A) == []
    B = dataclasses.replace(A, L=0)
    assert clipped(B) == [-1, 0]
    xb = xpad[:B.npad]
    assert torch.equal(emulate_k2_walk(plan, B, xb, seg=3),
                       tds.spmv_psdia_padded_ref(B, xb))


@pytest.mark.parametrize("name", ["WalkPlan", "psdia_walk_plan",
                                  "psdia_cluster_walk", "check_walk",
                                  "WALK_TILE", "WALK_STAGES"])
def test_plan_moved_from_dist_stream(name):
    """The walk's plan lives with K2; ``dist_stream``'s former names are
    the same objects, so a sharded pack's ``ring_plan`` is K2's plan."""
    old = {"WalkPlan": "RingWalkPlan", "psdia_walk_plan": "psdia_ring_plan",
           "psdia_cluster_walk": "ring_cluster_walk",
           "check_walk": "check_ring_walk", "WALK_TILE": "RING_TILE",
           "WALK_STAGES": "RING_STAGES"}[name]
    assert getattr(tdst, old) is getattr(tds, name)
    for offsets, period in (((-4096, -1, 0, 1, 4096), 4096),
                            ((-256, -16, -1, 0, 1, 16, 256), 256)):
        for isz in (4, 8):
            assert tdst.psdia_ring_plan(offsets, period, isz) == \
                tds.psdia_walk_plan(offsets, period, isz)
            assert tdst.ring_cluster_walk(offsets, isz) == \
                tds.psdia_cluster_walk(offsets, isz)


def test_k2_launch_arguments_are_made_once():
    """K2's wrapper looks its walk up once per pack key: the checked plan
    and the address of its launch arguments (the offsets and the plan's
    table on the device, the row tile, the plan's scalars), which a launch
    passes as one pointer; a second lookup returns the same."""
    A = _operand("band, period 1024", torch.float32, False)[0]
    dev = torch.device("cpu")
    got = tds._walk_launch(A.offsets, A.period, A.rb, 4, dev)
    assert got is tds._walk_launch(A.offsets, A.period, A.rb, 4, dev)
    plan, at = got
    assert plan == tds.psdia_walk_plan(A.offsets, A.period, 4)
    args, addr = tds._walk_args(plan, A.offsets, A.rb, dev, True)
    assert at == addr == ctypes.addressof(args)
    assert args.offsets == tds._offsets_on(A.offsets, dev).data_ptr()
    assert args.table == tds._offsets_on(plan.table, dev).data_ptr()
    assert tds._offsets_on(plan.table, dev).tolist() == list(plan.table)
    assert (args.rb, args.ndiags, args.nclusters, args.stride, args.slot,
            args.jspan, args.reuse, args.ahead) == (
        A.rb, A.ndiags, 1, plan.stride, plan.slot, plan.jspan, 1, plan.ahead)
    # one thread a row on few tiles only on a card, and only from K2's own
    # wrapper: a walk asked for by name (and K8b's) keeps the walk
    assert args.direct_tiles == tds._direct_tiles(dev) == 0
    assert tds._walk_args(plan, A.offsets, A.rb, dev)[0].direct_tiles == 0


@pytest.mark.parametrize("walk,ahead", [("plan", 0), ("plan", 4),
                                        ("clusters", 1)])
def test_check_walk_rejects_windows_in_flight_out_of_range(walk, ahead):
    """The plan decides how many windows the bulk stride walk keeps in
    flight and the launcher only checks it: ``check_walk`` refuses none
    or more than ``BULK_AHEAD`` on the stride walk, and any on the
    cluster walk."""
    A = _operand("band, period 1024", torch.float32, False)[0]
    plan = _walks(A, 4)[walk]
    tds.check_walk(plan, A.offsets, 4)
    with pytest.raises(ValueError, match="in flight"):
        tds.check_walk(dataclasses.replace(plan, ahead=ahead), A.offsets, 4)
