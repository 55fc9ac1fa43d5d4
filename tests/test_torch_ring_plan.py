"""K8b's host plan (``psdia_ring_plan`` in ``tpu_spmv_torch/kernels/
dist_stream.py``), on the CPU.

K8b (``psdia_ring_stride`` / ``psdia_ring_clusters`` in
``tpu_spmv_torch/csrc/dist_stream.cu``) stages windows of the ring
``[left | x | right]`` and the pattern's coefficient rows in shared memory
along one of two walks that the plan picks on the host.  These tests hold
the plan to what the kernel relies on (the 2-D Poisson on the stride walk
at its grid width, every read of every row of a tile inside a staged
window, 16-byte window edges, the coefficient reuse only where the stride
is a multiple of the period, the shared-memory budget), run a torch
emulation of both walks (windows copied from ``left``, ``x`` and
``right``, zeros outside them, the coefficients once per segment or per
tile, the diagonals summed in stored order) bitwise against the plain
version at 1, 2 and 4 shards, and hold the port's sharded PSDIA and the
emulated walk against the JAX package's ``spmv_psdia_sharded`` (its ring
kernel in interpret mode) with the limits of ``test_torch_dist_planned``:
1e-6 relative in float32, 1e-13 in float64 (the same sums; the kernel's
FMA rounding may differ).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv as ts
from tpu_spmv import dist as jdist
from tpu_spmv.dist import planned as jplanned
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import COO, convert, dist, utils
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.kernels import dist_stream as tdst

torch.set_num_threads(1)

TILE = tdst.RING_TILE
JAX_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
DTYPES = [torch.float32, torch.float64]


def _band(n: int, half: int):
    """A Toeplitz band of 2 half + 1 diagonals (period 1)."""
    rng = np.random.default_rng(half)
    offs = list(range(-half, half + 1))
    return sp.diags([rng.standard_normal() for _ in offs], offs,
                    shape=(n, n), format="csr")


#: small operands and their row tiles: a 2-D grid 2048 wide (the stride
#: walk at S = 2048, coefficients once per segment), the 3-D Poisson of
#: chip_smoke's phase 4d (consecutive tiles, one window each), a band of
#: 81 diagonals (the cluster walk)
OPERANDS = {"laplacian_2d(2048, 40)": (lambda: utils.laplacian_2d(2048, 40),
                                       4096),
            "laplacian_3d(16)": (lambda: utils.laplacian_3d(16), 1024),
            "band of 81 diagonals": (lambda: _band(3000, 40), 1024)}


def _offsets(m):
    return tuple(int(o) for o in tds.DIA.from_coo(COO.from_scipy(m)).offsets)


def _check_plan(offsets, period, itemsize, plan=None):
    """The invariants K8b relies on; returns the plan (by default
    :func:`psdia_ring_plan`'s)."""
    if plan is None:
        plan = tdst.psdia_ring_plan(tuple(offsets), period, itemsize)
    vec = 16 // itemsize
    nd = len(offsets)
    assert plan.starts[0] == 0 and plan.starts[-1] == nd
    assert all(a < b for a, b in zip(plan.starts, plan.starts[1:]))
    assert len(plan.a0) == len(plan.width) == plan.nclusters
    for a0, w in zip(plan.a0, plan.width):
        assert a0 % vec == 0 and w % vec == 0       # 16-byte copies
    assert plan.slot * itemsize % 16 == 0
    if plan.stride:
        span = max(plan.jd) - min(plan.jd) + 1
        assert plan.nclusters == 1 and len(plan.jd) == nd
        assert span <= 3 and plan.jspan == span
        assert plan.nslot == span + 1               # one window in flight
        assert plan.table == ((min(plan.jd), plan.a0[0], plan.width[0])
                              + plan.jd)
        assert plan.reuse == (plan.stride * TILE % period == 0)
        coef = nd * TILE if plan.reuse else 0
        assert plan.slot >= plan.width[0] + (0 if plan.reuse else nd * TILE)
        reads = [(off - j * plan.stride * TILE, 0)
                 for off, j in zip(offsets, plan.jd)]
    else:
        assert plan.jd == () and not plan.reuse and plan.jspan == 0
        assert plan.nslot == tdst.RING_STAGES
        assert plan.table == plan.starts + plan.a0 + plan.width
        coef = 0
        for c in range(plan.nclusters):
            nd_c = plan.starts[c + 1] - plan.starts[c]
            assert plan.slot >= nd_c * TILE + plan.width[c]
        reads = [(off, c) for c in range(plan.nclusters)
                 for off in offsets[plan.starts[c]:plan.starts[c + 1]]]
    for off, c in reads:
        # rows k0 .. k0 + TILE - 1 read k + off inside their window
        assert plan.a0[c] <= off
        assert off + TILE <= plan.a0[c] + plan.width[c]
    assert plan.smem_bytes == (plan.nslot * plan.slot + coef) * itemsize
    assert plan.smem_bytes <= tds.SPMM_SMEM_MAX
    tdst.check_ring_walk(plan, tuple(offsets), itemsize)
    return plan


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("width", [2048, 4096])
def test_plan_poisson_2d_walks_the_grid_stride(width, itemsize):
    """The 2-D Poisson (offsets -width, -1, 0, 1, width; period width):
    the stride walk at S = the grid width, one window of TILE + 2 vec
    columns a tile, the coefficient rows once per segment, one window in
    flight; three blocks (the kernel's register cap) fit an SM in f32 and
    f64."""
    offsets = (-width, -1, 0, 1, width)
    plan = _check_plan(offsets, width, itemsize)
    vec = 16 // itemsize
    assert plan.stride * TILE == width
    assert plan.jd == (-1, 0, 0, 0, 1) and plan.reuse
    assert (plan.a0, plan.width) == ((-vec,), (TILE + 2 * vec,))
    assert (plan.jspan, plan.nslot) == (3, 4)
    assert 3 * (plan.smem_bytes + 1024) <= 233472


def test_plan_poisson_2d_of_a_full_operand():
    """The 4096^2 Poisson of chip_smoke's phase 4d: its offsets and period
    from the pack's own analysis give the stride walk at S = 4096."""
    m = utils.laplacian_2d(4096)
    offsets = _offsets(m)
    assert offsets == (-4096, -1, 0, 1, 4096)
    plan = _check_plan(offsets, 4096, 4)
    assert plan.stride * TILE == 4096 and plan.reuse


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["band of 81 diagonals",
                                  "laplacian_2d(48)"])
def test_plan_clusters_without_a_stride(name, itemsize):
    """A band of 81 diagonals has no stride (every offset inside one tile,
    no window of neighbouring tiles to share): the cluster walk, its
    clusters cut to the slot budget; so has the 48-wide grid in f32 (one
    window of TILE + 96 columns)."""
    m = _band(3000, 40) if name.startswith("band") else utils.laplacian_2d(48)
    offsets = _offsets(m)
    plan = _check_plan(offsets, 1 if name.startswith("band") else 48,
                       itemsize)
    if name.startswith("band") or itemsize == 4:
        assert plan.stride == 0 and not plan.reuse
    if name == "laplacian_2d(48)" and itemsize == 4:
        assert plan.starts == (0, 5) and plan.width == (TILE + 96,)


@pytest.mark.parametrize("n,itemsize,stride", [(16, 4, 1), (16, 8, 1),
                                               (128, 4, 16), (128, 8, 0)])
def test_plan_poisson_3d(n, itemsize, stride):
    """The 3-D Poisson takes K3b's choice at one right-hand side: at 16^3
    (chip_smoke's phase 4d) every offset fits one window, so the walk
    goes over consecutive tiles (stride 1, one window a tile) with the
    coefficients once per segment; at 128^3 tiles a plane apart in f32,
    and in f64 (whose per-tile slots do not fit) the cluster walk."""
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    plan = _check_plan(offsets, n * n, itemsize)
    assert plan.stride == stride
    if stride:
        assert plan.reuse


@pytest.mark.parametrize("period,reuse", [(4096, True), (2048, True),
                                          (1024, True), (1000, False),
                                          (8192, False), (131072, False)])
def test_plan_reuses_coefficients_only_on_a_period_multiple(period, reuse):
    """Every tile of a stride column has the same coefficient rows only
    where S = 4096 is a multiple of the period; otherwise each tile
    stages its own (in its slot, before its window)."""
    offsets = (-4096, -1, 0, 1, 4096)
    plan = _check_plan(offsets, period, 4)
    assert plan.stride * TILE == 4096 and plan.reuse == reuse
    if not reuse:
        assert plan.slot >= len(offsets) * TILE + plan.width[0]
    assert not tdst.ring_cluster_walk(offsets, 4).reuse


@pytest.mark.parametrize("name", ["laplacian_2d(2048, 40)", "laplacian_3d(16)",
                                  "laplacian_3d(128)", "band of 81 diagonals",
                                  "random"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_covers_every_read(name, itemsize):
    """Both walks cover every read on every operand, and on random sorted
    offset sets (within one row tile of 131072 rows)."""
    rng = np.random.default_rng(len(name) + itemsize)
    if name == "laplacian_3d(128)":
        sets = [(-16384, -128, -1, 0, 1, 128, 16384)]
    elif name == "random":
        sets = [tuple(sorted(set(rng.integers(-70000, 70000, k).tolist())))
                for k in (1, 3, 6, 11, 40)]
    else:
        sets = [_offsets(OPERANDS[name][0]())]
    for offsets in sets:
        for period in (1, 1024, 4096):
            _check_plan(offsets, period, itemsize)
        _check_plan(offsets, 1, itemsize,
                    tdst.ring_cluster_walk(offsets, itemsize))


def _broken_walks(itemsize):
    """Walks that do not fit the 2-D Poisson's offsets (-4096, -1, 0, 1,
    4096), each with the fault the check must name."""
    offsets = (-4096, -1, 0, 1, 4096)
    plan = tdst.psdia_ring_plan(offsets, 4096, itemsize)
    clusters = tdst.ring_cluster_walk(offsets, itemsize)
    vec = 16 // itemsize
    rep = dataclasses.replace
    return offsets, {
        "jd two tiles back": (rep(plan, jd=(-2, 0, 0, 0, 1)), "outside"),
        "jd of three diagonals": (rep(plan, jd=(-1, 0, 1)), "jd"),
        "a window too narrow": (rep(plan, width=(TILE,)), "outside"),
        "a window off 16 bytes": (rep(plan, a0=(-vec - 1,)), "16-byte"),
        "slots too small": (rep(plan, slot=plan.width[0] - 4 * vec), "hold"),
        "per-tile slots too small": (rep(plan, reuse=False), "hold"),
        "a stride walk of two clusters": (
            rep(plan, starts=(0, 2, 5), a0=(0, 0), width=(TILE,) * 2),
            "one window"),
        "clusters that skip diagonals": (rep(clusters, starts=(0, 4)),
                                         "split"),
        "a cluster walk with reuse": (rep(clusters, reuse=True), "reuse"),
        "a ring past the budget": (
            rep(plan, slot=tds.SPMM_SMEM_MAX // itemsize), "budget")}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_check_ring_walk_rejects_walks_that_do_not_fit(itemsize):
    """``check_ring_walk`` (which ``spmv_psdia_ring`` runs on every plan
    it is given, before the kernel could race or read past a window)
    accepts the planner's walks and rejects each broken one with a
    ``ValueError`` naming its fault; the ring's slots follow from the walk
    (``jspan`` windows read and one in flight), so no plan can hold
    fewer."""
    offsets, broken = _broken_walks(itemsize)
    tdst.check_ring_walk(tdst.psdia_ring_plan(offsets, 4096, itemsize),
                         offsets, itemsize)
    tdst.check_ring_walk(tdst.ring_cluster_walk(offsets, itemsize), offsets,
                         itemsize)
    for name, (plan, fault) in broken.items():
        with pytest.raises(ValueError, match=fault):
            tdst.check_ring_walk(plan, offsets, itemsize)
        if plan.stride and len(plan.jd) == len(offsets):
            assert plan.nslot == plan.jspan + 1, name


def test_psdia_ring_checks_its_plan_on_the_cpu():
    """The wrapper checks a given walk on a CPU tensor too (where it runs
    the plain version), so a broken walk fails before it reaches a card."""
    _, pack, A, xpad = _sharded("laplacian_2d(2048, 40)", torch.float32, 1)
    x0 = A.shard_xpad(xpad).chunks[0]
    args = (A.pattern[0], A.offsets, x0, x0[-A.halo:], x0[:A.halo])
    kw = dict(base=0, L=A.L, nrow=A.shape[0])
    y = tdst.spmv_psdia_ring(*args, **kw, plan=A.ring_plan)
    assert torch.equal(y, tdst.spmv_psdia_ring_ref(*args, **kw))
    bad = dataclasses.replace(A.ring_plan, jd=(-2, 0, 0, 0, 1))
    with pytest.raises(ValueError, match="outside"):
        tdst.spmv_psdia_ring(*args, **kw, plan=bad)


def _window(ring, h, cp, j0, w):
    """Columns j0 .. j0 + w of the ring [left | x | right] (ring[h + j] is
    column j), zero outside [-h, cp + h): the kernel's copy helper."""
    j = torch.arange(j0, j0 + w)
    inside = (j >= -h) & (j < cp + h)
    return torch.where(inside, ring[(h + j).clamp(0, len(ring) - 1)],
                       torch.zeros((), dtype=ring.dtype))


def _coef(pattern, d0, d1, k0):
    """The coefficient rows of diagonals d0 .. d1 for the tile at k0."""
    rb = pattern.shape[1]
    return pattern[d0:d1, (k0 + torch.arange(TILE)) % rb]


def emulate_ring_walk(plan, pattern, offsets, x, left, right, *, base, L,
                      nrow, seg):
    """K8b's walk in torch, tile by tile as the kernel stages it: the
    windows of each segment of ``seg`` tiles of a stride column (or each
    tile's cluster windows), the coefficient rows once per segment (the
    plan's ``reuse``) or per tile, each row's diagonals summed in stored
    order from zero; rows whose ``base + k`` leaves ``[L, L + nrow)`` are
    zero."""
    cp, h = x.shape[0], left.shape[0]
    ring = torch.cat([left, x, right])
    ntiles = -(-cp // TILE)
    y = torch.zeros(ntiles * TILE, dtype=x.dtype)
    r = torch.arange(TILE)
    nd = len(offsets)

    def tile_sum(k0, parts):
        acc = torch.zeros(TILE, dtype=x.dtype)
        for coef, xs in parts:           # diagonals in stored order
            acc = acc + coef * xs
        row = base + k0 + r
        y[k0:k0 + TILE] = torch.where((row >= L) & (row < L + nrow), acc,
                                      torch.zeros((), dtype=x.dtype))

    if plan.stride:
        M, jd = plan.stride, plan.jd
        span, a0, w = M * TILE, plan.a0[0], plan.width[0]
        for col in range(M):
            length = -(-(ntiles - col) // M)
            for i0 in range(0, length, seg):
                i1 = min(i0 + seg, length)
                wins = {p: _window(ring, h, cp, (col + p * M) * TILE + a0, w)
                        for p in range(i0 + min(jd), i1 + max(jd))}
                seg_coef = _coef(pattern, 0, nd, (col + i0 * M) * TILE)
                for i in range(i0, i1):
                    k0 = (col + i * M) * TILE
                    coef = (seg_coef if plan.reuse
                            else _coef(pattern, 0, nd, k0))
                    tile_sum(k0, [(coef[d], wins[i + jd[d]][
                        r + offsets[d] - jd[d] * span - a0])
                        for d in range(nd)])
    else:
        for t in range(ntiles):
            k0 = t * TILE
            parts = []
            for c in range(plan.nclusters):
                d0, d1 = plan.starts[c], plan.starts[c + 1]
                win = _window(ring, h, cp, k0 + plan.a0[c], plan.width[c])
                coef = _coef(pattern, d0, d1, k0)
                parts += [(coef[d - d0], win[r + offsets[d] - plan.a0[c]])
                          for d in range(d0, d1)]
            tile_sum(k0, parts)
    return y[:cp]


@functools.cache
def _sharded(name, dtype, ndev):
    """The operand's CPU pack (row tile of OPERANDS), its sharded form on
    ``ndev`` CPU shards, and a padded x."""
    make, rb = OPERANDS[name]
    m = make()
    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    pack = tds.pack_psdia(dia, period=tds.detect_period(dia), rb=rb,
                          device="cpu")
    A = dist.place(dist.ShardedPSDIA.build(pack, ndev),
                   dist.make_mesh(ndev, device="cpu"))
    x = np.random.default_rng(ndev).standard_normal(m.shape[0])
    return m, pack, A, tds.pad_x(pack, torch.tensor(x, dtype=dtype))


def _walks(A, itemsize):
    return {"plan": A.ring_plan,
            "per tile": tdst.psdia_ring_plan(A.offsets, A.rb, itemsize),
            "clusters": tdst.ring_cluster_walk(A.offsets, itemsize)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("walk", ["plan", "per tile", "clusters"])
def test_emulated_walk_matches_the_plain_version(walk, ndev, dtype):
    """Every walk on every operand, at segments of 1, 3 and every tile of
    a column: each shard bitwise equal to ``spmv_psdia_ring_ref`` (the
    same products and sums, the windows and coefficient rows taken where
    the kernel takes them), and the shards together bitwise the
    single-chip plain version of K2 on the same pack."""
    isz = torch.tensor([], dtype=dtype).element_size()
    for name in OPERANDS:
        m, pack, A, xpad = _sharded(name, dtype, ndev)
        plan = _walks(A, isz)[walk]
        if name.startswith("laplacian_2d") and walk == "plan":
            assert plan.stride * TILE == 2048 and plan.reuse
        if name.startswith("band"):
            assert plan.stride == 0
        xs = A.shard_xpad(xpad)
        k2 = tds.spmv_psdia_padded_ref(pack, xpad)
        for seg in (1, 3, 1 << 20):
            ys = []
            for s in range(ndev):
                args = (A.pattern[s], A.offsets, xs.chunks[s],
                        xs.chunks[(s - 1) % ndev][-A.halo:],
                        xs.chunks[(s + 1) % ndev][:A.halo])
                kw = dict(base=s * A.rows_per_shard, L=A.L, nrow=A.shape[0])
                ye = emulate_ring_walk(plan, *args, **kw, seg=seg)
                assert torch.equal(ye, tdst.spmv_psdia_ring_ref(*args, **kw)
                                   ), (name, s, seg)
                ys.append(ye)
            flat = torch.cat(ys)
            assert torch.equal(flat[:pack.npad], k2), (name, seg)
            assert not flat[pack.npad:].any()
    assert tdst.LAUNCHES["psdia_ring"] == 0


def test_sharded_pack_keeps_its_plan():
    """The plan is computed once per sharded pack and kept with it (also
    through ``place``), from the pack's offsets, period and value type."""
    _, pack, A, _ = _sharded("laplacian_2d(2048, 40)", torch.float32, 2)
    assert A.ring_plan is A.ring_plan
    assert A.ring_plan == tdst.psdia_ring_plan(pack.offsets, pack.period, 4)
    B = dist.place(A, dist.make_mesh(2, device="cpu"))
    assert B.ring_plan == A.ring_plan


@pytest.mark.parametrize("dtype,ndev", [(torch.float32, 2),
                                        (torch.float64, 4)])
def test_sharded_psdia_matches_reference(dtype, ndev):
    """A 64x64 Poisson (4096 rows, row tile 1024): the port's sharded
    PSDIA (its plain version on the CPU) and the emulation of K8b's
    planned walk against the JAX package's ``spmv_psdia_sharded`` (its
    ring kernel in interpret mode, jitted), within 1e-6 relative in
    float32 and 1e-13 in float64."""
    m = utils.laplacian_2d(64)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    J = jplanned.ShardedPSDIA.build(jds.pack_psdia(
        ts.convert(ts.COO.from_scipy(m, dtype=jdt), "dia"), rb=1024), ndev)
    x = np.random.default_rng(7).random(m.shape[1])
    xpad = np.zeros(J.npad, np.float64)
    xpad[J.L:J.L + m.shape[1]] = x
    jmesh = jdist.make_mesh(ndev)
    step = jax.jit(lambda A, v: jplanned.spmv_psdia_sharded(jmesh, A, v,
                                                            interpret=True))
    yj = np.asarray(step(J, J.shard_xpad(jnp.asarray(xpad, jdt))).chunks
                    ).reshape(-1)

    dia = convert(COO.from_scipy(m, dtype=dtype), "dia")
    pack = tds.pack_psdia(dia, period=64, rb=1024, device="cpu")
    mesh = dist.make_mesh(ndev, device="cpu")
    A = dist.place(dist.ShardedPSDIA.build(pack, ndev), mesh)
    assert (A.L, A.rb, A.rows_per_shard, A.npad, A.halo) == (
        J.L, J.rb, J.rows_per_shard, J.npad, jds._halo_size(J.offsets, J.rb))
    xs = A.shard_xpad(torch.tensor(xpad, dtype=dtype))
    yt = torch.cat(dist.spmv_psdia_sharded(mesh, A, xs).chunks)
    ye = torch.cat([emulate_ring_walk(
        A.ring_plan, A.pattern[s], A.offsets, xs.chunks[s],
        xs.chunks[(s - 1) % ndev][-A.halo:], xs.chunks[(s + 1) % ndev][:A.halo],
        base=s * A.rows_per_shard, L=A.L, nrow=A.shape[0], seg=2)
        for s in range(ndev)])
    scale = np.max(np.abs(yj))
    for y in (yt, ye):
        assert np.max(np.abs(y.double().numpy() - yj)) <= JAX_TOL[dtype] * scale
    assert np.max(np.abs(yt.double().numpy()[A.L:A.L + m.shape[0]]
                         - m @ x)) <= 2e-5 * np.max(np.abs(m @ x))
