"""``tile_permute`` as one composed gather a tile (``csrc/probes.cu``), on
the CPU.

Every step of a tile program moves words, so the kernel walks the steps
backward from each output position through the index tiles (T: (i, j) <-
(j, i); S_k: i <- idx_k[i][j]; G_k: j <- idx_k[i][j]) to a position of
the loaded tile and reads that value once, then multiplies by ``mul``
and sums eight lanes left to right as the plain version does.  This file
does exactly that arithmetic in numpy and holds it bitwise against
``tile_permute_ref`` on every variant of the probes (T4 cut from 100 x 5
tiles to 4 x 5) and on random programs of up to 8 steps with both index
types; it also checks what the kernel relies on from the plan: every
index in one byte, the mode (an S-only program's output column j comes
from column j, a G-only one's row i from row i, so a block can take a
slab of 32 columns or rows; a lane gather reaches any column) and the
staged index slots (every slot a gather reads)."""

import numpy as np
import pytest
import torch

from tpu_spmv_torch.bench import probes as pr

torch.set_num_threads(1)

Q = pr.Q
_OP = {1: "S", 2: "G", 3: "T"}


def _loaded_tiles(prog, src: np.ndarray, T: int) -> np.ndarray:
    """The loaded tiles ``[T, 128, 128]``: ``src``'s tiles, or its rows
    through ``rowsrc`` (lane-gathered by ``lidx``), zero past ``nload``."""
    if prog.rowsrc is None:
        return src.reshape(T, Q, Q)
    z = np.zeros((T, Q, Q), np.float32)
    rows = src[prog.rowsrc.numpy()].reshape(T, prog.nload, Q)
    if prog.lidx is not None:
        lanes = (prog.lidx.numpy().astype(np.int64) & (Q - 1)).reshape(
            T, prog.nload, Q)
        rows = np.take_along_axis(rows, lanes, axis=2)
    z[:, :prog.nload] = rows
    return z


def chase(prog, src: np.ndarray, mul=None, psum8=False) -> np.ndarray:
    """The kernel's arithmetic in numpy: the code's steps walked backward
    from every output (t, i, j) to a position of the loaded tile, one read
    there, ``mul`` as one float32 product, eight lanes added left to right
    in float32."""
    T = src.size // (Q * Q) if prog.rowsrc is None else prog.ntiles
    idx = prog.idx.numpy().astype(np.int64)
    t, i, j = np.meshgrid(np.arange(T), np.arange(Q), np.arange(Q),
                          indexing="ij")
    tsel = t if prog.idx_tiles > 1 else np.zeros_like(t)
    r, c = i.copy(), j.copy()
    nsteps = len(prog.steps)
    for s in range(nsteps - 1, -1, -1):
        code = (prog.code >> (4 * s)) & 0xF
        op, k = _OP[code & 3], code >> 2
        if op == "T":
            r, c = c, r
            continue
        assert (prog.staged >> k) & 1            # staged by the kernel
        v = idx[k, tsel, r, c] & (Q - 1)
        if op == "S":
            r = v
        else:
            c = v
    if prog.mode == pr.COL_SLABS:
        assert (c == j).all()
    elif prog.mode == pr.ROW_SLABS:
        assert (r == i).all()
    out = _loaded_tiles(prog, src, T)[t, r, c]
    if mul is not None:
        out = (out * mul.reshape(T, Q, Q)).astype(np.float32)
    if psum8:
        a = out.reshape(T, Q, Q // 8, 8)
        s8 = a[..., 0].copy()
        for e in range(1, 8):
            s8 = (s8 + a[..., e]).astype(np.float32)
        out = s8
    return out


@pytest.fixture(scope="module")
def variants():
    """T3 at its 91 tiles; T4 cut from 100 x 5 tiles to 4 x 5 (the same
    shared index tiles and per-tile program)."""
    return pr.tile_variants(pr.t3_operands(), pr.t4_operands(T=4), "cpu")


#: each variant's mode and staged index slots
PLANS = {"S": (pr.COL_SLABS, 1), "G-S-G": (pr.FULL_TILE, 1),
         "exchange + S-G": (pr.FULL_TILE, 1),
         "exchange + S-G + psum8": (pr.FULL_TILE, 1),
         "s1v2": (pr.FULL_TILE, 1), "TGTG": (pr.FULL_TILE, 0b11)}


@pytest.mark.parametrize("name", list(PLANS))
def test_chase_is_tile_permute_ref_on_every_variant(variants, name):
    prog, src, mul, psum8 = variants[name]
    assert prog.idx.dtype == torch.int8
    assert (prog.mode, prog.staged) == PLANS[name]
    want = pr.tile_permute_ref(prog, src, mul, psum8)
    got = chase(prog, src.numpy(), None if mul is None else mul.numpy(),
                psum8)
    np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())
    assert pr.LAUNCHES["tile_permute"] == 0


def _random_program(rng, itype, T=3):
    """A random program of 1 to 8 steps (S, G or T; gathers name one of
    1 to 4 index slots), index tiles shared or per tile, loaded directly
    or through a row index with or without lane gathers, with or without
    ``mul`` and ``psum8``."""
    K = int(rng.integers(1, 5))
    ops = rng.choice(["S", "G", "T"], int(rng.integers(1, 9)))
    if rng.random() < 0.3:              # an S-only or G-only program
        ops[:] = rng.choice(["S", "G"])
    steps = "".join(op if op == "T" else f"{op}{rng.integers(0, K)}"
                    for op in ops)
    idx = rng.integers(0, Q, (K, 1 if rng.random() < 0.5 else T, Q, Q)
                       ).astype(itype)
    kind = rng.choice(["direct", "rows", "rows+lanes"])
    if kind == "direct":
        prog = pr.plan_tile_program(steps, idx, device="cpu")
        src = torch.rand(T, Q, Q)
    else:
        nload = int(rng.integers(1, Q + 1))
        lidx = (rng.integers(0, Q, (T * nload, Q)).astype(itype)
                if kind == "rows+lanes" else None)
        prog = pr.plan_tile_program(steps, idx,
                                    rowsrc=rng.integers(0, 300, T * nload),
                                    lidx=lidx, nload=nload, device="cpu")
        src = torch.rand(300, Q)
    mul = torch.rand(T, Q, Q) if rng.random() < 0.5 else None
    return prog, src, mul, bool(rng.random() < 0.5)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("itype", [np.int8, np.int32])
def test_chase_is_tile_permute_ref_on_random_programs(itype, seed):
    """Random programs, both index types (stored as int8): the backward
    chase bitwise the plain version."""
    rng = np.random.default_rng(seed + 100 * np.dtype(itype).itemsize)
    for _ in range(4):
        prog, src, mul, psum8 = _random_program(rng, itype)
        assert prog.idx.dtype == torch.int8
        assert prog.lidx is None or prog.lidx.dtype == torch.int8
        ops = {op for op, _ in prog.steps}
        assert prog.mode == (
            pr.COL_SLABS if ops == {"S"} and prog.lidx is None else
            pr.ROW_SLABS if ops == {"G"} else pr.FULL_TILE)
        want = pr.tile_permute_ref(prog, src, mul, psum8)
        got = chase(prog, src.numpy(), None if mul is None else mul.numpy(),
                    psum8)
        np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())


def test_launch_arguments_are_made_with_the_program():
    """The kernel's launch arguments between src and mul come from the
    program, made once: row index, lane index, nload, the one-byte index
    tiles, tiles per slot, the step code, the step count, the staged
    slots and the mode."""
    g = np.random.default_rng(0).integers(0, Q, (2, 1, Q, Q)).astype(np.int32)
    prog = pr.plan_tile_program("TG0TG1", g, device="cpu")
    assert prog.args == (None, None, Q, prog.idx.data_ptr(), 1, prog.code, 4,
                         0b11, pr.FULL_TILE)
    assert prog.idx.dtype == torch.int8
    assert torch.equal(prog.idx.long(), torch.from_numpy(g).long())
