"""The planned two-pass permutation (``plan_permutation`` in
``tpu_spmv_torch/kernels/permute.py``), on the CPU.

On the card a scattered perm is applied in two passes through shared
memory (``permute_pass1`` and ``permute_pass2`` in
``tpu_spmv_torch/csrc/permute.cu``) along arrays the plan builds once.
These tests run a torch emulation of both passes on the plan's own arrays
— pass 1 stages each source chunk and writes its pairs to the stage in
plan order, pass 2 zeroes each destination chunk and copies its buckets to
their planned offsets — bitwise against numpy's ``x[perm]`` on every edge
the kernels have (one chunk, a ragged last chunk, repeated entries,
don't-care slots, int32 and int64 input, words of 1, 2, 4 and 8 bytes),
and hold the plan's choice between that form and the direct gather.  The
JAX package's side of ``apply_permutation`` is held in
``test_torch_permute.py``.
"""

import numpy as np
import pytest
import torch

from tpu_spmv_torch.kernels import permute as tp

torch.set_num_threads(1)

#: words of 1, 2, 4 and 8 bytes
WORDS = [np.uint8, np.int16, np.float32, np.float64]


def emulate_two_pass(plan: tp.PermutationPlan, x: torch.Tensor):
    """Both passes of the two-pass gather on the plan's arrays."""
    n, C, K = plan.n, plan.chunk, plan.nchunks
    ptr = plan.bucket_ptr.long()
    # the kernels read the offsets as uint16
    src_off = plan.src_off.long() & 0xFFFF
    dst_off = plan.dst_off.long() & 0xFFFF
    stage = torch.empty(plan.src_off.numel(), dtype=x.dtype)
    for b in range(K):                    # pass 1: one block a source chunk
        chunk = x[b * C:min((b + 1) * C, n)]
        lo, hi = int(ptr[b * K]), int(ptr[(b + 1) * K])
        assert bool((src_off[lo:hi] < chunk.numel()).all())
        stage[lo:hi] = chunk[src_off[lo:hi]]
    out = torch.empty_like(x)
    for k in range(K):                    # pass 2: one block a destination
        size = min(C, n - k * C)
        buf = torch.zeros(C, dtype=x.dtype)
        for b in range(K):
            lo, hi = int(ptr[b * K + k]), int(ptr[b * K + k + 1])
            assert bool((dst_off[lo:hi] < size).all())
            buf[dst_off[lo:hi]] = stage[lo:hi]
        out[k * C:k * C + size] = buf[:size]
    return out


def _perms(n: int, seed: int) -> dict:
    """Index vectors of ``n`` slots (negative = don't care)."""
    rng = np.random.default_rng(seed)
    local = np.argsort(np.arange(n) + rng.integers(-16, 17, n), kind="stable")
    dc = rng.permutation(n)
    dc[rng.random(n) < 0.1] = -1
    return {"identity": np.arange(n), "random": rng.permutation(n),
            "banded RCM-like": local, "repeated": rng.integers(0, n, n),
            "don't care": dc, "all don't care": np.full(n, -1)}


def _want(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return np.where(perm >= 0, x[np.where(perm >= 0, perm, 0)], 0)


@pytest.mark.parametrize("n", [1, 31, 255, 256, 257, 5 * 256 + 77])
def test_two_passes_emulated_equal_x_perm(n):
    """The emulated passes on chunks of 256 words, bitwise ``x[perm]``, for
    every perm kind, int32 and int64 input and every word size."""
    rng = np.random.default_rng(n)
    for name, perm in _perms(n, n).items():
        for itype in (np.int32, np.int64):
            plan = tp._plan(perm.astype(itype), "cpu", "two_pass", 256)
            assert plan.method == "two_pass" and plan.chunk == 256
            assert plan.nchunks == -(-n // 256)
            for word in WORDS:
                x = rng.integers(1, 100, n).astype(word)
                y = emulate_two_pass(plan, torch.from_numpy(x)).numpy()
                np.testing.assert_array_equal(y, _want(x, perm),
                                              err_msg=f"{name} {word}")


def test_plan_arrays_are_the_stage_order():
    """The stage holds the pairs ``(perm[i], i)``, ``perm[i] >= 0``, in
    (source chunk, destination chunk) order and, inside a bucket, in
    destination order; offsets fit 16 bits; the buckets tile the stage;
    ``two_pass_pairs`` and the passes' plain versions agree."""
    n, C = 3 * 1024 + 500, 1024
    perm = _perms(n, 3)["don't care"]
    plan = tp._plan(torch.from_numpy(perm), "cpu", "two_pass", C)
    K = plan.nchunks
    ptr = plan.bucket_ptr.numpy()
    assert plan.bucket_ptr.dtype == torch.int32 and ptr.shape == (K * K + 1,)
    assert ptr[0] == 0 and ptr[-1] == (perm >= 0).sum()
    assert np.all(np.diff(ptr) >= 0)
    assert plan.src_off.dtype == plan.dst_off.dtype == torch.int16
    src_off, dst_off = plan.src_off.numpy(), plan.dst_off.numpy()
    assert src_off.min() >= 0 and dst_off.min() >= 0
    seen = []
    for b in range(K):
        for k in range(K):
            lo, hi = ptr[b * K + k], ptr[b * K + k + 1]
            src, dst = b * C + src_off[lo:hi], k * C + dst_off[lo:hi]
            np.testing.assert_array_equal(perm[dst], src)
            assert np.all(np.diff(dst) > 0)
            seen.append(dst)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.flatnonzero(perm >= 0))
    assert torch.equal(plan.perm, torch.from_numpy(perm.astype(np.int32)))
    # the pairs and the plain version of each pass read the same arrays
    src, dst = tp.two_pass_pairs(plan)
    np.testing.assert_array_equal(np.concatenate(seen), dst.numpy())
    np.testing.assert_array_equal(perm[dst.numpy()], src.numpy())
    x = torch.from_numpy(np.random.default_rng(8).random(n))
    stage, out = tp.two_pass_ref(plan, x)
    assert torch.equal(stage, x[src])
    assert torch.equal(out, emulate_two_pass(plan, x))


def test_far_share_counts_neighbours_read_far_apart():
    """0 for the identity, its reverse and a shift, near 0 for a shuffle
    inside windows of ``reach`` words (only neighbours across a window's
    edge); about 1 for a random perm and about 2 f for one that sends a
    share f of its slots far; don't-care slots skipped."""
    n, reach = 1 << 14, 256
    ident = torch.arange(n)
    assert tp.far_share(ident, reach) == 0.0
    assert tp.far_share(ident.flip(0), reach) == 0.0
    assert tp.far_share((ident + 1000) % n, reach) < 2 / n
    rng = np.random.default_rng(4)
    window = torch.from_numpy((rng.random((n // reach, reach)).argsort(1)
                               + np.arange(0, n, reach)[:, None]).ravel())
    assert tp.far_share(window, reach) < 2 / reach   # at window edges
    assert tp.far_share(torch.from_numpy(rng.permutation(n)), reach) > 0.95
    some = np.arange(n)
    moved = np.flatnonzero(rng.random(n) < 0.1)
    some[moved] = rng.permutation(moved)
    assert 0.15 < tp.far_share(torch.from_numpy(some), reach) < 0.2
    half = ident.clone()
    half[1::2] = -1
    assert tp.far_share(half, reach) == 0.0
    assert tp.far_share(torch.full((n,), -1), reach) == 0.0


def test_plan_picks_its_form():
    """The direct gather below ``TWO_PASS_MIN_N`` (K7a's 16384-entry
    tile among them), on a local perm (the identity, its reverse, a banded
    shuffle) and where the bucket table outgrows its share of the index
    bytes; the two-pass form on a scattered perm past that size, for words
    of up to 4 bytes (8-byte words take the direct gather).  Either form
    gives the same bits."""
    rng = np.random.default_rng(5)
    n = tp.TWO_PASS_MIN_N
    scattered = rng.permutation(n)
    plan = tp.plan_permutation(scattered, device="cpu")
    assert (plan.method, plan.chunk) == ("two_pass", tp.CHUNK)
    assert plan.nchunks ** 2 <= tp.TABLE_SHARE * n
    for word, staged in ((torch.uint8, True), (torch.int16, True),
                         (torch.float32, True), (torch.float64, False)):
        assert tp._staged(plan, torch.zeros(1, dtype=word)) == staged
    for perm in (np.arange(n), np.arange(n)[::-1].copy(),
                 _perms(n, 6)["banded RCM-like"]):
        assert tp.plan_permutation(perm, device="cpu").method == "direct"
    small = rng.permutation(n - 1)
    assert tp.plan_permutation(small, device="cpu").method == "direct"
    assert tp.far_share(torch.from_numpy(scattered)) >= tp.FAR_SHARE
    tile = tp.plan_tile_permutation(rng.permutation(tp.TILE), device="cpu")
    assert tile.method == "direct" and tile.src_off is None
    assert not tp._staged(tp.plan_permutation(np.arange(n), device="cpu"),
                          torch.zeros(1))
    # chunks of 256 words: K = 8192 and a table of 67M starts, past its
    # share of two million slots' index bytes
    assert tp._plan(scattered, "cpu", "auto", 256).method == "direct"
    forced = tp._plan(rng.permutation(5000), "cpu", "two_pass", 256)
    x = torch.from_numpy(rng.random(5000))
    assert torch.equal(emulate_two_pass(forced, x),
                       tp.apply_permutation(forced, x))


def test_plan_refuses_bad_arguments():
    """An unknown form, a chunk that is no power of two in [MIN_CHUNK,
    CHUNK], and a forced two-pass plan of more chunks than the kernels
    take are refused; an empty perm plans to the direct form."""
    with pytest.raises(ValueError, match="form"):
        tp._plan(np.arange(4), "cpu", "clos", tp.CHUNK)
    for chunk in (128, 1000, 32768):
        with pytest.raises(ValueError, match="chunk"):
            tp._plan(np.arange(4), "cpu", "auto", chunk)
    with pytest.raises(ValueError, match="chunks"):
        tp._plan(np.arange(tp.MAX_CHUNKS * 256 + 1), "cpu", "two_pass", 256)
    empty = tp._plan(np.zeros(0, dtype=np.int64), "cpu", "two_pass",
                     tp.CHUNK)
    assert empty.method == "direct" and empty.n == 0
