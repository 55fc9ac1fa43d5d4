"""The permutation on the rows of a block (``apply_permutation_batched``
in ``tpu_spmv_torch/kernels/permute.py``, K7d/K7e), on the CPU.

On the card the wrapper launches the plan's form (``gather_form``): a
two-pass plan on words of 1, 2 or 4 bytes runs ``permute_rows_two_pass``
(``csrc/permute.cu``), both passes over groups of ``two_pass_rows`` rows
in one launch of persistent blocks that take their items by ticket; any
other plan runs ``permute_gather_batched``, the direct gather that uses
each group of four loaded indices for the ``direct_rows`` rows of a
group.  These tests
run torch emulations of both forms on the plan's own arrays — the row
groups, a ragged last group, a ragged last chunk, the tickets' order and
the stage rows — bitwise against numpy's ``X[:, perm]`` (zero at
don't-care slots), hold the ticket order to what keeps the launch free of
deadlock, and hold the wrapper's choice of form.  The JAX package's side
is held in ``test_torch_permute.py``
(``test_apply_permutation_batched_matches_reference``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_spmv_torch.kernels import permute as tp

torch.set_num_threads(1)

#: words of 1, 2 and 4 bytes (the two-pass form's) and of 8
STAGED = [np.uint8, np.int16, np.float32]
WORDS = STAGED + [np.float64]


def ticket_order(nchunks: int, groups: int, lag: int) -> list:
    """The items of ``permute_rows_two_pass`` in ticket order, as the
    kernel decodes a ticket: ``(pass, i)``, item ``i`` of group ``i //
    nchunks`` and chunk ``i % nchunks``; pass-1 item ``i`` at time ``i``,
    pass-2 item ``i`` at ``i + lag``, pass 2 first on a tie."""
    items = groups * nchunks
    lead = min(lag, items)
    order = []
    for t in range(2 * items):
        if t < lead:
            order.append((1, t))
        elif t - lead < 2 * (items - lead):
            u = t - lead
            order.append((2, u // 2) if u % 2 == 0 else (1, lead + u // 2))
        else:
            order.append((2, t - items))
    return order


def lag_of(nchunks: int, grid: int) -> int:
    """The launch's lag of pass 2 behind pass 1 (``launch_rows``): K plus
    half the grid, at most 2 K."""
    return nchunks + min(nchunks, grid // 2)


def emulate_rows_two_pass(plan, X: torch.Tensor, grid: int = 7):
    """``permute_rows_two_pass`` on the plan's arrays: groups of
    ``two_pass_rows`` rows, items run in ticket order, every row's pairs
    in its own stage row (``STAGE_ALIGN``-word stride, starting as
    garbage), every wait checked to be on items already run."""
    nrhs, n = X.shape
    C, K = plan.chunk, plan.nchunks
    R = tp.two_pass_rows(X.element_size())
    groups = -(-nrhs // R)
    m = plan.src_off.numel()
    stride = -(-m // tp.STAGE_ALIGN) * tp.STAGE_ALIGN
    ptr = plan.bucket_ptr.long()
    src_off = plan.src_off.long() & 0xFFFF
    dst_off = plan.dst_off.long() & 0xFFFF
    stage = torch.from_numpy(np.random.default_rng(0).integers(
        0, 100, (nrhs, stride))).to(X.dtype)
    out = torch.empty_like(X)
    done = [0] * groups
    for which, i in ticket_order(K, groups, lag_of(K, grid)):
        g, c = divmod(i, K)
        rows = X[g * R:(g + 1) * R]
        st = stage[g * R:(g + 1) * R]
        if which == 1:
            chunk = rows[:, c * C:min((c + 1) * C, n)]
            lo, hi = int(ptr[c * K]), int(ptr[(c + 1) * K])
            st[:, lo:hi] = chunk[:, src_off[lo:hi]]
            done[g] += 1
        else:
            assert done[g] == K
            size = min(C, n - c * C)
            buf = torch.zeros(len(rows), C, dtype=X.dtype)
            for b in range(K):
                lo, hi = int(ptr[b * K + c]), int(ptr[b * K + c + 1])
                buf[:, dst_off[lo:hi]] = st[:, lo:hi]
            out[g * R:g * R + len(rows), c * C:c * C + size] = buf[:, :size]
    return out


def emulate_gather_batched(plan, X: torch.Tensor, group: int):
    """``permute_gather_batched``: groups of ``group`` rows, each thread's
    four perm entries (``-1`` past ``n``) used for every row of the group,
    the ragged last group and slot group cut off."""
    nrhs, n = X.shape
    groups = -(-n // 4)
    p = torch.full((groups * 4,), -1, dtype=torch.int64)
    p[:n] = plan.perm.long()
    p = p.view(groups, 4)
    out = torch.empty_like(X)
    for q0 in range(0, nrhs, group):
        rows = X[q0:q0 + group]
        v = torch.where(p >= 0, rows[:, p.clamp(min=0)],
                        torch.zeros((), dtype=X.dtype))
        out[q0:q0 + group] = v.reshape(len(rows), -1)[:, :n]
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


def _want(X: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return np.where(perm >= 0, X[:, np.where(perm >= 0, perm, 0)], 0)


@pytest.mark.parametrize("n", [1, 257, 5 * 256 + 77])
def test_rows_two_pass_emulated_equal_x_perm(n):
    """The emulated persistent two-pass launch on chunks of 256 words (one
    chunk, a ragged last chunk), bitwise ``X[:, perm]`` for every perm
    kind, int32 and int64 input, words of 1, 2 and 4 bytes (four, two and
    one row a group) and row counts of one group, a ragged last group and
    several groups."""
    rng = np.random.default_rng(n)
    for name, perm in _perms(n, n).items():
        for itype in (np.int32, np.int64):
            plan = tp._plan(perm.astype(itype), "cpu", "two_pass", 256)
            assert plan.method == "two_pass" and plan.chunk == 256
            for word in STAGED:
                R = tp.two_pass_rows(np.dtype(word).itemsize)
                for nrhs in (1, R + 1, 5 * R - 1):
                    X = rng.integers(1, 100, (nrhs, n)).astype(word)
                    y = emulate_rows_two_pass(plan, torch.from_numpy(X))
                    np.testing.assert_array_equal(
                        y.numpy(), _want(X, perm),
                        err_msg=f"{name} {itype} {word} {nrhs}")


def test_ticket_order_waits_only_on_earlier_tickets():
    """Every item of every launch shape appears once, and each wait of
    ``permute_rows_two_pass`` is on items with earlier tickets: pass 2 of
    a chunk after all K pass-1 items of its group.  A ticket is taken
    only by a running block, so the launch cannot deadlock, whatever the
    grid."""
    for K in (1, 2, 3, 7, 64):
        for groups in (1, 2, 3, 4, 5, 9):
            for grid in (1, 2, 264, 10**6):
                lag = lag_of(K, grid)
                assert lag >= K
                order = ticket_order(K, groups, lag)
                assert sorted(order) == sorted(
                    (w, i) for w in (1, 2) for i in range(groups * K))
                at = {item: t for t, item in enumerate(order)}
                for (which, i), t in at.items():
                    if which == 2:
                        g = i // K
                        assert all(at[1, g * K + b] < t for b in range(K)), (
                            K, groups, grid, i)
    # pass 2 of a group trails its pass 1 by the lag: K plus half the grid
    order = ticket_order(4, 3, lag_of(4, 6))
    assert order[:7] == [(1, 0), (1, 1), (1, 2), (1, 3), (1, 4), (1, 5),
                         (1, 6)]
    assert order[7:10] == [(2, 0), (1, 7), (2, 1)]


def test_gather_batched_emulated_equal_x_perm():
    """The emulated direct form on rows, bitwise ``X[:, perm]``: groups
    of 1, 2 and 4 rows, one row, a ragged last group of rows, n of one
    slot and n not a multiple of four, every perm kind, int32 and int64
    indices, words of 1, 2, 4 and 8 bytes."""
    rng = np.random.default_rng(9)
    for n in (1, 6, 1027):
        for name, perm in _perms(n, n).items():
            for itype in (np.int32, np.int64):
                plan = tp._plan(perm.astype(itype), "cpu", "direct",
                                tp.CHUNK)
                plan = dataclasses.replace(
                    plan, perm=torch.from_numpy(perm.astype(itype)))
                for word in WORDS:
                    X = rng.integers(1, 100, (11, n)).astype(word)
                    for group in (1, 2, 4):
                        for nrhs in (1, group + 1, 11):
                            y = emulate_gather_batched(
                                plan, torch.from_numpy(X[:nrhs]), group)
                            np.testing.assert_array_equal(
                                y.numpy(), _want(X[:nrhs], perm),
                                err_msg=f"{name} {itype} {word} {group}")


def test_gather_form_follows_the_plan():
    """The batched gather takes the plan's form as the single gather
    does: the two-pass form for a two-pass plan on 1-, 2- and 4-byte
    words, the direct form for 8-byte words and for a direct plan; a
    two-pass group holds 4 bytes of every slot; a direct group as many
    rows (4, 2, 1) as fit ``BATCH_L2_BYTES``."""
    assert tp.gather_form("two_pass", 1) == "two_pass"
    assert tp.gather_form("two_pass", 2) == "two_pass"
    assert tp.gather_form("two_pass", 4) == "two_pass"
    assert tp.gather_form("two_pass", 8) == "direct"
    for w in (1, 2, 4, 8):
        assert tp.gather_form("direct", w) == "direct"
    assert [tp.two_pass_rows(w) for w in (1, 2, 4)] == [4, 2, 1]
    assert tp.BATCH_L2_BYTES == 24 << 20
    assert tp.direct_rows(1_000_000, 4) == 4       # the natural band's
    assert tp.direct_rows(2_000_000, 4) == 2
    assert tp.direct_rows(4_194_304, 4) == 1       # the shuffled Poisson's
    assert tp.direct_rows(4_194_304, 8) == 1
    assert tp.direct_rows(1, 8) == 4
    rng = np.random.default_rng(2)
    scattered = tp.plan_permutation(rng.permutation(tp.TWO_PASS_MIN_N),
                                    device="cpu")
    local = tp.plan_permutation(np.arange(1000), device="cpu")
    for word in (torch.uint8, torch.int16, torch.float32, torch.float64):
        X = torch.zeros(2, 1, dtype=word)
        w = X.element_size()
        assert tp._staged(scattered, X) == (
            tp.gather_form(scattered.method, w) == "two_pass") == (w <= 4)
        assert not tp._staged(local, X)


def test_batched_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version, counts no
    launch, and gives ``X[:, perm]`` on either plan; it refuses a shape
    that is not ``[nrhs, n]`` and a plan on another device."""
    rng = np.random.default_rng(4)
    n = 3000
    perm = _perms(n, 4)["don't care"]
    X = torch.from_numpy(rng.random((5, n)))
    before = dict(tp.LAUNCHES)
    for form in ("direct", "two_pass"):
        plan = tp._plan(perm, "cpu", form, 256)
        y = tp.apply_permutation_batched(plan, X)
        np.testing.assert_array_equal(y.numpy(), _want(X.numpy(), perm))
        assert torch.equal(y, tp.apply_permutation_batched_ref(plan, X))
        assert torch.equal(emulate_gather_batched(
            plan, X, tp.direct_rows(n, X.element_size())), y)
        if form == "two_pass":
            assert torch.equal(emulate_rows_two_pass(plan, X.float()),
                               y.float())
    assert tp.LAUNCHES == before
    with pytest.raises(ValueError, match="nrhs"):
        tp.apply_permutation_batched(plan, X[0])
    with pytest.raises(ValueError, match="nrhs"):
        tp.apply_permutation_batched(plan, X[:, :-1])
    meta = tp.PermutationPlan(perm=plan.perm.to("meta"), n=n)
    with pytest.raises(ValueError, match="plan on meta"):
        tp.apply_permutation_batched(meta, X)
