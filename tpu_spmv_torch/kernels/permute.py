"""The permutation engine — ``out[i] = x[perm[i]]`` — as one gather, or as
a planned two-pass gather through shared memory.

Counterpart of ``tpu_spmv/kernels/permute.py``.  The reference routes an
arbitrary permutation on the host as a Clos network (``plan_permutation``:
int8 lane-gather planes, a row exchange, a two-level form past ~1.6M
entries) because a TPU gathers fast only inside 128 lanes; its Pallas
kernels K7a–K7e apply the planes in stages.  A Hopper thread reads any
address, but a scattered 4-byte read costs a 32-byte L2 sector request,
and a permutation is planned once and applied many times
(``ReorderedOperator`` runs two gathers per product).  So the port's plan
picks one of two forms:

- the direct gather (``permute_gather`` of ``csrc/permute.cu``): small
  ``n``, perms whose neighbouring slots mostly read nearby sources
  (:func:`far_share`), and where the two-pass bucket table would be too
  large;
- the two-pass gather (``permute_pass1`` then ``permute_pass2``, launched
  together) for words of 1, 2 and 4 bytes (8-byte words take the direct
  gather, which was as fast in f64): source and destination cut into
  chunks of ``CHUNK`` words,
  the pairs ``(perm[i], i)`` ordered by (source chunk, destination chunk);
  pass 1 stages each source chunk in shared memory and writes its pairs
  to a stage buffer in that order, pass 2 gathers each destination chunk's
  buckets into shared memory and stores the chunk, so no read of device
  memory is scattered.

:class:`PermutationPlan` holds ``perm`` on the device (int32 while ``n <
2**31``, else int64) and ``n`` — what the direct and the batched gathers
and the plain versions read — and, for the two-pass form, the per-pair
offsets inside the chunks (int16 holding values below ``chunk``, read as
uint16) and the bucket starts (int32).  :func:`plan_permutation` and
:func:`plan_permutation_auto` give the same plan at every ``n``.
:func:`apply_permutation` (K7a–K7c) launches the plan's form;
:func:`apply_permutation_batched` (K7d/K7e) launches the plan's form on
``[nrhs, n]`` with one perm for every row (:func:`gather_form` picks it
for both): ``permute_rows_two_pass``, both passes over groups of
:func:`two_pass_rows` rows in one persistent launch, or
``permute_gather_batched``, the direct gather with each loaded index used
for the :func:`direct_rows` rows of a group;
:func:`plan_tile_permutation` / :func:`apply_tile_permutation` are the same
gather on one ``[128, 128]`` tile (16384 entries: the direct form).

A negative ``perm[i]`` is a don't-care slot, as in the reference; the
reference leaves garbage there, the port writes zero.  Entries may repeat.
The kernels move words without arithmetic, so the result is bitwise
``x[perm]``.

On a CUDA tensor the wrappers launch the kernels and count the launch in
:data:`LAUNCHES`; on a CPU tensor they run the plain versions (``*_ref``,
an ``index_select``).  Nothing falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.base import sparse_dataclass
from . import _build

__all__ = ["Q", "TILE", "LAUNCHES", "CHUNK", "PermutationPlan",
           "permute_reference", "far_share", "plan_permutation",
           "two_pass_pairs", "two_pass_ref", "gather_form",
           "two_pass_rows", "direct_rows", "STAGE_ALIGN",
           "BATCH_L2_BYTES",
           "plan_permutation_auto", "plan_tile_permutation",
           "apply_permutation", "apply_permutation_ref",
           "apply_permutation_batched", "apply_permutation_batched_ref",
           "apply_tile_permutation", "apply_tile_permutation_ref"]

#: the reference's tile edge; a tile permutation has ``TILE`` entries
Q = 128
TILE = Q * Q
#: kernel launches by the wrappers on CUDA tensors (plain-version calls on
#: CPU tensors are not counted); ``permute_two_pass`` counts one launch of
#: the two-pass form's both passes, ``permute_pass`` one pass launched
#: alone to time it; ``permute_batched`` the direct form on rows,
#: ``permute_batched_two_pass`` the two-pass form on rows (both passes)
LAUNCHES = {"permute": 0, "permute_two_pass": 0, "permute_pass": 0,
            "permute_batched": 0, "permute_batched_two_pass": 0}
_WORD_BYTES = (1, 2, 4, 8)
#: the two-pass form's words (8-byte words take the direct gather)
_STAGED_BYTES = (1, 2, 4)
#: the two-pass form's chunk (words a block stages in shared memory, 64
#: KiB of 4-byte words); a forced plan may take a power of two between
#: ``MIN_CHUNK`` and ``CHUNK``, where every offset fits 16 bits
CHUNK = 16384
MIN_CHUNK = 256
#: neighbouring reads of the direct gather this close (4 KB of 4-byte
#: words) cost no more than the identity's
FAR_REACH = 1024
#: the plan's rule takes the direct gather below this many slots (two
#: launches cost more than the scattered reads save) ...
TWO_PASS_MIN_N = 1 << 21
#: ... where fewer than this share of neighbouring slots read sources more
#: than ``FAR_REACH`` words apart (:func:`far_share`) ...
FAR_SHARE = 0.9
#: ... and where the bucket table (``K * K + 1`` int32 starts, ``K``
#: chunks) would hold more than this share of the index bytes (4 per
#: slot): beyond it a bucket averages fewer than 8 words (one sector).
#: At ``CHUNK`` it keeps ``K`` to ``CHUNK / 8``, inside ``MAX_CHUNKS``
TABLE_SHARE = 1 / 8
#: the most chunks the kernels take (pass 2 keeps two ints a chunk in
#: shared memory beside its chunk); a forced plan with more is refused
MAX_CHUNKS = 4096
#: the direct form on rows gathers a group of rows with each group of four
#: loaded indices; the group's rows are all in flight at once, and a
#: scattered perm reads all of each, so they are as many (4, 2 or 1) as
#: keep within this many bytes, a share of the card's 50 MB L2 (four rows
#: of 4,194,304 f32 values missed it: 2.2x one slot a thread's time)
BATCH_L2_BYTES = 24 << 20
#: the two-pass form on rows gives every row its own stage row of the
#: plan's pairs, rounded up to a multiple of this many words (whole
#: 128-byte lines of 4-byte words: pass 2 reads them through L1, so no
#: line may hold two rows)
STAGE_ALIGN = 32
_FORMS = ("auto", "direct", "two_pass")


def permute_reference(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``out[i] = x[perm[i]]`` (numpy oracle, the reference's)."""
    return np.asarray(x).ravel()[perm].reshape(np.asarray(x).shape)


@sparse_dataclass
class PermutationPlan:
    """``out.flat[i] = x.flat[perm[i]]`` for ``i < n``; ``perm[i] < 0`` is
    a don't-care slot (written as zero).  ``method`` is ``"direct"`` or
    ``"two_pass"``; a two-pass plan also holds, for its ``m`` pairs in
    stage order, their offsets inside the source and the destination
    chunk, and the start of each (source chunk, destination chunk) bucket
    in that order."""

    perm: torch.Tensor          # [n] int32 (int64 when n >= 2**31)
    n: int
    method: str = "direct"      # the form for words of up to 4 bytes
    chunk: int = 0              # words a chunk (two-pass form)
    src_off: torch.Tensor | None = None     # [m] int16, in stage order
    dst_off: torch.Tensor | None = None     # [m] int16, in stage order
    bucket_ptr: torch.Tensor | None = None  # [K * K + 1] int32

    @property
    def nchunks(self) -> int:
        """``K``, the chunks of the source and of the destination."""
        return -(-self.n // self.chunk) if self.chunk else 0


def far_share(perm: torch.Tensor, reach: int = FAR_REACH) -> float:
    """The share of neighbouring slots ``i - 1, i`` (both with a source)
    whose sources lie more than ``reach`` words apart: 0 for the identity,
    its reverse, a shift or a shuffle inside windows of ``reach`` words,
    about 1 for a random perm (a perm that sends a share ``f`` of its slots
    far scores about ``2 f``); 0 where fewer than two slots have one."""
    src = perm[perm >= 0].long()
    if src.numel() < 2:
        return 0.0
    return float(((src[1:] - src[:-1]).abs() > reach).double().mean())


def _pick(p: torch.Tensor, n: int, chunk: int, form: str) -> str:
    """The form the plan takes (see the rule's constants)."""
    nchunks = -(-n // chunk)
    if n == 0 or n >= 2**31:
        return "direct"
    if form == "two_pass" and nchunks > MAX_CHUNKS:
        raise ValueError(f"two_pass: {nchunks} chunks of {chunk} words, "
                         f"more than {MAX_CHUNKS}")
    if form != "auto":
        return form
    if (n < TWO_PASS_MIN_N or nchunks * nchunks > TABLE_SHARE * n
            or far_share(p) < FAR_SHARE):
        return "direct"
    return "two_pass"


def _two_pass_arrays(p: torch.Tensor, n: int, chunk: int):
    """``(src_off, dst_off, bucket_ptr)`` of the pairs ``(p[i], i)``,
    ``p[i] >= 0``, ordered stably by (source chunk, destination chunk)."""
    shift = chunk.bit_length() - 1
    nchunks = -(-n // chunk)
    dst = torch.nonzero(p >= 0).squeeze(1)
    src = p[dst]
    key, order = torch.sort((src >> shift) * nchunks + (dst >> shift),
                            stable=True)
    src_off = (src[order] & (chunk - 1)).to(torch.int16)
    dst_off = (dst[order] & (chunk - 1)).to(torch.int16)
    bucket_ptr = torch.searchsorted(
        key, torch.arange(nchunks * nchunks + 1, device=p.device))
    return (src_off.contiguous(), dst_off.contiguous(),
            bucket_ptr.to(torch.int32))


def plan_permutation(perm, *, device="cuda") -> PermutationPlan:
    """The plan of an index vector (numpy or torch; entries ``< n``,
    negative = don't care) on ``device`` (default: the card), built there
    with torch ops.

    It takes the two-pass form, chunks of ``CHUNK`` words, for a perm of
    at least ``TWO_PASS_MIN_N`` slots whose neighbouring slots nearly all
    read far apart (``far_share >= FAR_SHARE``) and whose bucket table
    fits ``TABLE_SHARE``, the direct form otherwise."""
    return _plan(perm, device, "auto", CHUNK)


def _plan(perm, device, form: str, chunk: int) -> PermutationPlan:
    """:func:`plan_permutation` with its form (``"auto"``, or ``"direct"``
    and ``"two_pass"`` forced: both give the same bits) and the two-pass
    chunk in words chosen, for tests and timing."""
    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}, got {form!r}")
    if (chunk & (chunk - 1) or not MIN_CHUNK <= chunk <= CHUNK):
        raise ValueError(f"chunk must be a power of two in [{MIN_CHUNK}, "
                         f"{CHUNK}], got {chunk}")
    if isinstance(perm, torch.Tensor):
        p = perm.detach().to(device=device, dtype=torch.int64)
    else:
        p = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(device)
    if p.dim() != 1:
        raise ValueError(f"perm must be 1-D, got shape {tuple(p.shape)}")
    n = int(p.shape[0])
    if n and int(p.max()) >= n:
        raise ValueError(f"perm entries must be < n = {n}")
    p = torch.clamp(p, min=-1)
    idx = p.to(torch.int32) if n < 2**31 else p
    if _pick(p, n, chunk, form) == "direct":
        return PermutationPlan(perm=idx.contiguous(), n=n)
    src_off, dst_off, bucket_ptr = _two_pass_arrays(p, n, chunk)
    return PermutationPlan(perm=idx.contiguous(), n=n, method="two_pass",
                           chunk=chunk, src_off=src_off, dst_off=dst_off,
                           bucket_ptr=bucket_ptr)


def plan_permutation_auto(perm, *, device="cuda") -> PermutationPlan:
    """:func:`plan_permutation` at every ``n``: the reference's
    single-level cap and two-level routing are VMEM and Clos facts."""
    return plan_permutation(perm, device=device)


def plan_tile_permutation(perm, *, device="cuda") -> PermutationPlan:
    """The plan of a permutation of one ``[128, 128]`` tile (flat,
    row-major; ``TILE`` entries)."""
    if tuple(np.shape(perm)) != (TILE,):
        raise ValueError(f"perm must have {TILE} entries")
    return plan_permutation(perm, device=device)


def _check(name: str, plan: PermutationPlan, x: torch.Tensor) -> None:
    if plan.perm.device != x.device:
        raise ValueError(f"{name}: plan on {plan.perm.device}, x on "
                         f"{x.device}")
    if x.element_size() not in _WORD_BYTES:
        raise TypeError(f"{name}: no kernel for {x.dtype}")


def _gather_ref(plan: PermutationPlan, x2: torch.Tensor) -> torch.Tensor:
    """``x2[..., perm]`` along the last axis, zero at don't-care slots."""
    idx = plan.perm.long()
    out = torch.index_select(x2, -1, idx.clamp(min=0))
    return torch.where(idx >= 0, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))


def _launch(kernel: str, key: str, plan: PermutationPlan, src: torch.Tensor,
            *rows: int) -> torch.Tensor:
    """``permute_gather`` on a flat ``src``, or with ``rows`` (nrhs, rows
    a group) ``permute_gather_batched`` on ``[nrhs, n]``."""
    out = torch.empty_like(src)
    nrhs, group = rows[:1], rows[1:]
    _build.launcher(kernel)(
        src, src.data_ptr(), plan.perm.data_ptr(), plan.perm.element_size(),
        out.data_ptr(), plan.n, *nrhs, src.element_size(), *group)
    LAUNCHES[key] += 1
    return out


def two_pass_pairs(plan: PermutationPlan) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``(src, dst)``: the source and destination slot of every pair of a
    two-pass plan, in stage order (``perm[dst] == src``)."""
    K, C = plan.nchunks, plan.chunk
    bucket = torch.repeat_interleave(
        torch.arange(K * K, device=plan.perm.device),
        torch.diff(plan.bucket_ptr.long()))
    src = (bucket // K) * C + (plan.src_off.long() & 0xFFFF)
    dst = (bucket % K) * C + (plan.dst_off.long() & 0xFFFF)
    return src, dst


def two_pass_ref(plan: PermutationPlan, x: torch.Tensor):
    """Plain version of the two passes on a flat ``x``: ``(stage, out)``,
    pass 1's stage (``x`` at each pair's source, in stage order) and pass
    2's output (the stage at each pair's destination, zero elsewhere)."""
    src, dst = two_pass_pairs(plan)
    stage = torch.index_select(x, 0, src)
    out = torch.zeros_like(x).index_copy_(0, dst, stage)
    return stage, out


def gather_form(method: str, word_bytes: int) -> str:
    """The form a plan of ``method`` gathers words of ``word_bytes`` with,
    one vector or the rows of a block alike: ``"two_pass"`` for a
    two-pass plan on words of 1, 2 or 4 bytes, else ``"direct"`` (8-byte
    words gather directly: the two forms were level in f64)."""
    return ("two_pass" if method == "two_pass" and word_bytes in
            _STAGED_BYTES else "direct")


def two_pass_rows(word_bytes: int) -> int:
    """Rows a group of the two-pass form on rows holds: 4 bytes of every
    slot (one row of 4-byte words, two of 2-byte, four of 1-byte), so
    that a group's chunks take 64 KiB of shared memory at ``CHUNK`` and
    its stage is one 4-byte row's, while each offset a block loads serves
    every row of the group."""
    return 4 // word_bytes


def direct_rows(n: int, word_bytes: int) -> int:
    """Rows a group of the direct form on rows holds: 4, 2 or 1, the most
    whose ``n`` words each fit ``BATCH_L2_BYTES`` together."""
    return next((r for r in (4, 2) if r * n * word_bytes <= BATCH_L2_BYTES),
                1)


def _staged(plan: PermutationPlan, x: torch.Tensor) -> bool:
    """Whether ``x`` goes through the two-pass form of ``plan``."""
    return gather_form(plan.method, x.element_size()) == "two_pass"


def _two_pass(plan: PermutationPlan, src: torch.Tensor) -> torch.Tensor:
    """Both passes of a two-pass plan on a flat CUDA ``src`` of 1-, 2- or
    4-byte words; the stage, one word per pair, comes from the caching
    allocator."""
    stage = torch.empty(plan.src_off.numel(), dtype=src.dtype,
                        device=src.device)
    out = torch.empty_like(src)
    _build.launcher("permute_two_pass")(
        src, src.data_ptr(), plan.src_off.data_ptr(), plan.dst_off.data_ptr(),
        plan.bucket_ptr.data_ptr(), stage.data_ptr(), out.data_ptr(), plan.n,
        plan.chunk.bit_length() - 1, src.element_size())
    LAUNCHES["permute_two_pass"] += 1
    return out


def _one_pass(plan: PermutationPlan, src: torch.Tensor,
              which: int) -> torch.Tensor:
    """One pass of a two-pass plan alone, to time it: pass 1 from a flat
    CUDA ``x`` to a new stage, pass 2 from a stage that pass 1 filled to
    a new output of ``plan.n`` words."""
    if not _staged(plan, src):
        raise ValueError("one pass: not a two-pass plan of 1-, 2- or "
                         "4-byte words")
    m = plan.src_off.numel()
    if src.numel() != (plan.n if which == 1 else m):
        raise ValueError(f"pass {which}: {src.numel()} words in")
    dst = torch.empty(m if which == 1 else plan.n, dtype=src.dtype,
                      device=src.device)
    off = plan.src_off if which == 1 else plan.dst_off
    _build.launcher(f"permute_pass{which}")(
        src, src.data_ptr(), off.data_ptr(), plan.bucket_ptr.data_ptr(),
        dst.data_ptr(), plan.n, plan.chunk.bit_length() - 1,
        src.element_size())
    LAUNCHES["permute_pass"] += 1
    return dst


def apply_permutation_ref(plan: PermutationPlan,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7a–K7c: ``x.flat[perm]`` in ``x``'s shape."""
    return _gather_ref(plan, x.reshape(-1)).reshape(x.shape)


def apply_permutation(plan: PermutationPlan, x: torch.Tensor) -> torch.Tensor:
    """``out.flat[i] = x.flat[perm[i]]`` in ``x``'s shape (``x.numel() ==
    plan.n``).

    CUDA tensor: launches the plan's form (``csrc/permute.cu``:
    ``permute_gather``, or ``permute_pass1`` and ``permute_pass2`` for
    words of up to 4 bytes); CPU tensor: :func:`apply_permutation_ref`."""
    _check("apply_permutation", plan, x)
    if x.numel() != plan.n:
        raise ValueError(f"apply_permutation: x has {x.numel()} elements, "
                         f"the plan {plan.n}")
    if x.is_cpu:
        return apply_permutation_ref(plan, x)
    src = x.reshape(-1).contiguous()
    if _staged(plan, src):
        return _two_pass(plan, src).reshape(x.shape)
    return _launch("permute_gather", "permute", plan, src).reshape(x.shape)


def apply_permutation_batched_ref(plan: PermutationPlan,
                                  X: torch.Tensor) -> torch.Tensor:
    """Plain version of K7d/K7e: ``X[:, perm]``."""
    return _gather_ref(plan, X)


def _rows_two_pass(plan: PermutationPlan, X: torch.Tensor) -> torch.Tensor:
    """Both passes of a two-pass plan on the rows of a contiguous CUDA
    ``X [nrhs, n]`` of 1-, 2- or 4-byte words, in one launch; the stage
    (a row of the plan's pairs for every row of ``X``) and the launch's
    counters come from the caching allocator."""
    nrhs, w = X.shape[0], X.element_size()
    rows = two_pass_rows(w)
    stride = -(-plan.src_off.numel() // STAGE_ALIGN) * STAGE_ALIGN
    stage = torch.empty(nrhs * stride, dtype=X.dtype, device=X.device)
    counters = torch.empty(2 + -(-nrhs // rows), dtype=torch.int32,
                           device=X.device)
    out = torch.empty_like(X)
    _build.launcher("permute_rows_two_pass")(
        X, X.data_ptr(), plan.src_off.data_ptr(), plan.dst_off.data_ptr(),
        plan.bucket_ptr.data_ptr(), stage.data_ptr(), counters.data_ptr(),
        out.data_ptr(), plan.n, stride, nrhs, plan.chunk.bit_length() - 1, w,
        rows)
    LAUNCHES["permute_batched_two_pass"] += 1
    return out


def apply_permutation_batched(plan: PermutationPlan,
                              X: torch.Tensor) -> torch.Tensor:
    """One permutation applied to every row: ``X [nrhs, n]`` → same
    shape, ``out[q, i] = X[q, perm[i]]``.

    CUDA tensor: launches the plan's form (:func:`gather_form`;
    ``csrc/permute.cu``: ``permute_rows_two_pass``, or
    ``permute_gather_batched``); CPU tensor:
    :func:`apply_permutation_batched_ref`."""
    _check("apply_permutation_batched", plan, X)
    if X.dim() != 2 or X.shape[1] != plan.n:
        raise ValueError(f"apply_permutation_batched: X must be [nrhs, "
                         f"{plan.n}], got {tuple(X.shape)}")
    if X.is_cpu:
        return apply_permutation_batched_ref(plan, X)
    if not X.is_contiguous():
        raise ValueError("apply_permutation_batched: X must be contiguous")
    if X.shape[0] == 0:
        return torch.empty_like(X)
    if _staged(plan, X):
        return _rows_two_pass(plan, X)
    return _launch("permute_gather_batched", "permute_batched", plan, X,
                   X.shape[0], direct_rows(plan.n, X.element_size()))


def apply_tile_permutation_ref(x: torch.Tensor,
                               plan: PermutationPlan) -> torch.Tensor:
    """Plain version of K7a on one ``[128, 128]`` tile."""
    return apply_permutation_ref(plan, x)


def apply_tile_permutation(x: torch.Tensor,
                           plan: PermutationPlan) -> torch.Tensor:
    """Apply a tile plan to a ``[128, 128]`` array (the reference's
    argument order): ``permute_gather`` over the flat tile."""
    if tuple(x.shape) != (Q, Q) or plan.n != TILE:
        raise ValueError(f"apply_tile_permutation: needs a [{Q}, {Q}] tile "
                         f"and a {TILE}-entry plan, got {tuple(x.shape)} and "
                         f"{plan.n}")
    return apply_permutation(plan, x)
