"""Host-side partition planning: row (or column) splits into shards.

Counterpart of ``tpu_spmv/dist/partition.py``, a numpy copy, so every plan
is the reference's: ``plan_even`` (remainder over the first shards),
``plan_uniform`` (``global index = shard * C + local``, the layout the
sharded DIA kernels need) and ``plan_rows`` (boundaries at equal nnz
quantiles, or the even row split).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RowPlan", "plan_rows", "plan_even", "plan_uniform"]


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """A 1-D row (or column) partition into ``ndev`` contiguous shards."""

    starts: tuple[int, ...]       # len ndev+1; shard i owns [starts[i], starts[i+1])
    ndev: int
    length: int                   # total rows (== starts[-1])

    @property
    def counts(self) -> np.ndarray:
        s = np.asarray(self.starts)
        return s[1:] - s[:-1]

    @property
    def max_count(self) -> int:
        return int(self.counts.max()) if self.ndev else 0

    def owner_of(self, idx: np.ndarray) -> np.ndarray:
        """Owning shard of each global index (vectorized)."""
        return np.searchsorted(np.asarray(self.starts), idx, side="right") - 1


def plan_even(length: int, ndev: int) -> RowPlan:
    """Even split, remainder spread over the first shards."""
    base, rem = divmod(length, ndev)
    counts = np.full(ndev, base, dtype=np.int64)
    counts[:rem] += 1
    starts = np.zeros(ndev + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return RowPlan(tuple(int(s) for s in starts), ndev, length)


def plan_uniform(length: int, ndev: int) -> RowPlan:
    """Uniform split: shard ``i`` owns ``[i*C, min((i+1)*C, length))`` with
    ``C = ceil(length/ndev)``, so the padded chunks concatenate to the
    global array zero-padded at the end."""
    C = max(-(-length // ndev), 1)
    starts = tuple(min(i * C, length) for i in range(ndev + 1))
    return RowPlan(starts, ndev, length)


def plan_rows(indptr, ndev: int, *, balance: str = "nnz") -> RowPlan:
    """Partition rows of a CSR matrix into ``ndev`` contiguous shards.

    ``balance="nnz"`` places boundaries at equal nnz quantiles (each shard
    gets ~nnz/ndev entries); ``balance="rows"`` is the even row split."""
    indptr = np.asarray(indptr, dtype=np.int64)
    nrow = len(indptr) - 1
    if ndev < 1:
        raise ValueError("ndev must be >= 1")
    if balance == "rows":
        return plan_even(nrow, ndev)
    if balance != "nnz":
        raise ValueError(f"unknown balance mode {balance!r}")
    nnz = int(indptr[-1])
    targets = (np.arange(1, ndev) * nnz) // ndev
    # boundary rows: first row whose prefix-nnz reaches each target
    cuts = np.searchsorted(indptr[1:], targets, side="left") + 1
    starts = np.concatenate([[0], np.minimum(cuts, nrow), [nrow]])
    # monotone starts (degenerate cases: empty rows, tiny matrices)
    starts = np.maximum.accumulate(starts)
    return RowPlan(tuple(int(s) for s in starts), ndev, nrow)
