"""Sharded matrix and vector containers.

Counterpart of ``tpu_spmv/dist/sharded.py``.  The reference stacks every
leaf as one ``[ndev, ...]`` array that a ``NamedSharding`` spreads over
the mesh; here each array field is a tuple of per-shard tensors, shard
``s``'s on the device that holds shard ``s`` (:func:`.spmv.place` moves
them there).  The builders are host numpy and lay the entries out as the
reference does, bucket for bucket:

- :class:`ShardedCSR` — the all-gather strategy: column ids in padded
  gathered-x space (``owner * C + local``);
- :class:`HaloCSR` — the ring: bucket ``t`` of shard ``s`` holds the
  entries whose x chunk shard ``(s - t) mod ndev`` owns, with column ids
  in that chunk;
- :class:`NeighborCSR` — the neighbour halo: an interior bucket (columns
  in the own chunk) and a boundary bucket indexing the window of the
  neighbour chunks the shards touch;
- :class:`ColShardedCSR` — the column split: global row ids into the
  padded ``[ndev * R]`` y that the shards' partial products sum into.

Every bucket keeps the reference's padding (row 0, column 0, value 0 past
its entries).  Beside it the port keeps each bucket's row pointer
(``rowptr``, int64): a bucket's live entries are sorted by row, so its
product is a gather and one ``torch.segment_reduce`` over that pointer —
row-owned, with no atomics, as in :mod:`..ops.spmv`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.base import torch_dtype
from .partition import RowPlan, plan_even, plan_rows, plan_uniform

__all__ = ["ShardedVector", "ShardedCSR", "HaloCSR", "NeighborCSR",
           "ColShardedCSR"]


def _csr_host_arrays(csr):
    """``(indptr, indices, data, row_ids, shape)`` as host numpy from a
    port CSR or a scipy CSR."""
    if isinstance(csr.data, torch.Tensor):
        indptr, cols, data = (csr.indptr.cpu().numpy(),
                              csr.indices.cpu().numpy(),
                              csr.data.cpu().numpy())
    else:
        indptr, cols, data = csr.indptr, csr.indices, csr.data
    indptr = np.asarray(indptr, dtype=np.int64)
    row_ids = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                        np.diff(indptr))
    return (indptr, np.asarray(cols, dtype=np.int64), np.asarray(data),
            row_ids, (int(csr.shape[0]), int(csr.shape[1])))


def _rowptr(rows: np.ndarray, data: np.ndarray, nrows: int) -> np.ndarray:
    """Row pointer ``[nrows + 1]`` of one padded bucket: its entries sorted
    by row, then padding (row 0, value 0).  The segments end at the last
    entry that is not (row 0, value 0); what follows adds nothing."""
    live = np.flatnonzero((rows != 0) | (data != 0))
    n = int(live[-1]) + 1 if live.size else 0
    ptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[:n], minlength=nrows), out=ptr[1:])
    return ptr


def _t(a: np.ndarray, index: bool = False) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=np.int32 if index else None)
    return torch.from_numpy(a)


def _split(a: np.ndarray, index: bool = False) -> tuple[torch.Tensor, ...]:
    """One tensor per shard of a stacked ``[ndev, ...]`` host array."""
    return tuple(_t(part, index) for part in a)


def rowptrs(rows: np.ndarray, data: np.ndarray, nrows: int):
    """Per-shard row pointers (int64, ``[..., nrows + 1]``) of stacked
    ``[ndev, ..., nnzb]`` host buckets."""
    return tuple(torch.from_numpy(np.stack(
        [_rowptr(r, d, nrows) for r, d in zip(rs.reshape(-1, rs.shape[-1]),
                                             ds.reshape(-1, ds.shape[-1]))]
    ).reshape(rs.shape[:-1] + (nrows + 1,))) for rs, ds in zip(rows, data))


@dataclasses.dataclass(frozen=True)
class ShardedVector:
    """A dense vector split into ``ndev`` contiguous zero-padded chunks of
    one size ``C``, chunk ``s`` on shard ``s``'s device (a ``[C, nrhs]``
    chunk for a block of right-hand sides).  The padding is zero, so sums
    over the chunks are exact."""

    chunks: tuple[torch.Tensor, ...]
    starts: tuple[int, ...]
    length: int

    @property
    def ndev(self) -> int:
        return len(self.chunks)

    @property
    def chunk_size(self) -> int:
        return int(self.chunks[0].shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    @staticmethod
    def from_global(x, plan: RowPlan, dtype=None) -> "ShardedVector":
        """Split a global ``[length]`` (or ``[length, nrhs]``) host array
        into padded per-shard chunks on the CPU (:func:`.spmv.place` moves
        them to a mesh)."""
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        if x.shape[0] != plan.length:
            raise ValueError(f"x has shape {x.shape}, plan expects leading "
                             f"dim {plan.length}")
        dt = torch_dtype(dtype if dtype is not None else x.dtype)
        C = max(plan.max_count, 1)
        s = plan.starts
        chunks = []
        for i in range(plan.ndev):
            c = torch.zeros((C,) + x.shape[1:], dtype=dt)
            c[:s[i + 1] - s[i]] = torch.from_numpy(x[s[i]:s[i + 1]])
            chunks.append(c)
        return ShardedVector(chunks=tuple(chunks), starts=plan.starts,
                             length=plan.length)

    def to_global(self) -> np.ndarray:
        """Strip the padding and concatenate the chunks (host numpy)."""
        s = self.starts
        return np.concatenate([c[:s[i + 1] - s[i]].cpu().numpy()
                               for i, c in enumerate(self.chunks)])


def _plans(indptr, ncol: int, ndev: int, balance: str, square: bool):
    rplan = plan_rows(indptr, ndev, balance=balance)
    if square:
        if rplan.length != ncol:
            raise ValueError("square=True requires a square matrix")
        return rplan, rplan
    return rplan, plan_even(ncol, ndev)


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-partitioned CSR for the all-gather strategy: per shard
    ``[nnzp]`` values, column ids in padded gathered-x space and local row
    ids, padded to the largest shard."""

    data: tuple[torch.Tensor, ...]
    cols: tuple[torch.Tensor, ...]
    rows: tuple[torch.Tensor, ...]
    rowptr: tuple[torch.Tensor, ...]      # [R + 1] int64 each, R the largest row block
    shape: tuple[int, int]
    row_starts: tuple[int, ...]
    col_starts: tuple[int, ...]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def row_plan(self) -> RowPlan:
        return RowPlan(self.row_starts, self.ndev, self.shape[0])

    @property
    def col_plan(self) -> RowPlan:
        return RowPlan(self.col_starts, self.ndev, self.shape[1])

    @staticmethod
    def build(csr, ndev: int, *, balance: str = "nnz",
              square: bool = False) -> "ShardedCSR":
        """Partition a port or scipy CSR into ``ndev`` padded shards;
        ``square=True`` uses the row plan for the columns too (chained
        products: output sharding == input sharding)."""
        indptr, cols, data, row_ids, (nrow, ncol) = _csr_host_arrays(csr)
        rplan, cplan = _plans(indptr, ncol, ndev, balance, square)
        C = max(cplan.max_count, 1)
        owner = cplan.owner_of(cols)
        cols_padded = owner * C + (cols - np.asarray(cplan.starts)[owner])
        s = rplan.starts
        nnz_per = indptr[list(s[1:])] - indptr[list(s[:-1])]
        nnzp = max(int(nnz_per.max()), 1)
        d = np.zeros((ndev, nnzp), dtype=data.dtype)
        c = np.zeros((ndev, nnzp), dtype=np.int64)
        r = np.zeros((ndev, nnzp), dtype=np.int64)
        for i in range(ndev):
            lo, hi = indptr[s[i]], indptr[s[i + 1]]
            d[i, :hi - lo] = data[lo:hi]
            c[i, :hi - lo] = cols_padded[lo:hi]
            r[i, :hi - lo] = row_ids[lo:hi] - s[i]
        return ShardedCSR(data=_split(d), cols=_split(c, True),
                          rows=_split(r, True),
                          rowptr=rowptrs(r, d, rplan.max_count),
                          shape=(nrow, ncol), row_starts=rplan.starts,
                          col_starts=cplan.starts, nnz=int(indptr[-1]))


@dataclasses.dataclass(frozen=True)
class HaloCSR:
    """Row-partitioned CSR bucketed by ring step: per shard ``[ndev,
    nnzb]`` (step ``t``: entries whose x chunk shard ``(s - t) mod ndev``
    owns, column ids in that chunk), padded to the largest bucket."""

    data: tuple[torch.Tensor, ...]
    cols: tuple[torch.Tensor, ...]
    rows: tuple[torch.Tensor, ...]
    rowptr: tuple[torch.Tensor, ...]      # [ndev, R + 1] int64 each
    shape: tuple[int, int]
    row_starts: tuple[int, ...]
    col_starts: tuple[int, ...]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def row_plan(self) -> RowPlan:
        return RowPlan(self.row_starts, self.ndev, self.shape[0])

    @property
    def col_plan(self) -> RowPlan:
        return RowPlan(self.col_starts, self.ndev, self.shape[1])

    @staticmethod
    def build(csr, ndev: int, *, balance: str = "nnz",
              square: bool = False) -> "HaloCSR":
        indptr, cols, data, row_ids, (nrow, ncol) = _csr_host_arrays(csr)
        rplan, cplan = _plans(indptr, ncol, ndev, balance, square)
        owner = cplan.owner_of(cols)
        cols_local = cols - np.asarray(cplan.starts)[owner]
        shard = rplan.owner_of(row_ids)
        step = (shard - owner) % ndev
        rows_local = row_ids - np.asarray(rplan.starts)[shard]
        key = shard * ndev + step
        sizes = np.bincount(key, minlength=ndev * ndev)
        nnzb = max(int(sizes.max()), 1)
        d = np.zeros((ndev, ndev, nnzb), dtype=data.dtype)
        c = np.zeros((ndev, ndev, nnzb), dtype=np.int64)
        r = np.zeros((ndev, ndev, nnzb), dtype=np.int64)
        order = np.argsort(key, kind="stable")
        key_sorted = key[order]
        starts = np.zeros(ndev * ndev + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot = np.arange(len(order)) - starts[key_sorted]
        sh, st = key_sorted // ndev, key_sorted % ndev
        d[sh, st, slot] = data[order]
        c[sh, st, slot] = cols_local[order]
        r[sh, st, slot] = rows_local[order]
        return HaloCSR(data=_split(d), cols=_split(c, True),
                       rows=_split(r, True),
                       rowptr=rowptrs(r, d, rplan.max_count),
                       shape=(nrow, ncol), row_starts=rplan.starts,
                       col_starts=cplan.starts, nnz=int(indptr[-1]))


@dataclasses.dataclass(frozen=True)
class NeighborCSR:
    """Row-partitioned CSR with a neighbour halo: per shard an interior
    bucket (column ids in the own chunk) and a boundary bucket (column ids
    in the window ``[chunk of s + offsets[0] | chunk of s + offsets[1] |
    ...]``, ``offsets`` the ring deltas any shard's columns touch)."""

    data_int: tuple[torch.Tensor, ...]
    cols_int: tuple[torch.Tensor, ...]
    rows_int: tuple[torch.Tensor, ...]
    data_bnd: tuple[torch.Tensor, ...]
    cols_bnd: tuple[torch.Tensor, ...]
    rows_bnd: tuple[torch.Tensor, ...]
    rowptr_int: tuple[torch.Tensor, ...]  # [R + 1] int64 each, R the largest row block
    rowptr_bnd: tuple[torch.Tensor, ...]
    offsets: tuple[int, ...]              # ring deltas, != 0
    shape: tuple[int, int]
    row_starts: tuple[int, ...]
    col_starts: tuple[int, ...]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data_int)

    @property
    def row_plan(self) -> RowPlan:
        return RowPlan(self.row_starts, self.ndev, self.shape[0])

    @property
    def col_plan(self) -> RowPlan:
        return RowPlan(self.col_starts, self.ndev, self.shape[1])

    @staticmethod
    def build(csr, ndev: int, *, balance: str = "nnz",
              square: bool = False) -> "NeighborCSR":
        indptr, cols, data, row_ids, (nrow, ncol) = _csr_host_arrays(csr)
        rplan, cplan = _plans(indptr, ncol, ndev, balance, square)
        owner = cplan.owner_of(cols)
        cols_local = cols - np.asarray(cplan.starts)[owner]
        shard = rplan.owner_of(row_ids)
        rows_local = row_ids - np.asarray(rplan.starts)[shard]
        delta = (owner - shard) % ndev                 # 0 = interior
        offs = tuple(int(d) for d in np.unique(delta) if d != 0)
        hidx = np.zeros(ndev, dtype=np.int64)          # delta -> window slot
        for i, dd in enumerate(offs):
            hidx[dd] = i
        C = max(cplan.max_count, 1)
        R = rplan.max_count

        def bucket(mask, window_cols):
            sizes = np.bincount(shard[mask], minlength=ndev)
            nb = max(int(sizes.max()), 1)
            dd = np.zeros((ndev, nb), dtype=data.dtype)
            cc = np.zeros((ndev, nb), dtype=np.int64)
            rr = np.zeros((ndev, nb), dtype=np.int64)
            order = np.argsort(shard[mask], kind="stable")
            sh_sorted = shard[mask][order]
            starts = np.zeros(ndev + 1, dtype=np.int64)
            np.cumsum(sizes, out=starts[1:])
            slot = np.arange(len(order)) - starts[sh_sorted]
            dd[sh_sorted, slot] = data[mask][order]
            cc[sh_sorted, slot] = window_cols[mask][order]
            rr[sh_sorted, slot] = rows_local[mask][order]
            return dd, cc, rr

        interior = delta == 0
        di, ci, ri = bucket(interior, cols_local)
        db, cb, rb = bucket(~interior, hidx[delta] * C + cols_local)
        return NeighborCSR(
            data_int=_split(di), cols_int=_split(ci, True),
            rows_int=_split(ri, True), data_bnd=_split(db),
            cols_bnd=_split(cb, True), rows_bnd=_split(rb, True),
            rowptr_int=rowptrs(ri, di, R), rowptr_bnd=rowptrs(rb, db, R),
            offsets=offs, shape=(nrow, ncol), row_starts=rplan.starts,
            col_starts=cplan.starts, nnz=int(indptr[-1]))


@dataclasses.dataclass(frozen=True)
class ColShardedCSR:
    """Column-partitioned CSR for the reduce-scatter strategy: per shard
    ``[nnzp]`` values, column ids in the owned x chunk and global row ids
    into the padded ``[ndev * R]`` y (rows split by ``plan_uniform``)."""

    data: tuple[torch.Tensor, ...]
    cols: tuple[torch.Tensor, ...]
    rows: tuple[torch.Tensor, ...]
    rowptr: tuple[torch.Tensor, ...]      # [ndev * R + 1] int64 each
    shape: tuple[int, int]
    row_starts: tuple[int, ...]
    col_starts: tuple[int, ...]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def rows_per_shard(self) -> int:
        return max(int(-(-self.shape[0] // self.ndev)), 1)

    @property
    def row_plan(self) -> RowPlan:
        return RowPlan(self.row_starts, self.ndev, self.shape[0])

    @property
    def col_plan(self) -> RowPlan:
        return RowPlan(self.col_starts, self.ndev, self.shape[1])

    @staticmethod
    def build(csr, ndev: int, *, balance: str = "nnz") -> "ColShardedCSR":
        """Partition by columns; ``balance="nnz"`` places the column
        boundaries at equal nnz quantiles, ``"cols"`` splits evenly."""
        _, cols, data, row_ids, (nrow, ncol) = _csr_host_arrays(csr)
        if balance == "nnz":
            col_ptr = np.zeros(ncol + 1, dtype=np.int64)
            np.cumsum(np.bincount(cols, minlength=ncol), out=col_ptr[1:])
            cplan = plan_rows(col_ptr, ndev, balance="nnz")
        else:
            cplan = plan_even(ncol, ndev)
        rplan = plan_uniform(nrow, ndev)
        owner = cplan.owner_of(cols)
        cols_local = cols - np.asarray(cplan.starts)[owner]
        order = np.argsort(owner, kind="stable")
        sizes = np.bincount(owner, minlength=ndev)
        nnzp = max(int(sizes.max()), 1)
        d = np.zeros((ndev, nnzp), dtype=data.dtype)
        c = np.zeros((ndev, nnzp), dtype=np.int64)
        r = np.zeros((ndev, nnzp), dtype=np.int64)
        starts = np.zeros(ndev + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot = np.arange(len(order)) - starts[owner[order]]
        d[owner[order], slot] = data[order]
        c[owner[order], slot] = cols_local[order]
        r[owner[order], slot] = row_ids[order]
        R = max(-(-nrow // ndev), 1)
        return ColShardedCSR(data=_split(d), cols=_split(c, True),
                             rows=_split(r, True),
                             rowptr=rowptrs(r, d, ndev * R),
                             shape=(nrow, ncol), row_starts=rplan.starts,
                             col_starts=cplan.starts, nnz=len(cols))
