"""BSR (block sparse row) format with square ``bs x bs`` blocks.

Counterpart of ``tpu_spmv/formats/bsr.py``, field for field: the dense
block stack ``data [nblocks, bs, bs]`` in block-row-major order, the block
column ``indices``, the block-row pointer ``indptr`` and the expanded
``block_row_ids`` (int32), the static ``shape``, ``block_size`` and true
``nnz``.  Storage is padded up to whole blocks with explicit zeros.

The occupied blocks are found by a stable sort of the block keys (a
CSR-ordered input is a few sorted runs per block row), and the values land
with a weighted ``bincount`` over their slots, which sums duplicates as the
reference's ``np.add.at`` does, in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_index, as_values, sparse_dataclass
from .coo import COO

__all__ = ["BSR"]


def _slot_values(slots: np.ndarray, vals: np.ndarray, size: int,
                 dtype) -> np.ndarray:
    """``out[slots[k]] += vals[k]`` over a zero ``[size]`` array, in the
    values' dtype (duplicates summed)."""
    return np.bincount(slots, weights=vals, minlength=size).astype(
        dtype, copy=False)


@sparse_dataclass
class BSR:
    """Block-sparse-row matrix.

    Attributes:
      data: ``[nblocks, bs, bs]`` dense blocks, block-row-major order.
      indices: ``[nblocks] int32`` block-column id per block.
      indptr: ``[nbrow+1] int32`` block-row pointer.
      block_row_ids: ``[nblocks] int32`` block-row id per block.
      shape: static logical ``(nrow, ncol)``.
      block_size: static block edge ``bs``.
      nnz: static true scalar nonzero count.
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    block_row_ids: torch.Tensor
    shape: tuple[int, int]
    block_size: int
    nnz: int

    @staticmethod
    def from_coo(coo: COO, block_size: int = 8) -> "BSR":
        """COO → BSR on the host; the result lives on ``coo``'s device."""
        bs = int(block_size)
        if bs < 1:
            raise ValueError("block_size must be >= 1")
        row = coo.row.cpu().numpy().astype(np.int64)
        col = coo.col.cpu().numpy().astype(np.int64)
        vals = coo.data.cpu().numpy()
        nrow, ncol = coo.shape
        nbrow = -(-nrow // bs) if nrow else 0
        nbcol = -(-ncol // bs) if ncol else 0
        key = (row // bs) * max(nbcol, 1) + col // bs
        if key.size:
            order = np.argsort(key, kind="stable")
            ks = key[order]
            new = np.empty(ks.size, dtype=bool)
            new[0] = True
            np.not_equal(ks[1:], ks[:-1], out=new[1:])
            block_of_entry = np.empty(ks.size, dtype=np.int64)
            block_of_entry[order] = np.cumsum(new) - 1
            uniq = ks[new]
        else:
            block_of_entry = key
            uniq = np.zeros(1, dtype=np.int64)
        nblocks = len(uniq)
        ub_row = uniq // max(nbcol, 1)
        ub_col = uniq % max(nbcol, 1)
        slots = (block_of_entry * bs + row % bs) * bs + col % bs
        data = _slot_values(slots, vals, nblocks * bs * bs, vals.dtype)
        counts = np.bincount(ub_row, minlength=max(nbrow, 1))
        indptr = np.zeros(max(nbrow, 1) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        dev = coo.device
        return BSR(data=torch.from_numpy(data.reshape(nblocks, bs, bs)).to(
                       dev),
                   indices=as_index(ub_col, dev), indptr=as_index(indptr, dev),
                   block_row_ids=as_index(ub_row, dev),
                   shape=(int(nrow), int(ncol)), block_size=bs,
                   nnz=int(row.size))

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbrow(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def nbcol(self) -> int:
        return -(-self.shape[1] // self.block_size) if self.shape[1] else 0

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def to_coo(self) -> COO:
        bs = self.block_size
        data = self.data.cpu().numpy()
        brow = self.block_row_ids.cpu().numpy().astype(np.int64)
        bcol = self.indices.cpu().numpy().astype(np.int64)
        b, i, j = np.nonzero(data)
        rows = brow[b] * bs + i
        cols = bcol[b] * bs + j
        keep = (rows < self.shape[0]) & (cols < self.shape[1])
        return COO.from_arrays(rows[keep], cols[keep], data[b, i, j][keep],
                               self.shape, dtype=self.dtype,
                               device=self.device)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def astype(self, dtype) -> "BSR":
        return BSR(data=as_values(self.data, dtype), indices=self.indices,
                   indptr=self.indptr, block_row_ids=self.block_row_ids,
                   shape=self.shape, block_size=self.block_size, nnz=self.nnz)
