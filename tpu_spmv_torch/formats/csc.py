"""CSC (compressed sparse column) format.

Counterpart of ``tpu_spmv/formats/csc.py``, field for field: ``data``,
``indices`` (row per entry), ``indptr`` (column pointer) and the expanded
column index ``col_ids``.  The reference's CSC SpMV is an unsorted segment
sum over rows; a scatter over ``indices`` would use atomics on CUDA and
change bits from run to run.  So a CSC also carries, computed once at
construction, a stable row order of its entries (``row_order``) and the
row offsets into it (``row_ptr``): the SpMV gathers in that order and sums
each row's run with ``torch.segment_reduce``, row-owned as CSR's.  Within a
row the entries keep their column order, so a CSC product equals the CSR
product of the same matrix bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_index, sparse_dataclass
from .coo import COO

__all__ = ["CSC"]


@sparse_dataclass
class CSC:
    """Compressed-sparse-column matrix.

    Attributes:
      data: ``[nnz]`` values, column-major (sorted by column, then row).
      indices: ``[nnz] int32`` row index per entry.
      indptr: ``[ncol+1] int32`` column pointer.
      col_ids: ``[nnz] int32`` column index per entry (expanded indptr).
      shape: static ``(nrow, ncol)``.
      row_order: ``[nnz] int64`` entries in row order (stable), derived.
      row_ptr: ``[nrow+1] int64`` row offsets into ``row_order``, derived.
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    col_ids: torch.Tensor
    shape: tuple[int, int]
    row_order: torch.Tensor | None = None
    row_ptr: torch.Tensor | None = None

    def __post_init__(self):
        if self.row_order is None:
            rows = self.indices.long()
            counts = torch.bincount(rows, minlength=self.shape[0])
            ptr = torch.zeros(self.shape[0] + 1, dtype=torch.int64,
                              device=rows.device)
            torch.cumsum(counts, 0, out=ptr[1:])
            object.__setattr__(self, "row_order",
                               torch.argsort(rows, stable=True))
            object.__setattr__(self, "row_ptr", ptr)

    @staticmethod
    def from_coo(coo: COO) -> "CSC":
        """COO → CSC on the host; the result lives on ``coo``'s device."""
        row = coo.row.cpu().numpy()
        col = coo.col.cpu().numpy()
        data = coo.data.cpu().numpy()
        nrow, ncol = coo.shape
        order = np.lexsort((row, col))
        row, col, data = row[order], col[order], data[order]
        counts = np.bincount(col, minlength=ncol)
        indptr = np.zeros(ncol + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        dev = coo.device
        return CSC(data=torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                   indices=as_index(row, dev), indptr=as_index(indptr, dev),
                   col_ids=as_index(col, dev), shape=(int(nrow), int(ncol)))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def to_coo(self) -> COO:
        return COO(row=self.indices, col=self.col_ids, data=self.data,
                   shape=self.shape, rows_sorted=False)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (self.data.cpu().numpy(), self.indices.cpu().numpy(),
             self.indptr.cpu().numpy()), shape=self.shape)
