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

from .base import as_index, as_values, host_values, sparse_dataclass
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
        data = host_values(coo.data)
        nrow, ncol = coo.shape
        order = np.lexsort((row, col))
        row, col, data = row[order], col[order], data[order]
        counts = np.bincount(col, minlength=ncol)
        indptr = np.zeros(ncol + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        dev = coo.device
        return CSC(data=as_values(data, coo.dtype, dev),
                   indices=as_index(row, dev), indptr=as_index(indptr, dev),
                   col_ids=as_index(col, dev), shape=(int(nrow), int(ncol)))

    @staticmethod
    def from_arrays(data, indices, indptr, shape, *, dtype=None,
                    device=None) -> "CSC":
        """Build from a CSC triplet of host arrays (e.g. scipy's)."""
        indptr_np = np.asarray(indptr, dtype=np.int64)
        nrow, ncol = shape
        if indptr_np.shape != (ncol + 1,):
            raise ValueError(f"indptr must have shape ({ncol + 1},)")
        col_ids = np.repeat(np.arange(ncol, dtype=np.int64),
                            np.diff(indptr_np))
        return CSC(data=as_values(data, dtype, device),
                   indices=as_index(indices, device),
                   indptr=as_index(indptr_np, device),
                   col_ids=as_index(col_ids, device),
                   shape=(int(nrow), int(ncol)))

    @staticmethod
    def from_scipy(mat, *, dtype=None, device=None) -> "CSC":
        m = mat.tocsc()
        m.sort_indices()
        return CSC.from_arrays(m.data, m.indices, m.indptr, m.shape,
                               dtype=dtype, device=device)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

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
        return COO(row=self.indices, col=self.col_ids, data=self.data,
                   shape=self.shape, rows_sorted=False)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (host_values(self.data), self.indices.cpu().numpy(),
             self.indptr.cpu().numpy()), shape=self.shape)

    def astype(self, dtype) -> "CSC":
        return CSC(data=as_values(self.data, dtype), indices=self.indices,
                   indptr=self.indptr, col_ids=self.col_ids,
                   shape=self.shape, row_order=self.row_order,
                   row_ptr=self.row_ptr)
