"""CSR (compressed sparse row) format.

Counterpart of ``tpu_spmv/formats/csr.py``, field for field: ``data``,
``indices``, ``indptr`` and the expanded row index ``row_ids``.  Built from
COO on the host with a lexsort, a bincount and a cumsum.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_index, as_values, host_values, sparse_dataclass
from .coo import COO

__all__ = ["CSR"]


@sparse_dataclass
class CSR:
    """Compressed-sparse-row matrix.

    Attributes:
      data: ``[nnz]`` values, sorted by row, then column.
      indices: ``[nnz] int32`` column index per entry.
      indptr: ``[nrow+1] int32`` row pointer.
      row_ids: ``[nnz] int32`` row index per entry (expanded indptr).
      shape: static ``(nrow, ncol)``.
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    shape: tuple[int, int]

    @staticmethod
    def from_coo(coo: COO) -> "CSR":
        """COO → CSR on the host; the result lives on ``coo``'s device."""
        row = coo.row.cpu().numpy()
        col = coo.col.cpu().numpy()
        data = host_values(coo.data)
        nrow, ncol = coo.shape
        if not coo.rows_sorted:
            order = np.lexsort((col, row))
            row, col, data = row[order], col[order], data[order]
        counts = np.bincount(row, minlength=nrow)
        indptr = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        dev = coo.device
        return CSR(data=as_values(data, coo.dtype, dev),
                   indices=as_index(col, dev), indptr=as_index(indptr, dev),
                   row_ids=as_index(row, dev), shape=(int(nrow), int(ncol)))

    @staticmethod
    def from_arrays(data, indices, indptr, shape, *, dtype=None,
                    device=None) -> "CSR":
        """Build from a CSR triplet of host arrays (e.g. scipy's)."""
        indptr_np = np.asarray(indptr, dtype=np.int64)
        nrow, ncol = shape
        if indptr_np.shape != (nrow + 1,):
            raise ValueError(f"indptr must have shape ({nrow + 1},)")
        row_ids = np.repeat(np.arange(nrow, dtype=np.int64),
                            np.diff(indptr_np))
        return CSR(data=as_values(data, dtype, device),
                   indices=as_index(indices, device),
                   indptr=as_index(indptr_np, device),
                   row_ids=as_index(row_ids, device),
                   shape=(int(nrow), int(ncol)))

    @staticmethod
    def from_scipy(mat, *, dtype=None, device=None) -> "CSR":
        m = mat.tocsr()
        m.sort_indices()
        return CSR.from_arrays(m.data, m.indices, m.indptr, m.shape,
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

    def row_lengths(self) -> np.ndarray:
        """Entries per row, on the host."""
        return np.diff(self.indptr.cpu().numpy())

    def diagonal(self) -> torch.Tensor:
        """Row-aligned main diagonal, zero where a row has none.

        A row-owned segment sum over ``indptr`` (no atomics): duplicates of
        a diagonal entry are summed, as in the reference."""
        on_diag = torch.where(self.row_ids == self.indices, self.data,
                              torch.zeros_like(self.data))
        diag = torch.segment_reduce(on_diag, "sum",
                                    offsets=self.indptr.long(), axis=0)
        return diag[:min(self.shape)]

    def to_coo(self) -> COO:
        return COO(row=self.row_ids, col=self.indices, data=self.data,
                   shape=self.shape, rows_sorted=True)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (host_values(self.data), self.indices.cpu().numpy(),
             self.indptr.cpu().numpy()), shape=self.shape)

    def astype(self, dtype) -> "CSR":
        return CSR(data=as_values(self.data, dtype), indices=self.indices,
                   indptr=self.indptr, row_ids=self.row_ids, shape=self.shape)
