"""COO (coordinate) sparse format — the canonical ingest format.

Counterpart of ``tpu_spmv/formats/coo.py``: three parallel tensors
``(row, col, data)`` plus the static ``shape`` and ``rows_sorted`` flag.
Entries are sorted by (row, col) at construction unless ``sort=False``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_index, as_values, host_values, sparse_dataclass

__all__ = ["COO"]


@sparse_dataclass
class COO:
    """Coordinate-format sparse matrix.

    Attributes:
      row: ``[nnz] int32`` row index of each stored entry.
      col: ``[nnz] int32`` column index of each stored entry.
      data: ``[nnz]`` value of each stored entry.
      shape: static ``(nrow, ncol)``.
      rows_sorted: static flag — True when entries are sorted by (row, col).
    """

    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
    shape: tuple[int, int]
    rows_sorted: bool = False

    @staticmethod
    def from_arrays(row, col, data, shape, *, dtype=None, device=None,
                    sort: bool = True) -> "COO":
        """Build from host (numpy) index/value arrays; sorted by (row, col)
        unless ``sort=False``."""
        row = np.asarray(row)
        col = np.asarray(col)
        data = np.asarray(data)
        if not (row.shape == col.shape == data.shape) or row.ndim != 1:
            raise ValueError(
                f"row/col/data must be equal-length 1-D arrays, got "
                f"{row.shape}/{col.shape}/{data.shape}")
        nrow, ncol = shape
        if row.size:
            if row.min() < 0 or row.max() >= nrow:
                raise ValueError(f"row indices out of range for nrow={nrow}")
            if col.min() < 0 or col.max() >= ncol:
                raise ValueError(f"col indices out of range for ncol={ncol}")
        sorted_flag = False
        if sort and row.size:
            order = np.lexsort((col, row))
            row, col, data = row[order], col[order], data[order]
            sorted_flag = True
        return COO(row=as_index(row, device), col=as_index(col, device),
                   data=as_values(data, dtype, device),
                   shape=(int(nrow), int(ncol)), rows_sorted=sorted_flag)

    @staticmethod
    def from_dense(dense, *, dtype=None, device=None) -> "COO":
        """The nonzeros of a dense host array, sorted by (row, col)."""
        dense = np.asarray(dense)
        row, col = np.nonzero(dense)
        return COO.from_arrays(row, col, dense[row, col], dense.shape,
                               dtype=dtype, device=device)

    @staticmethod
    def from_scipy(mat, *, dtype=None, device=None) -> "COO":
        m = mat.tocoo()
        return COO.from_arrays(m.row, m.col, m.data, m.shape, dtype=dtype,
                               device=device)

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

    def todense(self) -> torch.Tensor:
        """Dense ``[nrow, ncol]`` tensor (duplicates accumulate)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                              accumulate=True)

    def to_scipy(self):
        """A scipy ``coo_matrix`` (bfloat16 values widened to float32:
        scipy has no bf16)."""
        import scipy.sparse as sp

        return sp.coo_matrix(
            (host_values(self.data),
             (self.row.cpu().numpy(), self.col.cpu().numpy())),
            shape=self.shape)

    def sort_by_row(self) -> "COO":
        """An equivalent COO sorted by (row, col)."""
        if self.rows_sorted:
            return self
        key = self.row.long() * self.shape[1] + self.col.long()
        order = torch.argsort(key, stable=True)
        return COO(row=self.row[order], col=self.col[order],
                   data=self.data[order], shape=self.shape, rows_sorted=True)

    def astype(self, dtype) -> "COO":
        return COO(row=self.row, col=self.col,
                   data=as_values(self.data, dtype), shape=self.shape,
                   rows_sorted=self.rows_sorted)
