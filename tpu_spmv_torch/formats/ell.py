"""ELL (ELLPACK) format: row-major dense ``[nrow, width]`` slots.

Counterpart of ``tpu_spmv/formats/ell.py``, field for field: ``data``,
``cols`` (int32) and ``valid`` (bool) of shape ``[nrow, width]``, the
static ``shape`` and the true ``nnz``.  Slot ``j`` of row ``i`` holds the
row's ``j``-th entry in column order; padding slots hold value 0, column 0
and ``valid`` False.  The width is the longest row unless the caller asks
for more.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_index, as_values, host_values, sparse_dataclass
from .coo import COO

__all__ = ["ELL"]


@sparse_dataclass
class ELL:
    """ELLPACK matrix with row-major dense storage.

    Attributes:
      data: ``[nrow, width]`` values, zero in padding slots.
      cols: ``[nrow, width] int32`` column ids, 0 in padding slots.
      valid: ``[nrow, width] bool`` slot occupancy.
      shape: static ``(nrow, ncol)``.
      nnz: static true (unpadded) nonzero count.
    """

    data: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor
    shape: tuple[int, int]
    nnz: int

    @staticmethod
    def from_coo(coo: COO, *, width: int | None = None) -> "ELL":
        """COO → ELL on the host (each entry at its position within its
        row, rows sorted by column); the result lives on ``coo``'s
        device."""
        row = coo.row.cpu().numpy().astype(np.int64)
        col = coo.col.cpu().numpy().astype(np.int64)
        data = host_values(coo.data)
        nrow, ncol = coo.shape
        if not coo.rows_sorted:
            order = np.lexsort((col, row))
            row, col, data = row[order], col[order], data[order]
        counts = np.bincount(row, minlength=nrow)
        max_width = int(counts.max()) if nrow and counts.size else 0
        if width is None:
            width = max_width
        elif width < max_width:
            raise ValueError(f"width={width} < max row population {max_width}")
        width = max(int(width), 1)
        starts = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(row.size, dtype=np.int64) - starts[row]
        vals = np.zeros((nrow, width), dtype=data.dtype)
        cols = np.zeros((nrow, width), dtype=np.int64)
        mask = np.zeros((nrow, width), dtype=bool)
        vals[row, slot] = data
        cols[row, slot] = col
        mask[row, slot] = True
        dev = coo.device
        return ELL(data=as_values(vals, coo.dtype, dev),
                   cols=as_index(cols, dev),
                   valid=torch.from_numpy(mask).to(dev),
                   shape=(int(nrow), int(ncol)), nnz=int(row.size))

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

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
        mask = self.valid.cpu().numpy()
        row, slot = np.nonzero(mask)
        return COO.from_arrays(row, self.cols.cpu().numpy()[row, slot],
                               host_values(self.data)[row, slot], self.shape,
                               dtype=self.dtype, device=self.device)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def astype(self, dtype) -> "ELL":
        return ELL(data=as_values(self.data, dtype), cols=self.cols,
                   valid=self.valid, shape=self.shape, nnz=self.nnz)
