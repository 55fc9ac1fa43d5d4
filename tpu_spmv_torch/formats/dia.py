"""DIA (diagonal) format for banded and structured matrices.

Counterpart of ``tpu_spmv/formats/dia.py``: ``data: [ndiags, nrow]`` with
``data[d, i] = A[i, i + offsets[d]]`` (zero where out of range) and the
offsets as a static ascending tuple.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_values, host_values, sparse_dataclass
from .coo import COO

__all__ = ["DIA"]


@sparse_dataclass
class DIA:
    """Diagonal-format matrix.

    Attributes:
      data: ``[ndiags, nrow]`` — ``data[d, i] = A[i, i + offsets[d]]``.
      offsets: static tuple of diagonal offsets (col - row), ascending.
      shape: static ``(nrow, ncol)``.
      nnz: static true nonzero count (for GFLOP/s accounting).
    """

    data: torch.Tensor
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int

    @staticmethod
    def host_arrays(coo: COO) -> tuple[np.ndarray, tuple[int, ...]]:
        """``([ndiags, nrow] numpy data, offsets)`` built on the host.

        Duplicates are summed and offsets come out ascending, as in the
        reference.  Sort-free: the occupied diagonals come from a bincount
        over the ``nrow + ncol - 1`` possible offsets, and the values land
        with a weighted bincount over ``diag_idx * nrow + row`` (the sums of
        ``np.add.at``, in one pass)."""
        row = coo.row.cpu().numpy()
        col = coo.col.cpu().numpy()
        vals = host_values(coo.data)
        nrow, ncol = coo.shape
        if row.size == 0:
            return np.zeros((1, nrow), dtype=vals.dtype), (0,)
        # int64 keys worked in place: col - row + nrow - 1, then each
        # entry's diagonal index, then its slot diag_idx * nrow + row
        key = np.subtract(col, row, dtype=np.int64)
        key += nrow - 1
        present = np.bincount(key, minlength=nrow + ncol - 1) > 0
        offsets = np.flatnonzero(present) - (nrow - 1)
        key = (np.cumsum(present) - 1)[key]
        key *= nrow
        key += row
        nd = len(offsets)
        data = np.bincount(key, weights=vals,
                           minlength=nd * nrow).reshape(nd, nrow)
        return (data.astype(vals.dtype, copy=False),
                tuple(int(o) for o in offsets))

    @staticmethod
    def from_coo(coo: COO) -> "DIA":
        """COO → DIA; the result lives on ``coo``'s device."""
        data, offs = DIA.host_arrays(coo)
        return DIA(data=as_values(data, coo.dtype, coo.device), offsets=offs,
                   shape=(int(coo.shape[0]), int(coo.shape[1])),
                   nnz=coo.nnz)

    @property
    def ndiags(self) -> int:
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
        nrow, ncol = self.shape
        data = host_values(self.data)
        rows, cols, vals = [], [], []
        i = np.arange(nrow, dtype=np.int64)
        for d, off in enumerate(self.offsets):
            j = i + off
            keep = (j >= 0) & (j < ncol) & (data[d] != 0)
            rows.append(i[keep])
            cols.append(j[keep])
            vals.append(data[d][keep])
        return COO.from_arrays(np.concatenate(rows), np.concatenate(cols),
                               np.concatenate(vals), self.shape,
                               dtype=self.dtype, device=self.device)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def astype(self, dtype) -> "DIA":
        return DIA(data=as_values(self.data, dtype), offsets=self.offsets,
                   shape=self.shape, nnz=self.nnz)
