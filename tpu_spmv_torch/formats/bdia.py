"""BDIA (block-diagonal) format: DIA lifted to dense ``bs x bs`` blocks.

Counterpart of ``tpu_spmv/formats/bdia.py``, field for field:
``data [ndiags, nbrow, bs, bs]`` with ``data[d, b] = A_block[b, b +
offsets[d]]`` (zero where the block diagonal leaves the matrix), the static
ascending ``offsets``, ``shape``, ``block_size`` and true ``nnz``.  A
block-banded matrix (a structured PDE with ``bs`` coupled components per
grid point) needs no index arrays at all.

Built on the host without a sort: the occupied block diagonals come from a
bincount over the ``nbrow + nbcol - 1`` possible offsets, and the values
land with a weighted ``bincount`` over their slots, which sums duplicates
as the reference's ``np.add.at`` does, in one pass (``np.add.at`` is slow
at tens of millions of entries).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import as_values, sparse_dataclass
from .bsr import _slot_values
from .coo import COO

__all__ = ["BDIA"]


@sparse_dataclass
class BDIA:
    """Block-diagonal sparse matrix.

    Attributes:
      data: ``[ndiags, nbrow, bs, bs]`` — block ``(d, b)`` is
        ``A[b*bs:(b+1)*bs, (b+offsets[d])*bs : ...+bs]``.
      offsets: static tuple of block-diagonal offsets, ascending.
      shape: static logical ``(nrow, ncol)``.
      block_size: static block edge.
      nnz: static true scalar nonzero count.
    """

    data: torch.Tensor
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    block_size: int
    nnz: int

    @staticmethod
    def from_coo(coo: COO, block_size: int = 8) -> "BDIA":
        """COO → BDIA on the host; the result lives on ``coo``'s device."""
        bs = int(block_size)
        if bs < 1:
            raise ValueError("block_size must be >= 1")
        row = coo.row.cpu().numpy().astype(np.int64)
        col = coo.col.cpu().numpy().astype(np.int64)
        vals = coo.data.cpu().numpy()
        nrow, ncol = coo.shape
        nbrow = max(-(-nrow // bs), 1)
        nbcol = max(-(-ncol // bs), 1)
        brow = row // bs
        if row.size:
            diag = col // bs - brow + (nbrow - 1)
            present = np.bincount(diag, minlength=nbrow + nbcol - 1) > 0
            offsets = np.flatnonzero(present) - (nbrow - 1)
            diag_idx = (np.cumsum(present) - 1)[diag]
        else:
            offsets = np.zeros(1, dtype=np.int64)
            diag_idx = row
        nd = len(offsets)
        slots = ((diag_idx * nbrow + brow) * bs + row % bs) * bs + col % bs
        data = _slot_values(slots, vals, nd * nbrow * bs * bs, vals.dtype)
        return BDIA(data=torch.from_numpy(data.reshape(nd, nbrow, bs, bs)).to(
                        coo.device),
                    offsets=tuple(int(o) for o in offsets),
                    shape=(int(nrow), int(ncol)), block_size=bs,
                    nnz=int(row.size))

    @property
    def ndiags(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbrow(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbcol(self) -> int:
        return -(-self.shape[1] // self.block_size) if self.shape[1] else 1

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
        d, b, i, j = np.nonzero(data)
        rows = b * bs + i
        cols = (b + np.asarray(self.offsets, dtype=np.int64)[d]) * bs + j
        keep = (rows < self.shape[0]) & (cols >= 0) & (cols < self.shape[1])
        return COO.from_arrays(rows[keep], cols[keep],
                               data[d, b, i, j][keep], self.shape,
                               dtype=self.dtype, device=self.device)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def astype(self, dtype) -> "BDIA":
        return BDIA(data=as_values(self.data, dtype), offsets=self.offsets,
                    shape=self.shape, block_size=self.block_size,
                    nnz=self.nnz)
