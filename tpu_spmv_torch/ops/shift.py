"""Diagonal shift: ``A + c·I`` in the same format, on the device.

Counterpart of ``tpu_spmv/ops/shift.py``.  Shifted operators are the
screened Poisson / implicit diffusion step ``(A + I/dt)``, ridge terms and
spectral shifts; folding the shift into the stored format keeps the fast
kernels (one K2 pass per product instead of K2 plus an elementwise add).

- DIA / SDIA / PSDIA: the shift is added to the main-diagonal row, which
  is spliced in at its sorted offset when the format stores none (``nnz``
  grows by ``n``).  SDIA shifts only its real rows ``[L, L + n)``, so the
  pad rows stay structural zeros; PSDIA shifts its pattern row (the row
  mask handles the boundaries).
- CSR / COO: in place when every row stores exactly one diagonal entry,
  which a row-owned count checks (``torch.bincount``, no scatter); fewer
  would skip rows and duplicates would count ``c`` twice, so both raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats import COO, CSR, DIA
from ..kernels.dia_stream import PSDIA, SDIA

__all__ = ["shift_diagonal"]


def _add_or_insert_diag(A, field: str, shift_row: torch.Tensor, n: int):
    """Add ``shift_row`` onto the main-diagonal row of ``getattr(A,
    field)``, or splice it in at the sorted offset position when the format
    stores no main diagonal (``nnz`` grows by ``n``)."""
    data = getattr(A, field)
    offs = list(A.offsets)
    if 0 in offs:
        d0 = offs.index(0)
        new = data.clone()
        new[d0] += shift_row
        return dataclasses.replace(A, **{field: new})
    pos = int(np.searchsorted(np.asarray(offs), 0))
    stacked = torch.cat([data[:pos], shift_row[None, :], data[pos:]])
    return dataclasses.replace(
        A, nnz=A.nnz + n, offsets=tuple(offs[:pos]) + (0,) + tuple(offs[pos:]),
        **{field: stacked})


def _shift_entries(A, rows: torch.Tensor, cols: torch.Tensor,
                   data: torch.Tensor, c, n: int) -> torch.Tensor:
    mask = rows == cols
    counts = torch.bincount(torch.where(mask, rows, n).long(),
                            minlength=n + 1)[:n]
    if not bool(torch.all(counts == 1)):
        raise TypeError(
            f"{type(A).__name__} shift needs exactly one stored diagonal "
            f"entry per row ({int(mask.sum())} present for {n} rows) — "
            f"inserting entries changes the sparsity structure; shift in "
            f"scipy and re-convert")
    return torch.where(mask, data + c, data)


def shift_diagonal(A, c):
    """Return ``A + c·I`` in the same format as ``A`` (on its device)."""
    n = min(A.shape)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"A + c*I needs a square matrix, got {A.shape}")
    if isinstance(A, DIA):
        return _add_or_insert_diag(A, "data", torch.full(
            (A.data.shape[1],), c, dtype=A.dtype, device=A.data.device), n)
    if isinstance(A, SDIA):
        k = torch.arange(A.npad, device=A.data.device)
        real = (k >= A.L) & (k < A.L + n)
        return _add_or_insert_diag(A, "data", c * real.to(A.dtype), n)
    if isinstance(A, PSDIA):
        return _add_or_insert_diag(A, "pattern", torch.full(
            (A.pattern.shape[1],), c, dtype=A.dtype,
            device=A.pattern.device), n)
    if isinstance(A, CSR):
        return dataclasses.replace(A, data=_shift_entries(
            A, A.row_ids, A.indices, A.data, c, n))
    if isinstance(A, COO):
        return dataclasses.replace(A, data=_shift_entries(
            A, A.row, A.col, A.data, c, n))
    raise TypeError(
        f"no in-place diagonal shift for {type(A).__name__}; convert to "
        f"DIA/CSR first or apply the shift before packing")
