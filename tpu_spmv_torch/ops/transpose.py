"""Transpose across formats — zero-copy where the layout allows.

Counterpart of ``tpu_spmv/ops/transpose.py``.  ``A^T x`` is what
least-squares solvers and reverse-mode gradients need:

- ``CSR^T -> CSC`` / ``CSC^T -> CSR``: the same four arrays, read with the
  roles of rows and columns swapped (a CSC also derives its row order,
  :mod:`..formats.csc`);
- ``COO^T``: the row and column tensors swap (``rows_sorted=False``);
- ``DIA^T``: negated offsets, each diagonal shifted with zero fill
  (``dataT[d', i] = data[d, i + o']``);
- streaming packs: :func:`~..kernels.dia_stream.transpose_sdia` /
  ``transpose_psdia`` (padded row space, the same kernels K1/K2).

The packed GPR and sliced ELL bake in their row grouping: re-pack from the
host matrix for those.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import COO, CSC, CSR, DIA
from ..kernels import dia_stream

__all__ = ["transpose"]


def _shift_rows(data: torch.Tensor, offsets, width: int) -> torch.Tensor:
    """Per-diagonal zero-filled shifts: row ``d`` of the result holds
    ``data[d, i + offsets[d]]`` over ``i in [0, width)``."""
    src_w = int(data.shape[1])
    rows = []
    for d, off in enumerate(offsets):
        lo = max(0, -off)                  # first valid dest slot
        hi = min(width, src_w - off)       # one past last valid dest slot
        if hi <= lo:
            rows.append(data.new_zeros(width))
            continue
        rows.append(F.pad(data[d, lo + off:hi + off], (lo, width - hi)))
    return torch.stack(rows)


def transpose(A):
    """``A^T`` in the natural target format (see module docstring)."""
    if isinstance(A, CSR):
        return CSC(data=A.data, indices=A.indices, indptr=A.indptr,
                   col_ids=A.row_ids, shape=(A.shape[1], A.shape[0]))
    if isinstance(A, CSC):
        return CSR(data=A.data, indices=A.indices, indptr=A.indptr,
                   row_ids=A.col_ids, shape=(A.shape[1], A.shape[0]))
    if isinstance(A, COO):
        return COO(row=A.col, col=A.row, data=A.data,
                   shape=(A.shape[1], A.shape[0]), rows_sorted=False)
    if isinstance(A, DIA):
        # A^T[i, i + o'] = A[i + o', i] = data[d, i + o'] with o' = -o
        offs_T = [-int(o) for o in A.offsets]
        order = sorted(range(len(offs_T)), key=lambda d: offs_T[d])
        data_T = _shift_rows(A.data[order], [offs_T[d] for d in order],
                             A.shape[1])
        return DIA(data=data_T, offsets=tuple(offs_T[d] for d in order),
                   shape=(A.shape[1], A.shape[0]), nnz=A.nnz)
    if isinstance(A, dia_stream.SDIA):
        return dia_stream.transpose_sdia(A)
    if isinstance(A, dia_stream.PSDIA):
        return dia_stream.transpose_psdia(A)
    raise TypeError(
        f"no in-place transpose for {type(A).__name__}; convert through "
        f"COO (convert(transpose(to_coo(A)), ...)) — its layout bakes in "
        f"the row grouping")
