"""Sparse matrix–vector products for COO, CSR, CSC and DIA in plain PyTorch.

Counterpart of the XLA-level arms of ``tpu_spmv/ops/spmv.py``.
``spmv(A, x)`` returns ``A @ x``; ``spmv(A, x, y)`` returns ``y + A @ x``.

Every reduction is row-owned and deterministic — the same bits on every
run, on the CPU and on CUDA.  No ``index_add_`` / ``scatter_add_``, which
use atomics on CUDA:

- COO/CSR gather ``x``, multiply, and sum each row's contiguous run of
  products with ``torch.segment_reduce`` over the row offsets (``indptr``,
  or for sorted COO the offsets found by ``searchsorted``).  Each segment
  is reduced by one owner in a fixed order, so no two rows race and the
  order never changes from run to run.
- CSC gathers its entries in the stable row order it computed at
  construction and takes the same segment sum over its row offsets (the
  reference's unsorted ``segment_sum`` would be a scatter here).
- DIA is a static loop of shifted dense FMAs over a zero-padded ``x``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import COO, CSC, CSR, DIA

__all__ = ["spmv", "spmv_coo", "spmv_csr", "spmv_csc", "spmv_dia"]


def _finish(ax: torch.Tensor, y: torch.Tensor | None) -> torch.Tensor:
    return ax if y is None else y + ax


def _row_sums(prod: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(prod, "sum", offsets=offsets.long(), axis=0)


def spmv_coo(A: COO, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """COO SpMV: entries sorted by row (sorted first if they are not),
    then the same row-owned segment sum as CSR."""
    A = A.sort_by_row()
    bounds = torch.arange(A.shape[0] + 1, dtype=A.row.dtype,
                          device=A.row.device)
    offsets = torch.searchsorted(A.row, bounds)
    return _finish(_row_sums(A.data * x[A.col], offsets), y)


def spmv_csr(A: CSR, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """CSR SpMV: ``data * x[indices]`` summed per row over ``indptr``."""
    return _finish(_row_sums(A.data * x[A.indices], A.indptr), y)


def spmv_csc(A: CSC, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """CSC SpMV: the entries in row order, ``data * x[col]`` summed per
    row over the row offsets (row-owned, no scatter)."""
    order = A.row_order
    prod = A.data[order] * x[A.col_ids[order]]
    return _finish(_row_sums(prod, A.row_ptr), y)


def spmv_dia(A: DIA, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """DIA SpMV: one unit-stride FMA per diagonal over a padded ``x``
    (out-of-range slots are structural zeros in ``A.data``)."""
    nrow, ncol = A.shape
    lo = max(0, -min(A.offsets))
    hi = max(0, (nrow - 1) + max(A.offsets) - (ncol - 1))
    xp = F.pad(x, (lo, hi))
    ax = torch.zeros(nrow, dtype=torch.result_type(A.data, x),
                     device=x.device)
    for d, off in enumerate(A.offsets):
        ax = ax + A.data[d] * xp[off + lo:off + lo + nrow]
    return _finish(ax, y)


_DISPATCH = {COO: spmv_coo, CSR: spmv_csr, CSC: spmv_csc, DIA: spmv_dia}


def spmv(A, x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (or ``y + A @ x``) for COO, CSR, CSC and DIA."""
    try:
        fn = _DISPATCH[type(A)]
    except KeyError:
        raise TypeError(f"unsupported sparse type {type(A).__name__}") from None
    return fn(A, x, y)
