"""Sparse matrix × dense matrix (SpMM, multi-RHS SpMV) in plain PyTorch.

Counterpart of ``tpu_spmv/ops/spmm.py`` for the formats the port has (COO,
CSR, CSC, DIA).  Convention: ``X`` is ``[ncol, nrhs]``, the result is
``[nrow, nrhs]``.

The reductions are :mod:`.spmv`'s with a trailing RHS axis, row-owned and
deterministic: COO/CSR/CSC gather the rows of ``X``, multiply, and sum each
row's run of products with ``torch.segment_reduce`` along axis 0; DIA is a
static loop of shifted dense FMAs over a zero-padded ``X``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import COO, CSC, CSR, DIA
from .spmv import _row_sums

__all__ = ["spmm", "spmm_coo", "spmm_csr", "spmm_csc", "spmm_dia"]


def _check_rhs(X: torch.Tensor) -> None:
    if X.dim() != 2:
        raise ValueError(f"X must be [ncol, nrhs], got shape "
                         f"{tuple(X.shape)}")


def spmm_coo(A: COO, X: torch.Tensor) -> torch.Tensor:
    """COO SpMM: entries sorted by row (sorted first if they are not),
    then the same row-owned segment sum as CSR."""
    _check_rhs(X)
    A = A.sort_by_row()
    bounds = torch.arange(A.shape[0] + 1, dtype=A.row.dtype,
                          device=A.row.device)
    offsets = torch.searchsorted(A.row, bounds)
    return _row_sums(A.data[:, None] * X[A.col], offsets)


def spmm_csr(A: CSR, X: torch.Tensor) -> torch.Tensor:
    """CSR SpMM: ``data * X[indices]`` summed per row over ``indptr``."""
    _check_rhs(X)
    return _row_sums(A.data[:, None] * X[A.indices], A.indptr)


def spmm_csc(A: CSC, X: torch.Tensor) -> torch.Tensor:
    """CSC SpMM: the entries in row order, summed per row (as
    :func:`.spmv.spmv_csc`)."""
    _check_rhs(X)
    order = A.row_order
    return _row_sums(A.data[order][:, None] * X[A.col_ids[order]], A.row_ptr)


def spmm_dia(A: DIA, X: torch.Tensor) -> torch.Tensor:
    """DIA SpMM: one shifted FMA per diagonal over a row-padded ``X``."""
    _check_rhs(X)
    nrow, ncol = A.shape
    lo = max(0, -min(A.offsets))
    hi = max(0, (nrow - 1) + max(A.offsets) - (ncol - 1))
    Xp = F.pad(X, (0, 0, lo, hi))
    out = torch.zeros(nrow, X.shape[1], dtype=torch.result_type(A.data, X),
                      device=X.device)
    for d, off in enumerate(A.offsets):
        out = out + A.data[d][:, None] * Xp[off + lo:off + lo + nrow]
    return out


_DISPATCH = {COO: spmm_coo, CSR: spmm_csr, CSC: spmm_csc, DIA: spmm_dia}


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for COO, CSR, CSC and DIA, ``X: [ncol, nrhs]``."""
    try:
        fn = _DISPATCH[type(A)]
    except KeyError:
        raise TypeError(f"unsupported sparse type {type(A).__name__}") from None
    return fn(A, X)
