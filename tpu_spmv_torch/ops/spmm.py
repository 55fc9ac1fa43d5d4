"""Sparse matrix × dense matrix (SpMM, multi-RHS SpMV) in plain PyTorch.

Counterpart of ``tpu_spmv/ops/spmm.py``.  Convention: ``X`` is ``[ncol,
nrhs]``, the result is ``[nrow, nrhs]``.

The reductions are :mod:`.spmv`'s with a trailing RHS axis, row-owned and
deterministic: COO/CSR/CSC gather the rows of ``X``, multiply, and sum each
row's run of products with ``torch.segment_reduce`` along axis 0; ELL sums
its gathered slots; DIA is a static loop of shifted dense FMAs over a
zero-padded ``X``.  The block formats contract ``[bs, bs] @ [bs, nrhs]``
per block as ``bs`` elementwise multiply-adds over the block's columns, in
column order (BSR then sums each block row's blocks over ``indptr``): no
matrix product, so float32 stays float32 with no TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import BDIA, BSR, COO, CSC, CSR, DIA, ELL
from .spmv import _row_sums, bdia_pad, blocked

__all__ = ["spmm", "spmm_coo", "spmm_csr", "spmm_csc", "spmm_ell",
           "spmm_dia", "spmm_bsr", "spmm_bdia"]


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


def spmm_ell(A: ELL, X: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: ``data * X[cols]`` summed along each row's slots."""
    _check_rhs(X)
    return (A.data[:, :, None] * X[A.cols]).sum(dim=1)


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


def _block_mm(blocks: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """``blocks [n, bs, bs] @ Xb [n, bs, nrhs]`` as ``bs`` multiply-adds
    over the block's columns, in order."""
    acc = None
    for j in range(blocks.shape[-1]):
        part = blocks[:, :, j, None] * Xb[:, None, j, :]
        acc = part if acc is None else acc + part
    return acc


def spmm_bsr(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """BSR SpMM: each block times its gathered ``[bs, nrhs]`` rows of
    ``X``, the blocks of a block row summed over ``indptr``."""
    _check_rhs(X)
    nrhs = X.shape[1]
    Yb = _block_mm(A.data, blocked(X, A.nbcol, A.block_size)[A.indices])
    Ybr = _row_sums(Yb.reshape(A.nblocks, -1), A.indptr)
    return Ybr.reshape(-1, nrhs)[:A.shape[0]]


def spmm_bdia(A: BDIA, X: torch.Tensor) -> torch.Tensor:
    """BDIA SpMM: per block diagonal, the blocks times a shifted slice of
    the blocked, zero-padded ``X``."""
    _check_rhs(X)
    lo, hi = bdia_pad(A.offsets, A.nbrow, A.nbcol)
    Xbp = F.pad(blocked(X, A.nbcol, A.block_size), (0, 0, 0, 0, lo, hi))
    acc = None
    for d, off in enumerate(A.offsets):
        part = _block_mm(A.data[d], Xbp[off + lo:off + lo + A.nbrow])
        acc = part if acc is None else acc + part
    return acc.reshape(-1, X.shape[1])[:A.shape[0]]


_DISPATCH = {COO: spmm_coo, CSR: spmm_csr, CSC: spmm_csc, ELL: spmm_ell,
             DIA: spmm_dia, BSR: spmm_bsr, BDIA: spmm_bdia}


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for any port format, ``X: [ncol, nrhs]``."""
    try:
        fn = _DISPATCH[type(A)]
    except KeyError:
        raise TypeError(f"unsupported sparse type {type(A).__name__}") from None
    return fn(A, X)
