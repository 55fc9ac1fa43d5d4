"""Sparse matrix–vector products for COO, CSR, CSC, ELL, DIA, BSR and BDIA
in plain PyTorch.

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
- ELL gathers ``x`` by its ``[nrow, width]`` columns and sums each row of
  products (pad slots hold 0).
- DIA is a static loop of shifted dense FMAs over a zero-padded ``x``.
- BSR gathers ``x`` a block at a time, contracts each block with its
  ``bs`` values, and sums each block row's run of blocks with
  ``torch.segment_reduce`` over ``indptr``.
- BDIA contracts each block diagonal with a shifted slice of the blocked,
  zero-padded ``x`` (no index arrays, no gather).

The block contractions are elementwise products summed over the block's
columns, never a matrix product, so float32 sums stay float32 with no TF32
whatever torch's matmul flags say.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats import BDIA, BSR, COO, CSC, CSR, DIA, ELL

__all__ = ["spmv", "spmv_coo", "spmv_csr", "spmv_csc", "spmv_ell",
           "spmv_dia", "spmv_bsr", "spmv_bdia"]


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


def spmv_ell(A: ELL, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """ELL SpMV: ``data * x[cols]`` summed along each row (pad slots hold
    value 0, so no mask is needed)."""
    return _finish((A.data * x[A.cols]).sum(dim=1), y)


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


def blocked(x: torch.Tensor, nblocks: int, bs: int) -> torch.Tensor:
    """``x [n, ...]`` zero-padded to ``nblocks * bs`` rows as ``[nblocks,
    bs, ...]``."""
    pad = nblocks * bs - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape((nblocks, bs) + tuple(x.shape[1:]))


def bdia_pad(offsets, nbrow: int, nbcol: int) -> tuple[int, int]:
    """Block rows of zeros before and after the blocked ``x`` so that
    every block diagonal's slice ``[off + lo, off + lo + nbrow)`` is in
    range."""
    return (max(0, -min(offsets)),
            max(0, (nbrow - 1) + max(offsets) - (nbcol - 1)))


def bdia_blocks(data: torch.Tensor, offsets, xbp: torch.Tensor, lo: int,
                nbrow: int) -> torch.Tensor:
    """``[nbrow, bs]`` block products ``sum_d data[d] @ xbp[off_d + lo :
    off_d + lo + nbrow]`` as elementwise products summed over the block's
    columns (``xbp`` is the blocked, padded ``x``)."""
    acc = None
    for d, off in enumerate(offsets):
        xs = xbp[off + lo:off + lo + nbrow]
        part = (data[d] * xs[:, None, :]).sum(dim=-1)
        acc = part if acc is None else acc + part
    return acc


def spmv_bsr(A: BSR, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """BSR SpMV: each block times its gathered ``bs`` values of ``x``, the
    blocks of a block row summed over ``indptr`` (row-owned)."""
    xb = blocked(x, A.nbcol, A.block_size)
    yb = (A.data * xb[A.indices][:, None, :]).sum(dim=-1)
    ax = _row_sums(yb, A.indptr).reshape(-1)[:A.shape[0]]
    return _finish(ax, y)


def spmv_bdia(A: BDIA, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """BDIA SpMV: one contraction per block diagonal with a shifted slice
    of the blocked, zero-padded ``x`` (out-of-range blocks are zero)."""
    lo, hi = bdia_pad(A.offsets, A.nbrow, A.nbcol)
    xb = blocked(x, A.nbcol, A.block_size)
    xbp = F.pad(xb, (0, 0, lo, hi))
    ax = bdia_blocks(A.data, A.offsets, xbp, lo, A.nbrow).reshape(-1)
    return _finish(ax[:A.shape[0]], y)


_DISPATCH = {COO: spmv_coo, CSR: spmv_csr, CSC: spmv_csc, ELL: spmv_ell,
             DIA: spmv_dia, BSR: spmv_bsr, BDIA: spmv_bdia}


def spmv(A, x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (or ``y + A @ x``) for COO, CSR, CSC, ELL, DIA, BSR and
    BDIA."""
    try:
        fn = _DISPATCH[type(A)]
    except KeyError:
        raise TypeError(f"unsupported sparse type {type(A).__name__}") from None
    return fn(A, x, y)
