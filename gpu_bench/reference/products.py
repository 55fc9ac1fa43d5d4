"""``A @ X`` in float64 from a host CSR, in blocks of rows on the device.

The CSR is the configuration's generated matrix (``indptr``, ``indices``,
``data`` as NumPy arrays, ``data`` in float64), never anything the
program packed.  Blocks of rows travel to the device one at a time, so
the reference fits beside whatever else is there and sets no memory peak
of the timed run (it runs after the peak has been read).

``bf16=True`` is the control: the same product with the matrix values
and ``X`` rounded to bfloat16 first, the nearest precision below the
configuration's float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: float64 products held on the device at a time (per block)
BLOCK_VALUES = 1 << 25


@dataclass(frozen=True)
class HostCSR:
    """A square or rectangular CSR on the host; ``data`` is float64."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def _row_blocks(indptr: np.ndarray, per_block: int):
    """``(r0, r1)`` spans of whole rows holding about ``per_block``
    entries each (a longer row is a block of its own)."""
    n = len(indptr) - 1
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + per_block, "right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        yield r0, r1
        r0 = r1


def _rounded(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).double() if bf16 else t.double()


def matmul(A: HostCSR, X: torch.Tensor, *, bf16: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(A @ X, |A| @ |X|)`` in float64 on ``X``'s device, for ``X`` of
    shape ``[ncol]`` or ``[ncol, k]``."""
    dev = X.device
    X64 = _rounded(X, bf16)
    k = 1 if X.dim() == 1 else X.shape[1]
    Y = torch.zeros((A.shape[0],) + tuple(X.shape[1:]), dtype=torch.float64,
                    device=dev)
    Yabs = torch.zeros_like(Y)
    absX = X64.abs()
    for r0, r1 in _row_blocks(A.indptr, max(1, BLOCK_VALUES // k)):
        p0, p1 = int(A.indptr[r0]), int(A.indptr[r1])
        if p0 == p1:
            continue
        cols = torch.from_numpy(A.indices[p0:p1]).to(dev).long()
        vals = _rounded(torch.from_numpy(A.data[p0:p1]), bf16).to(dev)
        counts = torch.from_numpy(np.diff(A.indptr[r0:r1 + 1])).to(dev)
        rows = torch.repeat_interleave(
            torch.arange(r1 - r0, device=dev), counts)
        if X.dim() > 1:
            vals = vals[:, None]
        Y[r0:r1].index_add_(0, rows, vals * X64[cols])
        Yabs[r0:r1].index_add_(0, rows, vals.abs() * absX[cols])
    return Y, Yabs


def componentwise_error(y: torch.Tensor, ref: torch.Tensor,
                        ref_abs: torch.Tensor) -> float:
    """``max |y - ref| / (|A| |x|)`` over every entry: the error of each
    sum against the size of its terms, which float32 rounding bounds by a
    small multiple of its unit round-off.  A nonzero where every term is
    zero (an empty row) is an infinite error."""
    diff = (y.double() - ref).abs()
    err = torch.where(ref_abs > 0, diff / torch.where(ref_abs > 0, ref_abs, 1),
                      torch.where(diff > 0, torch.inf, 0.0))
    return float(err.max()) if err.numel() else 0.0


def relative_residuals(A: HostCSR, B: torch.Tensor, X: torch.Tensor
                       ) -> list[float]:
    """``||b - A x|| / ||b||`` in float64 for each column of ``B`` and
    ``X`` (``[n, k]``)."""
    AX, _ = matmul(A, X)
    B64 = B.double()
    return (torch.linalg.norm(B64 - AX, dim=0)
            / torch.linalg.norm(B64, dim=0)).tolist()
