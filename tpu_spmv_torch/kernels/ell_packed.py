"""Sliced-ELL SpMV and SpMM, one warp per slice — the port of the
packed-ELL kernel.

Counterpart of ``tpu_spmv/kernels/ell_pallas.py`` (``pack_ell``,
``spmv_pallas``, K4, and ``spmm_pallas``, which maps K4 over the RHS).
The reference packs consecutive rows into ``[8, 128]`` lane tiles with
int8 lane and gather-round planes, because a TPU gathers fast only within
128 lanes and reduces rows with a mask matmul.  The port keeps what the format computes and drops that layout:

- a slice is 32 consecutive rows (one warp).  It is as wide as its longest
  row, capped at 128 slots per row — the reference's widest lane budget;
- a slice's slots are column-major: slot ``j`` of the slice's row ``i`` is
  ``slice_ptr[s] + 32 * j + i``, so the 32 threads of a warp read 32
  neighbouring addresses at every step;
- pad slots hold value 0 and column 0 and add exactly 0;
- entries beyond 128 in a row go to a ``side`` COO, added by the port's
  ``ops/spmv.py:spmv_coo`` outside the kernel, as the reference adds its
  side COO on the XLA tier (``ell_pallas.py:27-29``, ``:399-402``).

On a CUDA tensor :func:`spmv_ell_main` launches ``ell_spmv`` and
:func:`spmm_ell_main` launches ``ell_spmm``, ``gpr_spmm``'s body on the
slice's slots: each row's lanes hold up to 16 bytes of consecutive
right-hand sides of ``X [ncol, nrhs]`` each (``csrc/general.cu``, built at
first use by :mod:`._build`); each counts the launch in :data:`LAUNCHES`.
Every output sums its row's slots in order, so each column of
``ell_spmm`` is bitwise ``ell_spmv``'s.
On a CPU tensor they run the plain versions :func:`spmv_ell_packed_ref` and
:func:`spmm_ell_packed_ref`.  Nothing falls back from one to the other.

``pack_ell(dtype=torch.bfloat16)`` stores the slots' values (and the side
COO's) in bf16, rounded once, for a float32 x: the SpMV runs the kernel's
bf16-data form (``ell_spmv<float, __nv_bfloat16>``), whose plain version
adds the float32 products of a row's slots one at a time in slot order, as
the kernel does, so the two agree bit for bit.  The SpMM's bf16-data form
(``ell_spmm<float, __nv_bfloat16, ...>``, a float32 ``X``) adds each row's
rounded products in slot order too, so every column of it is bitwise the
SpMV's, and so does its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import COO
from ..formats.base import as_values, sparse_dataclass
from . import _build
from .gpr import _check, _host_csr, _value_dtype, rows_in_order

__all__ = ["PackedELL", "SLICE", "MAX_WIDTH", "LAUNCHES", "pack_ell",
           "slice_slots", "spmv_ell_main", "spmv_ell_packed_ref",
           "spmv_ell_packed", "spmm_ell_main", "spmm_ell_packed_ref",
           "spmm_ell_packed"]

#: rows per slice (one warp)
SLICE = 32
#: slots per row at most; the rest of a row goes to the side COO
MAX_WIDTH = 128
#: kernel launches by :func:`spmv_ell_main` and :func:`spmm_ell_main` on
#: CUDA tensors (``*_bf16``: their bf16-data forms; plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"ell": 0, "ell_bf16": 0, "ell_spmm": 0, "ell_spmm_bf16": 0}


@sparse_dataclass
class PackedELL:
    """Sliced ELL: 32-row slices, each as wide as its longest row (at most
    128), slots column-major inside a slice; the tails of rows over 128
    entries in ``side``."""

    vals: torch.Tensor            # [slots]
    cols: torch.Tensor            # [slots] int32
    slice_ptr: torch.Tensor       # [nslices + 1] int64, multiples of 32
    side: COO
    shape: tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def nslices(self) -> int:
        return int(self.slice_ptr.shape[0]) - 1

    @property
    def slots(self) -> int:
        return int(self.vals.shape[0])


def slice_slots(counts: np.ndarray) -> tuple[np.ndarray, int]:
    """Per-slice widths (slots per row) of rows with ``counts`` entries,
    and the number of slices."""
    nsl = -(-len(counts) // SLICE)
    padded = np.zeros(nsl * SLICE, dtype=np.int64)
    padded[:len(counts)] = np.minimum(counts, MAX_WIDTH)
    return padded.reshape(nsl, SLICE).max(axis=1, initial=0), nsl


def pack_ell(mat, *, dtype=None, device="cuda") -> PackedELL:
    """Pack a scipy matrix or a port format (host numpy) into a
    :class:`PackedELL` on ``device``.  ``dtype=None`` keeps the matrix's
    own value type (float32, else float64); ``torch.bfloat16`` stores the
    values rounded to bf16 once, in the same slots as the float32 pack of
    the rounded matrix."""
    dtype = _value_dtype(mat, dtype)
    indptr, cols, data, (nrow, ncol) = _host_csr(mat, dtype)
    if ncol > 2**31 - 1:
        raise ValueError(f"ell: ncol={ncol} exceeds int32 column indices")
    counts = np.diff(indptr)
    width, nsl = slice_slots(counts)
    slice_ptr = np.zeros(nsl + 1, dtype=np.int64)
    np.cumsum(width * SLICE, out=slice_ptr[1:])
    row_ids = np.repeat(np.arange(nrow, dtype=np.int64), counts)
    offs = np.arange(len(cols), dtype=np.int64) - indptr[row_ids]
    main = offs < MAX_WIDTH
    r = row_ids[main]
    pos = slice_ptr[r // SLICE] + offs[main] * SLICE + r % SLICE
    vals = np.zeros(int(slice_ptr[-1]), dtype=data.dtype)
    scol = np.zeros(int(slice_ptr[-1]), dtype=np.int32)
    vals[pos] = data[main]
    scol[pos] = cols[main]
    side = COO.from_arrays(row_ids[~main], cols[~main], data[~main],
                           (nrow, ncol), dtype=dtype, device=device)
    up = lambda a: torch.from_numpy(a).to(device)
    return PackedELL(vals=as_values(vals, dtype, device), cols=up(scol),
                     slice_ptr=up(slice_ptr),
                     side=side, shape=(int(nrow), int(ncol)),
                     nnz=int(len(cols)))


def _slot_index(A: PackedELL, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, valid)``, both ``[nrow, width]``: slot ``j`` of each row and
    whether it lies inside the row's slice (pointing at slot 0 where not)."""
    nrow = A.shape[0]
    width = (A.slice_ptr[1:] - A.slice_ptr[:-1]) // SLICE
    w = width.repeat_interleave(SLICE)[:nrow]
    lane = torch.arange(nrow, device=device) % SLICE
    base = A.slice_ptr[:-1].repeat_interleave(SLICE)[:nrow] + lane
    j = torch.arange(int(width.max()) if nrow else 0, device=device)
    idx = base[:, None] + SLICE * j[None, :]
    valid = j[None, :] < w[:, None]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def spmv_ell_packed_ref(A: PackedELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each row's slots gathered into
    a ``[nrow, width]`` block (pad slots and slots past the slice's width
    add 0) and summed over the slots (``[ncol] -> [nrow]``, without the
    side COO).  On bf16 data the kernel's bf16-data arithmetic: each
    product rounded to x's type (bf16 widens exactly), then added to the
    row's sum from zero one slot at a time, slots of the slice's width in
    order."""
    idx, valid = _slot_index(A, x.device)
    g = (A.vals.to(x.dtype) * x[A.cols])[idx]
    if A.vals.dtype != torch.bfloat16:
        return torch.where(valid, g, torch.zeros_like(g)).sum(dim=1)
    acc = torch.zeros(A.shape[0], dtype=x.dtype, device=x.device)
    for j in range(g.shape[1]):
        acc = torch.where(valid[:, j], acc + g[:, j], acc)
    return acc


def spmm_ell_packed_ref(A: PackedELL, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``ell_spmm``: :func:`spmv_ell_packed_ref`
    with a trailing RHS axis (``[ncol, nrhs] -> [nrow, nrhs]``, without
    the side COO); on bf16 data the kernel's order, each row's rounded
    products added slot by slot over its slice's width
    (:func:`.gpr.rows_in_order`)."""
    if A.vals.dtype == torch.bfloat16:
        rows = torch.arange(A.shape[0], device=X.device)
        begin = A.slice_ptr[rows // SLICE] + rows % SLICE
        return rows_in_order(begin, A.slice_ptr[rows // SLICE + 1], A.vals,
                             A.cols, X, step=SLICE)
    idx, valid = _slot_index(A, X.device)
    g = (A.vals[:, None] * X[A.cols])[idx]
    return torch.where(valid[..., None], g, torch.zeros_like(g)).sum(dim=1)


def _check_ell(name: str, A: PackedELL, x: torch.Tensor, ndim: int = 1):
    """Raise on anything the kernels do not take (the GPR checks, on the
    ELL arrays)."""
    _check(name, A, x, ndim, values=A.vals,
           arrays=(A.vals, A.cols, A.slice_ptr))


def spmv_ell_main(A: PackedELL, x: torch.Tensor) -> torch.Tensor:
    """The sliced-ELL part of ``A @ x`` (``[ncol] -> [nrow]``, without the
    side COO).

    CUDA tensor: launches ``ell_spmv`` (``csrc/general.cu``; on bfloat16
    data against a float32 x its bf16-data form, counted apart); CPU
    tensor: :func:`spmv_ell_packed_ref`."""
    _check_ell("spmv_ell", A, x)
    if x.is_cpu:
        return spmv_ell_packed_ref(A, x)
    bf16 = A.vals.dtype == torch.bfloat16
    y = x.new_empty(A.shape[0])
    launch = (_build.launcher("ell_spmv_bf16f32") if bf16
              else _build.launcher("ell_spmv", x.dtype))
    launch(x, A.vals.data_ptr(), A.cols.data_ptr(), A.slice_ptr.data_ptr(),
           x.data_ptr(), y.data_ptr(), A.shape[0])
    LAUNCHES["ell_bf16" if bf16 else "ell"] += 1
    return y


def spmm_ell_main(A: PackedELL, X: torch.Tensor) -> torch.Tensor:
    """The sliced-ELL part of ``A @ X`` (``[ncol, nrhs] -> [nrow, nrhs]``,
    without the side COO).

    CUDA tensor: launches ``ell_spmm`` (``csrc/general.cu``; on bfloat16
    data against a float32 ``X`` its bf16-data form, counted apart); CPU
    tensor: :func:`spmm_ell_packed_ref`."""
    _check_ell("spmm_ell", A, X, ndim=2)
    if X.is_cpu:
        return spmm_ell_packed_ref(A, X)
    bf16 = A.vals.dtype == torch.bfloat16
    Y = X.new_empty(A.shape[0], X.shape[1])
    launch = (_build.launcher("ell_spmm_bf16f32") if bf16
              else _build.launcher("ell_spmm", X.dtype))
    launch(X, A.vals.data_ptr(), A.cols.data_ptr(), A.slice_ptr.data_ptr(),
           X.data_ptr(), Y.data_ptr(), A.shape[0], X.shape[1])
    LAUNCHES["ell_spmm_bf16" if bf16 else "ell_spmm"] += 1
    return Y


def spmv_ell_packed(A: PackedELL, x: torch.Tensor,
                    y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (+ ``y``): the sliced-ELL kernel plus the side COO."""
    from ..ops.spmv import spmv_coo

    out = spmv_ell_main(A, x)
    if A.side.nnz:
        out = spmv_coo(A.side, x, y=out)
    return out if y is None else y + out


def spmm_ell_packed(A: PackedELL, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for ``X [ncol, nrhs]``: the sliced-ELL kernel plus the
    side COO, added once."""
    from ..ops.spmm import spmm_coo

    out = spmm_ell_main(A, X)
    return out + spmm_coo(A.side, X) if A.side.nnz else out
