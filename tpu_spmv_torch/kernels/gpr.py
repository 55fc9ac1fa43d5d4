"""General-pattern SpMV and SpMM by row-width class — the port of the GPR
pipeline.

Counterpart of ``tpu_spmv/kernels/gpr.py`` (``pack_gpr``, ``spmv_gpr``,
``spmm_gpr``).
The reference gathers x into column-segment slots, routes the gathered
values through a Clos permutation into row-aligned ``[8, 128]`` tiles and
reduces them per width class with a mask matmul (K5a–K5d), because a TPU
gathers fast only within 128 lanes.  A Hopper thread can read any address,
so the port keeps what that pipeline computes and the pattern logic of its
pack, and drops the TPU layout:

- **hub split** (``gpr.py:256-288``): rows with more than 128 entries
  become virtual rows of at most 128 entries, appended after the real rows;
  ``hub_owner`` (sorted) names each one's real row.  After the split no row
  exceeds 128 entries, so nothing spills to a side path;
- **width classes** (``gpr.py:301-308``): each row goes to the narrowest of
  ``CLASS_W = (8, 16, 32, 64, 128)`` that holds it, and the rows are laid
  out class-major in stable order — a class-sorted CSR (:class:`GPCSR`);
- the kernel (``gpr_spmv`` in ``csrc/general.cu``) gives each class
  ``W / 4`` lanes per row (each lane at most four entries of its row,
  loaded before any is summed) and writes each row's sum in place at its
  internal row id, so the reference's y-restoring permutation has nothing
  to do;
- the virtual rows fold back into their owners with a
  ``torch.segment_reduce`` over the runs of the sorted ``hub_owner`` (one
  segment per owning row, so each owner has one writer), outside the
  kernel, as the reference folds with ``jax.ops.segment_sum``;
- the SpMM (``gpr_spmm``, the reference's K6 and RHS-batched K5b) runs over
  the same class-sorted CSR with a few lanes a row, each lane up to four
  consecutive right-hand sides of ``X [ncol, nrhs]`` (one 16-byte load a
  lane per entry, a 128-byte line at 32 float32 RHS), and writes ``[nrow +
  nv, nrhs]`` rows in place; the same fold then runs along axis 0.

The Clos planes, the ``[8, 128]`` tile layouts, the ``side_gpr`` recursion,
the side COO, row chunking and the ``ncol`` envelope are TPU answers and
are not ported.

On a CUDA tensor :func:`spmv_gpr_rows` and :func:`spmm_gpr_rows` launch
their kernels (built at first use, :mod:`._build`) and count the launch in
:data:`LAUNCHES`; on a CPU tensor they run the plain versions
:func:`spmv_gpr_ref` and :func:`spmm_gpr_ref`.  Nothing falls back
from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import to_coo
from ..formats.base import sparse_dataclass, torch_dtype
from . import _build

__all__ = ["GPCSR", "CLASS_W", "LANES", "LAUNCHES", "pack_gpr", "supports",
           "spmv_gpr_rows", "spmv_gpr_ref", "fold_hub_rows", "spmv_gpr",
           "spmm_gpr_rows", "spmm_gpr_ref", "spmm_gpr"]

LANES = 128
#: width-class budgets: a row of n entries goes to the first W >= n
CLASS_W = (8, 16, 32, 64, 128)
#: kernel launches by :func:`spmv_gpr_rows` and :func:`spmm_gpr_rows` on
#: CUDA tensors (plain-version calls on CPU tensors are not counted)
LAUNCHES = {"gpr": 0, "gpr_spmm": 0}
#: the kernel's column indices are int32
_MAX_NCOL = 2**31 - 1


@sparse_dataclass
class GPCSR:
    """Class-sorted CSR for the general-pattern kernel.

    Internal rows are the ``shape[0]`` real rows followed by ``nv`` virtual
    (hub-split) rows.  Sorted row ``r`` is internal row ``rows[r]``; its
    entries are ``indptr[r]:indptr[r + 1]`` of ``indices`` / ``data``,
    ascending by column.  The first ``class_rows[0]`` sorted rows are class
    ``CLASS_W[0]``, the next ``class_rows[1]`` class ``CLASS_W[1]``, and
    so on."""

    rows: torch.Tensor            # [nrow + nv] int32
    indptr: torch.Tensor          # [nrow + nv + 1] int64
    indices: torch.Tensor         # [nnz] int32
    data: torch.Tensor            # [nnz]
    hub_owner: torch.Tensor       # [nv] int32, sorted
    hub_rows: torch.Tensor        # [nh] int64, the distinct owners
    hub_ptr: torch.Tensor         # [nh + 1] int64, their runs in hub_owner
    shape: tuple[int, int]
    nnz: int
    class_rows: tuple[int, ...]   # rows per class, CLASS_W order
    nv: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nrow_internal(self) -> int:
        return self.shape[0] + self.nv


def supports(shape, nnz) -> bool:
    """The kernel's envelope: int32 column indices.  No ``ncol`` cap
    beyond that (the reference's is a VMEM fact) and no nnz cap (``indptr``
    is int64)."""
    return shape[0] >= 1 and shape[1] <= _MAX_NCOL


def _host_csr(mat, dtype):
    """``(indptr int64, cols int64, data, shape)`` of a scipy matrix or a
    port format, columns sorted within each row."""
    if not hasattr(mat, "tocsr"):
        mat = to_coo(mat).to_scipy()
    csr = mat.tocsr()
    csr.sort_indices()
    np_dtype = np.float32 if torch_dtype(dtype) == torch.float32 else np.float64
    return (np.asarray(csr.indptr, dtype=np.int64),
            np.asarray(csr.indices, dtype=np.int64),
            np.asarray(csr.data).astype(np_dtype), csr.shape)


def _value_dtype(mat, dtype):
    if dtype is not None:
        return torch_dtype(dtype)
    data = getattr(mat, "data", None)
    if isinstance(data, torch.Tensor):
        return data.dtype
    if data is not None and np.dtype(data.dtype) == np.float32:
        return torch.float32
    return torch.float64


def pack_gpr(mat, *, dtype=None, device="cuda") -> GPCSR:
    """Pack a scipy matrix or a port format (host analysis, the
    reference's pattern rules) into a :class:`GPCSR` on ``device``.

    ``dtype=None`` keeps the matrix's own value type (float32, else
    float64)."""
    dtype = _value_dtype(mat, dtype)
    indptr, cols, data, (nrow, ncol) = _host_csr(mat, dtype)
    if not supports((nrow, ncol), len(cols)):
        raise ValueError(f"gpr: shape {(nrow, ncol)} outside the kernel's "
                         f"envelope (ncol <= {_MAX_NCOL})")
    nnz = len(cols)
    nrow_logical = nrow
    counts = np.diff(indptr)
    hub_owner = np.zeros(0, dtype=np.int32)
    if counts.max(initial=0) > LANES:
        # hub split: entry o of a row goes to its 128-entry block o >> 7;
        # blocks past the first become virtual rows nrow + k, numbered by
        # (owner, block) ascending
        row_ids0 = np.repeat(np.arange(nrow, dtype=np.int64), counts)
        blk = (np.arange(nnz, dtype=np.int64) - indptr[row_ids0]) >> 7
        hub = blk > 0
        maxb = int(blk.max()) + 1
        uniq, inv = np.unique(row_ids0[hub] * maxb + blk[hub],
                              return_inverse=True)
        new_rows = row_ids0
        new_rows[hub] = nrow + inv
        hub_owner = (uniq // maxb).astype(np.int32)
        nrow += len(uniq)
        # a stable sort by the new row keeps each row's columns ascending
        order = np.argsort(new_rows, kind="stable")
        cols, data = cols[order], data[order]
        counts = np.bincount(new_rows, minlength=nrow)
        indptr = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])

    # width classes, class-major stable row order
    cls = np.minimum(np.searchsorted(CLASS_W, counts), len(CLASS_W) - 1)
    row_order = np.argsort(cls, kind="stable")
    class_rows = np.bincount(cls, minlength=len(CLASS_W))
    s_counts = counts[row_order]
    s_indptr = np.zeros(nrow + 1, dtype=np.int64)
    np.cumsum(s_counts, out=s_indptr[1:])
    # entry j of sorted row r comes from indptr[row_order[r]] + j
    src = (np.repeat(indptr[row_order] - s_indptr[:-1], s_counts)
           + np.arange(nnz, dtype=np.int64))
    # the runs of the sorted hub_owner: one fold segment per owning row
    starts = np.flatnonzero(np.diff(hub_owner, prepend=-1))
    hub_ptr = np.append(starts, len(hub_owner)).astype(np.int64)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GPCSR(rows=up(row_order.astype(np.int32)), indptr=up(s_indptr),
                 indices=up(cols[src].astype(np.int32)), data=up(data[src]),
                 hub_owner=up(hub_owner),
                 hub_rows=up(hub_owner[starts].astype(np.int64)),
                 hub_ptr=up(hub_ptr), shape=(int(nrow_logical), int(ncol)),
                 nnz=int(nnz), class_rows=tuple(int(c) for c in class_rows),
                 nv=int(len(hub_owner)))


def spmv_gpr_ref(A: GPCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y_int[rows[r]] = Σ data·x[
    indices]`` over sorted row ``r``'s entries, a row-owned segment sum
    (``[ncol] -> [nrow + nv]``, internal row space)."""
    sums = torch.segment_reduce(A.data * x[A.indices], "sum",
                                offsets=A.indptr, axis=0)
    y = torch.empty(A.nrow_internal, dtype=x.dtype, device=x.device)
    y[A.rows.long()] = sums            # a permutation: one writer per row
    return y


def spmm_gpr_ref(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gpr_spmm``: :func:`spmv_gpr_ref` with a
    trailing RHS axis (``[ncol, nrhs] -> [nrow + nv, nrhs]``)."""
    sums = torch.segment_reduce(A.data[:, None] * X[A.indices], "sum",
                                offsets=A.indptr, axis=0)
    Y = torch.empty(A.nrow_internal, X.shape[1], dtype=X.dtype,
                    device=X.device)
    Y[A.rows.long()] = sums
    return Y


def _check(name: str, A, x: torch.Tensor, ndim: int = 1, *,
           values: torch.Tensor | None = None, arrays=None) -> None:
    """Raise on anything the kernels do not take: ``x`` is ``[ncol]``, or
    ``[ncol, nrhs]`` with ``ndim=2``, and matches the matrix ``values``
    (default: a :class:`GPCSR`'s data) in type and device; ``arrays`` (by
    default the GPCSR's) must be contiguous."""
    values = A.data if values is None else values
    if arrays is None:
        arrays = (A.rows, A.indptr, A.indices, A.data)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x must be float32 or float64, "
                        f"got {x.dtype}")
    if values.dtype != x.dtype:
        raise TypeError(f"{name}: matrix is {values.dtype} but x is "
                        f"{x.dtype}")
    if values.device != x.device:
        raise ValueError(f"{name}: matrix on {values.device}, x on "
                         f"{x.device}")
    if x.dim() != ndim or x.shape[0] != A.shape[1]:
        want = "[ncol" + ("" if ndim == 1 else ", nrhs")
        raise ValueError(f"{name}: x must be {want}] with ncol="
                         f"{A.shape[1]}, got {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (*arrays, x)):
        raise ValueError(f"{name}: operands must be contiguous")


def spmv_gpr_rows(A: GPCSR, x: torch.Tensor) -> torch.Tensor:
    """Every internal row's sum, in internal row order (``[ncol] ->
    [nrow + nv]``), before the virtual-row fold.

    CUDA tensor: launches ``gpr_spmv`` (``csrc/general.cu``), one launch
    for all classes; CPU tensor: :func:`spmv_gpr_ref`."""
    _check("spmv_gpr", A, x)
    if x.is_cpu:
        return spmv_gpr_ref(A, x)
    y = x.new_empty(A.nrow_internal)
    _build.launcher("gpr_spmv", x.dtype)(
        x, A.rows.data_ptr(), A.indptr.data_ptr(), A.indices.data_ptr(),
        A.data.data_ptr(), x.data_ptr(), y.data_ptr(), *A.class_rows)
    LAUNCHES["gpr"] += 1
    return y


def spmm_gpr_rows(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """Every internal row's product with ``X [ncol, nrhs]``, in internal
    row order (``[nrow + nv, nrhs]``), before the virtual-row fold.

    CUDA tensor: launches ``gpr_spmm`` (``csrc/general.cu``); CPU tensor:
    :func:`spmm_gpr_ref`."""
    _check("spmm_gpr", A, X, ndim=2)
    if X.is_cpu:
        return spmm_gpr_ref(A, X)
    Y = X.new_empty(A.nrow_internal, X.shape[1])
    _build.launcher("gpr_spmm", X.dtype)(
        X, A.rows.data_ptr(), A.indptr.data_ptr(), A.indices.data_ptr(),
        A.data.data_ptr(), X.data_ptr(), Y.data_ptr(), A.nrow_internal,
        X.shape[1])
    LAUNCHES["gpr_spmm"] += 1
    return Y


def fold_hub_rows(A: GPCSR, y_int: torch.Tensor) -> torch.Tensor:
    """Add each virtual row's sum into its owner (``[nrow + nv] ->
    [nrow]``, or ``[nrow + nv, nrhs] -> [nrow, nrhs]``, in place in
    ``y_int``'s storage): a segment sum along axis 0 over each owner's run
    of virtual rows, then one write per owner."""
    if not A.nv:
        return y_int
    n = A.shape[0]
    part = torch.segment_reduce(y_int[n:], "sum", offsets=A.hub_ptr, axis=0)
    y = y_int[:n]
    y[A.hub_rows] = y[A.hub_rows] + part      # distinct rows: one writer
    return y


def spmv_gpr(A: GPCSR, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (+ ``y``): the kernel's row sums with the virtual rows
    folded back."""
    out = fold_hub_rows(A, spmv_gpr_rows(A, x))
    return out if y is None else y + out


def spmm_gpr(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for ``X [ncol, nrhs]``: the kernel's row products with the
    virtual rows folded back (``[nrow, nrhs]``)."""
    return fold_hub_rows(A, spmm_gpr_rows(A, X))
