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

``pack_gpr(dtype=torch.bfloat16)`` stores the coefficients in bf16 (the
values rounded once) for a float32 x: the SpMV then runs the kernel's
bf16-data form (``gpr_spmv<float, __nv_bfloat16>``), whose plain version
sums the float32 products in the kernel's own order (lanes, then the
butterfly; :func:`gpr_rows_ordered`), so the two agree bit for bit.  The
SpMM runs ``gpr_spmm<float, __nv_bfloat16, ...>`` on such a pack with a
float32 ``X``: each product rounded, then added to its output in entry
order from zero, which its plain version repeats
(:func:`gpr_spmm_ordered`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import to_coo
from ..formats.base import (as_values, host_values, sparse_dataclass,
                           torch_dtype)
from . import _build

__all__ = ["GPCSR", "CLASS_W", "LANES", "LAUNCHES", "pack_gpr", "supports",
           "spmv_gpr_rows", "spmv_gpr_ref", "gpr_rows_ordered",
           "fold_hub_rows", "spmv_gpr", "spmm_gpr_rows", "spmm_gpr_ref",
           "gpr_spmm_ordered", "spmm_gpr"]

LANES = 128
#: width-class budgets: a row of n entries goes to the first W >= n
CLASS_W = (8, 16, 32, 64, 128)
#: lanes a row of each width class (a quarter of the class width), as the
#: kernel gives them
CLASS_LANES = tuple(w // 4 for w in CLASS_W)
#: kernel launches by :func:`spmv_gpr_rows` and :func:`spmm_gpr_rows` on
#: CUDA tensors (``*_bf16``: their bf16-data forms; plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"gpr": 0, "gpr_bf16": 0, "gpr_spmm": 0, "gpr_spmm_bf16": 0}
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
    port format, columns sorted within each row; bfloat16 ``dtype``: the
    values rounded to bf16 once, held as float32 (numpy has no bf16)."""
    if not hasattr(mat, "tocsr"):
        mat = to_coo(mat).to_scipy()
    csr = mat.tocsr()
    csr.sort_indices()
    dtype = torch_dtype(dtype)
    data = np.asarray(csr.data)
    if dtype == torch.bfloat16:
        data = host_values(as_values(data, dtype))
    else:
        data = data.astype(np.float32 if dtype == torch.float32
                           else np.float64)
    return (np.asarray(csr.indptr, dtype=np.int64),
            np.asarray(csr.indices, dtype=np.int64), data, csr.shape)


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
    float64); ``torch.bfloat16`` stores the values rounded to bf16 once,
    in the same places as the float32 pack of the rounded matrix."""
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
                 indices=up(cols[src].astype(np.int32)),
                 data=as_values(data[src], dtype, device),
                 hub_owner=up(hub_owner),
                 hub_rows=up(hub_owner[starts].astype(np.int64)),
                 hub_ptr=up(hub_ptr), shape=(int(nrow_logical), int(ncol)),
                 nnz=int(nnz), class_rows=tuple(int(c) for c in class_rows),
                 nv=int(len(hub_owner)))


def spmv_gpr_ref(A: GPCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y_int[rows[r]] = Σ data·x[
    indices]`` over sorted row ``r``'s entries, a row-owned segment sum
    (``[ncol] -> [nrow + nv]``, internal row space).  On bf16 data: the
    bf16-data form's exact arithmetic, :func:`gpr_rows_ordered`."""
    if A.data.dtype == torch.bfloat16:
        return gpr_rows_ordered(A, x)
    sums = torch.segment_reduce(A.data * x[A.indices], "sum",
                                offsets=A.indptr, axis=0)
    y = torch.empty(A.nrow_internal, dtype=x.dtype, device=x.device)
    y[A.rows.long()] = sums            # a permutation: one writer per row
    return y


def gpr_rows_ordered(A: GPCSR, x: torch.Tensor) -> torch.Tensor:
    """Every internal row's sum in the bf16-data kernel's own order
    (``[ncol] -> [nrow + nv]``): each product ``data·x`` rounded to x's
    type (bf16 widens exactly), lane ``l`` of a class's ``T`` lanes
    summing the row's entries ``l, l + T, l + 2T, ...`` in turn from
    zero, then the lanes combined as the kernel's butterfly does (lane
    ``l`` plus lane ``l + h``, ``h = T/2, T/4, ..., 1``).  Bit for bit the
    kernel's result."""
    prod = A.data.to(x.dtype) * x[A.indices]
    y = torch.empty(A.nrow_internal, dtype=x.dtype, device=x.device)
    first = 0
    for lanes, n in zip(CLASS_LANES, A.class_rows):
        if not n:
            continue
        ptr = A.indptr[first:first + n + 1]
        begin, count = ptr[:-1], ptr[1:] - ptr[:-1]
        steps = -(-int(count.max()) // lanes)
        k = torch.arange(steps * lanes, device=x.device)
        valid = k[None, :] < count[:, None]
        idx = torch.where(valid, begin[:, None] + k[None, :], 0)
        g, valid = (t.reshape(n, steps, lanes) for t in (prod[idx], valid))
        acc = torch.zeros(n, lanes, dtype=x.dtype, device=x.device)
        for e in range(steps):
            acc = torch.where(valid[:, e], acc + g[:, e], acc)
        while acc.shape[1] > 1:
            h = acc.shape[1] // 2
            acc = acc[:, :h] + acc[:, h:]
        y[A.rows[first:first + n].long()] = acc[:, 0]
        first += n
    return y


def spmm_gpr_ref(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gpr_spmm``: :func:`spmv_gpr_ref` with a
    trailing RHS axis (``[ncol, nrhs] -> [nrow + nv, nrhs]``).  On bf16
    data the bf16-data form's exact arithmetic, :func:`gpr_spmm_ordered`."""
    if A.data.dtype == torch.bfloat16:
        return gpr_spmm_ordered(A, X)
    sums = torch.segment_reduce(A.data[:, None] * X[A.indices], "sum",
                                offsets=A.indptr, axis=0)
    Y = torch.empty(A.nrow_internal, X.shape[1], dtype=X.dtype,
                    device=X.device)
    Y[A.rows.long()] = sums
    return Y


def rows_in_order(begin: torch.Tensor, end: torch.Tensor,
                  data: torch.Tensor, indices: torch.Tensor, X: torch.Tensor,
                  step: int = 1) -> torch.Tensor:
    """Each row's products with ``X [ncol, nrhs]`` added in entry order
    from zero, each product ``data·X`` rounded to ``X``'s type first (bf16
    widens exactly): row ``r``'s entries are ``begin[r], begin[r] + step,
    ...`` below ``end[r]``.  The SpMMs' bf16-data arithmetic, one entry of
    every row a step."""
    count = (end - begin + step - 1) // step
    acc = X.new_zeros(begin.shape[0], X.shape[1])
    for e in range(int(count.max()) if count.numel() else 0):
        live = e < count
        j = torch.where(live, begin + e * step, 0)
        prod = data[j].to(X.dtype)[:, None] * X[indices[j]]
        acc = torch.where(live[:, None], acc + prod, acc)
    return acc


def gpr_spmm_ordered(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """Every internal row's product with ``X`` in the bf16-data SpMM's own
    order (``[ncol, nrhs] -> [nrow + nv, nrhs]``): each output adds its
    row's rounded products in entry order from zero (:func:`rows_in_order`).
    Bit for bit the kernel's result."""
    Y = X.new_empty(A.nrow_internal, X.shape[1])
    Y[A.rows.long()] = rows_in_order(A.indptr[:-1], A.indptr[1:], A.data,
                                     A.indices, X)
    return Y


def _check(name: str, A, x: torch.Tensor, ndim: int = 1, *,
           values: torch.Tensor | None = None, arrays=None) -> None:
    """Raise on anything the kernels do not take: ``x`` is ``[ncol]``, or
    ``[ncol, nrhs]`` with ``ndim=2``, and matches the matrix ``values``
    (default: a :class:`GPCSR`'s data) in type and device, bfloat16
    values pairing with a float32 x (the bf16-data forms); ``arrays`` (by
    default the GPCSR's) must be contiguous."""
    values = A.data if values is None else values
    if arrays is None:
        arrays = (A.rows, A.indptr, A.indices, A.data)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x must be float32 or float64, "
                        f"got {x.dtype}")
    mixed = values.dtype == torch.bfloat16 and x.dtype == torch.float32
    if values.dtype != x.dtype and not mixed:
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
    for all classes (on bfloat16 data against a float32 x its bf16-data
    form, counted apart); CPU tensor: :func:`spmv_gpr_ref`."""
    _check("spmv_gpr", A, x)
    if x.is_cpu:
        return spmv_gpr_ref(A, x)
    bf16 = A.data.dtype == torch.bfloat16
    y = x.new_empty(A.nrow_internal)
    launch = (_build.launcher("gpr_spmv_bf16f32") if bf16
              else _build.launcher("gpr_spmv", x.dtype))
    launch(x, A.rows.data_ptr(), A.indptr.data_ptr(), A.indices.data_ptr(),
           A.data.data_ptr(), x.data_ptr(), y.data_ptr(), *A.class_rows)
    LAUNCHES["gpr_bf16" if bf16 else "gpr"] += 1
    return y


def spmm_gpr_rows(A: GPCSR, X: torch.Tensor) -> torch.Tensor:
    """Every internal row's product with ``X [ncol, nrhs]``, in internal
    row order (``[nrow + nv, nrhs]``), before the virtual-row fold.

    CUDA tensor: launches ``gpr_spmm`` (``csrc/general.cu``; on bfloat16
    data against a float32 ``X`` its bf16-data form, counted apart); CPU
    tensor: :func:`spmm_gpr_ref`."""
    _check("spmm_gpr", A, X, ndim=2)
    if X.is_cpu:
        return spmm_gpr_ref(A, X)
    bf16 = A.data.dtype == torch.bfloat16
    Y = X.new_empty(A.nrow_internal, X.shape[1])
    launch = (_build.launcher("gpr_spmm_bf16f32") if bf16
              else _build.launcher("gpr_spmm", X.dtype))
    launch(X, A.rows.data_ptr(), A.indptr.data_ptr(), A.indices.data_ptr(),
           A.data.data_ptr(), X.data_ptr(), Y.data_ptr(), A.nrow_internal,
           X.shape[1])
    LAUNCHES["gpr_spmm_bf16" if bf16 else "gpr_spmm"] += 1
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
