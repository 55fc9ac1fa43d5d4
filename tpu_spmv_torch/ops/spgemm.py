"""Sparse × sparse products (SpGEMM): DIA × DIA assembled on the device,
and general operands by a host symbolic and a device numeric phase.

Counterpart of ``tpu_spmv/ops/spgemm.py`` (XLA code there, torch code
here).  A matrix with diagonals ``o1`` times one with diagonals ``o2`` has
diagonals ``o1 + o2``, each a sum of elementwise products of shifted input
diagonals::

    C[i, i + o1 + o2] += A.data[o1][i] * B.data[o2][i + o1]

so :func:`spgemm` on two DIAs is ``ndiags(A) * ndiags(B)`` shifted
multiply-adds over ``[nrow]`` vectors, the shifts zero-filled (no
wraparound): out-of-range reads multiply structural zeros.  The result is
a :class:`~..formats.DIA` that the planner and ``pack_sdia`` /
``pack_psdia`` take like any other (``spgemm(A, A)`` assembles A² for a
polynomial preconditioner).

:func:`spgemm_csr` takes any pair: the Gustavson pair expansion and the
output pattern come from numpy on the host (data-dependent, once per
pattern), and the device multiplies the expanded pairs and sums each
output slot's sorted run with ``torch.segment_reduce`` over its offsets —
no ``index_add_`` / ``scatter_add_``, which are atomic on CUDA, so the
bits are the same on every run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..formats import CSR, DIA, to_coo

__all__ = ["spgemm", "spgemm_csr"]


def _shift_fill(v: torch.Tensor, s: int) -> torch.Tensor:
    """``out[i] = v[i + s]``, zero where ``i + s`` is out of range."""
    n = v.shape[0]
    if s == 0:
        return v
    k = min(abs(s), n)
    if s > 0:
        return F.pad(v[k:], (0, k))
    return F.pad(v[:n - k], (k, 0))


def _to_scipy_csr(M):
    import scipy.sparse as sp

    if sp.issparse(M):
        return M.tocsr()
    return to_coo(M).to_scipy().tocsr()


def _device_of(*mats, device=None) -> torch.device:
    """``device``, else the first port format's device, else the card."""
    if device is not None:
        return torch.device(device)
    for M in mats:
        if hasattr(M, "device") and not hasattr(M, "tocsr"):
            return M.device
    return torch.device("cuda")


def _symbolic(As, Bs, max_pairs: int):
    """The host symbolic phase on two sorted scipy CSRs: ``(pa, pb,
    seg_ptr, out_rows, out_cols, indptr)`` — every pair's entry of ``A``
    and of ``B`` sorted by output ``(row, col)``, the offsets of each
    output's run of pairs, and the output pattern — or ``None`` for a
    product with no pair."""
    nrow = As.shape[0]
    a_ind = np.asarray(As.indices, np.int64)
    b_ptr = np.asarray(Bs.indptr, np.int64)
    counts = b_ptr[a_ind + 1] - b_ptr[a_ind]      # B-row length per A entry
    total = int(counts.sum())
    if total == 0:
        return None
    if total > max_pairs:
        raise ValueError(
            f"spgemm_csr expansion needs {total} multiply pairs "
            f"(> max_pairs={max_pairs}); the product is too dense for "
            f"the expanded formulation — compute in scipy instead")
    arow = np.repeat(np.arange(nrow, dtype=np.int64),
                     np.diff(np.asarray(As.indptr, np.int64)))
    pa = np.repeat(np.arange(As.nnz, dtype=np.int64), counts)
    cum = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(cum, counts)
    pb = np.repeat(b_ptr[a_ind], counts) + offs
    ci = np.repeat(arow, counts)                  # output row per pair
    ck = np.asarray(Bs.indices, np.int64)[pb]     # output column per pair
    o = np.lexsort((ck, ci))
    ci, ck, pa, pb = ci[o], ck[o], pa[o], pb[o]
    newseg = np.ones(total, bool)
    newseg[1:] = (ci[1:] != ci[:-1]) | (ck[1:] != ck[:-1])
    seg_ptr = np.append(np.flatnonzero(newseg), total)
    out_rows = ci[newseg]
    indptr = np.zeros(nrow + 1, np.int64)
    np.cumsum(np.bincount(out_rows, minlength=nrow), out=indptr[1:])
    return pa, pb, seg_ptr, out_rows, ck[newseg], indptr


def _numeric(adata: torch.Tensor, bdata: torch.Tensor, pa: torch.Tensor,
             pb: torch.Tensor, seg_ptr: torch.Tensor) -> torch.Tensor:
    """The device numeric phase: every pair's product, each output's run
    summed by its one owner (``torch.segment_reduce`` over ``seg_ptr``;
    no atomics)."""
    return torch.segment_reduce(adata[pa] * bdata[pb], "sum",
                                offsets=seg_ptr, axis=0)


def spgemm_csr(A, B, *, dtype=None, max_pairs: int = 200_000_000,
               device=None) -> CSR:
    """``C = A @ B`` for general sparse operands (scipy matrices or port
    formats) as a :class:`~..formats.CSR` on ``device`` (default: the
    first port operand's device, else the card).

    The symbolic phase runs on the host: every pair ``(A[i, k], B[k, j])``
    (the Gustavson expansion), sorted by output ``(i, j)``; the numeric
    phase gathers ``A.data[pa] * B.data[pb]`` on the device and sums each
    output's run.  ``dtype=None`` takes the operands' common value type.
    ``max_pairs`` bounds the expansion (the multiplies and the device
    scratch): a denser product raises ``ValueError``."""
    As, Bs = _to_scipy_csr(A), _to_scipy_csr(B)
    if As.shape[1] != Bs.shape[0]:
        raise ValueError(f"inner dimensions differ: {As.shape} @ {Bs.shape}")
    As.sort_indices()
    Bs.sort_indices()
    device = _device_of(A, B, device=device)
    if dtype is None:
        dtype = torch.from_numpy(
            np.zeros(0, np.result_type(As.data.dtype, Bs.data.dtype))).dtype
    nrow, ncol = As.shape[0], Bs.shape[1]
    sym = _symbolic(As, Bs, max_pairs)
    up = lambda a, t: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=t)
    if sym is None:
        zi = torch.zeros(0, dtype=torch.int32, device=device)
        return CSR(data=torch.zeros(0, dtype=dtype, device=device),
                   indices=zi, indptr=up(np.zeros(nrow + 1), torch.int32),
                   row_ids=zi, shape=(int(nrow), int(ncol)))
    pa, pb, seg_ptr, out_rows, out_cols, indptr = sym
    data = _numeric(up(As.data, dtype), up(Bs.data, dtype),
                    up(pa, torch.int64), up(pb, torch.int64),
                    up(seg_ptr, torch.int64))
    return CSR(data=data, indices=up(out_cols, torch.int32),
               indptr=up(indptr, torch.int32),
               row_ids=up(out_rows, torch.int32),
               shape=(int(nrow), int(ncol)))


def spgemm(A, B):
    """``C = A @ B``: two square DIAs by the diagonal assembly on ``A``'s
    device; any other pair goes to :func:`spgemm_csr`.

    Output diagonals are every in-range sum ``o1 + o2``; each is built
    from zero, the pairs in ``A``'s then ``B``'s diagonal order.  A
    structurally zero product (every sum out of range) is the empty DIA,
    ``offsets=(0,)`` and ``nnz=0``; otherwise ``nnz`` counts the output
    diagonals' in-range slots (structural, as the reference's)."""
    if not (isinstance(A, DIA) and isinstance(B, DIA)):
        return spgemm_csr(A, B)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    if A.shape[0] != A.shape[1] or B.shape[0] != B.shape[1]:
        raise ValueError("DIA spgemm supports square operands "
                         f"(got {A.shape} @ {B.shape})")
    n = A.shape[0]
    sums = tuple(sorted({int(o1) + int(o2) for o1 in A.offsets
                         for o2 in B.offsets if -n < int(o1) + int(o2) < n}))
    dtype = torch.promote_types(A.data.dtype, B.data.dtype)
    dev = A.data.device
    if not sums:
        return DIA(data=torch.zeros((1, n), dtype=dtype, device=dev),
                   offsets=(0,), shape=(n, n), nnz=0)
    pos = {o: k for k, o in enumerate(sums)}
    out = torch.zeros((len(sums), n), dtype=dtype, device=dev)
    db = B.data.to(device=dev, dtype=dtype)
    da = A.data.to(dtype)
    for i1, o1 in enumerate(A.offsets):
        for i2, o2 in enumerate(B.offsets):
            k = pos.get(int(o1) + int(o2))
            if k is not None:
                out[k] += da[i1] * _shift_fill(db[i2], int(o1))
    nnz = int(sum(n - abs(o) for o in sums))
    return DIA(data=out, offsets=sums, shape=(n, n), nnz=nnz)
