"""Bandwidth-reducing row/column reordering (RCM).

Counterpart of ``tpu_spmv/reorder.py``.  Reverse Cuthill–McKee gathers the
entries of a matrix whose structure its numbering hides (a mesh, a band in
a random node order) near the diagonal, so the planner can pick a
streaming-DIA kernel instead of a general one.

:func:`rcm_permutation` computes the permutation on the host (scipy);
:func:`reorder_plan` plans the permuted matrix ``A_p = P A P^T`` and
returns a :class:`ReorderedOperator`, which permutes ``x`` and ``y`` on the
device with the gather kernel of :mod:`.kernels.permute` — two n-sized
gathers per product.  For iterative work, permute once and solve in
permuted space through ``ro.plan`` (``x_p = x[ro.perm]``, ``y =
y_p[ro.inv_perm]``, or the same with ``apply_permutation``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .formats import to_coo
from .kernels.permute import (PermutationPlan, apply_permutation,
                              plan_permutation)

__all__ = ["rcm_permutation", "bandwidth", "ReorderedOperator", "reorder_plan"]


def _host_csr(mat):
    if hasattr(mat, "tocsr"):
        return mat.tocsr()
    return to_coo(mat).to_scipy().tocsr()


def bandwidth(mat) -> int:
    """Max ``|col - row|`` over stored entries (host-side)."""
    m = (mat if hasattr(mat, "tocoo") else to_coo(mat).to_scipy()).tocoo()
    if m.nnz == 0:
        return 0
    return int(np.max(np.abs(m.col.astype(np.int64) - m.row.astype(np.int64))))


def rcm_permutation(mat) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of ``A + A^T`` (square matrices)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = _host_csr(mat)
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("RCM reordering requires a square matrix")
    sym = (csr + csr.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))


@dataclasses.dataclass(frozen=True)
class ReorderedOperator:
    """A plan on the RCM-permuted matrix plus the permutation on the
    device: ``y = P^T (A_p (P x))`` with ``A_p = P A P^T``, callable like
    a plan."""

    plan: object                 # SpmvPlan on the permuted matrix
    perm: torch.Tensor           # [n] int64, new order -> old order
    inv_perm: torch.Tensor       # [n] int64, old order -> new order
    bandwidth_before: int
    bandwidth_after: int

    @functools.cached_property
    def perm_plan(self) -> PermutationPlan:
        """``x -> P x`` (``out[i] = x[perm[i]]``)."""
        return plan_permutation(self.perm, device=self.perm.device)

    @functools.cached_property
    def inv_plan(self) -> PermutationPlan:
        """``y_p -> P^T y_p`` (``out[i] = y_p[inv_perm[i]]``)."""
        return plan_permutation(self.inv_perm, device=self.inv_perm.device)

    def __call__(self, x: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor:
        yp = self.plan(apply_permutation(self.perm_plan, x))
        out = apply_permutation(self.inv_plan, yp)
        return out if y is None else y + out

    @property
    def strategy(self) -> str:
        return f"rcm+{self.plan.strategy}"


def reorder_plan(mat, **plan_kwargs) -> ReorderedOperator:
    """RCM-reorder a square matrix (scipy or a port format), then
    :func:`~.ops.auto.plan_spmv` the permuted matrix with ``plan_kwargs``
    (default ``device="cuda"``)."""
    import scipy.sparse as sp

    from .ops.auto import plan_spmv

    csr = _host_csr(mat)
    perm = rcm_permutation(csr)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    # A_p[i, j] = A[perm[i], perm[j]]: entry (r, c) moves to (inv[r],
    # inv[c]) — the reference's csr[perm][:, perm] as one relabelling
    coo = csr.tocoo()
    permuted = sp.csr_matrix((coo.data, (inv[coo.row], inv[coo.col])),
                             shape=csr.shape)
    plan = plan_spmv(permuted, **plan_kwargs)
    device = torch.device(plan_kwargs.get("device", "cuda"))
    return ReorderedOperator(
        plan=plan,
        perm=torch.from_numpy(perm.astype(np.int64)).to(device),
        inv_perm=torch.from_numpy(inv.astype(np.int64)).to(device),
        bandwidth_before=bandwidth(csr),
        bandwidth_after=bandwidth(permuted))
