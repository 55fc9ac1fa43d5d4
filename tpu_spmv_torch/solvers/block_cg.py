"""Multi-RHS conjugate gradients: k solves per SpMM.

Counterpart of ``tpu_spmv/solvers/block_cg.py``.  :func:`cg_multi` runs k
independent CG recurrences in lockstep — one ``alpha``/``beta`` per column
of ``B [n, k]``, coupled only through the shared SpMM, so each column
follows the single-RHS CG.  On a plan of bf16 coefficients ``B`` is
float32, as for the plan's SpMV.  Columns that converge first are frozen (their
``alpha``/``beta`` forced to zero and their search direction kept) so that
trailing iterations cannot un-converge them.  Loops are Python loops over
tensors; the SpMM is the plan's kernel (``SpmvPlan.spmm``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.spmm import spmm
from .cg import _identity, _nonzero

__all__ = ["CGMultiResult", "cg_multi", "cg_multi_runner"]


class CGMultiResult(NamedTuple):
    x: torch.Tensor                 # [n, k]
    iterations: int                 # iterations of the shared loop
    residual_norm: torch.Tensor     # [k]
    converged: torch.Tensor         # [k] bool


def _as_matmat(A) -> Callable:
    if hasattr(A, "spmm"):                    # SpmvPlan (callable, but its
        return A.spmm                         # __call__ is the SpMV path)
    if callable(A) and not hasattr(A, "shape"):
        return A
    return lambda X: spmm(A, X)


def _columnwise(precond: Callable | None) -> Callable:
    """``precond`` (on ``[n]`` vectors) applied to each column of an
    ``[n, k]`` block."""
    if precond is None:
        return _identity
    return lambda R: torch.stack([precond(R[:, q]) for q in range(R.shape[1])],
                                 dim=1)


def _colnorm(V: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((V * V).sum(dim=0))


def _step(matmat, M, X, R, P, rz, active):
    """One lockstep CG iteration; ``active=None`` means every column."""
    AP = matmat(P)
    alpha = rz / _nonzero((P * AP).sum(dim=0))
    if active is not None:
        alpha = torch.where(active, alpha, 0.0)
    X = X + alpha * P
    R = R - alpha * AP
    Z = M(R)
    rz_new = (R * Z).sum(dim=0)
    beta = rz_new / _nonzero(rz)
    if active is None:
        return X, R, Z + beta * P, rz_new
    beta = torch.where(active, beta, 0.0)
    return X, R, torch.where(active, Z + beta * P, P), rz_new


def cg_multi_runner(A, *, iters: int, tol: float | None = None,
                    precond: Callable | None = None,
                    report_tol: float = 1e-8) -> Callable:
    """A reusable multi-RHS CG solve ``run(B, X0=None) -> CGMultiResult``.

    ``A`` is a port format, an :class:`~tpu_spmv_torch.ops.auto.SpmvPlan`
    (its strategy's SpMM kernel is used) or a matmat closure ``[n, k] ->
    [n, k]``.  ``precond`` acts on ``[n]`` vectors (the closures
    :func:`~tpu_spmv_torch.solvers.cg.cg` takes) and is applied column by
    column.

    ``tol=None``: exactly ``iters`` iterations with no host
    synchronisation; ``converged`` reads ``rnorm <= report_tol·||b||`` per
    column at the end.  With ``tol``: the loop reads on the host, once per
    iteration, whether any column is still above ``tol·||b||`` and exits
    when none is (or at ``iters``); converged columns are frozen."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    matmat = _as_matmat(A)
    M = _columnwise(precond)

    def run(B, X0=None) -> CGMultiResult:
        if B.dim() != 2:
            raise ValueError(f"B must be [n, k], got shape {tuple(B.shape)}")
        B = B.contiguous()
        X = torch.zeros_like(B) if X0 is None else X0.contiguous()
        R = B - matmat(X)
        P = M(R)
        rz = (R * P).sum(dim=0)
        bnorm = _colnorm(B)
        if tol is None:
            for _ in range(iters):
                X, R, P, rz = _step(matmat, M, X, R, P, rz, None)
            rnorm = _colnorm(R)
            return CGMultiResult(
                x=X, iterations=iters, residual_norm=rnorm,
                converged=rnorm <= report_tol * torch.clamp(bnorm,
                                                            min=1e-300))
        limit = tol * torch.clamp(bnorm, min=1e-300)
        it = 0
        while it < iters:
            active = _colnorm(R) > limit
            if not bool(active.any()):
                break
            X, R, P, rz = _step(matmat, M, X, R, P, rz, active)
            it += 1
        rnorm = _colnorm(R)
        return CGMultiResult(x=X, iterations=it, residual_norm=rnorm,
                             converged=rnorm <= limit)

    return run


def cg_multi(A, B, *, x0=None, tol: float | None = 1e-8,
             maxiter: int = 1000,
             precond: Callable | None = None) -> CGMultiResult:
    """One-shot multi-RHS CG (k independent solves per SpMM)."""
    return cg_multi_runner(A, iters=maxiter, tol=tol, precond=precond)(B, x0)
