"""LSQR: least-squares and rectangular solves by Golub-Kahan
bidiagonalization (Paige & Saunders 1982).

Counterpart of ``tpu_spmv/solvers/lsqr.py``.  It needs ``A^T v`` as well
as ``A v``: a plan's :meth:`~..ops.auto.SpmvPlan.transpose` (the streaming
packs transpose on the device and run the same kernels), the format's
:func:`~..ops.transpose.transpose`, or an ``At=`` closure.  The scalars stay
on the device; the loop reads one flag a step on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cg import _as_matvec, _norm

__all__ = ["LSQRResult", "lsqr"]


class LSQRResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor     # ||b - A x||
    atr_norm: torch.Tensor          # ||A^T (b - A x)|| (least-squares optimality)
    converged: torch.Tensor


def lsqr(A, b: torch.Tensor, *, At=None, x0=None, tol: float = 1e-8,
         maxiter: int = 1000) -> LSQRResult:
    """Solve ``min_x ||A x - b||_2`` (square, over- or underdetermined).

    ``A`` is a format, a plan or a matvec closure; ``At`` (the transpose
    operator) defaults to ``A.transpose()`` for plans and
    :func:`~..ops.transpose.transpose` for formats; a matvec closure needs
    it passed.

    Stops when ``||r|| <= tol ||b||`` (consistent systems) or ``||A^T r||
    <= tol ||A|| ||r||`` (least-squares optimality), or on breakdown;
    ``converged`` holds either test, ten times looser, on the true
    residual of the returned ``x``."""
    matvec = _as_matvec(A)
    if At is None:
        if hasattr(A, "transpose"):
            At = A.transpose()
        elif hasattr(A, "shape"):
            from ..ops.transpose import transpose

            At = transpose(A)
        else:
            raise ValueError("matvec-closure A needs an explicit At=")
    rmatvec = _as_matvec(At)
    eps = torch.finfo(b.dtype).tiny

    def unit(v):
        nrm = _norm(v)
        return v / torch.clamp(nrm, min=eps), nrm

    u, beta = unit(b if x0 is None else b - matvec(x0))
    v, alpha = unit(rmatvec(u))
    x = torch.zeros_like(v) if x0 is None else x0
    bnorm = _norm(b)
    w, rhobar, phibar, anorm2 = v, alpha, beta, alpha * alpha
    done = beta <= tol * bnorm
    it = 0
    while it < maxiter and not bool(done):
        u, beta = unit(matvec(v) - alpha * u)
        v_new, alpha_new = unit(rmatvec(u) - beta * v)
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        rho_safe = torch.clamp(rho, min=eps)
        c, s = rhobar / rho_safe, beta / rho_safe
        theta = s * alpha_new
        rhobar = -c * alpha_new
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / rho_safe) * w
        w = v_new - (theta / rho_safe) * w
        anorm2 = anorm2 + alpha * alpha + beta * beta
        # ||A^T r|| = phibar * |rhobar| after the rotation
        arnorm = phibar * rhobar.abs()
        done = ((phibar <= tol * torch.clamp(bnorm, min=eps))
                | (arnorm <= tol * torch.sqrt(anorm2)
                   * torch.clamp(phibar, min=eps))
                | (beta <= eps) | (alpha_new <= eps))
        v, alpha = v_new, alpha_new
        it += 1
    r = b - matvec(x)
    rnorm = _norm(r)
    atr = _norm(rmatvec(r))
    ok = ((rnorm <= 10 * tol * torch.clamp(bnorm, min=eps))
          | (atr <= 10 * tol * torch.sqrt(anorm2)
             * torch.clamp(rnorm, min=eps)))
    return LSQRResult(x=x, iterations=it, residual_norm=rnorm,
                      atr_norm=atr, converged=ok)
