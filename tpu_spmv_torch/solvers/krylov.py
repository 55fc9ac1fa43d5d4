"""Nonsymmetric Krylov solvers: BiCGSTAB and restarted GMRES.

Counterpart of ``tpu_spmv/solvers/krylov.py``.  Both need only the forward
matvec, so they run on every planner strategy (a format, a plan or a
matvec closure).  The loops are Python loops over tensors:

- BiCGSTAB keeps its scalars on the device and reads one flag a step on
  the host (the residual test and the breakdown test together);
- GMRES(m) runs the Arnoldi vectors on the device (classical
  Gram-Schmidt against the filled basis rows: one product with the basis
  and one with its transpose) and reads the new Hessenberg column
  (``j + 2`` values) on the host each step, where the Givens rotations
  and the cycle's triangular solve run in the vectors' type, as the
  reference's do (a float64 recurrence on float32 vectors passes ``tol``
  steps before the float32 residual does).  A cycle stops at convergence
  or breakdown instead of masking the remaining steps, which is the
  reference's step count.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from .cg import _as_matvec, _identity, _limit, _norm

__all__ = ["KrylovResult", "bicgstab", "gmres"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int             # GMRES: total inner steps
    residual_norm: torch.Tensor     # 0-d
    converged: torch.Tensor         # 0-d bool


def _guard(bad: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` where it is a safe divisor, 1 where ``bad``."""
    return torch.where(bad, torch.ones_like(v), v)


def bicgstab(A, b: torch.Tensor, *, x0=None, tol: float = 1e-8,
             maxiter: int = 1000, precond: Callable | None = None
             ) -> KrylovResult:
    """BiCGSTAB (van der Vorst) for general square ``A``.

    ``precond`` (optional) applies ``M^-1``.  Breakdown (``rho -> 0`` or
    ``omega -> 0``) ends the loop with ``converged`` False instead of
    NaN-ing the state; an exact solve in the middle of a step (``s``
    already below the limit) is success."""
    matvec = _as_matvec(A)
    M = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    eps = torch.finfo(b.dtype).tiny
    r = b - matvec(x)
    rhat = r                            # fixed shadow residual
    limit = _limit(tol, b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones_like(zero)
    p = v = torch.zeros_like(r)
    rho = alpha = omega = one
    it = 0
    go = _norm(r) > limit
    while it < maxiter and bool(go):
        rho_new = torch.dot(rhat, r)
        broke = rho_new.abs() <= eps
        beta = torch.where(broke, zero,
                           rho_new / _guard(broke, rho) * (alpha / omega))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = matvec(ph)
        denom = torch.dot(rhat, v)
        broke = broke | (denom.abs() <= eps)
        alpha = torch.where(broke, zero, rho_new / _guard(broke, denom))
        s = r - alpha * v
        sh = M(s)
        t = matvec(sh)
        tt = torch.dot(t, t)
        broke_o = tt <= eps
        omega_new = torch.where(broke_o, zero,
                                torch.dot(t, s) / _guard(broke_o, tt))
        x = x + alpha * ph + omega_new * sh
        r = s - omega_new * t
        done = _norm(s) <= limit
        x = torch.where(done, x - omega_new * sh, x)
        r = torch.where(done, s, r)
        rho = rho_new
        omega = torch.where(broke_o, one, omega_new)
        it += 1
        go = (_norm(r) > limit) & ~((broke | broke_o) & ~done)
    rnorm = _norm(r)
    return KrylovResult(x=x, iterations=it, residual_norm=rnorm,
                        converged=rnorm <= limit)


def _restarted_gmres(residual, start, arnoldi, update, x, limit_t, *,
                     m: int, maxiter: int, eps: float):
    """The host half of restarted GMRES(m), shared by :func:`gmres` and
    :func:`~.dist_gmres.dist_gmres`, which supply the vector operations:

    - ``residual(x) -> (r, ||r||)``;
    - ``start(r, ||r||) -> V``, a basis whose first vector is ``r / ||r||``;
    - ``arnoldi(V, j) -> col``: one step against the filled basis
      ``V[:j + 1]``, which stores the next basis vector (zero where its
      norm is at most ``eps``) and returns the new Hessenberg column on the
      host, ``j + 2`` values whose last is that norm;
    - ``update(x, V, y) -> x + M(V[:m]^T y)``.

    Each cycle rotates its columns with Givens on the host in the vectors'
    type, stops at convergence or breakdown, and updates ``x`` through the
    triangular solve of the rotated Hessenberg; cycles repeat while the
    true residual (the next cycle's start) stays above the limit and
    falls.  Returns ``x``, the inner steps and the true ``||r||``."""
    # the host recurrence's type: the vectors' (numpy scalars of it keep
    # every rotation in it)
    ht = np.float32 if limit_t.dtype == torch.float32 else np.float64
    limit = ht(limit_t.item())
    r, beta_t = residual(x)
    beta = ht(beta_t.item())
    prev = ht(math.inf)
    it = 0
    while beta > limit and it < maxiter and beta < prev:
        V = start(r, beta_t)
        H = np.zeros((m + 1, m), ht)
        cs, sn = np.ones(m, ht), np.zeros(m, ht)
        g = np.zeros(m + 1, ht)
        g[0] = beta
        for j in range(m):
            col = arnoldi(V, j).astype(ht)
            hnext = col[-1]
            h = np.zeros(m + 1, ht)
            h[:j + 2] = col
            for i in range(j):          # the accumulated rotations
                h[i], h[i + 1] = (cs[i] * h[i] + sn[i] * h[i + 1],
                                  -sn[i] * h[i] + cs[i] * h[i + 1])
            denom = np.sqrt(h[j] * h[j] + hnext * hnext)
            c, s = ((h[j] / denom, hnext / denom) if denom > eps
                    else (ht(1), ht(0)))
            h[j], h[j + 1] = c * h[j] + s * hnext, 0
            g[j], g[j + 1] = c * g[j], -s * g[j]
            H[:, j], cs[j], sn[j] = h, c, s
            it += 1
            if not (abs(g[j + 1]) > limit and hnext > eps):
                break
        # R y = g on the top m x m block; columns never filled get a unit
        # diagonal and a zero right-hand side, so their y is exactly zero
        filled = np.abs(np.diagonal(H[:m])) > eps
        R = H[:m] + np.diag(~filled).astype(ht)
        y = scipy.linalg.solve_triangular(R, g[:m] * filled, lower=False)
        x = update(x, V, y)
        prev = beta
        r, beta_t = residual(x)
        beta = ht(beta_t.item())
    return x, it, beta_t


def gmres(A, b: torch.Tensor, *, x0=None, tol: float = 1e-8,
          restart: int = 30, maxiter: int = 1000,
          precond: Callable | None = None) -> KrylovResult:
    """Restarted GMRES(m) for general square ``A``.

    Right-preconditioned (``A M^-1 u = b``, ``x = M^-1 u``), so the
    residual the Givens recurrence tracks is the true one.  Each cycle
    runs up to ``restart`` Arnoldi steps, stopping early once the tracked
    residual passes ``tol`` or the basis breaks down, then updates ``x``
    through the triangular solve of the rotated Hessenberg; cycles repeat
    while the true residual (the next cycle's start, so no extra product)
    stays above ``tol`` and falls.  The reference tests the Givens estimate
    there, which in float32 can pass ``tol`` a few steps before the true
    residual does and end the solve unconverged.  ``residual_norm`` is the
    true residual of the returned ``x``."""
    matvec = _as_matvec(A)
    M = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    m = int(restart)
    eps = torch.finfo(b.dtype).tiny
    limit_t = _limit(tol, b)

    def residual(x):
        r = b - matvec(x)
        return r, _norm(r)

    def start(r, beta_t):
        V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
        V[0] = r / torch.clamp(beta_t, min=eps)
        return V

    def arnoldi(V, j):
        # classical Gram-Schmidt: one product with the basis, one with
        # its transpose
        w = matvec(M(V[j]))
        h_t = torch.mv(V[:j + 1], w)
        w = w - torch.mv(V[:j + 1].T, h_t)
        hn_t = _norm(w)
        col = torch.cat([h_t, hn_t[None]]).cpu().numpy()
        V[j + 1] = w / hn_t if col[-1] > eps else torch.zeros_like(w)
        return col

    def update(x, V, y):
        return x + M(torch.mv(V[:m].T, torch.from_numpy(y).to(V)))

    x, it, beta_t = _restarted_gmres(residual, start, arnoldi, update, x,
                                     limit_t, m=m, maxiter=maxiter, eps=eps)
    return KrylovResult(x=x, iterations=it, residual_norm=beta_t,
                        converged=beta_t <= limit_t)
