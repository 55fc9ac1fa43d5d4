"""Chebyshev iteration and the Chebyshev polynomial preconditioner.

Counterpart of ``tpu_spmv/solvers/cheby.py``:

- :func:`chebyshev` solves an SPD system whose spectrum lies in
  ``[lmin, lmax]`` with the three-term recurrence (Saad, *Iterative
  Methods*, alg. 12.1): one SpMV and two vector updates a step, no dot
  product but the convergence test (one host read a step);
- :func:`chebyshev_preconditioner` applies a fixed-degree polynomial
  ``p(D^-1 A) D^-1`` on the window ``[lmin_frac lmax, lmax]`` of the
  Jacobi-scaled operator, ``lmax`` estimated once by power iteration: each
  application is ``degree`` SpMVs and no reduction at all.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..formats import CSR, convert
from ..ops.spmv import spmv
from .cg import (_as_matvec, _limit, _norm, _solver_space, power_iteration,
                 safe_dinv)

__all__ = ["ChebyshevResult", "chebyshev", "chebyshev_preconditioner"]


class ChebyshevResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor     # 0-d
    converged: torch.Tensor         # 0-d bool


def chebyshev(A, b: torch.Tensor, *, lmin: float, lmax: float, x0=None,
              tol: float = 1e-8, maxiter: int = 1000) -> ChebyshevResult:
    """Chebyshev iteration for SPD ``A`` with spectrum in ``[lmin, lmax]``
    (a format, a plan, which iterates in its padded space, or a matvec
    closure).

    Loose or wrong bounds slow convergence, and a spectrum that leaks
    outside them can diverge: get ``lmax`` from
    :func:`~.cg.power_iteration` with a safety factor, or both ends from
    :func:`~.lanczos.eigsh_lanczos`."""
    if not (0.0 < lmin < lmax):
        raise ValueError(f"need 0 < lmin < lmax, got [{lmin}, {lmax}]")
    enc, matvec, dec = _solver_space(A)
    b = enc(b)
    x = torch.zeros_like(b) if x0 is None else enc(x0)
    theta = 0.5 * (lmax + lmin)        # interval centre
    delta = 0.5 * (lmax - lmin)        # interval half-width
    r = b - matvec(x)
    limit = _limit(tol, b)
    # first step: x1 = x0 + r0 / theta
    p = r / theta
    x = x + p
    r = r - matvec(p)
    sigma = theta / max(delta, 1e-300)
    rho = 1.0 / sigma
    it = 1
    while it < maxiter and bool(_norm(r) > limit):
        rho_new = 1.0 / (2.0 * sigma - rho)
        p = rho_new * (2.0 * r / delta + rho * p)
        x = x + p
        r = r - matvec(p)
        rho = rho_new
        it += 1
    rnorm = _norm(r)
    return ChebyshevResult(x=dec(x), iterations=it, residual_norm=rnorm,
                           converged=rnorm <= limit)


def chebyshev_preconditioner(A, *, degree: int = 4,
                             lmax: float | None = None,
                             power_iters: int = 20, safety: float = 1.1,
                             lmin_frac: float = 1.0 / 30.0, dinv=None,
                             n: int | None = None,
                             generator: torch.Generator | None = None
                             ) -> Callable:
    """Degree-``degree`` Chebyshev polynomial preconditioner for CG:
    ``z = p(D^-1 A) D^-1 r`` on the window ``[lmin_frac lmax, lmax]`` of
    the Jacobi-scaled operator, an SPD map for SPD ``A`` (a valid
    ``precond=`` of :func:`~.cg.cg`).

    ``lmax`` (of ``D^-1 A``) is estimated once with ``power_iters`` power
    steps (from ``generator``) and multiplied by ``safety``; a
    non-positive or non-finite estimate falls back to ``2 safety``, which
    bounds every SPD matrix with a nonzero diagonal.

    ``A`` may be a matvec closure or a plan whose pack has no CSR view:
    pass ``dinv`` (the inverse diagonal, a tensor) and ``n`` with it."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if dinv is None:
        csr = A if isinstance(A, CSR) else convert(A, "csr")
        dinv = safe_dinv(csr.diagonal())
        n = csr.shape[0]
        matvec = lambda v: spmv(csr, v)
    else:
        if n is None:
            raise ValueError("matvec-closure form needs n=")
        matvec = _as_matvec(A)
    scaled = lambda v: dinv * matvec(v)     # D^-1 A
    if lmax is None:
        lam, _ = power_iteration(scaled, iters=power_iters, n=n,
                                 generator=generator, dtype=dinv.dtype,
                                 device=dinv.device)
        lmax = float(lam) * safety
        if not (lmax > 0.0) or not math.isfinite(lmax):
            lmax = 2.0 * safety
    lmin = lmin_frac * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / max(delta, 1e-300)

    def apply(r):
        # one SpMV a step: one application is `degree` SpMVs and a
        # polynomial of degree `degree`
        rr = dinv * r
        p = rr / theta
        z = p
        rho = 1.0 / sigma
        for _ in range(degree):
            rr = rr - scaled(p)
            rho_new = 1.0 / (2.0 * sigma - rho)
            p = rho_new * (2.0 * rr / delta + rho * p)
            z = z + p
            rho = rho_new
        return z

    return apply
