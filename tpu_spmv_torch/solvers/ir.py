"""Mixed-precision iterative refinement: bf16-data inner solves, f32 truth.

Counterpart of ``tpu_spmv/solvers/ir.py``.  The bf16-data kernels (K1's
bf16 form, K2 on a bf16 pattern) move fewer matrix bytes, but a CG on the
bf16 operator alone stalls at the bf16 rounding of its coefficients.
Classical iterative refinement (Wilkinson; Carson & Higham 2018) recovers
the hi-precision accuracy while the inner work runs on the low operator::

    x = 0
    repeat:  r = b - A_hi x        # one hi-precision SpMV a cycle
             d ~ solve(A_lo, r)    # k CG steps on the low operator
             x = x + d

The inner CG is :func:`~.cg.cg_runner`'s fixed-k loop from zero (no host
synchronisation; guarded denominators make steps past convergence
no-ops); the outer loop reads the true residual's norm once a cycle.
When the hi and lo plans pad alike (the same matrix on the same
streaming strategy), the whole refinement runs in their padded space.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .cg import (_as_matvec, _identity, _limit, _nonzero, _norm, _size,
                 _solver_space)

__all__ = ["IRResult", "ir_solve", "ir_runner"]


class IRResult(NamedTuple):
    x: torch.Tensor
    outer_iterations: int           # refinement cycles run
    residual_norm: torch.Tensor     # the TRUE (hi-precision) residual
    converged: torch.Tensor         # 0-d bool


def _paired_spaces(A_hi, A_lo):
    """``(encode, decode, hi matvec, lo matvec)``: in the plans' shared
    padded space when they pad alike (the same strategy and, for the
    streaming packs, the same offsets, tile and front pad, so the same
    row map), else in the plain vector space."""
    st = getattr(A_hi, "strategy", None)
    same = (st is not None and st == getattr(A_lo, "strategy", None)
            and hasattr(A_hi, "solver_space"))
    if same and st in ("dia_stream", "pdia_stream"):
        M_hi, M_lo = A_hi.matrix, A_lo.matrix
        same = (M_hi.L == M_lo.L and M_hi.rb == M_lo.rb
                and M_hi.npad == M_lo.npad
                and tuple(M_hi.offsets) == tuple(M_lo.offsets))
    if same:
        enc, mv_hi, dec = _solver_space(A_hi)
        _, mv_lo, _ = _solver_space(A_lo)
        return enc, dec, mv_hi, mv_lo
    return _identity, _identity, _as_matvec(A_hi), _as_matvec(A_lo)


def ir_runner(A, *, low=None, inner_iters: int = 16, maxiter: int = 40,
              tol: float = 1e-7, precond: Callable | None = None,
              n: int | None = None) -> Callable:
    """A reusable mixed-precision refinement solve ``run(b, x0=None) ->
    IRResult``.

    ``A`` is the hi-precision operator (a format, a plan or a matvec
    closure, which needs ``n=``): it defines the residual and so the
    accuracy ``x`` reaches.  ``low`` is the operator the inner CG iterates
    on (typically ``plan_spmv(mat, dtype=torch.bfloat16)``; default ``A``,
    which is restarted CG).  Each cycle runs ``inner_iters`` CG steps; up
    to ``maxiter`` cycles run until ``||b - A x|| <= tol ||b||``, and the
    solve stops early after three cycles in a row that do not cut the
    residual below 0.9 of the cycle before (the rounding floor).
    ``precond`` preconditions the inner CG, in the plain vector space.
    ``A`` must be SPD."""
    if inner_iters < 1 or maxiter < 1:
        raise ValueError("inner_iters and maxiter must be >= 1, got "
                         f"{inner_iters}, {maxiter}")
    if low is None:
        low = A
    _size(A, n, "ir_runner")
    if precond is None:
        enc, dec, mv_hi, mv_lo = _paired_spaces(A, low)
        M = _identity
    else:
        enc = dec = _identity
        mv_hi, mv_lo = _as_matvec(A), _as_matvec(low)
        M = precond

    def inner_cg(r):
        # fixed-k CG on the low operator from d = 0; the vectors stay in
        # r's type, only the matrix data is narrower
        z = M(r)
        rz = torch.dot(r, z)
        d = torch.zeros_like(r)
        p = z
        for _ in range(inner_iters):
            Ap = mv_lo(p)
            alpha = rz / _nonzero(torch.dot(p, Ap))
            d = d + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / _nonzero(rz)) * p
            rz = rz_new
        return d

    def run(b, x0=None) -> IRResult:
        b = enc(b)
        x = torch.zeros_like(b) if x0 is None else enc(x0)
        limit = _limit(tol, b)
        lim = float(limit)
        r = b - mv_hi(x)
        it, prev, bad = 0, math.inf, 0
        while True:
            rn = float(_norm(r))
            if not (rn > lim and it < maxiter and bad < 3):
                break
            # a cycle that does not cut the residual below 0.9 of the one
            # before counts towards the stagnation exit; CG's 2-norm
            # residual is not monotone, hence three in a row
            bad = 0 if rn < 0.9 * prev else bad + 1
            prev = rn
            x = x + inner_cg(r)
            r = b - mv_hi(x)
            it += 1
        rnorm = _norm(r)
        return IRResult(x=dec(x), outer_iterations=it, residual_norm=rnorm,
                        converged=rnorm <= limit)

    return run


def ir_solve(A, b: torch.Tensor, *, low=None, inner_iters: int = 16,
             maxiter: int = 40, tol: float = 1e-7, x0=None,
             precond: Callable | None = None) -> IRResult:
    """One mixed-precision refinement solve (see :func:`ir_runner`)."""
    run = ir_runner(A, low=low, inner_iters=inner_iters, maxiter=maxiter,
                    tol=tol, precond=precond, n=b.shape[0])
    return run(b, x0)
