"""Distributed BiCGSTAB over a mesh.

Counterpart of ``tpu_spmv/solvers/dist_bicgstab.py``: general
(nonsymmetric) square systems with a row-sharded matrix, where
:func:`~.dist_cg.dist_cg` needs SPD.  The containers, the validation and
the matvec are :func:`~.dist_cg.dist_cg`'s; the recurrence is the serial
:func:`~.krylov.bicgstab`'s on sharded vectors, every dot summed over the
shards in shard order.  Where the reference runs one jitted
``while_loop``, the loop is Python over the shards' tensors and reads one
flag a step on the host (the residual test and the breakdown test
together), as the port's :func:`~.dist_cg.dist_cg` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dist import blas
from ..dist.sharded import ShardedVector
from .dist_cg import _dist_matvec, _zeros
from .krylov import _guard

__all__ = ["DistBiCGSTABResult", "dist_bicgstab"]


class DistBiCGSTABResult(NamedTuple):
    x: ShardedVector
    iterations: int
    residual_norm: torch.Tensor     # 0-d, on shard 0's device
    converged: torch.Tensor         # 0-d bool


def _select(cond: torch.Tensor, a: ShardedVector,
            b: ShardedVector) -> ShardedVector:
    """``a`` where the 0-d ``cond`` holds, else ``b``, shard by shard."""
    return a.map(lambda x, y: torch.where(cond.to(x.device), x, y), b)


def dist_bicgstab(mesh, A, b: ShardedVector, *, tol: float = 1e-8,
                  maxiter: int = 500, precond=None) -> DistBiCGSTABResult:
    """BiCGSTAB (van der Vorst) with a mesh-sharded matrix until ``||r||
    <= tol·||b||`` or ``maxiter``.

    ``precond``: optional ``M(v: ShardedVector) -> ShardedVector`` applied
    on the right (``A M^-1``), e.g. a sharded Jacobi scale or
    :func:`~.dist_multigrid.dist_mg_preconditioner`.  The shadow residual
    is fixed at ``r0``.  Breakdown (``rho``, ``(rhat, v)`` or ``(t, t)`` at
    most the type's ``tiny``) ends the loop with ``converged`` False; an
    exact solve in the middle of a step (``||s|| <= tol·||b||``) is
    success and keeps ``x + alpha·ph``."""
    matvec = _dist_matvec(mesh, A, b, "dist_bicgstab")
    M = precond if precond is not None else (lambda v: v)
    eps = torch.finfo(b.dtype).tiny
    x = _zeros(b)
    r = blas.axpby(1.0, b, -1.0, matvec(x))
    rhat = r                            # fixed shadow residual
    limit = tol * torch.clamp(blas.norm2(b), min=1e-300)
    zero = torch.zeros_like(limit)
    one = torch.ones_like(limit)
    p = v = _zeros(b)
    rho = alpha = omega = one
    it = 0
    go = blas.norm2(r) > limit
    while it < maxiter and bool(go):
        rho_new = blas.dot(rhat, r)
        broke = rho_new.abs() <= eps
        beta = torch.where(broke, zero,
                           rho_new / _guard(broke, rho) * (alpha / omega))
        p = blas.axpby(1.0, r, beta, blas.axpy(-omega, v, p))
        ph = M(p)
        v = matvec(ph)
        denom = blas.dot(rhat, v)
        broke = broke | (denom.abs() <= eps)
        alpha = torch.where(broke, zero, rho_new / _guard(broke, denom))
        s = blas.axpy(-alpha, v, r)
        sh = M(s)
        t = matvec(sh)
        tt = blas.dot(t, t)
        broke_o = tt <= eps
        omega_new = torch.where(broke_o, zero,
                                blas.dot(t, s) / _guard(broke_o, tt))
        x = blas.axpy(omega_new, sh, blas.axpy(alpha, ph, x))
        r = blas.axpy(-omega_new, t, s)
        # an exact solve mid-step (s below the limit) is success, not
        # breakdown: keep x + alpha ph and r = s
        done = blas.norm2(s) <= limit
        x = _select(done, blas.axpy(-omega_new, sh, x), x)
        r = _select(done, s, r)
        rho = rho_new
        omega = torch.where(broke_o, one, omega_new)
        it += 1
        go = (blas.norm2(r) > limit) & ~((broke | broke_o) & ~done)
    rnorm = blas.norm2(r)
    return DistBiCGSTABResult(x=x, iterations=it, residual_norm=rnorm,
                              converged=rnorm <= limit)
