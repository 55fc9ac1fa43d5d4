"""Distributed restarted GMRES over a mesh.

Counterpart of ``tpu_spmv/solvers/dist_gmres.py``: general nonsymmetric
square systems with a row-sharded matrix (:func:`~.dist_cg.dist_cg`'s
containers and matvec), right-preconditioned (``A M^-1 u = b``), so the
Givens recurrence tracks the true residual.

The Krylov basis is one ``[m + 1, C]`` tensor per local shard (row ``j``
is the shard's chunk of the ``j``-th basis vector).  Each Arnoldi step runs
one-shot classical Gram-Schmidt against the filled basis rows: every shard
takes its ``[j + 1]`` dots with one product against its basis block, and
the shards' dots add in shard order in one reduction (the reference's
single all-reduce); then each shard subtracts with one product against the
transpose, and one more reduction gives the new vector's norm.  The new
Hessenberg column (``j + 2`` values) goes to the host once a step.

The host half (the Givens rotations, the triangular solve and the restart
test) is the serial :func:`~.krylov.gmres`'s own,
``krylov._restarted_gmres``, so it carries that function's repair, a
deliberate difference from the reference:

- the Givens rotations and the cycle's triangular solve run on the host in
  the vectors' type;
- a cycle stops at convergence or breakdown instead of masking its
  remaining steps, and cycles repeat while the true residual (the next
  cycle's start) stays above ``tol`` and falls.  The reference tests its
  Givens estimate there, which in float32 can pass ``tol`` steps before
  the true residual does and end the solve unconverged;
- ``residual_norm`` is the true residual of the returned ``x``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dist import blas
from ..dist.sharded import ShardedVector
from .dist_cg import _dist_matvec, _zeros
from .krylov import _restarted_gmres

__all__ = ["DistGMRESResult", "dist_gmres"]


class DistGMRESResult(NamedTuple):
    x: ShardedVector
    iterations: int                 # total inner (Arnoldi) steps
    residual_norm: torch.Tensor     # 0-d, on shard 0's device
    converged: torch.Tensor         # 0-d bool


def dist_gmres(mesh, A, b: ShardedVector, *, tol: float = 1e-8,
               restart: int = 30, maxiter: int = 1000,
               precond=None) -> DistGMRESResult:
    """Restarted GMRES(m) with a mesh-sharded matrix until the true
    residual ``||b - A x|| <= tol·||b||`` or ``maxiter`` inner steps.

    ``precond``: optional ``M(v: ShardedVector) -> ShardedVector`` applied
    on the right, e.g. a sharded Jacobi scale."""
    matvec = _dist_matvec(mesh, A, b, "dist_gmres")
    M = precond if precond is not None else (lambda v: v)
    m = int(restart)
    eps = torch.finfo(b.dtype).tiny
    limit_t = tol * torch.clamp(blas.norm2(b), min=1e-300)

    loc = mesh.local

    def sv(chunks) -> ShardedVector:
        """A vector from the local shards' chunks."""
        return b.with_chunks(mesh.shards(list(chunks)))

    def residual(x):
        r = blas.axpby(1.0, b, -1.0, matvec(x))
        return r, blas.norm2(r)

    def start(r, beta_t):
        V = [b.chunks[s].new_zeros((m + 1,) + b.chunks[s].shape) for s in loc]
        for Vs, s in zip(V, loc):
            rs = r.chunks[s]
            Vs[0] = rs / torch.clamp(beta_t.to(rs.device), min=eps)
        return V

    def arnoldi(V, j):
        w = matvec(M(sv(Vs[j] for Vs in V)))
        ws = [w.chunks[s] for s in loc]
        # one-shot CGS: the shards' [j + 1] dots in one reduction
        h_t = blas.psum([torch.mv(Vs[:j + 1], c) for Vs, c in zip(V, ws)],
                        mesh)
        w = sv(c - torch.mv(Vs[:j + 1].T, h_t.to(c.device))
               for Vs, c in zip(V, ws))
        hn_t = blas.norm2(w)
        col = torch.cat([h_t, hn_t[None]]).cpu().numpy()
        for Vs, s in zip(V, loc):
            c = w.chunks[s]
            Vs[j + 1] = (c / hn_t.to(c.device) if col[-1] > eps
                         else torch.zeros_like(c))
        return col

    def update(x, V, y):
        upd = M(sv(torch.mv(Vs[:m].T, torch.from_numpy(y).to(Vs))
                   for Vs in V))
        return blas.axpy(1.0, upd, x)

    x, it, beta_t = _restarted_gmres(residual, start, arnoldi, update,
                                     _zeros(b), limit_t, m=m,
                                     maxiter=maxiter, eps=eps)
    return DistGMRESResult(x=x, iterations=it, residual_norm=beta_t,
                           converged=beta_t <= limit_t)
