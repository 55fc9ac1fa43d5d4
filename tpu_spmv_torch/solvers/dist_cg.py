"""Distributed conjugate gradients over a mesh.

Counterpart of ``tpu_spmv/solvers/dist_cg.py``: the matrix is a row-sharded
:class:`~..dist.sharded.ShardedCSR`, ``HaloCSR`` or ``NeighborCSR`` whose
row partition equals its column partition (square, built with
``square=True``), vectors are :class:`~..dist.sharded.ShardedVector`, and
every dot product sums over the shards in shard order.  Where the reference
runs one jitted ``while_loop``, the port's loop is Python over the shards'
tensors and reads the residual on the host once per iteration, as the
port's :func:`~.cg.cg` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dist import blas
from ..dist.sharded import HaloCSR, NeighborCSR, ShardedCSR, ShardedVector
from ..dist.spmv import spmv_allgather, spmv_halo, spmv_neighbor

__all__ = ["DistCGResult", "dist_cg", "dist_cg_ca"]


class DistCGResult(NamedTuple):
    x: ShardedVector
    iterations: int
    residual_norm: torch.Tensor     # 0-d, on shard 0's device
    converged: torch.Tensor         # 0-d bool


def _dist_matvec(mesh, A, b: ShardedVector, name: str):
    """Validation and matvec of the distributed Krylov solvers: square
    operator, b on the row plan, row partition == column partition."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"{name} requires a square matrix")
    if A.row_starts != b.starts:
        raise ValueError(
            "b must be partitioned by the matrix row plan "
            "(build with ShardedVector.from_global(b, A.row_plan))")
    if A.col_starts != A.row_starts:
        raise ValueError(f"{name} needs row partition == column partition; "
                         f"build the sharded matrix with square=True")
    for cls, fn in ((NeighborCSR, spmv_neighbor), (HaloCSR, spmv_halo),
                    (ShardedCSR, spmv_allgather)):
        if isinstance(A, cls):
            return lambda v: fn(mesh, A, v)
    raise TypeError(f"unsupported sharded matrix {type(A).__name__}")


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v == 0, torch.ones_like(v), v)


def _zeros(b: ShardedVector) -> ShardedVector:
    return blas.scale(b, 0.0)


def dist_cg(mesh, A, b: ShardedVector, *, tol: float = 1e-8,
            maxiter: int = 500) -> DistCGResult:
    """CG with a mesh-sharded matrix until ``||r|| <= tol·||b||`` or
    ``maxiter``.  The reference's ``precond=`` waits for its one caller,
    ``dist_multigrid``."""
    matvec = _dist_matvec(mesh, A, b, "dist_cg")
    x = _zeros(b)
    r = blas.axpby(1.0, b, -1.0, matvec(x))
    p = r
    rr = blas.dot(r, r)
    limit = tol * torch.clamp(blas.norm2(b), min=1e-300)
    it = 0
    while it < maxiter and bool(torch.sqrt(rr) > limit):
        Ap = matvec(p)
        alpha = rr / _nonzero(blas.dot(p, Ap))
        x = blas.axpy(alpha, p, x)
        r = blas.axpy(-alpha, Ap, r)
        rr_new = blas.dot(r, r)
        p = blas.axpby(1.0, r, rr_new / _nonzero(rr), p)
        rr = rr_new
        it += 1
    rnorm = torch.sqrt(rr)
    return DistCGResult(x=x, iterations=it, residual_norm=rnorm,
                        converged=rnorm <= limit)


def dist_cg_ca(mesh, A, b: ShardedVector, *, tol: float = 1e-8,
               maxiter: int = 500) -> DistCGResult:
    """Communication-avoiding (single-reduction) distributed CG: the
    Chronopoulos–Gear recurrence, whose dots ``gamma = (r, r)`` and
    ``delta = (w, r)`` (``w = A r``) are available together and reduce in
    one :func:`~..dist.blas.dot_stack` per iteration.  ``alpha = gamma /
    (delta - beta·gamma/alpha_prev)``; in exact arithmetic the iterates are
    CG's.  Same contract as :func:`dist_cg`."""
    matvec = _dist_matvec(mesh, A, b, "dist_cg_ca")
    x, r = _zeros(b), b                  # x0 = 0, so r0 = b
    w = matvec(r)
    gamma, delta, bb = blas.dot_stack((r, r), (w, r), (b, b))
    limit = tol * torch.clamp(torch.sqrt(bb), min=1e-300)
    alpha = gamma / _nonzero(delta)
    beta = torch.zeros_like(gamma)
    p = s = _zeros(b)
    it = 0
    while it < maxiter and bool(torch.sqrt(gamma) > limit):
        p = blas.axpby(1.0, r, beta, p)
        s = blas.axpby(1.0, w, beta, s)
        x = blas.axpy(alpha, p, x)
        r = blas.axpy(-alpha, s, r)
        w = matvec(r)
        gamma_new, delta = blas.dot_stack((r, r), (w, r))
        beta = gamma_new / _nonzero(gamma)
        alpha = gamma_new / _nonzero(delta - beta * gamma_new
                                     / _nonzero(alpha))
        gamma = gamma_new
        it += 1
    rnorm = torch.sqrt(gamma)
    return DistCGResult(x=x, iterations=it, residual_norm=rnorm,
                        converged=rnorm <= limit)
