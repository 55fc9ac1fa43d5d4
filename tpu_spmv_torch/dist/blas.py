"""BLAS-1 on sharded vectors.

Counterpart of ``tpu_spmv/dist/blas.py``.  The chunks are zero-padded, so
elementwise ops and reductions over them are exact.  Elementwise ops run
per local shard on the shard's device (:meth:`~.sharded.ShardedVector.map`:
on a process mesh the other shards' ``meta`` placeholders are left
alone); a reduction takes each
local shard's partial on its device and adds the partials in shard order
(the ``psum`` of the vector's mesh: on shard 0's device on the single
controller, on every rank alike on a process mesh), so it gives the same
bits on every run and every rank.  A scalar argument may be a number or a
0-d tensor on any device.
"""

from __future__ import annotations

import torch

from .mesh import sum_in_order
from .sharded import ShardedVector

__all__ = ["dot", "dot_stack", "psum", "axpby", "axpy", "scale", "norm2",
           "check_aligned"]


def check_aligned(x: ShardedVector, y: ShardedVector) -> None:
    if x.starts != y.starts or x.length != y.length:
        raise ValueError("sharded vectors have mismatched partitions")


def _on(alpha, device):
    return alpha.to(device) if isinstance(alpha, torch.Tensor) else alpha


def psum(partials, mesh=None) -> torch.Tensor:
    """The local shards' partials (one tensor each, any shape) added in
    shard order: over ``mesh`` (its :meth:`~.mesh.Mesh.psum`), or, with no
    mesh, on the first one's device."""
    return sum_in_order(partials) if mesh is None else mesh.psum(partials)


def dot(x: ShardedVector, y: ShardedVector) -> torch.Tensor:
    """``x · y`` (0-d, on shard 0's device; on a process mesh on every
    rank)."""
    check_aligned(x, y)
    return psum([torch.vdot(x.chunks[s].reshape(-1), y.chunks[s].reshape(-1))
                 for s in x.local], x.mesh)


def dot_stack(*pairs) -> torch.Tensor:
    """``[len(pairs)]`` of ``x · y`` for several aligned pairs, reduced
    together: one sum over the shards for the whole batch (the single
    reduction of the communication-avoiding solvers).  Real dtypes."""
    for x, y in pairs:
        check_aligned(x, y)
    x0 = pairs[0][0]
    return psum([torch.stack([(x.chunks[s] * y.chunks[s]).sum()
                              for x, y in pairs]) for s in x0.local], x0.mesh)


def axpby(alpha, x: ShardedVector, beta, y: ShardedVector) -> ShardedVector:
    check_aligned(x, y)
    return x.map(lambda a, b: _on(alpha, a.device) * a
                 + _on(beta, a.device) * b, y)


def axpy(alpha, x: ShardedVector, y: ShardedVector) -> ShardedVector:
    check_aligned(x, y)
    return x.map(lambda a, b: b + _on(alpha, a.device) * a, y)


def scale(x: ShardedVector, alpha) -> ShardedVector:
    return x.map(lambda a: _on(alpha, a.device) * a)


def norm2(x: ShardedVector) -> torch.Tensor:
    return torch.sqrt(dot(x, x))
