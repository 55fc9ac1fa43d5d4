"""BLAS-1 on sharded vectors.

Counterpart of ``tpu_spmv/dist/blas.py``.  The chunks are zero-padded, so
elementwise ops and reductions over them are exact.  Elementwise ops run
per shard on the shard's device; a reduction takes each shard's partial on
its device and adds the partials in shard order on shard 0's device (the
``psum``), so it gives the same bits on every run.  A scalar argument may
be a number or a 0-d tensor on any device.
"""

from __future__ import annotations

import torch

from .sharded import ShardedVector

__all__ = ["dot", "dot_stack", "psum", "axpby", "axpy", "scale", "norm2",
           "check_aligned"]


def check_aligned(x: ShardedVector, y: ShardedVector) -> None:
    if x.starts != y.starts or x.length != y.length:
        raise ValueError("sharded vectors have mismatched partitions")


def _on(alpha, device):
    return alpha.to(device) if isinstance(alpha, torch.Tensor) else alpha


def psum(partials) -> torch.Tensor:
    """The shards' partials (one tensor each, any shape) added in shard
    order on the first one's device."""
    dev = partials[0].device
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(dev)
    return total


def _like(x: ShardedVector, chunks) -> ShardedVector:
    return ShardedVector(chunks=tuple(chunks), starts=x.starts,
                         length=x.length)


def dot(x: ShardedVector, y: ShardedVector) -> torch.Tensor:
    """``x · y`` (0-d, on shard 0's device)."""
    check_aligned(x, y)
    return psum([torch.vdot(a.reshape(-1), b.reshape(-1))
                  for a, b in zip(x.chunks, y.chunks)])


def dot_stack(*pairs) -> torch.Tensor:
    """``[len(pairs)]`` of ``x · y`` for several aligned pairs, reduced
    together: one sum over the shards for the whole batch (the single
    reduction of the communication-avoiding solvers).  Real dtypes."""
    for x, y in pairs:
        check_aligned(x, y)
    ndev = pairs[0][0].ndev
    return psum([torch.stack([(x.chunks[s] * y.chunks[s]).sum()
                               for x, y in pairs]) for s in range(ndev)])


def axpby(alpha, x: ShardedVector, beta, y: ShardedVector) -> ShardedVector:
    check_aligned(x, y)
    return _like(x, (_on(alpha, a.device) * a + _on(beta, a.device) * b
                     for a, b in zip(x.chunks, y.chunks)))


def axpy(alpha, x: ShardedVector, y: ShardedVector) -> ShardedVector:
    check_aligned(x, y)
    return _like(x, (b + _on(alpha, a.device) * a
                     for a, b in zip(x.chunks, y.chunks)))


def scale(x: ShardedVector, alpha) -> ShardedVector:
    return _like(x, (_on(alpha, a.device) * a for a in x.chunks))


def norm2(x: ShardedVector) -> torch.Tensor:
    return torch.sqrt(dot(x, x))
