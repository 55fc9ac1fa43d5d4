"""Distributed SpMV over a mesh: the general-CSR strategies.

Counterpart of ``tpu_spmv/dist/spmv.py``.  Where the reference runs one
``shard_map`` SPMD program, each function here loops over the mesh's local
shards (every shard on the single controller, the own one on a process
mesh) and runs each shard's work on that shard's device; the exchanges are
the mesh's (:mod:`.mesh`):

- ``lax.all_gather`` becomes :meth:`~.mesh.Mesh.all_gather` and a
  concatenation (:func:`spmv_allgather`);
- ``lax.ppermute`` becomes :meth:`~.mesh.Mesh.shift` (:func:`spmv_halo`
  ships one chunk per ring step to the next shard) and
  :meth:`~.mesh.Mesh.neighbors` (:func:`spmv_neighbor` brings the touched
  neighbour chunks);
- ``lax.psum_scatter`` becomes :meth:`~.mesh.Mesh.reduce_scatter`, a sum
  of the partial y slices in shard order (:func:`spmv_colsplit`).

Each shard's product is a gather and one ``torch.segment_reduce`` per
bucket over the bucket's row pointer (row-owned, deterministic).  The
SpMMs (:func:`spmm_allgather`, :func:`spmm_halo`, :func:`spmm_neighbor`)
run the same strategies on a block of right-hand sides: ``X``'s chunks
are ``[C, nrhs]``, the values ride along the trailing axis of the
exchanges and of the segment sums, and the result's chunks are ``[R,
nrhs]``.  Overlapping the exchanges with compute is later work.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import Mesh
from .sharded import (ColShardedCSR, HaloCSR, NeighborCSR, ShardedCSR,
                      ShardedVector)

__all__ = ["place", "spmv_allgather", "spmv_halo", "spmv_neighbor",
           "spmv_colsplit", "spmm_allgather", "spmm_halo", "spmm_neighbor"]


def _per_shard(value, ndev: int) -> bool:
    return (isinstance(value, tuple) and len(value) == ndev and bool(value)
            and all(isinstance(v, torch.Tensor) or hasattr(v, "to")
                    for v in value))


def place(obj, mesh: Mesh):
    """``obj`` (a sharded container or :class:`~.sharded.ShardedVector`)
    with shard ``s``'s tensors on ``mesh.devices[s]`` (no copy where they
    already are): on a process mesh the other shards' tensors become
    ``meta`` placeholders.  A vector also records the mesh."""
    n = obj.ndev
    if n != mesh.ndev:
        raise ValueError(f"{type(obj).__name__} has {n} shards, the mesh "
                         f"{mesh.ndev}")
    moved = {f.name: tuple(v.to(d) for v, d in zip(getattr(obj, f.name),
                                                   mesh.devices))
             for f in dataclasses.fields(obj)
             if _per_shard(getattr(obj, f.name), n)}
    if isinstance(obj, ShardedVector):
        moved["mesh"] = mesh
    return dataclasses.replace(obj, **moved)


def _segsum(prod: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Row sums of a bucket's products: one segment per row of ``ptr``;
    the bucket's padding past ``ptr[-1]`` is left out."""
    return torch.segment_reduce(prod, "sum", offsets=ptr, axis=0)


def _vector(mesh: Mesh, A, ys) -> ShardedVector:
    """The result vector of ``A`` from the local shards' chunks."""
    return ShardedVector(chunks=mesh.shards(ys), starts=A.row_starts,
                         length=A.shape[0], mesh=mesh)


def _times(data: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Each entry's value times its gathered x value, or (``xg`` ``[nnz,
    nrhs]``, a block of right-hand sides) its gathered row of X."""
    return (data if xg.dim() == 1 else data[:, None]) * xg


def spmv_allgather(mesh: Mesh, A: ShardedCSR,
                   x: ShardedVector) -> ShardedVector:
    """Row-sharded SpMV with x replicated: every shard gathers all chunks
    (the padded ``[ndev * C]`` x), multiplies its row block and keeps its y
    slice — no reduction."""
    loc = mesh.local
    xgs = mesh.all_gather([x.chunks[s] for s in loc])
    return _vector(mesh, A, [
        _segsum(_times(A.data[s], torch.cat(xg)[A.cols[s]]), A.rowptr[s])
        for s, xg in zip(loc, xgs)])


def spmv_halo(mesh: Mesh, A: HaloCSR, x: ShardedVector) -> ShardedVector:
    """Row-sharded SpMV with a ring: at step ``t`` each shard multiplies
    bucket ``t`` with the chunk it holds (shard ``(s - t) mod ndev``'s),
    then ships that chunk to the next shard.  After ``ndev`` steps every
    shard has seen every chunk once."""
    n, loc = A.ndev, mesh.local
    cur = [x.chunks[s] for s in loc]
    ys = [None] * len(loc)
    for t in range(n):
        for i, s in enumerate(loc):
            part = _segsum(_times(A.data[s][t], cur[i][A.cols[s][t]]),
                           A.rowptr[s][t])
            ys[i] = part if ys[i] is None else ys[i] + part
        if t + 1 < n:
            cur = mesh.shift(cur)
    return _vector(mesh, A, ys)


def spmv_neighbor(mesh: Mesh, A: NeighborCSR,
                  x: ShardedVector) -> ShardedVector:
    """Row-sharded SpMV with a neighbour halo: each shard brings only the
    chunks of shards ``s + d`` for the ring deltas ``d`` in ``A.offsets``,
    multiplies its interior bucket against its own chunk and its boundary
    bucket against the window of the received ones."""
    loc = mesh.local
    own = [x.chunks[s] for s in loc]
    wins = mesh.neighbors(own, A.offsets, A.spans) if A.offsets else None
    ys = []
    for i, s in enumerate(loc):
        y = _segsum(_times(A.data_int[s], own[i][A.cols_int[s]]),
                    A.rowptr_int[s])
        if A.offsets:
            xwin = torch.cat(wins[i])
            y = y + _segsum(_times(A.data_bnd[s], xwin[A.cols_bnd[s]]),
                            A.rowptr_bnd[s])
        ys.append(y)
    return _vector(mesh, A, ys)


def spmv_colsplit(mesh: Mesh, A: ColShardedCSR,
                  x: ShardedVector) -> ShardedVector:
    """Column-partitioned SpMV: each shard computes a full-length partial y
    from its column slab and own x chunk; shard ``s`` then receives the sum
    of the partials' rows ``[s*R, (s+1)*R)``, added in shard order (the
    reduce-scatter)."""
    parts = [_segsum(A.data[s] * x.chunks[s][A.cols[s]], A.rowptr[s])
             for s in mesh.local]
    return _vector(mesh, A, mesh.reduce_scatter(parts, A.rows_per_shard))


def _check_rhs(X: ShardedVector) -> None:
    if X.chunks[0].dim() != 2:
        raise ValueError(f"X's chunks must be [C, nrhs], got "
                         f"{tuple(X.chunks[0].shape)}")


def spmm_allgather(mesh: Mesh, A: ShardedCSR,
                   X: ShardedVector) -> ShardedVector:
    """Row-sharded SpMM with X replicated (:func:`spmv_allgather` on a
    block of right-hand sides): ``X``'s chunks are ``[C, nrhs]``, the
    result's ``[R, nrhs]``."""
    _check_rhs(X)
    return spmv_allgather(mesh, A, X)


def spmm_halo(mesh: Mesh, A: HaloCSR, X: ShardedVector) -> ShardedVector:
    """Row-sharded SpMM with the ring (:func:`spmv_halo` on a block of
    right-hand sides: each step ships a ``[C, nrhs]`` chunk)."""
    _check_rhs(X)
    return spmv_halo(mesh, A, X)


def spmm_neighbor(mesh: Mesh, A: NeighborCSR,
                  X: ShardedVector) -> ShardedVector:
    """Row-sharded SpMM with a neighbour halo (:func:`spmv_neighbor` on a
    block of right-hand sides: the touched ``[C, nrhs]`` chunks)."""
    _check_rhs(X)
    return spmv_neighbor(mesh, A, X)
