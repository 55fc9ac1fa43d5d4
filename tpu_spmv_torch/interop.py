"""Carry operators packed by the JAX reference package into the port.

In this system the "weights" are the packed operators.  The port keeps the
reference's dataclass fields for COO, CSR, CSC, DIA, SDIA and PSDIA, so an
operator carries over field by field: array leaves through numpy, static
fields as they are.  A reference ``PackedELL`` carries over through the
logical matrix its tiles hold (the arithmetic of ``PackedELL.to_coo``),
repacked as the port's sliced ELL.  A reference ``GPCSR`` or
``GPCSRChunked`` holds only routed values, so it does not carry over:
re-plan from the host matrix.

A reference ``PermutationPlan`` or ``TwoLevelPlan`` (Clos routing planes)
carries over as the permutation it routes: the planes are applied on the
host to an int64 ``arange`` (:func:`compose_permutation`), and the port's
plan is that index vector.  :func:`tile_plan_from_planes` does the same for
the ``(g1, g2, g3)`` planes of a tile permutation.  A reference
``ReorderedOperator`` carries over with its plan and its permutation.

The distributed containers (``ShardedVector``, ``ShardedDIA``,
``ShardedSDIA``, ``ShardedPSDIA``, ``ShardedCSR``, ``HaloCSR``,
``NeighborCSR``, ``ColShardedCSR``) and a ``DistPlan`` over them carry over
onto a port mesh: each stacked ``[ndev, ...]`` leaf becomes one tensor per
shard on that shard's device, and the port's bucket row pointers are
derived from the rows.  A ``ShardedGPR`` is refused as a ``GPCSR`` is.
It works by duck typing and imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dist import (ColShardedCSR, DistPlan, HaloCSR, NeighborCSR, RowPlan,
                   ShardedCSR, ShardedDIA, ShardedPSDIA, ShardedSDIA,
                   ShardedVector, place)
from .dist.sharded import rowptrs
from .formats import COO, CSC, CSR, DIA
from .formats.base import INDEX_DTYPE, torch_dtype
from .kernels.dia_stream import PSDIA, SDIA
from .kernels.ell_packed import pack_ell
from .kernels.gpr import LANES
from .kernels.permute import Q, TILE, PermutationPlan, plan_permutation
from .ops.auto import PatternStats, plan_from_matrix
from .reorder import ReorderedOperator

__all__ = ["from_reference", "compose_permutation", "tile_plan_from_planes"]

_TYPES = {cls.__name__: cls for cls in (COO, CSR, CSC, DIA, SDIA, PSDIA)}
_DIST = {cls.__name__: cls for cls in (
    ShardedVector, ShardedDIA, ShardedSDIA, ShardedPSDIA, ShardedCSR,
    HaloCSR, NeighborCSR, ColShardedCSR)}
#: the port's row-pointer fields and the (rows, data) buckets they index
_ROWPTR = {"rowptr": ("rows", "data"), "rowptr_int": ("rows_int", "data_int"),
           "rowptr_bnd": ("rows_bnd", "data_bnd")}
#: reference strategies the port can run
_STRATEGIES = ("pdia_stream", "dia_stream", "dia", "csr", "pallas_ell",
               "gpr")


def _leaf(value, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(value))
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype or t.dtype)
    return t.to(device=device, dtype=INDEX_DTYPE)


def _static(value):
    if isinstance(value, tuple):
        return tuple(int(v) for v in value)
    return value


def _packed_ell_coo(obj):
    """``(rows, cols, values)`` of the logical matrix a reference
    ``PackedELL`` holds: its main tiles (nonzero slots; a round id picks
    each lane's x segment) and its side COO."""
    vals = np.asarray(obj.vals)
    lidx = np.asarray(obj.lidx).astype(np.int64)
    rnd = np.asarray(obj.rnd).astype(np.int64)
    seg = np.asarray(obj.seg).astype(np.int64)
    t, i, lane = np.nonzero(vals)
    segs = (seg[t, rnd[t, i, lane]] if obj.tile_uniform
            else seg[t, i, rnd[t, i, lane]])
    k = obj.rows_per_sublane
    width = LANES // k        # a reference tile is [8, LANES]
    rows = t * 8 * k + i * k + lane // width
    cols = segs * LANES + lidx[t, i, lane]
    side = obj.side
    return (np.concatenate([rows, np.asarray(side.row, dtype=np.int64)]),
            np.concatenate([cols, np.asarray(side.col, dtype=np.int64)]),
            np.concatenate([vals[t, i, lane], np.asarray(side.data)]))


def _gather_rows(z: np.ndarray, plane) -> np.ndarray:
    """Per-row lane gather ``z[..., r, m] = z[..., r, plane[..., r, m]]``
    (the reference's planes are int8: widened before indexing)."""
    return np.take_along_axis(z, np.asarray(plane).astype(np.int64), axis=-1)


def _gtgtg(z: np.ndarray, g1, g2, g3) -> np.ndarray:
    """The reference's three-gather, two-transpose tile permutation."""
    z = np.swapaxes(_gather_rows(z, g1), -1, -2)
    z = np.swapaxes(_gather_rows(z, g2), -1, -2)
    return _gather_rows(z, g3)


def compose_permutation(plan) -> np.ndarray:
    """The ``[n]`` int64 index vector a reference ``PermutationPlan`` or
    ``TwoLevelPlan`` routes (``out[i] = x[perm[i]]``): its stages applied
    on the host to ``arange(n)`` — consolidate (a1, a2, a3), exchange rows
    (rowsrc), place (b2, b3).  Pad slots carry -1, so a don't-care output
    that reads one comes back negative."""
    if type(plan).__name__ == "TwoLevelPlan":
        # out[i] = mid[perm_b[i]], mid[q] = x[perm_a[q]]
        perm_b = compose_permutation(plan.plan_b)
        return np.where(perm_b >= 0,
                        compose_permutation(plan.plan_a)[perm_b], -1)
    n = int(plan.n)
    T = int(np.asarray(plan.a2).shape[0])
    r_p = int(plan.real_per_tile)
    xf = np.full(T * r_p, -1, dtype=np.int64)
    xf[:n] = np.arange(n, dtype=np.int64)
    z = np.full((T, TILE), -1, dtype=np.int64)
    z[:, :r_p] = xf.reshape(T, r_p)
    z = _gtgtg(z.reshape(T, Q, Q), plan.a1, plan.a2, plan.a3)
    rows = z.reshape(T * Q, Q)[np.asarray(plan.rowsrc).astype(np.int64)]
    rows = np.swapaxes(rows.reshape(T, Q, Q), 1, 2)
    rows = np.swapaxes(_gather_rows(rows, plan.b2), 1, 2)
    rows = _gather_rows(rows, plan.b3)
    return rows.reshape(T, TILE)[:, :r_p].reshape(-1)[:n]


def tile_plan_from_planes(planes, *, device) -> PermutationPlan:
    """The port's tile plan from the reference's ``(g1, g2, g3)`` planes of
    ``plan_tile_permutation``: G-T-G-T-G applied to a tile of indices."""
    g1, g2, g3 = planes
    tile = np.arange(TILE, dtype=np.int64).reshape(Q, Q)
    return plan_permutation(_gtgtg(tile, g1, g2, g3).reshape(-1),
                            device=device)


def _row_plan(plan) -> RowPlan:
    return RowPlan(tuple(int(s) for s in plan.starts), int(plan.ndev),
                   int(plan.length))


def _from_dist(obj, cls, mesh, dtype):
    """A reference sharded container on ``mesh``: stacked leaves split per
    shard, row pointers derived from each bucket's rows."""
    ndev = int(np.asarray(getattr(obj, dataclasses.fields(cls)[0].name)
                          ).shape[0])
    if ndev != mesh.ndev:
        raise ValueError(f"a reference {cls.__name__} of {ndev} shards does "
                         f"not fit a mesh of {mesh.ndev}")
    fields, stacked = {}, {}
    for f in dataclasses.fields(cls):
        if f.name in _ROWPTR:
            continue
        value = getattr(obj, f.name)
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            stacked[f.name] = np.asarray(value)
            fields[f.name] = tuple(_leaf(v, "cpu", dtype)
                                   for v in stacked[f.name])
        else:
            fields[f.name] = _static(value)
    names = {f.name for f in dataclasses.fields(cls)}
    if names & set(_ROWPTR):
        starts = np.asarray(fields["row_starts"])
        nrows = (ndev * max(-(-fields["shape"][0] // ndev), 1)
                 if cls is ColShardedCSR else int(np.diff(starts).max()))
        for name, (rows, data) in _ROWPTR.items():
            if name in names:
                fields[name] = rowptrs(stacked[rows], stacked[data], nrows)
    return place(cls(**fields), mesh)


def from_reference(obj, *, device=None, dtype=None, mesh=None):
    """The port's counterpart of a reference ``COO`` / ``CSR`` / ``CSC`` /
    ``DIA`` / ``SDIA`` / ``PSDIA`` / ``PackedELL``, ``SpmvPlan``,
    ``PermutationPlan`` / ``TwoLevelPlan`` or ``ReorderedOperator``, with
    its tensors on ``device`` — or of a reference distributed container or
    ``DistPlan``, placed on the port :class:`~.dist.Mesh` ``mesh`` (float
    leaves cast to ``dtype`` when given)."""
    dtype = torch_dtype(dtype) if dtype is not None else None
    name = type(obj).__name__
    if name in _DIST or name == "DistPlan" or name.startswith("Sharded"):
        if mesh is None:
            raise ValueError(f"a reference {name} carries over onto a mesh: "
                             f"pass mesh=")
        if name == "DistPlan":
            return DistPlan(from_reference(obj.matrix, mesh=mesh,
                                           dtype=dtype),
                            obj.strategy, _row_plan(obj.x_plan),
                            _row_plan(obj.row_plan), mesh)
        if name not in _DIST:
            raise TypeError(f"a reference {name} does not carry over; "
                            f"re-plan from the host matrix with "
                            f"plan_dist_spmv")
        return _from_dist(obj, _DIST[name], mesh, dtype)
    if device is None:
        raise ValueError(f"pass device= for a reference {name}")
    if name in ("PermutationPlan", "TwoLevelPlan"):
        return plan_permutation(compose_permutation(obj), device=device)
    if name == "ReorderedOperator":
        return ReorderedOperator(
            plan=from_reference(obj.plan, device=device, dtype=dtype),
            perm=_leaf(obj.perm, device, None).long(),
            inv_perm=_leaf(obj.inv_perm, device, None).long(),
            bandwidth_before=int(obj.bandwidth_before),
            bandwidth_after=int(obj.bandwidth_after))
    if hasattr(obj, "matrix") and hasattr(obj, "strategy"):
        if obj.strategy not in _STRATEGIES:
            raise ValueError(f"strategy {obj.strategy!r} is not ported yet "
                             f"(ported: {', '.join(_STRATEGIES)})")
        stats = (PatternStats(**dataclasses.asdict(obj.stats))
                 if obj.stats is not None else None)
        return plan_from_matrix(from_reference(obj.matrix, device=device,
                                               dtype=dtype),
                                obj.strategy, stats)
    if name in ("GPCSR", "GPCSRChunked"):
        raise TypeError(f"a reference {name} stores only routed values and "
                        f"does not carry over; re-plan from the host matrix "
                        f"with plan_spmv or pack_gpr")
    if name == "PackedELL":
        import scipy.sparse as sp

        rows, cols, vals = _packed_ell_coo(obj)
        host = sp.csr_matrix((vals, (rows, cols)), shape=tuple(obj.shape))
        return pack_ell(host, dtype=dtype or torch_dtype(vals.dtype),
                        device=device)
    cls = _TYPES.get(name)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")
    fields = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name) and f.default is None:
            continue        # a field the port derives (CSC's row order)
        value = getattr(obj, f.name)
        is_array = hasattr(value, "shape") and hasattr(value, "dtype")
        fields[f.name] = (_leaf(value, device, dtype) if is_array
                          else _static(value))
    return cls(**fields)
