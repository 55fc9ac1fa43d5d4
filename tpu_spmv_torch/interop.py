"""Carry operators packed by the JAX reference package into the port.

In this system the "weights" are the packed operators.  The port keeps the
reference's dataclass fields for COO, CSR, DIA, SDIA and PSDIA, so an
operator carries over field by field: array leaves through numpy, static
fields as they are.  A reference ``PackedELL`` carries over through the
logical matrix its tiles hold (the arithmetic of ``PackedELL.to_coo``),
repacked as the port's sliced ELL.  A reference ``GPCSR`` or
``GPCSRChunked`` holds only routed values, so it does not carry over:
re-plan from the host matrix.

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
from .formats import COO, CSR, DIA
from .formats.base import INDEX_DTYPE, torch_dtype
from .kernels.dia_stream import PSDIA, SDIA
from .kernels.ell_packed import pack_ell
from .kernels.gpr import LANES
from .ops.auto import PatternStats, plan_from_matrix

__all__ = ["from_reference"]

_TYPES = {cls.__name__: cls for cls in (COO, CSR, DIA, SDIA, PSDIA)}
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
    """The port's counterpart of a reference ``COO`` / ``CSR`` / ``DIA`` /
    ``SDIA`` / ``PSDIA`` / ``PackedELL`` or ``SpmvPlan``, with its tensors
    on ``device`` — or of a reference distributed container or
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
        value = getattr(obj, f.name)
        is_array = hasattr(value, "shape") and hasattr(value, "dtype")
        fields[f.name] = (_leaf(value, device, dtype) if is_array
                          else _static(value))
    return cls(**fields)
