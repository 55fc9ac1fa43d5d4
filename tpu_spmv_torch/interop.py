"""Carry operators packed by the JAX reference package into the port.

In this system the "weights" are the packed operators.  The port keeps the
reference's dataclass fields for COO, CSR, DIA, SDIA and PSDIA, so an
operator carries over field by field: array leaves through numpy, static
fields as they are.  A reference ``PackedELL`` carries over through the
logical matrix its tiles hold (the arithmetic of ``PackedELL.to_coo``),
repacked as the port's sliced ELL.  A reference ``GPCSR`` or
``GPCSRChunked`` holds only routed values, so it does not carry over:
re-plan from the host matrix.  It works by duck typing and imports no
JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats import COO, CSR, DIA
from .formats.base import INDEX_DTYPE, torch_dtype
from .kernels.dia_stream import PSDIA, SDIA
from .kernels.ell_packed import pack_ell
from .kernels.gpr import LANES
from .ops.auto import PatternStats, plan_from_matrix

__all__ = ["from_reference"]

_TYPES = {cls.__name__: cls for cls in (COO, CSR, DIA, SDIA, PSDIA)}
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


def from_reference(obj, *, device, dtype=None):
    """The port's counterpart of a reference ``COO`` / ``CSR`` / ``DIA`` /
    ``SDIA`` / ``PSDIA`` / ``PackedELL`` or ``SpmvPlan``, with its tensors
    on ``device`` (float leaves cast to ``dtype`` when given)."""
    dtype = torch_dtype(dtype) if dtype is not None else None
    if hasattr(obj, "matrix") and hasattr(obj, "strategy"):
        if obj.strategy not in _STRATEGIES:
            raise ValueError(f"strategy {obj.strategy!r} is not ported yet "
                             f"(ported: {', '.join(_STRATEGIES)})")
        stats = (PatternStats(**dataclasses.asdict(obj.stats))
                 if obj.stats is not None else None)
        return plan_from_matrix(from_reference(obj.matrix, device=device,
                                               dtype=dtype),
                                obj.strategy, stats)
    name = type(obj).__name__
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
