"""Carry operators packed by the JAX reference package into the port.

In this system the "weights" are the packed operators.  The port keeps the
reference's dataclass fields for COO, CSR, DIA, SDIA and PSDIA, so an
operator carries over field by field: array leaves through numpy, static
fields as they are.  It works by duck typing and imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats import COO, CSR, DIA
from .formats.base import INDEX_DTYPE, torch_dtype
from .kernels.dia_stream import PSDIA, SDIA
from .ops.auto import PatternStats, plan_from_matrix

__all__ = ["from_reference"]

_TYPES = {cls.__name__: cls for cls in (COO, CSR, DIA, SDIA, PSDIA)}
#: reference strategies the port can run
_STRATEGIES = ("pdia_stream", "dia_stream", "dia", "csr")


def _leaf(value, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(value))
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype or t.dtype)
    return t.to(device=device, dtype=INDEX_DTYPE)


def _static(value):
    if isinstance(value, tuple):
        return tuple(int(v) for v in value)
    return value


def from_reference(obj, *, device, dtype=None):
    """The port's counterpart of a reference ``COO`` / ``CSR`` / ``DIA`` /
    ``SDIA`` / ``PSDIA`` or ``SpmvPlan``, with its tensors on ``device``
    (float leaves cast to ``dtype`` when given)."""
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
    cls = _TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")
    fields = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        is_array = hasattr(value, "shape") and hasattr(value, "dtype")
        fields[f.name] = (_leaf(value, device, dtype) if is_array
                          else _static(value))
    return cls(**fields)
