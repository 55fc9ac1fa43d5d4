"""Shared helpers for the sparse-format dataclasses.

Each format is a frozen :func:`dataclasses.dataclass` whose array fields
are ``torch.Tensor`` and whose other fields (``shape``, ``offsets``, …) are
plain static Python metadata.  Index tensors are ``int32``, as in the JAX
reference package, so packs carry over field for field and the byte model
of :mod:`..bench.roofline` holds; value tensors are ``float32`` or
``float64``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["INDEX_DTYPE", "sparse_dataclass", "torch_dtype", "as_index",
           "as_values"]

INDEX_DTYPE = torch.int32

_BY_NAME = {"float32": torch.float32, "float64": torch.float64}
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported value dtype {name!r} "
                        f"(valid: {sorted(_BY_NAME)})")
    return _BY_NAME[name]


def _to(self, device):
    """The same matrix with every tensor field, and every nested sparse
    dataclass (a pack's side COO), moved to ``device``."""
    moved = {f.name: getattr(self, f.name).to(device)
             for f in dataclasses.fields(self)
             if isinstance(getattr(self, f.name), torch.Tensor)
             or dataclasses.is_dataclass(getattr(self, f.name))}
    return dataclasses.replace(self, **moved)


def _device(self) -> torch.device:
    """The device of the matrix's tensors."""
    for f in dataclasses.fields(self):
        v = getattr(self, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"{type(self).__name__} holds no tensor")


def sparse_dataclass(cls):
    """A frozen dataclass with ``.to(device)`` and ``.device``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.to = _to
    cls.device = property(_device)
    return cls


def as_index(x, device=None) -> torch.Tensor:
    """Host or device integers as an ``int32`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=INDEX_DTYPE)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def as_values(x, dtype=None, device=None) -> torch.Tensor:
    """Host or device values as a float tensor on ``device``.

    ``dtype=None`` keeps float32/float64 input as it is and takes any
    other input as float64."""
    if isinstance(x, torch.Tensor):
        dt = torch_dtype(dtype) if dtype is not None else (
            x.dtype if x.dtype in (torch.float32, torch.float64)
            else torch.float64)
        return x.to(device=device, dtype=dt)
    arr = np.asarray(x)
    if dtype is None:
        dt = arr.dtype if arr.dtype in (np.float32, np.float64) else np.float64
    else:
        dt = _NUMPY[torch_dtype(dtype)]
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=dt)).to(device)
