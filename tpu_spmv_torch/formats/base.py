"""Shared helpers for the sparse-format dataclasses.

Each format is a frozen :func:`dataclasses.dataclass` whose array fields
are ``torch.Tensor`` and whose other fields (``shape``, ``offsets``, …) are
plain static Python metadata.  Index tensors are ``int32``, as in the JAX
reference package, so packs carry over field for field and the byte model
of :mod:`..bench.roofline` holds; value tensors are ``float32`` or
``float64``, or ``bfloat16`` (coefficients stored in 16 bits for float32
vectors).  Numpy has no bfloat16, so host code reads bf16 values widened
to float32 (exact, :func:`host_values`) and rounds them back once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["INDEX_DTYPE", "sparse_dataclass", "torch_dtype", "as_index",
           "as_values", "host_values"]

INDEX_DTYPE = torch.int32

#: the value types, by name
_BY_NAME = {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` from a torch dtype, a numpy dtype or a name
    (``"bfloat16"`` by name only: numpy has no such type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _BY_NAME:
        return _BY_NAME[dtype]
    name = np.dtype(dtype).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported value dtype {name!r} "
                        f"(valid: {sorted(_BY_NAME)})")
    return _BY_NAME[name]


def host_values(t: torch.Tensor) -> np.ndarray:
    """A value tensor as a host numpy array; bfloat16 widened to float32
    (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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

    ``dtype=None`` keeps float32, float64 and bfloat16 as they are and
    takes any other input as float64.  A narrower ``dtype`` rounds the
    values once (``torch.bfloat16``: torch's rounding of the input's
    type)."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(np.float64)
        x = torch.from_numpy(np.ascontiguousarray(arr))
    dt = torch_dtype(dtype) if dtype is not None else (
        x.dtype if x.dtype in _BY_NAME.values() else torch.float64)
    return x.to(device=device, dtype=dt)
