"""Sparse matrix formats as dataclasses of torch tensors: COO, CSR, CSC,
DIA.

Counterpart of ``tpu_spmv/formats``; conversions go through COO.  ELL, BSR
and BDIA are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from .base import INDEX_DTYPE, torch_dtype
from .coo import COO
from .csc import CSC
from .csr import CSR
from .dia import DIA

__all__ = ["COO", "CSR", "CSC", "DIA", "INDEX_DTYPE", "torch_dtype",
           "convert", "to_coo", "FORMATS"]

#: name → class registry (the CLI's ``--formats`` sweep uses it)
FORMATS = {"coo": COO, "csr": CSR, "csc": CSC, "dia": DIA}


def to_coo(mat) -> COO:
    """Any port format or scipy.sparse matrix → COO."""
    if isinstance(mat, COO):
        return mat
    if hasattr(mat, "to_coo"):
        return mat.to_coo()
    if hasattr(mat, "tocoo"):          # scipy.sparse
        return COO.from_scipy(mat)
    raise TypeError(f"cannot convert {type(mat).__name__} to COO")


def convert(mat, target: str | type):
    """Convert between formats via COO: ``convert(A, "csr")``."""
    if isinstance(target, str):
        try:
            target_cls = FORMATS[target.lower()]
        except KeyError:
            raise ValueError(
                f"unknown format {target!r}; valid: {sorted(FORMATS)}"
            ) from None
    else:
        target_cls = target
    if isinstance(mat, target_cls):
        return mat
    coo = to_coo(mat)
    if target_cls is COO:
        return coo
    return target_cls.from_coo(coo)
