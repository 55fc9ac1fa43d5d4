"""Sparse matrix formats as dataclasses of torch tensors: COO, CSR, CSC,
ELL, DIA, BSR and BDIA.

Counterpart of ``tpu_spmv/formats``; conversions go through COO and pass
their keyword arguments on (``convert(A, "bsr", block_size=8)``).
"""

from __future__ import annotations

from .base import INDEX_DTYPE, torch_dtype
from .bdia import BDIA
from .bsr import BSR
from .coo import COO
from .csc import CSC
from .csr import CSR
from .dia import DIA
from .ell import ELL

__all__ = ["COO", "CSR", "CSC", "ELL", "DIA", "BSR", "BDIA", "INDEX_DTYPE",
           "torch_dtype", "convert", "to_coo", "FORMATS"]

#: name → class registry (the CLI's ``--formats`` sweep uses it)
FORMATS = {"coo": COO, "csr": CSR, "csc": CSC, "ell": ELL, "dia": DIA,
           "bsr": BSR, "bdia": BDIA}


def to_coo(mat) -> COO:
    """Any port format or scipy.sparse matrix → COO."""
    if isinstance(mat, COO):
        return mat
    if hasattr(mat, "to_coo"):
        return mat.to_coo()
    if hasattr(mat, "tocoo"):          # scipy.sparse
        return COO.from_scipy(mat)
    raise TypeError(f"cannot convert {type(mat).__name__} to COO")


def convert(mat, target: str | type, **kwargs):
    """Convert between formats via COO: ``convert(A, "csr")``,
    ``convert(A, "bsr", block_size=8)`` (keyword arguments go to the
    target's ``from_coo``)."""
    if isinstance(target, str):
        try:
            target_cls = FORMATS[target.lower()]
        except KeyError:
            raise ValueError(
                f"unknown format {target!r}; valid: {sorted(FORMATS)}"
            ) from None
    else:
        target_cls = target
    if isinstance(mat, target_cls) and not kwargs:
        return mat
    coo = to_coo(mat)
    if target_cls is COO:
        return coo
    return target_cls.from_coo(coo, **kwargs)
