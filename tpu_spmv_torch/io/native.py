"""ctypes binding to the C++ fast MatrixMarket parser (native tier).

Wraps ``native/libmmio_fast.so`` (built by ``make -C native``), the
framework-free library the reference package loads the same way.
Gracefully absent: :func:`available` is False when the library isn't
built, and :mod:`.mmio` falls back to its pure-Python parser — identical
semantics, just slower.  Python keeps ownership of semantics (symmetry
expansion, pattern fills, validation); C++ only turns bytes into arrays.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

__all__ = ["available", "read_mtx_arrays_native"]

_SEARCH = [
    os.environ.get("TPU_SPMV_NATIVE", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libmmio_fast.so"),
    os.path.join(os.path.dirname(__file__), "libmmio_fast.so"),
]


@functools.cache
def _lib():
    from ..utils import ensure_native_built

    ensure_native_built()
    for path in _SEARCH:
        if path and os.path.exists(path):
            lib = ctypes.CDLL(path)
            lib.mtx_open.restype = ctypes.c_void_p
            lib.mtx_open.argtypes = [ctypes.c_char_p]
            lib.mtx_error.restype = ctypes.c_char_p
            lib.mtx_error.argtypes = [ctypes.c_void_p]
            for name in ("mtx_nrow", "mtx_ncol", "mtx_nnz"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            for name in ("mtx_format", "mtx_field", "mtx_symmetry"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_char_p
                fn.argtypes = [ctypes.c_void_p]
            lib.mtx_read_coordinate.restype = ctypes.c_int64
            lib.mtx_read_coordinate.argtypes = [ctypes.c_void_p] + [
                ctypes.POINTER(ctypes.c_int64)] * 2 + [
                ctypes.POINTER(ctypes.c_double)]
            lib.mtx_read_array.restype = ctypes.c_int64
            lib.mtx_read_array.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
            lib.mtx_close.restype = None
            lib.mtx_close.argtypes = [ctypes.c_void_p]
            return lib
    return None


def available() -> bool:
    return _lib() is not None


def read_mtx_arrays_native(path):
    """Native read → ``(row, col, val, shape, field, symmetry)`` with
    0-based indices, **no** symmetry expansion (caller's job).

    Raises on parse errors; raises RuntimeError if the library is absent.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native mmio library not built (make -C native)")
    handle = lib.mtx_open(os.fspath(path).encode())
    try:
        err = lib.mtx_error(handle)
        if err:
            raise ValueError(f"mmio_fast: {err.decode()}")
        fmt = lib.mtx_format(handle).decode()
        field = lib.mtx_field(handle).decode()
        symmetry = lib.mtx_symmetry(handle).decode()
        nrow = lib.mtx_nrow(handle)
        ncol = lib.mtx_ncol(handle)
        nnz = lib.mtx_nnz(handle)
        if field == "complex":
            raise ValueError("complex matrices are not supported")
        if fmt == "coordinate":
            rows = np.empty(nnz, dtype=np.int64)
            cols = np.empty(nnz, dtype=np.int64)
            vals = np.ones(nnz, dtype=np.float64)
            got = lib.mtx_read_coordinate(
                handle,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            err = lib.mtx_error(handle)
            if got < 0 or err:
                raise ValueError(
                    f"mmio_fast parse error: {err.decode() if err else got}"
                )
            if got != nnz:
                raise ValueError(
                    f"coordinate body has {got} entries, expected {nnz}"
                )
            rows -= 1
            cols -= 1
            if rows.size and (
                rows.min() < 0 or rows.max() >= nrow
                or cols.min() < 0 or cols.max() >= ncol
            ):
                raise ValueError("matrix entry index out of declared bounds")
            return rows, cols, vals, (int(nrow), int(ncol)), field, symmetry
        # array format — the C++ tier only tokenizes (reads at most
        # nrow*ncol values, its internal cap); the symmetric packed-triangle
        # reconstruction lives in one place, mmio._dense_from_array_vals,
        # so both parse paths agree.  Symmetry is returned as "general"
        # because the dense reconstruction already expanded it — the caller
        # must not mirror again (that double-counted off-diagonals before).
        from .mmio import _dense_from_array_vals

        vals = np.empty(int(nnz), dtype=np.float64)
        got = lib.mtx_read_array(
            handle, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        dense = _dense_from_array_vals(vals[:got], int(nrow), int(ncol),
                                       symmetry)
        row, col = np.nonzero(dense)
        return (row, col, dense[row, col], (int(nrow), int(ncol)), field,
                "general")
    finally:
        lib.mtx_close(handle)
