"""MatrixMarket (.mtx) I/O, pure Python/numpy.

Counterpart of ``tpu_spmv/io/mmio.py`` with the same semantics: banner and
size-line validation, 1-based → 0-based indices, ``symmetric`` /
``skew-symmetric`` storage expanded to full generality, ``pattern`` entries
valued 1.0, complex matrices rejected.  Plain file paths use the C++ fast
parser of ``native/`` when it is built (:mod:`.native`); semantics are
identical either way.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import gzip
import numpy as np

from ..formats.base import host_values
from ..formats.coo import COO

__all__ = [
    "MMHeader",
    "read_header",
    "read_mtx_arrays",
    "read_matrix",
    "write_matrix",
    "read_dense",
    "write_dense",
]

_FIELDS = {"real", "integer", "pattern", "complex"}
_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


@dataclasses.dataclass(frozen=True)
class MMHeader:
    """Parsed MatrixMarket banner + size line (the mm_typecode analog)."""

    object: str          # "matrix"
    format: str          # "coordinate" | "array"
    field: str           # "real" | "integer" | "pattern" | "complex"
    symmetry: str        # "general" | "symmetric" | "skew-symmetric" | "hermitian"
    nrow: int
    ncol: int
    nnz: int             # stored entries (pre-expansion); for array format
                         # nrow*ncol when general, packed-triangle count
                         # (n(n+1)/2, or n(n-1)/2 skew) otherwise


def _open(path_or_file, mode: str):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    path = os.fspath(path_or_file)
    if path.endswith(".gz"):
        return gzip.open(path, mode), True
    return open(path, mode), True


def read_header(f) -> MMHeader:
    """Parse banner + comment block + size line.

    Raises ``ValueError`` on anything malformed.
    """
    banner = f.readline()
    if isinstance(banner, bytes):
        raise TypeError("mmio expects text-mode streams")
    parts = banner.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a MatrixMarket file (banner: {banner.strip()!r})")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    if obj != "matrix":
        raise ValueError(f"unsupported MatrixMarket object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported MatrixMarket format {fmt!r}")
    if field not in _FIELDS:
        raise ValueError(f"unsupported MatrixMarket field {field!r}")
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"unsupported MatrixMarket symmetry {symmetry!r}")
    # skip comments and blank lines
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    if not line:
        raise ValueError("missing MatrixMarket size line")
    sizes = line.split()
    if fmt == "coordinate":
        if len(sizes) != 3:
            raise ValueError(f"bad coordinate size line: {line.strip()!r}")
        nrow, ncol, nnz = (int(s) for s in sizes)
    else:
        if len(sizes) != 2:
            raise ValueError(f"bad array size line: {line.strip()!r}")
        nrow, ncol = (int(s) for s in sizes)
        # array files with symmetry store only the packed lower triangle
        # (column-major); skew-symmetric omits the diagonal (MM spec)
        if symmetry == "general":
            nnz = nrow * ncol
        elif symmetry == "skew-symmetric":
            nnz = nrow * (nrow - 1) // 2
        else:
            nnz = nrow * (nrow + 1) // 2
    return MMHeader(obj, fmt, field, symmetry, nrow, ncol, nnz)


def _dense_from_array_vals(vals, nrow: int, ncol: int, symmetry: str):
    """Reconstruct the full dense matrix from array-format body values.

    ``general`` stores all ``nrow*ncol`` values column-major.  Non-general
    symmetries store only the packed lower triangle column-major (for each
    column ``j``: rows ``j..n-1``); ``skew-symmetric`` omits the diagonal.
    Shared by the pure-Python and native parse paths so both agree.
    """
    vals = np.asarray(vals, dtype=np.float64)
    if symmetry == "general":
        if vals.size != nrow * ncol:
            raise ValueError(
                f"array body has {vals.size} values, expected {nrow * ncol}"
            )
        return vals.reshape(ncol, nrow).T  # column-major file order
    if nrow != ncol:
        raise ValueError(
            f"{symmetry} array matrix must be square, got {nrow}x{ncol}"
        )
    n = nrow
    skew = symmetry == "skew-symmetric"
    expect = n * (n - 1) // 2 if skew else n * (n + 1) // 2
    if vals.size != expect:
        raise ValueError(
            f"array body has {vals.size} values, expected {expect} "
            f"(packed lower triangle, {symmetry})"
        )
    r, c = np.tril_indices(n, -1 if skew else 0)
    order = np.lexsort((r, c))          # storage order: by column, then row
    dense = np.zeros((n, n))
    dense[r[order], c[order]] = vals
    if skew:
        return dense - dense.T
    return dense + np.tril(dense, -1).T


def _expand_symmetry(row, col, val, symmetry: str):
    """Expand triangular storage to full generality."""
    if symmetry == "general":
        return row, col, val
    off = row != col
    mrow = np.concatenate([row, col[off]])
    mcol = np.concatenate([col, row[off]])
    if symmetry == "skew-symmetric":
        mval = np.concatenate([val, -val[off]])
    else:  # symmetric (and hermitian-on-reals)
        mval = np.concatenate([val, val[off]])
    return mrow, mcol, mval


def read_mtx_arrays(path_or_file, *, use_native: bool | None = None):
    """Read a .mtx file into host numpy ``(row, col, val, (nrow, ncol))``.

    0-based indices, symmetry expanded, pattern entries valued 1.0.
    Plain (non-gzip) file paths use the C++ fast parser when it is built
    (``make -C native``); semantics are identical either way.
    """
    is_path = not (hasattr(path_or_file, "read") or hasattr(path_or_file, "write"))
    if use_native is not False and is_path:
        path = os.fspath(path_or_file)
        if not path.endswith(".gz"):
            from . import native

            if not os.path.exists(path):
                raise FileNotFoundError(path)
            if native.available():
                row, col, val, shape, field, symmetry = (
                    native.read_mtx_arrays_native(path)
                )
                if symmetry not in _SYMMETRIES:
                    raise ValueError(
                        f"unsupported MatrixMarket symmetry {symmetry!r}"
                    )
                row, col, val = _expand_symmetry(row, col, val, symmetry)
                return row, col, val, shape
            if use_native:
                raise RuntimeError(
                    "native mmio requested but not built (make -C native)"
                )
    f, should_close = _open(path_or_file, "rt")
    try:
        hdr = read_header(f)
        if hdr.field == "complex":
            raise ValueError("complex matrices are not supported")
        body = f.read()
        if hdr.format == "array":
            vals = np.array(body.split(), dtype=np.float64)
            dense = _dense_from_array_vals(vals, hdr.nrow, hdr.ncol,
                                           hdr.symmetry)
            row, col = np.nonzero(dense)
            return row, col, dense[row, col], (hdr.nrow, hdr.ncol)
        # coordinate
        tokens = np.array(body.split(), dtype=np.float64)
        if hdr.field == "pattern":
            if tokens.size != 2 * hdr.nnz:
                raise ValueError(
                    f"pattern body has {tokens.size} tokens, expected {2 * hdr.nnz}"
                )
            pairs = tokens.reshape(hdr.nnz, 2)
            row = pairs[:, 0].astype(np.int64) - 1
            col = pairs[:, 1].astype(np.int64) - 1
            val = np.ones(hdr.nnz, dtype=np.float64)
        else:
            if tokens.size != 3 * hdr.nnz:
                raise ValueError(
                    f"coordinate body has {tokens.size} tokens, expected {3 * hdr.nnz}"
                )
            trip = tokens.reshape(hdr.nnz, 3)
            row = trip[:, 0].astype(np.int64) - 1
            col = trip[:, 1].astype(np.int64) - 1
            val = trip[:, 2]
        if row.size and (
            row.min() < 0 or row.max() >= hdr.nrow
            or col.min() < 0 or col.max() >= hdr.ncol
        ):
            raise ValueError("matrix entry index out of declared bounds")
        row, col, val = _expand_symmetry(row, col, val, hdr.symmetry)
        return row, col, val, (hdr.nrow, hdr.ncol)
    finally:
        if should_close:
            f.close()


def read_matrix(path_or_file, *, dtype=None, device=None,
                sort: bool = True) -> COO:
    """.mtx → :class:`COO` on ``device``, sorted by row, then column
    (``sort=False`` keeps the file's order)."""
    row, col, val, shape = read_mtx_arrays(path_or_file)
    return COO.from_arrays(row, col, val, shape, dtype=dtype, device=device,
                           sort=sort)


def write_matrix(path_or_file, mat, *, comment: str | None = None) -> None:
    """Write a sparse matrix (port format or scipy) as
    coordinate/real/general .mtx."""
    from ..formats import to_coo

    coo = to_coo(mat)
    row = coo.row.cpu().numpy().astype(np.int64) + 1
    col = coo.col.cpu().numpy().astype(np.int64) + 1
    val = host_values(coo.data).astype(np.float64)
    f, should_close = _open(path_or_file, "wt")
    try:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        buf = _io.StringIO()
        np.savetxt(buf, np.column_stack([row, col, val]), fmt="%d %d %.17g")
        f.write(buf.getvalue())
    finally:
        if should_close:
            f.close()


def read_dense(path_or_file) -> np.ndarray:
    """A dense vector or matrix from array-format .mtx, or from the plain
    vector format (the first line the length, then one value a line)."""
    f, should_close = _open(path_or_file, "rt")
    try:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            f.seek(0)
            row, col, val, shape = read_mtx_arrays(f)
            dense = np.zeros(shape)
            dense[row, col] = val
            return dense if shape[1] > 1 else dense[:, 0]
        n = int(first.split()[0])
        vals = np.array(f.read().split(), dtype=np.float64)
        if vals.size != n:
            raise ValueError(f"vector file declares {n} values, has "
                             f"{vals.size}")
        return vals
    finally:
        if should_close:
            f.close()


def write_dense(path_or_file, vec) -> None:
    """Write a vector (numpy or a tensor, flattened) in the plain vector
    format :func:`read_dense` reads."""
    if hasattr(vec, "detach"):
        vec = host_values(vec)
    arr = np.asarray(vec).ravel()
    f, should_close = _open(path_or_file, "wt")
    try:
        f.write(f"{arr.size}\n")
        for v in arr:
            f.write(f"{v:.17g}\n")
    finally:
        if should_close:
            f.close()
