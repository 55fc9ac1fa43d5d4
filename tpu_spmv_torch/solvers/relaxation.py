"""Multicolor Gauss-Seidel, SOR and SymGS: relaxation as full SpMVs.

Counterpart of ``tpu_spmv/solvers/relaxation.py``.  The rows are coloured
so that no two rows of one colour are coupled (``A[i, j] = 0`` whenever
``color[i] == color[j]``, ``i != j``); all rows of a colour then update at
once, and a sweep is ``ncolors`` full SpMVs (the planner's kernel) and a
masked update each.  Updating colour 0, 1, 2, ... is classical
Gauss-Seidel in the colour-sorted row order.  For a colour ``c``::

    (A x)_c = A_{c, not c} x_{not c} + d_c x_c
    x_c    <- (1 - omega) x_c + omega D_c^-1 (b_c - (A x)_c + d_c x_c)

The colouring is host planning, once per matrix: a greedy colouring of
the symmetrized pattern by ``native/libpermute_router.so:greedy_color``
(O(nnz) C++, built from ``native/`` at first use), or the same greedy
rule in Python where the library does not load.  Grid stencils come out
red-black.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from .cg import _as_matvec, _limit, _norm, safe_dinv, safe_dinv_host

__all__ = ["multicolor", "gauss_seidel_sweep", "sor", "SORResult",
           "symgs_preconditioner"]


def _greedy_color_py(indptr, indices, n) -> np.ndarray:
    """The greedy colouring in Python: each row takes the smallest colour
    none of its neighbours has."""
    color = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nb = indices[indptr[i]:indptr[i + 1]]
        used = set(color[j] for j in nb if color[j] >= 0)
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color


@functools.cache
def _router():
    """``native/libpermute_router.so`` with ``greedy_color`` declared, or
    None where it cannot be built or loaded."""
    from ..utils import ensure_native_built

    ensure_native_built()
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libpermute_router.so")
    try:
        lib = ctypes.CDLL(path)
        fn = lib.greedy_color
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int32)]
    return lib


def multicolor(host_mat) -> np.ndarray:
    """Greedy multicolouring of a scipy matrix's symmetrized pattern:
    ``color[i]`` in ``[0, ncolors)`` with no edge inside a colour (grid
    stencils: red-black; at most the largest symmetrized degree + 1
    colours)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(host_mat)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("multicolor needs a square matrix")
    S = (A + A.T).tocsr()          # symmetrize: GS couples both ways
    S.sort_indices()
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    lib = _router()
    if lib is None:
        return _greedy_color_py(indptr, indices, n)
    color = np.full(n, -1, dtype=np.int32)
    lib.greedy_color(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        color.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return color


def gauss_seidel_sweep(A, b: torch.Tensor, x: torch.Tensor, *,
                       color: torch.Tensor, ncolors: int,
                       dinv: torch.Tensor, omega: float = 1.0,
                       symmetric: bool = False) -> torch.Tensor:
    """One multicolor Gauss-Seidel (``omega=1``) or SOR sweep, and with
    ``symmetric`` its reverse-order half after it (SymGS).

    ``color`` is :func:`multicolor`'s colouring as a tensor on ``x``'s
    device, ``dinv`` the inverse diagonal; each colour costs one full
    SpMV of ``A`` (a format, a plan or a matvec closure)."""
    matvec = _as_matvec(A)

    def half(x, order):
        for c in order:
            # b - A_{c, not c} x_{not c} == b - (A x - d x) on colour rows
            gs = dinv * (b - matvec(x)) + x
            x = torch.where(color == c, x + omega * (gs - x), x)
        return x

    x = half(x, range(ncolors))
    if symmetric:
        x = half(x, range(ncolors - 1, -1, -1))
    return x


class SORResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: torch.Tensor


def sor(A, b: torch.Tensor, *, host_mat=None, color=None, dinv=None,
        omega: float = 1.0, x0=None, tol: float = 1e-8,
        maxiter: int = 500, symmetric: bool = False) -> SORResult:
    """Multicolor SOR (``omega=1``: Gauss-Seidel) solve of ``A x = b``:
    sweeps until ``||b - A x|| <= tol ||b||`` or ``maxiter`` (one host
    read a sweep).

    Needs the host scipy matrix (for the colouring and the diagonal) or
    both ``color`` and ``dinv``.  A sweep costs ``ncolors`` SpMVs, twice
    that with ``symmetric``."""
    if (color is None or dinv is None) and host_mat is None:
        raise ValueError("sor needs host_mat= (for coloring + diagonal) "
                         "or BOTH color= and dinv=")
    if color is None:
        color = multicolor(host_mat)
    color = np.asarray(color)
    ncolors = int(color.max()) + 1 if len(color) else 1
    color_dev = torch.as_tensor(color, dtype=torch.int32, device=b.device)
    if dinv is None:
        dinv = safe_dinv(np.asarray(host_mat.diagonal(), np.float64),
                         dtype=b.dtype, device=b.device)
    else:
        dinv = torch.as_tensor(dinv, dtype=b.dtype, device=b.device)
    matvec = _as_matvec(A)
    x = torch.zeros_like(b) if x0 is None else x0
    limit = _limit(tol, b)
    rn = _norm(b - matvec(x))
    it = 0
    while it < maxiter and bool(rn > limit):
        x = gauss_seidel_sweep(matvec, b, x, color=color_dev,
                               ncolors=ncolors, dinv=dinv, omega=omega,
                               symmetric=symmetric)
        rn = _norm(b - matvec(x))
        it += 1
    return SORResult(x=x, iterations=it, residual_norm=rn,
                     converged=rn <= limit)


def symgs_preconditioner(A, host_mat, *, sweeps: int = 1,
                         omega: float = 1.0) -> Callable:
    """SymGS as a CG preconditioner: ``z ~ M^-1 r`` by ``sweeps``
    symmetric multicolor sweeps from ``z = 0``.  Symmetric sweeps keep it
    SPD for SPD ``A``; one application is ``2 ncolors sweeps`` SpMVs."""
    color = multicolor(host_mat)
    ncolors = int(color.max()) + 1 if len(color) else 1
    dinv_host = safe_dinv_host(host_mat.diagonal())
    placed = {}             # (device, dtype) -> (colours, inverse diagonal)

    def apply(r):
        key = (r.device, r.dtype)
        if key not in placed:
            placed[key] = (
                torch.as_tensor(color, dtype=torch.int32, device=r.device),
                torch.as_tensor(dinv_host, dtype=r.dtype, device=r.device))
        color_dev, dinv = placed[key]
        z = torch.zeros_like(r)
        for _ in range(sweeps):
            z = gauss_seidel_sweep(A, r, z, color=color_dev,
                                   ncolors=ncolors, dinv=dinv, omega=omega,
                                   symmetric=True)
        return z

    return apply
