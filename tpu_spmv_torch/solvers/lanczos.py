"""Lanczos tridiagonalization and extremal eigenvalues of symmetric A.

Counterpart of ``tpu_spmv/solvers/lanczos.py``: ``k`` Lanczos steps give
both ends of the spectrum (the bounds :func:`~.cheby.chebyshev` needs) at
a Krylov method's rate.  A step is one SpMV, two dots and two vector
updates on the device, with no host synchronisation; the ``k x k``
tridiagonal eigenproblem runs on the host in numpy.

``full_reorth=True`` orthogonalizes each new vector against the whole
stored basis ``V`` (``[k, n]``): one product with ``V`` and one with its
transpose a step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cg import _as_matvec, _draw, _norm, _size, _vector_type

__all__ = ["LanczosResult", "lanczos", "eigsh_lanczos"]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor        # [k] tridiagonal diagonal
    betas: torch.Tensor         # [k-1] tridiagonal off-diagonal
    V: torch.Tensor | None      # [k, n] Lanczos basis (full_reorth only)


def lanczos(A, *, k: int = 50, v0=None,
            generator: torch.Generator | None = None, n: int | None = None,
            full_reorth: bool = False, dtype=None,
            device=None) -> LanczosResult:
    """Run ``k`` Lanczos steps on symmetric ``A`` (a format, a plan or a
    matvec closure) from ``v0``, or from uniform values in [-0.5, 0.5)
    drawn from ``generator`` (the reference's ``key``).

    Returns the tridiagonal coefficients, and the basis ``V`` with
    ``full_reorth``.  A breakdown (``beta ~ 0``: an invariant subspace)
    continues with a zero vector, so the steps after it carry ``alpha =
    0`` and must be cut before the tridiagonal is solved, as
    :func:`eigsh_lanczos` does."""
    matvec = _as_matvec(A)
    n = _size(A, n, "lanczos")
    if k < 1:
        raise ValueError("k must be >= 1")
    if v0 is None:
        dtype, device = _vector_type(A, dtype, device)
        v0 = _draw(n, generator, dtype, device) - 0.5
    eps = torch.tensor(1e-30, dtype=v0.dtype, device=v0.device)
    v = v0 / torch.maximum(_norm(v0), eps)
    V = None
    if full_reorth:
        V = torch.zeros((k, n), dtype=v.dtype, device=v.device)
        V[0] = v
    v_prev = torch.zeros_like(v)
    beta = torch.zeros_like(eps)
    alphas, betas = [], []
    for i in range(k):
        w = matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta * v_prev
        if full_reorth:
            # against the whole stored basis (rows past i are zero)
            w = w - torch.mv(V.T, torch.mv(V, w))
        beta = torch.sqrt(torch.clamp(torch.dot(w, w), min=0.0))
        v_next = torch.where(beta > 1e-12, w / torch.maximum(beta, eps),
                             torch.zeros_like(w))
        if full_reorth and i + 1 < k:
            V[i + 1] = v_next
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, v_next
    return LanczosResult(alphas=torch.stack(alphas),
                         betas=torch.stack(betas)[:-1], V=V)


def eigsh_lanczos(A, *, k: int = 50, which: str = "both", v0=None,
                  generator: torch.Generator | None = None,
                  n: int | None = None, full_reorth: bool = True,
                  dtype=None, device=None):
    """Extremal eigenvalue estimates of symmetric ``A`` from ``k`` Lanczos
    steps: ``which="both"`` gives ``(lmin, lmax)``, ``"LM"`` ``lmax`` and
    ``"SM"`` ``lmin`` (scipy's ``eigsh`` names).  The tridiagonal,
    cut at the first breakdown, is solved on the host in numpy."""
    res = lanczos(A, k=k, v0=v0, generator=generator, n=n,
                  full_reorth=full_reorth, dtype=dtype, device=device)
    a = res.alphas.cpu().double().numpy()
    b = res.betas.cpu().double().numpy()
    # steps past a ~zero beta carry alpha = 0 and would add a spurious
    # eigenvalue 0
    brk = np.flatnonzero(np.abs(b) <= 1e-12)
    if len(brk):
        cut = int(brk[0]) + 1
        a, b = a[:cut], b[:cut - 1]
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    w = np.linalg.eigvalsh(T)
    if which == "LM":
        return float(w[-1])
    if which == "SM":
        return float(w[0])
    if which == "both":
        return float(w[0]), float(w[-1])
    raise ValueError(f"which must be 'both'|'LM'|'SM', got {which!r}")
