"""Conjugate gradients on the SpMV + BLAS-1 surface.

Counterpart of ``tpu_spmv/solvers/cg.py``: :func:`cg` (with the
true-residual restart mode), the fixed-iteration :func:`cg_runner` /
:func:`cg_runner_k` for timing and serving loops, the Jacobi
preconditioner and :func:`power_iteration`.  Loops are Python loops over tensors.  Plans with a padded
row space (the streaming-DIA strategies) iterate in it through
``SpmvPlan.solver_space``: encode once, loop, decode once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..formats import CSR, convert
from ..ops.spmv import spmv

__all__ = ["CGResult", "cg", "cg_runner", "cg_runner_k",
           "jacobi_preconditioner", "power_iteration", "safe_dinv",
           "safe_dinv_host"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor     # 0-d
    converged: torch.Tensor         # 0-d bool


def _identity(v):
    return v


def _as_matvec(A) -> Callable:
    if callable(A) and not hasattr(A, "shape"):
        return A
    return lambda v: spmv(A, v)


def _solver_space(A):
    """``(encode, matvec, decode)``: a plan's native vector space (see
    ``SpmvPlan.solver_space``), identities for everything else."""
    if hasattr(A, "solver_space"):
        return A.solver_space()
    return _identity, _as_matvec(A), _identity


def _size(A, n: int | None, who: str) -> int:
    """The operator's row count: its ``shape``, its plan's matrix's, or
    ``n`` (needed for a matvec closure)."""
    for obj in (A, getattr(A, "matrix", None)):
        if obj is not None and hasattr(obj, "shape"):
            return int(obj.shape[0])
    if n is None:
        raise ValueError(f"{who} needs n= for matvec closures")
    return int(n)


def _vector_type(A, dtype, device) -> tuple[torch.dtype, torch.device]:
    """The type and device of the vectors an operator takes: the given
    ones, else its values' (float32 for bfloat16 coefficients) and its
    tensors' device; a matvec closure gets float32 on the card."""
    M = getattr(A, "matrix", A)
    if dtype is None:
        dtype = getattr(M, "dtype", None)
        if dtype not in (torch.float32, torch.float64):
            dtype = torch.float32
    if device is None:
        try:
            device = M.device
        except (AttributeError, TypeError):
            device = "cuda"
    return dtype, torch.device(device)


def _draw(n: int, generator, dtype, device) -> torch.Tensor:
    """``n`` uniform values in [0, 1) from ``generator``, drawn on its
    device and moved to ``device``.  The default, a CPU generator seeded
    0, draws on the host, so its values do not depend on the device; a
    generator on the card draws there."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand(n, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def _spaces(A, precond):
    # a preconditioner acts in the ORIGINAL vector space, so the padded
    # fast path only engages without one
    if precond is None:
        enc, matvec, dec = _solver_space(A)
        return enc, matvec, dec, _identity
    return _identity, _as_matvec(A), _identity, precond


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(v, v))


def _limit(tol: float, b: torch.Tensor) -> torch.Tensor:
    return tol * torch.clamp(_norm(b), min=1e-300)


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v == 0, torch.ones_like(v), v)


def _cg_until(matvec, M, b, x, tol: float, maxiter: int, guarded: bool):
    """CG from ``x`` until ``||r|| <= tol·||b||`` or ``maxiter``.  Reads
    the residual norm on the host once per iteration."""
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    limit = _limit(tol, b)
    it = 0
    while it < maxiter and bool(_norm(r) > limit):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / (_nonzero(pAp) if guarded else pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / (_nonzero(rz) if guarded else rz)) * p
        rz = rz_new
        it += 1
    rnorm = _norm(r)
    return x, it, rnorm, rnorm <= limit


def _cg_fixed(matvec, M, b, x, k: int):
    """Exactly ``k`` CG iterations with no host synchronisation: the 0/0
    guards turn iterations past an exact zero residual into no-ops."""
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(k):
        Ap = matvec(p)
        alpha = rz / _nonzero(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / _nonzero(rz)) * p
        rz = rz_new
    return x, _norm(r), _norm(b)


def safe_dinv(d, dtype=None, device=None) -> torch.Tensor:
    """Elementwise safe inverse of a diagonal: zero entries invert to 1
    (a zero diagonal row gets an identity update, not inf/NaN)."""
    d = torch.as_tensor(d, dtype=dtype, device=device)
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)


def safe_dinv_host(d) -> np.ndarray:
    """Host-numpy :func:`safe_dinv` (same zero → identity policy)."""
    d = np.asarray(d, np.float64)
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)


def jacobi_preconditioner(A) -> Callable:
    """M⁻¹ = 1/diag(A), from the row-aligned CSR diagonal."""
    csr = A if isinstance(A, CSR) else convert(A, "csr")
    inv = safe_dinv(csr.diagonal())
    return lambda r: inv * r


def cg(A, b, *, x0=None, tol: float = 1e-8, maxiter: int = 1000,
       precond: Callable | None = None,
       true_tol: float | None = None, max_restarts: int = 3) -> CGResult:
    """Conjugate gradients for SPD ``A`` (a format, a plan or a matvec).

    The loop reads the residual norm on the host every iteration to test
    convergence (one device synchronisation per iteration; capturing the
    loop in a CUDA graph is later work).

    ``true_tol`` gates convergence on the TRUE relative residual
    ``||b - A@x|| / ||b||``: the solve restarts from the current iterate
    (recomputing ``r = b - A@x``) up to ``max_restarts`` times until it
    holds, and stops restarting early when an inner pass takes 0
    iterations.  ``residual_norm`` / ``converged`` then refer to the true
    residual and ``iterations`` adds up over the restarts.  Set the inner
    ``tol`` a decade below ``true_tol``."""
    enc, matvec, dec, M = _spaces(A, precond)
    b = enc(b)
    x = torch.zeros_like(b) if x0 is None else enc(x0)
    x, it, rnorm, ok = _cg_until(matvec, M, b, x, tol, maxiter, False)
    if true_tol is not None:
        def true_residual(x):
            rt = _norm(b - matvec(x))
            return rt, rt <= _limit(true_tol, b)

        rnorm, ok = true_residual(x)
        for _ in range(max_restarts):
            if bool(ok):
                break
            x, it2, _, _ = _cg_until(matvec, M, b, x, tol, maxiter, False)
            it += it2
            rnorm, ok = true_residual(x)
            if it2 == 0:
                break       # inner tol already met: stalled (tol must sit
                            # below true_tol)
    return CGResult(x=dec(x), iterations=it, residual_norm=rnorm,
                    converged=ok)


def cg_runner(A, *, iters: int, tol: float | None = None,
              precond: Callable | None = None,
              report_tol: float = 1e-8) -> Callable:
    """A reusable CG solve ``run(b, x0=None) -> CGResult`` bound to
    ``(A, iters, tol, precond)``.

    ``tol=None`` runs EXACTLY ``iters`` iterations with no convergence
    test and no host synchronisation inside the loop; ``converged`` reads
    ``rnorm <= report_tol·||b||`` once, at the end (pass e.g. 1e-5 for
    float32 operands).  With a ``tol``, it is :func:`cg`'s early-exit loop
    with ``maxiter=iters`` and 0/0 guards."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    enc, matvec, dec, M = _spaces(A, precond)

    def run(b, x0=None) -> CGResult:
        b = enc(b)
        x = torch.zeros_like(b) if x0 is None else enc(x0)
        if tol is None:
            x, rnorm, bnorm = _cg_fixed(matvec, M, b, x, iters)
            return CGResult(x=dec(x), iterations=iters, residual_norm=rnorm,
                            converged=rnorm <= report_tol * torch.clamp(
                                bnorm, min=1e-300))
        x, it, rnorm, ok = _cg_until(matvec, M, b, x, tol, iters, True)
        return CGResult(x=dec(x), iterations=it, residual_norm=rnorm,
                        converged=ok)

    return run


def cg_runner_k(A, *, precond: Callable | None = None,
                report_tol: float = 1e-8) -> Callable:
    """Like :func:`cg_runner` with ``tol=None``, with the iteration count
    an argument of each call: ``run(b, k, x0=None)``."""
    enc, matvec, dec, M = _spaces(A, precond)

    def run(b, k: int, x0=None) -> CGResult:
        b = enc(b)
        x = torch.zeros_like(b) if x0 is None else enc(x0)
        x, rnorm, bnorm = _cg_fixed(matvec, M, b, x, int(k))
        return CGResult(x=dec(x), iterations=int(k), residual_norm=rnorm,
                        converged=rnorm <= report_tol * torch.clamp(
                            bnorm, min=1e-300))

    return run


def power_iteration(A, *, generator: torch.Generator | None = None,
                    iters: int = 50, n: int | None = None, dtype=None,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dominant eigenvalue and eigenvector of ``A`` by ``iters`` power
    steps from a uniform random start: ``(lam, v)`` with the Rayleigh
    quotient ``lam = v . A v``.

    ``generator`` (a ``torch.Generator``; default a CPU one seeded 0)
    takes the place of the reference's ``key``; ``n`` is needed for matvec closures, whose
    vectors are float32 on the card unless ``dtype`` / ``device`` say
    otherwise.  Plans iterate in their padded space.  No host
    synchronisation inside the loop."""
    enc, matvec, dec = _solver_space(A)
    n = _size(A, n, "power_iteration")
    dtype, device = _vector_type(A, dtype, device)
    v = enc(_draw(n, generator, dtype, device))
    v = v / _norm(v)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp(_norm(w), min=1e-300)
    return torch.dot(v, matvec(v)), dec(v)
