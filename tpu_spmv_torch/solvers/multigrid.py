"""Geometric multigrid preconditioner for grid Poisson operators.

Counterpart of ``tpu_spmv/solvers/multigrid.py``: plain CG needs O(g)
iterations on a g x g Poisson grid, MG-PCG O(1).  Everything is torch
code on ``[g, g(, g)]`` tensors, with no matrix, no gather and no
reduction:

- **level operators**: the unscaled (2d+1)-point stencil ``(2d + c) u -
  sum of neighbours`` with zero (eliminated Dirichlet) boundaries, applied
  by shifted slices; the shift ``c`` grows x4 a level (a mass term
  against the h^2-scaled Laplacian);
- **transfers**: cell-centred d-linear prolongation, a 1-D clamped
  stencil ``fine[2i] = (3 u[i] + u[i-1]) / 4``, ``fine[2i+1] = (3 u[i] +
  u[i+1]) / 4`` along each axis; restriction is its exact adjoint
  (:func:`_restrict`, written out) scaled by ``2^-d``, which keeps the
  V-cycle symmetric and so a valid PCG preconditioner;
- **correction scale 4**: with row-sum-1 restriction the Galerkin
  operator ``R A P`` is ``A_coarse / 4`` on smooth modes, so the coarse
  correction comes back x4;
- **smoother**: weighted Jacobi, ``omega / (2d + c)``;
- **coarsest solve**: fixed-degree Chebyshev on the coarsest stencil with
  analytic spectrum bounds (linear and symmetric, unlike an inner CG).

Scope: constant-coefficient Poisson (+ shift) on rectangular grids, the
matrices of ``utils.laplacian_2d/_3d`` (+ ``shift`` I).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Sequence

import torch

__all__ = ["mg_preconditioner", "poisson_stencil_apply"]


def poisson_stencil_apply(u: torch.Tensor, shift: float = 0.0
                          ) -> torch.Tensor:
    """Unscaled (2d+1)-point Laplacian + shift on a ``[g1, ..., gd]``
    grid: ``(2d + shift) u - sum over axes of u shifted by +-1`` with zero
    Dirichlet closure, the matrix of ``utils.laplacian_2d/_3d`` (+
    ``shift`` I) on the grid."""
    d = u.dim()
    y = (2 * d + shift) * u
    for ax in range(d):
        g = u.shape[ax]
        # y[i] -= u[i+1], then y[i] -= u[i-1] (the reference's order)
        y.narrow(ax, 0, g - 1).sub_(u.narrow(ax, 1, g - 1))
        y.narrow(ax, 1, g - 1).sub_(u.narrow(ax, 0, g - 1))
    return y


def _interp1d(u: torch.Tensor, ax: int) -> torch.Tensor:
    """Cell-centred linear interpolation along one axis (clamped ends):
    ``fine[2i] = (3 u[i] + u[i-1]) / 4``, ``fine[2i+1] = (3 u[i] + u[i+1])
    / 4``; the axis doubles."""
    g = u.shape[ax]
    um = torch.cat([u.narrow(ax, 0, 1), u.narrow(ax, 0, g - 1)], dim=ax)
    up = torch.cat([u.narrow(ax, 1, g - 1), u.narrow(ax, g - 1, 1)], dim=ax)
    even = (3.0 * u + um) * 0.25
    odd = (3.0 * u + up) * 0.25
    shape = list(u.shape)
    shape[ax] *= 2
    return torch.stack([even, odd], dim=ax + 1).reshape(shape)


def _interp1d_adjoint(f: torch.Tensor, ax: int) -> torch.Tensor:
    """The exact adjoint of :func:`_interp1d` along ``ax`` (the axis
    halves): ``u_bar[i] = 3/4 (e[i] + o[i]) + 1/4 (e[i+1] + o[i-1])``, the
    clamped ends folding ``e[0]`` and ``o[-1]`` back onto themselves."""
    shape = list(f.shape)
    g = shape[ax] // 2
    shape[ax:ax + 1] = [g, 2]
    pairs = f.reshape(shape)
    e = pairs.select(ax + 1, 0)
    o = pairs.select(ax + 1, 1)
    # the terms u[i-1] (read by e[i]) and u[i+1] (read by o[i]) send
    # e[i] / 4 to i - 1 (i = 0: to 0) and o[i] / 4 to i + 1 (last: itself)
    e_back = torch.cat([e.narrow(ax, 1, g - 1), torch.zeros_like(
        e.narrow(ax, 0, 1))], dim=ax)
    o_fwd = torch.cat([torch.zeros_like(o.narrow(ax, 0, 1)),
                       o.narrow(ax, 0, g - 1)], dim=ax)
    u = 0.75 * (e + o) + 0.25 * (e_back + o_fwd)
    u.narrow(ax, 0, 1).add_(0.25 * e.narrow(ax, 0, 1))
    u.narrow(ax, g - 1, 1).add_(0.25 * o.narrow(ax, g - 1, 1))
    return u


def _prolong(uc: torch.Tensor) -> torch.Tensor:
    """d-linear prolongation: :func:`_interp1d` along each axis (2-D
    weights 9/16, 3/16, 3/16, 1/16)."""
    f = uc
    for ax in range(uc.dim()):
        f = _interp1d(f, ax)
    return f


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Restriction: the exact adjoint of :func:`_prolong` (the axes'
    adjoints in reverse order) scaled by ``2^-d``, so its rows sum to 1."""
    d = r.dim()
    for ax in reversed(range(d)):
        r = _interp1d_adjoint(r, ax)
    return r * (0.5 ** d)


def _cheby_solve(b: torch.Tensor, matvec: Callable, lmin: float,
                 lmax: float, degree: int) -> torch.Tensor:
    """Fixed-degree Chebyshev approximation to ``A^-1 b`` on ``[lmin,
    lmax]`` (the :mod:`.cheby` recurrence): linear and symmetric in
    ``b``."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    r = b
    p = r / theta
    x = p
    rho = 1.0 / sigma
    for _ in range(degree):
        r = r - matvec(p)
        rho_new = 1.0 / (2.0 * sigma - rho)
        p = rho_new * (2.0 * r / delta + rho * p)
        x = x + p
        rho = rho_new
    return x


def _check_sweeps(nu1: int, nu2: int) -> None:
    """The sweep counts' checks (called by the preconditioners' factories,
    so the warning points at their caller)."""
    if nu1 < 0 or nu2 < 0 or nu1 + nu2 == 0:
        raise ValueError("need nu1 + nu2 >= 1 smoothing sweeps")
    if nu1 != nu2:
        warnings.warn(
            f"nu1={nu1} != nu2={nu2} makes the V-cycle non-symmetric; "
            "the result is not a valid PCG preconditioner (fine for "
            "standalone smoothing / flexible methods)", stacklevel=3)


def _levels(grid_shape: tuple[int, ...], shift: float, coarsest: int):
    """The hierarchy's grid shapes and shifts: every axis halves while all
    are even and above ``coarsest``."""
    shapes = [grid_shape]
    shifts = [float(shift)]
    while (all(g % 2 == 0 for g in shapes[-1])
           and min(shapes[-1]) > coarsest):
        shapes.append(tuple(g // 2 for g in shapes[-1]))
        shifts.append(shifts[-1] * 4.0)   # the mass term grows x4 a level
    return shapes, shifts


def _vcycle(shapes, shifts, *, nu1: int, nu2: int, omega: float,
            coarse_degree: int) -> Callable:
    """``vcycle(lvl, b)``: the V-cycle from level ``lvl`` down on a level
    grid ``b``."""
    d = len(shapes[0])
    nlev = len(shapes)

    def smooth(u, b, lvl, sweeps):
        dinv = omega / (2 * d + shifts[lvl])
        for _ in range(sweeps):
            u = u + dinv * (b - poisson_stencil_apply(u, shifts[lvl]))
        return u

    def vcycle(lvl, b):
        if lvl == nlev - 1:
            g = max(shapes[lvl])
            c = shifts[lvl]
            lmin = c + 4.0 * d * math.sin(math.pi / (4.0 * g)) ** 2
            lmax = c + 4.0 * d
            return _cheby_solve(b, lambda v: poisson_stencil_apply(v, c),
                                lmin, lmax, coarse_degree)
        u = smooth(torch.zeros_like(b), b, lvl, nu1)
        r = b - poisson_stencil_apply(u, shifts[lvl])
        e = vcycle(lvl + 1, _restrict(r))
        # Galerkin R A P = A_coarse / 4 on smooth modes: correction x4
        u = u + 4.0 * _prolong(e)
        return smooth(u, b, lvl, nu2)

    return vcycle


def mg_preconditioner(grid_shape: Sequence[int], *, shift: float = 0.0,
                      nu1: int = 2, nu2: int = 2, omega: float = 0.8,
                      coarsest: int = 8, coarse_degree: int = 16,
                      cycles: int = 1) -> Callable:
    """V-cycle geometric-multigrid preconditioner for the grid operator
    ``laplacian_2d/_3d(g) + shift I``: ``apply(r_flat) -> z_flat``, ``z ~
    A^-1 r``, an SPD linear map valid as ``precond=`` of
    :func:`~.cg.cg`; it runs on ``r``'s device and type.

    ``grid_shape`` is the grid, e.g. ``(1024, 1024)``; every axis halves
    while all are even and above ``coarsest``.  ``nu1`` / ``nu2`` Jacobi
    sweeps before and after the coarse correction (equal counts keep the
    cycle symmetric), ``cycles`` V-cycles an application."""
    grid_shape = tuple(int(g) for g in grid_shape)
    d = len(grid_shape)
    if d not in (2, 3):
        raise ValueError(f"mg_preconditioner supports 2-D/3-D grids, "
                         f"got {grid_shape}")
    if any(g < 2 for g in grid_shape):
        raise ValueError(f"grid too small: {grid_shape}")
    _check_sweeps(nu1, nu2)
    shapes, shifts = _levels(grid_shape, shift, coarsest)
    vcycle = _vcycle(shapes, shifts, nu1=nu1, nu2=nu2, omega=omega,
                     coarse_degree=coarse_degree)
    n = math.prod(grid_shape)

    def apply(r):
        if tuple(r.shape) != (n,):
            raise ValueError(
                f"mg_preconditioner built for flat [{n}] vectors of the "
                f"{grid_shape} grid, got shape {tuple(r.shape)}")
        b = r.reshape(grid_shape)
        z = vcycle(0, b)
        for _ in range(cycles - 1):
            z = z + vcycle(0, b - poisson_stencil_apply(z, shifts[0]))
        return z.reshape(-1)

    return apply
