"""Iterative solvers on the SpMV + BLAS-1 surface: CG and its runners,
multi-RHS CG, distributed CG, BiCGSTAB, GMRES, LSQR, Chebyshev, Lanczos,
power iteration, multicolor SOR / SymGS, geometric multigrid and
mixed-precision iterative refinement."""

from .block_cg import CGMultiResult, cg_multi, cg_multi_runner
from .cg import (CGResult, cg, cg_runner, cg_runner_k, jacobi_preconditioner,
                 power_iteration, safe_dinv, safe_dinv_host)
from .cheby import ChebyshevResult, chebyshev, chebyshev_preconditioner
from .dist_cg import DistCGResult, dist_cg, dist_cg_ca
from .ir import IRResult, ir_runner, ir_solve
from .krylov import KrylovResult, bicgstab, gmres
from .lanczos import LanczosResult, eigsh_lanczos, lanczos
from .lsqr import LSQRResult, lsqr
from .multigrid import mg_preconditioner, poisson_stencil_apply
from .relaxation import (SORResult, gauss_seidel_sweep, multicolor, sor,
                         symgs_preconditioner)

__all__ = ["CGResult", "cg", "cg_runner", "cg_runner_k",
           "jacobi_preconditioner", "power_iteration", "safe_dinv",
           "safe_dinv_host",
           "CGMultiResult", "cg_multi", "cg_multi_runner",
           "ChebyshevResult", "chebyshev", "chebyshev_preconditioner",
           "DistCGResult", "dist_cg", "dist_cg_ca",
           "IRResult", "ir_solve", "ir_runner",
           "KrylovResult", "bicgstab", "gmres",
           "LanczosResult", "lanczos", "eigsh_lanczos",
           "LSQRResult", "lsqr",
           "mg_preconditioner", "poisson_stencil_apply",
           "SORResult", "multicolor", "gauss_seidel_sweep", "sor",
           "symgs_preconditioner"]
