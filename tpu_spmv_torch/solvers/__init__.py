"""Iterative solvers on the SpMV + BLAS-1 surface (CG for now)."""

from .cg import (CGResult, cg, cg_runner, cg_runner_k, jacobi_preconditioner,
                 safe_dinv, safe_dinv_host)

__all__ = ["CGResult", "cg", "cg_runner", "cg_runner_k",
           "jacobi_preconditioner", "safe_dinv", "safe_dinv_host"]
