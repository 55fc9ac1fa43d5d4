"""Iterative solvers on the SpMV + BLAS-1 surface: CG and multi-RHS CG."""

from .block_cg import CGMultiResult, cg_multi, cg_multi_runner
from .cg import (CGResult, cg, cg_runner, cg_runner_k, jacobi_preconditioner,
                 safe_dinv, safe_dinv_host)

__all__ = ["CGResult", "cg", "cg_runner", "cg_runner_k",
           "jacobi_preconditioner", "safe_dinv", "safe_dinv_host",
           "CGMultiResult", "cg_multi", "cg_multi_runner"]
