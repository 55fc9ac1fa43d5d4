"""Iterative solvers on the SpMV + BLAS-1 surface: CG, multi-RHS CG and
distributed CG."""

from .block_cg import CGMultiResult, cg_multi, cg_multi_runner
from .cg import (CGResult, cg, cg_runner, cg_runner_k, jacobi_preconditioner,
                 safe_dinv, safe_dinv_host)
from .dist_cg import DistCGResult, dist_cg, dist_cg_ca

__all__ = ["CGResult", "cg", "cg_runner", "cg_runner_k",
           "jacobi_preconditioner", "safe_dinv", "safe_dinv_host",
           "CGMultiResult", "cg_multi", "cg_multi_runner",
           "DistCGResult", "dist_cg", "dist_cg_ca"]
