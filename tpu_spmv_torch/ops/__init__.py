"""Compute ops: SpMV and SpMM per format, the planner, BLAS-1 vector ops,
transpose and diagonal shift."""

from .auto import PatternStats, SpmvPlan, analyze, plan_from_matrix, plan_spmv
from .shift import shift_diagonal
from .spmm import spmm, spmm_coo, spmm_csc, spmm_csr, spmm_dia
from .spmv import spmv, spmv_coo, spmv_csc, spmv_csr, spmv_dia
from .transpose import transpose
# after the submodule .shift: the name ``shift`` is blas1's vector shift
from .blas1 import (add2scaled, allclose, axpby, axpy, check_vector, dot,
                    fill, fill_random, norm2, scale, shift)

__all__ = ["spmv", "spmv_coo", "spmv_csr", "spmv_csc", "spmv_dia",
           "spmm", "spmm_coo", "spmm_csr", "spmm_csc", "spmm_dia",
           "transpose", "shift_diagonal",
           "PatternStats", "SpmvPlan", "analyze", "plan_spmv",
           "plan_from_matrix",
           "dot", "axpby", "axpy", "add2scaled", "fill", "fill_random",
           "scale", "shift", "norm2", "check_vector", "allclose"]
